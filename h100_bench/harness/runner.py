"""One run of one cell: set-up, the measured window (traced with
``--trace 1``), the comparison with the reference, the result line.

``run_cell`` takes the device and, for the CPU tests, the configuration and
traffic directly; ``run.py`` gives it the card and the cell's files.  What a
kind of traffic does (its set-up, window, end-to-end numbers and checks)
is its driver's, ``drivers/<name>.py``, found by the name the traffic gives.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

import torch

from . import core
from . import program as P


@dataclass
class Ctx:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Any]
    driver: Path = None  # drivers/<name>.py; by default the traffic's driver here
    cuda_graphs: bool = True
    spans: core.Spans = field(default_factory=core.Spans)

    def __post_init__(self):
        if self.driver is None:
            self.driver = core.driver_path(self.traffic)


def _log(msg: str) -> None:
    print(f"[h100_bench] {msg}", file=sys.stderr, flush=True)


def per_layer(ctx, run, trace) -> Dict[str, tuple]:
    window = [s for s in ctx.spans.items if s[1] >= run.t_open]
    m = {"spans": window, "trace": trace, "run": run, "config": ctx.config,
         "traffic": ctx.traffic}
    out = {}
    for spec in ctx.per_layer:
        v = core.load_reader(ctx.readers[spec["name"]])(m)
        if v is not None:
            out[spec["name"]] = (float(v), spec["unit"])
    return out, m.get("notes", {})


def run_cell(ctx: Ctx, t_start: float) -> Dict[str, Any]:
    """Everything but printing; returns the pieces of the result line."""
    drv = core.load_driver(ctx.driver)
    run = drv.Run(ctx)
    run.setup()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.2f} s")
    trace = None
    if ctx.trace:
        from .trace import Profiler

        ctx.spans.profiled = True
        with Profiler() as prof:
            with ctx.spans.span("window"):
                run.window()
        _log(f"traced window closed at {time.perf_counter() - t_start:.2f} s")
        trace = prof.read()
        _log(f"trace read at {time.perf_counter() - t_start:.2f} s: {len(trace.kernels)} "
             "device operations")
    else:
        run.window()
    e2e = run.end_to_end()
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
              else "cpu",
              "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(ctx.device))
              if ctx.device.type == "cuda" else 0}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
    inputs = run.check_inputs()
    layer, notes = (per_layer(ctx, run, trace) if ctx.trace else ({}, {}))
    run.close()  # the driver drops what it held of the program
    P.free()
    found = core.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    _log(f"window and reading done at {time.perf_counter() - t_start:.2f} s")
    t_ref = time.perf_counter()
    checks = drv.checks(ctx, inputs)
    _log(f"reference {time.perf_counter() - t_ref:.2f} s")
    metrics: Dict[str, tuple] = {}
    if ctx.trace:
        metrics.update(layer)
    else:
        metrics["setup_s"] = (setup_s, "s")
        for spec in ctx.end_to_end:
            if spec["name"] in e2e:
                metrics[spec["name"]] = (float(e2e[spec["name"]]), spec["unit"])
    extra = {"info": {k: v for k, v in e2e.items() if k not in metrics},
             "card": core.card_info() if ctx.device.type == "cuda" else {},
             "kernel_records": notes, "seed": ctx.seed, "workload": ctx.workload}
    if not ctx.trace:
        extra["info"]["setup_s"] = setup_s
    gc.collect()
    return {"correct": all(c[3] for c in checks) and e2e["failed"] == 0 or False,
            "attempted": e2e["attempted"], "failed": e2e["failed"], "metrics": metrics,
            "device": device, "checks": checks, "extra": extra,
            "breakdown": trace.breakdown() if trace is not None else None}
