"""What every run of the benchmark shares: the benchmark file and the cell
it names, the environment, the guard against JAX, host spans, the device
line and the one JSON result line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package the program was ported from (compared whole: the program's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffusion_finetuning_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names among ``modules`` (default ``sys.modules``) that the
    guard refuses."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, and
    the libraries that could load JAX told not to."""
    os.environ["DFT_TORCH_BUILD_DIR"] = str(root / "build" / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def resolve(bench: dict, workload: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    """The cell's entry, its configuration (the file ``BENCHMARK.json``
    names), its traffic (``traffic/<name>.json``), the driver the traffic
    names (``drivers/<name>.py``) and the per-layer metric readers
    (``metrics/<name>.py``) and end-to-end metrics that list it."""
    cell = find_cell(bench, workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    root = bench_dir.parent
    config = load_json(root / conf["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": config, "traffic": traffic,
            "driver": driver_path(traffic, bench_dir),
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)],
            "readers": {m["name"]: bench_dir / "metrics" / f"{m['name']}.py"
                        for m in bench["per_layer"] if listed(m)}}


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_LOADED: Dict[Path, Any] = {}


def load_file(path: Path, kind: str):
    """The module of a benchmark file found by name (a driver, a metric),
    loaded once per process."""
    import importlib.util

    path = Path(path).resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise SystemExit(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(
            f"h100_bench_{kind}_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def driver_path(traffic: dict, bench_dir: Path = BENCH_DIR) -> Path:
    """``drivers/<name>.py`` for the traffic's ``driver``."""
    name = traffic["driver"]
    if not NAME.fullmatch(name):
        raise SystemExit(f"bad driver name {name!r}")
    return bench_dir / "drivers" / f"{name}.py"


def load_driver(path: Path):
    """A driver's module: ``Run(ctx)`` (``setup``, ``window``,
    ``end_to_end``, ``check_inputs``, ``control_inputs``, ``close``),
    ``checks(ctx, inputs)`` and ``readings(ctx, inputs, mode)``."""
    return load_file(path, "driver")


def load_reader(path: Path):
    """The ``read(m)`` function of a per-layer metric's file."""
    return load_file(path, "metric").read


class Spans:
    """Host spans (name, start s, end s, attrs) of the benchmark's wrappers
    around calls into the program, on ``time.perf_counter``; with
    ``profiled`` each is also a ``record_function`` range, so the trace
    holds it on the device's clock."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.items: List[tuple] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rf = None
        if self.profiled:
            import torch

            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._lock:
                self.items.append((name, t0, t1, attrs))


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]); inf counts as a miss."""
    vals = sorted(values)
    if not vals:
        return math.inf
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def card_info() -> Dict[str, Any]:
    """The card's name, SM clock and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout
        name, sm, sm_max, limit = [x.strip() for x in out.strip().splitlines()[0].split(",")]
        return {"smi_name": name, "sm_clock": sm, "sm_clock_max": sm_max, "power_limit": limit}
    except Exception as e:  # the line is informative only
        return {"smi_error": str(e)[:200]}


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
         device: Dict[str, Any], checks: List[tuple], extra: Optional[Dict[str, Any]] = None,
         breakdown: Optional[Dict[str, Any]] = None) -> None:
    """The result: each compared number beside its limit as the last lines
    of stderr, then one JSON line as the last line of stdout, the checks
    under the last key."""
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                            "failed": int(failed),
                            "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
                            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    for k, v in (extra or {}).items():
        line[k] = v
    line["checks"] = [{"name": n, "value": v, "limit": lim, "ok": ok}
                      for n, v, lim, ok in checks]
    sys.stdout.flush()
    for n, v, lim, ok in checks:
        print(f"check {n}: {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
