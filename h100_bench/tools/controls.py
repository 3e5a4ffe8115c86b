"""The controls of the comparison that decides ``correct``.

For a cell and a seed: the program's readings (a short window at the
cell's own load, or the training steps before the window) and the
control's, the reference computed one precision below what the
configuration states (``traffic[check][control]``: ``fp8`` below bf16
serving and bf16 training; ``bf16`` below fp32 training, whose cuDNN
convolutions run at PyTorch's default, TF32), put in the program's place
on the same inputs.  Both are held against the fp32 reference.

    python3 -m h100_bench.tools.controls --cells <cell> [...] --seeds 3 [--seconds 8] \
        [--mode tf32] [--adapter-faults N]

on the card, from the root of a checkout; one JSON line per cell and seed.
``--mode`` reads another precision than the traffic's ``control`` (the
modes of ``reference/numerics.py``).  ``--adapter-faults N`` reads, in
place of the control, the reference serving ``N`` of the run's requests
with another request's adapter and with none (a serving driver's
``adapter_faults``); the program does not run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Tuple

import torch

from ..harness import core, runner
from ..harness import program as P


def readings(ctx, mode: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(program's numbers, control's numbers) against the fp32 reference,
    by the cell's driver: its ``Run.control_inputs`` (a window at the
    cell's load, or the steps made in set-up), then its ``readings``."""
    drv = core.load_driver(ctx.driver)
    run = drv.Run(ctx)
    run.setup()
    inputs = run.control_inputs()
    run.close()
    del run
    P.free()
    return drv.readings(ctx, inputs, mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=7_100_000_000)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--mode", default=None)
    ap.add_argument("--adapter-faults", type=int, default=0)
    args = ap.parse_args(argv)
    root = core.BENCH_DIR.parent
    core.cache_env(root)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = core.load_json(root / "BENCHMARK.json")
    for cell in args.cells:
        spec = core.resolve(bench, cell)
        mode = args.mode or spec["traffic"]["check"]["control"]
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            ctx = runner.Ctx(workload=cell, seed=seed, seconds=args.seconds, trace=False,
                             device=torch.device("cuda", 0), config=spec["config"],
                             traffic=spec["traffic"], end_to_end=spec["end_to_end"],
                             per_layer=[], readers={}, driver=spec["driver"])
            t0 = time.perf_counter()
            if args.adapter_faults:
                out = {"faults": core.load_driver(ctx.driver).adapter_faults(
                    ctx, args.adapter_faults)}
            else:
                prog, ctrl = readings(ctx, mode)
                out = {"control": mode, "program": prog, "control_readings": ctrl}
            print(json.dumps({"cell": cell, "seed": seed, **out,
                              "seconds": time.perf_counter() - t0}), flush=True)
            P.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
