"""Find the knee of an open-loop serving cell: the highest arrival rate the
program sustains without a backlog that grows through the window.

    python3 -m h100_bench.tools.sweep --cell sd15.serve.adapters_open --rates 2.5 3 3.5 \\
        [--repeats 2] [--seconds 50] [--seed N]

on the card.  One server is set up once; each rate runs the cell's traffic
for ``--seconds``, ``--repeats`` times, each repeat with another realisation
of the arrivals and adapters (``pattern_seed`` 0, 1, ...; the cell runs 0),
and the server drains before the next.  Per rate: the
completed requests a second, the latency p50 / p90, and the mean latency of
the window's last third against its first third (a backlog that grows
shows as a ratio well above 1), and the requests still queued at the close.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..harness import core, runner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=8_200_000_000)
    args = ap.parse_args(argv)
    root = core.BENCH_DIR.parent
    core.cache_env(root)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = core.resolve(core.load_json(root / "BENCHMARK.json"), args.cell)
    ctx = runner.Ctx(workload=args.cell, seed=args.seed, seconds=args.seconds, trace=False,
                     device=torch.device("cuda", 0), config=spec["config"],
                     traffic=dict(spec["traffic"]), end_to_end=spec["end_to_end"],
                     per_layer=[], readers={}, driver=spec["driver"])
    drv = core.load_driver(ctx.driver)
    run = drv.Run(ctx)
    run.setup()
    runs = [(rate, r) for rate in args.rates for r in range(args.repeats)]
    for i, (rate, rep) in enumerate(runs):
        ctx.traffic["rate_per_s"] = rate
        ctx.traffic["pattern_seed"] = rep
        run.requests = drv.schedule(ctx.traffic, args.seed + i, args.seconds)
        run.records = []
        run.window()
        e2e = run.end_to_end()
        recs = sorted(run.records, key=lambda r: r["due"])
        lat = [r["done"] - r["due"] for r in recs if r["done"] is not None]
        third = max(1, len(lat) // 3)
        queued = sum(1 for r in recs if r["done"] is None or r["done"] > run.t_close)
        print(json.dumps({"rate_per_s": rate, "pattern_seed": rep, "requests": len(recs),
                          "completed_per_s": sum(1 for r in recs if r["done"] is not None
                                                 and r["done"] <= run.t_close) / args.seconds,
                          "latency_p50_s": e2e.get("latency_p50_s"),
                          "latency_p90_s": e2e.get("latency_p90_s"),
                          "last_third_over_first": float(np.mean(lat[-third:]) / np.mean(lat[:third])),
                          "unfinished_at_close": queued, "failed": e2e["failed"]}), flush=True)
    run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
