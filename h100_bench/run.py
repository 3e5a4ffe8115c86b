"""Run one cell of the port's benchmark on this machine's card.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``h100_bench/configs/<name>.json``) and a traffic mix
(``h100_bench/traffic/<name>.json``), which names its driver
(``h100_bench/drivers/<name>.py``); per-layer metrics are read by
``h100_bench/metrics/<name>.py``.  The last line of stdout is the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from h100_bench.harness import core

    core.cache_env(ROOT)
    if not (ROOT / "diffusion_finetuning_tpu_torch" / "__init__.py").exists():
        print("the program (diffusion_finetuning_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    bench = core.load_json(ROOT / "BENCHMARK.json")
    spec = core.resolve(bench, args.workload)
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from h100_bench.harness import runner

    torch.cuda.set_device(0)
    ctx = runner.Ctx(workload=args.workload, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda", 0),
                     config=spec["config"], traffic=spec["traffic"],
                     end_to_end=spec["end_to_end"], per_layer=spec["per_layer"],
                     readers=spec["readers"], driver=spec["driver"])
    out = runner.run_cell(ctx, T_START)
    core.emit(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"],
              out["checks"], out["extra"], out["breakdown"])
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the result is out and every thread the run started has been stopped;
    # skip the interpreter's teardown of a traced run's millions of profiler
    # records, which took minutes on the card's machine
    os._exit(code)
