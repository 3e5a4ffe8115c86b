"""Host time of the flash-attention wrappers and of a UNet step: this
checkout against another one, on one card.

    python3 -m diffusion_finetuning_tpu_torch.host_cost --against DIR

``DIR`` is the root of another checkout (a parent commit unpacked with
``git archive``, say).  Its ``diffusion_finetuning_tpu_torch`` is imported
under another module name, so that both packages live in one process and
take turns on the card, in rounds ordered this, other, other, this: a drift
in the shared host's speed then falls on both.  Each turn measures

* host microseconds per call of ``ops.flash_attention._fwd_cuda`` (K1, BH
  16) and ``_bwd_cuda`` (K3, BH 8) at SD1.5's eight attention shapes: the
  time to enqueue ``CALLS`` calls without waiting for the card, which is
  all the host does per call (Python, ctypes, the C entry's tensor-map
  encodes, the launch);
* wall ms of a full-width SD1.5 UNet step (CFG batch 2, 64x64 latents,
  bf16, random weights, no LoRA), ``STEPS`` steps ending in a synchronize.

It prints the medians of each tree and, as its last line, a JSON object of
them.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time

# (Sq, Skv, d, calls a UNet or train step) of SD1.5's attention at 512^2
SHAPES = [(4096, 4096, 40, 5), (1024, 1024, 80, 5), (256, 256, 160, 5), (64, 64, 160, 1),
          (4096, 77, 40, 5), (1024, 77, 80, 5), (256, 77, 160, 5), (64, 77, 160, 1)]
FWD_BH, BWD_BH = 16, 8  # serving (CFG batch 2 x 8 heads), training (batch 1)
CALLS = 50  # calls enqueued per host timing
STEPS = 10  # UNet steps per wall timing
THIS = "diffusion_finetuning_tpu_torch"


def load_tree(root: str, name: str):
    """The ``diffusion_finetuning_tpu_torch`` package under ``root``,
    imported as ``name`` (its imports of itself are relative)."""
    pkg = os.path.join(os.path.abspath(root), THIS)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def enqueue_us(fn) -> float:
    """Host microseconds per call of ``CALLS`` calls of fn(), the card
    idle at the start and not waited for until they are all enqueued."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / CALLS
    torch.cuda.synchronize()
    return us


class Tree:
    """One checkout's flash wrappers and UNet on shared inputs."""

    def __init__(self, pkg: str, inputs, unet_state):
        import torch

        self.fa = importlib.import_module(f"{pkg}.ops.flash_attention")
        unet_mod = importlib.import_module(f"{pkg}.models.unet")
        with torch.device("cuda"):
            self.unet = unet_mod.UNet2DConditionModel(unet_mod.UNetConfig.sd15())
        self.unet = self.unet.to(torch.bfloat16).eval()
        if unet_state is not None:
            self.unet.load_state_dict(unet_state)
        self.inputs = inputs

    def turn(self) -> dict:
        """One turn: host us per K1 and K3 call at every shape, UNet step ms."""
        import torch

        fa = self.fa
        fwd, bwd = [], []
        with torch.inference_mode():
            for (sq, skv, d, _), (fw, bw) in zip(SHAPES, self.inputs["flash"]):
                scale = d ** -0.5
                fwd.append(enqueue_us(lambda: fa._fwd_cuda(*fw, scale)))
                q, k, v, lse, delta, do = bw
                bwd.append(enqueue_us(lambda: fa._bwd_cuda(q, k, v, lse, delta, do, scale)))
            x, t, ctx = self.inputs["unet"]
            self.unet(x, t, ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                self.unet(x, t, ctx)
            torch.cuda.synchronize()
            step = (time.perf_counter() - t0) * 1e3 / STEPS
        return {"fwd_us": fwd, "bwd_us": bwd, "unet_step_ms": step}


def make_inputs():
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    fa = importlib.import_module(f"{THIS}.ops.flash_attention")
    flash = []
    with torch.inference_mode():
        for sq, skv, d, _ in SHAPES:
            fw = (randn(FWD_BH, sq, d), randn(FWD_BH, skv, d), randn(FWD_BH, skv, d))
            q, k, v, do = randn(BWD_BH, sq, d), randn(BWD_BH, skv, d), randn(BWD_BH, skv, d), \
                randn(BWD_BH, sq, d)
            o, lse = fa.flash_attention_plain(q, k, v, d ** -0.5)
            flash.append((fw, (q, k, v, lse, fa._delta(o, do), do)))
    unet = (randn(2, 4, 64, 64), torch.tensor([500, 500], device="cuda"), randn(2, 77, 768))
    return {"flash": flash, "unet": unet}


def summary(turns) -> dict:
    """Medians over a tree's turns, per shape and summed over one step's calls."""
    fwd = [statistics.median(t["fwd_us"][i] for t in turns) for i in range(len(SHAPES))]
    bwd = [statistics.median(t["bwd_us"][i] for t in turns) for i in range(len(SHAPES))]
    per = [s[3] for s in SHAPES]
    return {"fwd_us": fwd, "bwd_us": bwd,
            "fwd_us_a_step": sum(u * n for u, n in zip(fwd, per)),
            "bwd_us_a_step": sum(u * n for u, n in zip(bwd, per)),
            "unet_step_ms": statistics.median(t["unet_step_ms"] for t in turns),
            "unet_step_ms_all": [t["unet_step_ms"] for t in turns]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds of four turns (this, other, other, this)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("host_cost needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip(), flush=True)
    load_tree(args.against, "dft_other")
    builds = [importlib.import_module(f"{p}.ops._build") for p in (THIS, "dft_other")]
    errors = []

    def build(mod):
        try:
            mod.build()
        except Exception as e:  # reported after both builds end
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m,)) for m in builds]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]

    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = make_inputs()
    this = Tree(THIS, inputs, None)
    other = Tree("dft_other", inputs, this.unet.state_dict())
    trees = {"this": this, "other": other}
    for tree in trees.values():  # warm-up: loads each library, configures each kernel
        before = (tree.fa.launches, tree.fa.bwd_launches)
        tree.turn()
        if (tree.fa.launches, tree.fa.bwd_launches) <= before:
            sys.exit("a tree launched no flash kernel")
    turns = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            turns[name].append(trees[name].turn())
    out = {name: summary(t) for name, t in turns.items()}
    for name, s in out.items():
        print(f"{name}: K1 host us/call " + " ".join(f"{u:.1f}" for u in s["fwd_us"])
              + f" ({s['fwd_us_a_step']:.1f} a step); K3 host us/call "
              + " ".join(f"{u:.1f}" for u in s["bwd_us"])
              + f" ({s['bwd_us_a_step']:.1f} a step); UNet step {s['unet_step_ms']:.3f} ms "
              + f"(turns {', '.join(f'{m:.3f}' for m in s['unet_step_ms_all'])})", flush=True)
    print(json.dumps({"shapes": [list(s) for s in SHAPES], "calls": CALLS, "steps": STEPS,
                      **out}))


if __name__ == "__main__":
    main()
