"""Host time of the kernel wrappers and of a UNet step: this checkout
against another one, on one card.

    python3 -m diffusion_finetuning_tpu_torch.host_cost --against DIR

``DIR`` is the root of another checkout (a parent commit unpacked with
``git archive``, say).  Its ``diffusion_finetuning_tpu_torch`` is imported
under another module name, so that both packages live in one process and
take turns on the card, in rounds ordered this, other, other, this: a drift
in the shared host's speed then falls on both.  Each turn measures

* host microseconds per call of ``ops.flash_attention._fwd_cuda`` (K1, BH
  16) and ``_bwd_cuda`` (K3, BH 8) at SD1.5's eight attention shapes, of
  ``ops.lora_matmul._lora_dense_cuda`` (K2) at the UNet step's LoRA'd
  projections and of ``ops.conv3x3._conv3x3_cuda`` (K5) at its routed
  convs (CFG batch 2): the time to enqueue ``CALLS`` calls without waiting
  for the card, which is all the host does per call (Python, ctypes, the
  plan, the C entry's tensor-map encodes, the launch);
* wall ms of a full-width SD1.5 UNet step (CFG batch 2, 64x64 latents,
  bf16, random weights), ``STEPS`` steps ending in a synchronize, without
  a LoRA and with a rank-4 LoRA attached (the dynamic-LoRA step: 144 K2
  calls).

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
# (M, K, N, calls a UNet step) of the LoRA'd projections at CFG batch 2
LORA_SHAPES = [shape for m, c, blocks in ((8192, 320, 5), (2048, 640, 5), (512, 1280, 5),
                                          (128, 1280, 1))
               for shape in ((m, c, c, 6 * blocks), (154, 768, c, 2 * blocks),
                             (m, c, 8 * c, blocks))]
# (B, C, H, W, O, calls a UNet step) of the convs routed to K5 at CFG batch 2
CONV_SHAPES = [(2, 320, 64, 64, 320, 7), (2, 320, 32, 32, 640, 1), (2, 640, 32, 32, 640, 6),
               (2, 640, 16, 16, 1280, 1), (2, 1280, 16, 16, 1280, 6),
               (2, 1280, 8, 8, 1280, 11), (2, 1280, 32, 32, 640, 1),
               (2, 960, 32, 32, 640, 1), (2, 960, 64, 64, 320, 1), (2, 640, 64, 64, 320, 2)]
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
    """One checkout's kernel wrappers and UNet on shared inputs."""

    def __init__(self, pkg: str, inputs, unet_state):
        import torch

        self.fa = importlib.import_module(f"{pkg}.ops.flash_attention")
        self.lm = importlib.import_module(f"{pkg}.ops.lora_matmul")
        self.cv = importlib.import_module(f"{pkg}.ops.conv3x3")
        self.lora = importlib.import_module(f"{pkg}.lora")
        unet_mod = importlib.import_module(f"{pkg}.models.unet")
        with torch.device("cuda"):
            self.unet = unet_mod.UNet2DConditionModel(unet_mod.UNetConfig.sd15())
        self.unet = self.unet.to(torch.bfloat16).eval()
        if unet_state is not None:
            self.unet.load_state_dict(unet_state)
        self.inputs = inputs

    def step_ms(self) -> float:
        import torch

        x, t, ctx = self.inputs["unet"]
        self.unet(x, t, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            self.unet(x, t, ctx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    def turn(self) -> dict:
        """One turn: host us per K1, K3, K2 and K5 call at every shape, UNet
        step ms without and with the LoRA."""
        import torch

        fa, lm, cv = self.fa, self.lm, self.cv
        fwd, bwd = [], []
        with torch.inference_mode():
            for (sq, skv, d, _), (fw, bw) in zip(SHAPES, self.inputs["flash"]):
                scale = d ** -0.5
                fwd.append(enqueue_us(lambda: fa._fwd_cuda(*fw, scale)))
                q, k, v, lse, delta, do = bw
                bwd.append(enqueue_us(lambda: fa._bwd_cuda(q, k, v, lse, delta, do, scale)))
            lora = [enqueue_us(lambda: lm._lora_dense_cuda(*args))
                    for args in self.inputs["lora"]]
            conv = [enqueue_us(lambda: cv._conv3x3_cuda(x, w, None))
                    for x, w in self.inputs["conv"]]
            step = self.step_ms()
            with self.lora.attached(self.unet, self.inputs["lora_tree"]):
                lora_step = self.step_ms()
        return {"fwd_us": fwd, "bwd_us": bwd, "lora_us": lora, "conv_us": conv,
                "unet_step_ms": step, "unet_step_ms_dynamic_lora": lora_step}


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
    lora = [(randn(m, k), randn(n, k) * k ** -0.5, randn(n) * 0.1, randn(n, 4) * 0.1,
             randn(4, k) * 0.25, torch.tensor(0.8, device="cuda"))
            for m, k, n, _ in LORA_SHAPES]
    conv = [(randn(b, c, h, w), randn(o, c, 3, 3) / (3 * c ** 0.5))
            for b, c, h, w, o, _ in CONV_SHAPES]
    unet = (randn(2, 4, 64, 64), torch.tensor([500, 500], device="cuda"), randn(2, 77, 768))
    return {"flash": flash, "lora": lora, "conv": conv, "unet": unet,
            "lora_tree": lora_tree()}


def lora_tree():
    """A rank-4 LoRA on SD1.5's default UNet targets (bf16, on the card,
    non-zero up), from this checkout's ``lora`` module."""
    import torch

    lora = importlib.import_module(f"{THIS}.lora")
    unet = importlib.import_module(f"{THIS}.models.unet")
    g = torch.Generator().manual_seed(1)
    targets = lora.filter_targets(unet.unet_lora_targets(unet.UNetConfig.sd15()),
                                  lora.DEFAULT_TARGET_REPLACE)
    tree = lora.inject_trainable_lora(targets, g, r=4, dtype=torch.bfloat16)
    for _, leaf in lora.lora_leaves(tree):
        leaf["up"] = (torch.randn(leaf["up"].shape, generator=g) * 0.01).bfloat16()

    def to_card(node):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda() for k, v in node.items()}

    return to_card(tree)


def summary(turns) -> dict:
    """Medians over a tree's turns, per shape and summed over one step's calls."""
    out = {}
    for key, shapes in (("fwd", SHAPES), ("bwd", SHAPES), ("lora", LORA_SHAPES),
                        ("conv", CONV_SHAPES)):
        us = [statistics.median(t[f"{key}_us"][i] for t in turns) for i in range(len(shapes))]
        out[f"{key}_us"] = us
        out[f"{key}_us_a_step"] = sum(u * s[-1] for u, s in zip(us, shapes))
    for key in ("unet_step_ms", "unet_step_ms_dynamic_lora"):
        out[key] = statistics.median(t[key] for t in turns)
        out[f"{key}_all"] = [t[key] for t in turns]
    return out


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
        before = (tree.fa.launches, tree.fa.bwd_launches, tree.lm.launches, tree.cv.launches)
        tree.turn()
        after = (tree.fa.launches, tree.fa.bwd_launches, tree.lm.launches, tree.cv.launches)
        if not all(a > b for a, b in zip(after, before)):
            sys.exit(f"a tree left a kernel unlaunched: {before} -> {after}")
    turns = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            turns[name].append(trees[name].turn())
    out = {name: summary(t) for name, t in turns.items()}
    for name, s in out.items():
        for key, label in (("fwd", "K1"), ("bwd", "K3"), ("lora", "K2"), ("conv", "K5")):
            print(f"{name}: {label} host us/call " + " ".join(f"{u:.1f}" for u in s[f"{key}_us"])
                  + f" ({s[f'{key}_us_a_step']:.1f} a step)", flush=True)
        for key in ("unet_step_ms", "unet_step_ms_dynamic_lora"):
            print(f"{name}: {key} {s[key]:.3f} (turns "
                  + ", ".join(f"{m:.3f}" for m in s[f"{key}_all"]) + ")", flush=True)
    print(json.dumps({"shapes": [list(s) for s in SHAPES], "lora_shapes": LORA_SHAPES,
                      "conv_shapes": CONV_SHAPES, "calls": CALLS, "steps": STEPS, **out}))


if __name__ == "__main__":
    main()
