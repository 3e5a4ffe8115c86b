"""The training driver (``"driver": "train"``): DreamBooth as
``train_lora_dreambooth.py`` builds it
(its dataset, ``DataLoader`` with prefetch, AdamW, ``build_train_step``,
``FusedDispatcher.drive`` with CUDA graphs), from the benchmark's weights on
the device.

Traffic keys (``traffic/<name>.json``, ``"driver": "train"``):
``resolution``, ``batch``, ``images`` (seeded PNG instance images written
under ``TMPDIR``), ``instance_prompt``, ``rank``, ``lr``, ``betas``,
``eps``, ``weight_decay``, ``max_grad_norm``, ``steps_per_dispatch``,
``dtype`` (``float32``: the trainers' default; ``bfloat16``:
``--mixed_precision bf16``), ``check_steps`` (steps made before the window
and compared with the reference), ``check`` (``limits``, ``control``).

One train state goes through the whole run: set-up drives it through the
first ``check_steps`` steps, on distinct images, through the same call and
loader as the window, and keeps what the comparison needs; the window then
continues it.  The benchmark hands each step its random draws (the
posterior sample, the noise, the timesteps), made from the seed.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from h100_bench.harness import check as C
from h100_bench.harness import program as P
from h100_bench.harness import weights as W


def write_images(folder: Path, seed: int, n: int, side: int) -> None:
    """``n`` seeded smooth RGB images, PNG, ``side``^2."""
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(W.sub_seed(seed, "images"))
    for i in range(n):
        coarse = rng.random((side // 32, side // 32, 3)).astype(np.float32)
        img = np.kron(coarse, np.ones((32, 32, 1), np.float32))
        img = img + 0.15 * rng.standard_normal((side, side, 3)).astype(np.float32)
        u8 = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        Image.fromarray(u8).save(folder / f"{i:03d}.png")


def draws_for(seed: int, step: int, batch: int, latent: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s draws: posterior sample and noise (B, h, w, 4), fp32,
    and timesteps in [0, 1000)."""
    g = torch.Generator(device=device).manual_seed(W.sub_seed(seed, "draws", step))
    shape = (batch, latent, latent, 4)
    return {"sample": torch.randn(shape, generator=g, device=device),
            "noise": torch.randn(shape, generator=g, device=device),
            "timesteps": torch.randint(0, 1000, (batch,), generator=g, device=device)}


def opt_of(traffic: dict) -> Dict[str, Any]:
    """The optimizer's settings, for the program and the reference alike."""
    return {"lr": traffic["lr"], "betas": tuple(traffic["betas"]), "eps": traffic["eps"],
            "weight_decay": traffic["weight_decay"], "max_grad_norm": traffic["max_grad_norm"]}


class Run:
    """Set-up, window and check inputs of one training run."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.device = ctx.device
        self.loader_waits: List[float] = []

    def setup(self):
        from diffusion_finetuning_tpu_torch.data.dataset import DataLoader, DreamBoothDataset
        from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler
        from diffusion_finetuning_tpu_torch.training.optim import (ParamGroup,
                                                                   multi_group_optimizer)
        from diffusion_finetuning_tpu_torch.training.train_step import (FusedDispatcher,
                                                                        TrainablePartition,
                                                                        build_train_step,
                                                                        init_train_state)

        ctx, tr = self.ctx, self.tr
        P.build_kernels(self.device)
        self.dtype = P.DTYPES[tr["dtype"]]
        pipe = self.pipe = P.make_pipe(self.cfg, ctx.seed, self.dtype, self.device)
        folder = Path(tempfile.mkdtemp(prefix="h100_bench_instance_"))
        self.folder = folder
        write_images(folder, ctx.seed, tr["images"], tr["resolution"])
        dataset = DreamBoothDataset(instance_data_root=str(folder),
                                    instance_prompt=tr["instance_prompt"],
                                    tokenizer=pipe.tokenizer, size=tr["resolution"],
                                    center_crop=False, color_jitter=False, resize=True,
                                    seed=ctx.seed % 2 ** 32)
        pad = pipe.tokenizer.encoder[pipe.tokenizer.pad_token]
        self.loader = DataLoader(dataset, tr["batch"], pad, seed=ctx.seed % 2 ** 32)
        targets = W.lora_targets("unet", self.cfg["unet"])
        self.init = W.lora_pairs(targets, ctx.seed, ("train",), tr["rank"], 0.0, self.device)
        opt = opt_of(tr)
        optimizer = multi_group_optimizer(
            {"unet_lora": ParamGroup(lr=opt["lr"], schedule="constant", warmup_steps=0,
                                     total_steps=10 ** 9, weight_decay=opt["weight_decay"],
                                     betas=opt["betas"], eps=opt["eps"])},
            max_grad_norm=opt["max_grad_norm"])
        step_fn = build_train_step(
            unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
            scheduler=DDPMScheduler(pipe.scheduler_config), optimizer=optimizer,
            partition=TrainablePartition(unet_lora=True, text_lora=False, ti=False))
        self.state = init_train_state(optimizer, unet_lora=P.lora_tree(pipe, "unet", self.init),
                                      device=self.device)
        self.dispatcher = FusedDispatcher(step_fn, spd=tr["steps_per_dispatch"],
                                          cuda_graphs=ctx.cuda_graphs)
        self.seen: List[dict] = []
        self._stream = self._batches()
        latent = tr["resolution"] // 2 ** (len(self.cfg["vae"]["block_out_channels"]) - 1)
        self.latent = latent
        gen = torch.Generator(device=self.device).manual_seed(W.sub_seed(ctx.seed, "rng"))
        self.drive = self.dispatcher.drive(
            self.state, gen, self._take, 10 ** 12,
            draws=lambda s: draws_for(ctx.seed, s, tr["batch"], latent, self.device))
        self._first_steps()

    def _batches(self):
        while True:
            for batch in self.loader:
                yield batch

    def _take(self, gs):
        take = self.tr["steps_per_dispatch"]
        group = []
        with self.ctx.spans.span("loader_next"):
            t0 = time.perf_counter()
            for _ in range(take):
                group.append(next(self._stream))
            self.loader_waits.append(time.perf_counter() - t0)
        if len(self.seen) < self.tr["check_steps"]:
            self.seen.extend({k: np.array(v) for k, v in b.items()} for b in group)
        return group

    def _leaf_names(self):
        """Each trainable tensor of the state by the benchmark's leaf name."""
        from diffusion_finetuning_tpu_torch import lora as lora_lib

        out = {}
        for path, leaf in lora_lib.lora_leaves(self.state["params"]["unet_lora"]):
            name = lora_lib.module_name(path, getattr(self.pipe.unet, "lora_prefix", ""))
            out[id(leaf["up"])] = f"{name}.up"
            out[id(leaf["down"])] = f"{name}.down"
        return out

    def _snapshot(self) -> Dict[str, torch.Tensor]:
        ids = self._leaf_names()
        return {ids[id(t)]: t.detach().clone()
                for t in self.state["opt_state"].groups["unet_lora"]}

    def _first_steps(self):
        """The first ``check_steps`` steps: the first captures the step's
        graph; after it AdamW's first moment gives the gradient it took."""
        n = self.tr["check_steps"]
        start = self._snapshot()
        losses, first_grad = [], None
        b1 = self.tr["betas"][0]
        steps = 0
        while steps < n:
            _, loss, stepped, _ = next(self.drive)
            steps += stepped
            losses += [float(x) for x in loss.flatten()]
            if first_grad is None:
                ost = self.state["opt_state"]
                views = ost.layouts["unet_lora"].views(ost.moments["unet_lora"]["m"])
                ids = self._leaf_names()
                first_grad = {ids[id(t)]: (v / (1 - b1)).clone()
                              for t, v in zip(ost.groups["unet_lora"], views)}
        after = self._snapshot()
        self.check_prog = {"losses": losses[:n], "first_grad": first_grad,
                           "change": {k: after[k] - start[k] for k in start}}
        self.check_batches = self.seen[:n]
        self.check_draws = [draws_for(self.ctx.seed, s, self.tr["batch"], self.latent,
                                      self.device) for s in range(n)]
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.loader_waits.clear()
        t0 = time.perf_counter()
        self.t_open = t0
        steps = 0
        while time.perf_counter() - t0 < self.ctx.seconds:
            with self.ctx.spans.span("drive"):
                _, _, stepped, _ = next(self.drive)
            steps += stepped
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_close = self.t_drained = time.perf_counter()
        self.steps = steps

    def end_to_end(self) -> Dict[str, Any]:
        el = self.t_close - self.t_open
        return {"attempted": self.steps, "failed": 0,
                "train_samples_per_s": self.steps * self.tr["batch"] / el,
                "steps": self.steps, "graphs_in_window": 0}

    def close(self):
        """Stop the loader and the dispatch, drop every reference to the
        program."""
        self.drive.close()
        self._stream.close()  # the loader's prefetch thread stops
        import shutil

        shutil.rmtree(self.folder, ignore_errors=True)
        del self.drive, self.dispatcher, self.state, self.pipe, self.loader, self._stream

    def control_inputs(self) -> Dict[str, Any]:
        """The steps made in set-up are the readings: no window."""
        return self.check_inputs()

    def check_inputs(self) -> Dict[str, Any]:
        return {"prog": self.check_prog, "batches": self.check_batches,
                "draws": [{k: v.cpu() for k, v in d.items()} for d in self.check_draws],
                "init": {k: (u.cpu(), d.cpu()) for k, (u, d) in self.init.items()}}



def _reference(ctx, inputs, mode: str = "fp32") -> dict:
    tr = ctx.traffic
    return C.train_reference(ctx.config, ctx.seed, P.DTYPES[tr["dtype"]], inputs["init"],
                             inputs["batches"], inputs["draws"], opt_of(tr), ctx.device,
                             mode=mode)


def checks(ctx, inputs) -> List[tuple]:
    """The loader's stage on its own, then the first steps against the
    reference's."""
    vocab_ok, distinct = _data_ok(ctx, inputs["batches"])
    gaps = C.train_gaps(inputs["prog"], _reference(ctx, inputs))
    out = [("batches_are_instance_images", vocab_ok, True, vocab_ok),
           ("distinct_rows", distinct, True, distinct)]
    return out + C.held(gaps, ctx.traffic["check"]["limits"],
                        ("loss_gap", "grad_norm_gap", "change_norm_gap",
                         "change_norm_gap_worst_leaf"))


def readings(ctx, inputs, mode: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(program's numbers, the control's: the reference's steps in
    ``mode``) against the fp32 reference."""
    ref = _reference(ctx, inputs)
    return (C.train_gaps(inputs["prog"], ref), C.train_gaps(_reference(ctx, inputs, mode), ref))


def _data_ok(ctx, batches):
    """The stage the reference takes from the program's loader, checked on
    its own: each row is one of the instance images, byte for byte, under
    the instance prompt's ids; the compared steps' rows all differ."""
    from PIL import Image

    from h100_bench.reference import tokenizer as RT

    tr = ctx.traffic
    with tempfile.TemporaryDirectory() as d:
        write_images(Path(d), ctx.seed, tr["images"], tr["resolution"])
        imgs = [np.asarray(Image.open(p).convert("RGB")) for p in sorted(Path(d).iterdir())]
    vocab, merges = W.tokenizer_tables()
    want_ids = np.asarray(RT.encode([tr["instance_prompt"]], vocab, merges)[0])
    seen, ok = [], True
    for b in batches:
        px = np.asarray(b["pixel_values"])
        if px.dtype != np.uint8:
            px = np.clip(np.rint((px + 1.0) * 127.5), 0, 255).astype(np.uint8)
        for row, ids in zip(px, np.asarray(b["input_ids"])):
            hit = [i for i, im in enumerate(imgs) if np.array_equal(im, row)]
            ok = ok and len(hit) == 1 and np.array_equal(ids, want_ids)
            seen += hit
    return bool(ok), len(seen) == len(set(seen))
