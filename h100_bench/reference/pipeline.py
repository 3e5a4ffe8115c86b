"""The reference's txt2img and DreamBooth steps, in plain PyTorch.

txt2img: the CLIP encode of ``[uncond; cond]``, the sampler of
``samplers/<name>.py`` under the traffic's ``scheduler`` name, classifier-free
guidance ``eps_u + g (eps_c - eps_u)``, the VAE decode of ``x / 0.18215`` and
``clip(x / 2 + 0.5, 0, 1)``, all in fp32.  Epsilon or v prediction as the
configuration's scheduler states; the betas of ``betas/<name>.py`` under
its ``beta_schedule``.  A name with no file stops the run: a traffic mix
with another sampler adds its file.

DreamBooth: ``latents = (mean + std * sample) * 0.18215`` from the VAE
posterior, ``noisy = sqrt(a_t) latents + sqrt(1 - a_t) noise``, the UNet
on the CLIP encoding of the instance prompt, the fp32 MSE against the
noise (or the velocity), the LoRA pairs' gradients, global-norm clipping
and AdamW as optax computes them (decoupled decay, bias-corrected moments,
eps outside the square root).
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from .models import SCALING_FACTOR

_HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def _part(kind: str, name: str):
    """The module of ``<kind>/<name>.py`` beside this file: a sampler, a
    beta schedule."""
    path = _HERE / kind / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not path.is_file():
        have = sorted(p.stem for p in (_HERE / kind).glob("*.py"))
        raise ValueError(f"the reference has no {kind[:-1]} {name!r} (it has {have})")
    spec = importlib.util.spec_from_file_location(f"h100_bench_reference_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Schedule:
    def __init__(self, cfg: dict):
        n = cfg["num_train_timesteps"]
        betas = _part("betas", cfg["beta_schedule"]).betas(cfg["beta_start"], cfg["beta_end"], n)
        ac = np.cumprod(1.0 - betas)
        self.n = n
        self.prediction = cfg["prediction_type"]
        self.alphas_cumprod = torch.tensor(ac, dtype=torch.float32)
        self.alpha = torch.tensor(np.sqrt(ac), dtype=torch.float32)
        self.sigma = torch.tensor(np.sqrt(1.0 - ac), dtype=torch.float32)
        self.lam = torch.tensor(np.log(np.sqrt(ac)) - np.log(np.sqrt(1.0 - ac)),
                                dtype=torch.float32)
        self.final = (torch.tensor(1.0) if cfg["set_alpha_to_one"]
                      else self.alphas_cumprod[0])

    def timesteps(self, steps: int) -> List[int]:
        return (np.linspace(0, self.n - 1, steps + 1).round()[::-1][:-1]
                .astype(np.int64).tolist())

    def x0(self, out, x, t):
        a, s = self.alpha[t], self.sigma[t]
        return (x - s * out) / a if self.prediction == "epsilon" else a * x - s * out

    def target(self, x0, noise, t):
        if self.prediction == "epsilon":
            return noise
        a = self.alphas_cumprod.to(x0.device)[t].reshape(-1, 1, 1, 1)
        return torch.sqrt(a) * noise - torch.sqrt(1 - a) * x0

    def add_noise(self, x0, noise, t):
        a = self.alphas_cumprod.to(x0.device)[t].reshape(-1, 1, 1, 1)
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise


@torch.no_grad()
def txt2img(unet, text, vae, sched: Schedule, sample, ids_cond, ids_uncond, latents,
            guidance: float, steps: int) -> torch.Tensor:
    """(B, H, W, 3) fp32 images in [0, 1] from (B, 4, h, w) initial latents;
    ``sample`` is a sampler's ``sample`` (:func:`sampler`)."""
    b = latents.shape[0]
    context = text(torch.cat([ids_uncond, ids_cond]))

    def eps(x, t):
        out = unet(torch.cat([x, x]), torch.full((2 * b,), t, device=x.device), context)
        eps_u, eps_c = out.chunk(2)
        return eps_u + guidance * (eps_c - eps_u)

    x = sample(eps, sched, latents.float(), steps)
    img = vae.decode(x / SCALING_FACTOR)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


def sampler(name: str):
    """``sample(eps, sched, x, steps)`` of ``samplers/<name>.py``, under the
    program's name of the sampler."""
    return _part("samplers", name).sample


def train_steps(unet, text, vae, sched: Schedule, params: Dict[str, torch.Tensor],
                batches: Sequence[dict], draws: Sequence[dict], opt: dict) -> dict:
    """``len(batches)`` DreamBooth steps on the LoRA ``params`` ({name:
    fp32 leaf}, updated in place; the models read them through their
    ``lora`` slots).  Returns the losses, the first step's clipped gradient
    of each leaf and each leaf's change over the steps."""
    names = sorted(params)
    start = {k: params[k].detach().clone() for k in names}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    b1, b2 = opt["betas"]
    losses, first_grad = [], None
    for step, (batch, d) in enumerate(zip(batches, draws)):
        for k in names:
            params[k].grad = None
        with torch.no_grad():
            px = batch["pixel_values"]
            px = px.float() / 255.0 * 2.0 - 1.0 if px.dtype == torch.uint8 else px.float()
            mean, std = vae.encode(px.permute(0, 3, 1, 2))
            x0 = (mean + std * d["sample"].permute(0, 3, 1, 2)) * SCALING_FACTOR
            noise = d["noise"].permute(0, 3, 1, 2)
            t = d["timesteps"].long()
            noisy = sched.add_noise(x0, noise, t)
            context = text(batch["input_ids"].long())
        pred = unet(noisy, t, context)
        loss = ((pred - sched.target(x0, noise, t)) ** 2).mean()
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: params[k].grad if params[k].grad is not None else torch.zeros_like(params[k])
                 for k in names}
            norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            if norm >= opt["max_grad_norm"]:
                g = {k: x / norm * opt["max_grad_norm"] for k, x in g.items()}
            if first_grad is None:
                first_grad = {k: x.clone() for k, x in g.items()}
            c = step + 1
            for k in names:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                mhat = m[k] / (1 - b1 ** c)
                vhat = v[k] / (1 - b2 ** c)
                params[k] -= opt["lr"] * (mhat / (torch.sqrt(vhat) + opt["eps"])
                                          + opt["weight_decay"] * params[k])
    return {"losses": losses, "first_grad": first_grad,
            "change": {k: (params[k].detach() - start[k]) for k in names}}
