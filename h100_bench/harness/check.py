"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, which works out every input again from the seed.

Serving: each sampled request's served uint8 image against the reference's
fp32 image of the same prompt, seed (the pipeline's latent draw: a
``torch.Generator`` on the device seeded with the request's seed, one
normal draw of (4, h, w)) and adapter (dynamic: the pairs beside the
layers; merged: folded into the weights by the reference).  The numbers:
the mean |difference| of each image in [0, 1] units, the worst image's.

Training: the three steps the run made before its window, against the
reference's three steps from the same weights, LoRA, batches and draws.
Numbers, each by the worst leaf where it is per leaf: the loss's relative
gap at each step; |‖g‖ - ‖g_ref‖| of the first step's clipped gradient, the
program's read from AdamW's first moment after one step (m / (1 - beta1));
|‖Δ‖ - ‖Δ_ref‖| of each leaf's change over the three steps, the median
leaf's; both against max(the leaf's reference norm, the median leaf's).  Leaves whose reference
gradient (or change) is under a thousandth of the median leaf's are left
out: they move by round-off alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import models as RM
from ..reference import numerics
from ..reference import pipeline as RP
from ..reference import tokenizer as RT
from . import weights as W

NEGLIGIBLE = 1e-3  # a leaf's norm under this share of the median leaf's is not compared


def reference_models(config: dict, seed: int, served_dtype: torch.dtype, device,
                     kinds=W.KINDS) -> Dict[str, torch.nn.Module]:
    """The reference's modules, fp32, holding the seed's weights as the
    program was served them (rounded once to ``served_dtype``)."""
    out = {}
    for kind in kinds:
        sd = W.state_dict(kind, config[kind], seed, served_dtype, device)
        with torch.device("meta"):
            m = RM.build(kind, config[kind])
        m.load_state_dict({k: v.float() for k, v in sd.items()}, assign=True)
        out[kind] = m.eval().requires_grad_(False)
        del sd
    return out


def ids(prompts: List[str], device) -> torch.Tensor:
    vocab, merges = W.tokenizer_tables()
    return torch.tensor(RT.encode(prompts, vocab, merges), dtype=torch.long, device=device)


def serve_reference(config: dict, traffic: dict, seed: int, samples: List[dict],
                    pairs: Dict[str, dict], device, mode: str = "fp32",
                    models: Optional[dict] = None) -> List[np.ndarray]:
    """The reference's fp32 images of the sampled requests; ``pairs`` holds
    each adapter's LoRA pairs ({name: {"unet": ..., "text": ... or None}}),
    and the traffic's ``scheduler`` picks the reference's sampler."""
    served = {"float32": torch.float32, "bfloat16": torch.bfloat16}[config["serve_dtype"]]
    models = models or reference_models(config, seed, served, device)
    unet, text, vae = models["unet"], models["text_encoder"], models["vae"]
    sched = RP.Schedule(config["scheduler"])
    sample = RP.sampler(traffic["scheduler"])
    merged = traffic["adapters"].get("materialize", False)
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    shape = (config["unet"]["in_channels"], traffic["height"] // f, traffic["width"] // f)
    with numerics.precision(mode):
        for name in sorted({s["adapter"] for s in samples}, key=str):
            group = [s for s in samples if s["adapter"] == name]
            p = pairs.get(name)
            if p is not None and merged:
                RM.merge_lora(unet, p["unet"])
                if p["text"]:
                    RM.merge_lora(text, p["text"])
            elif p is not None:
                RM.attach_lora(unet, p["unet"])
                RM.attach_lora(text, p["text"])
            for s in group:
                g = torch.Generator(device=device).manual_seed(int(s["seed"]))
                lat = torch.randn(shape, generator=g, device=device)[None]
                img = RP.txt2img(unet, text, vae, sched, sample, ids([s["prompt"]], device),
                                 ids([""], device), lat, traffic["guidance"], traffic["steps"])
                s["_ref"] = img[0].cpu().numpy()
            if p is not None and merged:  # take the merge out again
                neg = {k: (-u, d) for k, (u, d) in p["unet"].items()}
                RM.merge_lora(unet, neg)
                if p["text"]:
                    RM.merge_lora(text, {k: (-u, d) for k, (u, d) in p["text"].items()})
            RM.attach_lora(unet, None)
            RM.attach_lora(text, None)
    return [s.pop("_ref") for s in samples]


def held(gaps: Dict[str, float], limits: Dict[str, float], names) -> List[tuple]:
    """(name, number, limit, within it) of each number; one the cell does
    not compare (see PERF.md for why) is printed with no limit."""
    return [(k, gaps[k], limits[k], gaps[k] <= limits[k]) if k in limits
            else (f"{k} (not compared)", gaps[k], None, True) for k in names]


def image_gaps(served: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, float]:
    """Worst image's mean |served - reference| in [0, 1] units, and the
    worst image's share of pixels off by more than 16/255."""
    means, far = [], []
    for a, b in zip(served, ref):
        a = a.astype(np.float64) / 255.0 if a.dtype == np.uint8 else a.astype(np.float64)
        d = np.abs(a - b.astype(np.float64))
        means.append(float(d.mean()))
        far.append(float((d > 16 / 255).mean()))
    return {"image_mean_abs_gap": max(means) if means else float("inf"),
            "image_far_pixel_share": max(far) if far else float("inf")}


def _norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """Each compared leaf's |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    return [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in ref if rn[k] >= NEGLIGIBLE * med]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The loss's worst relative gap over the steps; the first gradient's
    worst leaf; the change's median leaf (its worst leaf swings from seed
    to seed, see PERF.md, and is reported beside it)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g = _norm_gaps(prog["first_grad"], ref["first_grad"])
    c = _norm_gaps(prog["change"], ref["change"])
    return {"loss_gap": max(losses), "grad_norm_gap": max(g),
            "change_norm_gap": float(np.median(c)), "change_norm_gap_worst_leaf": max(c),
            "grad_leaves": len(g), "change_leaves": len(c)}


def train_reference(config: dict, seed: int, compute_dtype: torch.dtype, init: dict,
                    batches: List[dict], draws: List[dict], opt: dict, device,
                    mode: str = "fp32") -> dict:
    """The reference's three steps from the run's inputs."""
    models = reference_models(config, seed, compute_dtype, device)
    unet, text, vae = models["unet"], models["text_encoder"], models["vae"]
    params = {}
    pairs = {}
    for name, (up, down) in init.items():
        params[f"{name}.up"] = up.detach().to(device, torch.float32).clone().requires_grad_(True)
        params[f"{name}.down"] = down.detach().to(device, torch.float32).clone().requires_grad_(True)
        pairs[name] = (params[f"{name}.up"], params[f"{name}.down"])
    RM.attach_lora(unet, pairs)
    sched = RP.Schedule(config["scheduler"])
    with numerics.precision(mode):
        out = RP.train_steps(unet, text, vae, sched, params,
                             [{k: torch.as_tensor(v).to(device) for k, v in b.items()}
                              for b in batches],
                             [{k: v.to(device) for k, v in d.items()} for d in draws], opt)
    RM.attach_lora(unet, None)
    return out
