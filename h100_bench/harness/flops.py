"""Operations and bytes: the yardstick of the rooflines and of ``mfu``.

Per call of the program's kernels (frozen copies of ``chip_smoke.py``'s
per-call formulae, each input byte read once and each output byte written
once): K1, the flash forward, 4 B H Sq Skv d operations; K3, the flash
backward, 8 B H Sq Skv d (its four products dV, dP, dQ, dK; recomputing
the logits is the kernel's choice, not the algorithm's need); K2, the
fused LoRA dense, 2 M N K + 2 M K r + 2 M r N.  The calls a UNet or text
forward makes are listed from the configuration (every transformer's
self- and cross-attention, every LoRA'd projection), so a new configuration
needs no new code.  Whole-model counts (``mfu``) come from running the
reference's modules on the meta device under ``FlopCounterMode``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

PEAK_BF16 = 989e12      # H100 SXM, dense bf16 and fp16
PEAK_TF32 = 494.7e12    # H100 SXM, dense TF32: the fastest rate for fp32 inputs
PEAK_BYTES = 3.35e12    # HBM3
PEAKS = {"bfloat16": PEAK_BF16, "float32": PEAK_TF32}
TEXT_TOKENS = 77


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAKS[dtype], nbytes / PEAK_BYTES)


def k1_cost(bh, sq, skv, d, es):
    return 4 * bh * sq * skv * d, es * bh * (2 * sq + 2 * skv) * d + 4 * bh * sq


def k3_cost(bh, sq, skv, d, es):
    return 8 * bh * sq * skv * d, es * bh * (3 * sq + 4 * skv) * d + 8 * bh * sq


def k2_cost(m, k, n, r, es, bias=True):
    flops = 2 * m * n * k + 2 * m * k * r + 2 * m * r * n
    return flops, es * (m * k + n * k + m * n + (n if bias else 0) + n * r + r * k) + 4


def transformers(unet: dict, latent: int) -> List[Tuple[int, int, int]]:
    """(tokens, channels, heads) of every transformer of one UNet forward."""
    chans = unet["block_out_channels"]
    heads = unet["attention_head_dim"]
    heads = list(heads) if isinstance(heads, list) else [heads] * len(chans)
    n = unet["layers_per_block"]
    out = []
    for i, bt in enumerate(unet["down_block_types"]):
        if bt.startswith("CrossAttn"):
            out += [((latent >> i) ** 2, chans[i], heads[i])] * n
    last = len(chans) - 1
    out.append(((latent >> last) ** 2, chans[last], heads[last]))
    for i, bt in enumerate(unet["up_block_types"]):
        lvl = last - i
        if bt.startswith("CrossAttn"):
            out += [((latent >> lvl) ** 2, chans[lvl], heads[lvl])] * (n + 1)
    return out


def attention_calls(unet: dict, latent: int, rows: int) -> Dict[Tuple, int]:
    """{(B*H, Sq, Skv, d): calls} of one UNet forward over ``rows`` rows."""
    calls: Dict[Tuple, int] = {}
    for s, c, h in transformers(unet, latent):
        for skv in (s, TEXT_TOKENS):
            key = (rows * h, s, skv, c // h)
            calls[key] = calls.get(key, 0) + 1
    return calls


def unet_lora_calls(unet: dict, latent: int, rows: int) -> Dict[Tuple, int]:
    """{(M, K, N, bias): calls} of one UNet forward's LoRA'd projections:
    attn1 q, k, v, out and attn2 q, out (C -> C), attn2 k, v (the text
    tokens, context -> C), the GEGLU projection (C -> 8C)."""
    calls: Dict[Tuple, int] = {}
    ctx = unet["cross_attention_dim"]

    def add(key, n):
        calls[key] = calls.get(key, 0) + n
    for s, c, _ in transformers(unet, latent):
        add((rows * s, c, c, False), 4)       # attn1 q, k, v; attn2 q
        add((rows * s, c, c, True), 2)        # attn1 out, attn2 out
        add((rows * TEXT_TOKENS, ctx, c, False), 2)
        add((rows * s, c, 8 * c, True), 1)
    return calls


def text_lora_calls(text: dict, rows: int) -> Dict[Tuple, int]:
    h = text["hidden_size"]
    return {(rows * TEXT_TOKENS, h, h, True): 4 * text["num_hidden_layers"]}


def sum_bounds(calls: Dict[Tuple, int], cost, es: int, dtype: str, rank=None) -> float:
    tot = 0.0
    for key, n in calls.items():
        f, b = cost(*key[:3], key[3], es) if rank is None else cost(*key[:3], rank, es, key[3])
        tot += n * bound_s(f, b, dtype)
    return tot


# -- whole-model counts, from the reference on the meta device ----------------

def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _lora(model, rank):
    from ..reference import models as RM

    pairs = {}
    for name, m in RM.lora_layers(model).items():
        pairs[name] = (torch.empty(m.out_features, rank, device="meta", requires_grad=True),
                       torch.empty(rank, m.in_features, device="meta", requires_grad=True))
    return pairs


@functools.lru_cache(maxsize=None)
def _models(config_key):
    import json

    from ..reference import models as RM

    config = json.loads(config_key)
    with torch.device("meta"):
        return {k: RM.build(k, config[k]).requires_grad_(False)
                for k in ("unet", "text_encoder", "vae")}


def image_flops(config: dict, traffic: dict) -> float:
    """Operations of one served image: the text tower over the CFG pair,
    ``steps`` UNet calls over it, one VAE decode; the LoRA products too
    where the adapters run beside the weights."""
    import json

    from ..reference import models as RM

    m = _models(json.dumps(config, sort_keys=True))
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    lat = traffic["height"] // f
    ad = traffic["adapters"]
    dynamic = ad["count"] and not ad.get("materialize", False)
    unet, text, vae = m["unet"], m["text_encoder"], m["vae"]
    if dynamic:
        RM.attach_lora(unet, {k: (u.detach(), d.detach()) for k, (u, d) in _lora(unet, ad["rank"]).items()})
        if ad.get("text_lora"):
            RM.attach_lora(text, {k: (u.detach(), d.detach()) for k, (u, d) in _lora(text, ad["rank"]).items()})
    with torch.no_grad():
        ids = torch.zeros((2, TEXT_TOKENS), dtype=torch.long, device="meta")
        t_text = _count(lambda: text(ids))
        ctx = torch.empty((2, TEXT_TOKENS, config["unet"]["cross_attention_dim"]), device="meta")
        x = torch.empty((2, config["unet"]["in_channels"], lat, lat), device="meta")
        t_unet = _count(lambda: unet(x, torch.zeros(2, device="meta"), ctx))
        z = torch.empty((1, config["unet"]["in_channels"], lat, lat), device="meta")
        t_vae = _count(lambda: vae.decode(z))
    RM.attach_lora(unet, None)
    RM.attach_lora(text, None)
    return float(t_text / 2 + traffic["steps"] * t_unet / 2 + t_vae)


def train_step_flops(config: dict, traffic: dict) -> float:
    """Operations of one DreamBooth step: the VAE encode, the text tower,
    the UNet forward and its backward (input gradients through the frozen
    weights, the LoRA pairs' gradients)."""
    import json

    from ..reference import models as RM

    m = _models(json.dumps(config, sort_keys=True))
    unet, text, vae = m["unet"], m["text_encoder"], m["vae"]
    b, side = traffic["batch"], traffic["resolution"]
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    pairs = _lora(unet, traffic["rank"])
    RM.attach_lora(unet, pairs)
    with torch.no_grad():
        px = torch.empty((b, 3, side, side), device="meta")
        t_vae = _count(lambda: vae.encode(px))
        ids = torch.zeros((b, TEXT_TOKENS), dtype=torch.long, device="meta")
        t_text = _count(lambda: text(ids))
    ctx = torch.empty((b, TEXT_TOKENS, config["unet"]["cross_attention_dim"]), device="meta")
    x = torch.empty((b, config["unet"]["in_channels"], side // f, side // f), device="meta")

    def fwd_bwd():
        unet(x, torch.zeros(b, device="meta"), ctx).float().square().mean().backward()
    t_unet = _count(fwd_bwd)
    RM.attach_lora(unet, None)
    return float(t_vae + t_text + t_unet)
