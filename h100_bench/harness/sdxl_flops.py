"""SDXL's operations and bytes, and the readers of the ``sdxl_base`` cell's
per-layer metrics (``metrics/*.serve_sdxl.py``).

``flops.py`` counts SD's UNets, whose every transformer holds one block
and whose context comes from one tower; it would count SDXL wrong.  Here,
per call, with ``flops.py``'s per-call formulae (K1 4 B H Sq Skv d; K2
2 M N K + 2 M K r + 2 M r N, each input byte read once and each output
byte written once):

* the UNet's transformers with their stacks (``transformer_layers_per_block``:
  70 blocks at SDXL's), each block's self- and cross-attention (77 context
  tokens, 2048 wide) and its nine LoRA'd projections;
* both towers' LoRA'd attention projections, over the rows they encode:
  tower 1 through its second-to-last layer (its last is not run), tower 2
  through all its layers.  With empty negative prompts (the unconditional
  half zeroed) the towers encode the prompts alone;
* whole-image operations (``mfu``): the reference's modules on the meta
  device under ``FlopCounterMode``: tower 1 to its penultimate state and
  tower 2 with its pooled projection over the prompt, ``steps`` UNet calls
  over one row, one VAE decode, and the LoRA products where the adapter
  runs beside the weights.  One row of the CFG pair, as ``flops.py``
  counts SD's image, so that ``mfu.serve_sdxl`` and ``mfu.serve_*`` share
  one rule; the rooflines count the calls as run, over both rows.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Optional, Tuple

import torch

from . import flops as F
from . import program_spans as PS
from . import readers as R

TEXT_TOKENS = F.TEXT_TOKENS


def transformers(unet: dict, latent: int):
    """(tokens, channels, heads, depth) of every transformer of one UNet
    forward: down, mid, up."""
    chans = list(unet["block_out_channels"])

    def per_level(v):
        return list(v) if isinstance(v, list) else [v] * len(chans)
    heads = per_level(unet["attention_head_dim"])
    depth = per_level(unet.get("transformer_layers_per_block", 1))
    n = unet["layers_per_block"]
    last = len(chans) - 1
    out = []
    for i, bt in enumerate(unet["down_block_types"]):
        if bt.startswith("CrossAttn"):
            out += [((latent >> i) ** 2, chans[i], heads[i], depth[i])] * n
    out.append(((latent >> last) ** 2, chans[last], heads[last], depth[last]))
    for i, bt in enumerate(unet["up_block_types"]):
        lvl = last - i
        if bt.startswith("CrossAttn"):
            out += [((latent >> lvl) ** 2, chans[lvl], heads[lvl], depth[lvl])] * (n + 1)
    return out


def _add(calls: Dict[Tuple, int], key, n: int) -> None:
    calls[key] = calls.get(key, 0) + n


def attention_calls(unet: dict, latent: int, rows: int) -> Dict[Tuple, int]:
    """{(B*H, Sq, Skv, d): calls} of one UNet forward over ``rows`` rows."""
    calls: Dict[Tuple, int] = {}
    for s, c, h, d in transformers(unet, latent):
        for skv in (s, TEXT_TOKENS):
            _add(calls, (rows * h, s, skv, c // h), d)
    return calls


def unet_lora_calls(unet: dict, latent: int, rows: int) -> Dict[Tuple, int]:
    """{(M, K, N, bias): calls} of one UNet forward's LoRA'd projections,
    per block: attn1 q, k, v and attn2 q (C -> C), attn1 and attn2 out
    (C -> C, with bias), attn2 k, v (the context, 2048 -> C), the GEGLU
    projection (C -> 8C)."""
    calls: Dict[Tuple, int] = {}
    ctx = unet["cross_attention_dim"]
    for s, c, _, d in transformers(unet, latent):
        _add(calls, (rows * s, c, c, False), 4 * d)
        _add(calls, (rows * s, c, c, True), 2 * d)
        _add(calls, (rows * TEXT_TOKENS, ctx, c, False), 2 * d)
        _add(calls, (rows * s, c, 8 * c, True), d)
    return calls


def text_lora_calls(config: dict, rows: int) -> Dict[Tuple, int]:
    """{(M, K, N, bias): calls} of both towers' LoRA'd attention projections
    over ``rows`` encoded rows (tower 1 runs all but its last layer)."""
    calls: Dict[Tuple, int] = {}
    for kind, run in (("text_encoder", -1), ("text_encoder_2", 0)):
        t = config[kind]
        h = t["hidden_size"]
        _add(calls, (rows * TEXT_TOKENS, h, h, True), 4 * (t["num_hidden_layers"] + run))
    return calls


@functools.lru_cache(maxsize=None)
def _image_flops(config_key: str, side: int, steps: int, rank: int, dynamic: bool,
                 text_lora: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import models as RM
    from ..reference import sdxl as RX

    config = json.loads(config_key)
    with torch.device("meta"):
        m = {k: RX.build(k, config[k]).requires_grad_(False) for k in RX.KINDS}
    if dynamic:
        kinds = ("unet",) + (("text_encoder", "text_encoder_2") if text_lora else ())
        for kind in kinds:
            RM.attach_lora(m[kind], {
                name: (torch.empty(o, rank, device="meta"), torch.empty(rank, i, device="meta"))
                for name, i, o in RX.lora_targets(m[kind], kind)})

    def count(fn) -> int:
        with FlopCounterMode(display=False) as fc:
            fn()
        return int(fc.get_total_flops())

    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    lat = side // f
    u = config["unet"]
    with torch.no_grad():
        ids = torch.zeros((1, TEXT_TOKENS), dtype=torch.long, device="meta")
        t_text = count(lambda: (m["text_encoder"](ids), m["text_encoder_2"](ids)))
        ctx = torch.empty((1, TEXT_TOKENS, u["cross_attention_dim"]), device="meta")
        pooled = torch.empty((1, config["text_encoder_2"]["projection_dim"]), device="meta")
        tids = torch.empty((1, 6), device="meta")
        x = torch.empty((1, u["in_channels"], lat, lat), device="meta")
        t_unet = count(lambda: m["unet"](x, torch.zeros(1, device="meta"), ctx, pooled, tids))
        z = torch.empty((1, u["in_channels"], lat, lat), device="meta")
        t_vae = count(lambda: m["vae"].decode(z))
    return float(t_text + steps * t_unet + t_vae)


def image_flops(config: dict, traffic: dict) -> float:
    """Operations of one served image (see the module's docstring)."""
    ad = traffic["adapters"]
    dynamic = bool(ad["count"]) and not ad.get("materialize", False)
    return _image_flops(json.dumps(config, sort_keys=True), traffic["height"], traffic["steps"],
                        ad["rank"], dynamic, bool(ad.get("text_lora")))


# -- readers ------------------------------------------------------------------

def _es(config: dict) -> int:
    return 2 if config["serve_dtype"] == "bfloat16" else 4


def mfu(m) -> Optional[float]:
    t, n = m["trace"], R.served_images(m)
    if t is None or not n or not t.kernels:
        return None
    peak = F.PEAKS[m["config"]["serve_dtype"]]
    return 100.0 * n * image_flops(m["config"], m["traffic"]) / (t.window_s * peak)


def k2_roofline(m) -> Optional[float]:
    """K2's bound over the calls the dispatched batches imply (the UNet's
    over the CFG pair each step, the towers' once a batch) against the
    device time of the bf16 ``lora_dense`` kernels."""
    cfg, tr = m["config"], m["traffic"]
    dtype, rank = cfg["serve_dtype"], tr["adapters"]["rank"]
    lat = R._latent(m)
    total, calls = 0.0, 0
    for s in R.dispatches(m):
        rows = s[3]["rows"]
        u = unet_lora_calls(cfg["unet"], lat, 2 * rows)
        total += s[3]["steps"] * F.sum_bounds(u, F.k2_cost, _es(cfg), dtype, rank=rank)
        calls += s[3]["steps"] * sum(u.values())
        if tr["adapters"].get("text_lora"):
            tx = text_lora_calls(cfg, rows)
            total += F.sum_bounds(tx, F.k2_cost, _es(cfg), dtype, rank=rank)
            calls += sum(tx.values())

    def lora_dense(name):
        return "lora_dense" in name and "f32" not in name and "tf32" not in name
    return R.roofline(m, lora_dense, total, calls)


def k1_roofline(m) -> Optional[float]:
    """K1's bound over the UNet's attention calls of the dispatched batches
    against the device time of the bf16 flash-forward kernels."""
    cfg = m["config"]
    lat = R._latent(m)
    total, calls = 0.0, 0
    for s in R.dispatches(m):
        a = attention_calls(cfg["unet"], lat, 2 * s[3]["rows"])
        total += s[3]["steps"] * F.sum_bounds(a, F.k1_cost, _es(cfg), cfg["serve_dtype"])
        calls += s[3]["steps"] * sum(a.values())

    def flash_fwd(name):
        return "flash_fwd" in name and "f32" not in name and "packed" not in name
    return R.roofline(m, flash_fwd, total, calls)


def prepare_ms_per_batch(m) -> Optional[float]:
    """Host ms in the program's ``pipe.prepare`` spans that carry ``towers``
    (tokenising for both towers, the vocabulary checks, latents, time ids,
    copies to the device) per ``server.batch``."""
    prog = PS.read(m)
    if prog is None:
        return None
    batches = prog.named("server.batch")
    prep = [s for s in prog.named("pipe.prepare") if "towers" in s.attrs]
    if not batches or not prep:
        return None
    return sum(s.end - s.start for s in prep) / len(batches) / 1e6
