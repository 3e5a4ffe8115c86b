"""Inputs the benchmark makes from ``--seed``, on the device: model weights,
LoRA adapters and the text vocabulary.  The same seed gives the same
tensors, for the program and for the reference alike.

Weights follow torch's default initialisation, drawn in a few large calls:
a linear or conv weight and its bias uniform in +-1/sqrt(fan_in), norm
weights one and biases zero, embedding tables N(0, 1).  Uniform draws come
in chunks of at most :data:`CHUNK` values from one generator on the device,
then are cut into the tensors in key order and rounded once to the dtype
they are served in.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..reference import models

CHUNK = 1 << 28
KINDS = ("unet", "text_encoder", "vae")


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def skeleton(kind: str, cfg: dict) -> nn.Module:
    with torch.device("meta"):
        return models.build(kind, cfg)


def _init_rules(module: nn.Module) -> List[Tuple[str, tuple, str, float]]:
    """(key, shape, rule, bound) for every state-dict entry, in key order."""
    owners = dict(module.named_modules())
    out = []
    for key, p in sorted(module.state_dict().items()):
        owner = owners[key.rsplit(".", 1)[0]]
        leaf = key.rsplit(".", 1)[1]
        if isinstance(owner, nn.Embedding):
            out.append((key, tuple(p.shape), "normal", 1.0))
        elif isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            out.append((key, tuple(p.shape), "one" if leaf == "weight" else "zero", 0.0))
        else:
            fan_in = owner.weight[0].numel()
            out.append((key, tuple(p.shape), "uniform", fan_in ** -0.5))
    return out


def state_dict(kind: str, cfg: dict, seed: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """The weights of one model of the configuration, on ``device``."""
    rules = _init_rules(skeleton(kind, cfg))
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", kind))
    out: Dict[str, torch.Tensor] = {}
    uniform = [r for r in rules if r[2] == "uniform"]
    i = 0
    while i < len(uniform):
        j, n = i, 0
        while j < len(uniform) and (n == 0 or n + _numel(uniform[j][1]) <= CHUNK):
            n += _numel(uniform[j][1])
            j += 1
        buf = torch.rand(n, generator=g, device=device)
        o = 0
        for key, shape, _, b in uniform[i:j]:
            k = _numel(shape)
            out[key] = (buf[o:o + k].view(shape) * (2 * b) - b).to(dtype)
            o += k
        del buf
        i = j
    normal = [r for r in rules if r[2] == "normal"]
    if normal:
        buf = torch.randn(sum(_numel(r[1]) for r in normal), generator=g, device=device)
        o = 0
        for key, shape, _, _ in normal:
            out[key] = buf[o:o + _numel(shape)].view(shape).to(dtype)
            o += _numel(shape)
        del buf
    for key, shape, rule, _ in rules:
        if rule in ("one", "zero"):
            out[key] = (torch.ones if rule == "one" else torch.zeros)(shape, dtype=dtype,
                                                                      device=device)
    return {k: out[k] for k, _, _, _ in rules}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# the target sets of the reference's LoRA defaults: every linear layer under
# a UNet attention or GEGLU, and the text tower's attention projections
def lora_targets(kind: str, cfg: dict) -> List[Tuple[str, int, int]]:
    """(module name, in, out) of the layers a LoRA of ``kind`` covers, sorted."""
    sk = skeleton(kind, cfg)
    if kind == "unet":
        anc = (models.CrossAttention, models.GEGLU)
    else:
        anc = (models.CLIPAttention,)
    names = set()
    for aname, amod in sk.named_modules():
        if isinstance(amod, anc):
            for name, m in amod.named_modules():
                if isinstance(m, nn.Linear):
                    names.add(f"{aname}.{name}")
    mods = dict(sk.named_modules())
    return [(n, mods[n].in_features, mods[n].out_features) for n in sorted(names)]


def lora_pairs(targets, seed: int, tag, rank: int, up_std: float, device,
               dtype=torch.float32) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{module name: (up (out, r), down (r, in))}: down N(0, 1) / r as the
    trainers draw it, up N(0, up_std) (0: a fresh LoRA), one draw for all."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "lora", *tag))
    n_down = sum(rank * i for _, i, _ in targets)
    n_up = sum(o * rank for _, _, o in targets)
    buf = torch.randn(n_down + n_up, generator=g, device=device)
    out, o = {}, 0
    for name, i, _ in targets:
        out[name] = [None, (buf[o:o + rank * i].view(rank, i) / rank).to(dtype)]
        o += rank * i
    for name, _, oo in targets:
        out[name][0] = (buf[o:o + oo * rank].view(oo, rank) * up_std).to(dtype)
        o += oo * rank
    return {k: (v[0], v[1]) for k, v in out.items()}


WORDS = ("a", "photo", "painting", "portrait", "of", "sks", "dog", "cat", "person", "castle",
         "forest", "river", "mountain", "city", "street", "night", "sunset", "morning",
         "red", "blue", "green", "golden", "old", "young", "small", "large", "in", "on",
         "the", "with", "style", "oil", "watercolor", "detailed", "soft", "light",
         "shadow", "snow", "rain", "garden")


def prompt(rng, n_words: int) -> str:
    return " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), n_words))


def tokenizer_tables(words: Sequence[str] = WORDS):
    from ..reference.tokenizer import vocabulary

    return vocabulary(words)
