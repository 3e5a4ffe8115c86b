"""LoRA addressing and serving (port of the JAX package's ``lora.py`` subset).

LoRA trees are the JAX package's: nested dicts addressed by the JAX module
paths, leaves ``{"up": (out, r), "down": (r, in), "scale": ()}`` in the
on-disk torch layout (lora.py:41-43 of the reference), so one tree moves
between the packages with no transposes.  Here the leaves are torch tensors.

A :class:`LoraTarget` keeps the JAX ``path``; :func:`module_name` maps it to
the port's ``nn.Module`` name (``("down_blocks_0_attentions_0",
"transformer_blocks_0", "attn1", "to_q")`` <->
``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q``).  A model
class names the prefix under which its targets sit (``lora_prefix``: empty
for the UNet, ``text_model.encoder.`` for CLIP).

Serving applies a tree in one of two ways, as the JAX pipeline does:
:func:`attached` sets it on the LoRA layers for the dynamic path (the fused
LoRA kernel on the card), :func:`materialize_lora_tree` folds it into the
weights once (``W += scale * up @ down``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Set, Tuple

import torch
from torch import nn

from .tree_util import Path, tree_set

__all__ = [
    "UNET_DEFAULT_TARGET_REPLACE",
    "UNET_EXTENDED_TARGET_REPLACE",
    "TEXT_ENCODER_DEFAULT_TARGET_REPLACE",
    "DEFAULT_TARGET_REPLACE",
    "LoraTarget",
    "filter_targets",
    "module_name",
    "inject_trainable_lora",
    "lora_leaves",
    "attached",
    "materialize_lora_tree",
    "tune_lora_scale",
]

# Ancestor-class target sets: the reference's strings (lora.py:53-56)
UNET_DEFAULT_TARGET_REPLACE = {"CrossAttention", "Attention", "GEGLU"}
TEXT_ENCODER_DEFAULT_TARGET_REPLACE = {"CLIPAttention"}
DEFAULT_TARGET_REPLACE = UNET_DEFAULT_TARGET_REPLACE
UNET_EXTENDED_TARGET_REPLACE = UNET_DEFAULT_TARGET_REPLACE | {"ResnetBlock2D"}


@dataclasses.dataclass(frozen=True)
class LoraTarget:
    """One LoRA-capable layer: its JAX module ``path``, its features, the
    reference ancestor class the target sets match against, and for conv
    targets the kernel size (pairs are then up (out, r, 1, 1), down
    (r, in, kh, kw))."""

    path: Path
    in_features: int
    out_features: int
    ancestor: str
    kernel_size: Optional[Tuple[int, int]] = None

    @property
    def is_conv(self) -> bool:
        return self.kernel_size is not None


def filter_targets(targets: Sequence[LoraTarget],
                   target_replace_module: Set[str]) -> List[LoraTarget]:
    """Targets whose ancestor is in the replace set, in canonical order."""
    keep = set(target_replace_module)
    return [t for t in targets if t.ancestor in keep]


_INDEX = re.compile(r"_(\d+)")
_CONTAINER = re.compile(r"_(attentions|resnets|downsamplers|upsamplers)\b")


def module_name(path: Sequence[str], prefix: str = "") -> str:
    """JAX module path -> the port's module name.  ``name_<i>`` becomes
    ``name.<i>`` and a block's containers a level of their own
    (``down_blocks_0_attentions_0`` -> ``down_blocks.0.attentions.0``,
    ``mid_block_attentions_0`` -> ``mid_block.attentions.0``, ``net_0`` ->
    ``net.0``); ``to_out`` is ``to_out.0`` (diffusers' ModuleList)."""
    parts = []
    for seg in path:
        seg = _CONTAINER.sub(r".\1", _INDEX.sub(r".\1", seg))
        parts.append("to_out.0" if seg == "to_out" else seg)
    return prefix + ".".join(parts)


def inject_trainable_lora(targets: Sequence[LoraTarget],
                          generator: torch.Generator, r: int = 4,
                          scale: float = 1.0, dtype: torch.dtype = torch.float32,
                          device=None) -> Dict[str, Any]:
    """A fresh LoRA tree for ``targets``: ``down ~ N(0, 1) / r`` and
    ``up = 0`` (reference lora.py:46-47), drawn from ``generator`` in target
    order, on ``device`` (default: the generator's device)."""
    if device is None:
        device = generator.device
    tree: Dict[str, Any] = {}
    for t in targets:
        if r > min(t.in_features, t.out_features):
            raise ValueError(f"LoRA rank {r} must be less or equal than "
                             f"{min(t.in_features, t.out_features)}")
        if t.is_conv:
            kh, kw = t.kernel_size
            down_shape, up_shape = (r, t.in_features, kh, kw), (t.out_features, r, 1, 1)
        else:
            down_shape, up_shape = (r, t.in_features), (t.out_features, r)
        down = torch.randn(down_shape, generator=generator, device=device) / r
        leaf = {"up": torch.zeros(up_shape, dtype=dtype, device=device),
                "down": down.to(dtype),
                "scale": torch.tensor(scale, dtype=torch.float32, device=device)}
        tree = tree_set(tree, t.path, leaf)
    return tree


def _is_leaf(node) -> bool:
    return isinstance(node, Mapping) and "up" in node and not isinstance(node["up"], Mapping)


def lora_leaves(tree: Mapping[str, Any], prefix: Path = ()) -> Iterator[Tuple[Path, Mapping]]:
    """(JAX path, leaf) for every LoRA leaf of ``tree``."""
    for key, child in tree.items():
        if _is_leaf(child):
            yield prefix + (key,), child
        elif isinstance(child, Mapping):
            yield from lora_leaves(child, prefix + (key,))


@contextlib.contextmanager
def attached(model: nn.Module, tree: Optional[Mapping[str, Any]]):
    """Set ``tree`` on ``model``'s LoRA layers for the duration of the block
    (the dynamic path: each layer adds ``scale * up(down(x))``)."""
    prefix = getattr(model, "lora_prefix", "")
    layers = []
    try:
        for path, leaf in lora_leaves(tree or {}):
            layer = model.get_submodule(module_name(path, prefix))
            layer.set_lora(leaf["up"], leaf["down"], leaf["scale"])
            layers.append(layer)
        yield model
    finally:
        for layer in layers:
            layer.clear_lora()


@torch.no_grad()
def materialize_lora_tree(model: nn.Module, lora: Optional[Mapping[str, Any]]
                          ) -> Dict[str, torch.Tensor]:
    """Merged weights ``W + scale * delta`` for every LoRA'd layer of
    ``model``, as {parameter name: tensor} -- the overrides to run the model
    with (``torch.func.functional_call``) at base-model speed.  The delta is
    dense ``up @ down`` or, for convs, the 1x1 up composed with the kxk down;
    computed in fp32 and rounded to the weight's dtype once, as the JAX
    package's ``materialize_lora_tree`` (lora.py:478)."""
    prefix = getattr(model, "lora_prefix", "")
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in lora_leaves(lora or {}):
        name = module_name(path, prefix)
        weight = model.get_submodule(name).weight
        up = leaf["up"].to(weight.device, torch.float32)
        down = leaf["down"].to(weight.device, torch.float32)
        if up.ndim == 4:
            delta = torch.einsum("or,rikl->oikl", up[:, :, 0, 0], down)
        else:
            delta = up @ down
        scale = torch.as_tensor(leaf["scale"], dtype=torch.float32).to(weight.device)
        out[name + ".weight"] = (weight.float() + scale * delta).to(weight.dtype)
    return out


def tune_lora_scale(lora_tree: Mapping[str, Any], alpha: float = 1.0) -> Dict[str, Any]:
    """A tree with every ``scale`` leaf set to ``alpha`` (reference
    lora.py:597-600); the scale is a tensor, so nothing is rebuilt."""

    def walk(node):
        if _is_leaf(node):
            out = dict(node)
            out["scale"] = torch.tensor(alpha, dtype=torch.float32,
                                        device=torch.as_tensor(node["scale"]).device)
            return out
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(lora_tree)
