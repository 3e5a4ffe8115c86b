"""LoRA addressing, serving and files (port of the JAX package's ``lora.py``).

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

Files are the reference's: ``.pt`` flat interleaved ``[up0, down0, up1,
...]`` fp16 lists (``torch.save``; read with ``torch.load(...,
weights_only=True)``) and the consolidated safetensors schema
(``io/safetensors_io.py``).  Model weights, for :func:`weight_apply_lora`,
are state dicts under the port's module names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Set, Tuple, Union

import torch
from torch import nn

from .io import safetensors_io
from .io.safetensors_io import (
    EMBED_FLAG,
    load_safeloras,
    load_safeloras_both,
    load_safeloras_embeds,
    parse_safeloras,
    parse_safeloras_embeds,
)
from .tree_util import Path, tree_get, tree_has, tree_set

__all__ = [
    "EMBED_FLAG",
    "UNET_DEFAULT_TARGET_REPLACE",
    "UNET_EXTENDED_TARGET_REPLACE",
    "TEXT_ENCODER_DEFAULT_TARGET_REPLACE",
    "DEFAULT_TARGET_REPLACE",
    "LoraTarget",
    "filter_targets",
    "module_name",
    "inject_trainable_lora",
    "lora_targets_from_module",
    "lora_leaves",
    "attached",
    "materialize_lora_tree",
    "tune_lora_scale",
    "lora_tree_to_flat",
    "flat_to_lora_tree",
    "extract_lora_ups_down",
    "save_lora_weight",
    "save_lora_as_json",
    "save_safeloras",
    "save_safeloras_with_embeds",
    "convert_loras_to_safeloras",
    "convert_loras_to_safeloras_with_embeds",
    "parse_safeloras",
    "parse_safeloras_embeds",
    "load_safeloras",
    "load_safeloras_embeds",
    "load_safeloras_both",
    "weight_apply_lora",
    "monkeypatch_lora",
    "monkeypatch_replace_lora",
    "monkeypatch_or_replace_lora",
    "monkeypatch_or_replace_safeloras",
    "monkeypatch_remove_lora",
    "monkeypatch_add_lora",
    "inspect_lora",
    "_text_lora_path",
    "_ti_lora_path",
    "save_all",
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
                          generator: Optional[torch.Generator], r: int = 4,
                          loras: Optional["FlatLora"] = None,
                          scale: float = 1.0, dtype: torch.dtype = torch.float32,
                          device=None) -> Dict[str, Any]:
    """A fresh LoRA tree for ``targets``: ``down ~ N(0, 1) / r`` and
    ``up = 0`` (reference lora.py:46-47), drawn from ``generator`` in target
    order, on ``device`` (default: the generator's device).

    ``loras`` warm-starts the tree instead (JAX :283-327, reference
    lora.py:150-151, 175-177): a ``.pt`` flat interleaved list or a list of
    tensors, through :func:`flat_to_lora_tree` (length and shape checks,
    conv pairs in either layout); nothing is drawn then."""
    if loras is not None:
        if device is None and generator is not None:
            device = generator.device
        return flat_to_lora_tree(_load_flat(loras), targets, scale=scale, dtype=dtype,
                                 device=device)
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


def _jax_path(name: str, prefix: str = "") -> Path:
    """The inverse of :func:`module_name`: a module name of the port (under
    ``prefix``) as the JAX module path (``down_blocks.0.attentions.0`` ->
    ``down_blocks_0_attentions_0``, ``to_out.0`` -> ``to_out``)."""
    if prefix and name.startswith(prefix):
        name = name[len(prefix):]
    parts: List[str] = []
    for seg in name.split("."):
        if parts and seg.isdigit():
            if parts[-1] != "to_out":
                parts[-1] += f"_{seg}"
        elif parts and seg in ("attentions", "resnets", "downsamplers", "upsamplers"):
            parts[-1] += f"_{seg}"
        else:
            parts.append(seg)
    return tuple(parts)


def lora_targets_from_module(module: nn.Module, *,
                             target_replace_module: Set[str] = DEFAULT_TARGET_REPLACE,
                             include_conv: bool = False) -> List[LoraTarget]:
    """Targets of an ``nn.Module`` by ancestor class name (JAX :138-216, the
    reference's ``_find_modules``, lora.py:61-134): every ``nn.Linear``
    (and, with ``include_conv``, ``nn.Conv2d``) that is a module whose class
    name is in ``target_replace_module`` or a descendant of one, in
    ancestor-major preorder of ``named_modules()``.  A layer under two
    matched ancestors comes once, for the first ancestor that reaches it
    (the reference's skip-already-injected rule, lora.py:98-104).  Paths are
    JAX paths (:func:`_jax_path`, under the module's ``lora_prefix``), so the
    targets drive the whole target-based API (inject, merge, save, load)."""
    prefix = getattr(module, "lora_prefix", "")
    modules = list(module.named_modules())
    replace = set(target_replace_module)
    targets: List[LoraTarget] = []
    seen: Set[str] = set()
    for aname, amod in modules:
        ancestor = type(amod).__name__
        if ancestor not in replace:
            continue
        for name, m in modules:
            if name in seen or not (name == aname or name.startswith(aname + ".")
                                    or not aname):
                continue
            is_dense = isinstance(m, nn.Linear)
            is_conv = include_conv and isinstance(m, nn.Conv2d)
            if not (is_dense or is_conv):
                continue
            seen.add(name)
            if is_dense:
                targets.append(LoraTarget(_jax_path(name, prefix), m.in_features,
                                          m.out_features, ancestor))
            else:
                targets.append(LoraTarget(_jax_path(name, prefix), m.in_channels,
                                          m.out_channels, ancestor,
                                          kernel_size=tuple(m.kernel_size)))
    return targets


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
    package's ``materialize_lora_tree`` (lora.py:478); a tensor-parallel
    layer's (``parallel/tp.py``) is its shard of the merged weight.  The sum is formed in
    the delta's buffer (the same fp32 operations), so a layer's workspace is
    one fp32 copy of its weight."""
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
        shard = getattr(model.get_submodule(name), "_dft_tp", None)
        if shard is not None:  # a tensor-parallel layer: its block of the delta
            delta = shard.local_weight(delta)
        scale = torch.as_tensor(leaf["scale"], dtype=torch.float32).to(weight.device)
        out[name + ".weight"] = delta.mul_(scale).add_(weight).to(weight.dtype)
        del delta
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


# --------------------------------------------------------------------------
# Tree <-> flat list (JAX lora.py:218-275)
# --------------------------------------------------------------------------

FlatLora = Union[str, Sequence[Any]]


def lora_tree_to_flat(lora_tree: Mapping[str, Any],
                      targets: Sequence[LoraTarget]) -> List[torch.Tensor]:
    """The reference's interleaved [up, down, ...] list, in target order."""
    flat: List[torch.Tensor] = []
    for t in targets:
        leaf = tree_get(lora_tree, t.path)
        flat += [leaf["up"], leaf["down"]]
    return flat


def flat_to_lora_tree(flat: Sequence[Any], targets: Sequence[LoraTarget], scale: float = 1.0,
                      dtype: torch.dtype = torch.float32, device=None) -> Dict[str, Any]:
    """A LoRA tree from an interleaved flat list (canonical order): leaves
    through fp32 into ``dtype`` on ``device`` (default: where they are),
    conv pairs given as 2-D rank factors reshaped to the torch Conv2d
    shapes, every pair checked against its target."""
    if len(flat) != 2 * len(targets):
        raise ValueError(f"flat list has {len(flat)} tensors but model has "
                         f"{len(targets)} targets")
    tree: Dict[str, Any] = {}
    for i, t in enumerate(targets):
        up, down = (torch.as_tensor(flat[2 * i + j]).to(device, torch.float32).to(dtype)
                    for j in (0, 1))
        if t.is_conv:
            r = up.shape[1]
            if up.ndim == 2:
                up = up.reshape(t.out_features, r, 1, 1)
            if down.ndim == 2:
                down = down.reshape(down.shape[0], t.in_features, *t.kernel_size)
            ok = (up.shape[0] == t.out_features and down.shape[1] == t.in_features
                  and tuple(down.shape[2:]) == tuple(t.kernel_size))
        else:
            ok = up.shape[0] == t.out_features and down.shape[1] == t.in_features
        if not ok:
            raise ValueError(f"target {t.path}: file pair (up {tuple(up.shape)}, down "
                             f"{tuple(down.shape)}) does not match layer "
                             f"({t.in_features} -> {t.out_features})")
        leaf = {"up": up, "down": down,
                "scale": torch.tensor(scale, dtype=torch.float32, device=up.device)}
        tree = tree_set(tree, t.path, leaf)
    return tree


def _load_flat(loras: FlatLora) -> List[torch.Tensor]:
    if isinstance(loras, str):
        obj = torch.load(loras, map_location="cpu", weights_only=True)
        if not isinstance(obj, list):
            raise ValueError(f"{loras} is not a flat LoRA list")
        return obj
    return [torch.as_tensor(a) for a in loras]


def extract_lora_ups_down(lora_tree: Mapping[str, Any], targets: Sequence[LoraTarget]
                          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(up, down), ...] of the targets the tree holds, in target order."""
    leaves = [tree_get(lora_tree, t.path) for t in targets if tree_has(lora_tree, t.path)]
    pairs = [(leaf["up"], leaf["down"]) for leaf in leaves]
    if not pairs:
        raise ValueError("No lora injected.")
    return pairs


# --------------------------------------------------------------------------
# Saving (JAX lora.py:347-434)
# --------------------------------------------------------------------------


def _host(t, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a fresh host tensor of ``dtype`` (its own storage, so that
    ``torch.save`` writes no larger buffer it may be a view of)."""
    return torch.as_tensor(t).detach().to("cpu", dtype).clone()


def save_lora_weight(lora_tree: Mapping[str, Any], targets: Sequence[LoraTarget],
                     path: str = "./lora.pt") -> None:
    """The flat interleaved list in fp16 (reference lora.py:201-213)."""
    weights = [_host(w, torch.float16)
               for pair in extract_lora_ups_down(lora_tree, targets) for w in pair]
    torch.save(weights, path)


def save_lora_as_json(lora_tree: Mapping[str, Any], targets: Sequence[LoraTarget],
                      path: str = "./lora.json") -> None:
    weights = [_host(w, torch.float32).tolist()
               for pair in extract_lora_ups_down(lora_tree, targets) for w in pair]
    with open(path, "w") as f:
        json.dump(weights, f)


ModelMapEntry = Tuple[Mapping[str, Any], Sequence[LoraTarget], Set[str]]


def save_safeloras_with_embeds(modelmap: Mapping[str, ModelMapEntry],
                               embeds: Optional[Mapping[str, Any]] = None,
                               outpath: str = "./lora.safetensors") -> None:
    """``modelmap = {name: (lora_tree, targets, target_replace_set)}``: the
    consolidated schema with the trees' own dtypes (only ``.pt`` saves cast
    to fp16, reference lora.py:210, 250-251)."""
    loras = {}
    for name, (lora_tree, targets, target_replace) in modelmap.items():
        sel = filter_targets(targets, target_replace)
        flat = lora_tree_to_flat(lora_tree, sel)
        ranks = [int(flat[2 * i].shape[1]) for i in range(len(sel))]
        loras[name] = (flat, ranks, sorted(target_replace))
    safetensors_io.write_safeloras(loras, outpath, embeds=dict(embeds or {}))


def save_safeloras(modelmap: Mapping[str, ModelMapEntry],
                   outpath: str = "./lora.safetensors") -> None:
    save_safeloras_with_embeds(modelmap, None, outpath)


def convert_loras_to_safeloras_with_embeds(
        modelmap: Mapping[str, Tuple[str, Set[str], int]],
        embeds: Optional[Union[str, Mapping[str, Any]]] = None,
        outpath: str = "./lora.safetensors") -> None:
    """``.pt`` flat lists into the safetensors schema (reference
    lora.py:268-303).  ``modelmap = {name: (.pt path, target_replace_set,
    rank)}``; ``embeds`` maps tokens to tensors or is a ``.pt`` path of such
    a dict."""
    loras = {}
    for name, (pt_path, target_replace, rank) in modelmap.items():
        flat = _load_flat(pt_path)
        loras[name] = (flat, [int(rank)] * (len(flat) // 2), sorted(target_replace))
    if isinstance(embeds, str):
        embeds = torch.load(embeds, map_location="cpu", weights_only=True)
    safetensors_io.write_safeloras(loras, outpath, embeds=dict(embeds or {}))


def convert_loras_to_safeloras(modelmap: Mapping[str, Tuple[str, Set[str], int]],
                               outpath: str = "./lora.safetensors") -> None:
    convert_loras_to_safeloras_with_embeds(modelmap, None, outpath)


# --------------------------------------------------------------------------
# Merging and the monkeypatch family (JAX lora.py:442-648)
# --------------------------------------------------------------------------


def _conv_pair(up: torch.Tensor, down: torch.Tensor, t: LoraTarget):
    """A conv target's pair as (up (out, r), down (r, in, kh, kw)), from the
    4-D or the 2-D rank-factor layout."""
    if up.ndim == 4:
        up = up[:, :, 0, 0]
    if down.ndim == 2:
        down = down.reshape(down.shape[0], t.in_features, *t.kernel_size)
    return up, down


@torch.no_grad()
def weight_apply_lora(params: Mapping[str, torch.Tensor], loras: FlatLora,
                      targets: Sequence[LoraTarget], alpha: float = 1.0,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """Merge for good: ``W += alpha * up @ down`` (reference lora.py:410-424)
    on a state dict under the port's module names (``prefix``: the model's
    ``lora_prefix``).  The delta is computed in fp32 and cast to the
    weight's dtype, then added there.  Returns a new state dict."""
    flat = _load_flat(loras)
    if len(flat) != 2 * len(targets):
        raise ValueError(f"{len(flat)} tensors for {len(targets)} targets")
    out = dict(params)
    for i, t in enumerate(targets):
        key = module_name(t.path, prefix) + ".weight"
        w = params[key]
        up, down = (flat[2 * i + j].to(w.device, torch.float32) for j in (0, 1))
        if t.is_conv:
            up, down = _conv_pair(up, down, t)
            delta = torch.einsum("or,rikl->oikl", up, down)
        else:
            delta = up @ down
        out[key] = w + alpha * delta.to(w.dtype)
    return out


def monkeypatch_lora(loras: FlatLora, targets: Sequence[LoraTarget], r: int = 4,
                     dtype: torch.dtype = torch.float32, device=None) -> Dict[str, Any]:
    """A LoRA tree from saved weights (reference lora.py:427-459): patching
    and replacing are one operation here, the returned tree supersedes the
    one that was active.  The rank comes from the tensors."""
    del r
    return flat_to_lora_tree(_load_flat(loras), targets, scale=1.0, dtype=dtype, device=device)


def monkeypatch_replace_lora(loras: FlatLora, targets: Sequence[LoraTarget], r: int = 4,
                             dtype: torch.dtype = torch.float32, device=None) -> Dict[str, Any]:
    return monkeypatch_lora(loras, targets, r, dtype, device)


def monkeypatch_or_replace_lora(loras: FlatLora, targets: Sequence[LoraTarget],
                                r: Union[int, List[int]] = 4,
                                dtype: torch.dtype = torch.float32,
                                device=None) -> Dict[str, Any]:
    """Reference lora.py:497-538: a per-module rank list is checked against
    the targets; the ranks are read from the tensors."""
    flat = _load_flat(loras)
    if isinstance(r, list) and len(r) not in (0, len(targets)):
        raise ValueError(f"rank list of {len(r)} for {len(targets)} targets")
    return flat_to_lora_tree(flat, targets, scale=1.0, dtype=dtype, device=device)


def monkeypatch_or_replace_safeloras(models: Any, safeloras: Tuple[Mapping[str, torch.Tensor],
                                                                  Mapping[str, str]]
                                     ) -> Dict[str, Dict[str, Any]]:
    """Parsed safeloras onto a pipe-like object by model name (reference
    lora.py:541-551): ``models.lora_targets(name, target_replace)`` gives
    the targets; returns {model name: tree} and sets ``models.<name>_lora``
    where that attribute exists.  A model the object lacks (KeyError) is
    skipped with the reference's message."""
    out: Dict[str, Dict[str, Any]] = {}
    lora_targets_fn = getattr(models, "lora_targets", None)
    for name, (flat, ranks, target) in parse_safeloras(*safeloras).items():
        if lora_targets_fn is None:
            print(f"No model provided for {name}, contained in Lora")
            continue
        try:
            targets = lora_targets_fn(name, set(target))
        except KeyError:
            print(f"No model provided for {name}, contained in Lora")
            continue
        out[name] = flat_to_lora_tree(flat, targets, scale=1.0)
        if hasattr(models, f"{name}_lora"):
            setattr(models, f"{name}_lora", out[name])
    return out


def monkeypatch_remove_lora(lora_tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The un-LoRA'd model: an empty tree (reference lora.py:554-567)."""
    del lora_tree
    return {}


def monkeypatch_add_lora(lora_tree: Mapping[str, Any], loras: FlatLora,
                         targets: Sequence[LoraTarget], alpha: float = 1.0,
                         beta: float = 1.0) -> Dict[str, Any]:
    """``up <- alpha * up_new + beta * up_old`` and the same for down
    (reference lora.py:570-594); new pairs in the leaves' dtypes, conv
    pairs as 2-D rank factors accepted."""
    flat = _load_flat(loras)
    new_tree = lora_tree
    for i, t in enumerate(targets):
        leaf = dict(tree_get(lora_tree, t.path))
        up_new, down_new = (flat[2 * i + j].to(leaf[k].device, torch.float32).to(leaf[k].dtype)
                            for j, k in ((0, "up"), (1, "down")))
        if t.is_conv:
            if up_new.ndim == 2:
                up_new = up_new.reshape(t.out_features, up_new.shape[1], 1, 1)
            if down_new.ndim == 2:
                down_new = down_new.reshape(down_new.shape[0], t.in_features, *t.kernel_size)
        if up_new.shape != leaf["up"].shape or down_new.shape != leaf["down"].shape:
            raise ValueError(
                f"add_lora shape mismatch at {t.path}: file has {tuple(up_new.shape)}/"
                f"{tuple(down_new.shape)}, tree has {tuple(leaf['up'].shape)}/"
                f"{tuple(leaf['down'].shape)} (different rank?)")
        leaf["up"] = alpha * up_new + beta * leaf["up"]
        leaf["down"] = alpha * down_new + beta * leaf["down"]
        new_tree = tree_set(new_tree, t.path, leaf)
    return new_tree


def inspect_lora(lora_tree: Mapping[str, Any]) -> Dict[str, List[float]]:
    """Mean |up @ down| of every leaf, in fp32, keyed by its path joined
    with dots (reference lora.py:735-752)."""
    moved: Dict[str, List[float]] = {}
    for path, leaf in lora_leaves(lora_tree):
        up = torch.as_tensor(leaf["up"]).detach().float().cpu()
        down = torch.as_tensor(leaf["down"]).detach().float().cpu()
        if up.ndim == 4:  # a conv pair: its rank factors
            up, down = up.reshape(up.shape[0], -1), down.reshape(down.shape[0], -1)
        moved.setdefault(".".join(path), []).append(float((up @ down).abs().mean()))
    return moved


# --------------------------------------------------------------------------
# Side-car paths and the unified saver (JAX lora.py:678-750)
# --------------------------------------------------------------------------


def _text_lora_path(path: str) -> str:
    if not path.endswith(".pt"):
        raise ValueError("Only .pt files are supported")
    return ".".join(path.split(".")[:-1] + ["text_encoder", "pt"])


def _ti_lora_path(path: str) -> str:
    if not path.endswith(".pt"):
        raise ValueError("Only .pt files are supported")
    return ".".join(path.split(".")[:-1] + ["ti", "pt"])


def save_all(unet_lora: Optional[Mapping[str, Any]], text_lora: Optional[Mapping[str, Any]],
             unet_targets: Sequence[LoraTarget], text_targets: Sequence[LoraTarget],
             learned_embeds: Optional[Mapping[str, Any]], save_path: str,
             save_lora: bool = True, save_ti: bool = True,
             target_replace_module_text: Set[str] = TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
             target_replace_module_unet: Set[str] = DEFAULT_TARGET_REPLACE,
             safe_form: bool = True, text_2_lora: Optional[Mapping[str, Any]] = None,
             text_2_targets: Sequence[LoraTarget] = ()) -> None:
    """UNet and text LoRAs and TI embeds together: ``safe_form`` one
    consolidated ``.safetensors``, else the reference's ``.pt`` triple
    ``path``, ``path.text_encoder.pt``, ``path.ti.pt`` (lora.py:755-821).
    Embeds are saved in fp32.  ``text_2_lora`` (SDXL's second tower, on
    ``text_2_targets``) is saved as the safetensors file's
    ``text_encoder_2`` pairs."""
    if text_2_lora is not None and not safe_form:
        raise ValueError("a text_encoder_2 LoRA is saved in the safetensors form only")
    embeds = {k: _host(v, torch.float32) for k, v in (learned_embeds or {}).items()}
    if not safe_form:
        if save_ti:
            torch.save(dict(embeds), _ti_lora_path(save_path))
            for tok in embeds:
                print(f"Current Learned Embeddings for {tok}:, id {tok} ", embeds[tok][:4])
        if save_lora:
            if unet_lora is None:
                raise ValueError("save_lora needs a UNet LoRA tree")
            save_lora_weight(unet_lora, filter_targets(unet_targets, target_replace_module_unet),
                             save_path)
            if text_lora is not None:
                save_lora_weight(text_lora,
                                 filter_targets(text_targets, target_replace_module_text),
                                 _text_lora_path(save_path))
        return

    if not save_path.endswith(".safetensors"):
        raise ValueError(f"Save path : {save_path} should end with .safetensors")
    modelmap: Dict[str, ModelMapEntry] = {}
    if save_lora:
        if unet_lora is None:
            raise ValueError("save_lora needs a UNet LoRA tree")
        modelmap["unet"] = (unet_lora, unet_targets, target_replace_module_unet)
        if text_lora is not None:
            modelmap["text_encoder"] = (text_lora, text_targets, target_replace_module_text)
        if text_2_lora is not None:
            modelmap["text_encoder_2"] = (text_2_lora, text_2_targets,
                                          target_replace_module_text)
    save_safeloras_with_embeds(modelmap, embeds if save_ti else None, save_path)
