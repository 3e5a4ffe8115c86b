"""Tensor parallelism of the frozen projections over a mesh's ``tp`` axis.

The JAX package annotates its parameters with column/row placements
(``parallel/mesh.py:tp_shardings``) and GSPMD inserts the collectives.
Here each rank holds its shard of the weights and the collectives are
explicit, as Megatron pairs with one all-reduce each:

* UNet attention: ``to_q``, ``to_k``, ``to_v`` split by output columns,
  attention on the rank's heads, ``to_out`` split by input rows;
* UNet feed-forward: GEGLU ``proj`` by columns, ``net.2`` by rows; ``proj``
  holds ``[hidden; gate]``, so a rank keeps its slice of both halves;
* CLIP: ``q_proj``, ``k_proj``, ``v_proj`` then ``out_proj``; ``fc1`` then
  ``fc2``.

An attention pair is split only where ``tp`` divides the heads, a
feed-forward pair where it divides the inner width; otherwise the block
stays replicated.  ``proj_in`` and ``proj_out`` are in JAX's sets, where
GSPMD reshards around the norms between them; per rank, splitting them
would cost an all-gather each, so they stay replicated here.  The result
does not depend on the placement (JAX :140).

A split layer keeps the ``nn.Linear`` it was (state-dict names and LoRA
targets unchanged) with its weight and bias cut to the shard, a
:class:`Shard` as ``_dft_tp`` and a forward that runs the fused LoRA dense
(K2) on the shard.  LoRA and TI leaves stay whole and replicated; a layer
slices what its shard needs: column layers ``up``'s rows, row layers
``down``'s columns (the bias is added once, after the all-reduce).  So a
leaf's gradient on a rank is its zero-padded partial, and summing over
``tp`` assembles it (``training/train_step.py``).  Backward: a column
layer's input gradient is all-reduced (Megatron's ``f``), a row layer's
output gradient passes through (``g``).

The row-split sum of per-rank ``bf16(x_s down_s^T) up^T`` differs from the
unsplit ``bf16(x down^T) up^T`` by rounding only; in fp32 ``h`` is not
rounded.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lora_matmul import lora_dense
from . import mesh as mesh_lib


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the input gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh_lib.all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The partial sums all-reduced over the group; the gradient passes."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh_lib.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(eq=False)
class Shard:
    """A split layer's rule: ``kind`` "col" keeps output rows ``index`` of
    the full weight, "row" its input columns ``index``; ``full`` is the full
    weight's shape; the layer's partial results meet over ``group``."""

    kind: str
    index: torch.Tensor
    full: torch.Size
    group: Any

    def local_weight(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full-shaped weight (a merged LoRA weight)."""
        idx = self.index.to(full.device)
        return full.index_select(0 if self.kind == "col" else 1, idx).contiguous()


def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
    sh: Shard = self._dft_tp
    up = getattr(self, "lora_up", None)
    if sh.kind == "col":
        if torch.is_grad_enabled():
            x = _CopyToGroup.apply(x, sh.group)
        if up is None:
            return F.linear(x, self.weight, self.bias)
        idx = sh.index.to(up.device)
        return lora_dense(x, self.weight, self.bias, up.index_select(0, idx), self.lora_down,
                          self.lora_scale)
    if up is None:
        y = F.linear(x, self.weight)
    else:
        idx = sh.index.to(up.device)
        y = lora_dense(x, self.weight, None, up, self.lora_down.index_select(1, idx),
                       self.lora_scale)
    y = (_ReduceFromGroup.apply(y, sh.group) if torch.is_grad_enabled()
         else mesh_lib.all_reduce(y.contiguous(), sh.group))
    return y if self.bias is None else y + self.bias


def _blocks(n: int, parts: int, i: int, halves: int = 1) -> torch.Tensor:
    """Rank ``i``'s indices of ``n`` features split in ``parts``: its
    contiguous block of each of ``halves`` equal halves (GEGLU's
    ``[hidden; gate]``)."""
    half = n // halves
    w = half // parts
    return torch.cat([torch.arange(h * half + i * w, h * half + (i + 1) * w)
                      for h in range(halves)])


@torch.no_grad()
def _split(lin: nn.Linear, kind: str, index: torch.Tensor, group) -> None:
    w = lin.weight
    full = w.shape
    idx = index.to(w.device)
    lin.weight = nn.Parameter(w.index_select(0 if kind == "col" else 1, idx).contiguous(),
                              requires_grad=w.requires_grad)
    if kind == "col" and lin.bias is not None:
        lin.bias = nn.Parameter(lin.bias.index_select(0, idx).contiguous(),
                                requires_grad=lin.bias.requires_grad)
    lin._dft_tp = Shard(kind, index, full, group)
    lin.forward = types.MethodType(_tp_forward, lin)


def _pair(cols: List[nn.Linear], row: nn.Linear, n: int, tp: int, i: int, group,
          halves: int = 1) -> None:
    for lin in cols:
        _split(lin, "col", _blocks(lin.out_features, tp, i, halves), group)
    _split(row, "row", _blocks(n, tp, i), group)


def shard_module(module: nn.Module, mesh: "mesh_lib.Mesh", axis: str = "tp") -> List[str]:
    """Split ``module``'s attention and feed-forward pairs (a UNet or a CLIP
    text encoder) over ``mesh``'s ``axis`` in place; returns the names of
    the layers split.  A module already split, or a mesh without ``tp`` > 1,
    is left as it is."""
    tp = mesh.axis_size(axis)
    if tp <= 1 or getattr(module, "_dft_tp_mesh", None) is not None:
        return []
    i, group = mesh.index(axis), mesh.groups[axis]
    for name, m in list(module.named_modules()):
        kind = type(m).__name__
        if kind in ("CrossAttention", "CLIPAttention") and m.heads % tp == 0:
            if kind == "CrossAttention":
                cols, row = [m.to_q, m.to_k, m.to_v], m.to_out[0]
            else:
                cols, row = [m.q_proj, m.k_proj, m.v_proj], m.out_proj
            _pair(cols, row, row.in_features, tp, i, group)
            m._dft_tp_heads = m.heads
            m.heads //= tp
        elif kind == "FeedForward":
            proj, out = m.net[0].proj, m.net[2]
            if out.in_features % tp == 0:
                _pair([proj], out, out.in_features, tp, i, group, halves=2)
        elif kind == "CLIPMLP" and m.fc2.in_features % tp == 0:
            _pair([m.fc1], m.fc2, m.fc2.in_features, tp, i, group)
    module._dft_tp_mesh = mesh
    return split_layers(module)


def split_layers(module: nn.Module) -> List[str]:
    """Names of ``module``'s layers that hold a tensor-parallel shard."""
    return [name for name, m in module.named_modules() if hasattr(m, "_dft_tp")]


@torch.no_grad()
def unshard_module(module: nn.Module) -> None:
    """Gather every split layer's full weight back (a zero-padded full
    buffer per rank, summed over the group) and restore the heads, so the
    module runs unsplit on every rank."""
    if getattr(module, "_dft_tp_mesh", None) is None:
        return
    for m in module.modules():
        sh: Optional[Shard] = getattr(m, "_dft_tp", None)
        if sh is not None:
            dim = 0 if sh.kind == "col" else 1
            idx = sh.index.to(m.weight.device)
            buf = torch.zeros(sh.full, dtype=m.weight.dtype, device=m.weight.device)
            buf.index_copy_(dim, idx, m.weight)
            m.weight = nn.Parameter(mesh_lib.all_reduce(buf, sh.group),
                                    requires_grad=m.weight.requires_grad)
            if sh.kind == "col" and m.bias is not None:
                b = torch.zeros(sh.full[0], dtype=m.bias.dtype, device=m.bias.device)
                b.index_copy_(0, idx, m.bias)
                m.bias = nn.Parameter(mesh_lib.all_reduce(b, sh.group),
                                      requires_grad=m.bias.requires_grad)
            del m._dft_tp
            del m.forward  # back to the class's forward
        heads = getattr(m, "_dft_tp_heads", None)
        if heads is not None:
            m.heads = heads
            del m._dft_tp_heads
    module._dft_tp_mesh = None


def shard_models(mesh: Optional["mesh_lib.Mesh"], *modules: Optional[nn.Module]) -> None:
    """:func:`shard_module` on each module given, when ``mesh`` has ``tp``."""
    if mesh is None:
        return
    for m in modules:
        if m is not None:
            shard_module(m, mesh)
