"""Fused LoRA dense: a hand-written Hopper kernel and its plain version.

``y = x W^T + b + scale * (h up^T)`` with ``h = x down^T`` rounded to x's
dtype, fp32 accumulation, in one pass.  Port of the JAX package's Pallas
TPU kernel ``ops/lora_matmul.py:_kernel`` (:38, wrapper ``_fused`` :50,
public ``lora_dense`` :137).  The CUDA kernel is ``csrc/lora_matmul.cu``
(``sm_90a``); its design and its bound on the card are noted there.  Its
grid comes from :func:`plan`: the rows and columns of y a CTA computes and
the CTAs that split the k-loop where the grid alone cannot fill the card.

Layouts: ``weight`` is ``nn.Linear``'s (N, K) (the JAX ``kernel`` is its
transpose), ``up`` (N, r) and ``down`` (r, K) are the on-disk LoRA layout
shared by both packages, ``scale`` is a scalar tensor (read on the device,
never baked into the kernel), ``bias`` is optional.

On a CPU tensor :func:`lora_dense` runs :func:`lora_dense_plain`; on a CUDA
tensor it launches the kernel or raises.  :func:`lora_dense` is
differentiable: with grad enabled and an operand that requires grad it runs
:class:`LoraDenseFunction`, whose forward is the kernel (or the plain
version on the CPU) and whose backward is torch matmuls in fp32, as the JAX
package's backward is plain XLA (``_lora_dense_bwd`` :111-131).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _grid

# kernel launches so far, bf16 and fp32 apart (chip_smoke.py resets and
# reads them)
launches = 0
fp32_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 16  # the rank is zero-padded to one mma k-depth in the kernel
K_STEP = 64  # k a stage of the bf16 kernel
TILES = ((128, 128), (64, 128), (64, 64))  # (rows, columns) of y a CTA, largest first


def plan(m: int, n: int, k: int):
    """(bm, bn, splits) of the bf16 kernel for an (m, k) x (k, n) call: the
    largest of the tiles 128 x 128, 64 x 128 and 64 x 64 (rows x columns of
    y a CTA) whose grid fills one wave, else 64 x 64; the k-loop (64-deep
    steps) split only where even 64 x 64 tiles fill under half a wave, into
    runs of at least 8 steps (``_grid.k_splits``): a split's partials cost
    more than the small calls' k-loops, so the 77- and 154-row text
    projections run unsplit."""
    for bm, bn in TILES:
        tiles = _grid.cdiv(m, bm) * _grid.cdiv(n, bn)
        if tiles >= _grid.SMS:
            return bm, bn, 1
    return bm, bn, _grid.k_splits(tiles, _grid.cdiv(k, K_STEP), 8, _grid.SMS // 2)


def _scale32(scale, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(())


def lora_dense_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], up: torch.Tensor,
                     down: torch.Tensor, scale) -> torch.Tensor:
    """The kernel's math in torch on (M, K) inputs: operands cast to x's
    dtype, products in fp32, h rounded to x's dtype before the up-product,
    then base + scale * LoRA + bias, one rounding at the end."""
    dt = x.dtype
    xf = x.float()
    acc = xf @ weight.to(dt).float().t()
    h = (xf @ down.to(dt).float().t()).to(dt)
    acc = acc + _scale32(scale, x.device) * (h.float() @ up.to(dt).float().t())
    if bias is not None:
        acc = acc + bias.to(dt).float()
    return acc.to(dt)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("lora_matmul")
        fn = lib.dft_lora_dense
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.dft_lora_dense


def _lora_dense_cuda(x, weight, bias, up, down, scale, grid=None):
    """The kernel on (M, K) inputs; ``grid`` (bm, bn, splits), bf16 only,
    defaults to :func:`plan`."""
    global launches, fp32_launches
    operands = [x, weight, up, down] + ([bias] if bias is not None else [])
    if x.dtype not in _DTYPES:
        raise TypeError(f"LoRA kernel takes fp32 or bf16, got {x.dtype}")
    if any(t.device != x.device for t in operands):
        raise ValueError("all LoRA dense operands must be on one device")
    m, k = x.shape
    n, r = weight.shape[0], up.shape[1]
    if (weight.shape[1] != k or up.shape[0] != n or down.shape != (r, k)
            or (bias is not None and bias.shape != (n,))):
        raise ValueError(f"shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"up {tuple(up.shape)}, down {tuple(down.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} do not match")
    if r > MAX_RANK:
        raise ValueError(f"LoRA rank {r} > {MAX_RANK} is not built")
    if x.dtype == torch.bfloat16 and k % 8:
        raise ValueError(f"bf16 LoRA kernel needs K % 8 == 0, got K={k}")
    dt = x.dtype
    x = x.contiguous()
    weight, up, down = (t.to(dt).contiguous() for t in (weight, up, down))
    bias = None if bias is None else bias.to(dt).contiguous()
    s = _scale32(scale, x.device)
    y = torch.empty((m, n), dtype=dt, device=x.device)
    bm, bn, splits = (grid or plan(m, n, k)) if dt == torch.bfloat16 else (64, 64, 1)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part = counters = None
        if splits > 1:  # fp32 partials of y and h, summed by the last CTA of each tile
            tiles = _grid.cdiv(m, bm) * _grid.cdiv(n, bn)
            part = torch.empty(splits * tiles * bm * (bn + 16), dtype=torch.float32,
                               device=x.device)
            counters = _grid.arrival_counters(x.device, stream, tiles)
        rc = fn(x.data_ptr(), weight.data_ptr(),
                None if bias is None else bias.data_ptr(), up.data_ptr(),
                down.data_ptr(), s.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(),
                None if counters is None else counters.data_ptr(), m, n, k, r,
                _DTYPES[dt], bm, bn, splits, stream)
    _build.check(rc, "lora_dense")
    if dt == torch.float32:
        fp32_launches += 1
    else:
        launches += 1
    return y


def _forward(x, weight, bias, up, down, scale):
    if x.device.type == "cuda":
        return _lora_dense_cuda(x, weight, bias, up, down, scale)
    if x.device.type == "cpu":
        return lora_dense_plain(x, weight, bias, up, down, scale)
    raise ValueError(f"no LoRA dense for device {x.device}")


class LoraDenseFunction(torch.autograd.Function):
    """Differentiable LoRA dense on (M, K) inputs.  Forward: the kernel (the
    plain version on the CPU).  Backward: JAX ``_lora_dense_bwd`` in torch,
    products in fp32, computing only the gradients autograd asks for (the
    frozen base weight gets no dW on the training path)."""

    @staticmethod
    def forward(ctx, x, weight, bias, up, down, scale):
        ctx.save_for_backward(x, weight, up, down, _scale32(scale, x.device))
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.scale_shape = scale.shape if isinstance(scale, torch.Tensor) else ()
        return _forward(x, weight, bias, up, down, scale)

    @staticmethod
    def backward(ctx, g):
        x, weight, up, down, s = ctx.saved_tensors
        need_x, need_w, need_b, need_up, need_down, need_s = ctx.needs_input_grad
        gf = g.float()
        upf, downf = up.float(), down.float()
        dx = dw = db = dup = ddown = dscale = None
        if need_x:
            dx = (gf @ weight.float() + s * ((gf @ upf) @ downf)).to(x.dtype)
        if need_w:
            dw = (gf.t() @ x.float()).to(weight.dtype)
        if need_b and ctx.bias_dtype is not None:
            db = gf.sum(dim=0).to(ctx.bias_dtype)
        if need_up or need_down or need_s:
            xf = x.float()
            h = xf @ downf.t()  # (M, r)
            if need_up:
                dup = ((gf.t() @ h) * s).to(up.dtype)
            if need_down:
                ddown = (((upf.t() @ gf.t()) @ xf) * s).to(down.dtype)
            if need_s:
                dscale = (gf * (h @ upf.t())).sum().reshape(ctx.scale_shape)
        return dx, dw, db, dup, ddown, dscale


def lora_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], up: torch.Tensor,
               down: torch.Tensor, scale) -> torch.Tensor:
    """Fused LoRA dense on (..., K) inputs; returns (..., N)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    operands = [x, weight, up, down, scale] + ([bias] if bias is not None else [])
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in operands):
        y = LoraDenseFunction.apply(x2, weight, bias, up, down, scale)
    else:
        y = _forward(x2, weight, bias, up, down, scale)
    return y.reshape(*lead, weight.shape[0])
