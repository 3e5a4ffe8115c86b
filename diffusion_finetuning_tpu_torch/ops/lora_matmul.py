"""Fused LoRA dense: a hand-written Hopper kernel and its plain version.

``y = x W^T + b + scale * (h up^T)`` with ``h = x down^T`` rounded to x's
dtype, fp32 accumulation, in one pass.  Port of the JAX package's Pallas
TPU kernel ``ops/lora_matmul.py:_kernel`` (:38, wrapper ``_fused`` :50,
public ``lora_dense`` :137).  The CUDA kernel is ``csrc/lora_matmul.cu``
(``sm_90a``); its design and its bound on the card are noted there.  Its
grid comes from :func:`plan`: the rows and columns of y a CTA computes and
the CTAs that split the k-loop where the grid alone cannot fill the card.
fp32 operands take the same file's ``lora_dense_tf32_kernel``, the split
(3xTF32) product on the tensor cores, with its grid from :func:`plan_f32`,
split copies of x and down made each call in scratch, and W split either
the same way or in shared memory (:func:`f32_w_in_smem`).

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

MAX_RANK = 16  # the rank is zero-padded to one mma k-depth in the kernel
K_STEP = 64  # k a stage of the bf16 kernel
K_STEP_F32 = 32  # k a stage of the fp32 kernel: 32 fp32 values, one 128-byte slab
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


def plan_f32(m: int, n: int, k: int):
    """(bm, bn, splits) of the fp32 kernel: the largest tile (of
    :data:`TILES`, no taller than m rounded up to 64) whose grid fills half a
    wave, else 64 x 64 with the k-loop (32-deep steps) split into the fewest
    runs of at least 4 steps that fill half a wave.  Measured on the card at
    the SD1.5 shapes: a CTA of the split product is three times a bf16 one's
    work, so fewer, larger CTAs beat a full wave of small ones (2048 x 640 x
    640: 80 tiles of 128 x 128 in 0.045 ms, 160 of 64 x 128 in 0.056), and
    the text projections' short k-loops lose to more splits than that."""
    half = _grid.SMS // 2
    for bm, bn in TILES:
        if bm > _grid.cdiv(m, 64) * 64:
            continue
        tiles = _grid.cdiv(m, bm) * _grid.cdiv(n, bn)
        if tiles >= half:
            return bm, bn, 1
    return bm, bn, _grid.k_splits(tiles, _grid.cdiv(k, K_STEP_F32), 4, half, half)


def f32_w_in_smem(m: int, k: int, bm: int) -> bool:
    """Whether the fp32 kernel splits W in shared memory, each CTA the W
    tiles it reads, rather than through the prep pass: where at most 4 CTAs
    along M read each W tile (measured on the card: the prep pass's bytes
    cost more than those splits there, and less where the 8192-row calls'
    64 row tiles would each split W again), and K is a multiple of 4 (W's
    rows read by TMA as they lie)."""
    return k % 4 == 0 and _grid.cdiv(m, bm) <= 4


def f32_scratch_floats(m: int, n: int, k: int, r: int, w_split: bool = False) -> int:
    """fp32 scratch of one fp32 call's split copies: [big; small] of x (m,
    kp), down (r, kp) and, unless W is split in shared memory, W (n, kp);
    kp = k rounded up to 8."""
    return 2 * _grid.cdiv(k, 8) * 8 * (m + r + (0 if w_split else n))


def part_floats(m: int, n: int, grid) -> int:
    """fp32 scratch of a split call's partials (either dtype): each split of
    each output tile stores its bm x bn base and bm x 16 h accumulators."""
    bm, bn, splits = grid
    return splits * _grid.cdiv(m, bm) * _grid.cdiv(n, bn) * bm * (bn + 16)


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


_FNS = {}


def _kernel(symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/lora_matmul.cu``, built at first use."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(_build.load("lora_matmul"), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _lora_dense_cuda(x, weight, bias, up, down, scale, grid=None, w_split=None):
    """The kernel on (M, K) inputs, bf16 or fp32; ``grid`` (bm, bn, splits)
    defaults to :func:`plan` (bf16) or :func:`plan_f32` (fp32), ``w_split``
    (fp32: W split in shared memory) to :func:`f32_w_in_smem`."""
    global launches, fp32_launches
    operands = [x, weight, up, down] + ([bias] if bias is not None else [])
    if x.dtype not in (torch.float32, torch.bfloat16):
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
    fp32 = dt == torch.float32
    x = x.contiguous()
    weight, up, down = (t.to(dt).contiguous() for t in (weight, up, down))
    bias = None if bias is None else bias.to(dt).contiguous()
    s = _scale32(scale, x.device)
    y = torch.empty((m, n), dtype=dt, device=x.device)
    grid = grid or (plan_f32 if fp32 else plan)(m, n, k)
    bm, bn, splits = grid
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part = counters = None
        if splits > 1:  # fp32 partials of y and h, summed by the last CTA of each tile
            part = torch.empty(part_floats(m, n, grid), dtype=torch.float32, device=x.device)
            counters = _grid.arrival_counters(x.device, stream,
                                              _grid.cdiv(m, bm) * _grid.cdiv(n, bn))
        ptrs = [x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
                up.data_ptr(), down.data_ptr(), s.data_ptr(), y.data_ptr()]
        part_ptrs = [None if part is None else part.data_ptr(),
                     None if counters is None else counters.data_ptr()]
        if fp32:
            fn = _kernel("dft_lora_dense_f32", [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                         + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            ws = f32_w_in_smem(m, k, bm) if w_split is None else w_split
            ws = ws and weight.data_ptr() % 16 == 0  # TMA reads W where it lies
            work = torch.empty(f32_scratch_floats(m, n, k, r, ws), dtype=torch.float32,
                               device=x.device)
            rc = fn(*ptrs, work.data_ptr(), work.numel(), *part_ptrs, m, n, k, r, bm, bn,
                    splits, int(ws), stream)
        else:
            fn = _kernel("dft_lora_dense", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
            rc = fn(*ptrs, *part_ptrs, m, n, k, r, bm, bn, splits, stream)
    _build.check(rc, "lora_dense")
    if fp32:
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
