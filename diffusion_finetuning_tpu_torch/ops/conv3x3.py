"""Fused 3x3 convolution: a hand-written Hopper kernel, its plain version,
the autograd function around it and the routing predicate.

Port of the JAX package's Pallas TPU kernel ``ops/conv_pallas.py:_kernel``
(:72, wrapper ``_conv3x3_fwd`` :95, public ``conv3x3`` :145 with a custom
VJP whose backward is XLA's conv gradient, :155-169; routing ``supported``
:172).  The CUDA kernel is ``csrc/conv3x3.cu`` (K5, ``sm_90a``), an implicit
GEMM that reads the NCHW input and the OIHW weight where they lie: no
padded, channels-last or 9-tap copy is made; its design and bound are noted
there.

Layouts are PyTorch's, as in the port's modules: x (B, C, H, W), weight
(O, C, 3, 3), bias (O,) or None, y (B, O, H, W).  The JAX function takes
NHWC/HWIO; the tests transpose between the two.  Stride 1, padding 1.

On a CPU tensor :func:`conv3x3` runs :func:`conv3x3_plain`; on a CUDA tensor
it launches the kernel or raises.  It is differentiable through
:class:`Conv3x3Function`, whose backward is PyTorch's conv gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

# kernel launches so far (chip_smoke.py resets and reads it)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 128  # the TPU kernel's output-channel block, read by the routing rule


def _row_block(H, W, C, itemsize=2):
    """The TPU kernel's image rows per grid step (a verbatim copy of JAX
    ``_row_block``, :55-69), read only by :func:`supported`."""
    rows_cap = max(64, min(512, 3145728 // (9 * C * itemsize)))
    bh = max(1, min(H, rows_cap // W))
    while bh > 1 and H % bh:  # grid needs bh | H; snap down to a divisor
        bh -= 1
    return bh


def supported(x_shape, kernel_shape, strides, padding: int = 1,
              itemsize: int = 2) -> bool:
    """Routing predicate: shapes this kernel handles efficiently.

    A verbatim copy of the JAX package's ``conv_pallas.supported``
    (:172-209, with ``_row_block`` :55-69), in the JAX layouts: ``x_shape``
    (B, H, W, C), ``kernel_shape`` (3, 3, C, O).  It is kept so that both
    packages send the same convs to their kernel: its VMEM budget is the TPU
    kernel's routing rule, not a limit of the Hopper kernel, which takes any
    B, H, W, O and any C divisible by 8.

    ``padding`` must be 1 (same-padding): :func:`conv3x3` hardcodes the
    (1, 1) halo, so routing a valid-padding conv here would silently
    produce same-padded (wrong-shape) output.
    """
    if padding != 1:
        return False
    if len(x_shape) != 4 or len(kernel_shape) != 4:
        return False
    B, H, W, C = x_shape
    kh, kw, _, O = kernel_shape
    if (kh, kw) != (3, 3) or strides != (1, 1):
        return False
    if H < 8:
        return False
    # MXU-feedable contraction + lane dims; tiny C (e.g. the RGB stem),
    # tiny O (e.g. rank-r LoRA down convs, O -> 128 lane round-up), or
    # tiny W would waste the tile
    if C % 16 != 0 or C < 64 or O < 64 or W < 8:
        return False
    # VMEM budget (double-buffered x9 + weights + fp32 accumulator) at the
    # caller's element size (bf16 on the production path)
    bh = _row_block(H, W, C, itemsize)
    if bh < H and bh * W < 128:
        # the divisor snap can degenerate to bh=1 (e.g. prime H from an
        # odd img2img latent size): many grid steps of <128-row matmuls
        # starve the MXU — leave those shapes on the XLA emitter.  A
        # whole-image block (bh == H, e.g. the 8x8 UNet level's 64 rows)
        # is exempt: one step cannot be tiled better.
        return False
    vmem = (2 * 9 * bh * W * C * itemsize
            + 2 * 9 * C * BN * itemsize
            + bh * W * BN * 4
            + 2 * bh * W * BN * itemsize)
    return vmem <= 12 * 1024 * 1024


def routes(x: torch.Tensor, weight: torch.Tensor, stride, padding) -> bool:
    """:func:`supported` for an NCHW input and an OIHW weight with
    ``nn.Conv2d``'s ``stride`` and ``padding`` (int or pair), as the JAX
    ``LoRAConv`` asks it (models/layers.py:212-214)."""
    if x.ndim != 4 or weight.ndim != 4 or isinstance(padding, str):
        return False
    pads = (padding, padding) if isinstance(padding, int) else tuple(padding)
    if pads[0] != pads[1]:
        return False
    strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    return supported((b, h, w, c), (kh, kw, c, o), strides, padding=pads[0],
                     itemsize=x.element_size())


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's math in torch: the 9 tap products of shifted views of
    the zero-padded input, operands in x's dtype, products and sums in fp32,
    the bias added before the one rounding to x's dtype."""
    B, C, H, W = x.shape
    dt = x.dtype
    xp = F.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1).float()  # (B, H+2, W+2, C)
    wf = weight.to(dt).float()
    acc = None
    for i in range(3):
        for j in range(3):
            tap = xp[:, i:i + H, j:j + W].reshape(B * H * W, C) @ wf[:, :, i, j].t()
            acc = tap if acc is None else acc + tap
    if bias is not None:
        acc = acc + bias.to(dt).float()
    return acc.reshape(B, H, W, -1).permute(0, 3, 1, 2).to(dt).contiguous()


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("conv3x3").dft_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _conv3x3_cuda(x, weight, bias):
    global launches
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 kernel takes fp32 or bf16, got {x.dtype}")
    if any(t.device != x.device for t in (weight,) + ((bias,) if bias is not None else ())):
        raise ValueError("conv3x3 operands must be on one device")
    if x.ndim != 4 or weight.ndim != 4:
        raise ValueError(f"x {tuple(x.shape)} must be NCHW and weight "
                         f"{tuple(weight.shape)} OIHW")
    B, C, H, W = x.shape
    O = weight.shape[0]
    if weight.shape != (O, C, 3, 3) or (bias is not None and bias.shape != (O,)):
        raise ValueError(f"shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} do not match")
    if x.dtype == torch.bfloat16 and C % 8:
        raise ValueError(f"bf16 conv3x3 kernel needs C % 8 == 0, got C={C}")
    dt = x.dtype
    x = x.contiguous()
    weight = weight.to(dt).contiguous()
    bias = None if bias is None else bias.to(dt).contiguous()
    y = torch.empty((B, O, H, W), dtype=dt, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
                y.data_ptr(), B, C, H, W, O, _DTYPES[dt], stream)
    _build.check(rc, "conv3x3")
    launches += 1
    return y


def _forward(x, weight, bias):
    if x.device.type == "cuda":
        return _conv3x3_cuda(x, weight, bias)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    raise ValueError(f"no conv3x3 for device {x.device}")


class Conv3x3Function(torch.autograd.Function):
    """Differentiable 3x3 conv.  Forward: the kernel (the plain version on
    the CPU).  Backward: PyTorch's conv gradient, as JAX ``_bwd`` (:159)
    takes XLA's, computing only the gradients autograd asks for (a frozen
    base weight gets no dW on the LoRA training path)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = torch.nn.grad.conv2d_input(x.shape, weight.to(g.dtype), g, padding=1)
        if need_w:
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, g, padding=1).to(weight.dtype)
        if need_b and ctx.bias_dtype is not None:
            db = g.float().sum(dim=(0, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1, same-padded 3x3 conv (NCHW x, OIHW weight), differentiable."""
    operands = [x, weight] + ([bias] if bias is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return Conv3x3Function.apply(x, weight, bias)
    return _forward(x, weight, bias)
