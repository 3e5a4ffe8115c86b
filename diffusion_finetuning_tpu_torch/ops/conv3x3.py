"""Fused 3x3 convolution: a hand-written Hopper kernel, its plain version,
the autograd function around it and the routing predicate.

Port of the JAX package's Pallas TPU kernel ``ops/conv_pallas.py:_kernel``
(:72, wrapper ``_conv3x3_fwd`` :95, public ``conv3x3`` :145 with a custom
VJP whose backward is XLA's conv gradient, :155-169; routing ``supported``
:172).  The CUDA kernel is ``csrc/conv3x3.cu`` (K5, ``sm_90a``), an implicit
GEMM (output channels x pixels x 9 taps * C) that reads the NCHW input where
it lies, by TMA, with no padded, channels-last or 9-tap copy of it; its
weight comes from a tap-major copy (:func:`tap_major`), made once per
weight and cached.  :func:`plan` sizes its grid.  Its design and bound are
noted there.

Layouts are PyTorch's, as in the port's modules: x (B, C, H, W), weight
(O, C, 3, 3), bias (O,) or None, y (B, O, H, W).  The JAX function takes
NHWC/HWIO; the tests transpose between the two.  Stride 1, padding 1.

On a CPU tensor :func:`conv3x3` runs :func:`conv3x3_plain`; on a CUDA tensor
it launches the kernel or raises.  It is differentiable through
:class:`Conv3x3Function`, whose backward is PyTorch's conv gradient.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build, _grid

# kernel launches so far, bf16 and fp32 apart (chip_smoke.py resets and
# reads them)
launches = 0
fp32_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 128  # the TPU kernel's output-channel block, read by the routing rule
PIXELS = 128  # pixels a CTA of the Hopper kernel (whole image rows)
CHANNELS = 64  # output channels a CTA (one consumer warpgroup)
C_STEP = 64  # channels a k-step


class Plan(NamedTuple):
    """Grid of the Hopper kernel for one conv: ``sw`` the pixel tile's
    swizzle in bytes (``sw // 2`` pixels a TMA box), ``rows`` image rows a
    CTA, ``splits`` CTAs along the 9 * C k-loop, ``tiles`` the output tiles
    (B * ceil(H / rows) * ceil(O / CHANNELS))."""
    sw: int
    rows: int
    splits: int
    tiles: int


def plan(B: int, C: int, H: int, W: int, O: int,
         splits: Optional[int] = None) -> Optional[Plan]:
    """The bf16 Hopper kernel's grid, or None where its TMA route does not
    take the shape (W not a multiple of 8, or above 128: the element-load
    kernel takes those).  A tile is 64 output channels by 128 pixels of
    whole image rows of one image, each row padded to wp = ceil(W / P) * P
    pixels, P = 16, 32 or 64 (the widest box W needs, at most 64); the 9 *
    ceil(C / 64) k-steps split where the tiles do not fill one wave, into
    the fewest runs of at least 4 steps that do (``_grid.k_splits``).
    ``splits`` overrides the rule's choice (tests, timings)."""
    if W % 8 or W > PIXELS:
        return None
    p = 16 if W <= 16 else 32 if W <= 32 else 64
    wp = _grid.cdiv(W, p) * p
    rows = PIXELS // wp
    tiles = B * _grid.cdiv(H, rows) * _grid.cdiv(O, CHANNELS)
    splits = splits or _grid.k_splits(tiles, 9 * _grid.cdiv(C, C_STEP), 4)
    return Plan(sw=2 * p, rows=rows, splits=splits, tiles=tiles)


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


_TAP_MAJOR = {}  # (id(weight), dtype) -> (weakref to the weight, its _version, w9)
tap_major_copies = 0  # misses of the cache: tap-major copies made so far


def tap_major(weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The Hopper kernel's weight operand: ``w9[kh * 3 + kw, o, c] =
    weight[o, c, kh, kw]`` in ``dtype`` (default the weight's), contiguous
    (9, O, C) -- JAX's ``w9`` (``conv_pallas.py:116``, (9, C, O)) with the
    last two dims swapped, so that a tap's channels are contiguous for TMA.

    A frozen weight is reordered once: the copy is cached per weight and
    returned again only for the same tensor object at the same ``_version``
    (an in-place update bumps it, so it gets a fresh copy); a freed weight
    drops its copy.  Writes through ``.data`` bypass the version counter,
    as they bypass autograd's own checks.  Inference tensors have no
    version counter and are reordered on every call (the pipeline builds
    its merged LoRA weights outside inference mode for that reason); inside
    a CUDA graph such a reorder is one copy each replay.  A cache miss of
    another weight while a graph is being captured raises (a warm-up fills
    the cache first).  :data:`tap_major_copies` counts the copies made."""
    dtype = dtype or weight.dtype
    o, c = weight.shape[:2]

    def reorder():
        global tap_major_copies
        tap_major_copies += 1
        return weight.detach().to(dtype).permute(2, 3, 0, 1).reshape(9, o, c).contiguous()

    if weight.is_inference():
        return reorder()
    key = (id(weight), dtype)
    hit = _TAP_MAJOR.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == weight._version:
        return hit[2]
    if weight.is_cuda and torch.cuda.is_current_stream_capturing():
        # the copy would be recorded, not made, yet cached for eager calls
        raise RuntimeError("a tap-major weight copy was asked for while a CUDA graph is "
                           "being captured: warm up on the capture stream first")
    w9 = reorder()
    _TAP_MAJOR[key] = (weakref.ref(weight, lambda _, k=key: _TAP_MAJOR.pop(k, None)),
                       weight._version, w9)
    return w9


def refresh_tap_major(weight: torch.Tensor) -> None:
    """After an in-place write to ``weight``, rewrite its cached tap-major
    copies in place (the same tensors, which a CUDA graph may read) and mark
    them current; a weight with no cached copy is left alone."""
    global tap_major_copies
    o, c = weight.shape[:2]
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        key = (id(weight), dtype)
        hit = _TAP_MAJOR.get(key)
        if hit is None or hit[0]() is not weight:
            continue
        tap_major_copies += 1
        # a copy made inside a request's inference mode is an inference
        # tensor, written in place only there
        with torch.inference_mode(hit[2].is_inference()):
            hit[2].copy_(weight.detach().to(dtype).permute(2, 3, 0, 1).reshape(9, o, c))
        _TAP_MAJOR[key] = (hit[0], weight._version, hit[2])


_FNS = {}


def _kernel(symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/conv3x3.cu``, built at first use."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(_build.load("conv3x3"), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _conv3x3_cuda(x, weight, bias, grid: Optional[Plan] = None):
    """The kernel on NCHW x: the Hopper design where :func:`plan` takes the
    bf16 shape (``grid`` overrides its plan), else the element-load kernel
    (bf16) or the FMA kernel (fp32)."""
    global launches, fp32_launches
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
    bias = None if bias is None else bias.to(dt).contiguous()
    y = torch.empty((B, O, H, W), dtype=dt, device=x.device)
    p = (grid or plan(B, C, H, W, O)) if dt == torch.bfloat16 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bias_ptr = None if bias is None else bias.data_ptr()
        if p is None:
            fn = _kernel("dft_conv3x3", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
            wt = weight.to(dt).contiguous()
            rc = fn(x.data_ptr(), wt.data_ptr(), bias_ptr, y.data_ptr(), B, C, H, W, O,
                    _DTYPES[dt], stream)
        else:
            fn = _kernel("dft_conv3x3_wgmma", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
            w9 = tap_major(weight, dt)
            part = counters = None
            if p.splits > 1:  # fp32 partials, summed by the last CTA of each tile
                part = torch.empty(p.splits * p.tiles * CHANNELS * PIXELS, dtype=torch.float32,
                                   device=x.device)
                counters = _grid.arrival_counters(x.device, stream, p.tiles)
            rc = fn(x.data_ptr(), w9.data_ptr(), bias_ptr, y.data_ptr(),
                    None if part is None else part.data_ptr(),
                    None if counters is None else counters.data_ptr(), B, C, H, W, O,
                    p.sw, p.splits, stream)
    _build.check(rc, "conv3x3")
    if dt == torch.float32:
        fp32_launches += 1
    else:
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
