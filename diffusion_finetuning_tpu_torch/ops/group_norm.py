"""GroupNorm over channels-last activations, with an optional per-(batch,
channel) add before it and an optional SiLU after it: a hand-written Hopper
kernel and its plain version.

    y = act(group_norm(round(x + add[:, :, None, None]), groups, weight, bias, eps))

with the statistics (mean and biased variance of each image's group, as
PyTorch's) and the arithmetic in fp32, ``x + add`` rounded to x's dtype as an
add in that dtype rounds, ``act`` SiLU or none, and one rounding of y to x's
dtype.  It replaces no TPU kernel: the JAX package leaves GroupNorm to XLA.
It serves the channels-last layout of the generation path
(``models/layers.py``), where PyTorch's GroupNorm makes every CUDA input
contiguous in NCHW; the resnets' ``norm2`` takes the time embedding as its
``add`` and both resnet norms their SiLU.  The CUDA kernel is
``csrc/group_norm.cu`` (two launches: statistics, then the normalisation);
its design and bound are noted there, its grid comes from :func:`plan`.

Layouts are PyTorch's logical NCHW at this module's functions: x (B, C, H,
W) whose memory is channels-last, weight and bias (C,), add (B, C) or None;
y like x.  On a CPU tensor :func:`group_norm` runs :func:`group_norm_plain`
(differentiable); on a CUDA tensor it launches the kernel (forward only) or
raises: :func:`supported` says which CUDA calls the kernel takes.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build, _grid

# kernel calls so far, each two launches (statistics, then normalisation):
# the counter counts calls, as K3's counts a backward of two kernels
launches = 0

THREADS = 512  # threads a CTA where the channels allow (more where C / vector is larger)
MIN_LOADS = 4  # 16-byte loads a thread at least, per tile
MAX_LOADS = 256  # and at most
TARGET_CTAS = 4 * _grid.SMS  # CTAs a launch aims at: about two waves of 512 threads


class Plan(NamedTuple):
    """Grid of both launches: ``threads`` a CTA (C / vector channel vectors
    times ``lanes`` pixel lanes), ``tile`` pixels of one image a CTA (a
    multiple of ``lanes``), ``tiles`` CTAs an image."""
    threads: int
    lanes: int
    tile: int
    tiles: int


def vector(itemsize: int) -> int:
    """Channels a thread loads at once: 16 bytes."""
    return 16 // itemsize


def plan(B: int, HW: int, C: int, itemsize: int = 2) -> Optional[Plan]:
    """The kernel's grid for B images of HW pixels and C channels, or None
    where it takes no such call (C not a multiple of the vector, or no
    whole number of warps of at most 1024 threads holds whole pixel rows).
    A thread owns one channel vector; up to :data:`THREADS` threads (whole
    warps: the group sums run a warp at a time) hold whole pixel rows; each
    thread walks at least :data:`MIN_LOADS` pixels of its tile, more until
    the grid is about :data:`TARGET_CTAS` CTAs."""
    vec = vector(itemsize)
    if C % vec:
        return None
    v = C // vec
    step = 32 // math.gcd(v, 32)  # pixel lanes come in steps that keep whole warps
    lanes = max(step, THREADS // v // step * step)
    if v * lanes > 1024:
        return None
    loads = min(MAX_LOADS, max(MIN_LOADS, _grid.cdiv(B * HW, lanes * TARGET_CTAS)))
    tile = lanes * loads
    return Plan(v * lanes, lanes, tile, _grid.cdiv(HW, tile))


def supported(x: torch.Tensor, groups: int, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], add: Optional[torch.Tensor] = None) -> bool:
    """Whether the CUDA kernel takes the call: a channels-last contiguous
    4-D bf16 or fp32 CUDA x on a 16-byte boundary, a weight and a bias of C
    values, an add of (B, C) or none, C a multiple of ``groups`` with a
    :func:`plan`."""
    if not (x.is_cuda and x.dim() == 4 and x.dtype in (torch.bfloat16, torch.float32)
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0):
        return False
    B, C = x.shape[:2]
    if weight is None or bias is None or weight.numel() != C or bias.numel() != C:
        return False
    if add is not None and tuple(add.shape) != (B, C):
        return False
    return C % groups == 0 and plan(B, x.shape[2] * x.shape[3], C, x.element_size()) is not None


def group_norm_plain(x: torch.Tensor, groups: int, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float,
                     add: Optional[torch.Tensor] = None, silu: bool = False) -> torch.Tensor:
    """The kernel's math in torch: ``x + add`` in x's dtype, then GroupNorm
    and SiLU in fp32, one rounding to x's dtype; y in x's memory format."""
    dt = x.dtype
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    if add is not None:
        x = x + add.to(dt)[:, :, None, None]
    y = F.group_norm(x.float(), groups, None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps)
    if silu:
        y = F.silu(y)
    return y.to(dt).contiguous(memory_format=fmt)


_FN = []


def _kernel():
    if not _FN:
        fn = _build.load("group_norm").dft_group_norm
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _group_norm_cuda(x, groups, weight, bias, eps, add=None, silu=False, grid=None):
    """Both launches on x's stream; ``grid`` overrides :func:`plan`."""
    global launches
    if not supported(x, groups, weight, bias, add):
        raise ValueError(f"group_norm kernel does not take x {tuple(x.shape)} {x.dtype} "
                         f"(channels-last: {x.is_contiguous(memory_format=torch.channels_last)})"
                         f", {groups} groups")
    if any(t.device != x.device for t in (weight, bias) + (() if add is None else (add,))):
        raise ValueError("group_norm operands must be on one device")
    B, C, H, W = x.shape
    dt = x.dtype
    p = grid or plan(B, H * W, C, x.element_size())
    weight, bias = weight.to(dt).contiguous(), bias.to(dt).contiguous()
    add = None if add is None else add.to(dt).contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty(2 * B * groups * _grid.cdiv(H * W, p.tile), dtype=torch.float32,
                       device=x.device)
    ss = torch.empty(2 * B * C, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _grid.arrival_counters(x.device, stream, B)
        rc = _kernel()(x.data_ptr(), None if add is None else add.data_ptr(), weight.data_ptr(),
                       bias.data_ptr(), y.data_ptr(), part.data_ptr(), ss.data_ptr(),
                       counters.data_ptr(), B, H * W, C, groups, p.threads, p.tile, eps,
                       int(silu), int(dt == torch.float32), stream)
    _build.check(rc, "group_norm")
    launches += 1
    return y


def group_norm(x: torch.Tensor, groups: int, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float, add: Optional[torch.Tensor] = None,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm of channels-last x (with ``add`` before it and SiLU after
    it): the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cuda":
        return _group_norm_cuda(x, groups, weight, bias, eps, add, silu)
    if x.device.type in ("cpu", "meta"):
        return group_norm_plain(x, groups, weight, bias, eps, add, silu)
    raise ValueError(f"no group_norm for device {x.device}")
