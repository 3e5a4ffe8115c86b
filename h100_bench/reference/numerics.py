"""The arithmetic the plain reference computes in.

``fp32`` is the reference itself: every product and sum in float32, TF32
off.  The other modes are the benchmark's controls, the reference put in
the program's place at the next precision down: ``tf32`` (every matmul,
conv and attention input rounded to TF32's 10-bit mantissa, to nearest),
``bf16`` (the same inputs rounded to bfloat16) and ``fp8`` (the same inputs
rounded to float8 e4m3, activations with one scale a tensor, weights one
scale an output channel, as an fp8 GEMM takes them).  Products are then summed in fp32.  Rounding is
applied in the forward pass; gradients pass through it unchanged.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "tf32", "bf16", "fp8")
_MODE = "fp32"
FP8_MAX = 448.0  # float8 e4m3's largest finite value


@contextlib.contextmanager
def precision(mode: str):
    """Compute the reference in ``mode`` for the duration of the block."""
    global _MODE
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}")
    saved = (_MODE, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _MODE = mode
    # no TF32 in any mode: the modes round the products' inputs themselves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        _MODE, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    amax = (x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)).float()
    scale = FP8_MAX / amax.clamp(min=1e-12)
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` with the 13 low mantissa bits rounded away (half away
    from zero), as TF32 keeps 10 of float32's 23."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def _round(x: torch.Tensor, weight: bool) -> torch.Tensor:
    if _MODE == "tf32":
        y = _tf32(x)
    elif _MODE == "bf16":
        y = x.to(torch.bfloat16).to(x.dtype)
    elif _MODE == "fp8":
        y = _fp8(x, dim=tuple(range(1, x.ndim)) if weight and x.ndim > 1 else None)
    else:
        return x
    # straight through: the rounding in the forward pass, the identity in the backward
    return x + (y - x).detach()


def act(x: torch.Tensor) -> torch.Tensor:
    """An activation entering a product, in the current mode."""
    return _round(x, weight=False)


def weight(w: torch.Tensor) -> torch.Tensor:
    """A weight entering a product, in the current mode."""
    return _round(w, weight=True)
