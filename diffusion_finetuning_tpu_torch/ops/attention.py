"""Attention dispatch (port of the JAX package's ``ops/attention.py``).

:func:`attention` (JAX :119) sends every call to the flash-attention forward
(``ops/flash_attention.py``): on a CUDA tensor that is the Hopper kernel, on
a CPU tensor its plain version.  The JAX router's TPU heuristics
(``flash_supported`` :76, ``FLASH_MIN_KV`` :30) are v5e measurements and are
not carried over: on the card the kernel takes every UNet attention,
cross-attention with KV=77 and the 8x8 mid block included.
:func:`plain_attention` is the JAX ``xla_attention`` (:97).

The JAX router's switches are kept with their meaning (:36-73):
:func:`set_flash_enabled` turns the kernel off for every call, and
:func:`set_flash_override` turns it on or off for the calls of one
``(seq_len_q, head_dim)`` (``None`` matches any), most specific first; a call
the router turns away goes to :func:`plain_attention` when its tensors lie on
the CPU, and raises on the card, where every call launches the kernel.
``xformers_utils`` sets them from its probe.  :func:`routing` is part of
every CUDA graph's key (``models/layers.kernel_switches``), since a graph
holds the route taken at its capture.

All paths take (B, S, H*D) tensors and keep the softmax in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .flash_attention import flash_attention

_FLASH_ENABLED = True

# (seq_len_q, head_dim) -> on/off; None in a slot matches any value
_SHAPE_OVERRIDES: Dict[Tuple[Optional[int], Optional[int]], bool] = {}


def set_flash_enabled(enabled: bool) -> None:
    """Global switch (the reference's set_use_memory_efficient_attention_xformers)."""
    global _FLASH_ENABLED
    _FLASH_ENABLED = bool(enabled)


def set_flash_override(seq_len_q: Optional[int] = None, head_dim: Optional[int] = None,
                       enabled: Optional[bool] = True) -> None:
    """Force the kernel on or off for calls matching ``(seq_len_q,
    head_dim)``; most specific match wins: (sq, d) > (sq, None) > (None, d).
    Overrides take precedence over the global switch.  ``enabled=None``
    removes the override."""
    key = (seq_len_q, head_dim)
    if enabled is None:
        _SHAPE_OVERRIDES.pop(key, None)
    else:
        _SHAPE_OVERRIDES[key] = bool(enabled)


def clear_flash_overrides() -> None:
    _SHAPE_OVERRIDES.clear()


def _override_for(seq_len_q: int, head_dim: int) -> Optional[bool]:
    for key in ((seq_len_q, head_dim), (seq_len_q, None), (None, head_dim)):
        if key in _SHAPE_OVERRIDES:
            return _SHAPE_OVERRIDES[key]
    return None


def routing() -> tuple:
    """The router's state: the global switch and the overrides."""
    return _FLASH_ENABLED, tuple(sorted(_SHAPE_OVERRIDES.items(), key=repr))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention written out: fp32 logits and softmax, probabilities
    cast to v's dtype, (B, Sq, C) x (B, Skv, C) -> (B, Sq, C)."""
    B, sq, C = q.shape
    skv = k.shape[1]
    d = C // heads
    if scale is None:
        scale = d ** -0.5
    qh = q.reshape(B, sq, heads, d).transpose(1, 2).float()
    kh = k.reshape(B, skv, heads, d).transpose(1, 2).float()
    vh = v.reshape(B, skv, heads, d).transpose(1, 2)
    probs = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), vh.float()).to(v.dtype)
    return out.transpose(1, 2).reshape(B, sq, C)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              scale: Optional[float] = None) -> torch.Tensor:
    """Main entry: the flash-attention forward, unless the router sends the
    call to :func:`plain_attention`, which it may only for CPU tensors."""
    sq, d = q.shape[1], q.shape[-1] // heads
    override = _override_for(sq, d)
    if (_FLASH_ENABLED if override is None else override):
        return flash_attention(q, k, v, heads, scale)
    if q.device.type != "cpu":
        raise RuntimeError(
            f"the attention router turns the flash kernel off for (seq_len_q={sq}, "
            f"head_dim={d}), but a {q.device.type} call must launch the kernel; "
            "clear the override or set_flash_enabled(True)")
    return plain_attention(q, k, v, heads, scale)
