"""Grid sizing shared by the GEMM kernels (K2, K5), and the arrival counters
of every kernel whose last CTA sums split partials (K2, K3, K5).

The plans are pure functions of the shapes, so the CPU tests check them at
every SD1.5 shape; the kernels take what they return.
"""

from __future__ import annotations

import torch

# H100 SXM streaming multiprocessors: grids are sized against one wave (one
# CTA an SM) and two
SMS = 132


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_splits(tiles: int, k_steps: int, min_steps: int, min_tiles: int = SMS,
             target: int = SMS) -> int:
    """CTAs along K for a grid of ``tiles`` output tiles whose k-loop has
    ``k_steps`` steps: 1 where the grid has ``min_tiles`` tiles; else the
    fewest splits that give ``target`` CTAs (one wave), as far as every
    split keeps ``min_steps`` steps.  Splits cut the loop into contiguous
    runs of whole steps (split s: steps [s*n // splits, (s+1)*n // splits))."""
    if tiles >= min_tiles:
        return 1
    return max(1, min(cdiv(target, tiles), k_steps // min_steps))


def wave_splits(tiles: int, k_steps: int, min_steps: int, max_splits: int) -> int:
    """CTAs along K that best fill whole waves: 1 where the grid has three
    waves (the last wave's loss is small there, a split's partials are
    not); else the fewest splits s (at most ``max_splits``, every split
    keeping ``min_steps`` steps) that minimise ceil(tiles * s / SMS) / s,
    the waves a unit of the work takes."""
    if tiles >= 3 * SMS:
        return 1
    top = max(1, min(max_splits, k_steps // min_steps))
    return min(range(1, top + 1), key=lambda s: (cdiv(tiles * s, SMS) / s, s))


def split_steps(k_steps: int, splits: int):
    """[(first, end)) k-steps of each split, as the kernels cut them."""
    return [(s * k_steps // splits, (s + 1) * k_steps // splits) for s in range(splits)]


_COUNTERS = {}


def arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Arrival counters for ``n`` output tiles, one int32 buffer per (device,
    stream), allocated zeroed on that stream.  Each launch leaves them zero,
    so the launches of one stream, which run in order, share a buffer (K2,
    K3 and K5 alike); launches on two streams may run at the same time, so
    each stream has its own.

    A CUDA graph captured on a stream bakes in its buffer, so the buffer
    must exist before the capture (a warm-up on the capture stream makes
    it): a zero-fill made while capturing would only be recorded, and the
    buffer, from the graph's pool, would be handed to later launches.  That
    raises."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "arrival counters requested for a new stream or a larger grid while a "
                "CUDA graph is being captured: warm up on the capture stream first")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf
