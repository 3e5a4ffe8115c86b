"""Flash attention: hand-written Hopper kernels for the forward and the
backward, their plain versions, and the autograd function around them.

Port of the JAX package's Pallas TPU kernels ``ops/flash_attention.py``
``_fwd_kernel`` (:87, wrapper ``_fwd`` :141), ``_fwd_kernel_packed`` (:178,
wrapper ``_fwd_packed`` :239) and ``_bwd_kernel`` (:285, wrapper ``_bwd``
:349), joined by the custom VJP ``_flash`` (:430-456) and reached through the
public ``flash_attention`` (:459).  The CUDA kernels are
``csrc/flash_attention.cu`` (K1, forward, and K4, the same forward with G
heads per CTA) and ``csrc/flash_attention_bwd.cu`` (K3, backward) on bf16
inputs, ``csrc/flash_attention_f32.cu`` and ``csrc/flash_attention_bwd_f32.cu``
on fp32 inputs (split products of three TF32 products on the tensor cores,
with fp32 scratch for the split copies of the operands), all ``sm_90a``;
their designs and bounds are noted there.  Two host rules size
their grids: :func:`fwd_q_tile` and :func:`packed_q_tile` (64 or 128 q
rows a forward CTA of K1 and of K4) and
:func:`bwd_q_splits` (CTAs sharing one KV tile's q loop in the backward,
whose fp32 dK/dV partials the kernel sums in split order;
:func:`flash_backward_plain` takes the same ``q_splits``).  The backward's
dQ is a second kernel that sums over the KV tiles in their order, so dQ,
like dK and dV, repeats bit for bit.

Head packing is opt-in, as in JAX: ``head_pack`` (default
:data:`DEFAULT_HEAD_PACK`, read once from ``DFT_FLASH_HEAD_PACK``, 1 = off)
sends a forward to K4 when JAX ``_fwd_dispatch`` (:419) would send it to
``_fwd_packed``; K4's O and lse are bit-equal to K1's.  The backward always
runs K3 per head (JAX ``_flash_bwd`` :445-453).

Contract of :func:`flash_fwd` (the kernel's own layout, as JAX ``_fwd``):
q ``(BH, Sq, D)``, k/v ``(BH, Skv, D)`` -> O ``(BH, Sq, D)`` in q's dtype and
an fp32 lse ``(BH, Sq)``.  The lse is in BASE 2 -- ``log2`` of the sum of
``2**(logits * scale * log2(e))``, i.e. the natural-log lse times
``log2(e)`` -- the JAX package's default (``DFT_FLASH_EXP2=1``).
:func:`flash_bwd` reads it in that base: ``(q, k, v, O, lse, dO)`` ->
``(dQ, dK, dV)`` in q's, k's and v's dtypes.

On a CPU tensor every entry here runs the plain version
(:func:`flash_attention_plain`, :func:`flash_backward_plain`); on a CUDA
tensor it launches the kernel or raises.  :func:`flash_attention` is
differentiable: with grad enabled and an input that requires grad it runs
:class:`FlashAttentionFunction` (K1 forward, K3 backward).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import _build, _grid

LOG2E = 1.4426950408889634
NEG_INF = -1e30

# kernel launches so far: the bf16 forward (K1), the bf16 packed forward
# (K4), the fp32 forward (K1's and K4's fp32 kernel), the bf16 backward (K3)
# and the fp32 backward (K3's fp32 pair); chip_smoke.py resets and reads them
launches = 0
packed_launches = 0
fp32_launches = 0
bwd_launches = 0
bwd_fp32_launches = 0

# heads per CTA of the forward (JAX DEFAULT_HEAD_PACK, :69); 1 = K1 only
DEFAULT_HEAD_PACK = int(os.environ.get("DFT_FLASH_HEAD_PACK", 1))
# the JAX wrapper's defaults (:42-43, :61), fed to the routing rule only: the
# port pads nothing in memory
_JAX_BLOCK_Q, _JAX_BLOCK_KV, _JAX_HEAD_PAD = 512, 1024, 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 160  # largest padded head dim the kernels are built for
# H100 SXM streaming multiprocessors; the tile and split rules size grids
# against one wave (one CTA an SM) and two waves of them
_SMS = 132
_KV_TILE = 64  # KV rows per CTA of the backward and per K/V stage of the forward


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, block_q: int = 256,
                          block_kv: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in blockwise torch: online softmax over K/V blocks
    with fp32 statistics and accumulator, dots in the input precision with
    fp32 accumulation, p rounded to v's dtype before the PV product, exp2
    with log2(e) folded into the scale.  A ragged last KV block is sliced
    rather than masked, which is the same sum as the kernel's -1e30 mask."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    logit_scale = scale * LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    outs, lses = [], []
    for i in range(0, sq, block_q):
        qb = qf[:, i:i + block_q]
        n = qb.shape[1]
        m = torch.full((bh, n, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, n, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, n, d), dtype=torch.float32, device=q.device)
        for j in range(0, skv, block_kv):
            s = torch.matmul(qb, kf[:, j:j + block_kv].transpose(1, 2)) * logit_scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                             vf[:, j:j + block_kv])
            m = m_new
        outs.append((acc / l).to(q.dtype))
        lses.append((m + torch.log2(l)).squeeze(-1))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def flash_attention_plain_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: float, head_pack: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: :func:`flash_attention_plain` over each group of
    ``head_pack`` heads (BH divisible by it), outputs concatenated."""
    outs = [flash_attention_plain(q[i:i + head_pack], k[i:i + head_pack],
                                  v[i:i + head_pack], scale)
            for i in range(0, q.shape[0], head_pack)]
    return torch.cat([o for o, _ in outs]), torch.cat([lse for _, lse in outs])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def head_pack_fits_vmem(G: int, skv: int, dp: int, block_q: int = 512,
                        itemsize: int = 2) -> bool:
    """Whether the packed forward's VMEM residency fits the 16MB scope.

    A verbatim copy of the JAX package's ``head_pack_fits_vmem``
    (``ops/flash_attention.py:398-416``), kept so that both packages send the
    same calls to the packed kernel.  The budget is the TPU kernel's
    (G full KV streams double-buffered in VMEM, lanes padded to 128), not a
    limit of the Hopper kernel, which streams K/V through shared memory in
    64-row tiles whatever G is.
    """
    if G <= 1:
        return True
    lanes = max(128, dp)
    skv_p = _cdiv(skv, 512) * 512 if skv > 512 else skv  # kv pad granularity
    kv_bytes = 2 * 2 * G * skv_p * lanes * itemsize      # dbl-buffered k+v
    qo_bytes = 2 * 2 * G * block_q * lanes * itemsize    # q + out blocks
    acc_bytes = G * block_q * lanes * 4 * 3              # fp32 carries
    return kv_bytes + qo_bytes + acc_bytes <= 12 * 1024 * 1024


def use_head_pack(head_pack: int, bh: int, sq: int, skv: int, d: int,
                  itemsize: int) -> bool:
    """JAX ``_fwd_dispatch``'s rule (:419-427) for a (BH, Sq, d) x (BH, Skv,
    d) call, fed the sizes the JAX wrapper feeds it: the head dim padded to
    8, block_q = min(512, round_up(Sq, 128)) and Skv padded to a multiple of
    min(1024, round_up(Skv, 128))."""
    if head_pack <= 1 or bh % head_pack:
        return False
    dp = _round_up(d, _JAX_HEAD_PAD)
    block_q = min(_JAX_BLOCK_Q, _round_up(sq, 128))
    skv_p = _round_up(skv, min(_JAX_BLOCK_KV, _round_up(skv, 128)))
    return head_pack_fits_vmem(head_pack, skv_p, dp, block_q, itemsize)


def fwd_q_tile(bh: int, sq: int) -> int:
    """q rows per CTA of the bf16 forward kernel K1 (and of K3's dQ kernel,
    which walks the KV tiles as K1 does): 128 (two consumer warpgroups,
    each CTA reading K/V once for 128 rows) where the (ceil(Sq/128), BH)
    grid still covers half the card's 132 SMs, else 64 (one warpgroup), so
    that a small call keeps its CTAs.  At S=1024, BH=16 the 128 CTAs of 128
    rows beat 256 of 64; at S=256 the 32 CTAs of 128 rows lose to 64 of 64
    (``PERF.md``)."""
    return 128 if 2 * _cdiv(sq, 128) * bh >= _SMS else 64


def packed_q_tile(bh: int, head_pack: int, sq: int) -> int:
    """q rows per CTA of the head-packed forward (K4): :func:`fwd_q_tile`
    of its own grid, (ceil(Sq/tile), BH/G) CTAs, each running its G heads
    at once on separate warpgroups -- 128 where that grid still covers half
    the SMs, else 64, so that K4 keeps as many CTAs as the packing allows.
    At S=1024, BH=16, G=2 that is 64 (128 CTAs), where K1 takes 128 (also
    128 CTAs)."""
    return fwd_q_tile(bh // head_pack, sq)


def bwd_q_rows(d: int) -> int:
    """q rows per tile of the bf16 backward (K3, ``q_rows`` there): dK and
    dV of 64 KV rows take d_pad/2 fp32 registers a thread each, so the q
    tile narrows as the head dim grows (64 rows up to d_pad 64, 32 up to
    96, else 16)."""
    dp = _round_up(d, 16)
    return 64 if dp <= 64 else 32 if dp <= 96 else 16


def f32_head_pad(d: int) -> int:
    """Head dim of the fp32 kernels' split copies: d rounded up to 8 up to
    64, to 16 above (``csrc/split_f32.cuh:f32_dpad``)."""
    return _round_up(d, 8) if d <= 64 else _round_up(d, 16)


def bwd_q_rows_f32(d: int) -> int:
    """q rows per tile of the fp32 backward's dK/dV kernel: 32 up to d_pad
    72, 16 up to 96, else 8 (dK and dV take d_pad/2 registers each, and a
    ring stage holds 8 split tiles of the q rows)."""
    dp = f32_head_pad(d)
    return 32 if dp <= 72 else 16 if dp <= 96 else 8


def f32_fwd_scratch(bh: int, sq: int, skv: int, d: int) -> int:
    """fp32 values of the fp32 forward's split copies: Q and K [big; small]
    rows, V [big; small] transposed (``csrc/flash_attention_f32.cu``)."""
    return 2 * bh * f32_head_pad(d) * (sq + skv + _round_up(skv, 8))


def f32_bwd_scratch(bh: int, sq: int, skv: int, d: int) -> int:
    """fp32 values of the fp32 backward's split copies: Q, dO, K, V rows and
    Q, dO, K transposed, [big; small] each (``csrc/flash_attention_bwd_f32.cu``)."""
    return 2 * bh * f32_head_pad(d) * (2 * sq + 2 * skv + 2 * _round_up(sq, 8)
                                       + _round_up(skv, 8))


def bwd_q_splits(bh: int, sq: int, skv: int, d: int, q_rows: Optional[int] = None) -> int:
    """CTAs per (head, 64 KV rows) of the backward's dK/dV kernel, on the
    grid (ceil(Skv/64), BH, q_splits): the fewest that give two waves (>= 2
    x 132 CTAs) while every split keeps at least 4 q tiles, and at least one
    wave (132 CTAs) wherever Sq has the q tiles for it.  Each split writes an
    fp32 dK/dV partial that the last CTA of its KV tile reads back, so
    splits of 1-3 tiles cost more than they give (measured on the SD1.5
    shapes, ``PERF.md``).  ``q_rows``: the kernel's q tile, the bf16
    kernel's :func:`bwd_q_rows` by default (the fp32 kernel's is
    :func:`bwd_q_rows_f32`)."""
    base = bh * _cdiv(skv, _KV_TILE)
    n_q = _cdiv(sq, q_rows or bwd_q_rows(d))
    if base >= 2 * _SMS:
        return 1
    two_waves = min(_cdiv(2 * _SMS, base), n_q // 4)
    one_wave = min(_cdiv(_SMS, base), n_q)
    return max(1, two_waves, one_wave)


def bwd_split_rows(sq: int, d: int, q_splits: int):
    """[(first, end)) q rows of each split: split s walks q tiles
    [s*n // q_splits, (s+1)*n // q_splits) of the n = ceil(Sq/BR) tiles, as
    the kernel's blockIdx.z does."""
    br = bwd_q_rows(d)
    n = _cdiv(sq, br)
    return [(s * n // q_splits * br, min((s + 1) * n // q_splits * br, sq))
            for s in range(q_splits)]


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (BH, Sq) -- JAX ``_bwd`` :355, outside
    the kernel there too."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                         scale: float, block_q: int = 256, q_splits: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's math (FA2, JAX ``_bwd_kernel``) in blockwise
    torch over q blocks: P = exp2(S * scale * log2 e - lse) from the base-2
    lse, dV = P^T dO with P rounded to v's dtype, dP = dO V^T,
    dS = P (dP - delta) scale rounded to q's dtype, dK = dS^T Q, dQ = dS K;
    products of the inputs' values with fp32 accumulation.  With
    ``q_splits`` > 1, dK and dV are fp32 partials over the kernel's q-split
    ranges (:func:`bwd_split_rows`) summed in split order, as the kernel's
    last CTA sums them.  Returns dQ, dK, dV in q's, k's and v's dtypes."""
    bh, sq, d = q.shape
    logit_scale = scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = _delta(o, do)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    dqs = []
    for first, end in bwd_split_rows(sq, d, q_splits):
        pk, pv = torch.zeros_like(dk), torch.zeros_like(dv)
        for i in range(first, end, block_q):
            j = min(i + block_q, end)
            qb, dob = qf[:, i:j], dof[:, i:j]
            s = torch.matmul(qb, kf.transpose(1, 2)) * logit_scale
            p = torch.exp2(s - lse[:, i:j, None])
            pv += torch.matmul(p.to(v.dtype).float().transpose(1, 2), dob)
            dp = torch.matmul(dob, vf.transpose(1, 2))
            ds = (p * (dp - delta[:, i:j, None]) * scale).to(q.dtype).float()
            pk += torch.matmul(ds.transpose(1, 2), qb)
            dqs.append(torch.matmul(ds, kf).to(q.dtype))
        dk += pk
        dv += pv
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


_FNS = {}


def _kernel(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built at first use."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _check_qkv(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on the same device")
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {_MAX_HEAD_DIM} is not built")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernels take contiguous q, k, v")


def _fwd_cuda(q, k, v, scale, head_pack=1, q_tile=None):
    """K1 (``head_pack`` 1) or K4 (``head_pack`` heads per CTA, dividing BH)
    on (BH, S, D) tensors; ``q_tile`` (64 or 128 q rows a CTA) defaults to
    :func:`fwd_q_tile` for K1 and :func:`packed_q_tile` for K4."""
    global launches, packed_launches, fp32_launches
    _check_qkv(q, k, v)
    if not scale > 0:  # the kernel takes row maxima before scaling
        raise ValueError(f"the flash forward kernel takes a positive scale, got {scale}")
    bh, sq, d = q.shape
    if head_pack < 1 or bh % head_pack:
        raise ValueError(f"head_pack {head_pack} must divide BH = {bh}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    skv = k.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.float32:  # q_tile: the fp32 kernel's CTA is 64 q rows
            fn = _kernel("flash_attention_f32", "dft_flash_fwd_f32",
                         [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            work = torch.empty(f32_fwd_scratch(bh, sq, skv, d), dtype=torch.float32,
                               device=q.device)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    work.data_ptr(), work.numel(), bh, sq, skv, d, float(scale), head_pack,
                    stream)
        else:
            fn = _kernel("flash_attention", "dft_flash_fwd",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), bh, sq, skv, d, float(scale),
                    _DTYPES[q.dtype], head_pack,
                    q_tile or (fwd_q_tile(bh, sq) if head_pack == 1
                               else packed_q_tile(bh, head_pack, sq)), stream)
    _build.check(rc, "flash_attention")
    if q.dtype == torch.float32:
        fp32_launches += 1
    elif head_pack == 1:
        launches += 1
    else:
        packed_launches += 1
    return o, lse


def _bwd_cuda(q, k, v, lse, delta, do, scale, q_splits=None):
    """K3 on (BH, S, D) tensors: dK/dV with ``q_splits`` (default
    :func:`bwd_q_splits` of the dtype's q tile) CTAs a KV tile, then dQ
    summed over the KV tiles in their order, on :func:`fwd_q_tile`'s q tile
    (bf16; fp32: 64 q rows)."""
    global bwd_launches, bwd_fp32_launches
    _check_qkv(q, k, v)
    bh, sq, d = q.shape
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError("dO, lse and delta must be on q's device")
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must be a contiguous "
                         f"tensor like q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 ({bh}, {sq}) tensor")
    skv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fp32 = q.dtype == torch.float32
    q_rows = bwd_q_rows_f32(d) if fp32 else bwd_q_rows(d)
    splits = q_splits or bwd_q_splits(bh, sq, skv, d, q_rows)
    dp = f32_head_pad(d) if fp32 else _round_up(d, 16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = counters = None
        if splits > 1:  # fp32 dK/dV partials, summed by the last CTA of each KV tile
            part = torch.empty((splits, bh, _cdiv(skv, _KV_TILE), 2 * _KV_TILE * dp),
                               dtype=torch.float32, device=q.device)
            counters = _grid.arrival_counters(q.device, stream, bh * _cdiv(skv, _KV_TILE))
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
        part_ptrs = [None if part is None else part.data_ptr(),
                     None if counters is None else counters.data_ptr()]
        if fp32:
            fn = _kernel("flash_attention_bwd_f32", "dft_flash_bwd_f32",
                         [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                         + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p])
            work = torch.empty(f32_bwd_scratch(bh, sq, skv, d), dtype=torch.float32,
                               device=q.device)
            rc = fn(*ptrs, work.data_ptr(), work.numel(), *part_ptrs, bh, sq, skv, d,
                    float(scale), splits, stream)
        else:
            fn = _kernel("flash_attention_bwd", "dft_flash_bwd",
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                         + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            rc = fn(*ptrs, *part_ptrs, bh, sq, skv, d, float(scale), _DTYPES[q.dtype],
                    splits, fwd_q_tile(bh, sq), stream)
    _build.check(rc, "flash_attention_bwd")
    if q.dtype == torch.float32:
        bwd_fp32_launches += 1
    else:
        bwd_launches += 1
    return dq, dk, dv


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              head_pack: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, Sq, D) x (BH, Skv, D) -> (O, lse base 2); K4 where
    :func:`use_head_pack` accepts ``head_pack`` (default
    :data:`DEFAULT_HEAD_PACK`), else K1, on CUDA; their plain versions on
    CPU."""
    if head_pack is None:
        head_pack = DEFAULT_HEAD_PACK
    bh, sq, d = q.shape
    packed = use_head_pack(head_pack, bh, sq, k.shape[1], d, q.element_size())
    if q.device.type == "cuda":
        return _fwd_cuda(q, k, v, scale, head_pack if packed else 1)
    if q.device.type == "cpu":
        if packed:
            return flash_attention_plain_packed(q, k, v, scale, head_pack)
        return flash_attention_plain(q, k, v, scale)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, do: torch.Tensor, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) from the forward's inputs, O and base-2 lse, and dO;
    kernel on CUDA (delta computed as a torch op first), plain version on
    CPU."""
    if q.device.type == "cuda":
        return _bwd_cuda(q, k, v, lse, _delta(o, do), do, scale)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, scale)
    raise ValueError(f"no flash attention backward for device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable (BH, S, D) flash attention: :func:`flash_fwd` forward
    (K1 or K4), saving q, k, v, O and lse (JAX ``_flash_fwd`` :438), and
    :func:`flash_bwd` backward, per head whatever the forward's packing (JAX
    ``_flash_bwd`` :445)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, head_pack=None):
        o, lse = flash_fwd(q, k, v, scale, head_pack)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: Optional[float] = None,
                    head_pack: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H*D) x (B, Skv, H*D) -> (B, Sq, H*D), the JAX layout,
    differentiable.  The split to (B*H, S, D) and the merge back are torch
    copies (autograd carries the gradient through them), as the JAX
    wrapper's reshapes are XLA ops.  ``head_pack``: see :func:`flash_fwd`."""
    B, sq, C = q.shape
    skv = k.shape[1]
    d = C // heads
    if scale is None:
        scale = d ** -0.5

    def split(t, s):
        return t.reshape(B, s, heads, d).transpose(1, 2).reshape(B * heads, s, d).contiguous()

    qh, kh, vh = split(q, sq), split(k, skv), split(v, skv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o = FlashAttentionFunction.apply(qh, kh, vh, scale, head_pack)
    else:
        o, _ = flash_fwd(qh, kh, vh, scale, head_pack)
    return o.reshape(B, heads, sq, d).transpose(1, 2).reshape(B, sq, C)
