"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs one CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports neither jax nor the JAX package, so on the
card's machine, which has no JAX, it runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: the fp32 flash kernels within chip_smoke.py's fp32 gates (O
within 1e-4 absolute and 1e-5 relative L2, lse within 1e-4; dQ, dK, dV
within 1e-4 of the largest reference value and 1e-5 relative L2); bf16
outputs within 2e-2 (flash) / 5e-2 (LoRA, |y| up to ~4)
absolute, or one bf16 ulp of the largest value (conv3x3)
absolute of the plain version on the same bf16 inputs -- the kernel and the
plain version round p or h and the output to bf16 at the same places but sum
in another order, so single values may land one bf16 ulp apart; fp32 within
1e-4; the flash lse within 1e-3.  The head-packed flash forward (K4) equals
K1 exactly.  K2 and K5 with split k-loops repeat bit for bit (the last CTA
sums the partials in split order).  The flash backward's dQ, dK and dV within
2e-2 of the largest reference value and 1e-2 relative L2 in bf16 (dS is
rounded to bf16 from sums taken in another order), 1e-4 relative in fp32;
in bf16 all three repeat bit for bit, and dQ is the same whatever the q
splits (it is summed over the KV tiles in their order).
"""

import threading

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from diffusion_finetuning_tpu_torch.models import layers as tlayers
from diffusion_finetuning_tpu_torch.models.layers import LoRAConv2d, LoRALinear
from diffusion_finetuning_tpu_torch.ops import attention as tatt
from diffusion_finetuning_tpu_torch.ops import conv3x3 as tconv
from diffusion_finetuning_tpu_torch.ops import flash_attention as tfa
from diffusion_finetuning_tpu_torch.ops import lora_matmul as tlm


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d", [(4096, 4096, 40), (1024, 77, 80), (64, 64, 160)])
def test_flash_kernel_matches_plain(card, sq, skv, d):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((16, s, d), generator=g, device=card, dtype=torch.bfloat16)
               for s in (sq, skv, skv))
    with torch.inference_mode():
        o, lse = tfa.flash_fwd(q, k, v, d ** -0.5)
        o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _max_err(o, o_ref) <= 2e-2
    assert _max_err(lse, lse_ref) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("q_tile", [64, 128])
@pytest.mark.parametrize("sq,skv,d", [(1000, 300, 40), (200, 77, 20), (130, 90, 100),
                                      (70, 77, 160), (150, 77, 18)])
def test_flash_kernel_tiles_match_plain(card, q_tile, sq, skv, d):
    """K1 at both q tiles (one and two warpgroups a CTA), ragged Sq and Skv,
    and at head dims that are not multiples of 8 (20, 100, 18: plain
    element loads instead of TMA)."""
    g = torch.Generator(device=card).manual_seed(10)
    q, k, v = (torch.randn((4, s, d), generator=g, device=card, dtype=torch.bfloat16)
               for s in (sq, skv, skv))
    with torch.inference_mode():
        o, lse = tfa._fwd_cuda(q, k, v, d ** -0.5, q_tile=q_tile)
        o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    assert bool(torch.isfinite(o).all())
    assert _max_err(o, o_ref) <= 2e-2
    assert _max_err(lse, lse_ref) <= 1e-3


@pytest.mark.cuda
def test_flash_kernel_fp32_ragged(card):
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn((3, s, 24), generator=g, device=card) for s in (70, 77, 77))
    with torch.inference_mode():
        o, lse = tfa.flash_fwd(q, k, v, 0.3)
        o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, 0.3)
    assert _max_err(o, o_ref) <= 1e-4 and _max_err(lse, lse_ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,counter,tol", [(torch.bfloat16, "launches", 2e-2),
                                               (torch.float32, "fp32_launches", 1e-4)])
def test_attention_launches_the_flash_kernel(card, dtype, counter, tol):
    """(B, S, H*D) in, one launch, the same result as plain_attention; bf16
    runs K1 and fp32 K1's fp32 kernel, each counted on its own counter."""
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((2, s, 8 * 40), generator=g, device=card, dtype=dtype)
               for s in (256, 77, 77))
    names = ("launches", "fp32_launches")
    before = {n: getattr(tfa, n) for n in names}
    with torch.inference_mode():
        out = tatt.attention(q, k, v, 8)
        ref = tatt.plain_attention(q, k, v, 8)
    assert {n: getattr(tfa, n) - before[n] for n in names} == {n: int(n == counter)
                                                              for n in names}
    assert out.shape == q.shape and _max_err(out, ref) <= tol


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _bwd_inputs(card, bh, sq, skv, d, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v, do = (torch.randn((bh, s, d), generator=g, device=card, dtype=dtype)
                   for s in (sq, skv, skv, sq))
    with torch.inference_mode():
        o, lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d", [(4096, 4096, 40), (1024, 77, 80), (64, 64, 160)])
def test_flash_bwd_kernel_matches_plain(card, sq, skv, d):
    q, k, v, o, lse, do = _bwd_inputs(card, 8, sq, skv, d, torch.bfloat16, 0)
    before = tfa.bwd_launches
    with torch.inference_mode():
        got = tfa.flash_bwd(q, k, v, o, lse, do, d ** -0.5)
        want = tfa.flash_backward_plain(q, k, v, o, lse, do, d ** -0.5)
    assert tfa.bwd_launches == before + 1
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert bool(torch.isfinite(a).all())
        assert _max_err(a, b) <= 2e-2 * float(b.float().abs().max())
        assert _rel_l2(a, b) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("splits,d", [(1, 40), (2, 40), (None, 40), (None, 20), (3, 80),
                                      (None, 160), (2, 18), (None, 30)])
def test_flash_bwd_kernel_q_splits(card, splits, d):
    """K3 with the q loop split over 1, 2, 3 or the planner's number of CTAs
    (None), ragged Sq and Skv < 64, against the plain version over the same
    split ranges; dQ, dK and dV of two runs are equal (the partials are
    summed in split order, dQ in KV-tile order).  d = 18 and 30 (not
    multiples of 8) take element loads."""
    bh, sq, skv = 4, 300, 50
    q, k, v, o, lse, do = _bwd_inputs(card, bh, sq, skv, d, torch.bfloat16, 3)
    n = splits or tfa.bwd_q_splits(bh, sq, skv, d)
    if splits is None:
        assert n > 3
    before = tfa.bwd_launches
    with torch.inference_mode():
        delta = tfa._delta(o, do)
        got = tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5, q_splits=splits)
        again = tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5, q_splits=splits)
        want = tfa.flash_backward_plain(q, k, v, o, lse, do, d ** -0.5, q_splits=n)
    assert tfa.bwd_launches == before + 2
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _max_err(a, b) <= 2e-2 * float(b.float().abs().max())
        assert _rel_l2(a, b) <= 1e-2
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [18, 30, 40, 80])
def test_flash_bwd_dq_repeats_across_runs_and_splits(card, d):
    """K3's dQ, dK and dV repeat bit for bit over 3 runs at each of q_splits
    1, 2 and the q-tile count n (one q tile a split), and dQ is the same
    bit for bit whatever the splits: it is summed over the KV tiles in their
    order, as JAX's loop over KV blocks sums it.  d = 18 and 30 take element
    loads; 40 the wgmma dQ product, 80 the mma.sync one."""
    bh, sq, skv = 4, 333, 300
    q, k, v, o, lse, do = _bwd_inputs(card, bh, sq, skv, d, torch.bfloat16, 21)
    n = -(-sq // tfa.bwd_q_rows(d))
    dqs = []
    with torch.inference_mode():
        delta = tfa._delta(o, do)
        want = tfa.flash_backward_plain(q, k, v, o, lse, do, d ** -0.5)
        for splits in (1, 2, n):
            runs = [tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5, q_splits=splits)
                    for _ in range(3)]
            for again in runs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
            dqs.append(runs[0][0])
    assert all(torch.equal(dqs[0], x) for x in dqs[1:])
    assert _max_err(dqs[0], want[0]) <= 2e-2 * float(want[0].float().abs().max())
    assert _rel_l2(dqs[0], want[0]) <= 1e-2


@pytest.mark.cuda
def test_flash_bwd_kernel_on_two_streams(card):
    """Split K3 launches in flight at the same time on two streams (each
    stream has its own arrival counters): dQ, dK and dV of every launch
    equal those of one launch on the current stream, bit for bit."""
    bh, sq, skv, d = 8, 4096, 77, 40
    q, k, v, o, lse, do = _bwd_inputs(card, bh, sq, skv, d, torch.bfloat16, 11)
    assert tfa.bwd_q_splits(bh, sq, skv, d) > 1
    main = torch.cuda.current_stream(card)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    got = []
    with torch.inference_mode():
        delta = tfa._delta(o, do)
        want = tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5)
        for s in streams:
            s.wait_stream(main)
        for _ in range(8):
            for s in streams:
                with torch.cuda.stream(s):
                    got.append(tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5))
        for s in streams:
            main.wait_stream(s)
        torch.cuda.synchronize(card)
    for dq, dk, dv in got:
        assert torch.equal(dq, want[0])
        assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])


@pytest.mark.cuda
def test_flash_bwd_kernel_fp32_ragged(card):
    q, k, v, o, lse, do = _bwd_inputs(card, 3, 70, 77, 24, torch.float32, 1)
    with torch.inference_mode():
        got = tfa.flash_bwd(q, k, v, o, lse, do, 0.3)
        want = tfa.flash_backward_plain(q, k, v, o, lse, do, 0.3)
    for a, b in zip(got, want):
        assert _rel_l2(a, b) <= 1e-4


@pytest.mark.cuda
def test_attention_backward_launches_the_bwd_kernel(card):
    """A backward through ops.attention runs K3 once per call, with the
    gradients of plain_attention's autograd."""
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((2, s, 8 * 40), generator=g, device=card, dtype=torch.bfloat16)
               .requires_grad_(True) for s in (256, 77, 77))
    dout = torch.randn((2, 256, 8 * 40), generator=g, device=card, dtype=torch.bfloat16)
    before = (tfa.launches, tfa.bwd_launches)
    got = torch.autograd.grad(tatt.attention(q, k, v, 8), (q, k, v), dout)
    assert (tfa.launches, tfa.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(tatt.plain_attention(q, k, v, 8), (q, k, v), dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_l2(a, b) <= 2e-2


# chip_smoke.py's fp32 gates: FLASH_F32_TOL (O and lse) and FLASH_BWD_F32_TOL
# (each of dQ, dK, dV: max |err| relative to the largest reference value,
# rel L2); both sides sum fp32 products in fp32, in another order
F32_FWD = {"max_abs": 1e-4, "rel_l2": 1e-5, "lse_abs": 1e-4}
F32_BWD = {"max_rel": 1e-4, "rel_l2": 1e-5}


def _counters():
    return {n: getattr(tfa, n) for n in ("launches", "packed_launches", "fp32_launches",
                                         "bwd_launches", "bwd_fp32_launches")}


def _moved(before):
    return {n: v - before[n] for n, v in _counters().items() if v != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d", [(333, 77, 40), (200, 129, 72), (130, 77, 80), (70, 90, 160),
                                      (1024, 1024, 40), (77, 200, 100)])
def test_flash_fp32_kernel_matches_plain(card, sq, skv, d):
    """K1's fp32 kernel (split products on the tensor cores) at ragged Sq and
    Skv (77 included) and head dims 40/72/80/100/160: O and lse within the
    fp32 gate, a second call equal bit for bit, one launch a call on its
    own counter."""
    g = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn((3, s, d), generator=g, device=card) for s in (sq, skv, skv))
    before = _counters()
    with torch.inference_mode():
        o, lse = tfa.flash_fwd(q, k, v, d ** -0.5)
        o2, lse2 = tfa.flash_fwd(q, k, v, d ** -0.5)
        o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    assert _moved(before) == {"fp32_launches": 2}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert _max_err(o, o_ref) <= F32_FWD["max_abs"] and _rel_l2(o, o_ref) <= F32_FWD["rel_l2"]
    assert _max_err(lse, lse_ref) <= F32_FWD["lse_abs"]


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("sq,skv,d", [(333, 77, 40), (130, 90, 80), (64, 64, 160)])
def test_packed_flash_fp32_equals_k1(card, pack, sq, skv, d):
    """K4 on fp32 inputs runs K1's fp32 kernel with the G heads in turn: O and
    lse equal G = 1's bit for bit, both on the fp32 counter."""
    g = torch.Generator(device=card).manual_seed(12)
    q, k, v = (torch.randn((8, s, d), generator=g, device=card) for s in (sq, skv, skv))
    before = _counters()
    with torch.inference_mode():
        o1, lse1 = tfa._fwd_cuda(q, k, v, d ** -0.5)
        o4, lse4 = tfa._fwd_cuda(q, k, v, d ** -0.5, pack)
    assert _moved(before) == {"fp32_launches": 2}
    assert torch.equal(o4, o1) and torch.equal(lse4, lse1)


@pytest.mark.cuda
@pytest.mark.parametrize("q_splits", [None, 1, 3])
@pytest.mark.parametrize("sq,skv,d", [(333, 77, 40), (200, 129, 72), (130, 77, 80), (70, 90, 160),
                                      (1024, 1024, 40)])
def test_flash_bwd_fp32_kernel_matches_plain(card, sq, skv, d, q_splits):
    """K3's fp32 pair at ragged Sq and Skv and head dims 40/72/80/160, at its
    q-split rule and at 1 and 3 splits: dQ, dK and dV within the fp32 gate,
    a second call equal bit for bit, one launch a call on its own counter,
    and dQ (summed over the kv tiles in their order) the same whatever the
    splits."""
    q, k, v, o, lse, do = _bwd_inputs(card, 2, sq, skv, d, torch.float32, 13)
    delta = tfa._delta(o, do)
    before = _counters()
    with torch.inference_mode():
        got = tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5, q_splits=q_splits)
        again = tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5, q_splits=q_splits)
        one = tfa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5, q_splits=1)
        want = tfa.flash_backward_plain(q, k, v, o, lse, do, d ** -0.5)
    assert _moved(before) == {"bwd_fp32_launches": 3}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], one[0])
    for a, b in zip(got, want):
        peak = float(b.abs().max())
        assert _max_err(a, b) <= F32_BWD["max_rel"] * peak and _rel_l2(a, b) <= F32_BWD["rel_l2"]


@pytest.mark.cuda
def test_attention_backward_fp32_runs_the_fp32_pair(card):
    """A backward through ops.attention in fp32 runs K1's and K3's fp32
    kernels once each, on their own counters, with plain_attention
    autograd's gradients."""
    g = torch.Generator(device=card).manual_seed(14)
    q, k, v = (torch.randn((2, s, 8 * 40), generator=g, device=card).requires_grad_(True)
               for s in (256, 77, 77))
    dout = torch.randn((2, 256, 8 * 40), generator=g, device=card)
    before = _counters()
    got = torch.autograd.grad(tatt.attention(q, k, v, 8), (q, k, v), dout)
    assert _moved(before) == {"fp32_launches": 1, "bwd_fp32_launches": 1}
    want = torch.autograd.grad(tatt.plain_attention(q, k, v, 8), (q, k, v), dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_l2(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,kdim,n", [(8192, 320, 320), (154, 768, 640), (512, 1280, 10240)])
def test_lora_kernel_matches_plain(card, m, kdim, n):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((m, kdim), generator=g, device=card).bfloat16()
    w = (torch.randn((n, kdim), generator=g, device=card) * kdim ** -0.5).bfloat16()
    b = (torch.randn((n,), generator=g, device=card) * 0.1).bfloat16()
    up = (torch.randn((n, 4), generator=g, device=card) * 0.1).bfloat16()
    down = (torch.randn((4, kdim), generator=g, device=card) / 4).bfloat16()
    with torch.inference_mode():
        y = tlm.lora_dense(x, w, b, up, down, 0.8)
        y_ref = tlm.lora_dense_plain(x, w, b, up, down, 0.8)
    assert y.dtype == torch.bfloat16 and _max_err(y, y_ref) <= 5e-2


def _lora_inputs(card, m, kdim, n, r, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((m, kdim), generator=g, device=card).bfloat16()
    w = (torch.randn((n, kdim), generator=g, device=card) * kdim ** -0.5).bfloat16()
    b = (torch.randn((n,), generator=g, device=card) * 0.1).bfloat16()
    up = (torch.randn((n, r), generator=g, device=card) * 0.1).bfloat16()
    down = (torch.randn((r, kdim), generator=g, device=card) / r).bfloat16()
    return x, w, b, up, down


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(64, 64, 1), (64, 64, 2), (64, 128, 3), (128, 128, 12),
                                  None])
@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("m", [77, 154])
def test_lora_kernel_forced_grids(card, grid, r, m):
    """K2 at each tile and at 1, 2, 3 and 12 splits of its 12 k-steps (K =
    768, the text rows' projection) and at the plan's choice (None), ranks
    1, 4 and 16, the text rows M = 77 and 154, N = 200 (no multiple of
    either tile): within the plain version's tolerance, and a second run
    equal bit for bit (the split partials are summed in split order)."""
    x, w, b, up, down = _lora_inputs(card, m, 768, 200, r, 20 + r)
    before = tlm.launches
    with torch.inference_mode():
        y = tlm._lora_dense_cuda(x, w, b, up, down, 0.8, grid=grid)
        again = tlm._lora_dense_cuda(x, w, b, up, down, 0.8, grid=grid)
        y_ref = tlm.lora_dense_plain(x, w, b, up, down, 0.8)
    assert tlm.launches == before + 2
    assert bool(torch.isfinite(y).all()) and _max_err(y, y_ref) <= 5e-2
    assert _rel_l2(y, y_ref) <= 1e-2
    assert torch.equal(y, again)


@pytest.mark.cuda
def test_lora_kernel_on_two_streams(card):
    """Split K2 launches in flight at the same time on two streams (each
    stream has its own arrival counters) equal one launch bit for bit."""
    x, w, b, up, down = _lora_inputs(card, 128, 1280, 1280, 4, 30)
    assert tlm.plan(128, 1280, 1280)[2] > 1
    main = torch.cuda.current_stream(card)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    got = []
    with torch.inference_mode():
        want = tlm.lora_dense(x, w, b, up, down, 0.8)
        for s in streams:
            s.wait_stream(main)
        for _ in range(8):
            for s in streams:
                with torch.cuda.stream(s):
                    got.append(tlm.lora_dense(x, w, b, up, down, 0.8))
        for s in streams:
            main.wait_stream(s)
        torch.cuda.synchronize(card)
    assert all(torch.equal(y, want) for y in got)


@pytest.mark.cuda
def test_lora_kernel_fp32_ragged(card):
    g = torch.Generator(device=card).manual_seed(3)
    x, w, b, up, down = (torch.randn(s, generator=g, device=card) * 0.3
                         for s in ((100, 72), (90, 72), (90,), (90, 3), (3, 72)))
    with torch.inference_mode():
        y = tlm.lora_dense(x, w, b, up, down, 0.5)
        y_ref = tlm.lora_dense_plain(x, w, b, up, down, 0.5)
    assert _max_err(y, y_ref) <= 1e-4


@pytest.mark.cuda
def test_lora_linear_launches_the_lora_kernel(card):
    """A LoRALinear with a LoRA set runs the kernel on (B, S, K) inputs;
    without one it is a plain linear and launches nothing."""
    torch.manual_seed(4)
    layer = LoRALinear(320, 640).to(card, torch.bfloat16)
    x = torch.randn((2, 77, 320), device=card, dtype=torch.bfloat16)
    up, down = torch.randn((640, 4)) * 0.1, torch.randn((4, 320)) / 4
    layer.set_lora(up, down, 0.7)
    before = tlm.launches
    with torch.inference_mode():
        y = layer(x)
        ref = tlm.lora_dense_plain(x.reshape(-1, 320), layer.weight, layer.bias,
                                   layer.lora_up, layer.lora_down, 0.7)
        layer.clear_lora()
        base = layer(x)
    assert tlm.launches == before + 1
    assert y.shape == (2, 77, 640) and _max_err(y.reshape(-1, 640), ref) <= 5e-2
    assert _max_err(y, base) > 0.1  # the LoRA term is on the path


@pytest.mark.cuda
def test_lora_dense_gradients_match_plain(card):
    """Gradients through the kernel's autograd function against autograd of
    the plain version, bf16 on the card; no dW for a frozen weight."""
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((2048, 640), generator=g, device=card).bfloat16().requires_grad_(True)
    w = (torch.randn((640, 640), generator=g, device=card) * 640 ** -0.5).bfloat16()
    b = (torch.randn((640,), generator=g, device=card) * 0.1).bfloat16()
    up = (torch.randn((640, 4), generator=g, device=card) * 0.1).requires_grad_(True)
    down = (torch.randn((4, 640), generator=g, device=card) / 4).requires_grad_(True)
    dy = torch.randn((2048, 640), generator=g, device=card).bfloat16()
    before = tlm.launches
    y = tlm.lora_dense(x, w, b, up.bfloat16(), down.bfloat16(), 0.8)
    assert tlm.launches == before + 1
    got = torch.autograd.grad(y, (x, up, down), dy)
    want = torch.autograd.grad(
        tlm.lora_dense_plain(x, w, b, up.bfloat16(), down.bfloat16(), 0.8), (x, up, down), dy)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and _rel_l2(a, b_) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("dtype,sq,skv,d", [(torch.bfloat16, 1024, 77, 80),
                                            (torch.bfloat16, 256, 256, 160),
                                            (torch.float32, 70, 77, 24)])
def test_packed_flash_kernel_equals_k1(card, pack, dtype, sq, skv, d):
    g = torch.Generator(device=card).manual_seed(6)
    q, k, v = (torch.randn((8, s, d), generator=g, device=card, dtype=dtype)
               for s in (sq, skv, skv))
    before = (tfa.launches, tfa.packed_launches, tfa.fp32_launches)
    with torch.inference_mode():
        o1, lse1 = tfa._fwd_cuda(q, k, v, d ** -0.5)
        o4, lse4 = tfa._fwd_cuda(q, k, v, d ** -0.5, pack)
    # bf16: one K1 and one K4 launch; fp32: both run K1's fp32 kernel, counted apart
    want = (1, 1, 0) if dtype == torch.bfloat16 else (0, 0, 2)
    assert tuple(n - b for n, b in zip(
        (tfa.launches, tfa.packed_launches, tfa.fp32_launches), before)) == want
    assert torch.equal(o4, o1) and torch.equal(lse4, lse1)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("q_tile", [64, 128])
@pytest.mark.parametrize("sq,skv,d", [(1024, 1024, 80), (4096, 77, 40), (300, 200, 100),
                                      (200, 77, 20), (64, 64, 160)])
def test_packed_flash_kernel_tiles_equal_k1(card, pack, q_tile, sq, skv, d):
    """K4 at both q tiles of its rule (64 and 128 rows a CTA: one or two
    warpgroups a head), at head dims that are and are not multiples of 8
    (20 and 100 take element loads and named barriers), equals K1 at its
    own tile bit for bit: every row runs K1's arithmetic."""
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn((8, s, d), generator=g, device=card, dtype=torch.bfloat16)
               for s in (sq, skv, skv))
    with torch.inference_mode():
        o1, lse1 = tfa._fwd_cuda(q, k, v, d ** -0.5)
        o4, lse4 = tfa._fwd_cuda(q, k, v, d ** -0.5, pack, q_tile=q_tile)
    assert torch.equal(o4, o1) and torch.equal(lse4, lse1)


@pytest.mark.cuda
def test_packed_flash_kernel_on_two_streams(card):
    """K4 launches in flight on two streams at once, at G = 2 and 4: every
    output equals K1's on the current stream bit for bit."""
    g = torch.Generator(device=card).manual_seed(8)
    q, k, v = (torch.randn((16, s, 40), generator=g, device=card, dtype=torch.bfloat16)
               for s in (1024, 1024, 1024))
    main = torch.cuda.current_stream(card)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    got = []
    with torch.inference_mode():
        want = tfa._fwd_cuda(q, k, v, 40 ** -0.5)
        for s in streams:
            s.wait_stream(main)
        for i in range(8):
            for pack, s in zip((2, 4), streams):
                with torch.cuda.stream(s):
                    got.append(tfa._fwd_cuda(q, k, v, 40 ** -0.5, pack))
        for s in streams:
            main.wait_stream(s)
        torch.cuda.synchronize(card)
    for o, lse in got:
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,o", [(2, 320, 64, 320), (1, 960, 32, 640),
                                     (2, 1280, 8, 1280), (1, 64, 16, 72)])
def test_conv3x3_kernel_matches_plain(card, b, c, h, o):
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((b, c, h, h), generator=g, device=card).bfloat16()
    w = (torch.randn((o, c, 3, 3), generator=g, device=card) / (3 * c ** 0.5)).bfloat16()
    bias = (torch.randn((o,), generator=g, device=card) * 0.1).bfloat16()
    before = tconv.launches
    with torch.inference_mode():
        y = tconv.conv3x3(x, w, bias)
        y_ref = tconv.conv3x3_plain(x, w, bias)
    assert tconv.launches == before + 1
    assert y.shape == (b, o, h, h) and y.dtype == torch.bfloat16
    assert _max_err(y, y_ref) <= 2 ** -7 * float(y_ref.float().abs().max())
    assert _rel_l2(y, y_ref) <= 1e-2


def _conv_inputs(card, b, c, h, w, o, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g, device=card).bfloat16()
    wt = (torch.randn((o, c, 3, 3), generator=g, device=card) / (3 * c ** 0.5)).bfloat16()
    bias = (torch.randn((o,), generator=g, device=card) * 0.1).bfloat16()
    return x, wt, bias


def _conv_close(y, y_ref):
    assert bool(torch.isfinite(y).all())
    assert _max_err(y, y_ref) <= 2 ** -7 * float(y_ref.float().abs().max())
    assert _rel_l2(y, y_ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,o,splits", [
    (2, 64, 8, 8, 96, 1), (2, 64, 8, 8, 96, 9), (1, 128, 16, 16, 64, 3),
    (2, 64, 32, 32, 136, 2), (1, 64, 64, 64, 64, 1), (1, 72, 9, 24, 64, 5),
    (1, 64, 10, 96, 64, 2), (1, 64, 5, 128, 64, 1), (1, 128, 8, 8, 64, 7),
    (2, 64, 16, 16, 72, 4), (1, 64, 32, 32, 64, 6), (1, 64, 64, 64, 64, 3)])
def test_conv3x3_kernel_forced_grids(card, b, c, h, w, o, splits):
    """K5's Hopper route at every pixel layout (W = 8 and 16: 16-pixel
    boxes, W = 24 and 32: 32-pixel boxes, W = 64: 128-byte boxes, W = 96 and
    128: two boxes a row), forced splits (up to every one of the 9 k-steps,
    and splits that end a run inside each of the three column-shift
    phases), ragged H, C (72: the last 64-channel step half past C) and O:
    within one bf16 ulp of the largest value of the plain version, and a
    second run equal bit for bit."""
    x, wt, bias = _conv_inputs(card, b, c, h, w, o, 40 + w)
    p = tconv.plan(b, c, h, w, o, splits=splits)
    before = tconv.launches
    with torch.inference_mode():
        y = tconv._conv3x3_cuda(x, wt, bias, grid=p)
        again = tconv._conv3x3_cuda(x, wt, bias, grid=p)
        y_ref = tconv.conv3x3_plain(x, wt, bias)
    assert tconv.launches == before + 2
    assert y.shape == (b, o, h, w)
    _conv_close(y, y_ref)
    assert torch.equal(y, again)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [12, 136])
def test_conv3x3_kernel_element_route(card, w):
    """bf16 shapes whose rows TMA cannot take (W = 12 is not a multiple of
    8; W = 136 is past two 64-pixel boxes) run the element-load kernel,
    chosen by shape."""
    assert tconv.plan(1, 64, 9, w, 80) is None
    x, wt, bias = _conv_inputs(card, 1, 64, 9, w, 80, 50)
    before = tconv.launches
    with torch.inference_mode():
        y = tconv.conv3x3(x, wt, bias)
        y_ref = tconv.conv3x3_plain(x, wt, bias)
    assert tconv.launches == before + 1
    _conv_close(y, y_ref)


@pytest.mark.cuda
def test_conv3x3_kernel_on_two_streams(card):
    """Split K5 launches in flight at the same time on two streams equal
    one launch bit for bit."""
    x, wt, _ = _conv_inputs(card, 2, 1280, 8, 8, 1280, 60)
    assert tconv.plan(2, 1280, 8, 8, 1280).splits > 1
    main = torch.cuda.current_stream(card)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    got = []
    with torch.inference_mode():
        want = tconv.conv3x3(x, wt)
        for s in streams:
            s.wait_stream(main)
        for _ in range(4):
            for s in streams:
                with torch.cuda.stream(s):
                    got.append(tconv.conv3x3(x, wt))
        for s in streams:
            main.wait_stream(s)
        torch.cuda.synchronize(card)
    assert all(torch.equal(y, want) for y in got)


@pytest.mark.cuda
def test_conv3x3_kernel_fp32_ragged(card):
    g = torch.Generator(device=card).manual_seed(8)
    x = torch.randn((2, 24, 9, 11), generator=g, device=card)
    w = torch.randn((70, 24, 3, 3), generator=g, device=card) * 0.1
    with torch.inference_mode():
        y = tconv.conv3x3(x, w, None)
        y_ref = tconv.conv3x3_plain(x, w, None)
    assert _rel_l2(y, y_ref) <= 1e-5


@pytest.mark.cuda
def test_conv3x3_gradients_match_conv2d(card, monkeypatch):
    """A routed LoRAConv2d (switch on) runs K5 once in the forward; its
    gradients are F.conv2d autograd's; the frozen weight gets none."""
    monkeypatch.setattr(tlayers, "CONV_KERNEL", True)
    torch.manual_seed(9)
    layer = LoRAConv2d(320, 640, 3, padding=1).to(card, torch.bfloat16)
    layer.weight.requires_grad_(False)
    layer.set_lora(torch.randn((640, 4, 1, 1)) * 0.1, torch.randn((4, 320, 3, 3)) * 0.05, 0.5)
    x = torch.randn((2, 320, 32, 32), device=card, dtype=torch.bfloat16).requires_grad_(True)
    dy = torch.randn((2, 640, 32, 32), device=card, dtype=torch.bfloat16)
    before = tconv.launches
    y = layer(x)
    assert tconv.launches == before + 1  # the LoRA down/up convs are not routed
    (gx,) = torch.autograd.grad(y, (x,), dy)
    assert layer.weight.grad is None
    ref = (F.conv2d(x, layer.weight, layer.bias, padding=1)
           + 0.5 * F.conv2d(F.conv2d(x, layer.lora_down, padding=1), layer.lora_up))
    (gx_ref,) = torch.autograd.grad(ref, (x,), dy)
    assert _rel_l2(y, ref) <= 1e-2 and _rel_l2(gx, gx_ref) <= 1e-2
    w = layer.weight.detach().clone().requires_grad_(True)
    b = layer.bias.detach().clone().requires_grad_(True)
    got = torch.autograd.grad(tconv.conv3x3(x, w, b), (x, w, b), dy)
    want = torch.autograd.grad(F.conv2d(x, w, b, padding=1), (x, w, b), dy)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and _rel_l2(a, b_) <= 1e-2


# ---------------------------------------------------------------------------
# CUDA graphs (graph.py): replays equal to the eager runs, bit for bit
# ---------------------------------------------------------------------------

SMALL_UNET = dict(sample_size=16, block_out_channels=(64, 128), layers_per_block=1,
                  cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))


def _small_lora(ucfg, seed, device="cpu", replace=None):
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.models.unet import unet_all_lora_targets

    g = torch.Generator().manual_seed(seed)
    targets = lora_lib.filter_targets(unet_all_lora_targets(ucfg),
                                      replace or lora_lib.DEFAULT_TARGET_REPLACE)
    tree = lora_lib.inject_trainable_lora(targets, g, r=4, dtype=torch.bfloat16)
    for _, leaf in lora_lib.lora_leaves(tree):
        leaf["up"] = (torch.randn(leaf["up"].shape, generator=g) * 0.05).bfloat16()
    return _tree_to(tree, device)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def small_pipe():
    """A bf16 pipeline on the card with random weights: a UNet of 64 and 128
    channels (its resnet convs route to K5 with the switch on), the tiny VAE
    and CLIP; images of 32^2 (16^2 latents)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = (UNetConfig(**SMALL_UNET), VAEConfig.tiny(), CLIPTextConfig.tiny())
    sds = []
    for i, (cls, cfg) in enumerate(zip((UNet2DConditionModel, AutoencoderKL, CLIPTextModel),
                                       cfgs)):
        torch.manual_seed(i)
        sds.append(cls(cfg).state_dict())
    return StableDiffusionPipeline(cfgs[0], sds[0], cfgs[1], sds[1], cfgs[2], sds[2],
                                   CLIPTokenizer.tiny(["photo", "sks"]), dtype=torch.bfloat16,
                                   device="cuda")


@pytest.fixture(params=[False, True], ids=["switches_off", "switches_on"])
def switches(request, monkeypatch):
    """The opt-in kernels off, or on: K5 for the routed resnet convs and K4
    (two heads a CTA) for the flash forwards."""
    monkeypatch.setattr(tlayers, "CONV_KERNEL", request.param)
    monkeypatch.setattr(tfa, "DEFAULT_HEAD_PACK", 2 if request.param else 1)
    return request.param


def _eager(pipe, call):
    pipe.cuda_graphs = False
    try:
        return call()
    finally:
        pipe.cuda_graphs = True


@pytest.mark.cuda
def test_unet_step_replay_equals_eager(small_pipe, switches):
    """One dynamic-LoRA UNet step captured with graph.Graphs: its replay
    equals the eager step bit for bit, and its capture launched the port's
    kernels (K1 or K4, K2, and with the switches K5)."""
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.graph import Graphs

    pipe = small_pipe
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 4, 16, 16), generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, 77, 32), generator=g, device="cuda").bfloat16()
    t = torch.tensor([500, 20], device="cuda")
    lora = _small_lora(pipe.unet_config, 3, "cuda")
    graphs = Graphs(pipe.device)
    with torch.inference_mode(), lora_lib.attached(pipe.unet, lora):
        want = pipe.unet(x, t, ctx)
        before = (tlm.launches, tconv.launches, tfa.launches + tfa.packed_launches)
        entry = graphs.capture("unet step", lambda: pipe.unet(x, t, ctx))
        launched = (tlm.launches - before[0], tconv.launches - before[1],
                    tfa.launches + tfa.packed_launches - before[2])
        got = entry.replay().clone()
        again = entry.replay().clone()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert launched[0] > 0 and launched[2] > 0 and (launched[1] > 0) == switches


@pytest.mark.cuda
@pytest.mark.parametrize("materialize", [False, True], ids=["dynamic", "merged"])
def test_txt2img_graph_equals_eager(small_pipe, switches, materialize):
    """txt2img (4 DDIM steps, batches 1 and 2) through its CUDA graph:
    captured by the first request of a key, replayed by the next ones, every
    image equal to the eager request's bit for bit."""
    pipe = small_pipe
    pipe.unet_lora, pipe.materialize_lora = _small_lora(pipe.unet_config, 4, "cuda"), materialize
    pipe.invalidate_merged_cache()
    pipe._graphs = None  # a fresh set of graphs: the counts below are this test's
    kw = dict(height=32, width=32, num_inference_steps=4, output_type="device")
    for prompt, seed in (("photo of sks", 1), (["photo", "sks photo"], [2, 3]),
                         ("photo of sks", 5)):
        got = pipe(prompt, seed=seed, **kw)
        want = _eager(pipe, lambda: pipe(prompt, seed=seed, **kw))
        assert got.dtype == torch.uint8 and torch.equal(got, want)
    graphs = pipe._graphs.graphs
    assert len(graphs) == 2 and sorted(e.replays for e in graphs.values()) == [1, 2]


@pytest.mark.cuda
def test_img2img_graph_equals_eager(small_pipe, switches):
    """img2img (10 steps at strength 0.6, batch 2, dynamic LoRA) through its
    graph, twice, against the eager request."""
    import numpy as np

    pipe = small_pipe
    pipe.unet_lora, pipe.materialize_lora = _small_lora(pipe.unet_config, 5, "cuda"), False
    pipe.invalidate_merged_cache()
    pipe._graphs = None  # a fresh set of graphs: the counts below are this test's
    image = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    for seed in (1, 2):
        kw = dict(strength=0.6, num_inference_steps=10, seed=seed, output_type="device")
        got = pipe.img2img(["photo", "photo of sks"], image, **kw)
        want = _eager(pipe, lambda: pipe.img2img(["photo", "photo of sks"], image, **kw))
        assert torch.equal(got, want)
    assert [e.replays for e in pipe._graphs.graphs.values()] == [2]


@pytest.mark.cuda
def test_pipeline_graph_cache_keys(small_pipe):
    """A new guidance scale replays the same graph (and changes the image);
    so do a swapped LoRA tree (its merged weights copied into the graph's
    buffers) and, after an in-place edit, invalidate_merged_cache (the next
    replay copies afresh); every image equals the eager one (no stale
    weights).  Dynamic: the same, another graph."""
    from diffusion_finetuning_tpu_torch import lora as lora_lib

    pipe = small_pipe
    pipe.materialize_lora = True
    pipe.unet_lora = _small_lora(pipe.unet_config, 6, "cuda")
    pipe.invalidate_merged_cache()
    pipe._graphs = None
    kw = dict(height=32, width=32, num_inference_steps=3, seed=0, output_type="device")
    a = pipe("photo", guidance_scale=7.5, **kw)
    b = pipe("photo", guidance_scale=3.0, **kw)
    graphs = pipe._graphs.graphs
    assert len(graphs) == 1 and not torch.equal(a, b)
    assert torch.equal(b, _eager(pipe, lambda: pipe("photo", guidance_scale=3.0, **kw)))
    pipe.unet_lora = _small_lora(pipe.unet_config, 7, "cuda")
    c = pipe("photo", guidance_scale=3.0, **kw)
    assert len(graphs) == 1 and not torch.equal(b, c)
    assert torch.equal(c, _eager(pipe, lambda: pipe("photo", guidance_scale=3.0, **kw)))
    with torch.no_grad():  # an in-place edit, then the invalidation it needs
        for _, leaf in lora_lib.lora_leaves(pipe.unet_lora):
            leaf["up"].mul_(2)
    pipe.invalidate_merged_cache()
    d = pipe("photo", guidance_scale=3.0, **kw)
    assert len(graphs) == 1 and not torch.equal(c, d)
    assert torch.equal(d, _eager(pipe, lambda: pipe("photo", guidance_scale=3.0, **kw)))
    assert [e.replays for e in graphs.values()] == [4]
    pipe.materialize_lora = False
    e = pipe("photo", guidance_scale=3.0, **kw)
    assert len(graphs) == 2
    assert torch.equal(e, _eager(pipe, lambda: pipe("photo", guidance_scale=3.0, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("materialize,conv", [(True, False), (False, False), (True, True)],
                         ids=["merged", "dynamic", "merged_conv_switched"])
def test_lora_swaps_and_retunes_replay_one_graph(small_pipe, monkeypatch, materialize, conv):
    """Three trees installed in turn, then tune_lora_scale_pipe twice, at
    one request key: one graph captured, each image equal to the eager one
    for its tree, and the memory allocated after each swap's request does
    not grow by a merged set (the graphs hold their buffers only).  Nor does
    a later swap hold two sets: its peak, from the swap through its request,
    stays within half a set of the memory allocated before it plus what a
    merge needs beside its result (the superseded set is freed before the
    next is built; measured here as one merge alone, since at 32^2 the
    capture holds less than that workspace).  With a
    LoRA on the resnet convs too and K5 switched on, the graph reads the
    merged conv weights' tap-major copies, rewritten with each refill."""
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import tune_lora_scale_pipe

    pipe = small_pipe
    pipe.materialize_lora = materialize
    monkeypatch.setattr(tlayers, "CONV_KERNEL", conv)
    replace = lora_lib.UNET_EXTENDED_TARGET_REPLACE if conv else None
    pipe.invalidate_merged_cache()
    pipe._graphs = None
    kw = dict(height=32, width=32, num_inference_steps=3, seed=1, output_type="device")
    trees = [_small_lora(pipe.unet_config, s, "cuda", replace) for s in (11, 12, 13)]
    swaps = [lambda t=t: setattr(pipe, "unet_lora", t) for t in trees]
    swaps += [lambda a=a: tune_lora_scale_pipe(pipe, a) for a in (0.5, 2.0)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        lora_lib.materialize_lora_tree(pipe.unet, trees[0])
    merge_peak = torch.cuda.max_memory_allocated() - base  # the set and its workspace
    allocated, before, peaks, images = [], [], [], []
    for swap in swaps:
        torch.cuda.synchronize()
        before.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        swap()
        got = pipe("photo of sks", **kw)
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
        peaks.append(torch.cuda.max_memory_allocated())
        assert torch.equal(got, _eager(pipe, lambda: pipe("photo of sks", **kw)))
        images.append(got)
    assert len(pipe._graphs.graphs) == 1
    assert all(not torch.equal(x, y) for x, y in zip(images, images[1:]))
    merged = sum(w.numel() * w.element_size() for w in pipe._generation_params()[0].values())
    lora = sum(t.numel() * t.element_size() for t in _leaves_of(pipe.unet_lora))
    step = merged if materialize else lora
    assert max(allocated[1:]) - allocated[1] < step // 2, (allocated, step)
    workspace = max(merge_peak - step, 0) if materialize else 0
    held = [p - b for p, b in zip(peaks[1:], before[1:])]
    assert max(held) < workspace + step // 2, (held, workspace, step)


def _leaves_of(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves_of(v)
        else:
            yield v


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["pndm", "dpm", "euler", "euler_a", "lms",
                                       "euler_a:karras"])
def test_graphed_request_per_scheduler_equals_eager(small_pipe, scheduler):
    """A txt2img request (5 steps, batch 2, dynamic LoRA) with each of the
    new samplers through its graph, twice (seeds, and so Euler-ancestral's
    noise, change between them), equal to the eager request bit for bit."""
    pipe = small_pipe
    pipe.unet_lora, pipe.materialize_lora = _small_lora(pipe.unet_config, 14, "cuda"), False
    pipe.invalidate_merged_cache()
    pipe._graphs = None
    for seed in ([1, 2], [3, 4]):
        kw = dict(height=32, width=32, num_inference_steps=5, seed=seed, scheduler=scheduler,
                  output_type="device")
        got = pipe(["photo", "photo of sks"], **kw)
        want = _eager(pipe, lambda: pipe(["photo", "photo of sks"], **kw))
        assert torch.equal(got, want)
    assert [e.replays for e in pipe._graphs.graphs.values()] == [2]


@pytest.mark.cuda
def test_register_adapter_while_the_server_captures(small_pipe, tmp_path):
    """Adapters registered from a file by client threads while the server's
    worker captures its first graphs: nothing fails, and every image equals
    its adapter's lone request on the pipe (same seed, batch 1)."""
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.serving import GenerationServer

    pipe = small_pipe
    pipe.unet_lora, pipe.materialize_lora = None, True
    pipe.invalidate_merged_cache()
    pipe._graphs = None
    targets = pipe.lora_targets("unet", lora_lib.DEFAULT_TARGET_REPLACE)
    paths = []
    for s in range(3):
        paths.append(str(tmp_path / f"a{s}.safetensors"))
        lora_lib.save_all(_small_lora(pipe.unet_config, 20 + s), None, targets, [], None,
                          paths[-1])
    server = GenerationServer(pipe, max_batch=2, max_wait_ms=5)
    kw = dict(height=32, width=32, steps=4, scheduler="dpm")
    futs = [server.submit("photo", seed=s, **kw) for s in range(2)]
    errors = []

    def register(i):
        try:
            server.register_adapter(f"a{i}", paths[i], materialize=bool(i % 2))
        except Exception as e:  # recorded, then asserted on below
            errors.append(e)

    threads = [threading.Thread(target=register, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    futs += [server.submit("photo", seed=5, adapter=f"a{i}", **kw) for i in range(3)]
    images = [np.asarray(f.result(timeout=300)) for f in futs]
    server.close()
    for i, img in enumerate(images[2:]):
        ap = server._adapters[f"a{i}"]
        want = pipe("photo", seed=5, height=32, width=32, num_inference_steps=4,
                    scheduler="dpm", output_type="uint8",
                    adapter_params=pipe.adapter_generation_params(
                        ap["unet_lora"], materialize=ap["materialize"]))[0]
        np.testing.assert_array_equal(img, want)
    assert not np.array_equal(images[2], images[3])


@pytest.mark.cuda
def test_bf16_safetensors_read_straight_to_the_card(card, tmp_path):
    from diffusion_finetuning_tpu_torch.io import safetensors_io

    w = torch.randn((64, 32), device=card).bfloat16()
    safetensors_io.write_safetensors({"w": w, "b": w[0].float()}, str(tmp_path / "x.st"))
    got, _ = safetensors_io.read_safetensors(str(tmp_path / "x.st"), device=card)
    assert got["w"].device.type == "cuda" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], w) and torch.equal(got["b"], w[0].float())


def _train_setup(pipe, ti=False, accum=1, use_8bit=False):
    """(step function, maker of equal fresh train states, batches) on the
    small pipeline's modules; with ``ti`` the token embedding trains
    (constrained, rows 5-7), else a UNet LoRA."""
    import numpy as np

    from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler
    from diffusion_finetuning_tpu_torch.training import optim, train_step as ts

    name = "ti_embeddings" if ti else "unet_lora"
    opt = optim.multi_group_optimizer({name: optim.ParamGroup(lr=1e-3, schedule="cosine",
                                                              warmup_steps=2)},
                                      grad_accum_steps=accum, max_grad_norm=0.5,
                                      use_8bit=use_8bit)
    step = ts.build_train_step(
        unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae, scheduler=DDPMScheduler(),
        optimizer=opt, partition=ts.TrainablePartition(unet_lora=not ti, ti=ti),
        ti_lr_schedule=optim.lr_schedule("constant", 5e-3) if ti else None,
        grad_accum_steps=accum)
    emb = pipe.text_encoder.text_model.embeddings.token_embedding.weight.detach().float()
    rows = torch.zeros(emb.shape[0], dtype=torch.bool)
    rows[5:8] = True

    def state():
        if ti:
            return ts.init_train_state(opt, ti_embeddings=emb, index_updates=rows)
        return ts.init_train_state(opt, unet_lora=_small_lora(pipe.unet_config, 8))

    rng = np.random.default_rng(0)
    batches = [{"pixel_values": rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
                "input_ids": rng.integers(0, 300, (1, 77)).astype(np.int32)}
               for _ in range(6)]
    for b in batches:
        b["input_ids"][0, :3] = [5, 6, 7]
    return step, state, batches


def _assert_states_equal(a, b):
    from diffusion_finetuning_tpu_torch.training.train_step import carried_tensors

    assert a["step"] == b["step"]
    for x, y in zip(carried_tensors(a), carried_tensors(b)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("spd", [1, 3])
@pytest.mark.parametrize("case", ["unet_lora", "ti_accum2", "unet_lora_8bit"])
def test_train_step_graphs_equal_eager(small_pipe, switches, spd, case):
    """6 steps through jit_train_step (spd 1) or two multi_step(3) graphs
    against 6 eager steps from an equal state with equal generators: the
    losses, the parameters, the moments and the counts bit for bit."""
    from diffusion_finetuning_tpu_torch.training import train_step as ts

    step, state, batches = _train_setup(small_pipe, ti=case.startswith("ti"),
                                        accum=2 if "accum2" in case else 1,
                                        use_8bit=case.endswith("8bit"))
    eager, graphed = state(), state()
    ge, gg = (torch.Generator(device="cuda").manual_seed(9) for _ in range(2))
    want = [step(eager, b, ge)[1]["loss"] for b in batches]
    if spd == 1:
        fn = ts.jit_train_step(step)
        got = [fn(graphed, b, gg)[1]["loss"] for b in batches]
    else:
        fn = ts.multi_step(step, spd)
        got = [loss for i in range(0, 6, spd) for loss in
               fn(graphed, ts.stack_batches(batches[i:i + spd]), gg)[1]["loss"]]
    assert torch.equal(torch.stack(got), torch.stack(want))
    _assert_states_equal(graphed, eager)
    assert graphed["step"] == 6 and int(graphed["device_step"]) == 6


@pytest.mark.cuda
def test_fused_dispatcher_on_the_card_equals_eager(small_pipe):
    """FusedDispatcher(spd=2).drive over 5 steps (groups 2, 2 staged by
    prepare, then a one-off tail of 1) against 5 eager steps."""
    from diffusion_finetuning_tpu_torch.training import train_step as ts

    step, state, batches = _train_setup(small_pipe)
    eager, graphed = state(), state()
    ge, gg = (torch.Generator(device="cuda").manual_seed(4) for _ in range(2))
    want = torch.stack([step(eager, b, ge)[1]["loss"] for b in batches[:5]])
    disp = ts.FusedDispatcher(step, spd=2)
    got = [losses for _, losses, _, _ in disp.drive(
        graphed, gg, lambda gs: batches[gs:min(gs + 2, 5)], 5)]
    assert torch.equal(torch.cat(got), want)
    _assert_states_equal(graphed, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("use_8bit", [False, True], ids=["fp32", "8bit"])
def test_optimizer_step_replay_equals_eager(card, use_8bit):
    """The optimiser step alone (clip, accumulation 2, a gated group and a
    runtime LR scale), captured once and replayed for 4 steps, against 4
    eager steps on equal parameters and gradients."""
    from diffusion_finetuning_tpu_torch.graph import Graphs
    from diffusion_finetuning_tpu_torch.training import optim

    groups = {"a": optim.ParamGroup(lr=1e-2, schedule="linear", warmup_steps=1, total_steps=8),
              "b": optim.ParamGroup(lr=5e-3, lr_gate=optim.StepGate(1))}
    opt = optim.multi_group_optimizer(groups, grad_accum_steps=2, max_grad_norm=1.0,
                                      use_8bit=use_8bit, runtime_lr_scale=True)
    g = torch.Generator(device=card).manual_seed(2)

    def make():
        gg = torch.Generator(device=card).manual_seed(1)
        params = {"a": {"x": torch.randn((300, 7), generator=gg, device=card)},
                  "b": torch.randn((5, 3), generator=gg, device=card)}
        for t in optim.trainable_tensors(params):
            t.requires_grad_(True)
            t.grad = torch.zeros_like(t)
        return params, opt.init(params)

    (pe, se), (pg, sg) = make(), make()
    optim.set_lr_scale(se, "a", 0.5)
    optim.set_lr_scale(sg, "a", 0.5)
    grads = [[torch.randn(t.shape, generator=g, device=card) for t in optim.trainable_tensors(pe)]
             for _ in range(4)]
    graphs, entry = Graphs(card), None
    for gs in grads:
        for t, gr in zip(optim.trainable_tensors(pe), gs):
            t.grad.copy_(gr)
        opt.step(se)
        for t, gr in zip(optim.trainable_tensors(pg), gs):
            t.grad.copy_(gr)
        if entry is None:
            snap = [t.detach().clone() for t in sg.params() + sg.tensors()]

            def restore():
                opt.step(sg)
                torch._foreach_copy_(sg.params() + sg.tensors(), snap)

            with torch.no_grad():
                entry = graphs.capture("opt", lambda: opt.step(sg), restore)
        entry.replay()
    for x, y in zip(se.params() + se.tensors(), sg.params() + sg.tensors()):
        assert torch.equal(x, y)
    assert int(sg.count) == 2


@pytest.mark.cuda
def test_capture_allocates_no_counters_or_tap_major_copies(card):
    """Inside a capture a new arrival-counter buffer or a tap-major weight
    copy is refused (the warm-up makes them); with a warm-up the same calls
    capture."""
    from diffusion_finetuning_tpu_torch.graph import GraphError, Graphs
    from diffusion_finetuning_tpu_torch.ops import _grid

    graphs = Graphs(card)
    stream = graphs.stream.cuda_stream
    with pytest.raises(GraphError, match="arrival counters"):
        graphs.capture("counters", lambda: _grid.arrival_counters(card, stream, 64),
                       warmup=lambda: None)
    graphs.capture("counters, warmed", lambda: _grid.arrival_counters(card, stream, 64))
    w = torch.randn((64, 64, 3, 3), device=card, dtype=torch.bfloat16)
    with pytest.raises(GraphError, match="tap-major"):
        graphs.capture("tap major", lambda: tconv.tap_major(w), warmup=lambda: None)
    before = tconv.tap_major_copies
    graphs.capture("tap major, warmed", lambda: tconv.tap_major(w))
    assert tconv.tap_major_copies == before + 1  # the warm-up's copy, none in the capture


@pytest.mark.cuda
def test_graphs_drop_the_oldest_beyond_the_bound(card, monkeypatch):
    """An owner keeps at most MAX_GRAPHS graphs, dropping the oldest; the
    graphs kept still replay."""
    from diffusion_finetuning_tpu_torch import graph

    monkeypatch.setattr(graph, "MAX_GRAPHS", 2)
    graphs = graph.Graphs(card)
    x = torch.arange(4.0, device=card)
    outs = [graphs.run(k, lambda static, k=k: static["x"] * k, {"x": x}).clone()
            for k in (1, 2, 3)]
    assert list(graphs.graphs) == [2, 3]
    assert torch.equal(outs[2], x * 3)
    assert torch.equal(graphs.run(2, None, {"x": x + 1}), (x + 1) * 2)


@pytest.mark.cuda
def test_failed_capture_raises_and_runs_nothing_eagerly(small_pipe):
    """A step that reads the device on the host cannot be captured: the
    first graphed call raises GraphError naming the key, the state is as it
    was (the warm-up's step undone, none run in its place), and the next
    eager step still runs."""
    from diffusion_finetuning_tpu_torch.graph import GraphError
    from diffusion_finetuning_tpu_torch.training import train_step as ts

    step, state, batches = _train_setup(small_pipe)

    def syncing_step(st, batch, generator=None, draws=None):
        st, m = step(st, batch, generator, draws)
        float(m["loss"])  # a host read: not permitted while capturing
        return st, m

    syncing_step.draws = step.draws
    s = state()
    before = [t.clone() for t in ts.carried_tensors(s)]
    with pytest.raises(GraphError, match="capture of CUDA graph"):
        ts.jit_train_step(syncing_step)(s, batches[0], torch.Generator(device="cuda"))
    assert s["step"] == 0
    for x, y in zip(ts.carried_tensors(s), before):
        assert torch.equal(x, y)
    s, m = step(s, batches[0], torch.Generator(device="cuda").manual_seed(0))
    assert s["step"] == 1 and bool(torch.isfinite(m["loss"]))


# ---------------------------------------------------------------------------
# the trainers (cli_lora_pti, training/checkpoint.py, xformers_utils)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model_dir(tmp_path_factory):
    """A bf16 diffusers directory of the small pipeline's configs (fresh
    weights from fixed seeds) and 4 instance images of 32^2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from PIL import Image

    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from diffusion_finetuning_tpu_torch.models.hf_export import save_pretrained
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    cfgs = (UNetConfig(**SMALL_UNET), VAEConfig.tiny(), CLIPTextConfig.tiny())
    sds = []
    for i, (cls, cfg) in enumerate(zip((UNet2DConditionModel, AutoencoderKL, CLIPTextModel),
                                       cfgs)):
        torch.manual_seed(10 + i)
        sds.append(cls(cfg).state_dict())
    pipe = StableDiffusionPipeline(cfgs[0], sds[0], cfgs[1], sds[1], cfgs[2], sds[2],
                                   CLIPTokenizer.tiny(["photo", "of", "sks"]), device="cpu")
    root = tmp_path_factory.mktemp("small_model")
    save_pretrained(pipe, str(root / "model"), dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    (root / "inst").mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            root / "inst" / f"a photo of sks_{i}.png")
    return root


@pytest.mark.cuda
def test_pti_graphed_spd2_equals_spd1(small_model_dir):
    """``cli_lora_pti.train`` in bf16 on the card (4 inversion steps with
    accumulation 2, 4 tuning steps with the text LoRA and continued
    inversion) at 2 steps a graph and at 1: the losses, LoRA trees and
    token table bit for bit, the checkpoints' bytes equal, and the frozen
    rows untouched by the inversion."""
    from diffusion_finetuning_tpu_torch import cli_lora_pti
    from diffusion_finetuning_tpu_torch.training.trainer_util import token_table

    runs = []
    for spd in (1, 2):
        out = small_model_dir / f"pti_spd{spd}"
        pipe = cli_lora_pti.train(
            instance_data_dir=str(small_model_dir / "inst"),
            pretrained_model_name_or_path=str(small_model_dir / "model"), output_dir=str(out),
            use_template="object", placeholder_tokens="<s1>|<s2>",
            initializer_tokens="<rand-0.017>|<zero>", seed=3, resolution=32,
            max_train_steps_ti=4, max_train_steps_tuning=4, gradient_accumulation_steps=2,
            save_steps=2, lora_rank=4, train_text_encoder=True, continue_inversion=True,
            mixed_precision="bf16", steps_per_dispatch=spd, device="cuda")
        runs.append((pipe, out))
    (a, out_a), (b, out_b) = runs
    for la, lb in zip(a.train_log, b.train_log):
        assert np.array_equal(la["losses"], lb["losses"]) and np.isfinite(la["losses"]).all()
        assert la["launches"]["flash_attention_fwd"] > 0
        assert la["launches"]["flash_attention_bwd"] > 0
    assert a.train_log[0]["frozen_rows_changed"] == 0
    assert b.train_log[1]["launches"]["lora_dense"] > 0
    from diffusion_finetuning_tpu_torch import lora as lora_lib

    for ta, tb in ((a.unet_lora, b.unet_lora), (a.text_encoder_lora, b.text_encoder_lora)):
        for (pa, x), (pb, y) in zip(lora_lib.lora_leaves(ta), lora_lib.lora_leaves(tb)):
            assert pa == pb and torch.equal(x["up"], y["up"])
            assert torch.equal(x["down"], y["down"])
    assert torch.equal(token_table(a), token_table(b))
    names = sorted(p.name for p in out_a.iterdir())
    assert names == sorted(p.name for p in out_b.iterdir()) and len(names) == 4
    for name in names:
        assert (out_a / name).read_bytes() == (out_b / name).read_bytes()


@pytest.mark.cuda
def test_checkpoint_restored_into_a_captured_state_replays_without_capture(small_pipe,
                                                                          tmp_path):
    """A train step captured with jit_train_step; the state saved after 2
    steps, 2 more steps, the checkpoint restored in place: the state equals
    the saved one bit for bit, and the same 2 steps again (the same draws)
    replay the graph (no new capture) to the same losses and state."""
    from diffusion_finetuning_tpu_torch.training import checkpoint as ckpt
    from diffusion_finetuning_tpu_torch.training import train_step as ts

    step, state, batches = _train_setup(small_pipe, ti=True, accum=2)
    st = state()
    fn = ts.jit_train_step(step)
    g = torch.Generator(device="cuda").manual_seed(2)
    for b in batches[:2]:
        fn(st, b, g)
    path = ckpt.save_train_state(str(tmp_path), st)
    saved = {k: t.clone() for k, t in ckpt.named_tensors(st).items()}
    graphs = next(iter(step._dft_graphs.values())).graphs
    captured = len(graphs)
    draws = [step.draws(b, torch.Generator(device="cuda").manual_seed(7 + i))
             for i, b in enumerate(batches[2:4])]
    first = [fn(st, b, draws=d)[1]["loss"] for b, d in zip(batches[2:4], draws)]
    after = [t.clone() for t in ts.carried_tensors(st)]
    ckpt.restore_train_state(path, st)
    assert st["step"] == 2
    for k, t in ckpt.named_tensors(st).items():
        assert torch.equal(t, saved[k]), k
    again = [fn(st, b, draws=d)[1]["loss"] for b, d in zip(batches[2:4], draws)]
    assert len(graphs) == captured
    assert torch.equal(torch.stack(first), torch.stack(again))
    assert all(torch.equal(x, y) for x, y in zip(after, ts.carried_tensors(st)))


@pytest.mark.cuda
def test_flash_backwards_probe_on_the_card(card):
    """xformers_utils.test_flash_backwards runs K1 and K3 at each SD1.5 head
    dim and holds them against the plain versions; the UNet-config walk
    keeps every head dim on the kernels."""
    from diffusion_finetuning_tpu_torch import xformers_utils
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig

    xformers_utils.test_flash_backwards.cache_clear()
    before = (tfa.launches, tfa.bwd_launches)
    assert all(xformers_utils.test_flash_backwards(d) for d in (40, 80, 160))
    assert tfa.launches - before[0] == 3 and tfa.bwd_launches - before[1] == 3
    try:
        assert xformers_utils.set_use_memory_efficient_attention_xformers(UNetConfig.sd15())
        assert tatt.routing() == (True, ())
    finally:
        tatt.clear_flash_overrides()
        tatt.set_flash_enabled(True)


@pytest.mark.cuda
def test_flash_probe_failure_raises_on_the_card(card, monkeypatch):
    """A probe that fails on the card raises with its head dim instead of
    turning the kernel off, and the router refuses to send a card call to
    plain_attention."""
    from diffusion_finetuning_tpu_torch import xformers_utils
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig

    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda q, k, v, heads, scale=None: real(q, k, v, heads, scale) * 2)
    xformers_utils.test_flash_backwards.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="head dim 40"):
            xformers_utils.set_use_memory_efficient_attention_xformers(UNetConfig.sd15())
        assert tatt.routing() == (True, ())
    finally:
        xformers_utils.test_flash_backwards.cache_clear()
    monkeypatch.setattr(tatt, "flash_attention", real)
    q = torch.randn((1, 64, 80), device="cuda", dtype=torch.bfloat16)
    try:
        tatt.set_flash_override(seq_len_q=64, head_dim=40, enabled=False)
        with pytest.raises(RuntimeError, match="seq_len_q=64, head_dim=40"):
            tatt.attention(q, q, q, heads=2)
    finally:
        tatt.clear_flash_overrides()


IMG2IMG_SCHEDULERS = ["ddim", "pndm", "dpm", "euler", "euler_a", "lms", "euler:karras",
                      "euler_a:karras", "lms:karras"]


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", IMG2IMG_SCHEDULERS)
def test_img2img_graph_per_sampler_equals_eager(small_pipe, scheduler):
    """img2img (6 steps at strength 0.6, batch 2, dynamic LoRA) with each
    sampler through its graph, twice (the seed, and so the draws, change),
    equal to the eager request bit for bit; one graph, captured by the
    first request and replayed by both."""
    import numpy as np

    pipe = small_pipe
    pipe.unet_lora, pipe.materialize_lora = _small_lora(pipe.unet_config, 15, "cuda"), False
    pipe.invalidate_merged_cache()
    pipe._graphs = None
    image = np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    for seed in (1, 2):
        kw = dict(strength=0.6, num_inference_steps=6, seed=seed, scheduler=scheduler,
                  output_type="device")
        got = pipe.img2img(["photo", "photo of sks"], image, **kw)
        want = _eager(pipe, lambda: pipe.img2img(["photo", "photo of sks"], image, **kw))
        replays = [e.replays for e in pipe._graphs.graphs.values()]
        assert got.shape == (2, 32, 32, 3), f"seed {seed}: graphed shape {tuple(got.shape)}"
        assert torch.equal(got, want), (
            f"seed {seed}: graphed differs from eager by max |diff| "
            f"{float((got.float() - want.float()).abs().max())}; graph replays {replays}")
    replays = [e.replays for e in pipe._graphs.graphs.values()]
    assert replays == [2], f"graph replays {replays}, want [2]"


@pytest.mark.cuda
def test_img2img_ancestral_noise_given_equals_seeded(small_pipe):
    """euler_a img2img with its draws handed in (``img2img_draws`` of the
    same seed) equals the seeded request, graphed and eager; other draws
    give another image."""
    import numpy as np

    pipe = small_pipe
    pipe.unet_lora = None
    pipe._graphs = None
    image = np.random.default_rng(2).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    kw = dict(strength=0.6, num_inference_steps=6, scheduler="euler_a", output_type="device")
    seeded = pipe.img2img(["photo", "sks"], image, seed=4, **kw)
    draws = pipe.img2img_draws(4, 2, (16, 16), noise_steps=4)
    given = pipe.img2img(["photo", "sks"], image, draws=draws, **kw)
    eager = _eager(pipe, lambda: pipe.img2img(["photo", "sks"], image, draws=draws, **kw))
    assert torch.equal(seeded, given) and torch.equal(given, eager)
    other = dict(draws, ancestral=torch.randn_like(draws["ancestral"]))
    assert not torch.equal(pipe.img2img(["photo", "sks"], image, draws=other, **kw), given)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(320, 768), (1280, 1280), (10240, 1280)])
def test_svd_pair_on_the_card_matches_the_cpu(card, shape):
    """``svd_pair`` through cuSOLVER against LAPACK on the CPU, pair by pair
    after sign alignment, on a fine-tune-like delta (rank 4, separated
    singular values, a 1e-3 full-rank residue): relative Frobenius 1e-4."""
    from diffusion_finetuning_tpu_torch.cli_svd import svd_pair

    g = torch.Generator().manual_seed(shape[0])
    u = torch.linalg.qr(torch.randn(shape[0], 4, generator=g))[0]
    v = torch.linalg.qr(torch.randn(shape[1], 4, generator=g))[0]
    delta = (u * torch.tensor([8.0, 4.0, 2.0, 1.0])) @ v.T + 1e-3 * torch.randn(shape, generator=g)
    cu, cvh = svd_pair(delta.to(card), 4)
    hu, hvh = svd_pair(delta, 4)
    assert cu.is_cuda and cvh.is_cuda
    for j in range(4):
        sign = torch.sign(torch.dot(cu[:, j].cpu(), hu[:, j]))
        for got, want in ((cu[:, j].cpu() * sign, hu[:, j]), (cvh[j].cpu() * sign, hvh[j])):
            assert float((got - want).norm()) <= 1e-4 * float(want.norm())


@pytest.mark.cuda
def test_lora_distill_refuses_to_start_without_a_card(card, monkeypatch, tmp_path):
    """With the card hidden and no ``device`` given, ``svd_distill`` raises
    before it reads anything; it never moves its SVDs to the CPU quietly."""
    from diffusion_finetuning_tpu_torch import cli_svd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_svd.svd_distill(str(tmp_path / "absent"), str(tmp_path / "absent"),
                            save_path=str(tmp_path / "x.pt"))
    assert not (tmp_path / "x.pt").exists()
