"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs one CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports neither jax nor the JAX package, so on the
card's machine, which has no JAX, it runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: bf16 outputs within 2e-2 (flash) / 5e-2 (LoRA, |y| up to ~4)
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
def test_attention_launches_the_flash_kernel(card):
    """(B, S, H*D) in, one launch, the same result as plain_attention."""
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((2, s, 8 * 40), generator=g, device=card, dtype=torch.bfloat16)
               for s in (256, 77, 77))
    before = tfa.launches
    with torch.inference_mode():
        out = tatt.attention(q, k, v, 8)
        ref = tatt.plain_attention(q, k, v, 8)
    assert tfa.launches == before + 1
    assert out.shape == q.shape and _max_err(out, ref) <= 2e-2


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
    before = (tfa.launches, tfa.packed_launches)
    with torch.inference_mode():
        o1, lse1 = tfa._fwd_cuda(q, k, v, d ** -0.5)
        o4, lse4 = tfa._fwd_cuda(q, k, v, d ** -0.5, pack)
    assert (tfa.launches, tfa.packed_launches) == (before[0] + 1, before[1] + 1)
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
