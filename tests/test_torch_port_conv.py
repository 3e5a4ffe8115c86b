"""The port's fused 3x3 conv (K5) and head-packed flash forward (K4) against
the JAX package, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_conv_pallas.py
and tests/test_flash_attention.py run them; the port's wrappers run their
plain versions.  Inputs are made with numpy from a seed and handed to both,
the conv's transposed between the JAX layouts (NHWC, HWIO) and the port's
(NCHW, OIHW).  The routing rules (``supported``, the head-pack rule) are
held against JAX's own decisions at every SD1.5 shape.

Tolerances: the conv's output 1e-4 in fp32 (JAX's own test against XLA's
conv uses the same), its gradients 1e-3 (the sum of squares' gradient
doubles every value); packed flash 1e-5 against JAX (the same sums in
another order) and exact against the port's unpacked forward.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu.models.unet import UNetConfig as JUNet
from diffusion_finetuning_tpu.models.unet import _resnet_channel_map as jax_resnet_map
from diffusion_finetuning_tpu.ops import conv_pallas as jconv
from diffusion_finetuning_tpu.ops import flash_attention as jfa

from diffusion_finetuning_tpu_torch.ops import _grid
from diffusion_finetuning_tpu_torch.ops import conv3x3 as tconv
from diffusion_finetuning_tpu_torch.ops import flash_attention as tfa

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _conv_inputs(shape, seed):
    B, H, W, C, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, C, O)) * 0.05).astype(np.float32)
    b = rng.standard_normal((O,)).astype(np.float32)
    return x, k, b


def _to_port(x, k):
    """NHWC / HWIO numpy -> NCHW / OIHW torch."""
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))))


@pytest.mark.parametrize(
    "shape",
    [
        (2, 16, 16, 64, 128),   # O = bn
        (1, 8, 8, 128, 320),    # O padded 320 -> 384 on the TPU
        (2, 16, 16, 128, 64),   # O < bn
        (1, 32, 16, 64, 128),   # H > bh: multi row-block grid
    ],
)
def test_conv3x3_matches_jax_interpret(shape):
    x, k, b = _conv_inputs(shape, 0)
    want = np.asarray(jconv.conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), True))
    xt, wt = _to_port(x, k)
    got = tconv.conv3x3(xt, wt, torch.from_numpy(b))
    assert got.shape == (shape[0], shape[4], shape[1], shape[2]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4)


def test_conv3x3_plain_rounds_once_in_bf16():
    """bf16 operands: products and sums in fp32, one rounding at the end,
    so the result is the fp32 conv of the bf16 values rounded once (within
    one bf16 ulp: the two fp32 sums run in different orders)."""
    x, k, b = _conv_inputs((1, 8, 8, 64, 64), 2)
    xt, wt = (t.bfloat16() for t in _to_port(x, k))
    bt = torch.from_numpy(b).bfloat16()
    got = tconv.conv3x3_plain(xt, wt, bt)
    want = torch.nn.functional.conv2d(xt.float(), wt.float(), bt.float(), padding=1)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.bfloat16().float(), atol=1e-6, rtol=2 ** -7)


def test_conv3x3_gradients_match_jax():
    x, k, b = _conv_inputs((1, 8, 8, 64, 64), 1)
    want = jax.grad(lambda x, k, b: jnp.sum(jconv.conv3x3(x, k, b, True) ** 2),
                    (0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt, wt = (t.requires_grad_(True) for t in _to_port(x, k))
    bt = torch.from_numpy(b).requires_grad_(True)
    gx, gw, gb = torch.autograd.grad((tconv.conv3x3(xt, wt, bt) ** 2).sum(), (xt, wt, bt))
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), np.asarray(want[0]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gw.permute(2, 3, 1, 0).numpy(), np.asarray(want[1]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want[2]), rtol=1e-3, atol=1e-3)


def test_conv3x3_frozen_weight_gets_no_gradient():
    x, k, b = _conv_inputs((1, 8, 8, 64, 64), 3)
    xt, wt = _to_port(x, k)
    xt.requires_grad_(True)
    out = tconv.conv3x3(xt, wt)
    (gx,) = torch.autograd.grad(out.sum(), (xt,))
    assert gx.shape == xt.shape and wt.grad is None


def _sd15_resnet_convs(side, batch):
    """(x NHWC, kernel HWIO) of the 44 3x3 convs of one SD1.5 UNet call at
    ``side``^2 latents, from the JAX model's resnet channel map."""
    levels = 4
    out = []
    for prefix, cin, cout in jax_resnet_map(JUNet.sd15()):
        i = int(prefix.split("_")[2]) if not prefix.startswith("mid") else None
        level = i if prefix.startswith("down") else (
            levels - 1 - i if prefix.startswith("up") else levels - 1)
        s = side >> level
        out.append(((batch, s, s, cin), (3, 3, cin, cout)))
        out.append(((batch, s, s, cout), (3, 3, cout, cout)))
    return out


@pytest.mark.parametrize("batch", [1, 2])
def test_supported_matches_jax_at_sd15(batch):
    """The copied predicate decides as JAX's at every SD1.5 resnet conv
    (bf16, 512^2): 37 of the 44 go to the kernel; the 7 left are the
    up-block conv1s with 2560 or 1920 input channels."""
    convs = _sd15_resnet_convs(64, batch)
    assert len(convs) == 44
    routed = []
    for x_shape, k_shape in convs:
        ours = tconv.supported(x_shape, k_shape, (1, 1), padding=1, itemsize=2)
        assert ours == jconv.supported(x_shape, k_shape, (1, 1), padding=1, itemsize=2)
        routed.append(ours)
    assert sum(routed) == 37
    assert {x[3] for (x, _), r in zip(convs, routed) if not r} == {2560, 1920}
    # the port's NCHW/OIHW front door asks the same question
    x_shape, k_shape = convs[0]
    xt = torch.empty((batch, x_shape[3], x_shape[1], x_shape[2]), dtype=torch.bfloat16)
    wt = torch.empty((k_shape[3], k_shape[2], 3, 3))
    assert tconv.routes(xt, wt, (1, 1), (1, 1)) and not tconv.routes(xt, wt, 2, 1)


def test_supported_rejects_as_jax():
    cases = [
        ((2, 64, 64, 320), (3, 3, 320, 320), (1, 1), 1, True),
        ((2, 8, 8, 1280), (3, 3, 1280, 1280), (1, 1), 1, True),
        ((2, 64, 64, 320), (3, 3, 320, 320), (2, 2), 1, False),   # stride 2
        ((2, 64, 64, 320), (1, 1, 320, 320), (1, 1), 1, False),   # 1x1
        ((1, 512, 512, 3), (3, 3, 3, 128), (1, 1), 1, False),     # RGB stem
        ((1, 8, 8, 16), (3, 3, 16, 16), (1, 1), 1, False),        # tiny
        ((2, 64, 64, 320), (3, 3, 320, 4), (1, 1), 1, False),     # rank-4 LoRA down
        ((2, 64, 64, 320), (3, 3, 320, 320), (1, 1), 0, False),   # valid padding
        ((1, 67, 67, 640), (3, 3, 640, 640), (1, 1), 1, False),   # prime H: bh snaps to 1
    ]
    for x_shape, k_shape, strides, pad, want in cases:
        assert jconv.supported(x_shape, k_shape, strides, padding=pad) == want
        assert tconv.supported(x_shape, k_shape, strides, padding=pad) == want


@pytest.mark.parametrize("batch", [2, 1], ids=["serve", "train"])
def test_conv_plan_at_sd15(batch):
    """K5's grid at every routed SD1.5 resnet conv (512^2): a TMA box of
    P = sw/2 pixels, P the narrowest of 16, 32, 64 that holds an image row
    (W = 8 reads half-empty 16-pixel boxes); 128-pixel tiles of whole rows
    covering H; 64-channel tiles covering O; splits that cut the 9 * C/64
    k-steps into contiguous runs of at least 4, only where the tiles fill
    under one wave, and the fewest that reach it."""
    for x_shape, k_shape in _sd15_resnet_convs(64, batch):
        if not tconv.supported(x_shape, k_shape, (1, 1), padding=1, itemsize=2):
            continue
        b, h, w, c = x_shape
        o = k_shape[3]
        p = tconv.plan(b, c, h, w, o)
        px = p.sw // 2
        assert px in (16, 32, 64) and px >= w and (px == 16 or px // 2 < w)
        assert p.rows * px == tconv.PIXELS
        assert p.tiles == b * _grid.cdiv(h, p.rows) * _grid.cdiv(o, tconv.CHANNELS)
        steps = 9 * _grid.cdiv(c, tconv.C_STEP)
        runs = _grid.split_steps(steps, p.splits)
        assert runs[0][0] == 0 and runs[-1][1] == steps
        assert all(b_ - a >= 4 for a, b_ in runs)
        assert p.tiles * p.splits >= 132 or p.splits == steps // 4
        assert p.splits == 1 or (p.tiles < 132 and p.tiles * (p.splits - 1) < 132)


def test_conv_plan_examples():
    """The 64^2 level: 128-byte boxes of one 64-pixel row, 2 rows a tile,
    unsplit (320 tiles at B = 2); 32^2: 64-byte boxes, 4 rows; 16^2 at
    1280 channels: 80 tiles split 2 ways (90 k-steps each); 8^2: 16-pixel
    boxes half past the image, 40 tiles split 4 ways (B = 2) and 20 split
    7 ways (B = 1); W = 96: rows of two 64-pixel boxes; W not a multiple
    of 8, or above 128, goes to the element-load kernel (no plan)."""
    assert tconv.plan(2, 320, 64, 64, 320) == tconv.Plan(128, 2, 1, 320)
    assert tconv.plan(2, 640, 32, 32, 640) == tconv.Plan(64, 4, 1, 160)
    assert tconv.plan(2, 1280, 16, 16, 1280) == tconv.Plan(32, 8, 2, 80)
    assert tconv.plan(2, 1280, 8, 8, 1280) == tconv.Plan(32, 8, 4, 40)
    assert tconv.plan(1, 1280, 8, 8, 1280) == tconv.Plan(32, 8, 7, 20)
    assert tconv.plan(1, 64, 20, 96, 128) == tconv.Plan(128, 1, 2, 40)
    assert tconv.plan(1, 64, 9, 12, 64) is None
    assert tconv.plan(1, 64, 8, 136, 64) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tap_major_weight_matches_jax_w9(dtype):
    """The kernel's weight operand is JAX's w9 (the HWIO kernel reshaped to
    (9, C, O), conv_pallas.py:116) with its last two dims swapped, from the
    same numpy weights, exactly."""
    _, k, _ = _conv_inputs((1, 8, 8, 64, 96), 4)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jnp.asarray(k).astype(jd).reshape(9, 64, 96).astype(jnp.float32))
    _, wt = _to_port(np.zeros((1, 8, 8, 64), np.float32), k)
    w9 = tconv.tap_major(wt, dtype)
    assert w9.shape == (9, 96, 64) and w9.dtype == dtype and w9.is_contiguous()
    np.testing.assert_array_equal(w9.float().permute(0, 2, 1).numpy(), want)


def test_tap_major_cache_follows_the_weight():
    """A frozen weight is reordered once; an in-place update (which bumps
    its version) gives a fresh copy; another tensor with the same values
    gets its own entry; a freed weight drops its copy."""
    _, k, _ = _conv_inputs((1, 8, 8, 64, 64), 5)
    _, wt = _to_port(np.zeros((1, 8, 8, 64), np.float32), k)
    first = tconv.tap_major(wt)
    assert tconv.tap_major(wt) is first
    assert tconv.tap_major(wt, torch.bfloat16) is not first
    with torch.no_grad():
        wt.mul_(2.0)
    again = tconv.tap_major(wt)
    assert again is not first
    torch.testing.assert_close(again, 2.0 * first, rtol=0, atol=0)
    twin = wt.clone()
    assert tconv.tap_major(twin) is not again
    key = (id(twin), twin.dtype)
    assert key in tconv._TAP_MAJOR
    del twin
    gc.collect()
    assert key not in tconv._TAP_MAJOR
    with torch.inference_mode():
        frozen = wt.clone()
        assert tconv.tap_major(frozen) is not tconv.tap_major(frozen)


def _qkv(b, sq, skv, heads, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, heads * d)).astype(np.float32)
                 for s in (sq, skv, skv))


@pytest.mark.parametrize("pack", [2, 4])
def test_packed_flash_matches_jax_and_unpacked(pack):
    """BH = 4: the packed route is taken on both sides; the port's packed
    output equals its unpacked one exactly and JAX's within 1e-5."""
    q, k, v = _qkv(2, 256, 256, 2, 40, 0)
    assert tfa.use_head_pack(pack, 4, 256, 256, 40, 4)
    want = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), 2, interpret=True,
                               head_pack=pack)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(qt, kt, vt, 2, head_pack=pack)
    base = tfa.flash_attention(qt, kt, vt, 2, head_pack=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, base)
    # the (BH, S, D) entry: O and lse bit-equal to the unpacked forward
    split = lambda t: t.reshape(2, -1, 2, 40).transpose(1, 2).reshape(4, -1, 40).contiguous()
    o_p, lse_p = tfa.flash_fwd(split(qt), split(kt), split(vt), 40 ** -0.5, head_pack=pack)
    o_1, lse_1 = tfa.flash_fwd(split(qt), split(kt), split(vt), 40 ** -0.5, head_pack=1)
    assert torch.equal(o_p, o_1) and torch.equal(lse_p, lse_1)


def test_packed_flash_indivisible_bh_falls_back():
    q, k, v = _qkv(1, 256, 77, 3, 40, 1)
    assert not tfa.use_head_pack(2, 3, 256, 77, 40, 4)
    want = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), 3, interpret=True,
                               head_pack=2)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(qt, kt, vt, 3, head_pack=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, tfa.flash_attention(qt, kt, vt, 3, head_pack=1))


def test_packed_flash_backward_matches_unpacked():
    """The backward runs per head whatever the forward's packing."""
    q, k, v = _qkv(2, 64, 77, 2, 40, 2)

    def grads(pack):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = tfa.flash_attention(*ts, 2, head_pack=pack)
        return torch.autograd.grad((out * out).sum(), ts)

    for a, b in zip(grads(2), grads(1)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# (Sq, Skv, head dim) of SD1.5's attention calls at 512^2: self-attention
# and cross-attention (77 text tokens) at each level, 8 heads
SD15_ATTENTION = [(4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160),
                  (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160)]


def _jax_packs(batch, sq, skv, d, pack):
    """Whether JAX flash_attention sends this bf16 call to _fwd_packed
    (traced abstractly: nothing is computed)."""
    seen = []
    real = jfa._fwd_packed

    def spy(*a, **kw):
        seen.append(True)
        return real(*a, **kw)

    jfa._fwd_packed = spy
    try:
        shapes = [jax.ShapeDtypeStruct((batch, s, 8 * d), jnp.bfloat16) for s in (sq, skv, skv)]
        jax.eval_shape(lambda q, k, v: jfa.flash_attention(q, k, v, 8, head_pack=pack), *shapes)
    finally:
        jfa._fwd_packed = real
    return bool(seen)


@pytest.mark.parametrize("pack", [2, 4])
def test_head_pack_rule_matches_jax_at_sd15(pack):
    """The port's rule decides as JAX's dispatch at every SD1.5 attention
    shape, for serving (batch 2: BH = 16) and training (batch 1: BH = 8).
    With G = 2 all 32 calls of a UNet step pack; with G = 4 the 5 calls of
    S = 4096 self-attention stay on the unpacked kernel (27 pack)."""
    calls = [5, 5, 5, 1, 5, 5, 5, 1]
    for batch in (1, 2):
        packed = 0
        for (sq, skv, d), n in zip(SD15_ATTENTION, calls):
            ours = tfa.use_head_pack(pack, batch * 8, sq, skv, d, 2)
            assert ours == _jax_packs(batch, sq, skv, d, pack), (sq, skv, d)
            packed += n * ours
        assert packed == (32 if pack == 2 else 27)
