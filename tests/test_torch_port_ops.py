"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as tests/test_flash_attention.py runs
them.  Inputs are made with numpy from a seed and handed to both.  The CUDA
kernels are held against the plain versions on a card by
tests/test_torch_port_cuda.py.

Tolerances: fp32 1e-5 (the same sums in another order); bf16 one bf16 ulp of
the outputs' magnitude (2e-2 at |x| <= 2) -- both sides round the same fp32
value to bf16 and may land on neighbouring values -- with the mean error
held 10x tighter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_finetuning_tpu.ops import flash_attention as jfa
from diffusion_finetuning_tpu.ops.attention import xla_attention
from diffusion_finetuning_tpu.ops.lora_matmul import lora_dense as jax_lora_dense

from diffusion_finetuning_tpu_torch.ops import _build, _grid
from diffusion_finetuning_tpu_torch.ops import attention as tatt
from diffusion_finetuning_tpu_torch.ops import flash_attention as tfa
from diffusion_finetuning_tpu_torch.ops import lora_matmul as tlm

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

LN2 = float(np.log(2.0))
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
        assert np.abs(got - want).mean() < 2e-3


def _qkv(bh, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, s, d)).astype(np.float32) for s in (sq, skv, skv))


@pytest.mark.parametrize("exp2", [True, False], ids=["exp2", "natural"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,sq,skv", [(40, 96, 77), (80, 64, 130), (160, 40, 40)])
def test_flash_plain_matches_jax_fwd(d, sq, skv, dtype, exp2):
    """O and lse of flash_attention_plain against JAX _fwd (interpret), with
    the ragged KV tail masked on the JAX side (kv_len < padded length)."""
    q, k, v = _qkv(2, sq, skv, d)
    scale = d ** -0.5
    blk = 128
    sq_p, skv_p, dp = -(-sq // blk) * blk, -(-skv // blk) * blk, -(-d // 8) * 8

    def pad(a, s_p):
        return jnp.asarray(np.pad(a, ((0, 0), (0, s_p - a.shape[1]), (0, dp - d))),
                           _JAX[dtype])

    o_j, lse_j = jfa._fwd(pad(q, sq_p), pad(k, skv_p), pad(v, skv_p), scale, skv,
                          blk, blk, True, exp2=exp2)
    o_j = np.asarray(o_j.astype(jnp.float32))[:, :sq, :d]
    lse_j = np.asarray(lse_j)[:, 0, :sq]
    if not exp2:  # natural-log lse -> the port's base 2
        lse_j = lse_j / LN2

    tt = lambda a: torch.from_numpy(a).to(_TORCH[dtype])
    o_t, lse_t = tfa.flash_attention_plain(tt(q), tt(k), tt(v), scale)
    assert o_t.dtype == _TORCH[dtype] and lse_t.dtype == torch.float32
    _close(o_t.float().numpy(), o_j, dtype)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("sq,skv,heads,d", [(64, 64, 2, 40), (100, 77, 2, 80)])
def test_flash_attention_matches_jax_flash_attention(sq, skv, heads, d):
    """The public (B, S, H*D) entry against JAX flash_attention in interpret
    mode: the split/merge of heads and the dispatch to the plain version."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, s, heads * d)).astype(np.float32)
               for s in (sq, skv, skv))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                               interpret=True, block_q=128, block_kv=128)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fn", ["attention", "plain_attention"], ids=["flash", "plain"])
@pytest.mark.parametrize("sq,skv", [(64, 64), (48, 77)])
def test_attention_matches_xla_attention(sq, skv, fn):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, s, 64)).astype(np.float32) for s in (sq, skv, skv))
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    got = getattr(tatt, fn)(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lora_dense_plain_matches_jax(dtype, bias):
    """M, N not tile multiples; rank 4; W in nn.Linear layout on the port's
    side, its transpose (the Flax kernel) on JAX's."""
    rng = np.random.default_rng(3)
    m, kdim, n, r = 37, 24, 50, 4
    x = rng.standard_normal((m, kdim)).astype(np.float32)
    w = (rng.standard_normal((n, kdim)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n,)) * 0.1).astype(np.float32) if bias else None
    up = (rng.standard_normal((n, r)) * 0.3).astype(np.float32)
    down = (rng.standard_normal((r, kdim)) * 0.3).astype(np.float32)
    jd = _JAX[dtype]
    want = jax_lora_dense(jnp.asarray(x, jd), jnp.asarray(w.T, jd),
                          None if b is None else jnp.asarray(b, jd),
                          jnp.asarray(up, jd), jnp.asarray(down, jd),
                          jnp.asarray(0.75, jnp.float32), interpret=True)
    td = _TORCH[dtype]
    tt = lambda a: None if a is None else torch.from_numpy(a).to(td)
    got = tlm.lora_dense_plain(tt(x), tt(w), tt(b), tt(up), tt(down), torch.tensor(0.75))
    assert got.dtype == td
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


def test_lora_dense_keeps_leading_dims():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    w, up, down = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((12, 16), (12, 3), (3, 16)))
    y = tlm.lora_dense(x, w, None, up, down, 0.5)
    assert y.shape == (2, 5, 12)
    want = x @ w.T + 0.5 * (x @ down.T) @ up.T
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


# (Sq, Skv, head dim) of SD1.5's attention calls at 512^2
SD15_FLASH = [(4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160),
              (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160)]


@pytest.mark.parametrize("bh", [8, 16], ids=["train", "serve"])
@pytest.mark.parametrize("sq,skv,d", SD15_FLASH)
def test_flash_grid_plans_at_sd15_shapes(sq, skv, d, bh):
    """K1's q tile and K3's q splits at every SD1.5 training (BH 8) and
    serving (BH 16) shape: 128-row tiles only where that grid still covers
    half the 132 SMs; the splits cover Sq in whole q tiles, none empty, reach
    one wave (132 CTAs) wherever Sq has the q tiles for it, and two waves
    (264) unless a split would then hold fewer than 4 q tiles, with the
    fewest splits that do so."""
    check_flash_plans(sq, skv, d, bh)


def check_flash_plans(sq, skv, d, bh):
    """The invariants of K1's q tile and K3's q splits at one call (see
    :func:`test_flash_grid_plans_at_sd15_shapes`)."""
    tile = tfa.fwd_q_tile(bh, sq)
    assert tile == (128 if -(-sq // 128) * bh >= 66 else 64)
    n = tfa.bwd_q_splits(bh, sq, skv, d)
    br = tfa.bwd_q_rows(d)
    n_q = -(-sq // br)
    rows = tfa.bwd_split_rows(sq, d, n)
    assert len(rows) == n and rows[0][0] == 0 and rows[-1][1] == sq
    assert all(a < b for a, b in rows)
    assert all(rows[i][1] == rows[i + 1][0] and rows[i][1] % br == 0 for i in range(n - 1))
    kv_tiles = -(-skv // 64) * bh
    assert kv_tiles * n >= 132 or n == n_q
    assert kv_tiles * n >= 264 or n >= n_q // 4
    assert n == 1 or kv_tiles * (n - 1) < 264


@pytest.mark.parametrize("bh", [8, 16], ids=["train", "serve"])
@pytest.mark.parametrize("head_pack", [2, 4])
@pytest.mark.parametrize("sq,skv,d", SD15_FLASH)
def test_packed_q_tile_at_sd15_shapes(sq, skv, d, head_pack, bh):
    """K4's q tile at every SD1.5 shape and G = 2, 4: sized for the packed
    grid of ceil(Sq/tile) x BH/G CTAs (each running its G heads at once),
    128 rows only where that grid still covers half the 132 SMs.  It never
    takes a larger tile than K1's, so K4 never has fewer CTAs per head than
    the packing forces, and ``_fwd_cuda`` takes it for packed calls."""
    tile = tfa.packed_q_tile(bh, head_pack, sq)
    ctas = -(-sq // tile) * (bh // head_pack)
    assert tile == (128 if -(-sq // 128) * (bh // head_pack) >= 66 else 64)
    assert tile <= tfa.fwd_q_tile(bh, sq)
    assert tile == 64 or ctas >= 66
    # the 64-row grid is taken only where the 128-row one would starve
    assert tile == 128 or -(-sq // 128) * (bh // head_pack) < 66


def test_packed_q_tile_examples():
    """The packed rule's cases named in the kernel's notes: at S=1024 and G
    = 2 K4 takes 64-row tiles (128 CTAs of two heads, as many CTAs as K1's
    128-row grid), at S=4096 128-row tiles (256 CTAs at G = 2, 128 at G =
    4), at S <= 256 64-row tiles."""
    assert tfa.packed_q_tile(16, 2, 1024) == 64 and tfa.fwd_q_tile(16, 1024) == 128
    assert tfa.packed_q_tile(16, 2, 4096) == 128 and tfa.packed_q_tile(16, 4, 4096) == 128
    assert tfa.packed_q_tile(16, 2, 256) == 64 and tfa.packed_q_tile(16, 4, 64) == 64
    assert tfa.packed_q_tile(8, 2, 4096) == 128 and tfa.packed_q_tile(16, 4, 1024) == 64


def test_flash_grid_plans_examples():
    """The rules' cases named in the kernels' notes: S=4096 and S=1024
    serving take 128-row tiles (512 and 128 CTAs), S=256 keeps 64 (64 CTAs,
    not 32), S=1024 training 64 (128 CTAs, not 64); the
    4096 x 77 backward goes from 16 CTAs to 256 (16 splits of 4 q tiles),
    1024 x 77 to one wave (9 splits), self-attention at 4096^2 stays
    unsplit; the q tile narrows from 64 rows (d_pad <= 64) to 16 (d_pad >
    96)."""
    assert tfa.fwd_q_tile(16, 4096) == 128 and tfa.fwd_q_tile(16, 1024) == 128
    assert tfa.fwd_q_tile(16, 256) == 64 and tfa.fwd_q_tile(8, 1024) == 64
    assert tfa.fwd_q_tile(8, 4096) == 128 and tfa.fwd_q_tile(8, 256) == 64
    assert tfa.bwd_q_splits(8, 4096, 77, 40) == 16
    assert tfa.bwd_q_splits(8, 1024, 77, 80) == 9
    assert tfa.bwd_q_splits(8, 4096, 4096, 40) == 1
    assert tfa.bwd_q_splits(8, 1024, 1024, 80) == 3
    assert tfa.bwd_q_splits(8, 64, 77, 160) == 4  # every one of its 4 q tiles
    assert (tfa.bwd_q_rows(40), tfa.bwd_q_rows(80), tfa.bwd_q_rows(160)) == (64, 32, 16)
    assert tfa.bwd_split_rows(100, 80, 3) == [(0, 32), (32, 64), (64, 100)]


# (M, K, N, calls a step) of the LoRA'd projections of SD1.5 at 512^2: per
# transformer block attn1 q/k/v/out and attn2 q/out (C -> C), attn2 k/v on
# the text rows (768 -> C), the GEGLU projection (C -> 8C); serving runs CFG
# batch 2 (154 text rows), training batch 1 (77)
def _sd15_lora_shapes(batch):
    shapes = []
    for hw, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        m = batch * hw
        shapes += [(m, c, c), (77 * batch, 768, c), (m, c, 8 * c)]
    return shapes


@pytest.mark.parametrize("batch", [2, 1], ids=["serve", "train"])
def test_lora_plan_at_sd15_shapes(batch):
    """K2's grid at every SD1.5 serving and training shape: one of the
    plan's tiles, covering M and N; the largest tile whose grid fills one
    wave (132 CTAs), else 64 x 64; splits that cut the 64-deep k-steps into
    contiguous runs of at least 8, none empty, only where 64 x 64 tiles
    fill under half a wave, and no more than one wave needs."""
    for m, k, n in _sd15_lora_shapes(batch):
        check_lora_plan(m, k, n)


def check_lora_plan(m, k, n):
    """The invariants of ``tlm.plan`` at one (M, K, N) call (see
    :func:`test_lora_plan_at_sd15_shapes`)."""
    bm, bn, splits = tlm.plan(m, n, k)
    assert (bm, bn) in tlm.TILES
    assert _grid.cdiv(m, bm) * bm >= m and _grid.cdiv(n, bn) * bn >= n
    tiles = _grid.cdiv(m, bm) * _grid.cdiv(n, bn)
    larger = tlm.TILES[:tlm.TILES.index((bm, bn))]
    assert all(_grid.cdiv(m, tm) * _grid.cdiv(n, tn) < 132 for tm, tn in larger)
    assert tiles >= 132 or (bm, bn) == (64, 64)
    steps = _grid.cdiv(k, tlm.K_STEP)
    runs = _grid.split_steps(steps, splits)
    assert runs[0][0] == 0 and runs[-1][1] == steps
    assert all(b - a >= 8 for a, b in runs) or splits == 1
    assert all(runs[i][1] == runs[i + 1][0] for i in range(splits - 1))
    assert splits == 1 or tiles < 66
    assert splits == 1 or tiles * (splits - 1) < 132, (m, k, n)


def test_lora_plan_examples():
    """Named cases: the text rows (154 x 768 -> N) run 64 x 64 tiles
    unsplit; the 64^2 level's C -> C projections 64 x 128 at batch 1 and
    128 x 128 at batch 2; the GEGLU projections 128 x 128; 512 x 1280 ->
    1280 64 x 64 (160 CTAs); the mid block's 128 rows at 1280 -> 1280, 40
    tiles, split in two (10 k-steps each)."""
    assert tlm.plan(154, 320, 768) == (64, 64, 1)
    assert tlm.plan(77, 1280, 768) == (64, 64, 1)
    assert tlm.plan(4096, 320, 320) == (64, 128, 1)
    assert tlm.plan(8192, 320, 320) == (128, 128, 1)
    assert tlm.plan(8192, 2560, 320) == (128, 128, 1)
    assert tlm.plan(512, 1280, 1280) == (64, 64, 1)
    assert tlm.plan(128, 1280, 1280) == (64, 64, 2)
    assert tlm.plan(128, 10240, 1280) == (64, 128, 1)
    assert _grid.split_steps(12, 6) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12)]


def test_kernel_library_is_keyed_on_sources(tmp_path, monkeypatch):
    """The build goes to the configured directory, one .so per source, named
    by a hash of the sources and flags (no nvcc needed to compute it)."""
    monkeypatch.setenv("DFT_TORCH_BUILD_DIR", str(tmp_path))
    paths = {name: _build.library_path(name) for name in _build.KERNELS}
    for name, p in paths.items():
        assert p.parent == tmp_path and p.name.startswith(name + "-") and p.suffix == ".so"
        assert p == _build.library_path(name)
        assert (_build.CSRC / f"{name}.cu").exists()
    assert len(set(paths.values())) == len(paths)


# -- NHWC GroupNorm (no JAX counterpart: its plain version against PyTorch's) --

def _gn_inputs(shape, dtype, layout, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, c = shape[:2]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    w = (1 + 0.1 * torch.randn((c,), generator=g)).to(dtype)
    bias = (0.1 * torch.randn((c,), generator=g)).to(dtype)
    add = torch.randn((b, c), generator=g).to(dtype)
    return x, w, bias, add


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("eps,with_add,silu", [(1e-5, True, True), (1e-5, False, True),
                                               (1e-6, False, False)],
                         ids=["norm2", "norm1", "transformer"])
@pytest.mark.parametrize("shape", [(2, 64, 8, 8), (2, 320, 5, 7)])
def test_group_norm_plain_matches_torch(shape, eps, with_add, silu, dtype, layout):
    """The NHWC GroupNorm's plain version (32 groups, the resnets' add and
    SiLU, the transformers' eps) against PyTorch's add, ``F.group_norm``
    and ``F.silu`` as the NCHW modules run them, in either layout; y keeps
    x's shape, dtype and memory format.  fp32 within 1e-5; bf16 within one
    bf16 ulp (2^-7 relative, or absolute near 0): PyTorch rounds after the
    norm and again after the SiLU, the plain version once."""
    from diffusion_finetuning_tpu_torch.ops import group_norm as tgn

    x, w, b, add = _gn_inputs(shape, _TORCH[dtype], layout)
    add = add if with_add else None
    got = tgn.group_norm(x, 32, w, b, eps, add, silu)
    h = x if add is None else x + add[:, :, None, None]
    want = F.group_norm(h, 32, w, b, eps)
    want = F.silu(want) if silu else want
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    assert got.shape == x.shape and got.dtype == x.dtype
    assert got.is_contiguous(memory_format=fmt)
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_group_norm_plain_is_differentiable():
    """On the CPU the plain version carries gradients (the NHWC path of a
    module that trains on channels-last inputs)."""
    from diffusion_finetuning_tpu_torch.ops import group_norm as tgn

    x, w, b, add = _gn_inputs((2, 64, 4, 4), torch.float32, "nhwc")
    for t in (x, w, b, add):
        t.requires_grad_(True)
    tgn.group_norm(x, 32, w, b, 1e-5, add, True).square().sum().backward()
    got = [t.grad.clone() for t in (x, w, b, add)]
    for t in (x, w, b, add):
        t.grad = None
    F.silu(F.group_norm(x + add[:, :, None, None], 32, w, b, 1e-5)).square().sum().backward()
    for g, t in zip(got, (x, w, b, add)):
        torch.testing.assert_close(g, t.grad, atol=1e-5, rtol=1e-5)


def _gn_shapes():
    """Every GroupNorm (B, C, HW) of the SD1.5 512^2 and SD 2.1 768^2 UNet
    steps (batch 1, 2, 8) and of the VAE decodes at 512^2 and 768^2 (batch
    1 to 4)."""
    import chip_smoke
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig

    keys = set()
    for cfg, side in ((UNetConfig.sd15(), 64), (UNetConfig.sd21(), 96)):
        for batch in (1, 2, 8):
            keys |= set(chip_smoke.unet_group_norm_calls(cfg, batch, side))
    for side in (64, 96):
        for batch in (1, 4):
            keys |= set(chip_smoke.vae_decoder_group_norm_calls(VAEConfig.sd15(), batch, side))
    return sorted({(k[0], k[1], k[2] * k[3]) for k in keys})


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_group_norm_plans_at_sd_shapes(itemsize):
    """The kernel's grid at every SD GroupNorm shape, bf16 and fp32: whole
    warps of at most 1024 threads, each a channel vector of one of the tile's
    pixel lanes; tiles covering the image once; shared memory within the
    227 KB a CTA can have."""
    from diffusion_finetuning_tpu_torch.ops import group_norm as tgn

    shapes = _gn_shapes()
    assert len(shapes) > 40
    for b, c, hw in shapes:
        p = tgn.plan(b, hw, c, itemsize)
        assert p is not None, (b, c, hw)
        vectors = c // tgn.vector(itemsize)
        assert p.threads == vectors * p.lanes and p.threads % 32 == 0 and p.threads <= 1024
        assert p.tile % p.lanes == 0 and p.tile // p.lanes >= tgn.MIN_LOADS
        assert (p.tiles - 1) * p.tile < hw <= p.tiles * p.tile
        assert (2 * p.lanes * c + p.lanes) * 4 <= 200 * 1024
        assert b * p.tiles <= 8 * tgn.TARGET_CTAS


def test_group_norm_plan_examples():
    from diffusion_finetuning_tpu_torch.ops import group_norm as tgn

    assert tgn.plan(2, 4096, 320) == (480, 12, 48, 86)  # 40 vectors x 12 lanes
    assert tgn.plan(8, 9216, 320) == (480, 12, 144, 64)
    assert tgn.plan(2, 64, 2560) == (320, 1, 4, 16)
    assert tgn.plan(4, 768 * 768, 128) == (512, 32, 4480, 132)
    assert tgn.plan(2, 256, 192).threads == 480  # 24 vectors: lanes in steps of 4
    assert tgn.plan(2, 64, 2560, 4).threads == 640
    assert tgn.plan(1, 64, 12) is None  # not a whole bf16 vector of channels
    assert tgn.plan(1, 64, 8 * 1000) is None  # no whole warps of at most 1024 threads
