"""The split fp32 product of the port's fp32 flash kernels, emulated on the
CPU with bit masks.

``csrc/split_f32.cuh``: each fp32 value x becomes big = tf32(x) and small =
tf32(x - big) (``cvt.rna.tf32.f32``: 10 explicit mantissa bits, to nearest,
ties away from zero), and a product a b becomes small_a big_b + big_a
small_b + big_a big_b, each product exact in fp32.  Here the three products
are summed in fp64 and rounded to fp32 once, so the error measured is the
split's own (the dropped small_a small_b and the rounding of the small
halves), against an fp64 reference, at the widest head dim the kernels take
(d = 160), the longest SD1.5 contraction of the LoRA'd projections (K =
1280) and of the fp32-routed convs (9 x 640, and 9 x 1280): inside
``chip_smoke.py``'s fp32 gates, where one TF32 product is not.  Beside them,
K5's split weight copy and the fp32 kernels' grid rules, in pure Python.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from diffusion_finetuning_tpu_torch.ops import _grid
from diffusion_finetuning_tpu_torch.ops import conv3x3 as tconv
from diffusion_finetuning_tpu_torch.ops import lora_matmul as tlm


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as cvt.rna: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n), fp32 in and out, as the split product."""
    (ab, as_), (bb, bs) = split(a), split(b)
    d = lambda t: t.double()  # noqa: E731
    return (d(as_) @ d(bb) + d(ab) @ d(bs) + d(ab) @ d(bb)).float()


def _rel_l2(a, b):
    return float((a.double() - b).norm() / b.norm())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11),
                      3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                -(1.0 + 2 ** -10), 3.0]
    big, small = split(torch.tensor([1.0 + 2 ** -20 + 2 ** -11], dtype=torch.float32))
    assert float(big) == 1.0 + 2 ** -10 and float(small) == -(2 ** -11) + 2 ** -20


def test_split_product_holds_the_lora_gate_where_one_tf32_product_does_not():
    """y = x W^T at K = 1280 (an SD1.5 1280-wide projection)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 1280)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((320, 1280)) / 1280 ** 0.5).astype(np.float32))
    ref = x.double() @ w.double().t()
    tol = chip_smoke.LORA_F32_TOL
    got = split_matmul(x, w.t())
    assert float((got.double() - ref).abs().max()) <= tol["max_rel"] * float(ref.abs().max())
    assert _rel_l2(got, ref) <= tol["rel_l2"]
    one = (tf32(x).double() @ tf32(w).double().t()).float()
    assert _rel_l2(one, ref) > tol["rel_l2"]


def test_split_product_holds_the_flash_gate_at_d160():
    """softmax(Q K^T s) V with both products split, the softmax in fp32 and P
    split as the kernel splits it, at d = 160 over 256 kv rows."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((256, 160)).astype(np.float32))
               for _ in range(3))
    scale = 160 ** -0.5
    log2e = 1.4426950408889634
    s = split_matmul(q, k.t()) * (scale * log2e)
    m = s.amax(dim=1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=1, keepdim=True)
    o = split_matmul(p, v) / l
    lse = (m + torch.log2(l)).squeeze(1)
    s64 = (q.double() @ k.double().t()) * (scale * log2e)
    m64 = s64.amax(dim=1, keepdim=True)
    p64 = torch.exp2(s64 - m64)
    o64 = (p64 @ v.double()) / p64.sum(dim=1, keepdim=True)
    lse64 = (m64 + torch.log2(p64.sum(dim=1, keepdim=True))).squeeze(1)
    tol = chip_smoke.FLASH_F32_TOL
    assert float((o.double() - o64).abs().max()) <= tol["max_abs"]
    assert _rel_l2(o, o64) <= tol["rel_l2"]
    assert float((lse.double() - lse64).abs().max()) <= tol["lse_abs"]


# ---------------------------------------------------------------------------
# K5's fp32 kernel (conv3x3_tf32_kernel): the same split product over the
# 9 * C contraction of a 3x3 conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kdim", [9 * 640, 9 * 1280])
def test_split_product_holds_the_conv_gate_where_one_tf32_product_does_not(kdim):
    """y = x W^T at K = 9 x 640 (the longest fp32-routed SD1.5 conv
    contraction) and 9 x 1280, weights scaled as a conv's (1 / (3 sqrt C))."""
    rng = np.random.default_rng(kdim)
    x = torch.from_numpy(rng.standard_normal((64, kdim)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, kdim)) / kdim ** 0.5).astype(np.float32))
    ref = x.double() @ w.double().t()
    tol = chip_smoke.CONV_F32_TOL
    got = split_matmul(x, w.t())
    assert float((got.double() - ref).abs().max()) <= tol["max_rel"] * float(ref.abs().max())
    assert _rel_l2(got, ref) <= tol["rel_l2"]
    one = (tf32(x).double() @ tf32(w).double().t()).float()
    assert _rel_l2(one, ref) > tol["rel_l2"]


def test_split_tap_major_weight_is_the_kernels_split():
    """``tap_major_split``: (2, 9, O, cp) [big; small] of the tap-major
    weight, channels zero-padded to a multiple of 8, each half what cvt.rna
    gives (the emulation above); big + small within 2^-21 of the weight."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((70, 20, 3, 3)).astype(np.float32))
    got = tconv.tap_major_split(w)
    assert got.shape == (2, 9, 70, 24) and got.dtype == torch.float32
    w9 = w.permute(2, 3, 0, 1).reshape(9, 70, 20)
    big, small = split(w9)
    assert torch.equal(got[0, ..., :20], big) and torch.equal(got[1, ..., :20], small)
    assert not got[..., 20:].any()
    assert float((got[0, ..., :20].double() + got[1, ..., :20] - w9.double()).abs().max()
                 / w9.abs().max()) <= 2 ** -21


def test_split_tap_major_cache_copies_once_and_refreshes_in_place():
    """The split copy is cached beside the tap-major ones: a second call
    makes no copy, an in-place update makes the next call copy afresh, and
    ``refresh_tap_major`` rewrites the cached tensor in place."""
    w = torch.randn((64, 16, 3, 3))
    before = tconv.tap_major_copies
    first = tconv.tap_major_split(w)
    assert tconv.tap_major_split(w) is first and tconv.tap_major_copies == before + 1
    w.add_(1.0)
    tconv.refresh_tap_major(w)
    assert tconv.tap_major_copies == before + 2
    assert tconv.tap_major_split(w) is first  # current again, the same tensor
    assert torch.equal(first, tconv._reordered(w, tconv.SPLIT))


# ---------------------------------------------------------------------------
# the fp32 kernels' grid rules (lora_matmul.plan_f32, conv3x3.plan_f32),
# checked in pure Python at every SD1.5 shape they meet
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use on an H100 (227 KB)
LORA_F32_SHAPES = sorted({s[:3] for s in chip_smoke.LORA_SHAPES + chip_smoke.LORA_TRAIN_SHAPES
                          + [chip_smoke.TEXT_LORA_ROW]})


def _fp32_convs():
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig

    return sorted({s for b in (2, 1) for s in chip_smoke.unet_conv3x3_calls(
        UNetConfig.sd15(), b, chip_smoke.IMAGE // 8, itemsize=4)})


def _check_splits(splits, steps):
    runs = _grid.split_steps(steps, splits)
    assert 1 <= splits <= steps
    assert runs[0][0] == 0 and runs[-1][1] == steps
    assert all(a < b for a, b in runs) and all(runs[i][1] == runs[i + 1][0]
                                               for i in range(len(runs) - 1))


@pytest.mark.parametrize("m,k,n", LORA_F32_SHAPES)
def test_lora_f32_plan_covers_fits_and_sizes_its_scratch(m, k, n):
    bm, bn, splits = tlm.plan_f32(m, n, k)
    assert (bm, bn) in tlm.TILES
    covered = np.zeros((m, n), dtype=np.int64)
    for i in range(_grid.cdiv(m, bm)):
        for j in range(_grid.cdiv(n, bn)):
            covered[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += 1
    assert (covered == 1).all()
    _check_splits(splits, _grid.cdiv(k, tlm.K_STEP_F32))
    # csrc/lora_matmul.cu:TileF32::smem: a ring of 3 stages (128-row tiles)
    # or 4 of [big; small] x (bm x 32), W (bn x 32) and down (16 x 32) fp32,
    # the up tile (16 x bn fp32), barriers and 1024 bytes of alignment slack
    stages = 3 if bm == 128 else 4
    smem = 1024 + stages * 2 * (bm + bn + 16) * 32 * 4 + 16 * bn * 4 + 16 * stages + 16
    assert smem <= SMEM_LIMIT
    kp = -(-k // 8) * 8
    assert tlm.f32_scratch_floats(m, n, k, 4) == 2 * kp * (m + n + 4)
    assert tlm.f32_scratch_floats(m, n, k, 4, True) == 2 * kp * (m + 4)
    tiles = -(-m // bm) * -(-n // bn)
    assert tlm.part_floats(m, n, (bm, bn, splits)) == splits * tiles * bm * (bn + 16)


@pytest.mark.parametrize("shape", _fp32_convs())
def test_conv_f32_plan_covers_fits_and_sizes_its_scratch(shape):
    b, c, h, w, o = shape
    p = tconv.plan_f32(b, c, h, w, o)
    assert p.box in tconv.F32_BOXES and p.box * p.rows == tconv.PIXELS
    blocks = _grid.cdiv(o, tconv.CHANNELS)
    per_image = _grid.cdiv(h, p.rows) * p.col_tiles
    assert p.tiles == b * per_image * blocks
    covered = np.zeros((b, o, h, w), dtype=np.int64)
    for tile in range(b * per_image):  # blockIdx.x, as the kernel reads it
        img, rem = divmod(tile, per_image)
        h0, w0 = (rem // p.col_tiles) * p.rows, (rem % p.col_tiles) * p.box
        for ob in range(blocks):  # blockIdx.y
            covered[img, ob * 64:(ob + 1) * 64, h0:h0 + p.rows, w0:w0 + p.box] += 1
    assert (covered == 1).all()
    _check_splits(p.splits, 9 * _grid.cdiv(tconv.f32_channels(c), tconv.C_STEP_F32))
    # csrc/conv3x3.cu:ConvTileF32::smem: 4 stages of [big; small] weight (64
    # x 32) and pixel (128 x 32) fp32 tiles, barriers and alignment slack
    assert 1024 + 4 * 2 * (64 + 128) * 32 * 4 + 16 * 4 + 16 <= SMEM_LIMIT
    assert tconv.f32_scratch_floats(b, c, h, w) == 2 * b * h * w * (-(-c // 8) * 8)
    assert tconv.part_floats(p) == p.splits * p.tiles * 64 * 128


def test_fp32_routes_reach_only_entry_points_that_exist():
    """The fp32 FMA kernels are gone from the sources, and every C entry
    point the K2 and K5 wrappers name is defined in its source."""
    import inspect
    import re
    from pathlib import Path

    csrc = Path(tlm.__file__).resolve().parent.parent / "csrc"
    for src, module in (("lora_matmul.cu", tlm), ("conv3x3.cu", tconv)):
        text = (csrc / src).read_text()
        assert "lora_dense_f32_kernel" not in text and "conv3x3_f32_kernel" not in text
        assert "tf32_kernel" in text
        named = set(re.findall(r'_kernel\("(dft_\w+)"', inspect.getsource(module)))
        assert named and all(f'extern "C" int {sym}(' in text for sym in named)
    assert {"dft_lora_dense_f32"} <= set(re.findall(r'_kernel\("(dft_\w+)"',
                                                    inspect.getsource(tlm)))
    assert {"dft_conv3x3_f32"} <= set(re.findall(r'_kernel\("(dft_\w+)"',
                                                 inspect.getsource(tconv)))


@pytest.mark.parametrize("tiles,splits", [(40, 3), (80, 3), (160, 3), (320, 2), (480, 1)])
def test_conv_f32_splits_fill_whole_waves(tiles, splits):
    """K5 fp32's split rule at the tile counts of SD1.5's fp32 convs (as
    measured best on the card), and at a grid whose waves are already full;
    a k-loop too short for a split stays whole."""
    assert _grid.wave_splits(tiles, 9 * 20, 4, 3) == splits
    assert _grid.wave_splits(tiles, 7, 4, 3) == 1
