"""The split fp32 product of the port's fp32 flash kernels, emulated on the
CPU with bit masks.

``csrc/split_f32.cuh``: each fp32 value x becomes big = tf32(x) and small =
tf32(x - big) (``cvt.rna.tf32.f32``: 10 explicit mantissa bits, to nearest,
ties away from zero), and a product a b becomes small_a big_b + big_a
small_b + big_a big_b, each product exact in fp32.  Here the three products
are summed in fp64 and rounded to fp32 once, so the error measured is the
split's own (the dropped small_a small_b and the rounding of the small
halves), against an fp64 reference, at the widest head dim the kernels take
(d = 160) and the longest SD1.5 contraction of the LoRA'd projections (K =
1280): inside ``chip_smoke.py``'s fp32 gates, where one TF32 product is not.
"""

import numpy as np
import torch

import chip_smoke


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
