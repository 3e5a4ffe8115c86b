"""K2 (fused LoRA dense) share of its roofline over the calls the dispatched batches imply."""

from h100_bench.harness import readers as R


def read(m):
    return R.k2_serve_roofline(m)
