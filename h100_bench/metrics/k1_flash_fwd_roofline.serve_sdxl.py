"""K1 (flash forward) share of its roofline over the attention calls of
SDXL's 70 transformer blocks in the dispatched batches."""

from h100_bench.harness import sdxl_flops as X


def read(m):
    return X.k1_roofline(m)
