"""K2 (fused LoRA dense) share of its roofline over the calls SDXL's
dispatched batches imply: 630 UNet projections a call, both towers'."""

from h100_bench.harness import sdxl_flops as X


def read(m):
    return X.k2_roofline(m)
