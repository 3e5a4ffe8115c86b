"""SDXL's operations of the images dispatched in the traced window (both
towers, the UNet over the CFG pair each step, the VAE decode, the LoRA
products) over (window x peak)."""

from h100_bench.harness import sdxl_flops as X


def read(m):
    return X.mfu(m)
