"""Host ms in the program's ``pipe.prepare`` spans (those with the
``towers`` attribute) per ``server.batch``."""

from h100_bench.harness import sdxl_flops as X


def read(m):
    return X.prepare_ms_per_batch(m)
