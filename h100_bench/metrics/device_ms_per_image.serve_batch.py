"""Device-busy ms per image dispatched in the traced window."""

from h100_bench.harness import readers as R


def read(m):
    return R.device_ms_per_image(m)
