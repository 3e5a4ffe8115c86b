"""Model operations of the images dispatched in the traced window over (window x peak)."""

from h100_bench.harness import readers as R


def read(m):
    return R.serve_mfu(m)
