"""K1 (flash forward) share of its roofline over the calls the dispatched batches imply."""

from h100_bench.harness import readers as R


def read(m):
    return R.k1_serve_roofline(m)
