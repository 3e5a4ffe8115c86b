"""Model operations of the window's steps over (window x peak of the cell's dtype)."""

from h100_bench.harness import readers as R


def read(m):
    return R.train_mfu(m)
