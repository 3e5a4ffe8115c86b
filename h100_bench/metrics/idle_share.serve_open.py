"""1 - union of device operations / traced window."""

from h100_bench.harness import readers as R


def read(m):
    return R.idle_share(m)
