"""Mean ms a step waited on the DataLoader's next()."""

from h100_bench.harness import readers as R


def read(m):
    return R.loader_wait_ms(m)
