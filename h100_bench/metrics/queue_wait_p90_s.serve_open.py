"""90th percentile of submit -> dispatch of the request's batch."""

from h100_bench.harness import readers as R


def read(m):
    return R.queue_wait_p90(m)
