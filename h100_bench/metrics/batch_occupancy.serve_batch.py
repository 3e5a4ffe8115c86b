"""Images per dispatched batch over the server's max_batch (closed-loop batch serving)."""

from h100_bench.harness import readers as R


def read(m):
    return R.batch_occupancy(m)
