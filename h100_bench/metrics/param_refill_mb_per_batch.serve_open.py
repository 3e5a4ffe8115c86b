"""MB the graphs' parameter buffers were refilled with (``graph.refill``
``bytes``: adapter swaps) per dispatched batch (``server.batch``)."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.refill_mb_per_batch(m)
