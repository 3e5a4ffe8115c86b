"""Device-idle ms per dispatched batch that fell inside a program span
(the trace's gaps by the innermost span at their middle)."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.idle_in_program_ms(m, "batch")
