"""Share of the loader's waits (``data.wait``) that found its prefetch
queue empty."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.prefetch_miss_share(m)
