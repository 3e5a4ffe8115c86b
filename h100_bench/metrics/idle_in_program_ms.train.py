"""Device-idle ms per train step that fell inside a program span other
than the loader's ``data.wait`` (the trace's gaps by the innermost span at
their middle)."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.idle_in_program_ms(m, "step", leave_out=("data.wait",))
