"""Mean host ms of the server's ``server.batch`` span, first request taken
to generation launched, less its ``server.coalesce`` wait."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.batch_host_ms(m)
