"""p90 of the time a request sat in the server's queue, submit until the
worker took it (the program's ``server.request`` spans, ``queued_s``)."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.request_wait_p90(m, "queued_s")
