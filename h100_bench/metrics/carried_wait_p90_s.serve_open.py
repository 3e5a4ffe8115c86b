"""p90 of the time a request was held by the worker, taken off the queue
until its batch was dispatched: behind another adapter's batch, split down
the batch ladder, or in its own batch's coalescing wait (the program's
``server.request`` spans, ``carried_s``)."""

from h100_bench.harness import program_spans as PS


def read(m):
    return PS.request_wait_p90(m, "carried_s")
