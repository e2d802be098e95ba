"""queue_wait_ms.online: the 95th percentile over requests of the time from
entering each stage's queue to the start of that stage's chunk, summed over the
stages (the online scheduler)."""

from benchmark.readers import queue_wait_ms


def read(run):
    return queue_wait_ms(run, 95)
