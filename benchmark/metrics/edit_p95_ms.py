"""edit_p95_ms: the nearest-rank 95th percentile of the latency of every
request due in the window, from its due time to its result as the
benchmark's clock sees it; a failed request counts as missing (+inf)."""

from benchmark.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
