"""front_end_ms.<kind>: mean host ms a request spent in online_prepare (g2p,
the TextGrid, f0, the speaker embedding, bucketing). Read for every
``front_end_ms.*`` metric without a file of its own."""

from benchmark.readers import front_end_ms


def read(run):
    return front_end_ms(run)
