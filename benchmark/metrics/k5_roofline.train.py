"""k5_roofline.train: K5's share of its roofline over the steps of the traced
window (its two launches at each step's real frames), in %."""

from benchmark.readers import step_roofline


def read(run):
    return step_roofline(run, "k5")
