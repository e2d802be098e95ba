"""k3_roofline.train: K3's share of its roofline over the steps of the traced
window: the least time of each step's nine calls (three over the tokens, six
over the frames, each over its rows' real keys; float32 products at the TF32
peak, bytes at HBM's) over their device time, in %."""

from benchmark.readers import step_roofline


def read(run):
    return step_roofline(run, "k3")
