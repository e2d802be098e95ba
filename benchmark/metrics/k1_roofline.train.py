"""k1_roofline.train: K1's share of its roofline over the steps of the traced
window (each launch at its step's real frames, writing h for K5; float32
products at the TF32 peak, bytes at HBM's), in %."""

from benchmark.readers import step_roofline


def read(run):
    return step_roofline(run, "k1")
