"""mfu.train: model FLOPs of every step completed in the window (forward and
backward, three times the forward's products, no recomputation) over the
window's seconds, over the TF32 peak, in %."""

from benchmark.readers import train_mfu


def read(run):
    return train_mfu(run)
