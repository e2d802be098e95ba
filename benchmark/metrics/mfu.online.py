"""mfu.online: model FLOPs of the real rows of the diff chunks (conditioner,
eight DiffNet passes, HiFi-GAN) over the union of those chunks' host intervals,
over the TF32 peak, in %."""

from benchmark.readers import serve_mfu


def read(run):
    return serve_mfu(run, "diff")
