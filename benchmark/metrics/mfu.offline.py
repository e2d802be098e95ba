"""mfu.offline: model FLOPs of every request whose result arrived in the
window outside its traced part (CampNet's forward at the request's frames
and tokens, HiFi-GAN), over those seconds, over the TF32 peak, in %."""

from benchmark.readers import completed_mfu


def read(run):
    return completed_mfu(run)
