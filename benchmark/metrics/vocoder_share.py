"""vocoder_share.<kind>: device time inside the spec2wav_batch_dev range over
all device time of the traced window, in %. Read for every
``vocoder_share.*`` metric without a file of its own."""

from benchmark.readers import vocoder_share


def read(run):
    return vocoder_share(run)
