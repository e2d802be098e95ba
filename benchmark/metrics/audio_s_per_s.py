"""audio_s_per_s: seconds of edited audio whose results arrived in the window,
over the window's seconds."""

from benchmark.readers import audio_s_per_s


def read(run):
    return audio_s_per_s(run)
