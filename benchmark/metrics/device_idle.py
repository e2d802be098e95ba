"""device_idle.<kind>: the traced window's share, in %, in which no device
operation ran. Read for every ``device_idle.*`` metric without a file of its
own."""

from benchmark.readers import device_idle


def read(run):
    return device_idle(run)
