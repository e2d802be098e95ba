"""fill.<kind>: real rows over batch rows, over every chunk the online
scheduler launched in the window (OnlineEditServer.launches), in %. Read for
every ``fill.*`` metric without a file of its own."""

from benchmark.readers import fill


def read(run):
    return fill(run)
