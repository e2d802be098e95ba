"""Jobs for the worker-pool tests, in a module of their own: a spawned
worker imports the module of the function it runs, and this one imports
nothing heavy."""

import os


def ctx(pid):
    return {"pid": pid, "worker": os.getpid()}


def job(x, ctx=None):
    if x == 3:
        raise ValueError("job 3 fails")
    return x * x, ctx["worker"]
