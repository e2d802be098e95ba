"""setup_s: seconds from the process's start to the window's (loading,
corpus and weights, kernel builds, warm-up)."""


def read(run):
    return run.setup_s
