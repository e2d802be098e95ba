"""loader_wait_ms.train: mean host ms a window step waited on next(batches)
(the data loader's spawned workers)."""


def read(run):
    waits = run.record.get("loader_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
