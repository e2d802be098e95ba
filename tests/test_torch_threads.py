"""The one-thread pin that every port test file imports.

The suite runs several pytest workers on the host's cores. A worker whose
torch steps on as many OpenMP threads as the host has cores oversubscribes
them: a Trainer step took 0.1-3 s alone and 9-42 s inside the suite. So each
port test file imports :func:`one_thread`, an autouse fixture of module
scope: it holds torch to one intra-op thread from before the file's first
fixture is built until after its last test, and sets ``OMP_NUM_THREADS=1``
for the processes those tests spawn (loader workers, gloo ranks), which
start torch afresh.
"""

import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def test_torch_runs_on_one_thread_here_and_in_spawned_processes():
    assert torch.get_num_threads() == 1
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "1"
