"""PyTorch port, HiFi-GAN's GAN training on two gloo ranks on the CPU: the
training entry ``run`` on ``egs/hifigan.yaml`` at tiny widths under
torchrun's environment (each rank its crops of the global batch, both
nets' gradients summed over the ranks, the LSGAN, feature-matching and mel
losses over the global batch) writes a checkpoint (both nets, both
optimizers) equal to a single-process run within 1e-5, rank 0 alone
printing and writing. The crops come in batches of two, so no padding row
enters the losses' means (the JAX package's means count padding rows,
which ``test_torch_parallel_mesh.py`` holds the port to)."""

import os

import numpy as np

from tests import torch_parallel_workers as workers
from tests.helpers import write_voc_corpus
from tests.test_torch_gan_trainer import TINY_HP as GAN_HP
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_rank_run_matches_one_process_hifigan(tmp_path):
    write_voc_corpus(str(tmp_path / "voc"), np.random.RandomState(1), hop=256)
    argv = ["--config", os.path.join(REPO, "egs", "hifigan.yaml"), "--device", "cpu", "-hp",
            f"binary_data_dir={tmp_path / 'voc'},{GAN_HP},max_updates=2"]
    work_s, work_m = str(tmp_path / "single"), str(tmp_path / "multi")
    single, got = workers.single_and_two_ranks(argv, work_s, work_m)
    assert single.global_step == got[0]["step"] == got[1]["step"] == 2
    assert got[0]["mesh"] == "data=2"
    workers.assert_same_checkpoint(work_s, work_m)
    workers.assert_rank0_alone_logs(got, work_m)
