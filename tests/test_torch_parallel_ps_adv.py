"""PyTorch port, adversarial PortaSpeech on two gloo ranks on the CPU:
``run`` on ``egs/ps_adv.yaml`` at tiny widths under torchrun's environment
(each rank its rows of the global batch, both nets' gradients summed over
the ranks, every loss the global batch's, the posterior's noise, dropout
and the windows' starts drawn for the global batch) writes a checkpoint
(both nets, both optimizers) equal to a single-process run's within 1e-5.
The batches have four rows, so no padding row enters the means."""

import os


from tests import torch_parallel_workers as workers
from tests.test_torch_ps_tasks import REPO, TINY, corpus  # noqa: F401
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)


def test_two_rank_ps_adv_step_matches_one_process(corpus, tmp_path):
    argv = ["--config", os.path.join(REPO, "egs", "ps_adv.yaml"), "--device", "cpu", "-hp",
            f"binary_data_dir={corpus},{TINY},max_updates=1,val_check_interval=1"]
    single, got = workers.single_and_two_ranks(argv, str(tmp_path / "single"),
                                               str(tmp_path / "multi"))
    assert single.global_step == got[0]["step"] == got[1]["step"] == 1
    assert got[0]["mesh"] == "data=2"
    workers.assert_same_checkpoint(str(tmp_path / "single"), str(tmp_path / "multi"))
