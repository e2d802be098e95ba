"""Evaluation on the host, numpy and scipy: MCD (wav and mel level),
STOI, PESQ (the ``pesq`` package, else a numpy model), DTW and attention
diagnostics; the port's copy of the JAX package's ``evals/``. Batch
drivers: ``python -m speech_editing_tpu_torch.evals.get_metrics`` and
``python -m speech_editing_tpu_torch.evals.batch_tools``."""

from speech_editing_tpu_torch.evals.dtw import dtw_path
from speech_editing_tpu_torch.evals.mcd import cal_mcd, cal_mcd_with_wave_batch, get_metrics_mels
from speech_editing_tpu_torch.evals.stoi import cal_stoi_with_waves_batch, stoi

__all__ = ["dtw_path", "cal_mcd", "cal_mcd_with_wave_batch", "get_metrics_mels",
           "cal_stoi_with_waves_batch", "stoi"]
