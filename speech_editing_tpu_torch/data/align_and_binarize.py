"""The offline data pipeline in one command: preprocess -> MFA alignment
-> binarize. The port of the JAX package's ``data/align_and_binarize.py``:

    python -m speech_editing_tpu_torch.data.align_and_binarize \
        --config egs/spec_denoiser.yaml [-hp ...] [--skip-align] [--mfa-jobs N] \
        [--device cpu]

The MFA stage runs the repository's ``scripts/run_mfa_train_align.sh``
(MFA is an external binary). It is skipped with ``--skip-align``, or when
``<processed_data_dir>/mfa_outputs`` already holds TextGrids (unless
``reuse_align`` is false); otherwise a missing ``mfa`` fails the command:
binarizing without alignments would give a corpus with no ``mel2ph``.
``--device`` (default ``cuda``, which raises when there is no GPU) is the
binarizer's, where the speaker encoder runs.
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import Any, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def align_and_binarize(hp: dict, skip_align: bool = False, mfa_jobs: Optional[int] = None,
                       device: Any = "cuda") -> None:
    from speech_editing_tpu_torch.data.binarizer import BaseBinarizer
    from speech_editing_tpu_torch.data.preprocess import BasePreprocessor
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu

    device = cuda_or_cpu(device, "align_and_binarize")
    pre = BasePreprocessor(dict(hp))
    processed_dir = pre.processed_dir
    print(f"| [1/3] preprocess -> {processed_dir}")
    pre.process()

    tg_dir = os.path.join(processed_dir, "mfa_outputs")
    have_tgs = bool(glob.glob(os.path.join(tg_dir, "*.TextGrid")))
    if skip_align or (have_tgs and hp.get("reuse_align", True)):
        why = "--skip-align" if skip_align else f"TextGrids present in {tg_dir}"
        print(f"| [2/3] MFA align skipped ({why})")
    else:
        script = os.path.join(REPO, "scripts", "run_mfa_train_align.sh")
        jobs = mfa_jobs or int(os.environ.get("N_PROC", os.cpu_count() or 1))
        print(f"| [2/3] MFA align ({jobs} jobs)")
        subprocess.check_call(["bash", script, processed_dir, str(jobs)])

    print("| [3/3] binarize")
    BaseBinarizer(dict(hp), device).process()


def main(argv=None) -> None:
    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams

    parser = arg_parser()
    parser.description = "preprocess -> MFA align -> binarize in one command"
    parser.add_argument("--skip-align", action="store_true",
                        help="binarize with pre-existing TextGrids only")
    parser.add_argument("--mfa-jobs", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    align_and_binarize(set_hparams(args, print_hparams=False), skip_align=args.skip_align,
                       mfa_jobs=args.mfa_jobs, device=args.device)


if __name__ == "__main__":
    main()
