"""Train, validate or generate the test set from a YAML config, as the JAX
package's ``run.py`` does:

    python -m speech_editing_tpu_torch.run --config egs/spec_denoiser.yaml \
        --exp_name NAME [-hp k=v,...] [--validate | --infer] [--reset] [--remove] \
        [--device cpu]

The config's ``task_cls`` names the task; the port resolves it by class
name among its own tasks (``TASKS``) and never imports the named module.
It runs on the GPU unless ``--device cpu`` is given. The ported tasks are
the six editing families of ``egs/``: FluentSpeech (``spec_denoiser``),
StutterSpeech and its stutter predictor, CampNet, A3T and EditSpeech; and
HiFi-GAN's GAN training (``HifiGanTask``, ``egs/hifigan.yaml``: the
generator against the multi-period and multi-scale discriminators on a
mel + wav corpus; ``--infer`` is copy synthesis of the test split); and
the TTS baselines FastSpeech, FastSpeech2-orig and DiffSpeech
(``egs/{fs,fs2_orig,diffspeech}.yaml``; one sentence from text:
``infer/tts_infer.py``); and the PortaSpeech family
(``egs/{ps,ps_flow,ps_adv}.yaml``: PortaSpeech, PortaSpeech-flow and
adversarial PortaSpeech on a corpus with word fields; ``--infer`` is its
inference entry point). The shipped ``egs/spec_denoiser.yaml`` sets
``use_bf16: true``: its steps run in bf16 against float32 master weights
(``training/train_state.py``), its validation and ``--infer`` in float32,
as in the JAX package; ``-hp use_bf16=False`` trains it in float32 (the
other configs train in float32 as shipped).

On N GPUs, launch it through torchrun, one rank a GPU:

    torchrun --nproc_per_node N -m speech_editing_tpu_torch.run \
        --config egs/spec_denoiser.yaml --exp_name NAME [-hp tp_size=2,...]

Under torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) ``run`` joins the job over NCCL and
trains on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the CPU), data
parallel, or with ``tp_size`` ranks a model group tensor parallel
(``training/trainer.py``); rank 0 alone prints and writes. ``--infer``
runs single-process.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import torch.distributed as dist

from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams
from speech_editing_tpu_torch.parallel.mesh import init_distributed
from speech_editing_tpu_torch.training.tasks.a3t import A3TTask
from speech_editing_tpu_torch.training.tasks.campnet import CampNetTask
from speech_editing_tpu_torch.training.tasks.editspeech import EditSpeechTask
from speech_editing_tpu_torch.training.tasks.hifigan import HifiGanTask
from speech_editing_tpu_torch.training.tasks.portaspeech import (PortaSpeechFlowTask,
                                                                 PortaSpeechTask)
from speech_editing_tpu_torch.training.tasks.ps_adv import PortaSpeechAdvTask
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.tasks.stutter_speech import (StutterPredictorTask,
                                                                    StutterSpeechTask)
from speech_editing_tpu_torch.training.tasks.tts import (DiffSpeechTask, FastSpeech2OrigTask,
                                                         FastSpeechTask)
from speech_editing_tpu_torch.training.trainer import Trainer, cuda_or_cpu, float32_on_card

TASKS = {cls.__name__: cls for cls in (SpecDenoiserTask, StutterSpeechTask,
                                       StutterPredictorTask, CampNetTask, A3TTask,
                                       EditSpeechTask, HifiGanTask, FastSpeechTask,
                                       FastSpeech2OrigTask, DiffSpeechTask, PortaSpeechTask,
                                       PortaSpeechFlowTask, PortaSpeechAdvTask)}


def task_class(task_cls: str):
    """The port's task named by the last part of a ``task_cls`` string."""
    name = task_cls.rsplit(".", 1)[-1]
    if name not in TASKS:
        raise ValueError(f"task_cls {task_cls!r}: the port has no task {name!r} "
                         f"(ported: {sorted(TASKS)})")
    return TASKS[name]


def run(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), then train, or validate
    with ``--validate``, or with ``--infer`` (or ``infer: true``) generate
    the test set (``Trainer.test``); returns the trainer. The trainer's
logging (terminal log, TensorBoard, validation media, ``save_codes``)
starts with training (``Trainer.fit``)."""
    parser = arg_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    joined = "RANK" in os.environ and not dist.is_initialized()
    if joined:      # a torchrun rank: cuda:LOCAL_RANK unless --device says otherwise
        device = init_distributed(device=None if args.device == "cuda" else args.device)
    else:
        device = cuda_or_cpu(args.device, "run")
    main = not dist.is_initialized() or dist.get_rank() == 0
    try:
        float32_on_card()
        if main:        # rank 0 resolves and saves the config before the others read it
            hp = set_hparams(args)
        if dist.is_initialized():
            dist.barrier()
        if not main:
            hp = set_hparams(args, print_hparams=False, save_config=False)
        if not hp.get("task_cls"):
            raise ValueError("the config must set task_cls")
        task = task_class(hp["task_cls"])(hp)
        if main:
            print(f"| Task: {type(task).__name__}", flush=True)
        trainer = Trainer(task, hp, device)
        if hp["infer"]:
            trainer.test()
        elif hp["validate"]:
            trainer.validate_only()
        else:
            trainer.fit()
        return trainer
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    run()
