"""The port's command-line tools, each run as ``python -m
speech_editing_tpu_torch.scripts.<name>``: ``e2e_acceptance`` (a family
learns on a structured synthetic corpus), ``quant_quality_ab`` (int8
weight-only serving against float32 on that model), ``copy_synthesis``
(wav -> mel -> vocoder -> wav) and ``make_example_audio`` (the demo wav of
``inference/example.csv``)."""
