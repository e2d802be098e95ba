"""Optional wav stages of the preprocessor, applied before a wav is staged:
the port's copy of the JAX package's ``data/wav_processors.py``. Each
processor wraps a ``sox`` command; with ``sox`` absent (or a processor
unknown or failing) the stage is skipped with a warning and the wav passes
through unchanged."""

from __future__ import annotations

import os
import shutil
import subprocess

WAV_PROCESSORS: dict = {}


def register_wav_processors(name: str):
    def wrap(cls):
        WAV_PROCESSORS[name] = cls
        return cls
    return wrap


def get_wav_processor_cls(name: str):
    return WAV_PROCESSORS.get(name)


class BaseWavProcessor:
    name = "base"

    def output_fn(self, input_fn: str, tmp_dir: str) -> str:
        base = os.path.splitext(os.path.basename(input_fn))[0]
        return f"{tmp_dir}/{base}_{self.name}.wav"

    def process(self, input_fn: str, tmp_dir: str) -> str:
        raise NotImplementedError


@register_wav_processors("sox_to_wav")
class ConvertToWavProcessor(BaseWavProcessor):
    name = "ToWav"

    def process(self, input_fn, tmp_dir):
        if input_fn.endswith(".wav"):
            return input_fn
        out = self.output_fn(input_fn, tmp_dir)
        subprocess.run(["sox", "-v", "0.95", input_fn, out], check=True)
        return out


@register_wav_processors("sox_resample")
class ResampleProcessor(BaseWavProcessor):
    name = "Resample"

    def __init__(self, sample_rate: int = 22050):
        self.sample_rate = sample_rate

    def process(self, input_fn, tmp_dir):
        out = self.output_fn(input_fn, tmp_dir)
        subprocess.run(["sox", input_fn, "-r", str(self.sample_rate), out], check=True)
        return out


@register_wav_processors("trim_sil")
class TrimSILProcessor(BaseWavProcessor):
    name = "TrimSIL"

    def process(self, input_fn, tmp_dir):
        out = self.output_fn(input_fn, tmp_dir)
        subprocess.run(["sox", input_fn, out, "silence", "1", "0.1", "0.02%",
                        "reverse", "silence", "1", "0.1", "0.02%", "reverse"], check=True)
        return out


def run_wav_processors(wav_fn: str, tmp_dir: str, processor_names=()) -> str:
    """The named processors applied in order; the path of the last output."""
    fn = wav_fn
    for name in processor_names or ():
        cls = get_wav_processor_cls(name)
        if cls is None:
            print(f"| WARN unknown wav processor {name}; skipped")
            continue
        if shutil.which("sox") is None:
            print(f"| WARN sox not installed; {name} skipped")
            continue
        try:
            fn = cls().process(fn, tmp_dir)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"| WARN wav processor {name} failed ({e}); skipped")
    return fn
