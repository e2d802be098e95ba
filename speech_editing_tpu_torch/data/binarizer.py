"""Binarizer: ``metadata.json`` and the aligner's TextGrids -> the binary
corpus that the port trains on. The port of the JAX package's
``data/binarizer.py``:

    python -m speech_editing_tpu_torch.data.binarizer --config egs/spec_denoiser.yaml \
        [-hp ...] [--device cpu]

Per split (valid, test, train: index ranges of the items, optionally
shuffled) and item: the log-mel (host ``wav2spec``) of the wav, which is
then kept as float16; the stutter labels of a ``stutter_set`` corpus; the
MFA alignment (``mel2ph``, ``dur``, ``mel2word``, ``dur_word``) with an
optional BOS/EOS trim; f0, coarse pitch and optional CWT targets from the
float16 wav. Then the speaker embeddings (``with_spk_embed``): resemblyzer
when it imports, else the port's :class:`VoiceEncoderCtx` from the
resemblyzer-format checkpoint named by ``VOICE_ENCODER_CKPT``, both on
the binarizer's device (the GPU unless ``--device cpu``), in this process
and in item order; else a spectral-statistics embedding. Output:
``{prefix}.data``/``.idx`` (``IndexedDatasetBuilder``, readable by the
JAX package), ``{prefix}_lengths.npy`` and ``{prefix}_ph_lengths.npy``.
The per-item work runs in spawned worker processes (``N_PROC``).
"""

from __future__ import annotations

import json
import os
import random
import shutil
import traceback
from typing import Any, Optional

import numpy as np

from speech_editing_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from speech_editing_tpu_torch.utils.audio.align import get_mel2ph, mel2token_to_dur
from speech_editing_tpu_torch.utils.audio.dsp import wav2spec
from speech_editing_tpu_torch.utils.audio.pitch import extract_pitch, f0_to_coarse_host
from speech_editing_tpu_torch.utils.multiprocess import multiprocess_run_tqdm


class BinarizationError(Exception):
    pass


DEFAULT_TEXT2MEL = {
    "fft_size": 1024, "hop_size": 256, "win_size": 1024,
    "audio_num_mel_bins": 80, "fmin": 55, "fmax": 7600,
    "f0_min": 80, "f0_max": 600, "pitch_extractor": "autocorr",
    "audio_sample_rate": 22050, "loud_norm": False,
    "mfa_min_sil_duration": 0.1, "trim_eos_bos": False,
    "with_align": True, "with_f0": True, "with_f0cwt": False,
    "min_mel_length": 64,
}


class BaseBinarizer:
    """Binarizes ``hp``'s corpus; the speaker encoder runs on ``device``
    (default ``"cuda"``, which raises when there is no GPU)."""

    def __init__(self, hp: Optional[dict] = None, device: Any = "cuda"):
        from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card

        self.device = cuda_or_cpu(device, "binarizer")
        if self.device.type == "cuda":
            float32_on_card()   # cuDNN's LSTM in float32, as the CPU computes it
        hp = hp or {}
        self.hp = hp
        self.dataset_name = hp.get("ds_name", "vctk")
        self.processed_data_dir = hp.get("processed_data_dir",
                                         f"data/processed/{self.dataset_name}")
        self.binary_data_dir = hp.get("binary_data_dir", f"data/binary/{self.dataset_name}")
        self.items: dict = {}
        self.item_names: list = []
        self.shuffle = hp.get("binarize_shuffle", False)
        self.with_spk_embed = hp.get("with_spk_embed", True)
        self.with_wav = hp.get("with_wav", False)
        self.with_stutter = hp.get("with_stutter_label", self.dataset_name == "stutter_set")
        self.valid_range = hp.get("valid_range", [0, 400])
        self.test_range = hp.get("test_range", [0, 400])
        self.train_range = hp.get("train_range", [400, -1])
        self.text2mel_params = dict(DEFAULT_TEXT2MEL)
        for k in self.text2mel_params:
            if k in hp:
                self.text2mel_params[k] = hp[k]
        self.text2mel_params["dataset_name"] = self.dataset_name
        self.text2mel_params["processed_data_dir"] = self.processed_data_dir
        self._spk_ctx: Optional[dict] = None

    def load_meta_data(self) -> None:
        with open(f"{self.processed_data_dir}/metadata.json") as f:
            items_list = json.load(f)
        for r in items_list:
            self.items[r["item_name"]] = r
            self.item_names.append(r["item_name"])
        if self.shuffle:
            random.seed(1234)
            random.shuffle(self.item_names)

    def _convert_range(self, range_) -> list:
        r = list(range_)
        if r[1] == -1:
            r[1] = len(self.item_names)
        return r

    def meta_data(self, prefix: str):
        ranges = {"train": self.train_range, "valid": self.valid_range,
                  "test": self.test_range}[prefix]
        r = self._convert_range(ranges)
        for name in self.item_names[r[0]: r[1]]:
            yield self.items[name]

    @classmethod
    def process_item(cls, item: dict, text2mel_params: dict, **kw) -> Optional[dict]:
        """One item's features; ``None`` (with the reason printed) when it
        is skipped."""
        item = dict(item)
        item_name, wav_fn = item["item_name"], item["wav_fn"]
        try:
            wav, mel = cls.process_audio(wav_fn, item, text2mel_params)
            if mel.shape[0] < text2mel_params.get("min_mel_length", 0):
                raise BinarizationError(f"mel too short {mel.shape[0]}")
            if text2mel_params.get("dataset_name") == "stutter_set" and \
                    kw.get("with_stutter", True):
                cls.process_stutter_label(wav, mel, item, text2mel_params)
            if text2mel_params["with_align"]:
                tg_dir = f"{text2mel_params['processed_data_dir']}/mfa_outputs"
                cls.process_align(f"{tg_dir}/{item_name}.TextGrid", item, text2mel_params)
                if text2mel_params.get("trim_eos_bos"):
                    cls.trim_eos_bos(item, text2mel_params)
            if text2mel_params["with_f0"]:
                cls.process_pitch(item, text2mel_params)
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            return None
        except Exception:
            traceback.print_exc()
            print(f"| Skip item. item_name: {item_name}")
            return None
        return item

    @classmethod
    def process_audio(cls, wav_fn: str, res: dict, p: dict):
        d = wav2spec(wav_fn, fft_size=p["fft_size"], hop_size=p["hop_size"],
                     win_length=p["win_size"], num_mels=p["audio_num_mel_bins"],
                     fmin=p["fmin"], fmax=p["fmax"], sample_rate=p["audio_sample_rate"],
                     loud_norm=p["loud_norm"], backend=p.get("dsp_backend", "auto"))
        mel = d["mel"]
        wav = d["wav"].astype(np.float16)
        res.update({"mel": mel, "wav": wav, "sec": len(wav) / p["audio_sample_rate"],
                    "len": mel.shape[0]})
        return wav, mel

    @classmethod
    def process_stutter_label(cls, wav, mel, res: dict, p: dict) -> None:
        """Frame mask of the labelled stutter spans ``[start s, end s,
        type]`` under ``stutter_labels/<first 17 chars>/<item>.npy``."""
        stutter_fn = (f"{p['processed_data_dir']}/stutter_labels/"
                      f"{res['item_name'][:17]}/{res['item_name']}.npy")
        stutter_mel_mask = np.zeros(mel.shape[0])
        if os.path.exists(stutter_fn):
            for s in np.load(stutter_fn):
                s0 = int(s[0] * p["audio_sample_rate"] // p["hop_size"])
                s1 = int(s[1] * p["audio_sample_rate"] // p["hop_size"])
                stutter_mel_mask[s0:s1] = 1 if s[2] != 0 else 0
        res["stutter_mel_mask"] = stutter_mel_mask

    @staticmethod
    def process_align(tg_fn: str, item: dict, p: dict) -> None:
        if tg_fn is None or not os.path.exists(tg_fn):
            raise BinarizationError("Align not found")
        mel2ph, dur = get_mel2ph(tg_fn, item["ph"], item["mel"], p["hop_size"],
                                 p["audio_sample_rate"], p["mfa_min_sil_duration"])
        if np.array(mel2ph).max() - 1 >= len(item["ph_token"]):
            raise BinarizationError(f"Align mismatch: {np.array(mel2ph).max() - 1} vs "
                                    f"{len(item['ph_token'])}")
        item["mel2ph"] = mel2ph
        item["dur"] = dur
        mel2word = [item["ph2word"][m - 1] for m in mel2ph]
        item["mel2word"] = mel2word
        item["dur_word"] = mel2token_to_dur(np.asarray(mel2word),
                                            len(item["word_token"])).tolist()

    @staticmethod
    def trim_eos_bos(item: dict, p: dict) -> None:
        """Drops the first and the last phone's frames (BOS, EOS) from mel,
        mel2ph, mel2word and the wav, and their entries of dur and dur_word;
        the token sequences are not re-indexed."""
        n_bos, n_eos = int(item["dur"][0]), int(item["dur"][-1])
        t = len(item["mel"])
        item["mel"] = item["mel"][n_bos: t - n_eos]
        item["mel2ph"] = list(item["mel2ph"])[n_bos: t - n_eos]
        item["mel2word"] = list(item["mel2word"])[n_bos: t - n_eos]
        item["dur"] = list(item["dur"])[1:-1]
        item["dur_word"] = list(item["dur_word"])[1:-1]
        item["len"] = item["mel"].shape[0]
        hop, wav = p["hop_size"], item["wav"]
        item["wav"] = wav[n_bos * hop: len(wav) - n_eos * hop]

    @staticmethod
    def process_pitch(item: dict, p: dict) -> None:
        wav, mel = item["wav"], item["mel"]
        f0 = extract_pitch(p["pitch_extractor"], wav.astype(np.float32), p["hop_size"],
                           p["audio_sample_rate"], f0_min=p["f0_min"], f0_max=p["f0_max"])
        f0 = f0[: len(mel)]
        if len(f0) < len(mel):
            f0 = np.pad(f0, (0, len(mel) - len(f0)))
        if sum(f0) == 0:
            raise BinarizationError("Empty f0")
        item["f0"] = f0
        item["pitch"] = f0_to_coarse_host(f0)
        if p.get("with_f0cwt"):
            from speech_editing_tpu_torch.utils.audio.cwt import f0_to_cwt

            d = f0_to_cwt(f0)
            item["cwt_spec"], item["cwt_mean"], item["cwt_std"] = (
                d["cwt_spec"], d["cwt_mean"], d["cwt_std"])

    @staticmethod
    def get_spk_embed(wav, ctx=None, sample_rate: int = 22050, **kw) -> np.ndarray:
        """The 256-d speaker embedding of ``wav``: ``ctx["voice_encoder"]``'s
        when there is one, else pooled spectral statistics (the mean and
        std of ``wav2spec``'s log-mel at its defaults, zero-padded to 256,
        L2-normalised)."""
        wav = np.asarray(wav, np.float32)
        if ctx and "voice_encoder" in ctx:
            enc = ctx["voice_encoder"]
            try:    # the port's encoder resamples from the corpus's rate
                return enc.embed_utterance(wav.astype(np.float64), source_sr=sample_rate)
            except TypeError:   # resemblyzer's signature has no source_sr
                return enc.embed_utterance(wav.astype(np.float64))
        mel = wav2spec(wav)["mel"]
        emb = np.concatenate([mel.mean(0), mel.std(0), np.zeros(96)])[:256]
        return (emb / (np.linalg.norm(emb) + 1e-8)).astype(np.float32)

    @staticmethod
    def _spk_encoder_ctx(device: Any) -> dict:
        """``{"voice_encoder": ...}`` on ``device``: resemblyzer's when it
        imports, else the port's from ``VOICE_ENCODER_CKPT``; else ``{}``
        (the spectral fallback)."""
        try:
            from resemblyzer import VoiceEncoder  # type: ignore
        except ImportError:
            pass
        else:
            return {"voice_encoder": VoiceEncoder(device=str(device))}
        ckpt = os.environ.get("VOICE_ENCODER_CKPT", "")
        if ckpt and os.path.exists(ckpt):
            from speech_editing_tpu_torch.models.voice_encoder import load_voice_encoder

            try:
                return {"voice_encoder": load_voice_encoder(ckpt, device)}
            except (OSError, RuntimeError, KeyError, ValueError) as e:
                print(f"| voice encoder ckpt load failed: {e}")
        return {}

    def process(self) -> None:
        self.load_meta_data()
        os.makedirs(self.binary_data_dir, exist_ok=True)
        for fn in ("phone_set.json", "word_set.json", "spk_map.json"):
            src = f"{self.processed_data_dir}/{fn}"
            if os.path.exists(src):
                shutil.copyfile(src, f"{self.binary_data_dir}/{fn}")
        self.process_data("valid")
        self.process_data("test")
        self.process_data("train")

    def process_data(self, prefix: str) -> None:
        builder = IndexedDatasetBuilder(f"{self.binary_data_dir}/{prefix}")
        args = [{"item": it, "text2mel_params": self.text2mel_params,
                 "with_stutter": self.with_stutter} for it in self.meta_data(prefix)]
        items = [item for _, item in multiprocess_run_tqdm(self.process_item, args,
                                                           desc=f"Binarize {prefix}")
                 if item is not None]
        if self.with_spk_embed:
            sr = int(self.text2mel_params.get("audio_sample_rate", 22050))
            if self._spk_ctx is None:     # one encoder for every split
                self._spk_ctx = self._spk_encoder_ctx(self.device)
            for item in items:
                item["spk_embed"] = self.get_spk_embed(item["wav"], self._spk_ctx, sr)

        mel_lengths, ph_lengths, total_sec = [], [], 0.0
        for item in items:
            if not self.with_wav and "wav" in item:
                del item["wav"]
            builder.add_item(item)
            mel_lengths.append(item["len"])
            if "ph_token" in item:
                ph_lengths.append(len(item["ph_token"]))
            total_sec += item["sec"]
        builder.finalize()
        np.save(f"{self.binary_data_dir}/{prefix}_lengths.npy", mel_lengths)
        if ph_lengths:
            np.save(f"{self.binary_data_dir}/{prefix}_ph_lengths.npy", ph_lengths)
        print(f"| {prefix}: {len(items)} items, {total_sec:.1f}s audio")


def main(argv=None) -> None:
    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams

    parser = arg_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    BaseBinarizer(set_hparams(args, print_hparams=False), args.device).process()


if __name__ == "__main__":
    main()
