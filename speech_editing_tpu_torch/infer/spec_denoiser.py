"""Region-edit inference, the user-facing CSV edit API (FluentSpeech): the
port of the JAX package's ``infer/spec_denoiser.py``.

    python -m speech_editing_tpu_torch.infer.spec_denoiser --config CONFIG \
        --exp_name NAME [-hp k=v,...] [--device cpu]

reads ``infer_csv`` (default ``inference/example.csv``; columns
id,item_name,text,edited_text,wav_fn_orig,edited_region,region), writes
the ``.lab`` files and dictionary lines for the Montreal Forced Aligner and
runs ``mfa align`` (unless ``mfa_align: false``, when the TextGrids must
already be in ``inference/audio/mfa_out``), then edits each row with the
last checkpoint of ``checkpoints/NAME`` and writes
``inference/out/<item_name>.wav`` and ``<item_name>_ref.wav``. It runs on
the GPU unless ``--device cpu`` is given.

Per request, on the host: g2p of both texts, word-region resolution, the
TextGrid's mel2ph, the log-mel (``wav2spec``) and f0 (``autocorr_pitch``)
of the source wav. Then two device programs: the duration predictor on the
edited phones, anchored by the durations of the untouched words
(``predict_durations``), whose durations are regulated on the host; the
frame-level splice [head | predicted edit | shifted tail] of alignment,
reference mel and f0/uv; and the reverse diffusion over the spliced frames
(kernel K1, ``timesteps`` x ``residual_layers`` launches), composited with
the reference mel outside the edit. Both the edited and the source mel are
vocoded.

A request's diffusion noise comes from a device ``torch.Generator`` seeded
by ``crc32(seed|item_name|ph|words_region|edited_words_region)``
(``request_generator``), drawn in one call at the request's exact frame
count (``request_noise``): it depends only on the seed and the request, as
the JAX package's ``request_prng_key`` does with threefry keys, which torch
cannot reproduce. The batch server (``infer/serving.py``, ``make_server``;
``serve_batched`` here) draws each row the same way and zero-pads it to its
bucket, so its exact-fit result is the per-item one. With
``serve_quant_int8`` both device programs run on int8 weights dequantized
once a call (``infer/quant.py``).
"""

from __future__ import annotations

import csv
import os
import shutil
import subprocess
import zlib
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from speech_editing_tpu_torch.infer.base_infer import BaseInfer
from speech_editing_tpu_torch.infer.infer_utils import (
    extract_f0_uv, get_align_from_mfa_output, get_words_region_from_origintxt_region,
    parse_region_list_from_str)
from speech_editing_tpu_torch.utils.text.processors import get_txt_processor_cls, txt_to_ph
from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme

def request_generator(seed: int, item: dict, device: Any) -> torch.Generator:
    """A generator on ``device`` seeded by the CRC-32 of ``seed`` and the
    request's identity: its name, phones and edit regions (32 bits: the
    CPU's generator keeps no more)."""
    ident = "|".join([str(seed), str(item.get("item_name", "")), item.get("ph", ""),
                      str(item.get("words_region", "")),
                      str(item.get("edited_words_region", ""))])
    return torch.Generator(device=device).manual_seed(zlib.crc32(ident.encode()))


def request_noise(gen: torch.Generator, steps: int, t: int, m: int) -> torch.Tensor:
    """A request's reverse-diffusion noise at its exact frame count ``t``,
    in one draw from its generator ``gen``: [steps + 1, t, m] on
    ``gen``'s device, the initial noise and then that of steps
    ``steps - 1`` .. 0 (``GaussianDiffusion.forward``). Torch's generators
    promise nothing across sizes, so a row padded to a bucket is drawn at
    its own length and zero-padded: the padded frames are masked out."""
    return torch.randn(steps + 1, t, m, generator=gen, device=gen.device)


def dur_inpaint_prep(item: dict):
    """Inputs for the duration-inpainting device program.

    Durations of untouched words anchor the predictor; the tail block is
    anchored by the EDITED sequence's tail size — if context-dependent g2p
    re-phonemized the tail differently, clamp to the overlap instead of
    writing through the changed region.

    Returns (masked_dur [S_edit], masked_mel2ph [T_orig],
    edit_frames [T_orig] bool).
    """
    mel2ph = item["mel2ph"]
    mel2word = item["mel2word"]
    dur = item["dur"]
    ph2word = item["ph2word"]
    edited_ph2word = item["edited_ph2word"]
    w0, w1 = item["words_region"][0]

    s_edit = len(edited_ph2word)
    c1 = item["edited_words_region"][0][1]
    masked_dur = np.zeros(s_edit, np.int64)
    n_head_ph = int(np.sum(ph2word < w0))
    masked_dur[:n_head_ph] = dur[:n_head_ph]
    n_tail_ph = min(int(np.sum(ph2word > w1)),
                    int(np.sum(edited_ph2word > c1)))
    if n_tail_ph > 0:
        masked_dur[-n_tail_ph:] = dur[-n_tail_ph:]

    edit_frames = (mel2word >= w0) & (mel2word <= w1)
    masked_mel2ph = np.where(edit_frames, 0, mel2ph)
    return masked_dur, masked_mel2ph, edit_frames


def dur_to_mel2ph(item: dict, dur_pred: np.ndarray, frames_multiple: int):
    """Length-regulate predicted durations on the host at the full predicted
    length (the model's regulator is bound to the source's frame count,
    which would truncate lengthening edits). Same numeric path as
    ops/seq_ops.length_regulator: round -> zero padding -> cumsum.

    Returns (edited_mel2ph_pred [T_pred], edited_mel2word [T_pred]).
    """
    dur_int = np.round(np.asarray(dur_pred, np.float32)).astype(np.int64)
    dur_int = dur_int * (item["edited_ph_token"] > 0)
    cum = np.cumsum(dur_int)
    fm = int(frames_multiple)
    t_pred = int(cum[-1]) // fm * fm  # clip_mel2token_to_multiple parity
    edited_mel2ph_pred = (np.searchsorted(
        cum, np.arange(t_pred), side="right") + 1).astype(np.int64)
    edited_mel2word = item["edited_ph2word"][edited_mel2ph_pred - 1]
    return edited_mel2ph_pred, edited_mel2word


def splice_edit(item: dict, edited_mel2ph_pred: np.ndarray,
                edited_mel2word: np.ndarray,
                frames_multiple: int) -> dict:
    """Frame-level splice [head | predicted edit | shifted tail]
    of alignment, ref mel, f0/uv, and the time mask,
    all floored to the ``frames_multiple`` grid the model clips to.

    Returns {mel2ph, ref_mels, f0, uv, time_mel_masks, t_new}.
    """
    mel = item["mel"]
    mel2ph = item["mel2ph"]
    mel2word = item["mel2word"]
    edited_ph2word = item["edited_ph2word"]
    f0, uv = item["f0"], item["uv"]
    w0, w1 = item["words_region"][0]
    c0, c1 = item["edited_words_region"][0]

    in_changed = (edited_mel2word >= c0) & (edited_mel2word <= c1)
    n_new = int(in_changed.sum())
    head_idx = int(np.sum((mel2word >= 1) & (mel2word < w0)))
    tail_mask = mel2word > w1
    tail_idx = head_idx + n_new
    t_new = head_idx + n_new + int(tail_mask.sum())

    # splice frame-level alignment [head | predicted edit | shifted tail]
    edited_mel2ph_full = np.zeros(t_new, np.int64)
    edited_mel2ph_full[:head_idx] = mel2ph[:head_idx]
    edited_mel2ph_full[head_idx:tail_idx] = edited_mel2ph_pred[in_changed]
    if tail_mask.any():
        # Map original tail phones 1:1 onto the edited sequence's tail
        # block: the words after the edit are identical in both texts, so
        # the phone ids differ by a constant offset. The reference's
        # `max(changed_pred)+2` heuristic (:107) assumes the predictor
        # emitted frames for the LAST changed phone and exactly one
        # separator phone follows — when it doesn't, ids overrun S_edit
        # and the expand gather goes out of bounds (NaN fill).
        ph2word = item["ph2word"]
        s_edit = len(edited_ph2word)
        n_tail_ph_orig = int(np.sum(ph2word > w1))
        n_tail_ph_edit = int(np.sum(edited_ph2word > c1))
        if n_tail_ph_orig != n_tail_ph_edit:
            # context-dependent g2p (POS homographs) re-phonemized the
            # unchanged tail differently — the constant offset no longer
            # holds; stretch by dense rank so ids stay in the tail block
            print(f"| WARN: tail g2p mismatch for "
                  f"{item.get('item_name')}: {n_tail_ph_orig} vs "
                  f"{n_tail_ph_edit} phones; using rank remap")
            tail_vals = mel2ph[tail_mask]
            _, dense = np.unique(tail_vals, return_inverse=True)
            edited_mel2ph_full[tail_idx:] = np.minimum(
                s_edit - n_tail_ph_edit + 1 + dense, s_edit)
        else:
            first_tail_orig = int(np.sum(ph2word <= w1)) + 1
            first_tail_edit = int(np.sum(edited_ph2word <= c1)) + 1
            edited_mel2ph_full[tail_idx:] = (
                mel2ph[tail_mask] + (first_tail_edit - first_tail_orig))

    # splice ref mel / f0 / uv; masked span stays zero
    ref_mels = np.zeros((t_new, mel.shape[1]), np.float32)
    ref_mels[:head_idx] = mel[:head_idx]
    edited_f0 = np.zeros(t_new, np.float32)
    edited_uv = np.zeros(t_new, np.float32)
    edited_f0[:head_idx] = f0[:head_idx]
    edited_uv[:head_idx] = uv[:head_idx]
    if tail_mask.any():
        ref_mels[tail_idx:] = mel[tail_mask]
        edited_f0[tail_idx:] = f0[tail_mask]
        edited_uv[tail_idx:] = uv[tail_mask]

    time_mel_masks = np.zeros((t_new, 1), np.float32)
    time_mel_masks[head_idx:tail_idx] = 1.0

    # the model clips mel2ph to frames_multiple (fs.forward_dur) — keep
    # every spliced array on the same floored grid or shapes diverge
    fm = int(frames_multiple)
    if fm > 1 and t_new // fm * fm > 0:
        t_new = t_new // fm * fm
        edited_mel2ph_full = edited_mel2ph_full[:t_new]
        ref_mels = ref_mels[:t_new]
        edited_f0 = edited_f0[:t_new]
        edited_uv = edited_uv[:t_new]
        time_mel_masks = time_mel_masks[:t_new]

    return {"mel2ph": edited_mel2ph_full, "ref_mels": ref_mels,
            "f0": edited_f0, "uv": edited_uv,
            "time_mel_masks": time_mel_masks, "t_new": t_new}


class SpecDenoiserInfer(BaseInfer):
    @classmethod
    def make_server(cls, infer_ins, **kw):
        """The batched serving engine for this family
        (``infer/serving.py::BatchedEditServer``)."""
        from speech_editing_tpu_torch.infer.serving import BatchedEditServer

        return BatchedEditServer(infer_ins, **kw)

    def build_model(self):
        from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model

        model = build_model(self.ph_encoder.vocab_size, self.hp)
        model.load_state_dict(self.load_variables())
        model.to(self.device).eval()
        self.quant = self.maybe_quantize(model)
        return model

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    # -- the two device programs, batched ------------------------------------
    @torch.inference_mode()
    def _predict_dur(self, txt, tm, m2p, mdur, spk) -> torch.Tensor:
        """Device program 1: the duration predictor on the edited phones
        txt [B, S], conditioned on the masked ground-truth durations mdur
        [B, S] of the untouched words; tm [B, T, 1] the edited frames, m2p
        [B, T] the masked alignment, spk [B, 256]. Returns the float
        durations [B, S] on the device."""
        with self.weights():
            out = self.model.predict_durations(
                self._tensor(txt), self._tensor(tm), self._tensor(m2p), self._tensor(mdur),
                self._tensor(spk, torch.float32))
        return out["dur"]

    @torch.inference_mode()
    def _infer(self, txt, tm, m2p, spk, ref, f0, uv, noise) -> torch.Tensor:
        """Device program 2: the reverse diffusion with predicted pitch over
        the spliced frames; txt [B, S], tm [B, T, 1], m2p [B, T], spk [B,
        256], ref [B, T, 80], f0 and uv [B, T]; ``noise`` timesteps + 1
        tensors [B, T, 80] (each row's ``request_noise``, zero-padded).
        Returns mel_out [B, T, 80] on the device, before the composite."""
        noise = torch.stack([torch.as_tensor(n) for n in noise]).to(self.device, torch.float32)
        with self.weights():
            out = self.model(
                self._tensor(txt), self._tensor(tm), self._tensor(m2p),
                self._tensor(spk, torch.float32), self._tensor(ref), self._tensor(f0),
                self._tensor(uv), use_pred_pitch=True, noise=noise)
        return out["mel_out"]

    # -- host-side preprocessing ----------------------------------------------
    def preprocess_input(self, inp: dict) -> dict:
        txt_processor = get_txt_processor_cls(self.hp.get("language", "en"))
        ph, txt, words, ph2word, _ = txt_to_ph(txt_processor, inp["text"])
        ph_token = self.ph_encoder.encode(ph)
        edited_ph, _, edited_words, edited_ph2word, _ = txt_to_ph(
            txt_processor, inp["edited_text"])
        edited_ph_token = self.ph_encoder.encode(edited_ph)

        words = words.split(" ")
        edited_words = edited_words.split(" ")
        region = parse_region_list_from_str(inp["region"])
        edited_region = parse_region_list_from_str(inp["edited_region"])
        words_region = get_words_region_from_origintxt_region(words, region)
        edited_words_region = get_words_region_from_origintxt_region(
            edited_words, edited_region)

        mel = np.asarray(inp["mel"], np.float32)
        wav = np.asarray(inp["wav"], np.float32)
        if "mel2ph" in inp:  # a precomputed alignment
            mel2ph = list(inp["mel2ph"])[:mel.shape[0]]
            mel2ph += [0] * (mel.shape[0] - len(mel2ph))
            from speech_editing_tpu_torch.utils.audio.align import mel2token_to_dur
            dur = mel2token_to_dur(np.asarray(mel2ph), len(ph_token)).tolist()
        else:
            mel2ph, dur = get_align_from_mfa_output(
                inp["mfa_textgrid"], ph, ph_token, mel, hop_size=self.hp["hop_size"],
                sample_rate=self.hp["audio_sample_rate"])
        # padding frames (mel2ph == 0) belong to no word: keep them 0 so the
        # head/tail splice drops them
        mel2word = [ph2word[p - 1] if p > 0 else 0 for p in mel2ph]
        f0, uv = extract_f0_uv(wav, mel, hop_size=self.hp["hop_size"],
                               sample_rate=self.hp["audio_sample_rate"],
                               f0_min=self.hp.get("f0_min", 80),
                               f0_max=self.hp.get("f0_max", 600))
        return {
            "item_name": inp.get("item_name", "<item>"), "text": txt,
            "ph": ph, "ph2word": np.asarray(ph2word, np.int64),
            "edited_ph2word": np.asarray(edited_ph2word, np.int64),
            "ph_token": np.asarray(ph_token, np.int64),
            "edited_ph_token": np.asarray(edited_ph_token, np.int64),
            "words_region": words_region,
            "edited_words_region": edited_words_region,
            "mel2ph": np.asarray(mel2ph, np.int64),
            "mel2word": np.asarray(mel2word, np.int64),
            "dur": np.asarray(dur, np.int64),
            "f0": f0.astype(np.float32), "uv": uv.astype(np.float32),
            "mel": mel, "wav": wav,
        }

    # -- duration inpainting + splice + diffusion ------------------------------
    def predict_durations(self, item: dict, spk_embed: np.ndarray) -> np.ndarray:
        """Device program 1 on one request. Returns the float durations
        [S_edit]."""
        masked_dur, masked_mel2ph, edit_frames = dur_inpaint_prep(item)
        dur = self._predict_dur(item["edited_ph_token"][None],
                                edit_frames.astype(np.float32)[None, :, None],
                                masked_mel2ph[None], masked_dur[None], spk_embed)
        return dur[0].float().cpu().numpy()

    def inpaint_durations(self, item: dict, spk_embed: np.ndarray,
                          dur_int: Optional[np.ndarray] = None):
        """Predicted durations, length-regulated on the host at their full
        length. ``dur_int`` (integer durations [S_edit]) replaces the
        rounded prediction, to replay another device's rounding.

        Returns (edited_mel2ph_pred [T_pred], edited_mel2word [T_pred],
        edit_frames [T_orig] bool)."""
        _, _, edit_frames = dur_inpaint_prep(item)
        dur = self.predict_durations(item, spk_embed) if dur_int is None else dur_int
        edited_mel2ph_pred, edited_mel2word = dur_to_mel2ph(
            item, dur, int(self.hp.get("frames_multiple", 1)))
        return edited_mel2ph_pred, edited_mel2word, edit_frames

    def diffuse(self, item: dict, sp: dict, spk_embed: np.ndarray,
                noise: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
        """Device program 2 on the spliced frames ``sp`` (``splice_edit``) of
        one request; its noise ``request_noise`` of the request's generator
        unless given (``timesteps + 1`` tensors [1, T, 80]). Returns mel_out
        [T, 80] before the composite."""
        if noise is None:
            gen = request_generator(int(self.hp.get("seed", 1234)), item, self.device)
            noise = request_noise(gen, self.model.num_timesteps, sp["t_new"],
                                  self.model.out_dims)[:, None]
        return self._infer(item["edited_ph_token"][None], sp["time_mel_masks"][None],
                           sp["mel2ph"][None], spk_embed, sp["ref_mels"][None],
                           sp["f0"][None], sp["uv"][None], noise)[0].cpu().numpy()

    def forward_model(self, item: dict, noise: Optional[Sequence[torch.Tensor]] = None,
                      dur_int: Optional[np.ndarray] = None):
        """One edit: durations, splice, diffusion, composite, two vocoder
        calls. ``noise`` and ``dur_int`` (see :meth:`diffuse` and
        :meth:`inpaint_durations`) let a test replay another run's draws
        and rounding. Returns (wav_out, wav_gt, mel_out, mel, ref_mels,
        masked_mel_gt)."""
        hp = self.hp
        mel = item["mel"]

        spk_embed = self.spk_embedder(item["wav"])[None]
        edited_mel2ph_pred, edited_mel2word, edit_frames = \
            self.inpaint_durations(item, spk_embed, dur_int)
        time_mel_masks_orig = edit_frames.astype(np.float32)

        sp = splice_edit(item, edited_mel2ph_pred, edited_mel2word,
                         int(hp.get("frames_multiple", 1)))
        ref_mels, time_mel_masks = sp["ref_mels"], sp["time_mel_masks"]
        mel_out = self.diffuse(item, sp, spk_embed, noise)
        mel_out = mel_out * time_mel_masks + ref_mels * (1 - time_mel_masks)

        wav_out = self.run_vocoder(mel_out)
        wav_gt = self.run_vocoder(mel)
        masked_mel_gt = mel * time_mel_masks_orig[:, None]
        return wav_out, wav_gt, mel_out, mel, ref_mels, masked_mel_gt

    # -- batch entry point-------------------------------------------------------
    @classmethod
    def example_run(cls, dataset_info: List[dict], hp: Any,
                    out_dir: str = "inference/out", device: Any = "cuda"):
        """The CSV edit API: the log-mel of each row's wav, one edit per row,
        ``<out_dir>/<item_name>.wav`` and ``<item_name>_ref.wav``. With
        ``serve_batched`` the edits run through the batch server
        (``serve_max_batch`` requests a chunk), with the same results
        contract."""
        from speech_editing_tpu_torch.utils.audio.dsp import wav2spec
        from speech_editing_tpu_torch.utils.audio.io import save_wav

        infer_ins = cls(hp, device)
        os.makedirs(out_dir, exist_ok=True)
        inputs = []
        for data_info in dataset_info:
            res = wav2spec(data_info["wav_fn_orig"], sample_rate=hp["audio_sample_rate"],
                           fft_size=hp["fft_size"], hop_size=hp["hop_size"],
                           win_length=hp.get("win_size", hp["fft_size"]),
                           num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"],
                           fmax=hp["fmax"])
            inp = dict(data_info)
            inp.update(mel=res["mel"], wav=res["wav"])
            inputs.append(inp)
        if hp.get("serve_batched"):
            server = cls.make_server(infer_ins, max_batch=int(hp.get("serve_max_batch", 8)))
            for inp, r in zip(inputs, server.edit_many(inputs)):
                name = inp["item_name"]
                save_wav(r["wav_out"], f"{out_dir}/{name}.wav", hp["audio_sample_rate"])
                save_wav(infer_ins.run_vocoder(inp["mel"]), f"{out_dir}/{name}_ref.wav",
                         hp["audio_sample_rate"])
        else:
            for inp in inputs:
                wav_out, wav_gt, *_ = infer_ins.infer_once(inp)
                name = inp["item_name"]
                save_wav(wav_out, f"{out_dir}/{name}.wav", hp["audio_sample_rate"])
                save_wav(wav_gt, f"{out_dir}/{name}_ref.wav", hp["audio_sample_rate"])
        print(f"| region-edit results -> {out_dir}", flush=True)


def load_dataset_info(file_path: str) -> List[dict]:
    rows = []
    with open(file_path) as f:
        for row in csv.DictReader(f):
            rows.append({k: row[k] for k in
                         ("item_name", "text", "edited_text", "wav_fn_orig",
                          "edited_region", "region")})
    return rows


def data_preprocess(file_path: str, input_directory: str,
                    dictionary_path: str, acoustic_model_path: str,
                    output_directory: str, align: bool = True) -> List[dict]:
    """Write .lab files + OOV dict entries, run ``mfa align`` (subprocess),
    attach TextGrid paths."""
    dataset_info = load_dataset_info(file_path)
    for d in dataset_info:
        d["mfa_textgrid"] = f"{output_directory}/{d['item_name']}.TextGrid"
    if not align:
        return dataset_info

    txt_processor = get_txt_processor_cls("en")
    os.makedirs(input_directory, exist_ok=True)
    for d in dataset_info:
        *_, ph_gb_word = txt_to_ph(txt_processor, d["text"])
        words_nosil = [
            "_".join([p for p in w.split("_") if not is_sil_phoneme(p)])
            for w in ph_gb_word.split(" ") if not is_sil_phoneme(w)]
        with open(f"{input_directory}/{d['item_name']}.lab", "w") as f:
            f.write(" ".join(words_nosil))
        existing = set()
        if os.path.exists(dictionary_path):
            with open(dictionary_path) as f:
                existing = set(f.readlines())
        with open(dictionary_path, "a+") as f:
            for w in words_nosil:
                line = w + "\t" + " ".join(w.split("_")) + "\n"
                if line not in existing:
                    f.write(line)
        shutil.copyfile(d["wav_fn_orig"],
                        f"{input_directory}/{d['item_name']}.wav")

    if os.path.exists(output_directory):
        shutil.rmtree(output_directory)
    cmd = ["mfa", "align", "-j", "4", "--clean", input_directory,
           dictionary_path, acoustic_model_path, output_directory]
    print("| running:", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return dataset_info



def main(argv: Optional[Sequence[str]] = None,
         infer_cls_for: Callable[[Any], type] = lambda hp: SpecDenoiserInfer) -> None:
    """The CSV edit API's command line (see the module doc), editing with
    the driver ``infer_cls_for(hp)``."""
    import sys

    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card

    parser = arg_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    device = cuda_or_cpu(args.device, "spec_denoiser")
    float32_on_card()
    hp = set_hparams(args)
    test_file_path = hp.get("infer_csv", "inference/example.csv")
    test_wav_directory = "inference/audio"
    dictionary_path = hp.get("mfa_dict", "data/processed/libritts/mfa_dict.txt")
    acoustic_model_path = hp.get("mfa_model", "data/processed/libritts/mfa_model.zip")
    output_directory = "inference/audio/mfa_out"
    dataset_info = data_preprocess(
        test_file_path, test_wav_directory, dictionary_path, acoustic_model_path,
        output_directory, align=bool(hp.get("mfa_align", True)))
    infer_cls_for(hp).example_run(dataset_info, hp, device=device)


if __name__ == "__main__":
    main()
