"""Released reference checkpoints -> the port's ``state_dict``s.

Lets users of the reference toolkit bring their released checkpoints (the
FluentSpeech ``model_ckpt_steps_*.ckpt`` of each editing family, the
pretrained HiFi-GAN) to the port. The port's parameter names are the
reference's, so a conversion is:

* weight normalisation folded: ``w = g * v / ||v||`` per output channel
  (``X.weight_g`` / ``X.weight_v``, or torch's newer
  ``X.parametrizations.weight.original0/1``) -> ``X.weight``;
* eval-mode BatchNorm folded (A3T): running statistics into a per-channel
  affine map, which the port's ``AffineNorm`` holds with running mean 0 and
  variance ``1 - eps`` (build the model with ``espnet_bn_affine``);
* the reference's weights that the port does not use dropped: the
  diffusion schedule buffers (recomputed from ``hp``), a conditioner's
  unused FastSpeech decoder and ``mel_out``, the parent-FastSpeech
  leftovers the in-place families' constructors never delete, the
  transformer encoder's unused ``pre_net``;
* parameters the reference lacks kept at the port's initialisation
  (EditSpeech's duration embedding, which its inference never reads).

Each ``convert_*`` takes the reference state dict and the ``hp`` the port
model is built from, and returns that model's full ``state_dict``: a
missing key, an unknown key or a shape that differs raises, so the result
loads with ``strict=True``.

    python -m speech_editing_tpu_torch.utils.convert_torch_ckpt --family hifigan \\
        --config egs/hifigan.yaml model_ckpt_steps_2168000.ckpt OUT_DIR

writes ``OUT_DIR/model_ckpt_steps_<N>.ckpt`` (a port checkpoint: the
converted ``state_dict`` under ``state["model"]``) and ``config.yaml``, a
work dir the port's drivers and its HiFi-GAN vocoder (``vocoder_ckpt``)
load as they load the port's own.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

#: the diffusion schedule's buffers, recomputed from hp on the port's side
SCHEDULE_BUFFERS = (r"(betas|alphas_cumprod|alphas_cumprod_prev|sqrt_alphas_cumprod|"
                    r"sqrt_one_minus_alphas_cumprod|log_one_minus_alphas_cumprod|"
                    r"sqrt_recip_alphas_cumprod|sqrt_recipm1_alphas_cumprod|"
                    r"posterior_variance|posterior_log_variance_clipped|posterior_mean_coef1|"
                    r"posterior_mean_coef2|spec_min|spec_max)$")
#: a conditioner's FastSpeech decoder and mel_out (``include_decoder=False``)
CONDITIONER_DECODER = (r"fs\.decoder\.", r"fs\.mel_out\.")
#: what an in-place family's constructor inherits from FastSpeech and never uses
FASTSPEECH_LEFTOVERS = (r"(dur_predictor|dur_embed|pitch_embed|pitch_predictor|energy_embed|"
                        r"energy_predictor|mel_out|decoder|spk_embed_proj|spk_id_proj)\.",
                        r"encoder\.pre_net\.")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.as_tensor(np.array(v))


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A torch ``.ckpt``/``.pt`` file as a flat state dict of CPU tensors,
    through the reference trainer's nestings: ``{"state_dict": {"model_gen":
    ...}}`` (the GAN trainer's generator), ``{"state_dict": {"model": ...}}``
    or a bare state dict."""
    sd: Any = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model_gen" in sd:
        sd = sd["model_gen"]
    elif isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: _tensor(v) for k, v in sd.items()}


def fold_weight_norm(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Every weight-normed module's ``g * v / ||v||`` (the norm over all
    dimensions but the first, as ``torch.nn.utils.weight_norm``'s default)
    under ``X.weight``; every other entry as it is."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    forms = (("weight_g", "weight_v"),
             ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    for g_name, v_name in forms:
        for g_key in [k for k in sd if k == g_name or k.endswith("." + g_name)]:
            prefix = g_key[: -len(g_name)]       # "" or "module.path."
            g, v = sd.pop(g_key).float(), sd.pop(prefix + v_name).float()
            norm = v.reshape(v.shape[0], -1).norm(dim=1).reshape(-1, *[1] * (v.dim() - 1))
            sd[prefix + "weight"] = g * v / norm.clamp_min(1e-12)
    return sd


def fold_batchnorm(sd: dict, prefix: str, eps: float = 1e-5) -> None:
    """Eval-mode BatchNorm1d under ``prefix`` as a per-channel affine map
    (scale ``w / sqrt(var + eps)``, bias ``b - mean * scale``), in place:
    the port's ``AffineNorm`` then holds mean 0 and variance ``1 - eps``."""
    w, b = sd[f"{prefix}.weight"].float(), sd[f"{prefix}.bias"].float()
    mean, var = sd[f"{prefix}.running_mean"].float(), sd[f"{prefix}.running_var"].float()
    scale = w / torch.sqrt(var + eps)
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = scale, b - mean * scale
    sd[f"{prefix}.running_mean"] = torch.zeros_like(mean)
    sd[f"{prefix}.running_var"] = torch.full_like(var, 1.0 - eps)


def _matches(key: str, patterns: Iterable[str]) -> bool:
    return any(re.match(p, key) for p in patterns)


def _assemble(sd: Mapping[str, torch.Tensor], model: nn.Module, drop: Iterable[str] = (),
              keep_init: Iterable[str] = (), what: str = "") -> dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` filled from ``sd``: keys matching
    ``keep_init`` and absent from ``sd`` keep the model's values, keys of
    ``sd`` matching ``drop`` are left out; anything else missing or unknown,
    or a shape that differs, raises."""
    expected = model.state_dict()
    drop, keep_init = tuple(drop), tuple(keep_init)
    out, missing, bad = {}, [], []
    for k, ref in expected.items():
        if k in sd:
            if tuple(sd[k].shape) != tuple(ref.shape):
                bad.append(f"{k}: {tuple(sd[k].shape)} != {tuple(ref.shape)}")
            out[k] = sd[k].to(ref.dtype).contiguous()
        elif _matches(k, keep_init):
            out[k] = ref.detach().clone()
        else:
            missing.append(k)
    unknown = sorted(k for k in sd if k not in expected and not _matches(k, drop))
    if missing or unknown or bad:
        raise KeyError(f"{what}: the reference checkpoint does not fit the port's model: "
                       f"missing {missing[:20]}{' ...' if len(missing) > 20 else ''}, "
                       f"unknown {unknown[:20]}{' ...' if len(unknown) > 20 else ''}, "
                       f"shapes {bad[:20]}")
    return out


def _shapes_only(build) -> nn.Module:
    """A model built on the meta device: its keys and shapes, no storage."""
    with torch.device("meta"):
        return build()


def _vocab(sd: Mapping[str, torch.Tensor], key: str) -> int:
    if key not in sd:
        raise KeyError(f"the reference checkpoint has no {key!r} (the token embedding)")
    return int(sd[key].shape[0])


def convert_hifigan_generator(state_dict: Mapping[str, Any], hp: Any) -> dict[str, torch.Tensor]:
    """The reference ``HifiGanGenerator`` (weight-normed convs) -> the port's
    ``models.vocoder.hifigan.HifiGanGenerator(hp)``."""
    from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator

    model = _shapes_only(lambda: HifiGanGenerator(hp))
    return _assemble(fold_weight_norm(state_dict), model, what="HiFi-GAN")


def convert_gaussian_diffusion(state_dict: Mapping[str, Any], hp: Any) -> dict[str, torch.Tensor]:
    """The reference FluentSpeech ``GaussianDiffusion`` (``fs.``,
    ``mel_encoder.``, ``denoise_fn.``; the schedule buffers and the
    conditioner's decoder dropped) -> the port's ``GaussianDiffusion``."""
    from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion

    sd = fold_weight_norm(state_dict)
    vocab = _vocab(sd, "fs.encoder.embed_tokens.weight")
    model = _shapes_only(lambda: GaussianDiffusion(vocab, hp, hp.get("audio_num_mel_bins", 80)))
    return _assemble(sd, model, (SCHEDULE_BUFFERS, *CONDITIONER_DECODER),
                     what="FluentSpeech")


def convert_stutter_gaussian_diffusion(state_dict: Mapping[str, Any],
                                       hp: Any) -> dict[str, torch.Tensor]:
    """The reference StutterSpeech ``GaussianDiffusion`` -> the port's
    ``StutterGaussianDiffusion``."""
    from speech_editing_tpu_torch.models.stutter_speech import StutterGaussianDiffusion

    sd = fold_weight_norm(state_dict)
    vocab = _vocab(sd, "fs.encoder.embed_tokens.weight")
    model = _shapes_only(lambda: StutterGaussianDiffusion(
        vocab, hp, hp.get("audio_num_mel_bins", 80)))
    return _assemble(sd, model, (SCHEDULE_BUFFERS, *CONDITIONER_DECODER),
                     what="StutterSpeech")


def convert_campnet(state_dict: Mapping[str, Any], hp: Any) -> dict[str, torch.Tensor]:
    """The reference ``CampNet`` -> the port's (the parent FastSpeech's
    leftovers and the encoder's unused ``pre_net`` dropped)."""
    from speech_editing_tpu_torch.models.campnet import CampNet

    sd = fold_weight_norm(state_dict)
    vocab = _vocab(sd, "encoder.embed_tokens.weight")
    model = _shapes_only(lambda: CampNet(vocab, hp, hp.get("audio_num_mel_bins", 80)))
    return _assemble(sd, model, FASTSPEECH_LEFTOVERS, what="CampNet")


def convert_editspeech(state_dict: Mapping[str, Any], hp: Any) -> dict[str, torch.Tensor]:
    """The reference ``EditSpeech`` -> the port's. The port's conditioner
    owns a duration embedding that the reference's plain FastSpeech lacks
    and inference never reads: it keeps the port's initialisation (seed 0),
    as the JAX package merges its converted tree onto an initialised one."""
    from speech_editing_tpu_torch.models.editspeech import EditSpeech
    from speech_editing_tpu_torch.utils.init import init_like_flax

    sd = fold_weight_norm(state_dict)
    vocab = _vocab(sd, "fs.encoder.embed_tokens.weight")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = init_like_flax(EditSpeech(vocab, hp, hp.get("audio_num_mel_bins", 80)))
    return _assemble(sd, model, CONDITIONER_DECODER, keep_init=(r"fs\.dur_embed\.",),
                     what="EditSpeech")


def convert_a3t(state_dict: Mapping[str, Any], hp: Any) -> dict[str, torch.Tensor]:
    """The reference ``A3T`` -> the port's built with ``espnet_bn_affine``
    (the conformer's and the postnet's eval-mode BatchNorms folded into its
    ``AffineNorm``s; the parent FastSpeech's leftovers dropped)."""
    from speech_editing_tpu_torch.models.a3t import A3T

    if not hp.get("espnet_bn_affine"):
        raise ValueError("convert_a3t: a reference A3T holds BatchNorms; build the port's "
                         "A3T with hp['espnet_bn_affine'] = True")
    sd = fold_weight_norm(state_dict)
    for k in [k for k in sd if k.endswith(".running_mean")]:
        fold_batchnorm(sd, k[: -len(".running_mean")])
    vocab = _vocab(sd, "encoder.txt_embed.weight")
    model = _shapes_only(lambda: A3T(vocab, hp, hp.get("audio_num_mel_bins", 80)))
    return _assemble(sd, model, FASTSPEECH_LEFTOVERS, what="A3T")


def convert_fastspeech(state_dict: Mapping[str, Any], hp: Any) -> dict[str, torch.Tensor]:
    """The reference TTS ``FastSpeech`` (``modules/tts/fs.py``: encoder,
    predictors, decoder and ``mel_out``) -> the port's ``FastSpeech(...,
    decoder=True, masked=False)``."""
    from speech_editing_tpu_torch.models.fs import FastSpeech

    sd = fold_weight_norm(state_dict)
    vocab = _vocab(sd, "encoder.embed_tokens.weight")
    model = _shapes_only(lambda: FastSpeech(vocab, hp, decoder=True, masked=False))
    return _assemble(sd, model, what="FastSpeech")


CONVERTERS = {"hifigan": convert_hifigan_generator, "spec_denoiser": convert_gaussian_diffusion,
              "stutter_speech": convert_stutter_gaussian_diffusion, "campnet": convert_campnet,
              "editspeech": convert_editspeech, "a3t": convert_a3t, "fs": convert_fastspeech}


def main(argv: Optional[list] = None) -> str:
    """Converts one released checkpoint into a port work dir; returns the
    written checkpoint's path."""
    from speech_editing_tpu_torch.config.hparams import dump_yaml, load_config
    from speech_editing_tpu_torch.training.checkpoint import save_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--family", required=True, choices=sorted(CONVERTERS))
    ap.add_argument("--config", required=True, help="the port's yaml for the model's hp")
    args = ap.parse_args(argv)
    hp = load_config(args.config)
    if args.family == "a3t":
        hp["espnet_bn_affine"] = True
    sd = CONVERTERS[args.family](load_torch_checkpoint(args.ckpt), hp)
    m = re.search(r"steps_(\d+)", os.path.basename(args.ckpt))
    path = save_checkpoint(args.out_dir, {"model": sd}, int(m.group(1)) if m else 0)
    with open(os.path.join(args.out_dir, "config.yaml"), "w") as f:
        f.write(dump_yaml({k: v for k, v in hp.items() if not isinstance(v, dict)}))
    print(f"| {args.family}: {len(sd)} tensors from {args.ckpt} -> {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
