"""Flax parameter trees (as numpy) -> the port's ``state_dict``s.

The port's parameter names are the reference torch layout; the layout
differences handled here:

* flax ``Conv`` kernel ``[k, in, out]`` -> torch ``Conv1d`` ``[out, in, k]``
  (a grouped one's ``[k, in/g, out]`` -> ``[out, in/g, k]``); a 2-D
  kernel ``[k, 1, in, out]`` -> ``Conv2d`` ``[out, in, k, 1]``;
* flax ``Dense`` kernel ``[in, out]`` -> torch ``Linear`` ``[out, in]``;
* flax ``LayerNorm`` and ``GroupNorm`` ``scale`` -> ``weight``;
* attention ``DenseGeneral`` q/k/v ``[E, h, d]`` -> packed
  ``in_proj_weight [3E, E]``; out ``[h, d, E]`` -> ``out_proj.weight [E, E]``;
* flax ``ConvTranspose`` kernel ``[k, in, out]`` is flipped along k
  relative to torch ``ConvTranspose1d`` ``[in, out, k]``;
* flax ``OptimizedLSTMCell`` kernels ``ii/if/ig/io`` and ``hi/hf/hg/ho``
  (the h side biased) -> ``nn.LSTM``'s stacked ``weight_ih_l{n}``,
  ``weight_hh_l{n}`` and ``bias_hh_l{n}`` (gates i, f, g, o), with
  ``bias_ih_l{n}`` zero;
* a scanned flax ``GRUCell`` (``ir``/``iz``/``in`` biased, ``hr``/``hz``
  not, ``hn`` biased) -> ``nn.GRU``'s stacked gates r, z, n, with the r and
  z thirds of ``bias_hh`` zero (``_reverse`` for the backward direction);
* a Dense that the reference holds as a 1-wide ``Conv1d`` (the conformer's
  pointwise layers) -> ``[out, in, 1]``;
* the ``affine`` norm (the reference's eval-mode BatchNorm, folded) ->
  BatchNorm ``weight``/``bias`` with running mean 0 and variance 1 - eps.

Parameters that a flax tree lacks because its model never called their
module (EditSpeech's ``dur_embed``, and ``proj_in`` of a tree made at
inference) are unused by inference and come out zero. The TTS models are
built without the modules their flax trees lack (no duration embedding;
FastSpeech2-orig's frame pitch predictor under CWT pitch).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv_transpose(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"])[::-1], (1, 2, 0)))
    sd[f"{name}.bias"] = _t(p["bias"])


def _linear(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _layer_norm(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _embedding(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["embed"]["embedding"])


def _predictor(sd: dict, name: str, p: Mapping, n_layers: int, head: str) -> None:
    for i in range(n_layers):
        _conv(sd, f"{name}.conv.{i}.0", p[f"conv_{i}"])
        _layer_norm(sd, f"{name}.conv.{i}.2", p[f"ln_{i}"])
    _linear(sd, f"{name}.{head}", p["linear"])


def _mha(sd: dict, name: str, att: Mapping) -> None:
    e = np.asarray(att["q_proj"]["kernel"]).shape[0]
    sd[f"{name}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(att[k]["kernel"]).reshape(e, e).T for k in ("q_proj", "k_proj", "v_proj")]))
    sd[f"{name}.out_proj.weight"] = _t(np.asarray(att["out_proj"]["kernel"]).reshape(e, e).T)


def _encoder(sd: dict, name: str, p: Mapping, num_layers: int, embed: bool = True) -> None:
    """The FFT blocks under ``p["fft"]`` (and with ``embed`` the token
    embedding) -> ``name``'s layers and last norm."""
    if embed:
        _embedding(sd, f"{name}.embed_tokens", p["embed_tokens"])
    fft = p["fft"]
    for i in range(num_layers):
        lp, prefix = fft[f"layers_{i}"], f"{name}.layers.{i}.op"
        _layer_norm(sd, f"{prefix}.layer_norm1", lp["layer_norm1"])
        _layer_norm(sd, f"{prefix}.layer_norm2", lp["layer_norm2"])
        _mha(sd, f"{prefix}.self_attn", lp["self_attn"])
        _conv(sd, f"{prefix}.ffn.ffn_1", lp["ffn"]["ffn_1"])
        _linear(sd, f"{prefix}.ffn.ffn_2", lp["ffn"]["ffn_2"])
    _layer_norm(sd, f"{name}.layer_norm", fft["layer_norm"])


def _conv_blocks(sd: dict, prefix: str, p: Mapping, n_blocks: int,
                 layers_in_block: int) -> None:
    for j in range(n_blocks):
        for i in range(layers_in_block):
            rp, name = p[f"res_{j}"], f"{prefix}res_blocks.{j}.blocks.{i}"
            if f"norm_{i}" in rp:       # an identity norm has no parameters
                _layer_norm(sd, f"{name}.0", rp[f"norm_{i}"])
            _conv(sd, f"{name}.1", rp[f"conv_{i}"])
            _conv(sd, f"{name}.4", rp[f"proj_{i}"])
    if "last_norm" in p:
        _layer_norm(sd, f"{prefix}last_norm", p["last_norm"])
    _conv(sd, f"{prefix}post_net1", p["post_net1"])


def _mel_encoder(sd: dict, name: str, p: Mapping) -> None:
    _linear(sd, f"{name}.encoder.0", p["fc1"])
    _linear(sd, f"{name}.encoder.2", p["fc2"])
    _linear(sd, f"{name}.fc_out", p["fc_out"])


def text_conv_encoder_params_from_jax(p: Mapping, n_blocks: int, layers_in_block: int = 2,
                                      prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ``TextConvEncoder`` params -> ``state_dict`` of the port's, keys
    prefixed by ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    _embedding(sd, f"{prefix}embed_tokens", p["embed_tokens"])
    _conv_blocks(sd, prefix, p["conv"], n_blocks, layers_in_block)
    return sd


def diffnet_params_from_jax(p: Mapping, residual_layers: int,
                            prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ``DiffNet`` params -> ``state_dict`` of the port's DiffNet, keys
    prefixed by ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}input_projection", p["input_projection"])
    _linear(sd, f"{prefix}mlp.0", p["mlp_1"])
    _linear(sd, f"{prefix}mlp.2", p["mlp_2"])
    for i in range(residual_layers):
        rp, name = p[f"residual_{i}"], f"{prefix}residual_layers.{i}"
        _conv(sd, f"{name}.dilated_conv", rp["dilated_conv"])
        _linear(sd, f"{name}.diffusion_projection", rp["diffusion_projection"])
        _conv(sd, f"{name}.conditioner_projection", rp["conditioner_projection"])
        _conv(sd, f"{name}.output_projection", rp["output_projection"])
    _conv(sd, f"{prefix}skip_projection", p["skip_projection"])
    _conv(sd, f"{prefix}output_projection", p["output_projection"])
    return sd


def _gru(sd: dict, name: str, p: Mapping, suffix: str = "") -> None:
    """A scanned flax ``GRUCell`` (``cell``: ``ir/iz/in`` biased, ``hr/hz``
    not, ``hn`` biased) -> one direction of ``nn.GRU`` (gates r, z, n), its
    reset and update gates' ``bias_hh`` zero."""
    cell = p["cell"]
    h = np.asarray(cell["hn"]["bias"]).shape[0]
    sd[f"{name}.weight_ih_l0{suffix}"] = _t(np.concatenate(
        [np.asarray(cell[g]["kernel"]).T for g in ("ir", "iz", "in")]))
    sd[f"{name}.weight_hh_l0{suffix}"] = _t(np.concatenate(
        [np.asarray(cell[g]["kernel"]).T for g in ("hr", "hz", "hn")]))
    sd[f"{name}.bias_ih_l0{suffix}"] = _t(np.concatenate(
        [np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")]))
    sd[f"{name}.bias_hh_l0{suffix}"] = _t(np.concatenate(
        [np.zeros(2 * h), np.asarray(cell["hn"]["bias"])]))


def _bigru(sd: dict, name: str, p: Mapping) -> None:
    _gru(sd, name, p["fwd"])
    _gru(sd, name, p["bwd"], "_reverse")


def _rel_encoder(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.emb.weight"] = _t(p["emb"]["embedding"])
    if "pre" in p:
        pre = p["pre"]
        i = 0
        while f"conv_{i}" in pre:
            _conv(sd, f"{name}.pre.convs.{i}", pre[f"conv_{i}"])
            _layer_norm(sd, f"{name}.pre.norms.{i}", pre[f"norm_{i}"])
            i += 1
        _linear(sd, f"{name}.pre.proj", pre["proj"])
    i = 0
    while f"attn_{i}" in p:
        att = p[f"attn_{i}"]
        for n in ("q", "k", "v", "out"):
            _linear(sd, f"{name}.attn.{i}.{n}", att[n])
        for n in ("emb_rel_k", "emb_rel_v"):
            sd[f"{name}.attn.{i}.{n}"] = _t(att[n])
        for n in ("norm1", "norm2"):
            _layer_norm(sd, f"{name}.{n}.{i}", p[f"{n}_{i}"])
        for n in ("ffn1", "ffn2"):
            _conv(sd, f"{name}.{n}.{i}", p[f"{n}_{i}"])
        i += 1
    _layer_norm(sd, f"{name}.last_norm", p["last_norm"])


def _tacotron_encoder(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.embedding.weight"] = _t(p["embedding"]["embedding"])
    _linear(sd, f"{name}.pre_net.fc1", p["pre_net"]["fc1"])
    _linear(sd, f"{name}.pre_net.fc2", p["pre_net"]["fc2"])
    cbhg, prefix = p["cbhg"], f"{name}.cbhg"
    k = 1
    while f"bank_{k}" in cbhg:
        _conv(sd, f"{prefix}.bank.{k - 1}", cbhg[f"bank_{k}"])
        _layer_norm(sd, f"{prefix}.bank_norm.{k - 1}", cbhg[f"bank_norm_{k}"])
        k += 1
    for n in ("proj1", "proj2"):
        _conv(sd, f"{prefix}.{n}", cbhg[n])
        _layer_norm(sd, f"{prefix}.{n}_norm", cbhg[f"{n}_norm"])
    if "pre_highway" in cbhg:
        _linear(sd, f"{prefix}.pre_highway", cbhg["pre_highway"])
    i = 0
    while f"highway_{i}" in cbhg:
        for n in ("W1", "W2"):
            _linear(sd, f"{prefix}.highways.{i}.{n}", cbhg[f"highway_{i}"][n])
        i += 1
    _bigru(sd, f"{prefix}.rnn", cbhg["rnn"])
    _linear(sd, f"{name}.proj_out", p["proj_out"])


def _rnn_encoder(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.embedding.weight"] = _t(p["embedding"]["embedding"])
    for i in range(3):
        _conv(sd, f"{name}.convs.{i}", p[f"conv_{i}"])
        _layer_norm(sd, f"{name}.norms.{i}", p[f"norm_{i}"])
    _bigru(sd, f"{name}.rnn", p["rnn"])


def _text_encoder(sd: dict, name: str, p: Mapping, hp: Any) -> None:
    """The ``encoder_type`` text encoder's parameters under ``name``."""
    enc_type = hp.get("encoder_type", "fft")
    if enc_type == "conv":
        sd.update(text_conv_encoder_params_from_jax(
            p, len(hp["enc_dilations"]), hp.get("layers_in_block", 2), f"{name}."))
    elif enc_type == "rel_fft":
        _rel_encoder(sd, name, p)
    elif enc_type == "tacotron":
        _tacotron_encoder(sd, name, p)
    elif enc_type == "tacotron2":
        _rnn_encoder(sd, name, p)
    else:
        _encoder(sd, name, p, hp["enc_layers"])


def _decoder(sd: dict, name: str, p: Mapping, hp: Any) -> None:
    """The ``decoder_type`` mel decoder's parameters under ``name``."""
    dec_type = hp.get("decoder_type", "fft")
    if dec_type == "fft":
        fft = p["fft"]
        sd[f"{name}.pos_embed_alpha"] = _t(fft["pos_embed_alpha"])
        _encoder(sd, name, p, hp["dec_layers"], embed=False)
    elif dec_type == "conv":
        _conv_blocks(sd, f"{name}.", p, len(hp["dec_dilations"]), hp.get("layers_in_block", 2))
    elif dec_type == "wn":
        for i in range(hp["dec_layers"]):
            _conv(sd, f"{name}.in_layers.{i}", p[f"in_{i}"])
            _conv(sd, f"{name}.res_skip_layers.{i}", p[f"res_skip_{i}"])
    else:
        _bigru(sd, f"{name}.rnn1", p["rnn1"])
        _bigru(sd, f"{name}.rnn2", p["rnn2"])
        _linear(sd, f"{name}.proj", p["proj"])


def _fastspeech(sd: dict, fs: Mapping, hp: Any, prefix: str = "fs.",
                masked: bool = True) -> None:
    """FastSpeech under ``prefix``: the encoder, speaker projections,
    duration and pitch predictors, and the decoder and ``mel_out`` where
    the tree has them; ``masked``: the conditioner's duration embedding
    (zero where its model never called it)."""
    h = hp["hidden_size"]
    _text_encoder(sd, f"{prefix}encoder", fs["encoder"], hp)
    if "spk_id_proj" in fs:
        _embedding(sd, f"{prefix}spk_id_proj", fs["spk_id_proj"])
    if "spk_embed_proj" in fs:
        _linear(sd, f"{prefix}spk_embed_proj", fs["spk_embed_proj"])
    if "dur_embed" in fs:
        _embedding(sd, f"{prefix}dur_embed", fs["dur_embed"])
    elif masked:
        sd[f"{prefix}dur_embed.weight"] = torch.zeros(2000, h)
    _predictor(sd, f"{prefix}dur_predictor", fs["dur_predictor"],
               hp["dur_predictor_layers"], "linear.0")
    if hp.get("use_pitch_embed"):
        _embedding(sd, f"{prefix}pitch_embed", fs["pitch_embed"])
        if "pitch_predictor" in fs:
            _predictor(sd, f"{prefix}pitch_predictor", fs["pitch_predictor"], 5, "linear")
    if "decoder" in fs:
        _decoder(sd, f"{prefix}decoder", fs["decoder"], hp)
        _linear(sd, f"{prefix}mel_out", fs["mel_out_proj"])


def fastspeech_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``FastSpeech`` (the TTS model, with its decoder) params ->
    ``state_dict`` of the port's ``FastSpeech(..., decoder=True,
    masked=False)`` (the reference layout that ``convert_fastspeech(...,
    include_decoder=True)`` reads, for the fft and conv encoders and the fft
    decoder)."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _fastspeech(sd, params, hp, prefix="", masked=False)
    return sd


def fs2_orig_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``FastSpeech2Orig`` params -> ``state_dict`` of the port's: the
    FastSpeech above plus the energy embedding and predictor and the CWT
    pitch predictor with its three stats layers."""
    params = params.get("params", params)
    sd = fastspeech_params_from_jax(params, hp)
    layers = hp.get("predictor_layers", 5)
    if "energy_embed" in params:
        _embedding(sd, "energy_embed", params["energy_embed"])
        _predictor(sd, "energy_predictor", params["energy_predictor"], layers, "linear")
    if "cwt_pitch_predictor" in params:
        _predictor(sd, "cwt_pitch_predictor", params["cwt_pitch_predictor"], layers, "linear")
        for i in range(3):
            _linear(sd, f"cwt_stats_layers.{i}", params[f"cwt_stats_layers_{i}"])
    return sd


def diffspeech_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``DiffSpeech`` params -> ``state_dict`` of the port's: ``fs`` (no
    decoder, no duration embedding) and ``denoise_fn``."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _fastspeech(sd, params["fs"], hp, masked=False)
    sd.update(diffnet_params_from_jax(params["denoise_fn"], hp["residual_layers"],
                                      "denoise_fn."))
    return sd


def params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``GaussianDiffusion`` params (numpy leaves; a ``{"params": ...}``
    wrapper is accepted) -> ``state_dict`` of the port's GaussianDiffusion."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _fastspeech(sd, params["fs"], hp)
    _mel_encoder(sd, "mel_encoder", params["mel_encoder"])
    sd.update(diffnet_params_from_jax(params["denoise_fn"], hp["residual_layers"],
                                      "denoise_fn."))
    return sd


def stutter_speech_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``StutterGaussianDiffusion`` params -> ``state_dict`` of the
    port's (the reference layout that ``convert_stutter_gaussian_diffusion``
    reads)."""
    params = params.get("params", params)
    sd = params_from_jax(params, hp)
    sd["stutter_embed.weight"] = _t(params["stutter_embed"]["embedding"])
    head = params["stutter_predictor"]
    _conv(sd, "stutter_predictor.conv.g_prenet", head["conv"]["g_prenet"])
    _conv_blocks(sd, "stutter_predictor.conv.", head["conv"]["conv"], 4, 2)
    _linear(sd, "stutter_predictor.linear", head["linear"])
    return sd


def _wn(sd: dict, name: str, p: Mapping) -> None:
    """A JAX ``WN`` (``in_{i}``, ``res_skip_{i}``, ``cond_layer``) -> the
    port's (``in_layers.{i}``, ``res_skip_layers.{i}``, ``cond_layer``)."""
    if "cond_layer" in p:
        _conv(sd, f"{name}.cond_layer", p["cond_layer"])
    i = 0
    while f"in_{i}" in p:
        _conv(sd, f"{name}.in_layers.{i}", p[f"in_{i}"])
        _conv(sd, f"{name}.res_skip_layers.{i}", p[f"res_skip_{i}"])
        i += 1


def _mel_prenet(sd: dict, name: str, p: Mapping) -> None:
    for i in range(4):
        _conv(sd, f"{name}.convs.{i}", p[f"conv_{i}"])
    _linear(sd, f"{name}.fc_out", p["fc_out"])


def stutter_predictor_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``StutterPredictor`` params -> ``state_dict`` of the port's."""
    params = params.get("params", params)
    sd = text_conv_encoder_params_from_jax(params["txt_encoder"], len(hp["enc_dilations"]),
                                           hp.get("layers_in_block", 2), "txt_encoder.")
    _mel_prenet(sd, "mel_prenet", params["mel_prenet"])
    _conv_blocks(sd, "mel_convs.", params["mel_convs"], 5, 2)
    _mel_prenet(sd, "decoder_text_prenet", params["decoder_text_prenet"])
    _wn(sd, "decoder", params["decoder"])
    _linear(sd, "out_proj", params["out_proj"])
    return sd


def campnet_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``CampNet`` params -> ``state_dict`` of the port's CampNet (the
    reference layout that ``convert_campnet`` reads)."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _encoder(sd, "encoder", params["encoder"]["enc"], 3)
    _mel_encoder(sd, "mel_encoder", params["mel_encoder"])
    dec = params["decoder_coarse"]
    sd["decoder_coarse.pos_embed_alpha"] = _t(dec["pos_embed_alpha"])
    for i in range(6):
        lp, prefix = dec[f"layers_{i}"], f"decoder_coarse.layers.{i}.op"
        for n in ("layer_norm1", "layer_norm2", "layer_norm3"):
            _layer_norm(sd, f"{prefix}.{n}", lp[n])
        _mha(sd, f"{prefix}.self_attn", lp["self_attn"])
        _mha(sd, f"{prefix}.encoder_attn", lp["encoder_attn"])
        _conv(sd, f"{prefix}.ffn.ffn_1.1", lp["ffn"]["ffn_1"])
        _linear(sd, f"{prefix}.ffn.ffn_2", lp["ffn"]["ffn_2"])
    _layer_norm(sd, "decoder_coarse.layer_norm", dec["layer_norm"])
    _conv_blocks(sd, "decoder_fine.", params["decoder_fine"], 5, 2)
    _linear(sd, "mel_out_coarse", params["mel_out_coarse"])
    _linear(sd, "mel_out_fine", params["mel_out_fine"])
    sd["mask_emb"] = _t(params["mask_emb"])
    return sd


def _lstm(sd: dict, name: str, stack: Mapping) -> None:
    n = 0
    while f"cell_{n}" in stack:
        cell = stack[f"cell_{n}"]
        w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in "ifgo"])
        sd[f"{name}.weight_ih_l{n}"] = _t(np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in "ifgo"]))
        sd[f"{name}.weight_hh_l{n}"] = _t(w_hh)
        sd[f"{name}.bias_ih_l{n}"] = torch.zeros(w_hh.shape[0])
        sd[f"{name}.bias_hh_l{n}"] = _t(np.concatenate(
            [np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"]))
        n += 1


def editspeech_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``EditSpeech`` params -> ``state_dict`` of the port's EditSpeech
    (the reference layout that ``convert_editspeech`` reads)."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _fastspeech(sd, params["fs"], hp)
    if "proj_in" in params:
        _linear(sd, "decoder.proj_in", params["proj_in"])
    else:
        sd["decoder.proj_in.weight"] = torch.zeros(hp["hidden_size"], 80)
        sd["decoder.proj_in.bias"] = torch.zeros(hp["hidden_size"])
    _mel_encoder(sd, "decoder.prenet", params["prenet"])
    for side in ("forward_decoder", "backward_decoder"):
        _lstm(sd, f"decoder.{side}.lstm", params[side]["stack"])
        _linear(sd, f"decoder.{side}.linear", params[side]["linear"])
    return sd


def _pointwise(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd: dict, name: str, p: Mapping, affine: bool) -> None:
    if not affine:
        _layer_norm(sd, name, p)
        return
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = torch.zeros(len(p["bias"]))
    sd[f"{name}.running_var"] = torch.full((len(p["bias"]),), 1.0 - 1e-5)
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _conformer(sd: dict, prefix: str, p: Mapping, affine: bool) -> None:
    i = 0
    while f"layers_{i}" in p:
        lp, name = p[f"layers_{i}"], f"{prefix}encoder_layers.{i}"
        for ffn, torch_ffn in (("ff_macaron", "feed_forward_macaron"), ("ff", "feed_forward")):
            for w in ("w_1", "w_2"):
                _pointwise(sd, f"{name}.{torch_ffn}.{w}", lp[ffn][w])
        for n in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff", "norm_final"):
            _layer_norm(sd, f"{name}.{n}", lp[n])
        att = lp["self_attn"]
        for n in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            _linear(sd, f"{name}.self_attn.{n}", att[n])
        for n in ("pos_bias_u", "pos_bias_v"):
            sd[f"{name}.self_attn.{n}"] = _t(att[n])
        conv = lp["conv"]
        _pointwise(sd, f"{name}.conv_module.pointwise_conv1", conv["pointwise_conv1"])
        _conv(sd, f"{name}.conv_module.depthwise_conv", conv["depthwise_conv"])
        _norm(sd, f"{name}.conv_module.norm", conv["norm"], affine)
        _pointwise(sd, f"{name}.conv_module.pointwise_conv2", conv["pointwise_conv2"])
        i += 1
    _layer_norm(sd, f"{prefix}layer_norm", p["layer_norm"])


def a3t_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``A3T`` params -> ``state_dict`` of the port's A3T (the reference
    layout that ``convert_a3t`` reads; BatchNorm statistics under
    ``espnet_bn_affine``)."""
    params = params.get("params", params)
    affine = bool(hp.get("espnet_bn_affine"))
    sd: dict[str, torch.Tensor] = {}
    _embedding(sd, "encoder.txt_embed", params["txt_embed"])
    _mel_encoder(sd, "encoder.mel_embed", params["mel_embed"])
    _embedding(sd, "encoder.seg_embed", params["seg_embed"])
    _conformer(sd, "encoder.", params["encoder"], affine)
    _conformer(sd, "a3t_decoder.", params["a3t_decoder"], affine)
    post = params["a3t_postnet"]
    i = 0
    while f"conv_{i}" in post:
        _conv(sd, f"a3t_postnet.postnet.{i}.0", post[f"conv_{i}"])
        _norm(sd, f"a3t_postnet.postnet.{i}.1", post[f"norm_{i}"], affine)
        i += 1
    _linear(sd, "mel_out_decoder", params["mel_out_decoder"])
    return sd


def vocoder_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``HifiGanGenerator`` params -> ``state_dict`` of the port's generator."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "conv_pre", params["conv_pre"])
    n_res = len(hp["resblock_kernel_sizes"])
    res1 = str(hp.get("resblock", "1")) == "1"
    for i in range(len(hp["upsample_rates"])):
        _conv_transpose(sd, f"ups.{i}", params[f"up_{i}"])
        for j in range(n_res):
            block, prefix = params[f"resblock_{i}_{j}"], f"resblocks.{i * n_res + j}"
            for d in range(len(hp["resblock_dilation_sizes"][j])):
                if res1:
                    _conv(sd, f"{prefix}.convs1.{d}", block[f"Conv_{2 * d}"])
                    _conv(sd, f"{prefix}.convs2.{d}", block[f"Conv_{2 * d + 1}"])
                else:
                    _conv(sd, f"{prefix}.convs.{d}", block[f"Conv_{d}"])
    _conv(sd, "conv_post", params["conv_post"])
    return sd


def _conv2d(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    sd[f"{name}.bias"] = _t(p["bias"])


def discriminator_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX HiFi-GAN discriminator params (``{"mpd": {"disc_p<p>"},
    "msd": {"disc_s<i>"}}``, each of auto-named ``Conv_<j>``, the last the
    post conv) -> ``state_dict`` of the port's ``HifiGanDiscriminators``."""
    sd: dict[str, torch.Tensor] = {}
    periods = tuple(hp.get("disc_periods", (2, 3, 5, 7, 11)))
    for k, period in enumerate(periods):
        d, name = params["mpd"][f"disc_p{period}"], f"mpd.discriminators.{k}"
        for j in range(5):
            _conv2d(sd, f"{name}.convs.{j}", d[f"Conv_{j}"])
        _conv2d(sd, f"{name}.conv_post", d["Conv_5"])
    for i in range(int(hp.get("msd_scales", 3))):
        d, name = params["msd"][f"disc_s{i}"], f"msd.discriminators.{i}"
        for j in range(7):
            _conv(sd, f"{name}.convs.{j}", d[f"Conv_{j}"])
        _conv(sd, f"{name}.conv_post", d["Conv_7"])
    return sd


def _couplings(sd: dict, name: str, p: Mapping) -> None:
    """A flow's ``coupling_{i}`` (``pre``, ``enc`` a WN, ``post``) ->
    ``{name}.couplings.{i}``."""
    i = 0
    while f"coupling_{i}" in p:
        c, prefix = p[f"coupling_{i}"], f"{name}.couplings.{i}"
        _linear(sd, f"{prefix}.pre", c["pre"])
        _wn(sd, f"{prefix}.enc", c["enc"])
        _linear(sd, f"{prefix}.post", c["post"])
        i += 1


def _glow(sd: dict, name: str, p: Mapping) -> None:
    """A JAX ``Glow`` (``actnorm_{i}``, ``invconv_{i}``, ``coupling_{i}``)."""
    i = 0
    while f"actnorm_{i}" in p:
        sd[f"{name}.actnorms.{i}.logs"] = _t(p[f"actnorm_{i}"]["logs"])
        sd[f"{name}.actnorms.{i}.bias"] = _t(p[f"actnorm_{i}"]["bias"])
        sd[f"{name}.invconvs.{i}.weight"] = _t(p[f"invconv_{i}"]["weight"])
        i += 1
    _couplings(sd, name, p)


def _fvae(sd: dict, name: str, p: Mapping) -> None:
    _conv(sd, f"{name}.g_pre_net", p["g_pre_net"])
    for part in ("encoder", "decoder"):
        q, prefix = p[part], f"{name}.{part}"
        (_conv_transpose if part == "decoder" else _conv)(sd, f"{prefix}.pre", q["pre"])
        _wn(sd, f"{prefix}.wn", q["wn"])
        _linear(sd, f"{prefix}.out_proj", q["out_proj"])
    if "prior_flow" in p:
        _couplings(sd, f"{name}.prior_flow", p["prior_flow"])


def portaspeech_params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``PortaSpeech`` or ``PortaSpeechFlow`` params -> ``state_dict``
    of the port's: the phone and word encoders (``FastSpeechEncoder``),
    ``ph2word_encoder`` (``FFTBlocks``), the projections, the postnet
    (``ConvBlocks``), the duration predictor, the FVAE (its decoder's
    ``ConvTranspose`` kernel flipped), the embeddings; and the Glow
    post-flow with its condition projection."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _encoder(sd, "encoder", params["encoder"], hp["enc_layers"])
    n_word = hp.get("word_enc_layers", 4)
    if "word_encoder" in params:
        _encoder(sd, "word_encoder", params["word_encoder"], n_word)
    ph2word = params["ph2word_encoder"]
    sd["ph2word_encoder.pos_embed_alpha"] = _t(ph2word["pos_embed_alpha"])
    _encoder(sd, "ph2word_encoder", {"fft": ph2word}, n_word, embed=False)
    for n in ("enc_pos_proj", "dec_res_proj", "attn_q", "attn_k", "attn_v", "word_pos_proj",
              "spk_embed_proj", "post_flow_cond_proj"):
        if n in params:
            _linear(sd, n, params[n])
    if "text_encoder_postnet" in params:
        _conv_blocks(sd, "text_encoder_postnet.", params["text_encoder_postnet"], 3, 2)
    _predictor(sd, "dur_predictor", params["dur_predictor"], hp["dur_predictor_layers"],
               "linear.0")
    _fvae(sd, "fvae", params["fvae"])
    for n in ("pitch_embed", "spk_id_proj"):
        if n in params:
            _embedding(sd, n, params[n])
    if "post_flow" in params:
        _glow(sd, "post_flow", params["post_flow"])
    return sd


def multi_window_disc_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``MultiWindowDiscriminator`` params (``disc_win<w>``: ``conv_{i}``
    2-D kernels ``[kh, kw, in, out]``, ``norm_{i}`` LayerNorms,
    ``adv_layer`` over the channel-last flattening) -> ``state_dict`` of
    the port's (``discs.{k}.convs.{i}``, ``discs.{k}.norms.{i}``,
    ``discs.{k}.adv_layer``; windows in ascending order)."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    wins = sorted(int(k[len("disc_win"):]) for k in params if k.startswith("disc_win"))
    for k, win in enumerate(wins):
        d, name = params[f"disc_win{win}"], f"discs.{k}"
        for i in range(3):
            _conv2d(sd, f"{name}.convs.{i}", d[f"conv_{i}"])
        for i in range(2):
            _layer_norm(sd, f"{name}.norms.{i}", d[f"norm_{i}"])
        _linear(sd, f"{name}.adv_layer", d["adv_layer"])
    return sd


def voice_encoder_params_from_jax(p: Mapping, n_layers: int = 3) -> dict[str, torch.Tensor]:
    """JAX ``VoiceEncoder`` params (``lstm_l{i}`` in torch's gate layout,
    ``linear``) -> ``state_dict`` of the port's (resemblyzer's names)."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"lstm.{name}_l{i}"] = _t(p[f"lstm_l{i}"][name])
    _linear(sd, "linear", p["linear"])
    return sd
