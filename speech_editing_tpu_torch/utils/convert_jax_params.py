"""Flax parameter trees (as numpy) -> the port's ``state_dict``s.

The port's parameter names are the reference torch layout; the layout
differences handled here:

* flax ``Conv`` kernel ``[k, in, out]`` -> torch ``Conv1d`` ``[out, in, k]``;
* flax ``Dense`` kernel ``[in, out]`` -> torch ``Linear`` ``[out, in]``;
* flax ``LayerNorm`` and ``GroupNorm`` ``scale`` -> ``weight``;
* attention ``DenseGeneral`` q/k/v ``[E, h, d]`` -> packed
  ``in_proj_weight [3E, E]``; out ``[h, d, E]`` -> ``out_proj.weight [E, E]``;
* flax ``ConvTranspose`` kernel ``[k, in, out]`` is flipped along k
  relative to torch ``ConvTranspose1d`` ``[in, out, k]``.
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


def _encoder(sd: dict, name: str, p: Mapping, num_layers: int) -> None:
    _embedding(sd, f"{name}.embed_tokens", p["embed_tokens"])
    fft = p["fft"]
    for i in range(num_layers):
        lp, prefix = fft[f"layers_{i}"], f"{name}.layers.{i}.op"
        _layer_norm(sd, f"{prefix}.layer_norm1", lp["layer_norm1"])
        _layer_norm(sd, f"{prefix}.layer_norm2", lp["layer_norm2"])
        att = lp["self_attn"]
        e = np.asarray(att["q_proj"]["kernel"]).shape[0]
        sd[f"{prefix}.self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(att[k]["kernel"]).reshape(e, e).T
             for k in ("q_proj", "k_proj", "v_proj")]))
        sd[f"{prefix}.self_attn.out_proj.weight"] = _t(
            np.asarray(att["out_proj"]["kernel"]).reshape(e, e).T)
        _conv(sd, f"{prefix}.ffn.ffn_1", lp["ffn"]["ffn_1"])
        _linear(sd, f"{prefix}.ffn.ffn_2", lp["ffn"]["ffn_2"])
    _layer_norm(sd, f"{name}.layer_norm", fft["layer_norm"])


def text_conv_encoder_params_from_jax(p: Mapping, n_blocks: int, layers_in_block: int = 2,
                                      prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ``TextConvEncoder`` params -> ``state_dict`` of the port's, keys
    prefixed by ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    _embedding(sd, f"{prefix}embed_tokens", p["embed_tokens"])
    conv = p["conv"]
    for j in range(n_blocks):
        for i in range(layers_in_block):
            rp, name = conv[f"res_{j}"], f"{prefix}res_blocks.{j}.blocks.{i}"
            _layer_norm(sd, f"{name}.0", rp[f"norm_{i}"])
            _conv(sd, f"{name}.1", rp[f"conv_{i}"])
            _conv(sd, f"{name}.4", rp[f"proj_{i}"])
    _layer_norm(sd, f"{prefix}last_norm", conv["last_norm"])
    _conv(sd, f"{prefix}post_net1", conv["post_net1"])
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


def params_from_jax(params: Mapping, hp: Any) -> dict[str, torch.Tensor]:
    """JAX ``GaussianDiffusion`` params (numpy leaves; a ``{"params": ...}``
    wrapper is accepted) -> ``state_dict`` of the port's GaussianDiffusion."""
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    fs = params["fs"]
    if hp.get("encoder_type", "fft") == "conv":
        sd.update(text_conv_encoder_params_from_jax(
            fs["encoder"], len(hp["enc_dilations"]), hp.get("layers_in_block", 2),
            "fs.encoder."))
    else:
        _encoder(sd, "fs.encoder", fs["encoder"], hp["enc_layers"])
    if "spk_id_proj" in fs:
        _embedding(sd, "fs.spk_id_proj", fs["spk_id_proj"])
    if "spk_embed_proj" in fs:
        _linear(sd, "fs.spk_embed_proj", fs["spk_embed_proj"])
    _embedding(sd, "fs.dur_embed", fs["dur_embed"])
    _predictor(sd, "fs.dur_predictor", fs["dur_predictor"],
               hp["dur_predictor_layers"], "linear.0")
    if hp.get("use_pitch_embed"):
        _embedding(sd, "fs.pitch_embed", fs["pitch_embed"])
        _predictor(sd, "fs.pitch_predictor", fs["pitch_predictor"], 5, "linear")
    me = params["mel_encoder"]
    _linear(sd, "mel_encoder.encoder.0", me["fc1"])
    _linear(sd, "mel_encoder.encoder.2", me["fc2"])
    _linear(sd, "mel_encoder.fc_out", me["fc_out"])
    sd.update(diffnet_params_from_jax(params["denoise_fn"], hp["residual_layers"],
                                      "denoise_fn."))
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
