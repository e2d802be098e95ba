"""The flagship FluentSpeech configuration (``egs/spec_denoiser.yaml`` sizes,
with the training keys of ``egs/base.yaml``) and the HiFi-GAN V1 generator
that vocodes it."""

from __future__ import annotations

FLAGSHIP_HP = {
    "hidden_size": 192, "enc_layers": 4, "enc_ffn_kernel_size": 5, "num_heads": 2,
    "encoder_type": "fft", "audio_num_mel_bins": 80, "dur_predictor_layers": 3,
    "dur_predictor_kernel": 5, "predictor_kernel": 5, "use_pitch_embed": True,
    "use_spk_embed": False, "use_spk_id": False, "residual_layers": 20,
    "residual_channels": 256, "dilation_cycle_length": 1, "timesteps": 8,
    "schedule_type": "vpsde", "frames_multiple": 1, "use_uv": True,
    "pitch_type": "frame",
    # training: predictors, losses, optimizer (float32; the JAX package's
    # flagship trains in bf16)
    "predictor_dropout": 0.2, "predictor_grad": 0.1, "timescale": 1,
    "lambda_ph_dur": 0.1, "lambda_word_dur": 1.0, "lambda_sent_dur": 0.0,
    "lambda_uv": 1.0, "lambda_f0": 1.0, "mel_losses": "l1:0.5|ssim:0.5",
    "lr": 2e-4, "scheduler": "warmup", "warmup_updates": 8000,
    "clip_grad_norm": 1, "clip_grad_value": 0,
    "optimizer_adam_beta1": 0.9, "optimizer_adam_beta2": 0.98, "weight_decay": 0,
    "max_tokens": 40000,
}

HIFIGAN_V1_HP = {
    "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
