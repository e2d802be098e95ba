"""The flagship FluentSpeech configuration (``egs/spec_denoiser.yaml`` sizes)
and the HiFi-GAN V1 generator that vocodes it."""

from __future__ import annotations

FLAGSHIP_HP = {
    "hidden_size": 192, "enc_layers": 4, "enc_ffn_kernel_size": 5, "num_heads": 2,
    "encoder_type": "fft", "audio_num_mel_bins": 80, "dur_predictor_layers": 3,
    "dur_predictor_kernel": 5, "predictor_kernel": 5, "use_pitch_embed": True,
    "use_spk_embed": False, "use_spk_id": False, "residual_layers": 20,
    "residual_channels": 256, "dilation_cycle_length": 1, "timesteps": 8,
    "schedule_type": "vpsde", "frames_multiple": 1, "use_uv": True,
    "pitch_type": "frame",
}

HIFIGAN_V1_HP = {
    "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
