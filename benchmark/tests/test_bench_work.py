"""Operations and bytes against hand counts at small shapes."""

from benchmark import work
from benchmark.oracles import campnet, fluentspeech


def test_k1_counts():
    # C=2, H=1, 3 frames: conv 6->4, cond 1->4, out 2->4: 2*3*(24+4+8) FLOP
    flops, n_bytes = work.k1(3, 2, 1)
    assert flops == 2 * 3 * (6 * 4 + 1 * 4 + 2 * 4)
    # x (2), cond (1), x' (2), skip (2), mask (1) a frame; weights 24 + 4 + 8 + 12 biases
    assert n_bytes == 4 * (3 * (2 + 1 + 2 + 2 + 1) + (24 + 4 + 8 + 12))
    assert work.k1(3, 2, 1, with_h=True)[1] == n_bytes + 4 * 3 * 4


def test_k5_counts():
    flops, n_bytes = work.k5(5, 2)
    # dg = do (4) Wo^T -> 2: 2*4*2; dy = dh (4) Wd^T -> 6: 2*4*6; a frame
    assert flops == 5 * (2 * 4 * 2 + 2 * 4 * 6)
    assert n_bytes == 4 * (5 * (4 + 2 + 2 + 2 + 4 + 2 + 1) + 8 + 24)


def test_attention_counts():
    assert work.attention(2, 4, 3, 5) == 4 * 2 * 4 * 3 * 5
    assert work.attention(2, 4, 3, 5, backward=True) == 10 * 2 * 4 * 3 * 5


def test_bound_is_the_larger_of_products_and_bytes():
    peak, bw = work.PEAKS["tf32_flops"], work.PEAKS["hbm_bytes_per_s"]
    assert work.bound_s(peak, 1.0) == 1.0
    assert work.bound_s(1.0, bw * 2) == 2.0
    assert work.bound_s(work.PEAKS["bf16_flops"], 0.0, "bf16") == 1.0


def test_hifigan_by_hand():
    v = {"upsample_initial_channel": 4, "upsample_rates": [2], "upsample_kernel_sizes": [4],
         "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]]}
    pre = 2 * 7 * 80 * 4
    up = 2 * 4 * 2 * 4 / 2 * 2          # 4 -> 2 channels, 4 taps at stride 2, 2 samples
    res = 2 * 1 * 2 * 3 * 2 * 2 * 2     # one conv pair of 2x2x3 at 2 samples
    post = 2 * 7 * 2 * 2
    assert work.hifigan_frame(v) == pre + up + res + post


def test_diffnet_frame_by_hand():
    hp = {"residual_channels": 2, "hidden_size": 1, "residual_layers": 3,
          "audio_num_mel_bins": 5}
    block = 2 * 2 * 2 * (6 + 1 + 2)
    assert fluentspeech.diffnet_frame(hp) == 2 * 5 * 2 + 3 * block + 2 * 2 * 2 + 2 * 2 * 5


def test_each_configuration_counts_its_own_model():
    """A served edit's and a step's products come from the configuration's
    oracle: the same shapes give each model's own count."""
    from benchmark.harness import load_json

    step = dict(frames=300, tokens=40, frames_sq=300 * 300, frames_tokens=300 * 40,
                tokens_sq=40 * 40)
    counts = []
    for orc, name in ((fluentspeech, "fluentspeech"), (campnet, "campnet")):
        config = load_json(f"configs/{name}.json")
        voc = 300 * work.hifigan_frame(config["vocoder"])
        assert orc.edit_flops(config, 300, 40) > voc
        assert orc.train_flops(config, step) > 0
        counts.append(orc.edit_flops(config, 300, 40) - voc)
    fs = load_json("configs/fluentspeech.json")["hp"]
    assert counts[0] == 300 * (fluentspeech.conditioner_frame(fs) + fs["timesteps"]
                               * fluentspeech.diffnet_frame(fs)) \
        + 40 * fluentspeech.conditioner_token(fs)
    assert counts[0] != counts[1]
