"""PyTorch port, ``evals/`` against the JAX package on CPU: every function
of ``dtw``, ``mcd``, ``stoi``, ``pesq_np``, ``pesq_metric``,
``get_metrics``, ``batch_tools`` and ``attention_metrics``, and the
``get_metrics`` and ``batch_tools`` command lines, on seeded wav pairs in
a test run's ``[G_SEG]``/``[P_SEG]`` layout, within 1e-6 relative."""

import importlib
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from speech_editing_tpu.evals import attention_metrics as jam
from speech_editing_tpu.evals import batch_tools as jbt
from speech_editing_tpu.evals import dtw as jdtw
from speech_editing_tpu.evals import get_metrics as jgm
from speech_editing_tpu.evals import mcd as jmcd
from speech_editing_tpu.evals import pesq_metric as jpm
from speech_editing_tpu.evals import pesq_np as jpn
from speech_editing_tpu_torch.evals import attention_metrics as tam
from speech_editing_tpu_torch.evals import batch_tools as tbt
from speech_editing_tpu_torch.evals import dtw as tdtw
from speech_editing_tpu_torch.evals import get_metrics as tgm
from speech_editing_tpu_torch.evals import mcd as tmcd
from speech_editing_tpu_torch.evals import pesq_metric as tpm
from speech_editing_tpu_torch.evals import pesq_np as tpn
from speech_editing_tpu_torch.utils.audio.io import load_wav, save_wav
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)

# the packages' ``evals/__init__`` export the function ``stoi``, which hides the module
jstoi = importlib.import_module("speech_editing_tpu.evals.stoi")
tstoi = importlib.import_module("speech_editing_tpu_torch.evals.stoi")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 22050
REL = dict(rtol=1e-6, atol=0)


def voice(seconds, f0, seed, noise=0.0):
    rs = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    wav = sum(0.25 / k * np.sin(2 * np.pi * f0 * k * t) for k in (1, 2, 3))
    wav = wav * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (wav + noise * rs.randn(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    """A test run's ``generated_*`` directory: ``wavs/`` with [G]/[P] and
    [G_SEG]/[P_SEG] wavs of three items, and ``meta.csv``."""
    d = tmp_path_factory.mktemp("generated_10_test")
    os.makedirs(d / "wavs")
    for i, (sec, f0) in enumerate(((1.0, 140), (0.8, 190), (1.3, 110))):
        gt, pred = voice(sec, f0, i, 0.005), voice(sec * 0.97, f0 * 1.03, i + 10, 0.02)
        for tag, w in (("G", gt), ("P", pred), ("G_SEG", gt[: len(gt) // 2]),
                       ("P_SEG", pred[: len(pred) // 2 + 300])):
            save_wav(w, str(d / "wavs" / f"[{tag}]item{i}.wav"), SR)
    (d / "meta.csv").write_text("item_name,dur_loss,mcd,wav_fn\n"
                                "item0,0.5,3.25,a.wav\nitem1,0.7,4.5,b.wav\n"
                                "item2,0.25,5.0,c.wav\n")
    return str(d)


def _same(got, ref):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _same(a, b)
    elif isinstance(ref, (list, str)) or ref is None:
        assert got == ref
    else:
        np.testing.assert_allclose(got, ref, **REL)


def test_dtw_matches_jax():
    rs = np.random.RandomState(0)
    for tx, ty in ((20, 20), (13, 29), (40, 7)):
        x, y = rs.randn(tx, 5), rs.randn(ty, 5)
        _same(tdtw.dtw_path(x, y), jdtw.dtw_path(x, y))


def test_mcd_matches_jax(gen_dir):
    pat = os.path.join(gen_dir, "wavs", "*")
    pairs = tmcd.seg_pairs(pat)
    assert pairs == jmcd.seg_pairs(pat) and len(pairs) == 3
    wav, _ = load_wav(pairs[0][0], SR)
    _same(tmcd.wav_mfcc(wav), jmcd.wav_mfcc(wav))
    for p in pairs[:2]:
        for use_dtw in (False, True):
            _same(tmcd.cal_mcd(p, use_dtw), jmcd.cal_mcd(p, use_dtw))
    _same(tmcd.cal_mcd_with_wave_batch(pat), jmcd.cal_mcd_with_wave_batch(pat))
    rs = np.random.RandomState(1)
    m1, m2 = np.abs(rs.randn(50, 80)) + 0.1, np.abs(rs.randn(61, 80)) + 0.1
    for take_log in (False, True):
        _same(tmcd.mel_mfcc_kubichek(m1.T, 16, take_log),
              jmcd.mel_mfcc_kubichek(m1.T, 16, take_log))
        for use_dtw in (False, True):
            _same(tmcd.get_metrics_mels(m1, m2, take_log=take_log, use_dtw=use_dtw),
                  jmcd.get_metrics_mels(m1, m2, take_log=take_log, use_dtw=use_dtw))


def test_stoi_and_pesq_match_jax(gen_dir):
    pat = os.path.join(gen_dir, "wavs", "*")
    clean = voice(1.2, 150, 0)
    noisy = clean + 0.1 * np.random.RandomState(1).randn(len(clean)).astype(np.float32)
    _same(tstoi.stoi(clean, noisy, SR), jstoi.stoi(clean, noisy, SR))
    _same(tstoi._thirdoct(), jstoi._thirdoct())
    _same(tstoi.cal_stoi_with_waves_batch(pat), jstoi.cal_stoi_with_waves_batch(pat))
    a, b = clean[::2][:16000], noisy[::2][:16000]
    _same(tpn.pesq_np(16000, a, b), jpn.pesq_np(16000, a, b))
    _same(tpn.pesq_np(8000, a[:8000], b[:8000]), jpn.pesq_np(8000, a[:8000], b[:8000]))
    _same(tpm.cal_pesq(a, b), jpm.cal_pesq(a, b))
    _same(tpm.cal_pesq_with_waves_batch(pat), jpm.cal_pesq_with_waves_batch(pat))
    with pytest.raises(ValueError):
        tpn.pesq_np(16000, a[:100], b[:100])


def test_get_metrics_and_its_command_line_match_jax(gen_dir):
    pat = os.path.join(gen_dir, "wavs", "*")
    got, ref = tgm.compute_all(pat), jgm.compute_all(pat)
    assert sorted(got) == sorted(ref) == ["mcd", "pesq", "stoi"]
    for k in ref:
        _same(got[k], ref[k])
        assert np.isfinite(got[k]), k
    outs = []
    for package in ("speech_editing_tpu", "speech_editing_tpu_torch"):
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-m", f"{package}.evals.get_metrics", pat],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(res.stdout.strip().splitlines()[-1])
    ref_line, line = outs
    nums = [float(x.split("=")[1].strip(" .")) for x in line.split(";")]
    ref_nums = [float(x.split("=")[1].strip(" .")) for x in ref_line.split(";")]
    np.testing.assert_allclose(nums, ref_nums, **REL)
    assert line.startswith("MCD = ") and "STOI = " in line and "PESQ = " in line


def test_batch_tools_match_jax(gen_dir, tmp_path):
    pat = os.path.join(gen_dir, "wavs", "*")
    for fs in (16000, 22050, 24000, 44100, 48000):
        assert tbt.best_mcep_params(fs) == jbt.best_mcep_params(fs)
    c = np.random.RandomState(0).randn(20)
    for order, alpha in ((5, 0.0), (24, 0.42), (34, 0.45)):
        _same(tbt.freqt(c, order, alpha), jbt.freqt(c, order, alpha))
    wav = voice(0.5, 200, 3)
    for w in (wav, wav[:300]):      # the frames in one batch: the same bits
        np.testing.assert_array_equal(tbt.mcep_from_wav(w, SR), jbt.mcep_from_wav(w, SR))
    pair = tmcd.seg_pairs(pat)[0]
    _same(tbt.cal_mcd_sptk(pair), jbt.cal_mcd_sptk(pair))
    _same(tbt.cal_mcd_sptk_batch(pat), jbt.cal_mcd_sptk_batch(pat))
    _same(tbt.pitch_comparison_batch(pat), jbt.pitch_comparison_batch(pat))
    _same(tbt.pitch_dtw_batch(pat), jbt.pitch_dtw_batch(pat))
    meta = os.path.join(gen_dir, "meta.csv")
    assert tbt.meta_csv_stats(meta) == jbt.meta_csv_stats(meta)
    assert tbt.meta_csv_stats(meta, ["mcd"]) == jbt.meta_csv_stats(meta, ["mcd"])


@pytest.mark.parametrize("command", [["mcd", "{pat}"], ["pitch", "{pat}"],
                                     ["pitch", "{pat}", "--dtw"], ["stats", "{meta}"],
                                     ["separate", "{gen}"]],
                         ids=["mcd", "pitch", "pitch_dtw", "stats", "separate"])
def test_batch_tools_command_lines_match_jax(gen_dir, tmp_path, command):
    outs = []
    for package, mod in (("jax", jbt), ("port", tbt)):
        gen = str(tmp_path / package)
        if command[0] == "separate":
            os.makedirs(gen)
            os.symlink(os.path.join(gen_dir, "wavs"), os.path.join(gen, "wavs"))
        argv = [a.format(pat=os.path.join(gen_dir, "wavs", "*"), gen=gen,
                         meta=os.path.join(gen_dir, "meta.csv")) for a in command]
        out = io.StringIO()
        with redirect_stdout(out):
            mod.main(argv)
        text = out.getvalue().replace(gen, "<gen>")
        if command[0] == "separate":
            text += repr({sub: sorted(os.listdir(os.path.join(gen, sub)))
                          for sub in ("gt", "gen")})
        outs.append(text)
    assert outs[0] == outs[1] and outs[1]


def test_attention_metrics_match_jax():
    rs = np.random.RandomState(0)
    b, t_dec, t_enc = 2, 40, 12
    attn = rs.rand(b, t_dec, t_enc)
    attn /= attn.sum(-1, keepdims=True)
    src_pad = np.zeros((b, t_enc))
    src_pad[1, 9:] = 1
    tgt_pad = np.zeros((b, t_dec))
    tgt_pad[1, 30:] = 1
    seg = np.zeros((b, t_enc))
    seg[0, :2] = 1
    ks = np.asarray([t_dec / t_enc, 30 / 9])
    for pads in ((None, None), (src_pad, tgt_pad)):
        _same(tam.get_focus_rate(attn, *pads), jam.get_focus_rate(attn, *pads))
        _same(tam.get_phone_coverage_rate(attn, pads[0], seg, pads[1]),
              jam.get_phone_coverage_rate(attn, pads[0], seg, pads[1]))
        _same(tam.get_diagonal_focus_rate(attn, ks, np.asarray([40, 30]), *pads, band_width=3),
              jam.get_diagonal_focus_rate(attn, ks, np.asarray([40, 30]), *pads, band_width=3))
    spec = rs.randn(30, 20)
    _same(tam.laplace_var(spec), jam.laplace_var(spec))
    f0a, f0b = 100 + 20 * rs.rand(25), 100 + 20 * rs.rand(31)
    _same(tam.pitch_dtw_distance(f0a, f0b), jam.pitch_dtw_distance(f0a, f0b))
