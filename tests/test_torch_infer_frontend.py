"""PyTorch port, the region-edit API's host front end against the JAX
package: the copied numpy modules (text processors, TextGrid alignment,
STFT and ``wav2spec``, wav IO, Griffin-Lim, the autocorrelation pitch
tracker, the edit API's helpers) and the host edit math (durations to
mel2ph, the frame-level splice, the MFA preparation) are held equal to the
JAX functions on seeded inputs: ``np.array_equal``, or ``==``."""

import os
import subprocess
import types

import numpy as np
import pytest

import speech_editing_tpu.infer.spec_denoiser as jsd
import speech_editing_tpu_torch.infer.spec_denoiser as psd
from speech_editing_tpu.infer import infer_utils as jiu
from speech_editing_tpu.utils.audio import align as jalign
from speech_editing_tpu.utils.audio import dsp as jdsp
from speech_editing_tpu.utils.audio import griffin_lim as jgl
from speech_editing_tpu.utils.audio import io as jio
from speech_editing_tpu.utils.audio import pitch as jpitch
from speech_editing_tpu.utils.text import processors as jproc
from speech_editing_tpu.utils.text.text_encoder import TokenTextEncoder as JEncoder
from speech_editing_tpu_torch.infer import infer_utils as piu
from speech_editing_tpu_torch.utils.audio import align as palign
from speech_editing_tpu_torch.utils.audio import dsp as pdsp
from speech_editing_tpu_torch.utils.audio import griffin_lim as pgl
from speech_editing_tpu_torch.utils.audio import io as pio
from speech_editing_tpu_torch.utils.audio import pitch as ppitch
from speech_editing_tpu_torch.utils.text import processors as pproc
from speech_editing_tpu_torch.utils.text.text_encoder import TokenTextEncoder as PEncoder
from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

SR, HOP = 22050, 256
TEXTS = ["this is a test sentence", "Hello, World! It's 1,250 dollars; $3 at 4.5%.",
         "the quick-brown fox jumped over the lazy dog's back",
         "Café naïve résumé: 21st century (100) cats?", "  spaces   and -- dashes  "]
# (text, edited text, region, edited region): a lengthening, a shortening, a
# same-length edit, and an edit whose tail differs outside the stated region
# (the unchanged tail re-phonemized differently, as a context-dependent g2p
# would give it)
EDITS = [
    ("this is a test sentence", "this is a wonderful test sentence", "[3,4]", "[3,5]"),
    ("the quick brown fox jumped over the dog", "the fox jumped over the dog", "[2,4]", "[2,2]"),
    ("the cat sat on the mat", "the dog sat on the mat", "[2,2]", "[2,2]"),
    ("the cat sat on the mat", "the dog sat on the mats", "[2,2]", "[2,2]"),
]


def equal(a, b) -> bool:
    """Equal values and types, arrays by ``np.array_equal`` with their dtypes."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(equal, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def harmonic_wav(seconds: float, f0: float, seed: int) -> np.ndarray:
    n = int(seconds * SR)
    t_ax = np.arange(n) / SR
    wav = sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t_ax) for k in range(1, 7))
    wav = wav * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ax))
    return (wav + 0.01 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def write_textgrid(path: str, text: str, n_frames: int, lead: int = 6,
                   tail: int = 9) -> None:
    """A phone tier for ``text``'s fallback-g2p phones spread evenly over
    ``n_frames`` between a leading and a trailing silence, in the long
    TextGrid form MFA writes."""
    ph, *_ = pproc.txt_to_ph(pproc.get_txt_processor_cls("en"), text)
    phones = [p for p in ph.split(" ") if not is_sil_phoneme(p)]
    bounds = lead + np.round(np.linspace(0, n_frames - lead - tail, len(phones) + 1)).astype(int)
    sec = lambda f: float(f * HOP / SR)
    ivs = ([(0.0, sec(lead), "")]
           + [(sec(a), sec(b), p) for a, b, p in zip(bounds[:-1], bounds[1:], phones)]
           + [(sec(bounds[-1]), sec(n_frames), "")])
    end = sec(n_frames)
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {end!r}", "tiers? <exists>", "size = 1", "item []:", "    item [1]:",
             '        class = "IntervalTier"', '        name = "phones"', "        xmin = 0",
             f"        xmax = {end!r}", f"        intervals: size = {len(ivs)}"]
    for k, (a, b, m) in enumerate(ivs, 1):
        lines += [f"        intervals [{k}]:", f"            xmin = {a!r}",
                  f"            xmax = {b!r}", f'            text = "{m}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def phone_list() -> list:
    """Every phone the fallback g2p writes for ``EDITS``."""
    tp = pproc.get_txt_processor_cls("en")
    return sorted({p for row in EDITS for text in row[:2]
                   for p in pproc.txt_to_ph(tp, text)[0].split(" ")})


# -- text --------------------------------------------------------------------------

@pytest.mark.parametrize("text", TEXTS)
def test_text_processing_equals_jax(text):
    assert pproc.normalize_numbers(text) == jproc.normalize_numbers(text)
    assert (pproc.EnTxtProcessor.preprocess_text(text)
            == jproc.EnTxtProcessor.preprocess_text(text))
    assert equal(pproc.txt_to_ph(pproc.get_txt_processor_cls("en"), text),
                 jproc.txt_to_ph(jproc.get_txt_processor_cls("en"), text))


def test_fallback_g2p_is_the_jax_table():
    assert pproc._FallbackG2p.DIGRAPHS == jproc._FallbackG2p.DIGRAPHS
    assert pproc._FallbackG2p.SINGLE == jproc._FallbackG2p.SINGLE
    assert type(pproc._get_g2p()).__name__ == type(jproc._get_g2p()).__name__
    for text in TEXTS:
        t = jproc.EnTxtProcessor.preprocess_text(text).strip()
        assert pproc._FallbackG2p()(t) == jproc._FallbackG2p()(t)


# -- alignment ---------------------------------------------------------------------

@pytest.mark.parametrize("encoding", ["utf-8", "utf-16", "utf-8-sig"])
def test_textgrid_and_mel2ph_equal_jax(tmp_path, encoding):
    text, n_frames = EDITS[1][0], 130
    path = str(tmp_path / "a.TextGrid")
    write_textgrid(path, text, n_frames)
    raw = open(path).read().encode(encoding)
    open(path, "wb").write(raw)
    got, ref = palign.read_textgrid(path), jalign.read_textgrid(path)
    assert got.keys() == ref.keys() and len(got["phones"]) == len(ref["phones"]) > 10
    for a, b in zip(got["phones"], ref["phones"]):
        assert (a.min_time, a.max_time, a.mark) == (b.min_time, b.max_time, b.mark)
    ph, *_ = pproc.txt_to_ph(pproc.get_txt_processor_cls("en"), text)
    mel = np.zeros((n_frames, 80), np.float32)
    for min_sil in (0.0, 0.1):
        args = (path, ph, mel, HOP, SR, min_sil)
        assert equal(palign.get_mel2ph(*args), jalign.get_mel2ph(*args))
    ph_token = list(range(len(ph.split(" "))))
    assert equal(piu.get_align_from_mfa_output(path, ph, ph_token, mel),
                 jiu.get_align_from_mfa_output(path, ph, ph_token, mel))


def test_mel2token_to_dur_equals_jax():
    rs = np.random.RandomState(0)
    m2p = np.sort(rs.randint(0, 12, (3, 50)), axis=1)
    for args in ((m2p[0],), (m2p,), (m2p, 14), (m2p, 14, 3)):
        assert equal(palign.mel2token_to_dur(*args), jalign.mel2token_to_dur(*args))


# -- dsp, io, Griffin-Lim, pitch ---------------------------------------------------

def test_stft_level_helpers_equal_jax():
    rs = np.random.RandomState(1)
    y = rs.randn(5000)
    for center in (True, False):
        assert equal(pdsp.frame_signal(y, 1024, 256, center),
                     jdsp.frame_signal(y, 1024, 256, center))
    spec = jdsp.stft(y, 1024, 256, 800)
    assert equal(pdsp.stft(y, 1024, 256, 800), spec)
    assert equal(pdsp.stft_window("hann", 800, 1024), jdsp.stft_window("hann", 800, 1024))
    for length in (None, 4000, 6000):
        assert equal(pdsp.istft(spec, 256, 800, length=length),
                     jdsp.istft(spec, 256, 800, length=length))
    mag = np.abs(spec)
    assert equal(pdsp.amp_to_db(mag), jdsp.amp_to_db(mag))
    assert equal(pdsp.normalize_spec(mag, -100), jdsp.normalize_spec(mag, -100))
    for sides in (1, 2):
        assert pdsp.pad_lr(y, 1024, 256, sides) == jdsp.pad_lr(y, 1024, 256, sides)


def test_wav2spec_and_wav_io_equal_jax(tmp_path):
    wav = harmonic_wav(1.3, 170, 2)
    path = str(tmp_path / "a.wav")
    pio.save_wav(wav, path, SR)
    ref_path = str(tmp_path / "b.wav")
    jio.save_wav(wav, ref_path, SR)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    assert equal(pio.load_wav(path), jio.load_wav(path))
    assert equal(pio.load_wav(path, 16000), jio.load_wav(path, 16000))
    kw = dict(fft_size=1024, hop_size=256, win_length=1024, num_mels=80, fmin=55, fmax=7600,
              sample_rate=SR)
    for src in (wav, path):
        for loud in (False, True):
            assert equal(pdsp.wav2spec(src, loud_norm=loud, **kw),
                         jdsp.wav2spec(src, loud_norm=loud, **kw))


def test_griffin_lim_equals_jax():
    mel = jdsp.wav2spec(harmonic_wav(0.4, 200, 3), fmin=55, fmax=7600)["mel"]
    assert equal(pgl.mel2wav_griffin_lim(mel, n_iters=4), jgl.mel2wav_griffin_lim(mel, n_iters=4))


@pytest.mark.parametrize("name", ["autocorr", "parselmouth"])
def test_pitch_tracker_equals_jax(name):
    wav = harmonic_wav(0.9, 140, 4)
    wav[: SR // 5] = 0.0    # a silent, unvoiced stretch
    args = (name, wav, HOP, SR)
    assert equal(ppitch.extract_pitch(*args, f0_min=80, f0_max=600),
                 jpitch.extract_pitch(*args, f0_min=80, f0_max=600))
    mel = np.zeros((len(wav) // HOP + 3, 80), np.float32)
    assert equal(piu.extract_f0_uv(wav, mel), jiu.extract_f0_uv(wav, mel))


# -- regions and the host edit math ------------------------------------------------

def test_region_helpers_equal_jax():
    for s in ("[4,6]", "[9,9][2,3]", "[0,2][1,1]", ""):
        assert piu.parse_region_list_from_str(s) == jiu.parse_region_list_from_str(s)
    tp = pproc.get_txt_processor_cls("en")
    for text, _, region, _ in EDITS:
        words = pproc.txt_to_ph(tp, text)[2].split(" ")
        regions = piu.parse_region_list_from_str(region)
        assert (piu.get_words_region_from_origintxt_region(words, regions)
                == jiu.get_words_region_from_origintxt_region(words, regions))


@pytest.fixture(scope="module")
def edit_items(tmp_path_factory):
    """Each ``EDITS`` row preprocessed by both packages' ``preprocess_input``
    (TextGrid alignment, f0 of a harmonic wav), as (port item, JAX item)."""
    tmp = tmp_path_factory.mktemp("frontend")
    hp = {"hop_size": HOP, "audio_sample_rate": SR, "f0_min": 80, "f0_max": 600,
          "language": "en"}
    phones = phone_list()
    port = types.SimpleNamespace(hp=hp, ph_encoder=PEncoder(phones))
    jax_ = types.SimpleNamespace(hp=hp, ph_encoder=JEncoder(phones))
    items = []
    for i, (text, edited, region, edited_region) in enumerate(EDITS):
        wav = harmonic_wav(1.2 + 0.3 * i, 120 + 20 * i, i)
        mel = jdsp.wav2spec(wav, fmin=55, fmax=7600)["mel"]
        tg = str(tmp / f"{i}.TextGrid")
        write_textgrid(tg, text, mel.shape[0])
        inp = dict(item_name=f"row{i}", text=text, edited_text=edited, region=region,
                   edited_region=edited_region, mel=mel, wav=wav, mfa_textgrid=tg)
        got = psd.SpecDenoiserInfer.preprocess_input(port, inp)
        ref = jsd.SpecDenoiserInfer.preprocess_input(jax_, inp)
        items.append((got, ref))
    return items


def test_preprocess_input_equals_jax(edit_items):
    for got, ref in edit_items:
        assert equal(got, ref)


@pytest.mark.parametrize("fm", [1, 4])
@pytest.mark.parametrize("row", range(len(EDITS)))
def test_duration_regulation_and_splice_equal_jax(edit_items, row, fm, capsys):
    got_item, item = edit_items[row]
    assert equal(psd.dur_inpaint_prep(got_item), jsd.dur_inpaint_prep(item))
    rs = np.random.RandomState(row)
    dur_pred = (rs.rand(len(item["edited_ph_token"])) * 6).astype(np.float32)
    regulated = psd.dur_to_mel2ph(got_item, dur_pred, fm)
    assert equal(regulated, jsd.dur_to_mel2ph(item, dur_pred, fm))
    got = psd.splice_edit(got_item, *regulated, fm)
    ref = jsd.splice_edit(item, *regulated, fm)
    assert equal(got, ref)
    n_orig, n_edit = (int(np.sum(item["ph2word"] > item["words_region"][0][1])),
                      int(np.sum(item["edited_ph2word"] > item["edited_words_region"][0][1])))
    # the last row reaches the tail rank remap; the others the constant offset
    assert (n_orig != n_edit) == (row == len(EDITS) - 1)
    assert ("tail g2p mismatch" in capsys.readouterr().out) == (row == len(EDITS) - 1)
    assert got["t_new"] % fm == 0 and got["mel2ph"].max() <= len(item["edited_ph_token"])


def test_data_preprocess_writes_what_jax_writes(tmp_path, monkeypatch):
    csv_path = tmp_path / "edits.csv"
    rows = ["id,item_name,text,edited_text,wav_fn_orig,edited_region,region"]
    for i, (text, edited, region, edited_region) in enumerate(EDITS):
        wav_fn = str(tmp_path / f"{i}.wav")
        pio.save_wav(harmonic_wav(0.3, 150, i), wav_fn, SR)
        rows.append(f'{i},row{i},"{text}","{edited}",{wav_fn},"{edited_region}","{region}"')
    csv_path.write_text("\n".join(rows) + "\n")
    assert equal(psd.load_dataset_info(str(csv_path)), jsd.load_dataset_info(str(csv_path)))
    commands = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, check: commands.append(cmd))
    outputs = {}
    for name, mod in (("port", psd), ("jax", jsd)):
        base = tmp_path / name
        os.makedirs(base / "mfa_out")
        info = mod.data_preprocess(str(csv_path), str(base / "in"), str(base / "dict.txt"),
                                   "model.zip", str(base / "mfa_out"))
        assert not (base / "mfa_out").exists()    # cleared for the aligner
        labs = {f: (base / "in" / f).read_bytes() for f in sorted(os.listdir(base / "in"))}
        outputs[name] = (info, labs, (base / "dict.txt").read_text(), commands[-1])
        assert mod.data_preprocess(str(csv_path), "x", "y", "z", str(base / "mfa_out"),
                                   align=False)[0]["mfa_textgrid"] == \
            str(base / "mfa_out" / "row0.TextGrid")
    (p_info, p_labs, p_dict, p_cmd), (j_info, j_labs, j_dict, j_cmd) = \
        outputs["port"], outputs["jax"]
    strip = lambda info, name: [{k: v.replace(str(tmp_path / name), "") for k, v in d.items()}
                                for d in info]
    assert strip(p_info, "port") == strip(j_info, "jax") and len(p_info) == len(EDITS)
    assert p_labs == j_labs and len(p_labs) == 2 * len(EDITS)
    assert p_dict == j_dict and p_dict.count("\n") > 10
    assert [c.replace(str(tmp_path / "port"), "") for c in p_cmd] == \
        [c.replace(str(tmp_path / "jax"), "") for c in j_cmd]
    assert p_cmd[:2] == ["mfa", "align"]
