"""PyTorch port, the gradio demo (``infer/gradio_app.py``) against the JAX
package's, with a stub ``gradio`` module in ``sys.modules`` (gradio is not
installed): the form's wiring, and the ``edit`` callbacks of both apps on
one seeded JAX checkpoint and one 44.1 kHz stereo int16 clip (int16 in,
downmix, resampling to 22,050 Hz, the uniform alignment without MFA, int16
out). With JAX's request draws and duration rounding replayed in the port
(as ``tests/test_torch_infer_edit.py`` does), the edited mel agrees within
the 1e-3 that ``tests/test_torch_infer_run.py`` holds ``--infer`` to and the
int16 outputs within 1e-3 of full scale. Without gradio ``build_app``
raises JAX's ImportError; without MFA ``_align_textgrid`` is None.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import speech_editing_tpu.infer.spec_denoiser as jsd
import speech_editing_tpu_torch.infer.spec_denoiser as psd
from speech_editing_tpu.infer.gradio_app import build_app as j_build_app
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer
from speech_editing_tpu.training.tasks.spec_denoiser import SpecDenoiserTask as JTask
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.infer import gradio_app
from tests.helpers import TINY_HP, perturb_biases
from tests.test_torch_infer_edit import _jax_durations
from tests.test_torch_infer_frontend import EDITS, harmonic_wav, phone_list
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

IN_SR = 44100


class _Component:
    def __init__(self, *a, **kw):
        self.kw = kw


class _Interface:
    def __init__(self, fn=None, inputs=None, outputs=None, title=None, description=None, **kw):
        self.fn, self.inputs, self.outputs, self.title = fn, inputs, outputs, title

    def launch(self, *a, **kw):
        raise RuntimeError("launch() is not called under test")


@pytest.fixture
def fake_gradio(monkeypatch):
    mod = types.ModuleType("gradio")
    mod.Interface, mod.Audio, mod.Textbox = _Interface, _Component, _Component
    monkeypatch.setitem(sys.modules, "gradio", mod)
    return mod


@pytest.fixture(scope="module")
def hp(tmp_path_factory):
    """A tiny JAX checkpoint (biases and DiffNet's output projection drawn
    non-zero, as trained weights have them) and its phone set."""
    tmp = tmp_path_factory.mktemp("gradio")
    data_dir, work_dir = str(tmp / "binary"), str(tmp / "work")
    os.makedirs(data_dir)
    with open(f"{data_dir}/phone_set.json", "w") as f:
        json.dump(phone_list(), f)
    hp = dict(TINY_HP, binary_data_dir=data_dir, work_dir=work_dir, infer=True,
              use_spk_embed=True, f0_min=80, f0_max=600, language="en",
              vocoder="GriffinLim", seed=1234)
    task = JTask(hp)
    rs = np.random.RandomState(0)
    t, s = 64, 10
    batch = {"txt_tokens": rs.randint(3, task.vocab_size, (1, s)),
             "time_mel_masks": np.zeros((1, t), np.float32),
             "mel2ph": np.clip(np.sort(rs.randint(1, s, (1, t))), 1, s),
             "mels": rs.randn(1, t, 80).astype(np.float32),
             "f0": rs.rand(1, t).astype(np.float32), "uv": np.zeros((1, t), np.float32),
             "spk_embed": np.zeros((1, 256), np.float32)}
    params = perturb_biases(task.init_model(task.build_model(), batch,
                                            jax.random.PRNGKey(0))["params"])
    out = params["denoise_fn"]["output_projection"]["kernel"]
    params["denoise_fn"]["output_projection"]["kernel"] = (
        rs.randn(*np.shape(out)) * 0.2).astype(np.float32)
    j_save_checkpoint(work_dir, TrainState.create(params, build_optimizer(hp)), 1)
    return hp


def stereo_clip() -> np.ndarray:
    """1.1 s at 44.1 kHz, int16, the right channel half the left's level."""
    mono = harmonic_wav(1.1 * IN_SR / 22050, 130, 3)[: int(1.1 * IN_SR)]
    return (np.stack([mono, 0.5 * mono], axis=1) * 32767 * 0.8).astype(np.int16)


def test_edit_callback_matches_jax(hp, fake_gradio, monkeypatch):
    text, edited, region, edited_region = EDITS[0]
    clip = stereo_clip()
    seen = {}
    j_forward = jsd.SpecDenoiserInfer.forward_model

    def record(self, item, *a, **kw):
        seen.update(jinf=self, item=item, out=j_forward(self, item, *a, **kw))
        return seen["out"]

    monkeypatch.setattr(jsd.SpecDenoiserInfer, "forward_model", record)
    japp = j_build_app(hp)
    j_sr, j_wav = japp.fn((IN_SR, clip), text, edited, region, edited_region)
    jinf, item, ref = seen["jinf"], seen["item"], seen["out"]

    # replay JAX's request draws and duration rounding in the port
    dur_ref = np.round(_jax_durations(jinf, item))
    key = jsd.request_prng_key(jax.random.PRNGKey(hp["seed"]), item)[None]
    t_new = ref[2].shape[0]
    noise = [torch.tensor(np.asarray(per_row_noise(key, step, (t_new, 80))))
             for step in range(hp["timesteps"], -1, -1)]
    p_forward = psd.SpecDenoiserInfer.forward_model
    got = {}

    def replay(self, p_item, *a, **kw):
        np.testing.assert_array_equal(p_item["mel"], item["mel"])
        np.testing.assert_array_equal(p_item["mel2ph"], item["mel2ph"])
        got["out"] = p_forward(self, p_item, noise=noise, dur_int=dur_ref)
        return got["out"]

    monkeypatch.setattr(psd.SpecDenoiserInfer, "forward_model", replay)
    app = gradio_app.build_app(hp, device="cpu")
    assert isinstance(app, _Interface) and len(app.inputs) == 5
    assert app.title == japp.title
    sr, wav = app.fn((IN_SR, clip), text, edited, region, edited_region)
    assert sr == j_sr == 22050
    assert wav.dtype == j_wav.dtype == np.int16 and wav.shape == j_wav.shape
    np.testing.assert_allclose(got["out"][2], ref[2], atol=1e-3, rtol=1e-3)
    diff = np.abs(wav.astype(np.int32) - j_wav.astype(np.int32)).max()
    print(f"int16 output: max difference {diff} of full scale 32767")
    assert diff <= 33
    assert np.abs(wav).max() > 100


def test_build_app_without_gradio_raises_jaxs_error(hp, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="the gradio demo needs `pip install gradio`"):
        gradio_app.build_app(hp, device="cpu")
    with pytest.raises(ImportError, match="the gradio demo needs `pip install gradio`"):
        j_build_app(hp)


def test_align_textgrid_is_none_without_mfa(hp):
    wav = harmonic_wav(0.5, 120, 0)
    assert gradio_app._align_textgrid(hp, wav, "this is a test") is None
    assert gradio_app._align_textgrid(dict(hp, mfa_dict="d", mfa_model="m"), wav,
                                      "this is a test") is None
