"""PyTorch port, data-parallel serving and the multi-rank dry run on the
CPU: the batched inference program (reverse diffusion with per-row
injected noise, the composite into the reference mel, HiFi-GAN) on two
gloo ranks, each on its rows, gives every row of the single-process
program within 1e-5, and of JAX's ``serve_fn`` (the program of
``tests/test_parallel_serving.py``, JAX's own per-row noise injected)
within 1e-3; and ``parallel.dryrun.dryrun_multichip`` passes its data
parallel, tensor parallel (float32 and bf16) and serving phases on 2 and
4 ranks, where no kernel launches (the CPU runs the plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.vocoder import HifiGanGenerator as JHifiGan
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.training.tasks.spec_denoiser import build_model as j_build_model
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.parallel.dryrun import (TINY_VOCODER, dryrun_multichip,
                                                      serve_program, spawn_ranks)
from speech_editing_tpu_torch.utils.convert_jax_params import (params_from_jax,
                                                               vocoder_params_from_jax)
from tests import torch_parallel_workers as workers
from tests.helpers import TINY_HP, VOCAB, synth_batch
from tests.test_torch_model import _randomize
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

HP = dict(TINY_HP, use_spk_embed=False)


def test_dp_serving_matches_one_process_and_jax():
    b, t, s = 4, 96, 8
    batch = synth_batch(np.random.RandomState(0), B=b, S=s, T=t)
    batch = {k: batch[k] for k in ("txt_tokens", "mels", "mel2ph", "f0", "uv",
                                   "time_mel_masks")}
    tm = batch["time_mel_masks"][..., None].astype(np.float32)
    model, voc = j_build_model(VOCAB, HP), JHifiGan(hp=TINY_VOCODER)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.asarray(batch["txt_tokens"]), jnp.asarray(tm), jnp.asarray(batch["mel2ph"]), None,
        jnp.asarray(batch["mels"]), jnp.asarray(batch["f0"]), jnp.asarray(batch["uv"]))
    params = _randomize(variables["params"], 3)      # DiffNet's output drawn non-zero
    vparams = jax.jit(voc.init)(jax.random.PRNGKey(2), jnp.asarray(batch["mels"]))
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), i))
                     for i in range(b)])

    def serve_fn(params, vps, txt, tmask, m2p, ref, f0, uv, keys):
        out = model.apply({"params": params}, txt, tmask, m2p, None, ref, f0, uv,
                          infer=True, use_pred_pitch=True, rng=keys)
        comp = out["mel_out"] * tmask + ref * (1 - tmask)
        return comp, voc.apply(vps, comp)

    j_mel, j_wav = jax.jit(serve_fn)(params, vparams, batch["txt_tokens"], tm, batch["mel2ph"],
                                     batch["mels"], batch["f0"], batch["uv"], keys)
    noise = [torch.tensor(np.asarray(per_row_noise(jnp.asarray(keys), step, (t, 80))))
             for step in range(HP["timesteps"], -1, -1)]
    inputs = dict(hp=HP, vocab=VOCAB, weights=params_from_jax(params, HP), batch=batch,
                  noise=noise, vocoder_hp=TINY_VOCODER,
                  vocoder_weights=vocoder_params_from_jax(vparams, TINY_VOCODER))
    got = spawn_ranks(workers.serve_rows, 2, inputs)
    model_t = workers._gaussian_diffusion(inputs).eval()
    voc_t = HifiGanGenerator(TINY_VOCODER)
    voc_t.load_state_dict(inputs["vocoder_weights"])
    mel, wav = serve_program(model_t, voc_t.eval(), {k: torch.as_tensor(v)
                                                     for k, v in batch.items()}, noise)
    for out in got:
        assert out["rows"] == b // 2
        np.testing.assert_allclose(out["mel"].numpy(), mel.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["wav"].numpy(), wav.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0]["mel"].numpy(), np.asarray(j_mel), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[0]["wav"].numpy(), np.asarray(j_wav), atol=1e-3, rtol=0)
    assert float(np.abs(np.asarray(j_mel) - np.asarray(batch["mels"])).max()) > 1e-2


@pytest.mark.parametrize("n, dtypes", [(2, ("float32", "bfloat16")), (4, ("float32",))])
def test_dryrun_multichip_on_the_cpu(n, dtypes):
    report = dryrun_multichip(n, "cpu", dtypes=dtypes, steps=2)
    for dtype in dtypes:
        for kind in ("dp", "tp"):
            r = report[f"{kind} {dtype}"]
            assert np.all(np.isfinite(r["total_loss"]))
            np.testing.assert_allclose(r["total_loss"], r["ref_total_loss"], rtol=1e-5)
    assert report["serve"]["mel_max_abs"] < 1e-5 and report["serve"]["wav_max_abs"] < 1e-5
    assert 0.5 < report["split_share"] <= 1.0
    assert len(report["launches"]) == n
    for per_rank in report["launches"]:
        assert set(per_rank) == {"serve"} | {f"{k} {d}" for k in ("dp", "tp") for d in dtypes}
        assert all(v == 0 for phase in per_rank.values() for v in phase.values())
