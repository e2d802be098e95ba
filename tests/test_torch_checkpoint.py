"""PyTorch port, checkpoints: naming, retention of the newest
``num_ckpt_keep``, the best checkpoint by validation loss, a bit-exact
reload of parameters, Adam's moments and counts, a resumed step equal to
an uninterrupted one (diffusion draws injected), and a checkpoint written
by the JAX package's ``save_checkpoint`` loading into the port, in a
process that imports only the port, with the JAX model's outputs."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.training.checkpoint import (get_all_ckpts,
                                                          get_last_checkpoint,
                                                          load_checkpoint,
                                                          save_checkpoint)
from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
from speech_editing_tpu_torch.training.train_state import TrainStep
from tests.test_torch_train import HP, SIL, _batch, _jax, _jax_batch, _port_model, _torch_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)


def _draws(seed):
    rs = np.random.RandomState(seed)
    batch = _batch(seed)
    t = torch.tensor(rs.randint(0, HP["timesteps"] + 1, 2))
    return _torch_batch(batch), t, torch.tensor(rs.randn(*batch["mels"].shape),
                                                dtype=torch.float32)


def _train_step(model):
    return TrainStep(model, HP, make_loss_fn(model, HP, SIL, train=False))


def _step():
    return _train_step(_port_model(_jax()[1]))


def _assert_states_equal(a: dict, b: dict):
    """Bit-exact: parameters, Adam's moments and counts."""
    assert a["step"] == b["step"] and a["updates"] == b["updates"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb) and sa
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k])), (i, k)


def test_save_load_retention_and_best(tmp_path):
    step = _step()
    batch, t, noise = _draws(0)
    step(batch, None, t, noise)
    work = str(tmp_path)
    assert get_last_checkpoint(work) == (None, 0)
    for steps, val_loss in ((10, 3.0), (20, 2.0), (30, 4.0), (40, None), (50, 2.5)):
        path = save_checkpoint(work, step.state_dict(), steps, epoch=steps // 20,
                               val_loss=val_loss, num_ckpt_keep=3, save_best=True)
        assert path == os.path.join(work, f"model_ckpt_steps_{steps}.ckpt")
    assert [os.path.basename(p) for p in get_all_ckpts(work)] == [
        f"model_ckpt_steps_{n}.ckpt" for n in (50, 40, 30)]
    assert get_last_checkpoint(work) == (os.path.join(work, "model_ckpt_steps_50.ckpt"), 50)
    assert not any(name.endswith(".part") for name in os.listdir(work))
    best = load_checkpoint(os.path.join(work, "model_ckpt_best.pt"))
    assert best["val_loss"] == 2.0 and best["steps"] == 20
    payload = load_checkpoint(os.path.join(work, "model_ckpt_steps_50.ckpt"))
    assert payload["steps"] == 50 and payload["epoch"] == 2 and payload["val_loss"] == 2.5
    _assert_states_equal(payload["state"], step.state_dict())


def test_resumed_step_equals_an_uninterrupted_one(tmp_path):
    batches = [_draws(s) for s in (0, 1, 2)]
    straight = _step()
    for batch, t, noise in batches:
        straight(batch, None, t, noise)
    first = _step()
    for batch, t, noise in batches[:2]:
        first(batch, None, t, noise)
    path = save_checkpoint(str(tmp_path), first.state_dict(), first.step)
    resumed = _train_step(_port_model(_randomized_other()))
    resumed.load_state_dict(load_checkpoint(path)["state"])
    _assert_states_equal(resumed.state_dict(), first.state_dict())
    batch, t, noise = batches[2]
    resumed(batch, None, t, noise)
    assert resumed.step == 3 and resumed.updates == 3
    _assert_states_equal(resumed.state_dict(), straight.state_dict())


def _randomized_other():
    return jax.tree.map(lambda a: a + 1.0, _jax()[1])


_LOAD_IN_PORT = r"""
import json, sys
import numpy as np, torch
from speech_editing_tpu_torch.training.trainer import Trainer
hp, vocab, sil, out = json.loads(sys.argv[1])
trainer = Trainer.from_hp(hp, device="cpu", vocab_size=vocab, sil_token_ids=sil)
trainer._build_state()
assert trainer.global_step == 7 and trainer.train_step.updates == 0, trainer.global_step
b = {k: torch.tensor(v) for k, v in np.load(out + ".in.npz").items()}
with torch.no_grad():
    ret = trainer.model.compute_cond(b["txt_tokens"], b["time_mel_masks"][..., None],
                                     b["mel2ph"], None, b["mels"], b["f0"], b["uv"])
np.savez(out, **{k: ret[k].numpy() for k in ("dur", "pitch_pred", "cond")})
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "speech_editing_tpu"))
assert not leaked, leaked
print("LOADED")
"""


def test_jax_checkpoint_loads_into_the_port_without_jax(tmp_path):
    """JAX ``save_checkpoint`` of a ``TrainState`` with its optax states ->
    the port's ``Trainer`` resumes from it (parameters, step count, and the
    fresh state's Adam moments and count of 0 updates; a state that has
    taken steps: ``test_torch_resume_jax.py``) in a process without JAX,
    and its conditioner's outputs equal the JAX model's with those
    parameters."""
    jm, params, _, _ = _jax()
    state = TrainState.create(params, j_optimizer(HP)).replace(step=np.int32(7))
    work = tmp_path / "work"
    j_save_checkpoint(str(work), jax.tree.map(np.asarray, state), 7)
    batch = _batch(1)
    jb = _jax_batch(batch)
    ref = jm.apply({"params": state.params}, jb["txt_tokens"],
                   jb["time_mel_masks"][..., None], jb["mel2ph"], None, jb["mels"],
                   jb["f0"], jb["uv"], method=jm.compute_cond)
    out = str(tmp_path / "out.npz")
    np.savez(out + ".in.npz", **batch)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    arg = json.dumps([dict(HP, work_dir=str(work)), int(jm.vocab_size), list(SIL), out])
    res = subprocess.run([sys.executable, "-c", _LOAD_IN_PORT, arg], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED" in res.stdout and "Adam's moments and 0 updates" in res.stdout
    got = np.load(out)
    for key in ("dur", "pitch_pred", "cond"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), **TOL, err_msg=key)
