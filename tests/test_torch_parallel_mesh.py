"""PyTorch port, the parallel layer's mesh and global batch
(``parallel/mesh.py``) on the CPU: ``shard_batch`` and
``pad_batch_to_multiple`` give each rank the rows that JAX's
``NamedSharding(P("data"))`` places on each device of the 8-device CPU
mesh; the global reductions and draws on two gloo ranks; a CUDA device
without a GPU and a backend that cannot start raise, with no fallback; and
the normaliser trap: a FluentSpeech step on two ranks whose rows hold
unequal non-padding counts, or that pads the batch (one rank holding only
padding), gives JAX's single-device loss and gradients on the padded
global batch, and nothing non-finite on any rank."""

import functools
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from speech_editing_tpu.parallel import mesh as jmesh
from speech_editing_tpu_torch.parallel import mesh as tmesh
from speech_editing_tpu_torch.parallel.dryrun import spawn_ranks
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests import torch_parallel_workers as workers
from tests.test_torch_train import HP, SIL, VOCAB, _jax, _jax_batch, _jax_draws
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = __file__.rsplit("/tests/", 1)[0]


def _leaves(rs, b):
    return {"a": rs.randn(b, 5).astype(np.float32), "ids": rs.randint(0, 9, (b, 3)),
            "odd": rs.randn(b + 1, 2).astype(np.float32), "scalar": np.float32(2.0)}


@pytest.mark.parametrize("b", [8, 16])
def test_shard_batch_gives_each_rank_the_rows_of_its_device(b):
    """Rank i of an 8-rank data axis holds the rows JAX places on device i;
    a leaf whose leading dim does not divide stays whole on every rank."""
    batch = _leaves(np.random.RandomState(b), b)
    mesh = jmesh.make_mesh(8)
    placed = jmesh.shard_batch(batch, mesh)
    for i, dev in enumerate(mesh.devices.flat):
        rank = tmesh.Mesh({tmesh.DATA_AXIS: 8}, i, {})
        for name, leaf in (("a", batch["a"]), ("ids", batch["ids"])):
            ours = tmesh.shard_batch({name: torch.as_tensor(leaf)}, rank)[name]
            theirs = next(s.data for s in placed[name].addressable_shards if s.device == dev)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
            np.testing.assert_array_equal(tmesh.shard_batch(leaf, rank), np.asarray(theirs))
        assert placed["odd"].sharding.is_fully_replicated
        np.testing.assert_array_equal(tmesh.shard_batch(batch, rank)["odd"], batch["odd"])
        assert tmesh.shard_batch(batch, rank)["scalar"] == batch["scalar"]


@pytest.mark.parametrize("b, multiple", [(5, 8), (8, 8), (3, 2), (1, 2)])
def test_pad_batch_to_multiple_matches_jax(b, multiple):
    batch = _leaves(np.random.RandomState(b), b)
    ref = jmesh.pad_batch_to_multiple(batch, multiple)
    for as_torch in (False, True):
        given = {k: torch.as_tensor(v) if as_torch else v for k, v in batch.items()}
        got = tmesh.pad_batch_to_multiple(given, multiple)
        for k in batch:
            assert type(got[k]) is type(given[k]), k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def test_global_reductions_and_draws_on_two_ranks():
    """Each rank holds the global sum and mean, its gradient is that of its
    own rows; draws are the global batch's rows; rank 0's tree is
    broadcast; the gather concatenates in rank order."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.0
    got = spawn_ranks(workers.reductions, 2, {"x": x})
    draws = torch.randn(4, 3, generator=torch.Generator().manual_seed(3)).numpy()
    for r, out in enumerate(got):
        assert out["sum"] == pytest.approx(x.sum())
        assert out["mean"] == pytest.approx((x ** 2).mean())
        np.testing.assert_allclose(out["grad"], 1 + 2 * x[r] / x.size, rtol=1e-6)
        np.testing.assert_array_equal(out["drawn"], draws[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["rows"], [2.0 * r, 2.0 * r + 1])
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))
        np.testing.assert_array_equal(out["gathered"], [0.0, 1.0])


def test_reductions_outside_a_data_axis_are_the_plain_ones():
    x = torch.randn(3, 4)
    with tmesh.data_parallel(tmesh.make_mesh()):       # one process: a 1-rank data axis
        assert tmesh.global_mean(x) == x.mean()
        total = x.sum()
        assert tmesh.global_sums(total)[0] is total
        assert tmesh.draw_rows(3, lambda n: torch.arange(n)).tolist() == [0, 1, 2]
    assert tmesh.active_data_mesh() is None


def test_a_cuda_rank_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed("gloo", "tcp://127.0.0.1:1", 1, 0, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):   # the default: cuda:LOCAL_RANK
        tmesh.init_distributed(init_method="tcp://127.0.0.1:1", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


def test_a_backend_that_cannot_start_raises_without_fallback():
    """NCCL asked for on the CPU: the init raises, and no group is made."""
    code = ("import torch.distributed as d\n"
            "from speech_editing_tpu_torch.parallel.mesh import init_distributed\n"
            "from speech_editing_tpu_torch.parallel.dryrun import free_port\n"
            "try:\n"
            "    init_distributed('nccl', f'tcp://127.0.0.1:{free_port()}', 1, 0, 'cpu')\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "print('INITIALIZED', d.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120).stdout
    assert "RAISED" in out and "INITIALIZED False" in out, out


def _rows_batch(lengths, s=10, t=36, seed=0):
    """Rows of (tokens, frames); the middle third of each row masked."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    tokens = np.zeros((b, s), np.int64)
    mel2ph = np.zeros((b, t), np.int64)
    mels = np.zeros((b, t, 80), np.float32)
    mask = np.zeros((b, t), np.float32)
    for i, (n_tok, n_frames) in enumerate(lengths):
        tokens[i, :n_tok] = rs.randint(1, VOCAB, n_tok)
        bounds = np.sort(rs.choice(np.arange(1, n_frames), n_tok - 1, replace=False))
        mel2ph[i, :n_frames] = np.searchsorted(bounds, np.arange(n_frames), side="right") + 1
        mels[i, :n_frames] = rs.randn(n_frames, 80) * 0.5 - 1.0
        mask[i, n_frames // 3: 2 * n_frames // 3] = 1.0
    uv = (rs.rand(b, t) < 0.2).astype(np.float32) * (mel2ph > 0)
    f0 = (rs.rand(b, t) * 2 + 6.5).astype(np.float32) * (1 - uv) * (mel2ph > 0)
    return dict(txt_tokens=tokens, mels=mels, mel2ph=mel2ph, f0=f0, uv=uv,
                time_mel_masks=mask)


NORMALISER_CASES = {
    # rank 0 a full row, rank 1 a short one: unequal non-padding counts
    "unequal_rows": [(10, 36), (4, 12)],
    # three rows padded to four: rank 1 holds a row and a padding row
    "padded_batch": [(10, 36), (7, 30), (5, 20)],
    # one row padded to two: rank 1 holds only padding
    "rank_of_padding": [(8, 33)],
}


def _padded(case):
    return tmesh.pad_batch_to_multiple(_rows_batch(NORMALISER_CASES[case]), 2)


@functools.lru_cache(maxsize=1)
def _two_rank_steps():
    """Each case's step on two ranks (one spawn for all), from JAX's
    weights, with the draws JAX makes from ``PRNGKey(11)`` on its padded
    global batch."""
    _, params, _, _ = _jax()
    cases = [dict(batches=[_padded(c)], draws=[_jax_draws(jax.random.PRNGKey(11), _padded(c))])
             for c in sorted(NORMALISER_CASES)]
    hp = dict(HP, clip_grad_norm=0)      # the summed gradients as they are
    got = spawn_ranks(workers.step_cases, 2, dict(
        hp=hp, vocab=VOCAB, sil=SIL, weights=params_from_jax(params, HP), cases=cases))
    return {c: [r["cases"][i] for r in got] for i, c in enumerate(sorted(NORMALISER_CASES))}


@pytest.mark.parametrize("case", sorted(NORMALISER_CASES))
def test_normalisers_are_the_global_batch(case):
    """Two ranks give JAX's loss terms and gradients on the padded global
    batch (the weighted means' global denominators, ``sdur``'s mean over
    every row, padding rows among them), and every rank's own loss and
    gradients are finite."""
    _, params, _, grad_fn = _jax()
    batch = _padded(case)
    (j_total, j_losses), j_grads = grad_fn(params, _jax_batch(batch), jax.random.PRNGKey(11))
    ref = params_from_jax(jax.tree.map(np.asarray, j_grads), HP)
    got = _two_rank_steps()[case]
    for out in got:
        assert out["finite"] and out["rows"] == [len(batch["txt_tokens"]) // 2]
        m = out["metrics"][0]
        np.testing.assert_allclose(m["total_loss"], float(j_total), rtol=1e-4)
        for k, v in j_losses.items():
            np.testing.assert_allclose(m[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
        for name, g in ref.items():
            np.testing.assert_allclose(out["grads"][name].numpy(), g.numpy(), atol=1e-4,
                                       rtol=1e-3, err_msg=name)
    assert "sdur" in got[0]["metrics"][0]
