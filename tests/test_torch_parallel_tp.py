"""PyTorch port, tensor parallelism (``parallel/tp.py``) on the CPU: the
split rule equals JAX's ``_spec_for`` on flax-layout shapes;
``param_partition_specs`` splits the same parameters of the tiny flagship
tree, along the same logical axis, as JAX's (each flax leaf carried
through ``convert_jax_params`` to see where its split axis lands); a step
on a (data 1, model 2) mesh of two gloo ranks equals JAX's single-device
``make_train_step`` on the global batch (two steps, parameters and Adam
moments within 1e-4), each rank holding its slice of every split
parameter; and a full state loads into the split step and gathers back
whole; and the training entry runs with ``tp_size`` 2 on two ranks."""

import functools

import jax
import numpy as np
import pytest
import torch

from speech_editing_tpu.parallel import tp as jtp
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.parallel import tp as ttp
from speech_editing_tpu_torch.parallel.dryrun import spawn_ranks
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests import torch_parallel_workers as workers
from tests.test_torch_train import (HP, SIL, VOCAB, _adam, _batch, _jax, _jax_draws,
                                    _jax_train_step, _port_model, _train_step)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

MIN_SIZE = 256      # the JAX dry run's: at these widths most kernels split


SHAPES = [("dense/kernel", (64, 64)), ("dense/bias", (64,)), ("conv/kernel", (3, 32, 64)),
          ("tiny/kernel", (4, 4)), ("odd/kernel", (63, 63)), ("odd_out/kernel", (64, 63)),
          ("att/q_proj/kernel", (32, 2, 16)), ("att/out_proj/kernel", (2, 16, 33)),
          ("norm/scale", (8, 256)), ("wn/weight_g", (64, 64))]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("min_size", [1024, 2048])
def test_split_rule_is_jax_rule(tp, min_size):
    for path, shape in SHAPES:
        assert ttp._spec_for(path, shape, tp, min_size) == tuple(
            jtp._spec_for(path, shape, tp, min_size)), (path, shape)


def _leaf_paths(tree):
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _with_leaf(tree, target, fill):
    def f(path, leaf):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        return fill(leaf.shape) if key == target else np.zeros(leaf.shape, np.float32)
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.mark.parametrize("min_size", [MIN_SIZE, 2048])
def test_specs_split_the_parameters_jax_splits_along_the_same_axis(min_size):
    """Each flax leaf of the tiny flagship tree, filled with its index along
    JAX's split axis (ones where JAX keeps it whole) and all else zero,
    goes through the converter: the port splits the parameters it lands in
    along the dim its index varies on, and no other parameter."""
    _, params, _, _ = _jax()
    jspecs = jtp.param_partition_specs(params, 2, min_size)
    flat_specs = {k: s for (k, _), s in zip(
        _leaf_paths(params), jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)))}
    specs = ttp.param_partition_specs(_port_model(params), 2, min_size)
    want: dict = {}
    for key, shape in _leaf_paths(params):
        axis = next((i for i, a in enumerate(flat_specs[key]) if a is not None), None)

        def fill(shape, axis=axis):
            if axis is None:
                return np.ones(shape, np.float32)
            idx = np.arange(1, shape[axis] + 1, dtype=np.float32)
            return np.broadcast_to(idx.reshape([-1 if i == axis else 1
                                                for i in range(len(shape))]), shape)

        for name, v in params_from_jax(_with_leaf(params, key, fill), HP).items():
            if not v.any():
                continue
            if axis is None:
                want.setdefault(name, None)
                continue
            varies = [d for d in range(v.ndim) if v.shape[d] > 1 and not torch.equal(
                v, v.narrow(d, 0, 1).expand_as(v))]
            assert len(varies) == 1, (key, name, varies)
            assert want.get(name) in (None, varies[0]) or name not in want, (key, name)
            want[name] = varies[0]
    assert set(want) == set(specs)
    for name, spec in specs.items():
        assert ttp.split_dim(spec) == want[name], (name, spec, want[name])
    assert sum(ttp.split_dim(s) is not None for s in specs.values()) > 0


@functools.lru_cache(maxsize=1)
def _tp_run():
    """Two steps on a (data 1, model 2) mesh, from JAX's weights with
    JAX's draws; and JAX's two steps."""
    _, params, _, _ = _jax()
    tx, j_step = _jax_train_step()
    state = TrainState.create(params, tx)
    batches, draws = [], []
    for i, seed in enumerate((0, 1)):
        batch, rng = _batch(seed), jax.random.PRNGKey(10 + i)
        state, _ = j_step(state, {k: jax.numpy.asarray(v.astype(np.int32) if v.dtype == np.int64
                                                        else v) for k, v in batch.items()}, rng)
        batches.append(batch)
        draws.append(_jax_draws(rng, batch))
    got = spawn_ranks(workers.train_steps, 2, dict(
        hp=HP, vocab=VOCAB, sil=SIL, weights=params_from_jax(params, HP), batches=batches,
        draws=draws, tp=2, min_size=MIN_SIZE))
    return state, got


def test_tp_steps_match_jax():
    state, got = _tp_run()
    names = list(_port_model(_jax()[1]).state_dict())
    adam = _adam(state.opt_state)
    full = got[0]["state"]
    ref_params = params_from_jax(jax.tree.map(np.asarray, state.params), HP)
    for name in names:
        np.testing.assert_allclose(full["model"][name].numpy(), ref_params[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = params_from_jax(jax.tree.map(np.asarray, tree), HP)
        for i, name in enumerate(names):
            np.testing.assert_allclose(full["optimizer"]["state"][i][key].numpy(),
                                       ref[name].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{key} {name}")
    for out in got:
        assert out["finite"] and out["rows"] == [2, 2]     # the model ranks see every row
        np.testing.assert_allclose(out["metrics"][-1]["total_loss"],
                                   got[0]["metrics"][-1]["total_loss"], rtol=0)


def test_tp_ranks_hold_slices_of_the_split_parameters():
    _, got = _tp_run()
    model = _port_model(_jax()[1])
    specs = ttp.param_partition_specs(model, 2, MIN_SIZE)
    split = {n: s for n, s in specs.items() if ttp.split_dim(s) is not None}
    assert split and set(got[0]["split"]) == set(split)
    for name, spec in split.items():
        shape = list(model.get_parameter(name).shape)
        shape[ttp.split_dim(spec)] //= 2
        assert got[0]["split"][name] == got[1]["split"][name] == tuple(shape), name
    assert 0.5 < ttp.sharded_share(model, specs) <= 1.0


def test_a_full_state_loads_into_the_split_step_and_gathers_back():
    model = _port_model(_jax()[1])
    step = _train_step(model)
    batch = {k: torch.tensor(v) for k, v in _batch(0).items()}
    for _ in range(2):
        step(batch, torch.Generator().manual_seed(0))
    full = step.state_dict()
    got = spawn_ranks(workers.tp_round_trip, 2, dict(
        hp=HP, vocab=VOCAB, sil=SIL, weights=model.state_dict(), state=full, min_size=MIN_SIZE))
    names = [n for n, _ in model.named_parameters()]
    for out in got:
        m = out["model_axis"]
        for name, (part, moment) in out["slices"].items():
            dim, i = out["dims"][name], names.index(name)
            size = part.shape[dim]
            torch.testing.assert_close(part, model.get_parameter(name).detach().narrow(
                dim, m * size, size), rtol=0, atol=0)
            torch.testing.assert_close(out["shard_params"][name], part, rtol=0, atol=0)
            torch.testing.assert_close(out["to_host_local"][name],
                                       model.get_parameter(name).detach(), rtol=0, atol=0)
            torch.testing.assert_close(moment, full["optimizer"]["state"][i]["exp_avg"].narrow(
                dim, m * size, size), rtol=0, atol=0)
        for i, st in full["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(out["state"]["optimizer"]["state"][i][k], st[k],
                                           rtol=0, atol=0)
        for k, v in full["model"].items():
            torch.testing.assert_close(out["state"]["model"][k], v, rtol=0, atol=0)


def test_run_with_tp_size_trains_on_a_model_axis(tmp_path):
    """``run -hp tp_size=2`` on two ranks: a (data 1, model 2) mesh, both
    ranks ending with the same whole weights."""
    config = workers.write_sd_config(tmp_path)
    got = spawn_ranks(workers.run_entry, 2, {"argv": [
        "--config", config, "--device", "cpu", "--exp_name", str(tmp_path / "tp"), "-hp",
        "tp_size=2,max_updates=2,num_sanity_val_steps=0"]}, init=False)
    assert got[0]["mesh"] == "data=1xmodel=2" and got[0]["step"] == got[1]["step"] == 2
    for k, v in got[1]["model"].items():
        torch.testing.assert_close(v, got[0]["model"][k], rtol=0, atol=0)
