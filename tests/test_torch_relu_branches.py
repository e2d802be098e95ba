"""``chip_smoke.py::relu_branches``, which lets the card-vs-CPU step check
differentiate one function on both sides: a ReLU's gradient jumps where its
input crosses 0, so two steps whose pre-activations differ by rounding can
disagree by far more than rounding. Recorded branches, replayed, remove
that; the check's tolerances stay as they are."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from speech_editing_tpu_torch.config.flagship import FLAGSHIP_HP
from speech_editing_tpu_torch.training.trainer import Trainer
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TORCH_RELU = torch.relu
RELUS = {"torch.relu": lambda x: torch.relu(x), "F.relu": F.relu,
         "nn.ReLU": torch.nn.ReLU()}


@pytest.mark.parametrize("style", sorted(RELUS))
def test_replay_takes_the_recorded_branch(style):
    relu = RELUS[style]
    w = torch.tensor([[1.0, -2.0, 0.5], [0.3, 0.7, -1.1]])
    x = torch.tensor([[2.0, 1.0, 1e-9], [1.0, -1.0, 0.5]])

    def grad(x, masks, replay):
        x = x.clone().requires_grad_()
        with chip_smoke.relu_branches(masks, replay) as tally:
            (relu(x) @ w.T).sum().backward()
        return x.grad, tally[0]

    masks = []
    ref, _ = grad(x, masks, replay=False)
    assert len(masks) == 1 and masks[0].tolist() == (x > 0).tolist()
    flipped = x.clone()
    flipped[0, 2] = -1e-9             # rounding puts this input across 0
    own, _ = grad(flipped, [], replay=False)
    assert float((own - ref).abs().max()) == pytest.approx(abs(float(w[:, 2].sum())))
    replayed, flips = grad(flipped, masks, replay=True)
    assert flips == 1
    torch.testing.assert_close(replayed, ref, rtol=0, atol=0)
    assert torch.relu is TORCH_RELU


def test_flagship_step_gradients_hold_under_rounding_with_replay(one_thread):
    """The flagship model's B=2 step, its weights perturbed at the level of
    rounding (3e-7 relative) four times: replaying the unperturbed step's
    ReLU branches, every gradient stays within 1e-5 of each tensor's max,
    a hundredth of the card-vs-CPU check's tolerance. One twin trainer
    takes every step, loading each state whole."""
    torch.manual_seed(0)
    batch = chip_smoke.train_batch(4, 512, 48, seed=0)
    trainer = Trainer.from_hp(FLAGSHIP_HP, device="cpu", seed=0, vocab_size=80,
                              sil_token_ids=chip_smoke.SIL_IDS)
    for _ in range(2):
        trainer.step(batch)
    state = trainer.train_step.state_dict()
    sub = {k: v[:2] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(7)
    t_draw = torch.randint(0, FLAGSHIP_HP["timesteps"] + 1, (2,), generator=gen)
    noise = torch.randn(2, 512, 80, generator=gen)
    masks: list = []
    twin = Trainer.from_hp(FLAGSHIP_HP, device="cpu", seed=1, vocab_size=80,
                           sil_token_ids=chip_smoke.SIL_IDS, dropout=False)

    def grads(st, replay):
        twin.train_step.load_state_dict(copy.deepcopy(st))
        with chip_smoke.relu_branches(masks, replay):
            twin.train_step(twin.to_device(sub), t=t_draw, noise=noise)
        return {n: p.grad.clone() for n, p in twin.train_step.model.named_parameters()}

    ref = grads(state, replay=False)
    rs = np.random.RandomState(0)
    for _ in range(4):
        st = copy.deepcopy(state)
        for v in st["model"].values():
            if v.is_floating_point():
                v.mul_(1 + 3e-7 * torch.from_numpy(np.asarray(rs.randn(*v.shape))).to(v.dtype))
        got = grads(st, replay=True)
        worst = max((chip_smoke.rel_err([got[n]], [ref[n]]), n) for n in ref)
        assert worst[0] <= chip_smoke.STEP_GRAD_TOL / 100, worst
