"""PyTorch port, the stutter predictor's bf16 training step (``use_bf16``)
against the JAX package on the CPU: its losses and every gradient through
``bf16_loss`` against ``jax.value_and_grad(bf16_wrap(loss_fn))``. As in
JAX, its float32 masks promote the embeddings they multiply, and every
layer after them computes in float32 with its bf16 weights promoted
(``utils/dtypes.py::promoted``); before that repair its gradients stood
0.39 from JAX's in relative L2. Harness and the reasons for the bars:
``test_torch_bf16_families.py``.
"""

from tests.test_torch_bf16_families import (Bars, check_gradients, check_losses,  # noqa: F401
                                             one_thread)

# readings: the cross entropy within 4.2e-3, the focal loss 1.3e-2, total
# 1.3e-2 (six 16-frame blocks, and two bf16 conv stacks ahead of the logits,
# whose rounding the focal loss's (1 - p)^5 multiplies fivefold); gradients
# 0.10 at worst, median 0.018
BARS = Bars(max_l2=0.2, median_l2=0.05, loss_rtol=3e-2, total_rtol=3e-2)


def test_stutter_predictor_bf16_losses_match_jax():
    check_losses("predictor", BARS)


def test_stutter_predictor_bf16_gradients_match_jax():
    check_gradients("predictor", BARS)
