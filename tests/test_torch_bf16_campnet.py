"""PyTorch port, CampNet's bf16 training step (``use_bf16``) against the
JAX package on the CPU: its losses and every gradient through
``bf16_loss`` against ``jax.value_and_grad(bf16_wrap(loss_fn))``; its 9
self-attentions (3 in the text encoder, 6 in the decoder) run the bf16 K3
and K4 plain versions, its cross-attention the plain einsum with f32
weights. Harness and the reasons for the bars: ``test_torch_bf16_families.py``.
"""

from tests.test_torch_bf16_families import (Bars, check_gradients, check_losses,  # noqa: F401
                                             one_thread)

# readings: loss terms within 5.4e-4, total 2.3e-4; gradients 0.073 at worst
# (the decoder's position scale), median 0.024
BARS = Bars(max_l2=0.15, median_l2=0.05)


def test_campnet_bf16_losses_match_jax():
    check_losses("campnet", BARS)


def test_campnet_bf16_gradients_match_jax():
    check_gradients("campnet", BARS)
