"""PyTorch port, StutterSpeech's bf16 training step (``use_bf16``) against
the JAX package on the CPU: its losses (the frame head's cross entropy in
f32, its focal loss a bf16 scalar) and every gradient through
``bf16_loss`` against ``jax.value_and_grad(bf16_wrap(loss_fn))``, JAX's
own diffusion draws injected. Harness and the reasons for the bars:
``test_torch_bf16_families.py``.
"""

from tests.test_torch_bf16_families import (Bars, check_gradients, check_losses,  # noqa: F401
                                             one_thread)

# readings: float32 loss terms within 4.9e-4, the bf16 focal loss 2 bf16
# ulps (1.1e-2: a mean rounded once to bf16 on each side, its terms
# differing in their last bits), total 2.7e-4; gradients 0.14 at worst (the
# conv text encoder's), median 0.016
BARS = Bars(max_l2=0.3, median_l2=0.05, ulps=4)


def test_stutter_speech_bf16_losses_match_jax():
    check_losses("stutter", BARS)


def test_stutter_speech_bf16_gradients_match_jax():
    check_gradients("stutter", BARS)
