"""PyTorch port, EditSpeech's bf16 training step (``use_bf16``) against the
JAX package on the CPU, teacher-forced (coin 1) and free-running (coin 0):
its losses and every gradient through ``bf16_loss`` against
``jax.value_and_grad(bf16_wrap(loss_fn))``. torch's bf16 LSTM cell keeps
its gates in f32 and rounds its outputs, flax's cell rounds after every
operation: the LSTMs' gradients are held at the bar measured here (0.021
at worst teacher-forced; the card runs cuDNN's bf16 recurrence, which
``chip_smoke.py`` checks). Harness and the reasons for the bars:
``test_torch_bf16_families.py``.
"""

import pytest

from tests.test_torch_bf16_families import (Bars, check_gradients, check_losses,  # noqa: F401
                                             one_thread)

# readings, coin 1 / coin 0: loss terms within 7.5e-4 / 7.5e-4, total 6.3e-6
# / 3.0e-5; gradients 0.021 / 0.085 at worst (an LSTM's / the prenet's),
# median 0.0076 / 0.0094
BARS = Bars(max_l2=0.2, median_l2=0.03)


@pytest.mark.parametrize("coin", [1, 0])
def test_editspeech_bf16_losses_match_jax(coin):
    check_losses("editspeech", BARS, heads=bool(coin))


@pytest.mark.parametrize("coin", [1, 0])
def test_editspeech_bf16_gradients_match_jax(coin):
    check_gradients("editspeech", BARS, heads=bool(coin))
