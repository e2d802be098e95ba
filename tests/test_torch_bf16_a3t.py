"""PyTorch port, A3T's bf16 training step (``use_bf16``) against the JAX
package on the CPU: its losses and every gradient through ``bf16_loss``
against ``jax.value_and_grad(bf16_wrap(loss_fn))``. The conformer's scores
form in f32 (JAX's ``preferred_element_type``), its position projection in
f32 (flax promotes the float32 table over the bf16 weight). JAX runs
compiled with XLA's defaults here: with ``xla_allow_excess_precision`` off
the compile takes about two minutes on a CPU host. Harness and the reasons
for the bars: ``test_torch_bf16_families.py``.
"""

import numpy as np

from tests.test_torch_bf16_families import (Bars, check_gradients, check_losses,  # noqa: F401
                                             one_thread, readings)

# readings: loss terms within 2.8e-4, total 1.6e-4; gradients 0.071 at worst
# (a position bias), median 0.024
BARS = Bars(max_l2=0.15, median_l2=0.05)


def test_a3t_bf16_losses_match_jax():
    check_losses("a3t", BARS)


def test_a3t_bf16_gradients_match_jax():
    check_gradients("a3t", BARS)


def test_a3t_bf16_key_bias_gradients_are_rounding():
    """The key projections' biases get no gradient in exact arithmetic (a
    bias on every key moves a whole softmax row's scores together); in bf16
    both sides leave rounding there, under 1e-3 in L2 norm (readings: port
    3e-6 to 2e-5, JAX 3e-5 to 1.1e-4)."""
    r = readings("a3t")
    assert len(r["zero_by_math"]) == 8
    for name, (got, want) in r["zero_by_math"].items():
        assert max(np.linalg.norm(got), np.linalg.norm(want)) <= 1e-3, name
