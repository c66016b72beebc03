"""PyTorch port: every objective on the simple-conv flow against
``jax.value_and_grad`` of the JAX objective; the cases, draws and
tolerances of tests/test_torch_families_objectives.py.
"""

import pytest

from test_torch_families_objectives import OBJECTIVES, check_objective


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_loss_and_gradients_match_jax(objective):
    check_objective("simple_conv", objective)
