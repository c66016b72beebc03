"""PyTorch port: the minimal standalone trainer
(``training/simple_trainer.py``) against the JAX package's.

The model is the JAX test's ``ConditionalFlow(8, 4, 1, 4)``, its JAX init
converted to the port. Each JAX step splits its key into the noise and the
time draws; the test draws the same arrays with JAX and passes them to the
port's step, so both take the same steps. Losses and parameters after 3
steps agree at float32 rtol 1e-5 / atol 1e-6 (the same f32 arithmetic,
summed in another order, through optax's and the port's AdamW).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.models import ConditionalFlow as JaxFlow
from meanflow_audio_codec_tpu.ops.time_sampling import logit_normal, sample_tr
from meanflow_audio_codec_tpu.training import simple_trainer as jst
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.models.mlp_flow import ConditionalFlow
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
    train_epoch,
    train_step_flow_matching,
    train_step_improved_mean_flow,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _model():
    return ConditionalFlow(8, 4, 1, 4)


def test_create_train_state_initialises_everything():
    state = create_train_state(_model(), torch.Generator().manual_seed(0),
                               batch_size=4, device="cpu")
    assert any(name.startswith("encoder.") for name in state.names)
    again = create_train_state(_model(), torch.Generator().manual_seed(0),
                               batch_size=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(state.params, again.params))
    assert state.step == 0 and state.ema is None


def _draws(step, key, x):
    """The noise and times JAX's ``step`` draws from ``key``."""
    k_noise, k_times = jax.random.split(key)
    noise = jax.random.normal(k_noise, x.shape, dtype=x.dtype)
    if step is jst.train_step_flow_matching:
        return {"noise": noise, "t": logit_normal(k_times, (x.shape[0], 1))}
    t, r = sample_tr(k_times, x.shape[0])
    return {"noise": noise, "t": t, "r": r}


@pytest.mark.parametrize("method", ["flow_matching", "improved_mean_flow"])
def test_steps_match_jax_for_the_same_draws(method):
    jax_step = getattr(jst, f"train_step_{method}")
    port_step = {"flow_matching": train_step_flow_matching,
                 "improved_mean_flow": train_step_improved_mean_flow}[method]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    jstate = jst.create_train_state(JaxFlow(noise_dimension=8,
                                            condition_dimension=4,
                                            num_blocks=1, latent_dimension=4),
                                    jax.random.PRNGKey(0), batch_size=16,
                                    learning_rate=3e-3)
    state = create_train_state(_model(), None, 16, learning_rate=3e-3,
                               device="cpu")
    state.model.load_state_dict(weights.flax_to_torch(
        jax.device_get(jstate.params), "mlp"), strict=True)
    key = jax.random.PRNGKey(1)
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 _draws(jax_step, sub, jnp.asarray(x)).items()}
        jstate, ref = jax_step(jstate, sub, jnp.asarray(x))
        state, loss = port_step(state, None, torch.from_numpy(x), **draws)
        np.testing.assert_allclose(loss.item(), float(ref), **TOL)
    assert state.step == int(jstate.step) == 3
    want = weights.flax_to_torch(jax.device_get(jstate.params), "mlp")
    for name, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), **TOL)


def test_simple_steps_run_and_decrease():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    for step_fn in (train_step_flow_matching, train_step_improved_mean_flow):
        state = create_train_state(_model(), torch.Generator().manual_seed(0),
                                   batch_size=16, learning_rate=3e-3,
                                   device="cpu")
        generator = torch.Generator().manual_seed(1)
        losses = [float(step_fn(state, generator, x)[1]) for _ in range(40)]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("improved", [False, True])
def test_train_epoch(improved):
    state = create_train_state(_model(), torch.Generator().manual_seed(0),
                               batch_size=4, device="cpu")
    batches = [np.zeros((4, 8), np.float32)] * 3
    state, mean_loss = train_epoch(state, torch.Generator().manual_seed(1),
                                   batches, use_improved_mean_flow=improved)
    assert np.isfinite(mean_loss)
    assert state.step == 3
    with pytest.raises(ValueError, match="both t and r"):
        train_step_improved_mean_flow(state, None, torch.zeros(4, 8),
                                      t=torch.ones(4, 1))
