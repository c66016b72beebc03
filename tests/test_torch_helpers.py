"""PyTorch port: the public helpers beside the main path, against the JAX
package: the three losses (``weighted_l2_loss``, ``adaptive_weighted_loss``,
``normalized_mse_loss``), ``create_time_sampling``, params-only checkpoints
(the same bytes, read across packages both ways), ``config_hash`` and
``validate_config_compatibility``, ``ProgressBar`` and ``TraceCapture``.

Tolerances: the losses and their gradients at float32 rtol 1e-6 (the same
f32 reductions, summed in another order); bytes, hashes and messages
equal.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meanflow_audio_codec_tpu.configs import (
    BaseConfig,
    DatasetConfig,
    MethodConfig,
    ModelConfig,
    TrainFlowConfig,
    TrainingConfig,
)
from meanflow_audio_codec_tpu.models import ConditionalFlow as JaxFlow
from meanflow_audio_codec_tpu.models import TrainState as JaxTrainState
from meanflow_audio_codec_tpu.ops import losses as jlosses
from meanflow_audio_codec_tpu.ops import time_sampling as jts
from meanflow_audio_codec_tpu.training import checkpoints as jckpt
from meanflow_audio_codec_tpu.training import logging as jlogging
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models.mlp_flow import ConditionalFlow
from meanflow_audio_codec_torch.ops import losses, time_sampling
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.logging import ProgressBar
from meanflow_audio_codec_torch.training.profiling import TraceCapture
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)

RTOL = 1e-6


def _pair(seed, shape=(6, 5, 4)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name,kwargs", [
    ("weighted_l2_loss", {}), ("weighted_l2_loss", {"p": 0.5, "c": 1e-2}),
    ("normalized_mse_loss", {}), ("adaptive_weighted_loss", {}),
    ("adaptive_weighted_loss", {"gamma": 0.25, "c": 1e-2})])
def test_losses_and_gradients_match_jax(name, kwargs):
    """The same values and gradients, the stop-gradient weights included."""
    pred, target = _pair(len(name) + len(kwargs))
    port_fn, jax_fn = getattr(losses, name), getattr(jlosses, name)
    if name == "adaptive_weighted_loss":  # a function of the error alone
        port_loss = lambda p: port_fn(p - torch.from_numpy(target), **kwargs)
        jax_loss = lambda p: jax_fn(p - jnp.asarray(target), **kwargs)
    else:
        port_loss = lambda p: port_fn(p, torch.from_numpy(target), **kwargs)
        jax_loss = lambda p: jax_fn(p, jnp.asarray(target), **kwargs)
    p = torch.from_numpy(pred).requires_grad_(True)
    value = port_loss(p)
    value.backward()
    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    assert value.dtype == torch.float32 and value.ndim == 0
    np.testing.assert_allclose(value.item(), float(ref), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-7)


def test_losses_reduce_bf16_in_float32():
    pred, target = _pair(1)
    got = losses.normalized_mse_loss(
        torch.from_numpy(pred).bfloat16(), torch.from_numpy(target).bfloat16())
    ref = jlosses.normalized_mse_loss(jnp.asarray(pred, jnp.bfloat16),
                                      jnp.asarray(target, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_create_time_sampling_names_and_errors():
    assert isinstance(time_sampling.create_time_sampling(None),
                      time_sampling.LogitNormalTimeSampling)
    for name in ("uniform", "logit_normal", "mean_flow"):
        sampler = time_sampling.create_time_sampling(name)
        assert type(sampler).__name__ == type(
            jts.create_time_sampling(name)).__name__
    sampler = time_sampling.create_time_sampling(
        "mean_flow", mean=0.1, std=0.5, data_proportion=0.25)
    assert (sampler.mean, sampler.std, sampler.data_proportion) == (
        0.1, 0.5, 0.25)
    t, r = sampler.sample_time_pair(8, torch.Generator().manual_seed(0))
    assert torch.equal(t[:2], r[:2]) and (r <= t).all()
    with pytest.raises(ValueError) as port_error:
        time_sampling.create_time_sampling("beta")
    with pytest.raises(ValueError) as jax_error:
        jts.create_time_sampling("beta")
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(TypeError):
        time_sampling.create_time_sampling("uniform", mean=0.0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _jax_state(seed=0):
    model = JaxFlow(noise_dimension=8, condition_dimension=4, num_blocks=1,
                    latent_dimension=4)
    variables = model.init(jax.random.PRNGKey(seed), jnp.ones((2, 8)),
                           jnp.zeros((2, 2)), method="init_all")
    return JaxTrainState.create(apply_fn=model.apply,
                                params=variables["params"],
                                tx=optax.adam(1e-3))


def _port_state(jax_state):
    state = create_train_state(ConditionalFlow(8, 4, 1, 4), None, 2,
                               device="cpu")
    state.model.load_state_dict(weights.flax_to_torch(
        jax.device_get(jax_state.params), "mlp"), strict=True)
    return state


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def test_params_only_files_are_jax_bytes_both_ways(tmp_path):
    jstate = _jax_state()
    state = _port_state(jstate)
    jax_path = jckpt.save_params_only(jstate, tmp_path / "jax.msgpack")
    port_path = checkpoints.save_params_only(state, tmp_path / "port.msgpack")
    assert port_path.read_bytes() == jax_path.read_bytes()
    # the JAX package reads the port's file into its template ...
    params = jckpt.load_params_only(port_path, _jax_state(seed=2).params)
    for a, b in zip(_leaves(params), _leaves(jstate.params)):
        np.testing.assert_array_equal(a, b)
    # ... and the port reads JAX's, by its model's names
    other = ConditionalFlow(8, 4, 1, 4)
    loaded = checkpoints.load_params_only(jax_path, other)
    for name, value in state.model.state_dict().items():
        assert torch.equal(loaded[name], value), name
    other.load_state_dict(loaded, strict=True)
    with pytest.raises(ValueError, match="do not match"):
        checkpoints.load_params_only(jax_path, ConditionalFlow(8, 4, 2, 4))


def _jax_config(workdir):
    return TrainFlowConfig(
        base=BaseConfig(batch_size=4, n_steps=3, base_lr=1e-3,
                        weight_decay=0.0, seed=0),
        model=ModelConfig(noise_dimension=784, condition_dimension=8,
                          latent_dimension=4, num_blocks=1),
        dataset=DatasetConfig(dataset="mnist",
                              tokenization_strategy="reshape"),
        method=MethodConfig(method="flow_matching"),
        training=TrainingConfig(sample_every=2, sample_seed=0, sample_steps=1,
                                workdir=workdir, max_checkpoints_to_keep=2),
    )


def test_config_hash_equals_jax_and_compatibility_check(tmp_path):
    jcfg = _jax_config(tmp_path)
    config = config_from_dict(jcfg.to_dict())
    assert checkpoints.config_hash(config) == jckpt.config_hash(jcfg)
    state = _port_state(_jax_state())
    path = checkpoints.save_checkpoint_with_metadata(
        state, tmp_path / "port", step=1, config=config)
    ok, _ = checkpoints.validate_config_compatibility(path, config)
    assert ok
    other = config_from_dict(dict(jcfg.to_dict(), base=dict(
        jcfg.to_dict()["base"], batch_size=999)))
    ok, reason = checkpoints.validate_config_compatibility(path, other)
    assert not ok and "mismatch" in reason
    # a JAX-written sidecar checks against the port's config, and the other
    # way round
    jpath = jckpt.save_checkpoint_with_metadata(_jax_state(), tmp_path / "jax",
                                                step=1, config=jcfg)
    assert checkpoints.validate_config_compatibility(jpath, config)[0]
    assert not checkpoints.validate_config_compatibility(jpath, other)[0]
    jother = TrainFlowConfig.from_dict(other.to_dict())
    assert not jckpt.validate_config_compatibility(path, jother)[0]
    assert checkpoints.validate_config_compatibility(
        tmp_path / "none.msgpack", config) == jckpt.validate_config_compatibility(
        tmp_path / "none.msgpack", jcfg)
    (tmp_path / "port" / "step_00001.metadata.json").write_text("{")
    ok, reason = checkpoints.validate_config_compatibility(path, other)
    assert ok and "unreadable sidecar" in reason


# ---------------------------------------------------------------------------
# logging and profiling
# ---------------------------------------------------------------------------


def test_progress_bar_prints_jax_lines_without_tqdm(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tqdm", None)  # import fails
    outputs = []
    for cls in (ProgressBar, jlogging.ProgressBar):
        bar = cls(total=7, desc="train", print_every=3)
        for i in range(7):
            bar.update(loss=round(0.5 / (i + 1), 3), step=i)
        bar.close()
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    assert outputs[0].splitlines() == ["train 3/7 loss=0.167 step=2",
                                       "train 6/7 loss=0.083 step=5"]


def test_progress_bar_drives_tqdm(capsys):
    pytest.importorskip("tqdm")
    bar = ProgressBar(total=2, desc="eval")
    bar.update(loss=1.0)
    bar.update()
    bar.close()
    assert "eval" in capsys.readouterr().err


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    with TraceCapture(tmp_path / "trace") as capture:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert capture.path.parent == tmp_path / "trace"
    events = json.loads(capture.path.read_text())["traceEvents"]
    assert any("mm" in str(event.get("name", "")) for event in events)
