"""PyTorch port: every objective on the MLP and MLP-Mixer flows (the
simple-conv flow's cases are in tests/test_torch_families_objectives_conv.py,
to keep each file under a minute) against ``jax.value_and_grad`` of the
JAX objective — flow matching,
mean flow, the autoencoder, iMF without the stop-gradient (the gradient
through du/dt), iMF with the learned weighting and iMF with latent QAT
(``ste`` on the ECSQ grid) — and the FLOP count the trainer's MFU reads.

Parameters are the Flax init tree redrawn from a seeded numpy generator;
noise, t and r are drawn by JAX from the key its loss uses and passed to
the port. Tolerances, float32 (those of tests/test_torch_objectives.py):
loss and mse rtol 1e-4; each gradient rtol 1e-3 with an atol of 1e-5 of
the tensor's largest magnitude (the JVP and the backward summed in another
order; a gradient element near zero keeps the absolute error of its
terms).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.models import mlp_flow as jmlp
from meanflow_audio_codec_tpu.models import mlp_mixer as jmixer
from meanflow_audio_codec_tpu.models import simple_conv_flow as jsconv
from meanflow_audio_codec_tpu.ops import latent_quant as jlq
from meanflow_audio_codec_tpu.ops import time_sampling as jtime
from meanflow_audio_codec_tpu.ops.losses import LEARNED_WEIGHT_KEY
from meanflow_audio_codec_tpu.training import objectives as jobj
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.models import mlp_flow, mlp_mixer
from meanflow_audio_codec_torch.models import simple_conv_flow as sconv
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.ops import losses, time_sampling
from meanflow_audio_codec_torch.training import objectives as obj
from meanflow_audio_codec_torch.training.profiling import estimate_step_flops

BATCH, NOISE = 6, 36
COMMON = dict(noise_dimension=NOISE, condition_dimension=16, num_blocks=2,
              latent_dimension=6)
MIXER = dict(token_mix_dim=24, channel_mix_dim=20, num_channels=4,
             num_latent_tokens=3, encoder_context_tokens=4)
FAMILIES = {
    "mlp": (lambda: jmlp.ConditionalFlow(**COMMON),
            lambda: mlp_flow.ConditionalFlow(**COMMON)),
    "mlp_mixer": (lambda: jmixer.ConditionalMLPMixerFlow(**COMMON, **MIXER),
                  lambda: mlp_mixer.ConditionalMLPMixerFlow(**COMMON,
                                                            **MIXER)),
    "simple_conv": (lambda: jsconv.SimpleConvFlow(**COMMON, base_channels=4),
                    lambda: sconv.SimpleConvFlow(**COMMON, base_channels=4)),
}
POLY = [0.1, 0.4, -0.3]  # a learned weighting away from its zero init


def _pairs(j):
    return (jtime if j else time_sampling).MeanFlowTimeSampling(
        full_interval_proportion=0.25)


# case -> (JAX objective, the port's objective, learned weighting)
OBJECTIVES = {
    "fm": (lambda: jobj.FlowMatchingObjective(),
           lambda: obj.FlowMatchingObjective(), False),
    "mf": (lambda: jobj.MeanFlowObjective(time_sampling=_pairs(True)),
           lambda: obj.MeanFlowObjective(time_sampling=_pairs(False)), False),
    "ae": (lambda: jobj.AutoencoderObjective(),
           lambda: obj.AutoencoderObjective(), False),
    "imf_no_stop_gradient": (
        lambda: jobj.ImprovedMeanFlowObjective(time_sampling=_pairs(True),
                                               use_stop_gradient=False),
        lambda: obj.ImprovedMeanFlowObjective(time_sampling=_pairs(False),
                                              use_stop_gradient=False),
        False),
    "imf_learned": (
        lambda: jobj.ImprovedMeanFlowObjective(time_sampling=_pairs(True),
                                               loss_weighting="learned"),
        lambda: obj.ImprovedMeanFlowObjective(time_sampling=_pairs(False),
                                              loss_weighting="learned"),
        True),
    "imf_qat_ste": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pairs(True),
            latent_qat=jlq.LatentQAT(step_frac=0.5)),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pairs(False),
            latent_qat=lq.LatentQAT(step_frac=0.5)),
        False),
}


def _np(t):
    return t.detach().float().numpy()


@functools.cache
def _jax_params(family):
    jmodel = FAMILIES[family][0]()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, NOISE)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(3)
    return jmodel, jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)


def _jax_draws(jobjective, key, x):
    """What ``jobjective.loss`` draws from ``key``, as the port's draws."""
    if isinstance(jobjective, jobj.AutoencoderObjective):
        return {}
    k_noise, k_time = jax.random.split(key)
    out = {"noise": jax.random.normal(k_noise, x.shape, dtype=x.dtype)}
    if isinstance(jobjective, jobj.FlowMatchingObjective):
        out["t"] = jobjective.time_sampling.sample_time(k_time, x.shape[0],
                                                        dtype=x.dtype)
    else:
        out["t"], out["r"] = jobjective.time_sampling.sample_time_pair(
            k_time, x.shape[0], dtype=x.dtype)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def check_objective(family, objective):
    """The port's loss, mse and every gradient against JAX's."""
    make_jax, make_port, learned = OBJECTIVES[objective]
    jmodel, params = _jax_params(family)
    if learned:
        params = dict(params)
        params[LEARNED_WEIGHT_KEY] = {"poly": np.asarray(POLY, np.float32)}
    x = (0.3 * np.random.default_rng(1).standard_normal(
        (BATCH, NOISE))).astype(np.float32)
    jobjective = make_jax()
    key = jax.random.PRNGKey(5)
    (loss_ref, aux_ref), grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jobjective.loss(p, jmodel.apply, key, jnp.asarray(x)),
        has_aux=True))(params)

    model = FAMILIES[family][1]()
    if learned:
        losses.attach_learned_weighting(model)
    weights.load_flax_params(model, params)
    loss, aux = make_port().loss(model, torch.from_numpy(x),
                                 **_jax_draws(jobjective, key,
                                              jnp.asarray(x)))
    np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(_np(aux["mse"]), np.asarray(aux_ref["mse"]),
                               rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()), allow_unused=True)))
    want = weights.flax_to_torch(grads_ref, model.architecture)
    assert set(grads) == set(want)
    for name, g in grads.items():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if g is None else _np(g)
        np.testing.assert_allclose(
            got, ref, rtol=1e-3,
            atol=1e-5 * max(float(np.abs(ref).max()), 1e-30), err_msg=name)


@pytest.mark.parametrize("objective", list(OBJECTIVES))
@pytest.mark.parametrize("family", ["mlp", "mlp_mixer"])
def test_loss_and_gradients_match_jax(family, objective):
    check_objective(family, objective)


def test_flop_count_reads_the_families_products():
    """``estimate_step_flops`` (the trainer's MFU) counts every product of
    the MLP flow's forward: 2 x rows x in x out per Dense."""
    model = mlp_flow.ConditionalFlow(**COMMON)
    x = torch.zeros(BATCH, NOISE)
    time = torch.zeros(BATCH, 2)
    dense = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    want = sum(2 * BATCH * m.in_features * m.out_features for m in dense)
    with torch.no_grad():
        got = estimate_step_flops(lambda: model(x, time, model.encode(x)))
    assert got == want
