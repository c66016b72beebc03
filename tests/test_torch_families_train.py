"""PyTorch port: training the MLP, MLP-Mixer and simple-conv families
against the JAX package — K = 2 ``make_train_step`` steps per family (the
features layout on MNIST + reshape for the MLP and simple-conv flows, the
frames layout on audio + MDCT for the mixer) and latent QAT in ``noise``
mode on the mixer's token latents. ``train_flow`` on these families is in
tests/test_torch_families_trainer.py.

Noise, t and r are drawn by JAX from the key its loss uses and passed to
the port; parameters are the Flax init tree redrawn from a seeded numpy
generator. Tolerances, float32 throughout: loss and gradient norm rtol 1e-4
(the objective's JVP and backward in f32, summed in another order, over
two steps whose updates feed the next); the change of each parameter and
EMA tensor over the K steps within relative L2 1e-2 of JAX's (Adam's first
steps move every element by about the learning rate whatever the size of
its gradient, so an element whose gradient is ~1e-7 of the tensor's and
differs in the last bits between the two frameworks moves by a different
fraction of lr: read 6.1e-5 at lr 1e-3 on one of 2368 elements); the QAT
loss rtol 1e-4 and gradients rtol 1e-3 with an atol of
1e-5 of each tensor's largest magnitude (the convention of
tests/test_torch_objectives.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.models import mlp_mixer as jmixer
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.ops import latent_quant as jlq
from meanflow_audio_codec_tpu.ops import time_sampling as jtime
from meanflow_audio_codec_tpu.ops.tokenize import (
    create_tokenization_strategy as jax_create_tokenization_strategy,
)
from meanflow_audio_codec_tpu.training import objectives as jobj
from meanflow_audio_codec_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from meanflow_audio_codec_tpu.training.trainer import (
    adapter_from_config as jax_adapter_from_config,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models import mlp_mixer
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.ops import time_sampling
from meanflow_audio_codec_torch.ops.tokenize import (
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.training import objectives as obj
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.objectives import (
    create_loss_strategy,
)
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

STEPS = 2
LR = 1e-3
UPDATE_REL_L2 = 1e-2
AUDIO_FRAME, WINDOW = 256, 16


def _np(t):
    return t.detach().float().numpy()


def _config(architecture, options, dataset, tokenization, tok_cfg,
            workdir="unused", **training):
    return {
        "config_version": "2.0",
        "base": {"batch_size": 2, "n_steps": 4, "base_lr": LR,
                 "weight_decay": 1e-2, "seed": 3, "grad_clip_norm": 1.0},
        "model": {"noise_dimension": 1, "condition_dimension": 16,
                  "latent_dimension": 8, "num_blocks": 2,
                  "architecture": architecture,
                  "architecture_options": options},
        "dataset": {"dataset": dataset, "tokenization_strategy": tokenization,
                    "tokenization_config": tok_cfg},
        "method": {"method": "improved_mean_flow",
                   "use_improved_mean_flow": True,
                   "time_sampling_full_proportion": 0.25},
        "training": {"sample_every": 1000, "sample_seed": 0,
                     "sample_steps": 1, "workdir": str(workdir),
                     "ema_decay": 0.9, **training},
        "tpu": {"precision": "float32", "skip_nonfinite_updates": True},
    }


MIXER_OPTIONS = {"token_mix_dim": 24, "channel_mix_dim": 20,
                 "num_channels": 4, "num_latent_tokens": 3,
                 "encoder_context_tokens": 4}
# family -> (config dict, flow example width)
FAMILIES = {
    "mlp": (_config("mlp", {}, "mnist", "reshape", {}), 784),
    "mlp_mixer": (_config("mlp_mixer", MIXER_OPTIONS, "audio", "mdct",
                          {"frame_size": AUDIO_FRAME, "window_size": WINDOW,
                           "coeff_scale": 4.0, "gain_norm": 0.05}),
                  2 * WINDOW),
    "simple_conv": (_config("simple_conv", {}, "mnist", "reshape", {}), 784),
}


def _batches(dataset):
    rng = np.random.default_rng(7)
    shape = (2, 784) if dataset == "mnist" else (2, AUDIO_FRAME, 2)
    return [rng.uniform(-1, 1, shape).astype(np.float32)
            for _ in range(STEPS)]


def _random_params(jmodel, width, seed=3, scale=0.2):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, width)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)


def _jax_draws(objective, key, x):
    k_noise, k_tr = jax.random.split(key)
    noise = jax.random.normal(k_noise, x.shape, dtype=x.dtype)
    t, r = objective.time_sampling.sample_time_pair(k_tr, x.shape[0],
                                                    dtype=x.dtype)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, r))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_steps_match_jax(family):
    data, width = FAMILIES[family]
    data = json.loads(json.dumps(data))
    data["model"]["noise_dimension"] = width
    jcfg = TrainFlowConfig.from_dict(data)
    jmodel = jax_create_flow_model(jcfg)
    params = _random_params(jmodel, width)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, tx=jax_make_optimizer(jcfg),
        ema_params=jax.tree_util.tree_map(jnp.array, params),
        ema_decay=jcfg.training.ema_decay)
    jobjective = jobj.create_loss_strategy(jcfg)
    jadapter = jax_adapter_from_config(jcfg, jax_create_tokenization_strategy(
        jcfg.tokenization_strategy, jcfg.tokenization_config))
    jstep = jax_make_train_step(jobjective, tokenizer=jadapter, flatten=True,
                                donate=False, skip_nonfinite=True)

    cfg = config_from_dict(data)
    model = weights.load_flax_params(create_flow_model(cfg), params)
    state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                       device="cpu")
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    step = make_train_step(create_loss_strategy(cfg), adapter,
                           skip_nonfinite=True)
    for k, batch in enumerate(_batches(cfg.dataset)):
        key = jax.random.PRNGKey(100 + k)
        x = jadapter.tokenize(jnp.asarray(batch))
        assert x.shape[1] == width
        noise, t, r = _jax_draws(jobjective, key, x)
        jstate, jm = jstep(jstate, key, jnp.asarray(batch))
        state, m = step(state, torch.from_numpy(batch), noise=noise, t=t,
                        r=r)
        assert m["update_ok"] and bool(jm["update_ok"])
        np.testing.assert_allclose(_np(m["loss"]), np.asarray(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(_np(m["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), rtol=1e-4)
    start = weights.flax_to_torch(params, model.architecture)
    for name, tree in (("params", jstate.params), ("ema", jstate.ema_params)):
        want = weights.flax_to_torch(tree, model.architecture)
        got = (dict(state.model.named_parameters()) if name == "params"
               else state.ema_state_dict())
        assert set(got) == set(want)
        for key, value in want.items():
            moved = value.numpy() - start[key].numpy()
            err = _np(got[key]) - value.numpy()
            assert (np.linalg.norm(err) <= UPDATE_REL_L2
                    * np.linalg.norm(moved)), (name, key)


def test_qat_noise_on_mixer_token_latents_matches_jax():
    """The QAT noise has the shape of ``encode``'s output, the mixer's
    ``[B, tokens, latent]`` tokens, as JAX's quantizer draws it; with
    JAX's draw passed in, the iMF loss and every gradient are JAX's."""
    flow = dict(noise_dimension=40, condition_dimension=16, num_blocks=2,
                latent_dimension=6, token_mix_dim=24, channel_mix_dim=20,
                num_channels=4, num_latent_tokens=3, encoder_context_tokens=4)
    batch = 5  # not the token count: a [B, latent] draw cannot broadcast
    x = (0.3 * np.random.default_rng(1).standard_normal((batch, 40))).astype(
        np.float32)
    jmodel = jmixer.ConditionalMLPMixerFlow(**flow)
    params = _random_params(jmodel, 40, seed=4, scale=0.1)
    sampling = dict(full_interval_proportion=0.25)
    for grid in (dict(step_frac=0.5), dict(bits=4)):
        jobjective = jobj.ImprovedMeanFlowObjective(
            time_sampling=jtime.MeanFlowTimeSampling(**sampling),
            latent_qat=jlq.LatentQAT(mode="noise", **grid))
        key = jax.random.PRNGKey(5)
        (loss_ref, aux_ref), grads_ref = jax.jit(jax.value_and_grad(
            lambda p: jobjective.loss(p, jmodel.apply, key, jnp.asarray(x)),
            has_aux=True))(params)
        latents = jmodel.apply({"params": params}, jnp.asarray(x),
                               method="encode")
        noise, t, r = _jax_draws(jobjective, key, jnp.asarray(x))
        qat_noise = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, 0x9A7), latents.shape,
            dtype=jnp.float32, minval=-0.5, maxval=0.5)))

        model = weights.load_flax_params(
            mlp_mixer.ConditionalMLPMixerFlow(**flow), params)
        objective = obj.ImprovedMeanFlowObjective(
            time_sampling=time_sampling.MeanFlowTimeSampling(**sampling),
            latent_qat=lq.LatentQAT(mode="noise", **grid))
        xt = torch.from_numpy(x)
        draws = objective.draw(model, xt, torch.Generator().manual_seed(0))
        assert tuple(draws["qat_noise"].shape) == tuple(latents.shape)
        loss, aux = objective.loss(model, xt, noise=noise, t=t, r=r,
                                   qat_noise=qat_noise)
        np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), rtol=1e-4)
        np.testing.assert_allclose(_np(aux["mse"]),
                                   np.asarray(aux_ref["mse"]), rtol=1e-4)
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters()))))
        want = weights.flax_to_torch(grads_ref, model.architecture)
        assert set(grads) == set(want)
        for name, g in grads.items():
            ref = want[name].numpy()
            np.testing.assert_allclose(
                _np(g), ref, rtol=1e-3,
                atol=1e-5 * max(float(np.abs(ref).max()), 1e-30),
                err_msg=f"{grid} {name}")
