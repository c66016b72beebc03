"""PyTorch port: every training objective and switch against the JAX package.

Flow matching, mean flow (stop-gradient on and off), the autoencoder, iMF
without the stop-gradient (plain and ``fused_stage``), the learned loss
weighting and latent QAT (``ste`` on the ECSQ and the fixed-width grid,
``noise``) on a small convnet flow. Parameters are Flax's init tree with
every leaf redrawn from a seeded numpy generator, carried to the port by
``weights.load_flax_params``; the noise, t, r and the QAT noise are what
the JAX loss draws from its key, passed to the port.

Tolerances are those of ``tests/test_torch_train.py``'s iMF test: loss and
mse rtol 1e-4; every parameter gradient rtol 1e-3 / atol 1e-5 of the largest
gradient of its leaf (two forwards and a JVP in float32, summed in another
order, then differentiated). Against the torch oracles of
``references/strategy.py`` (closed-form model, as tests/test_differential.py
holds the JAX objectives): rtol 1e-5 on the loss, rtol 1e-4 / atol 1e-6 on
the gradient. The QAT transform alone: the ECSQ and v1 round trips as
``tests/test_torch_latent_quant.py`` holds them (v1 bitwise; ECSQ codes may
sit on the other side of a rounding boundary, so rtol 1e-5 where none does).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from meanflow_audio_codec_tpu.configs import (
    BaseConfig,
    DatasetConfig,
    MethodConfig,
    ModelConfig,
    TrainFlowConfig,
    TrainingConfig,
)
from meanflow_audio_codec_tpu.models import conv_flow as jconv
from meanflow_audio_codec_tpu.ops import latent_quant as jlq
from meanflow_audio_codec_tpu.ops import time_sampling as jtime
from meanflow_audio_codec_tpu.ops.losses import LEARNED_WEIGHT_KEY
from meanflow_audio_codec_tpu.references.strategy import (
    FlowMatchingStrategy,
    MeanFlowStrategy,
)
from meanflow_audio_codec_tpu.training import objectives as jobj
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models import conv_flow
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.ops import losses, time_sampling
from meanflow_audio_codec_torch.training import objectives as obj

# the geometry of tests/test_torch_train.py::test_imf_loss_and_gradients_*
FLOW = dict(noise_dimension=64, condition_dimension=32, num_blocks=2,
            latent_dimension=16, channels=128, bottleneck_dim=32,
            spatial=4, lift_channels=8)
BATCH = 8
POLY = [0.1, 0.4, -0.3]  # a learned weighting away from its zero init


def _np(t):
    return t.detach().float().numpy()


def _random_params(module, seed, x, scale=0.1):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), x, jnp.zeros((x.shape[0], 2)),
        method="init_all"))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        shapes["params"])


@functools.cache
def _jax_model(fused: bool):
    """The JAX flow and its parameters, built once for every case."""
    x = jnp.zeros((BATCH, FLOW["noise_dimension"]), jnp.float32)
    jmodel = jconv.ConditionalConvFlow(**FLOW, fused_stage=fused)
    return jmodel, _random_params(jmodel, 0, x)


def _grad_close(got: torch.Tensor, want: np.ndarray, name: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=1e-5 * scale,
                               err_msg=name)


def _pair_sampling(j: bool):
    module = jtime if j else time_sampling
    return module.MeanFlowTimeSampling(full_interval_proportion=0.25)


# case -> (JAX objective, the port's objective, fused_stage, learned)
CASES = {
    "fm": (lambda: jobj.FlowMatchingObjective(),
           lambda: obj.FlowMatchingObjective(), False, False),
    "fm_time_dependent": (
        lambda: jobj.FlowMatchingObjective(use_weighted_loss=False,
                                           loss_weighting="time_dependent"),
        lambda: obj.FlowMatchingObjective(use_weighted_loss=False,
                                          loss_weighting="time_dependent"),
        False, False),
    "mf": (lambda: jobj.MeanFlowObjective(time_sampling=_pair_sampling(True)),
           lambda: obj.MeanFlowObjective(time_sampling=_pair_sampling(False)),
           False, False),
    "mf_no_stop_gradient": (
        lambda: jobj.MeanFlowObjective(time_sampling=_pair_sampling(True),
                                       gamma=0.25, use_stop_gradient=False),
        lambda: obj.MeanFlowObjective(time_sampling=_pair_sampling(False),
                                      gamma=0.25, use_stop_gradient=False),
        False, False),
    "ae": (lambda: jobj.AutoencoderObjective(),
           lambda: obj.AutoencoderObjective(), False, False),
    "imf_no_stop_gradient": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(True), use_stop_gradient=False),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(False), use_stop_gradient=False),
        False, False),
    "imf_no_stop_gradient_fused": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(True), use_stop_gradient=False),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(False), use_stop_gradient=False),
        True, False),
    "imf_learned": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(True), loss_weighting="learned"),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(False), loss_weighting="learned"),
        False, True),
    "fm_learned": (
        lambda: jobj.FlowMatchingObjective(loss_weighting="learned"),
        lambda: obj.FlowMatchingObjective(loss_weighting="learned"),
        False, True),
    "imf_qat_ste_ecsq": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(True),
            latent_qat=jlq.LatentQAT(step_frac=0.5)),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(False),
            latent_qat=lq.LatentQAT(step_frac=0.5)),
        False, False),
    "imf_qat_ste_bits": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(True),
            latent_qat=jlq.LatentQAT(bits=8)),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(False),
            latent_qat=lq.LatentQAT(bits=8)),
        False, False),
    "imf_qat_noise": (
        lambda: jobj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(True),
            latent_qat=jlq.LatentQAT(mode="noise", step_frac=0.5)),
        lambda: obj.ImprovedMeanFlowObjective(
            time_sampling=_pair_sampling(False),
            latent_qat=lq.LatentQAT(mode="noise", step_frac=0.5)),
        False, False),
    "ae_qat_noise_bits": (
        lambda: jobj.AutoencoderObjective(
            latent_qat=jlq.LatentQAT(mode="noise", bits=4)),
        lambda: obj.AutoencoderObjective(
            latent_qat=lq.LatentQAT(mode="noise", bits=4)),
        False, False),
}


def _jax_draws(jobjective, key, x, latent_dim):
    """What ``jobjective.loss`` draws from ``key``, as the port's draws."""
    out = {}
    if not isinstance(jobjective, jobj.AutoencoderObjective):
        k_noise, k_time = jax.random.split(key)
        out["noise"] = jax.random.normal(k_noise, x.shape, dtype=x.dtype)
        if isinstance(jobjective, jobj.FlowMatchingObjective):
            out["t"] = jobjective.time_sampling.sample_time(
                k_time, x.shape[0], dtype=x.dtype)
        else:
            out["t"], out["r"] = jobjective.time_sampling.sample_time_pair(
                k_time, x.shape[0], dtype=x.dtype)
    qat = jobjective.latent_qat
    if qat is not None and qat.mode == "noise":
        out["qat_noise"] = jax.random.uniform(
            jax.random.fold_in(key, 0x9A7), (x.shape[0], latent_dim),
            dtype=jnp.float32, minval=-0.5, maxval=0.5)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(case):
    make_jax, make_port, fused, learned = CASES[case]
    x = (0.3 * np.random.default_rng(1).standard_normal((BATCH, 64))).astype(
        np.float32)
    jmodel, params = _jax_model(fused)
    if learned:
        params = dict(params)
        params[LEARNED_WEIGHT_KEY] = {"poly": np.asarray(POLY, np.float32)}
    jobjective = make_jax()
    key = jax.random.PRNGKey(5)

    def wrapped(p):
        return jobjective.loss(p, jmodel.apply, key, jnp.asarray(x))

    (loss_ref, aux_ref), grads_ref = jax.jit(
        jax.value_and_grad(wrapped, has_aux=True))(params)

    model = conv_flow.ConditionalConvFlow(**FLOW, fused_stage=fused)
    if learned:
        losses.attach_learned_weighting(model)
    weights.load_flax_params(model, params)
    draws = _jax_draws(jobjective, key, jnp.asarray(x),
                       FLOW["latent_dimension"])
    loss, aux = make_port().loss(model, torch.from_numpy(x), **draws)
    np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(_np(aux["mse"]), np.asarray(aux_ref["mse"]),
                               rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    want = weights.flax_to_torch(grads_ref)
    assert set(grads) == set(want)
    assert ("loss_weighting.poly" in grads) == learned
    for name, g in grads.items():
        _grad_close(g, want[name].numpy(), name)


def test_stop_gradient_changes_the_gradient_not_the_loss():
    """Without the stop-gradient the loss is the same and the gradient is
    not: it also flows through du/dt."""
    x = torch.from_numpy((0.3 * np.random.default_rng(2).standard_normal(
        (BATCH, 64))).astype(np.float32))
    model = conv_flow.ConditionalConvFlow(**FLOW)
    gen = torch.Generator().manual_seed(0)
    ref = obj.ImprovedMeanFlowObjective()
    draws = ref.draw(model, x, gen)
    results = []
    for stop in (True, False):
        o = obj.ImprovedMeanFlowObjective(use_stop_gradient=stop)
        loss, _ = o.loss(model, x, **draws)
        grad = torch.autograd.grad(loss, list(model.parameters()))
        results.append((loss, torch.cat([g.reshape(-1) for g in grad])))
    torch.testing.assert_close(results[0][0], results[1][0])
    assert not torch.allclose(results[0][1], results[1][1])


@pytest.mark.parametrize("objective", [
    obj.FlowMatchingObjective(), obj.MeanFlowObjective(),
    obj.ImprovedMeanFlowObjective(), obj.AutoencoderObjective(),
    obj.ImprovedMeanFlowObjective(
        latent_qat=lq.LatentQAT(mode="noise", bits=8))],
    ids=["fm", "mf", "imf", "ae", "imf_qat_noise"])
def test_draws_come_from_the_generator(objective):
    model = conv_flow.ConditionalConvFlow(**FLOW)
    x = torch.randn(BATCH, 64, generator=torch.Generator().manual_seed(0))
    a, b, c = (objective.draw(model, x, torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert set(a) == set(b) == set(c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    if a:
        assert not all(torch.equal(a[k], c[k]) for k in a)
    if "qat_noise" in a:
        assert a["qat_noise"].shape == (BATCH, FLOW["latent_dimension"])
        assert a["qat_noise"].abs().max() <= 0.5
    given = objective.draw(model, x, torch.Generator().manual_seed(3), **a)
    assert all(torch.equal(a[k], given[k]) for k in a)


def test_learned_weighting_requires_its_params():
    model = conv_flow.ConditionalConvFlow(**FLOW)
    with pytest.raises(ValueError, match="learned"):
        obj.FlowMatchingObjective(loss_weighting="learned").loss(
            model, torch.zeros(2, 64), torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# the torch oracles (references/strategy.py) on a closed-form model
# ---------------------------------------------------------------------------

DIM = 6
RNG = np.random.default_rng(0)
A_NP = RNG.standard_normal((DIM, DIM)).astype(np.float32) * 0.3
X0_NP = RNG.standard_normal((BATCH, DIM)).astype(np.float32)
E_NP = RNG.standard_normal((BATCH, DIM)).astype(np.float32)
T_NP = RNG.uniform(0.3, 0.9, (BATCH, 1)).astype(np.float32)
R_NP = (T_NP * RNG.uniform(0.1, 0.9, (BATCH, 1))).astype(np.float32)


class _ClosedForm(nn.Module):
    """``u(z, t, r) = z @ A * (1 + t/2 + (t - r)/4)`` behind the port's model
    signature (``time = [t, h = t - r]``, latents ignored)."""

    latent_dimension = 1

    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(A_NP))

    def encode(self, x):
        return torch.zeros(x.shape[0], 1)

    def forward(self, z, time, latents):
        t, h = time[:, :1], time[:, 1:]
        return z @ self.a * (1.0 + 0.5 * t + 0.25 * h)


def _oracle_model(a):
    return lambda z, t, r: z @ a * (1.0 + 0.5 * t + 0.25 * (t - r))


@pytest.mark.parametrize("name", ["flow_matching", "mean_flow"])
def test_fm_and_mf_match_the_torch_oracles(name):
    x0, e, t, r = map(torch.tensor, (X0_NP, E_NP, T_NP, R_NP))
    a = torch.tensor(A_NP, requires_grad=True)
    if name == "flow_matching":
        want = FlowMatchingStrategy().loss_fn(_oracle_model(a), x0, t, e)
        objective, draws = obj.FlowMatchingObjective(), {"noise": e, "t": t}
    else:
        want = MeanFlowStrategy(gamma=0.5, c=1e-3).loss_fn(
            _oracle_model(a), x0, t, r, e)
        objective = obj.MeanFlowObjective()
        draws = {"noise": e, "t": t, "r": r}
    (want_grad,) = torch.autograd.grad(want, a)
    model = _ClosedForm()
    loss, _ = objective.loss(model, x0, **draws)
    (grad,) = torch.autograd.grad(loss, model.a)
    np.testing.assert_allclose(_np(loss), _np(want), rtol=1e-5)
    np.testing.assert_allclose(_np(grad), _np(want_grad), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# create_loss_strategy: every method and flag
# ---------------------------------------------------------------------------


def _configs(**method):
    jcfg = TrainFlowConfig(
        base=BaseConfig(batch_size=4, n_steps=1, base_lr=1e-4,
                        weight_decay=0.0, seed=0),
        model=ModelConfig(noise_dimension=16, condition_dimension=8,
                          latent_dimension=4, num_blocks=1),
        dataset=DatasetConfig(),
        method=MethodConfig(**method),
        training=TrainingConfig(sample_every=1, sample_seed=0, sample_steps=1,
                                workdir=Path("unused")),
    )
    return jcfg, config_from_dict(jcfg.to_dict())


#: JAX objective fields the port's objective fixes instead of carrying
FIXED = {"AutoencoderObjective": {"use_weighted_loss": False,
                                  "direct_call": False}}


def _same(ours, ref):
    if hasattr(ref, "__dataclass_fields__"):
        name = type(ref).__name__
        assert type(ours).__name__ == name
        fixed = FIXED.get(name, {})
        for field_name in ref.__dataclass_fields__:
            if field_name in fixed:
                assert getattr(ref, field_name) == fixed[field_name]
                assert not hasattr(ours, field_name)
            else:
                _same(getattr(ours, field_name), getattr(ref, field_name))
    else:
        assert ours == ref


STRATEGIES = [
    {}, {"use_improved_mean_flow": True},
    {"method": "mean_flow", "gamma": 1.0, "c": 1e-2},
    {"method": "mean_flow", "gamma": 2.0, "use_stop_gradient": False},
    {"method": "autoencoder"}, {"method": "autoencoder", "qat_bits": 4},
    {"method": "flow_matching", "time_sampling": "uniform",
     "use_weighted_loss": False, "loss_weighting": "learned"},
    {"method": "flow_matching", "noise_schedule": "uniform",
     "loss_weighting": "time_dependent"},
    {"method": "improved_mean_flow", "use_improved_mean_flow": True,
     "noise_schedule": "uniform", "time_sampling": "mean_flow",
     "time_sampling_data_proportion": 0.75},
    {"method": "improved_mean_flow", "use_improved_mean_flow": True,
     "use_stop_gradient": False, "time_sampling_full_proportion": 0.25,
     "flow_ratio": 0.25},
    {"method": "improved_mean_flow", "use_improved_mean_flow": True,
     "qat_step_frac": 0.25, "qat_mode": "noise"},
    {"method": "improved_mean_flow", "use_improved_mean_flow": True,
     "qat_step_frac": 0.5},
    {"loss_strategy": "mean_flow", "method": "flow_matching",
     "time_sampling_mean": 0.2, "time_sampling_std": 0.7},
    {"method": "mean_flow", "noise_min": 0.01, "noise_max": 0.9},
]


@pytest.mark.parametrize("method", STRATEGIES, ids=str)
def test_create_loss_strategy_matches_jax(method):
    jcfg, cfg = _configs(**method)
    _same(obj.create_loss_strategy(cfg), jobj.create_loss_strategy(jcfg))


def test_unknown_loss_strategy_raises():
    cfg = config_from_dict({
        "model": {"noise_dimension": 16, "condition_dimension": 8,
                  "latent_dimension": 4, "num_blocks": 1},
        "method": {"loss_strategy": "diffusion"}})
    with pytest.raises(ValueError, match="Unknown loss_strategy"):
        obj.create_loss_strategy(cfg)


# ---------------------------------------------------------------------------
# LatentQAT alone
# ---------------------------------------------------------------------------


def _latents(seed=0, shape=(32, 16)):
    rng = np.random.default_rng(seed)
    # static per-dim offsets + small residual, like real codec latents
    offsets = 5.0 * rng.standard_normal((1, shape[-1]))
    return (offsets + 0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("grid", [{"step_frac": 0.5}, {"bits": 4},
                                  {"bits": 8}], ids=str)
def test_qat_ste_forward_is_the_eval_round_trip_and_jax(grid):
    z = _latents()
    got = lq.LatentQAT(**grid)(torch.from_numpy(z))
    if "bits" in grid:
        eval_rt = lq.dequantize_latents(lq.quantize_latents(
            torch.from_numpy(z), bits=grid["bits"]))
    else:
        eval_rt = lq.dequantize_latents(lq.quantize_latents_ecsq(
            torch.from_numpy(z), step_frac=grid["step_frac"]))
    np.testing.assert_allclose(_np(got), _np(eval_rt), rtol=0, atol=1e-6)
    want = jlq.LatentQAT(**grid)(jnp.asarray(z), jax.random.PRNGKey(0))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_qat_ste_gradient_is_the_identity_and_keeps_the_dtype():
    z = torch.from_numpy(_latents()).requires_grad_()
    w = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))
    (grad,) = torch.autograd.grad((lq.LatentQAT(step_frac=0.5)(z) * w).sum(),
                                  z)
    torch.testing.assert_close(grad, w, rtol=0, atol=0)
    out = lq.LatentQAT(bits=8)(z.detach().to(torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("grid", [{"step_frac": 0.5}, {"bits": 8}], ids=str)
def test_qat_noise_matches_jax_on_its_draw(grid):
    z = _latents(seed=1)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, z.shape, dtype=jnp.float32,
                                      minval=-0.5, maxval=0.5))
    zt = torch.from_numpy(z).requires_grad_()
    got = lq.LatentQAT(mode="noise", **grid)(zt, noise=torch.from_numpy(u))
    want = jlq.LatentQAT(mode="noise", **grid)(jnp.asarray(z), key)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the noise amplitude is a constant to the gradient: identity again
    (grad,) = torch.autograd.grad(got.sum(), zt)
    torch.testing.assert_close(grad, torch.ones_like(zt))
    step = lq.LatentQAT(mode="noise", **grid)._step(torch.from_numpy(z))
    assert ((got.detach() - zt.detach()).abs() <= 0.5 * step + 1e-6).all()


def test_qat_validates_its_config():
    for kwargs in ({}, {"step_frac": 0.5, "bits": 8},
                   {"mode": "nearest", "step_frac": 0.5}):
        with pytest.raises(ValueError):
            lq.LatentQAT(**kwargs)
    assert lq.LatentQAT(step_frac=0.5).draw((2, 3)) is None
