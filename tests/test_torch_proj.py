"""PyTorch port: the ``proj/`` trials against the JAX scripts.

For each trial, at small widths in float32, the JAX script's model, optax
state and ``make_train_step`` are built as ``proj/*/train.py`` builds them,
and the port's from its ``meanflow_audio_codec_torch.proj`` module, with the
Flax init carried across by ``weights.py``. Both take K = 3 steps on the
same numpy batches (MNIST through the port's ``load_mnist``, audio from the
synthetic source); the iMF trial's noise, t and r are what JAX draws from
its step key, passed in. Tolerances are ``tests/test_torch_train.py``'s:
losses rtol 1e-4, parameters atol 1e-2 of the learning rate (Adam moves
each by about the rate whatever the gradient's size), and Adam's first
moments after each step at the gradient tolerance of
``tests/test_torch_objectives.py``'s mixer autoencoder case (rtol 1e-3,
atol 1e-5 of the largest of any leaf: a token mix's output bias has a
gradient that is zero but for rounding). Adam moves an element by ``lr g
/ (|g| + eps)`` a step: where that gradient tolerance lets the move change
by more than 1e-2 of the rate (``|g|`` within a few orders of eps, 1e-8:
a token mix's output bias, whose gradient is zero in exact arithmetic, or
a near-cancelling sum), the element, read off JAX's first moments, is held
to Adam's bound of the rate a step. The audio trial's reconstruction
through the IMDCT against JAX's at rtol 1e-4 / atol 1e-3
(the transforms' parity tolerance); the MNIST trial's 1-NFE sample, the
noise JAX draws passed in, at rtol 1e-4 / atol 1e-5. Then each trial's
``main`` runs 2 steps on the CPU at its published widths and writes its
output file.
"""

import functools
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meanflow_audio_codec_tpu.models import (
    ConditionalConvFlow as JaxConvFlow,
)
from meanflow_audio_codec_tpu.models import MLPMixerAutoencoder as JaxMixerAE
from meanflow_audio_codec_tpu.models import TrainState as JaxTrainState
from meanflow_audio_codec_tpu.ops import MDCTConfig as JaxMDCTConfig
from meanflow_audio_codec_tpu.ops import MDCTTokenization as JaxMDCT
from meanflow_audio_codec_tpu.ops.sampling import (
    sample_dual_time as jax_sample_dual_time,
)
from meanflow_audio_codec_tpu.training import (
    AutoencoderObjective as JaxAE,
)
from meanflow_audio_codec_tpu.training import (
    ImprovedMeanFlowObjective as JaxIMF,
)
from meanflow_audio_codec_tpu.training import (
    make_train_step as jax_make_train_step,
)
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.data.audio import synthetic_audio_pipeline
from meanflow_audio_codec_torch.data.mnist import load_mnist
from meanflow_audio_codec_torch.ops.mdct import (
    num_frames_for_length,
    output_length,
)
from meanflow_audio_codec_torch.ops.sampling import sample_dual_time
from meanflow_audio_codec_torch.proj import (
    audio_autoencoder,
    mnist_autoencoder,
    mnist_trial,
)
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)

STEPS, BATCH, LR = 3, 4, 1e-4
ADAM_EPS = 1e-8
FLOW = dict(condition_dimension=16, num_blocks=2, latent_dimension=8,
            channels=16, bottleneck_dim=32, spatial=4, lift_channels=8)
MIXER = dict(num_latent_tokens=4, latent_dim=8, num_context_tokens=8,
             num_output_tokens=8, token_mix_dim=16, channel_mix_dim=16)
WINDOW, FRAME = 64, 1024


def _np(t):
    return t.detach().float().numpy()


@functools.cache
def _mnist_batches():
    train, test = load_mnist(BATCH, seed=0)
    return [next(train) for _ in range(STEPS)], next(test)


def _run(jstep, jstate, step, state, batches, architecture, draws=None):
    """K steps of both: checks the losses and the parameters; returns
    both states."""
    rng = jax.random.PRNGKey(0)
    noisy, mu = None, None
    for batch in batches:
        rng, sub = jax.random.split(rng)
        given = draws(sub, batch) if draws else {}
        jstate, jmetrics = jstep(jstate, sub, jnp.asarray(batch))
        state, metrics = step(state, torch.from_numpy(batch), **given)
        np.testing.assert_allclose(_np(metrics["loss"]),
                                   np.asarray(jmetrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(_np(metrics["mse"]),
                                   np.asarray(jmetrics["mse"]), rtol=1e-4)
        # the step's gradient from optax's first moment, mu = b1 mu + (1 -
        # b1) g: the elements where it is at rounding level
        new_mu = {k: v.numpy() for k, v in weights.flax_to_torch(
            jstate.opt_state[0].mu, architecture).items()}
        port_mu = dict(zip(state.names, state.mu))
        scale = max(float(np.abs(v).max()) for v in new_mu.values())
        for k, v in new_mu.items():
            np.testing.assert_allclose(_np(port_mu[k]), v, rtol=1e-3,
                                       atol=1e-5 * scale, err_msg=k)
        grads = {k: (v - 0.9 * (mu[k] if mu else 0.0)) / 0.1
                 for k, v in new_mu.items()}
        g_tol = 1e-5 * max(float(np.abs(g).max()) for g in grads.values())
        low = {k: g_tol * ADAM_EPS > 1e-2 * (np.abs(g) + ADAM_EPS) ** 2
               for k, g in grads.items()}
        noisy = low if noisy is None else {k: noisy[k] | low[k] for k in low}
        mu = new_mu
    want = weights.flax_to_torch(jstate.params, architecture)
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    for name, value in want.items():
        diff = np.abs(_np(got[name]) - value.numpy())
        bound = np.where(noisy[name], LR * len(batches), 1e-2 * LR)
        assert (diff <= bound).all(), (name, diff.max())
    return jstate, state


def _port(module, params, **build):
    """The trial's state as its ``main`` builds it, in float32, holding
    the Flax init ``params`` (loaded into the state's parameter views)."""
    state = create_train_state(
        module.build_model(compute_dtype=torch.float32, **build),
        torch.Generator().manual_seed(0), BATCH, device="cpu")
    weights.load_flax_params(state.model, params)
    return state


def test_mnist_trial_steps_and_samples_as_the_jax_script():
    jmodel = JaxConvFlow(noise_dimension=784, **FLOW, dtype=jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((BATCH, 784)), jnp.zeros((BATCH, 2)),
        method="init_all"))(jax.random.PRNGKey(0))
    jstate = JaxTrainState.create(apply_fn=jmodel.apply,
                                  params=variables["params"],
                                  tx=optax.adamw(1e-4, weight_decay=1e-4))
    jobjective = JaxIMF()
    jstep = jax_make_train_step(jobjective, donate=False)
    state = _port(mnist_trial, variables["params"], **FLOW)

    def draws(key, batch):
        k_noise, k_time = jax.random.split(key)
        noise = jax.random.normal(k_noise, batch.shape)
        t, r = jobjective.time_sampling.sample_time_pair(k_time, len(batch))
        return {k: torch.from_numpy(np.array(v))
                for k, v in (("noise", noise), ("t", t), ("r", r))}

    batches, test = _mnist_batches()
    jstate, state = _run(jstep, jstate, mnist_trial.build_step(), state,
                         batches, "convnet", draws)

    # the 1-NFE sample of the trained parameters, JAX's carried across
    latents = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                                method="encode"))(
        jstate.params, jnp.asarray(test))
    want = jax_sample_dual_time(jstate.apply_fn, 784, jstate.params,
                                jax.random.PRNGKey(1), latents, n_steps=1)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (BATCH, 784))))
    model = weights.load_flax_params(state.model, jstate.params)
    with torch.no_grad():
        got = sample_dual_time(model, 784,
                               model.encode(torch.from_numpy(test)),
                               n_steps=1, noise=noise)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_mnist_autoencoder_steps_as_the_jax_script():
    jmodel = JaxMixerAE(input_dim=784, **MIXER, dtype=jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((BATCH, 784))))(
        jax.random.PRNGKey(0))
    jstate = JaxTrainState.create(apply_fn=jmodel.apply,
                                  params=variables["params"],
                                  tx=optax.adamw(1e-4))
    jstep = jax_make_train_step(JaxAE(direct_call=True), donate=False)
    state = _port(mnist_autoencoder, variables["params"], **MIXER)
    batches, test = _mnist_batches()
    jstate, state = _run(jstep, jstate, mnist_autoencoder.build_step(),
                         state, batches, "mlp_mixer_autoencoder")
    model = weights.load_flax_params(state.model, jstate.params)
    with torch.no_grad():
        got = model(torch.from_numpy(test))
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        jstate.params, jnp.asarray(test))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


class _JaxFrameAdapter:
    """The JAX script's adapter: tokenize, then fold frames into the
    batch."""

    def __init__(self, tok):
        self.tok = tok

    def tokenize(self, x):
        tokens = self.tok.tokenize(x)
        return tokens.reshape(-1, tokens.shape[-1])


def test_audio_autoencoder_steps_and_reconstructs_as_the_jax_script():
    tok = JaxMDCT(config=JaxMDCTConfig(window_size=WINDOW, normalize=True))
    jmodel = JaxMixerAE(input_dim=2 * WINDOW, **MIXER, dtype=jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((4, 2 * WINDOW))))(
        jax.random.PRNGKey(0))
    jstate = JaxTrainState.create(apply_fn=jmodel.apply,
                                  params=variables["params"],
                                  tx=optax.adamw(1e-4))
    jstep = jax_make_train_step(JaxAE(direct_call=True),
                                tokenizer=_JaxFrameAdapter(tok),
                                flatten=False, donate=False)
    state = _port(audio_autoencoder, variables["params"], **MIXER,
                  window_size=WINDOW)
    data = synthetic_audio_pipeline(frame_size=FRAME, batch_size=BATCH)
    tokenizer = audio_autoencoder.build_tokenizer(WINDOW)
    jstate, state = _run(jstep, jstate,
                         audio_autoencoder.build_step(tokenizer), state,
                         [next(data) for _ in range(STEPS)],
                         "mlp_mixer_autoencoder")

    clip = next(data)

    @jax.jit
    def jax_reconstruct(params, clip):
        tokens = tok.tokenize(clip)
        b, nf, width = tokens.shape
        recon = jmodel.apply({"params": params}, tokens.reshape(-1, width))
        return tok.detokenize(recon.reshape(b, nf, width).astype(
            jnp.float32))

    want = jax_reconstruct(jstate.params, jnp.asarray(clip))
    model = weights.load_flax_params(state.model, jstate.params)
    got = audio_autoencoder.reconstruct(model, tokenizer,
                                        torch.from_numpy(clip))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


# trial -> (its output file, the sample count of the WAV or None for a PNG)
OUTPUTS = {mnist_trial: ("samples_1nfe.png", None),
           mnist_autoencoder: ("reconstructions.png", None),
           audio_autoencoder: ("reconstruction.wav", output_length(
               num_frames_for_length(16384, 256, 128), 256, 128))}


@pytest.mark.parametrize("module", list(OUTPUTS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_runs_on_the_cpu_and_writes_its_output(module, tmp_path,
                                                    capsys, monkeypatch):
    runs, real = [], module.train

    def recorded(*args, **kwargs):
        runs.append(real(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(module, "train", recorded)
    assert module.main(["--steps", "2", "--batch-size", "4", "--device",
                        "cpu", "--workdir", str(tmp_path)]) == 0
    name, samples = OUTPUTS[module]
    path = tmp_path / name
    out = capsys.readouterr().out
    assert f"wrote {path}" in out and "step 0:" in out
    ((_, losses),) = runs
    assert len(losses) == 2 and all(np.isfinite(losses))
    if samples is None:
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    else:
        with wave.open(str(path)) as wav:
            assert (wav.getnchannels(), wav.getsampwidth(),
                    wav.getnframes()) == (2, 2, samples)


def test_a_trial_asks_for_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mnist_autoencoder.main(["--steps", "1", "--workdir", str(tmp_path)])
