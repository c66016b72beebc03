"""PyTorch port: the fused stage ops (``ops/stage.py``) and the
``fused_stage`` modules, against the JAX package.

On the CPU the port's ops run their plain versions (the CUDA kernels are held
against those on the card, tests/test_torch_cuda.py); the JAX public ops run
their Pallas kernels in interpret mode (``interpret=True``, as
tests/test_stage_pallas.py runs them) where the shape is lane-aligned, and
their jnp reference otherwise. The JAX fused modules run the jnp reference on
the CPU.

Tolerances: float32 at rtol 1e-5 / atol 1e-5 for the forward (the same f32
arithmetic, summed in another order), rtol / atol 1e-4 for tangents and
gradients (as tests/test_stage_pallas.py states them). bf16 outputs at
rtol / atol 1e-2: both sides compute in f32 and round once to bf16
(2**-7 relative), and a last-bit f32 difference can flip that rounding. The
modules take the tolerances of tests/test_torch_model.py (f32 rtol 1e-4 /
atol 1e-5; bf16 relative L2 <= 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from meanflow_audio_codec_tpu.models import blocks as jblocks
from meanflow_audio_codec_tpu.models import conv_flow as jconv
from meanflow_audio_codec_tpu.ops import stage_pallas as jstage
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.models import blocks, conv_flow
from meanflow_audio_codec_torch.ops import stage, stage_cuda

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
DIFF = dict(rtol=1e-4, atol=1e-4)
MODULE = dict(rtol=1e-4, atol=1e-5)
ALIGNED = (8, 16, 128)
SHAPES = [ALIGNED, (3, 9, 40), (2, 5, 7)]


def _np(t):
    return t.detach().float().numpy()


def _inputs(shape, seed=0):
    b, p, c = shape
    rng = np.random.default_rng(seed)
    return {
        "x": (2.0 * rng.standard_normal((b, p, c))).astype(np.float32),
        "s": (0.3 * rng.standard_normal((b, c))).astype(np.float32),
        "b": (0.3 * rng.standard_normal((b, c))).astype(np.float32),
        "gamma": (0.5 * rng.standard_normal(c)).astype(np.float32),
        "beta": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "tx": rng.standard_normal((b, p, c)).astype(np.float32),
        "ts": (0.1 * rng.standard_normal((b, c))).astype(np.float32),
        "tb": (0.1 * rng.standard_normal((b, c))).astype(np.float32),
        "tgamma": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "tbeta": (0.1 * rng.standard_normal(c)).astype(np.float32),
    }


def _pair(array, dtype):
    """The same array for JAX and for the port, in ``dtype``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jnp.asarray(array).astype(jdt), torch.from_numpy(array).to(dtype)


def _close(got, ref, tol):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **tol)


def _f64_refs(name, data, keys):
    """The segment's output and statistics in float64 numpy, from the same
    inputs: the referee that says which side departs when the port and JAX
    disagree."""
    x, *rest = (data[k].astype(np.float64) for k in keys)
    if name == "gelu_grn":
        gamma, beta = rest
        g = 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                     * (x + 0.044715 * x ** 3)))
        gx = np.sqrt((g * g).sum(axis=1) + 1e-12)
        nx = gx / (gx.mean(axis=-1, keepdims=True) + 1e-6)
        return g * (gamma + nx[:, None, :]) + beta, gx
    mu = x.mean(axis=-1)
    r = 1.0 / np.sqrt(((x - mu[..., None]) ** 2).mean(axis=-1) + 1e-6)
    y = (x - mu[..., None]) * r[..., None]
    if name == "ln_film":
        s, b = rest
        y = (1.0 + s[:, None, :]) * y + b[:, None, :]
    return y, mu, r


def _close_or_referee(got, want, tol, ref64):
    """``_close``; on a failure, the message also gives each side's largest
    error against the float64 referee."""
    try:
        _close(got, want, tol)
    except AssertionError as exc:
        errors = {side: float(np.abs(np.asarray(v, np.float64) - ref64).max())
                  for side, v in (("port", _np(got)), ("jax", want))}
        raise AssertionError(f"{exc}\nlargest error against float64: "
                             f"{errors}") from None


# (name, the port's plain version, JAX's reference, the input keys)
REFS = [
    ("ln_film", stage._ln_film_ref, jstage._ln_film_ref, ("x", "s", "b")),
    ("ln_norm", stage._ln_norm_ref, jstage._ln_norm_ref, ("x",)),
    ("gelu_grn", stage._gelu_grn_ref, jstage._gelu_grn_ref,
     ("x", "gamma", "beta")),
]
# (name, the port's public op, JAX's public op, input keys, tangent keys)
OPS = [
    ("ln_film", stage.fused_ln_film, jstage.fused_ln_film, ("x", "s", "b"),
     ("tx", "ts", "tb")),
    ("ln_norm", stage.fused_ln_norm, jstage.fused_ln_norm, ("x",), ("tx",)),
    ("gelu_grn", stage.fused_gelu_grn, jstage.fused_gelu_grn,
     ("x", "gamma", "beta"), ("tx", "tgamma", "tbeta")),
]


def _jax_op(jop, shape):
    """JAX's public op: the interpret-mode kernel where lane-aligned."""
    interpret = shape == ALIGNED
    return lambda *args: jop(*args, interpret)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,ref,jref,keys", REFS, ids=[r[0] for r in REFS])
def test_plain_versions_and_stats_match_jax(name, ref, jref, keys, shape,
                                            dtype):
    data = _inputs(shape)
    pairs = [_pair(data[k], dtype if k in ("x", "s", "b") else torch.float32)
             for k in keys]
    got = ref(*(t for _, t in pairs))
    want = jref(*(j for j, _ in pairs))
    ref64 = _f64_refs(name, data, keys)
    assert got[0].dtype == dtype
    _close_or_referee(got[0], want[0],
                      F32 if dtype == torch.float32 else BF16, ref64[0])
    for g, w, r in zip(got[1:], want[1:], ref64[1:]):  # statistics, f32
        assert g.dtype == torch.float32
        _close_or_referee(g, w, F32, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,op,jop,keys,tkeys", OPS,
                         ids=[o[0] for o in OPS])
def test_public_ops_match_jax(name, op, jop, keys, tkeys, shape, dtype):
    data = _inputs(shape, seed=1)
    pairs = [_pair(data[k], dtype if k in ("x", "s", "b") else torch.float32)
             for k in keys]
    got = op(*(t for _, t in pairs))
    want = _jax_op(jop, shape)(*(j for j, _ in pairs))
    assert got.dtype == dtype
    _close(got, want, F32 if dtype == torch.float32 else BF16)


@pytest.mark.parametrize("shape", [ALIGNED, (3, 9, 40)], ids=str)
@pytest.mark.parametrize("name,op,jop,keys,tkeys", OPS,
                         ids=[o[0] for o in OPS])
def test_public_ops_tangents_match_jax_jvp(name, op, jop, keys, tkeys, shape):
    data = _inputs(shape, seed=2)
    primals = [data[k] for k in keys]
    tangents = [data[k] for k in tkeys]
    y_ref, ty_ref = jax.jvp(_jax_op(jop, shape),
                            tuple(map(jnp.asarray, primals)),
                            tuple(map(jnp.asarray, tangents)))
    with fwAD.dual_level():
        duals = [fwAD.make_dual(torch.from_numpy(p), torch.from_numpy(t))
                 for p, t in zip(primals, tangents)]
        y, ty = fwAD.unpack_dual(op(*duals))
    _close(y, y_ref, F32)
    _close(ty, ty_ref, DIFF)


def test_tangent_of_x_alone_matches_jax_jvp():
    """Parameters carry no tangent in the model (GRN gamma/beta): the rule
    takes a tangent for x only."""
    data = _inputs(ALIGNED, seed=3)
    zeros = np.zeros_like(data["gamma"])
    _, ty_ref = jax.jvp(_jax_op(jstage.fused_gelu_grn, ALIGNED),
                        (jnp.asarray(data["x"]), jnp.asarray(data["gamma"]),
                         jnp.asarray(data["beta"])),
                        (jnp.asarray(data["tx"]), jnp.asarray(zeros),
                         jnp.asarray(zeros)))
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.from_numpy(data["x"]),
                           torch.from_numpy(data["tx"]))
        _, ty = fwAD.unpack_dual(stage.fused_gelu_grn(
            x, torch.from_numpy(data["gamma"]),
            torch.from_numpy(data["beta"])))
    _close(ty, ty_ref, DIFF)


@pytest.mark.parametrize("shape", [ALIGNED, (3, 9, 40)], ids=str)
@pytest.mark.parametrize("name,op,jop,keys,tkeys", OPS,
                         ids=[o[0] for o in OPS])
def test_public_ops_gradients_match_jax_grad(name, op, jop, keys, tkeys,
                                             shape):
    data = _inputs(shape, seed=4)
    primals = [data[k] for k in keys]
    jfn = _jax_op(jop, shape)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jfn(*a))),
                    argnums=tuple(range(len(keys))))(
        *map(jnp.asarray, primals))
    leaves = [torch.from_numpy(p).requires_grad_() for p in primals]
    got = torch.autograd.grad(torch.sin(op(*leaves)).sum(), leaves)
    for g, w in zip(got, want):
        _close(g, w, DIFF)


@pytest.mark.parametrize("shape", [ALIGNED, (3, 9, 40)], ids=str)
@pytest.mark.parametrize("name,op,jop,keys,tkeys", OPS,
                         ids=[o[0] for o in OPS])
def test_public_ops_grad_of_jvp_matches_jax(name, op, jop, keys, tkeys,
                                            shape):
    """Reverse mode through the tangent (the objectives without the
    stop-gradient): the gradient of sum((u + 0.3 du)^2), with (u, du) the
    JVP along a tangent of x, with respect to x, the op's parameters and
    the tangent, against ``jax.grad`` of ``jax.jvp`` of JAX's public op.
    Summed, so that the gradients are of order one and the 1e-4 tolerance
    binds."""
    data = _inputs(shape, seed=6)
    primals = [data[k] for k in keys] + [data["tx"]]
    jfn = _jax_op(jop, shape)

    def jloss(x, *rest):
        *params, v = rest
        u, du = jax.jvp(lambda z: jfn(z, *params), (x,), (v,))
        return jnp.sum(jnp.square(u + 0.3 * du))

    want = jax.grad(jloss, argnums=tuple(range(len(primals))))(
        *map(jnp.asarray, primals))
    leaves = [torch.from_numpy(p).requires_grad_() for p in primals]
    x, *params, v = leaves
    with fwAD.dual_level(), stage.differentiable_tangents():
        u, du = fwAD.unpack_dual(op(fwAD.make_dual(x, v), *params))
    got = torch.autograd.grad(torch.square(u + 0.3 * du).sum(), leaves)
    for g, w in zip(got, want):
        _close(g, w, DIFF)


@pytest.mark.parametrize("name,op,jop,keys,tkeys", OPS,
                         ids=[o[0] for o in OPS])
def test_tangents_keep_no_graph_unless_asked(name, op, jop, keys, tkeys):
    """The stop-gradient objectives' fast path: the tangent rule runs under
    no_grad, so the tangent is a constant to reverse mode."""
    data = _inputs((3, 9, 40), seed=7)
    leaves = [torch.from_numpy(data[k]).requires_grad_() for k in keys]
    for differentiable in (False, True):
        with fwAD.dual_level(), stage.differentiable_tangents(differentiable):
            y, ty = fwAD.unpack_dual(op(fwAD.make_dual(
                leaves[0], torch.from_numpy(data["tx"])), *leaves[1:]))
        assert y.requires_grad
        assert ty.requires_grad == differentiable
    assert not stage.tangents_differentiable()


def test_backward_skips_inputs_without_grad():
    data = _inputs((3, 9, 40), seed=5)
    x = torch.from_numpy(data["x"]).requires_grad_()
    y = stage.fused_gelu_grn(x, torch.from_numpy(data["gamma"]),
                             torch.from_numpy(data["beta"]))
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape and torch.isfinite(gx).all()


@pytest.mark.parametrize("shape,dtype,variant", [
    ((2032, 64, 512), torch.bfloat16, "single_read"),  # the train shape
    ((2032, 64, 512), torch.float32, "single_read"),
    ((3, 9, 41), torch.float32, "single_read"),        # scalar loads
    ((1, 1, 1), torch.bfloat16, "single_read"),
    ((4, 256, 512), torch.bfloat16, "two_pass"),       # long P
    ((4, 256, 512), torch.float32, "two_pass"),
    ((2, 8, 8192), torch.bfloat16, "two_pass"),        # C / 8 > 512 threads
    ((2, 0, 8), torch.float32, "two_pass"),
], ids=str)
def test_gelu_grn_kernel_is_chosen_by_shape(shape, dtype, variant):
    assert stage_cuda.gelu_grn_variant(torch.empty(shape, dtype=dtype)) == \
        variant


def test_gelu_grn_wrapper_runs_the_plain_version_on_cpu():
    data = _inputs((3, 9, 40), seed=6)
    x, gamma, beta = (torch.from_numpy(data[k]) for k in ("x", "gamma",
                                                           "beta"))
    before = (dict(stage_cuda.launches), dict(stage_cuda.gelu_grn_variants))
    got = stage_cuda.gelu_grn_cuda(x, gamma, beta)
    ref = stage._gelu_grn_ref(x, gamma, beta)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (stage_cuda.launches, stage_cuda.gelu_grn_variants) == before


# ---------------------------------------------------------------------------
# fused_stage modules
# ---------------------------------------------------------------------------


def _random_params(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes["params"])


def test_fused_film_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, 4, 24)).astype(np.float32) * 2 + 1
    cond = rng.standard_normal((3, 16)).astype(np.float32)
    module = jblocks.FiLM(channels=24, fuse_norm=True)
    params = _random_params(module, 7, jnp.asarray(x), jnp.asarray(cond))
    ref = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond))
    film = blocks.FiLM(16, 24, fuse_norm=True)
    film.proj.weight.data = torch.from_numpy(
        np.ascontiguousarray(params["Dense_0"]["kernel"].T))
    film.proj.bias.data = torch.from_numpy(params["Dense_0"]["bias"])
    _close(film(torch.from_numpy(x), torch.from_numpy(cond)), ref, MODULE)


def test_fused_grn_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 4, 4, 32)).astype(
        np.float32)
    x[:, :, :, 5] = -30.0  # a channel GELU kills: the eps inside the sqrt
    module = jblocks.GlobalResponseNormalization(fused_gelu=True)
    params = _random_params(module, 9, jnp.asarray(x))
    ref = module.apply({"params": params}, jnp.asarray(x))
    grn = blocks.GlobalResponseNormalization(32, fused_gelu=True)
    grn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    _close(grn(torch.from_numpy(x)), ref, MODULE)


def test_fused_convnext_block_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    module = jblocks.ConvNeXtBlock(dim=16, fused_stage=True)
    params = _random_params(module, 11, jnp.asarray(x))
    ref = module.apply({"params": params}, jnp.asarray(x))
    block = blocks.ConvNeXtBlock(16, fused_stage=True)
    sd = weights.flax_to_torch({"blocks_0": {"ConvNeXtBlock_0": params}})
    block.load_state_dict({k.removeprefix("stages.0.block."): v
                           for k, v in sd.items()}, strict=True)
    _close(block(torch.from_numpy(x)), ref, MODULE)


@pytest.mark.parametrize("lift_channels", [8, None])
def test_fused_conv_stage_matches_jax(lift_channels):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    cond = rng.standard_normal((3, 16)).astype(np.float32)
    geometry = dict(channels=16, spatial=4, lift_channels=lift_channels,
                    bottleneck_dim=32)
    module = jconv.ConvStage(noise_dimension=128, condition_dimension=16,
                             num_blocks=2, fused_stage=True, **geometry)
    params = _random_params(module, 13, jnp.asarray(x), jnp.asarray(cond))
    ref = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond))
    stage_ = conv_flow.ConvStage(128, 16, 2, fused_stage=True, **geometry)
    sd = weights.flax_to_torch({"blocks_0": params})
    stage_.load_state_dict({k.removeprefix("stages.0."): v
                            for k, v in sd.items()}, strict=True)
    _close(stage_(torch.from_numpy(x), torch.from_numpy(cond)), ref, MODULE)


FLOW = dict(noise_dimension=128, condition_dimension=16, num_blocks=2,
            latent_dimension=8, channels=16, spatial=4, lift_channels=8,
            bottleneck_dim=32)


def _flows(jdtype, tdtype, fused=True):
    jmodel = jconv.ConditionalConvFlow(**FLOW, fused_stage=fused, dtype=jdtype)
    params = _random_params(jmodel, 14, jnp.zeros((2, 128)), jnp.zeros((2, 2)),
                            method="init_all")
    tmodel = conv_flow.ConditionalConvFlow(**FLOW, fused_stage=fused,
                                           compute_dtype=tdtype)
    weights.load_flax_params(tmodel, params)
    return jmodel, params, tmodel


def _flow_inputs():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    time = np.stack([np.ones(4), np.linspace(0, 1, 4)], -1).astype(np.float32)
    latents = rng.standard_normal((4, 8)).astype(np.float32)
    return x, time, latents


def test_fused_conditional_conv_flow_matches_jax_f32():
    jmodel, params, tmodel = _flows(jnp.float32, torch.float32)
    x, time, latents = _flow_inputs()
    ref = jmodel.apply({"params": params}, *map(jnp.asarray,
                                                (x, time, latents)))
    got = tmodel(*map(torch.from_numpy, (x, time, latents)))
    _close(got, ref, MODULE)


def test_fused_conditional_conv_flow_matches_jax_bf16():
    jmodel, params, tmodel = _flows(jnp.bfloat16, torch.bfloat16)
    x, time, latents = _flow_inputs()
    ref = np.asarray(jmodel.apply({"params": params},
                                  *map(jnp.asarray, (x, time, latents))),
                     np.float32)
    got = tmodel(*map(torch.from_numpy, (x, time, latents)))
    assert got.dtype == torch.bfloat16
    assert np.linalg.norm(_np(got) - ref) / np.linalg.norm(ref) <= 2e-2


def test_fused_and_plain_trees_convert_with_one_mapping():
    _, fused, tmodel = _flows(jnp.float32, torch.float32, fused=True)
    _, plain, _ = _flows(jnp.float32, torch.float32, fused=False)
    assert (jax.tree_util.tree_structure(fused)
            == jax.tree_util.tree_structure(plain))
    fused_sd, plain_sd = weights.flax_to_torch(fused), weights.flax_to_torch(
        plain)
    assert list(fused_sd) == list(plain_sd)
    assert set(fused_sd) == set(tmodel.state_dict())
    for key, value in fused_sd.items():
        assert value.shape == plain_sd[key].shape, key


# ---------------------------------------------------------------------------
# the plain GELU+GRN does not depend on the CPU's math library path
# ---------------------------------------------------------------------------
#
# ROADMAP §3: on one host the f32 gelu_grn case above failed with 907 of
# 16384 outputs off (2.6e-4 against the float64 referee, JAX's side at
# 2.5e-6). Its numbers are reproduced to the last digit by MKL's vsTanh in
# its reduced-accuracy (EP) mode on MKL's AVX2 path, applied to the last
# 2048 elements (one internal thread's chunk of 8): ``torch.tanh`` on a
# CPU float tensor is MKL's vsTanh. The plain GELU now runs ATen's own
# gelu kernels and GRN's square root is taken in float64 (MKL's vsSqrt,
# behind ``torch.sqrt``, changes its last bit with MKL's code path), so the
# result no longer depends on MKL's path or thread count.


def test_plain_gelu_and_its_rules_never_call_torch_tanh(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.tanh (MKL's vsTanh on the CPU) called")

    data = _inputs(ALIGNED)
    x, gamma, beta, tx = (torch.from_numpy(data[k]) for k in
                          ("x", "gamma", "beta", "tx"))
    want_y, want_gx = stage._gelu_grn_ref(x, gamma, beta)
    monkeypatch.setattr(torch, "tanh", refuse)
    y, gx = stage._gelu_grn_ref(x, gamma, beta)
    assert torch.equal(y, want_y) and torch.equal(gx, want_gx)
    with fwAD.dual_level():
        _, ty = fwAD.unpack_dual(stage.fused_gelu_grn(
            fwAD.make_dual(x, tx), gamma, beta))
    assert torch.isfinite(ty).all()
    xg = x.clone().requires_grad_()
    stage.fused_gelu_grn(xg, gamma, beta).sum().backward()
    assert torch.isfinite(xg.grad).all()


_GELU_PROBE = """
import hashlib, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
from meanflow_audio_codec_torch.ops import stage
data = np.load({path!r})
args = [torch.from_numpy(data[k]) for k in ("x", "gamma", "beta")]
for threads in (1, 2, 8):
    torch.set_num_threads(threads)
    y, gx = stage._gelu_grn_ref(*args)
    print(threads, hashlib.sha256(y.numpy().tobytes()
                                  + gx.numpy().tobytes()).hexdigest())
"""


@pytest.mark.parametrize("mkl_path", ["default", "AVX2", "SSE4_2"])
def test_plain_gelu_grn_is_the_same_under_each_cpu_path(mkl_path, tmp_path):
    """The f32 case above, recomputed in a fresh process on each of MKL's
    code paths (``MKL_ENABLE_INSTRUCTIONS``) at 1, 2 and 8 threads: the same
    bytes as this process's, within F32 of the float64 referee."""
    import hashlib
    import os
    import subprocess
    import sys
    from pathlib import Path

    data = _inputs(ALIGNED)
    np.savez(tmp_path / "inputs.npz", **data)
    y, gx = stage._gelu_grn_ref(*(torch.from_numpy(data[k])
                                  for k in ("x", "gamma", "beta")))
    ref64 = _f64_refs("gelu_grn", data, ("x", "gamma", "beta"))
    _close(y, ref64[0], F32)
    _close(gx, ref64[1], F32)
    digest = hashlib.sha256(y.numpy().tobytes()
                            + gx.numpy().tobytes()).hexdigest()
    env = dict(os.environ)
    env.pop("MKL_ENABLE_INSTRUCTIONS", None)
    if mkl_path != "default":
        env["MKL_ENABLE_INSTRUCTIONS"] = mkl_path
    repo = str(Path(__file__).resolve().parents[1])
    result = subprocess.run(
        [sys.executable, "-c", _GELU_PROBE.format(
            repo=repo, path=str(tmp_path / "inputs.npz"))],
        env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    lines = result.stdout.split()
    assert lines == ["1", digest, "2", digest, "8", digest]
