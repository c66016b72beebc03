"""PyTorch port: the ConvNeXt block's stochastic depth against the JAX block.

The JAX block draws its per-example keep mask from its ``"drop_path"`` rng;
the port takes the mask as ``keep`` or draws it from a ``torch.Generator``
(a stated departure). With ``layer_scale_gamma`` set to 1 a kept row moves
away from its residual and a dropped row equals it exactly, so JAX's mask is
read off its output and passed to the port. Tolerances: rtol 1e-5 / atol
1e-5 on the block's output, whose values reach about 10 (the same float32
arithmetic, summed in another order: a few ulps); the generator's keep
share within 3 sigma of 1 - p over 4096 examples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.models import blocks as jblocks
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.models import blocks

DIM, P = 16, 0.5
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy()


def _params(x):
    shapes = jax.eval_shape(lambda: jblocks.ConvNeXtBlock(dim=DIM).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)
    params["layer_scale_gamma"] = np.ones(DIM, np.float32)
    return params


def _port_block(params, **kwargs):
    block = blocks.ConvNeXtBlock(DIM, drop_path=P, **kwargs)
    sd = weights.flax_to_torch({"blocks_0": {"ConvNeXtBlock_0": params}})
    block.load_state_dict({k.removeprefix("stages.0.block."): v
                           for k, v in sd.items()}, strict=True)
    return block


def _input(batch, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (batch, 4, 4, DIM)).astype(np.float32)


def test_train_output_matches_jax_with_its_mask():
    x = _input(16)
    params = _params(x)
    module = jblocks.ConvNeXtBlock(dim=DIM, drop_path=P)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x),
                                  train=True,
                                  rngs={"drop_path": jax.random.PRNGKey(3)}))
    dropped = (ref == x).reshape(len(x), -1).all(axis=1)
    # neither all kept nor all dropped: the mask is exercised both ways
    assert 0 < dropped.sum() < len(x)
    keep = torch.from_numpy((~dropped).astype(np.float32))
    got = _port_block(params)(torch.from_numpy(x), train=True, keep=keep)
    np.testing.assert_allclose(_np(got), ref, **TOL)
    assert (_np(got)[dropped] == x[dropped]).all()


def test_eval_output_matches_jax():
    x = _input(4)
    params = _params(x)
    ref = jblocks.ConvNeXtBlock(dim=DIM, drop_path=P).apply(
        {"params": params}, jnp.asarray(x))
    block = _port_block(params)
    np.testing.assert_allclose(_np(block(torch.from_numpy(x))),
                               np.asarray(ref), **TOL)
    # at p = 0 train changes nothing either
    plain = _port_block(params)
    plain.drop_path = 0.0
    torch.testing.assert_close(plain(torch.from_numpy(x), train=True),
                               block(torch.from_numpy(x)), rtol=0, atol=0)


def test_generator_draws_the_same_mask_from_the_same_seed():
    batch = 4096
    block = blocks.ConvNeXtBlock(4, drop_path=P, layer_scale_init_value=1.0)
    x = torch.randn(batch, 2, 2, 4, generator=torch.Generator().manual_seed(0))
    a, b, c = (block(x, train=True,
                     generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    kept = ~(a == x).reshape(batch, -1).all(dim=1)
    want = torch.bernoulli(torch.full((batch,), 1.0 - P),
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(kept, want.bool())
    sigma = (P * (1 - P) / batch) ** 0.5
    assert abs(kept.float().mean().item() - (1 - P)) <= 3 * sigma


@pytest.mark.parametrize("branch", [dict(fused_stage=True),
                                    dict(quantized=True),
                                    dict(remat_segments=True)],
                         ids=["fused_stage", "quantized", "remat_segments"])
def test_each_branch_scales_its_kept_rows(branch):
    """Each branch's train output is its eval branch scaled by mask / keep
    before the residual."""
    x = _input(6, seed=7)
    block = _port_block(_params(x), **branch)
    keep = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    xt = torch.from_numpy(x)
    h = block(xt) - xt
    want = h * keep[:, None, None, None] / (1.0 - P) + xt
    torch.testing.assert_close(block(xt, train=True, keep=keep), want,
                               rtol=1e-6, atol=1e-6)
