"""PyTorch port: dynamic W8A8 int8 serving (``ops/quant.py``, the quantized
``Dense``/``Conv2d``/``ConvNeXtBlock``/``ConvStage`` and the factory's
``quantized`` option) against the JAX package's ``ops/quant.py``.

The cases of the JAX package's ``tests/test_quant.py`` one for one (the
int8 product within relative L2 0.02 of the exact one, per-channel scales
under a 1000x column imbalance, the exact fallbacks, 1x1, 3x3 and strided
convolutions, the same parameters, the quantized forward tracking the
unquantized one within 0.05, the trainer refusing the knob), then parity on
identical float32 inputs:

  * the scales, the int8 codes and the int32 accumulators bit for bit;
  * the dequantized outputs bit for bit (the same float32 operations in
    the same order: one product of the two scales, one product with the
    accumulator);
  * a tiny quantized ``ConditionalConvFlow`` (2 stages, 16 channels,
    spatial 4) from a JAX init at float32 within relative L2 1e-5: a
    one-ulp difference upstream (XLA's and PyTorch's GELU or norm) can flip
    an int8 code, a step of amax/127 on one activation; none did at these
    seeds (2.5e-7).

The card's product (``int_product_card``: ``torch._int_mm`` with rows
padded to 17 and K, N to multiples of 8) runs here on the CPU, whose
``torch._int_mm`` takes any shape, so the padding is held against the plain
int32 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.models import ConditionalConvFlow as JaxFlow
from meanflow_audio_codec_tpu.models import factories as jax_factories
from meanflow_audio_codec_tpu.ops import quant as jq
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models.blocks import _same_padding
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops import quant
from meanflow_audio_codec_torch.training.trainer import train_flow

DN = (((1,), (0,)), ((), ()))
CONV_DN = ("NHWC", "HWIO", "NHWC")
FLOW = dict(noise_dimension=64, condition_dimension=32, latent_dimension=16,
            num_blocks=2, channels=16, bottleneck_dim=32, spatial=4,
            lift_channels=8)


def _rel_err(approx, exact):
    approx = np.asarray(approx, dtype=np.float64)
    exact = np.asarray(exact, dtype=np.float64)
    return np.linalg.norm(approx - exact) / (np.linalg.norm(exact) + 1e-12)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv(x, k, stride):
    """(JAX int8 conv, port int8 conv, exact JAX conv) of NHWC ``x`` and
    HWIO ``k`` with SAME padding."""
    ksize = k.shape[0]
    padding = tuple(_same_padding(x.shape[i], ksize, stride) for i in (1, 2))
    port = quant.int8_conv2d(_t(x), _t(k.transpose(3, 2, 0, 1)),
                             stride=stride, padding=padding).numpy()
    args = (jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME")
    ref = jq.int8_conv_general_dilated(*args, dimension_numbers=CONV_DN)
    exact = jax.lax.conv_general_dilated(*args, dimension_numbers=CONV_DN)
    return np.asarray(ref), port, np.asarray(exact)


# ---------------------------------------------------------------------------
# the JAX package's cases
# ---------------------------------------------------------------------------


def test_int8_linear_matches_dense_product():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    w = rng.standard_normal((96, 32)).astype(np.float32)
    approx = quant.int8_linear(_t(x), _t(w.T))
    assert approx.dtype == torch.float32
    assert _rel_err(approx.numpy(), x @ w) < 0.02


def test_int8_linear_per_channel_scales_survive_column_imbalance():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    w[:, 0] *= 1000.0
    x = rng.standard_normal((32, 64)).astype(np.float32)
    exact = np.asarray(jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w), DN))
    approx = quant.int8_linear(_t(x), _t(w.T)).numpy()
    for col in range(8):
        assert _rel_err(approx[:, col], exact[:, col]) < 0.02, col


def test_int8_linear_batched_weight_falls_back_exact():
    """A batched weight is not the Dense case: the exact product, as JAX's
    batched ``dot_general`` falls back (within float32 rounding of JAX's)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 8, 16)).astype(np.float32)
    b = rng.standard_normal((4, 16, 8)).astype(np.float32)
    out = quant.int8_linear(_t(a), _t(b.transpose(0, 2, 1)))
    assert torch.equal(out, torch.matmul(_t(a), _t(b)))
    ref = jq.int8_dot_general(jnp.asarray(a), jnp.asarray(b),
                              (((2,), (1,)), ((0,), (0,))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("ksize,stride,shape,cin,cout", [
    (1, 1, (4, 8, 8), 24, 16), (3, 1, (4, 8, 8), 24, 16),
    (3, 2, (2, 16, 16), 8, 12)], ids=["1x1", "3x3", "3x3-stride2"])
def test_int8_conv_matches_conv_and_jax(ksize, stride, shape, cin, cout):
    """Within 0.02 of the exact conv (JAX's case), and bit for bit JAX's
    int8 conv, shape and dtype included."""
    rng = np.random.default_rng(3 + stride)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    k = (rng.standard_normal((ksize, ksize, cin, cout))
         * (0.2 if stride == 1 else 1.0)).astype(np.float32)
    ref, port, exact = _conv(x, k, stride)
    assert port.shape == exact.shape and port.dtype == exact.dtype
    assert _rel_err(port, exact) < 0.02
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("dilation,groups", [(2, 1), (1, 2)],
                         ids=["dilated", "grouped"])
def test_int8_conv_dilated_or_grouped_falls_back_exact(dilation, groups):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    k = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    pad = ((dilation, dilation), (dilation, dilation))
    out = quant.int8_conv2d(_t(x), _t(k), stride=1, padding=pad,
                            dilation=dilation, groups=groups)
    exact = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), _t(k), padding=dilation,
        dilation=dilation, groups=groups).permute(0, 2, 3, 1)
    assert torch.equal(out, exact)
    ref = jq.int8_conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k.transpose(2, 3, 1, 0)), (1, 1), pad,
        rhs_dilation=(dilation, dilation), dimension_numbers=CONV_DN,
        feature_group_count=groups)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def _tiny_flows(dtype=torch.float32, jax_dtype=jnp.float32):
    """({quantized: port model}, JAX quantized flow, JAX twin, params): the
    port models load a JAX init's parameters, redrawn from a seed."""
    jflow = JaxFlow(quantized=True, dtype=jax_dtype, **FLOW)
    shapes = jax.eval_shape(lambda: jflow.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)
    state = weights.flax_to_torch(params)
    port = {}
    for quantized in (False, True):
        model = ConditionalConvFlow(
            64, 32, 2, 16, channels=16, bottleneck_dim=32, spatial=4,
            lift_channels=8, quantized=quantized, compute_dtype=dtype)
        model.load_state_dict(state, strict=True)  # a JAX init loads as-is
        port[quantized] = model
    return port, jflow, JaxFlow(dtype=jax_dtype, **FLOW), params


def test_quantized_model_state_dict_identical():
    twin = ConditionalConvFlow(64, 32, 2, 16, channels=16, bottleneck_dim=32,
                               spatial=4, lift_channels=8)
    quantized = ConditionalConvFlow(64, 32, 2, 16, channels=16,
                                    bottleneck_dim=32, spatial=4,
                                    lift_channels=8, quantized=True)
    a, b = twin.state_dict(), quantized.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)


def _forward(model, x, t):
    with torch.no_grad():
        return model(_t(x), _t(t), model.encode(_t(x))).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_forward_tracks_unquantized_forward(dtype):
    """The same weights served int8 stay within 0.05 of the unquantized
    decode (JAX's bound), in float32 and in bf16."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    t = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    port, *_ = _tiny_flows(getattr(torch, dtype), getattr(jnp, dtype))
    assert _rel_err(_forward(port[True], x, t), _forward(port[False], x, t)) \
        < 0.05


def test_quantized_flow_matches_jax_at_float32():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    t = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    port, jflow, jtwin, params = _tiny_flows()
    latents = jflow.apply({"params": params}, jnp.asarray(x),
                          method="encode")
    ref = np.asarray(jflow.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(t), latents))
    got = _forward(port[True], x, t)
    assert _rel_err(got, ref) < 1e-5
    twin = np.asarray(jtwin.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(t), latents))
    assert _rel_err(got, twin) > 1e-3  # the int8 path really ran


def test_a_quantized_stage_runs_72_products_at_8_blocks(monkeypatch):
    """Per decoder call: 4 Dense and 5 convs per stage, none elsewhere
    (FiLM's projection, the encoder and ``latent_proj`` stay unquantized),
    counted through the product the card would run."""
    calls = []
    monkeypatch.setattr(quant, "_int_product",
                        lambda a, w: calls.append(a.shape) or
                        quant.int_product_plain(a, w))
    model = ConditionalConvFlow(64, 32, 8, 16, channels=16, bottleneck_dim=32,
                                spatial=4, lift_channels=8, quantized=True)
    x = torch.randn(3, 64)
    latents = model.encode(x)
    assert calls == []
    with torch.no_grad():
        model(x, torch.rand(3, 2), latents)
    assert len(calls) == 72
    assert quant.int8_products == 0  # the count is the card's only


def test_trainer_rejects_quantized_knob(tmp_path):
    from meanflow_audio_codec_torch.configs import create_mnist_config

    config = create_mnist_config(
        architecture="convnet", architecture_options={"quantized": True},
        n_steps=1, workdir=str(tmp_path / "run"))
    with pytest.raises(ValueError, match="serving-only"):
        train_flow(config, device="cpu")


@pytest.mark.parametrize("architecture", ["mlp", "mlp_mixer", "simple_conv"])
def test_quantized_reaches_the_convnet_factory_only(architecture):
    """``architecture_options`` go to the family's factory, and only the
    convnet's takes ``quantized``: the others raise ``TypeError``, as the
    JAX package's factories do."""
    data = {"model": {"noise_dimension": 64, "condition_dimension": 16,
                      "latent_dimension": 8, "num_blocks": 1,
                      "architecture": architecture,
                      "architecture_options": {"quantized": True}}}
    with pytest.raises(TypeError):
        create_flow_model(config_from_dict(data))
    with pytest.raises(TypeError):
        jax_factories._BUILDERS[architecture](
            **{k: v for k, v in data["model"].items()
               if k not in ("architecture", "architecture_options")},
            quantized=True)
    data["model"].update(architecture="convnet", architecture_options=dict(
        channels=16, spatial=4, quantized=True))
    model = create_flow_model(config_from_dict(data))
    assert model.stages[0].block.conv.quantized
    assert not model.stages[0].film.proj.quantized
    assert not model.encoder.head.quantized


# ---------------------------------------------------------------------------
# parity with JAX on identical inputs
# ---------------------------------------------------------------------------


def test_scales_codes_and_accumulators_bit_equal_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    w = rng.standard_normal((96, 32)).astype(np.float32)
    s_act = jq._per_tensor_scale(jnp.asarray(x))
    s_w = jq._per_axis_scale(jnp.asarray(w), axis=1)
    codes_x = jq._quantize(jnp.asarray(x), s_act)
    codes_w = jq._quantize(jnp.asarray(w), s_w)
    acc = jax.lax.dot_general(codes_x, codes_w, DN,
                              preferred_element_type=jnp.int32)
    p_act = quant.per_tensor_scale(_t(x))
    p_w = quant.per_channel_scale(_t(w.T))
    assert p_act.item() == float(s_act)
    np.testing.assert_array_equal(p_w.numpy(), np.asarray(s_w))
    p_codes_x = quant.quantize(_t(x), p_act)
    p_codes_w = quant.quantize(_t(w.T), p_w[:, None])
    np.testing.assert_array_equal(p_codes_x.numpy(), np.asarray(codes_x))
    np.testing.assert_array_equal(p_codes_w.numpy(), np.asarray(codes_w).T)
    p_acc = quant.int_product_plain(p_codes_x, p_codes_w)
    assert p_acc.dtype == torch.int32
    np.testing.assert_array_equal(p_acc.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(
        quant.int8_linear(_t(x), _t(w.T)).numpy(),
        np.asarray(jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w), DN)))


def test_ties_round_half_to_even_as_jax():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.5]], np.float32)
    scale = jnp.float32(1.0)
    np.testing.assert_array_equal(
        quant.quantize(_t(x), torch.tensor(1.0)).numpy(),
        np.asarray(jq._quantize(jnp.asarray(x), scale)))


@pytest.mark.parametrize("rows,k,n", [(1, 16, 8), (16, 2304, 256),
                                      (5, 20, 7), (40, 24, 16)])
def test_card_product_pads_rows_k_and_n(rows, k, n):
    """``int_product_card`` pads rows to 17 and K, N to multiples of 8
    (zeros add nothing) and cuts the result back: equal to the plain int32
    product, a streaming push's few rows included."""
    rng = np.random.default_rng(rows + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    got = quant.int_product_card(a, w)
    assert got.shape == (rows, n) and got.dtype == torch.int32
    assert torch.equal(got, quant.int_product_plain(a, w))


def test_padding_rows_leaves_the_activation_scale_and_rows_alone():
    """Zero rows change neither the per-tensor amax nor any other row's
    product."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((3, 32)).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, 0, 0, 14))
    assert torch.equal(quant.per_tensor_scale(x),
                       quant.per_tensor_scale(padded))
    w = _t(rng.standard_normal((8, 32)).astype(np.float32))
    assert torch.equal(quant.int8_linear(padded, w)[:3],
                       quant.int8_linear(x, w))
