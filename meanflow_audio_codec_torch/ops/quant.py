"""Dynamic W8A8 int8 products for the quantized serving path.

Counterpart of ``meanflow_audio_codec_tpu/ops/quant.py``, with its scheme
kept exactly:

* activations: one symmetric scale per tensor, ``max(amax|x|, 1e-12)/127``,
  computed in the forward (no calibration pass, no host sync);
* weights: one symmetric scale per output channel (a Dense weight is
  ``[out, in]`` here, a conv weight OIHW: the scale reduces over every other
  axis);
* ``round(x / scale)`` (half to even, as ``jnp.round``), clipped to +-127;
* int32 accumulation, dequantized as ``acc * (s_act * s_w)`` in float32,
  then cast to the input's dtype; the caller adds the bias in that dtype, as
  Flax does after an injected ``dot_general``.

Inputs and weights come in the layer's compute dtype, as Flax promotes them
before the product, so the scales are those of the cast tensors.

:func:`int8_linear` and :func:`int8_conv2d` run the int32 product exactly:
on a CPU tensor through the plain version (an int32 matmul), on a CUDA
tensor through ``torch._int_mm`` (cuBLASLt's int8 GEMM; the JAX package's
int8 product is ``lax.dot_general``/``conv_general_dilated`` outside any
Pallas kernel). ``int8_products`` counts the card's int8 products. The
convolution is an im2col over the channels-last activations, so its output
rows come out in the ``[B, H, W, O]`` order the port keeps.

As in the JAX package, what is not the Dense case (a batched weight) or not
an undilated, ungrouped convolution falls back to the exact float op.
Training never runs this path (the trainer refuses the ``quantized`` knob).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

QMAX = 127.0
EPS = 1e-12
#: ``torch._int_mm`` on the card takes more than 16 rows and K, N multiples
#: of 8; shorter or narrower operands are zero-padded up to these
MIN_ROWS = 17
ALIGN = 8

#: int8 products run on the card since the count was last set to 0
int8_products = 0


@functools.cache
def _qmax(device: torch.device) -> torch.Tensor:
    """127 as a float32 tensor on ``device``. A CUDA tensor divided by a
    Python number is multiplied by its reciprocal, which is off the quotient
    by an ulp at times; a tensor divisor keeps the division."""
    return torch.tensor(QMAX, device=device)


def per_tensor_scale(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor scale, a float32 0-d tensor."""
    return x.float().abs().amax().clamp_min(EPS) / _qmax(x.device)


def per_channel_scale(weight: torch.Tensor) -> torch.Tensor:
    """One symmetric scale per output channel (axis 0), float32 ``[out]``."""
    amax = weight.float().abs().amax(dim=tuple(range(1, weight.ndim)))
    return amax.clamp_min(EPS) / _qmax(weight.device)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round to nearest int8 with the given broadcastable scale. The
    division is kept: a product with the reciprocal flips ties."""
    q = torch.round(x.float() / scale)
    return q.clamp(-QMAX, QMAX).to(torch.int8)


def int_product_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ w [N, K]^T`` of int8 codes on the CPU, exact in int32."""
    return torch.mm(a.to(torch.int32), w.to(torch.int32).t())


def int_product_card(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ w [N, K]^T`` through ``torch._int_mm``, with the rows
    zero-padded to ``MIN_ROWS`` and K and N to multiples of ``ALIGN``.

    A zero row or column adds nothing to the other rows' sums. The weight
    goes in as the transposed (column-major) view ``_int_mm`` takes, so no
    copy is made unless N or K needs padding."""
    rows, k = a.shape
    n = w.shape[0]
    pad_k = -k % ALIGN
    if pad_k:
        a, w = F.pad(a, (0, pad_k)), F.pad(w, (0, pad_k))
    if -n % ALIGN:
        w = F.pad(w, (0, 0, 0, -n % ALIGN))
    if rows < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - rows))
    return torch._int_mm(a.contiguous(), w.t())[:rows, :n]


def _int_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global int8_products
    if a.device.type == "cpu":
        return int_product_plain(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"int8 products take CPU or CUDA tensors, got "
                         f"{a.device}")
    out = int_product_card(a, w)
    int8_products += 1
    return out


def _dequantize(acc: torch.Tensor, s_act: torch.Tensor, s_w: torch.Tensor,
                dtype: torch.dtype, bias: torch.Tensor | None) -> torch.Tensor:
    out = (acc.float() * (s_act * s_w)).to(dtype)
    return out if bias is None else out + bias.to(dtype)


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` in W8A8 int8: ``x [..., K]``, ``weight
    [N, K]``, result in ``x``'s dtype.

    A batched weight (more than 2 dims: not the Dense case) falls back to
    the exact ``x @ weight^T``."""
    if weight.ndim != 2:
        out = torch.matmul(x, weight.transpose(-1, -2))
        return out if bias is None else out + bias.to(out.dtype)
    s_act = per_tensor_scale(x)
    s_w = per_channel_scale(weight)
    rows = quantize(x, s_act).reshape(-1, x.shape[-1])
    acc = _int_product(rows, quantize(weight, s_w[:, None]))
    out = _dequantize(acc, s_act, s_w, x.dtype, bias)
    return out.reshape(*x.shape[:-1], weight.shape[0])


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None, stride: int = 1,
                padding: tuple[tuple[int, int], tuple[int, int]] = (
                    (0, 0), (0, 0)),
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """A 2-d convolution in W8A8 int8 on channels-last activations: ``x
    [B, H, W, C]``, ``weight`` OIHW, ``padding`` ((top, bottom), (left,
    right)) of zeros; result ``[B, H', W', O]`` in ``x``'s dtype.

    The padded codes are unfolded into ``[B*H'*W', C*kh*kw]`` rows, in the
    order of ``weight.reshape(O, -1)``. A dilated or grouped convolution
    falls back to the exact ``F.conv2d``."""
    (top, bottom), (left, right) = padding
    if dilation != 1 or groups != 1:
        h = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        out = F.conv2d(h, weight, None, stride=stride, dilation=dilation,
                       groups=groups).permute(0, 2, 3, 1)
        return out if bias is None else out + bias.to(out.dtype)
    out_ch, _, kh, kw = weight.shape
    s_act = per_tensor_scale(x)
    s_w = per_channel_scale(weight)
    codes = F.pad(quantize(x, s_act), (0, 0, left, right, top, bottom))
    # [B, H', W', C, kh, kw]: a strided view, copied once into the rows
    patches = codes.unfold(1, kh, stride).unfold(2, kw, stride)
    b, ho, wo = patches.shape[:3]
    acc = _int_product(patches.reshape(b * ho * wo, -1),
                       quantize(weight, s_w[:, None, None, None]).reshape(
                           out_ch, -1))
    return _dequantize(acc, s_act, s_w, x.dtype, bias).reshape(b, ho, wo,
                                                               out_ch)
