"""Model factory; counterpart of ``meanflow_audio_codec_tpu/models/factories.py``
for the ``convnet`` family (the only one the port has so far), with its
``fused_stage`` option."""

from __future__ import annotations

import math

import torch
from torch import nn

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.models.blocks import Conv2d, Dense
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow

PRECISION_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "mixed": torch.bfloat16,  # bf16 compute, f32 params
}

#: options that only set the memory policy of the training backward pass
_TRAINING_ONLY_OPTIONS = ("remat", "remat_policy")
#: options whose code paths the port does not have yet
_UNPORTED_OPTIONS = ("quantized",)


def compute_dtype_for(config: CodecConfig) -> torch.dtype:
    """The compute dtype of the config's precision policy."""
    return PRECISION_DTYPES[config.precision]


def init_weights(model: nn.Module, generator: torch.Generator | None = None
                 ) -> nn.Module:
    """Flax's default init: kernels truncated-normal (+-2 sd) with variance
    1/fan_in, biases zero. GRN and layer-scale keep their constructor values."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (Dense, Conv2d)):
                fan_in = module.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
    return model


def create_flow_model(config: CodecConfig,
                      generator: torch.Generator | None = None
                      ) -> ConditionalConvFlow:
    """Build the flow model the config names, computing in the dtype of its
    ``precision``, with weights drawn from ``generator`` (CPU); move it to the
    device afterwards."""
    architecture = config.architecture or "mlp"
    if architecture != "convnet":
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet (only 'convnet')")
    options = dict(config.architecture_options)
    for name in _TRAINING_ONLY_OPTIONS:
        options.pop(name, None)
    for name in _UNPORTED_OPTIONS:
        if options.pop(name, False):
            raise NotImplementedError(f"architecture option {name!r} is not "
                                      "ported yet")
    options.pop("image_size", None)  # accepted but unused by the JAX model
    model = ConditionalConvFlow(
        noise_dimension=config.noise_dimension,
        condition_dimension=config.condition_dimension,
        num_blocks=config.num_blocks,
        latent_dimension=config.latent_dimension,
        compute_dtype=compute_dtype_for(config),
        **options,
    )
    return init_weights(model, generator)
