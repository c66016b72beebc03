"""Model factory; counterpart of ``meanflow_audio_codec_tpu/models/factories.py``.

``create_flow_model(config)`` builds the family ``config.architecture`` names
(default ``mlp``): ``convnet`` (with its ``fused_stage``, ``remat``,
``remat_policy`` and the serving-only ``quantized`` options), ``mlp``,
``mlp_mixer`` and ``simple_conv``.
``architecture_options`` pass straight to the family's builder, as in the
JAX package, so an option the family does not take raises ``TypeError``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.models.blocks import Conv2d, Dense
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.models.mlp_flow import ConditionalFlow
from meanflow_audio_codec_torch.models.mlp_mixer import (
    QUERY_INIT_STD,
    ConditionalMLPMixerFlow,
)
from meanflow_audio_codec_torch.models.simple_conv_flow import SimpleConvFlow
from meanflow_audio_codec_torch.ops.losses import attach_learned_weighting

PRECISION_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "mixed": torch.bfloat16,  # bf16 compute, f32 params
}


def compute_dtype_for(config: CodecConfig) -> torch.dtype:
    """The compute dtype of the config's precision policy."""
    return PRECISION_DTYPES[config.precision]


def init_weights(model: nn.Module, generator: torch.Generator | None = None
                 ) -> nn.Module:
    """Flax's default init: kernels truncated-normal (+-2 sd) with variance
    1/fan_in, biases zero; the mixer's query tokens and learned conditions
    (each module's ``normal_init``) normal with sd 0.02. GRN and layer-scale
    keep their constructor values."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (Dense, Conv2d)):
                fan_in = module.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            for name in getattr(module, "normal_init", ()):
                nn.init.normal_(getattr(module, name), std=QUERY_INIT_STD,
                                generator=generator)
    return model


def create_mlp_flow(noise_dimension: int, latent_dimension: int,
                    num_blocks: int, condition_dimension: int,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> ConditionalFlow:
    return ConditionalFlow(noise_dimension, condition_dimension, num_blocks,
                           latent_dimension, compute_dtype=compute_dtype)


def create_conv_flow(noise_dimension: int, latent_dimension: int,
                     num_blocks: int, condition_dimension: int,
                     image_size: int = 28,
                     compute_dtype: torch.dtype = torch.float32,
                     **options) -> ConditionalConvFlow:
    """``options`` go to :class:`ConditionalConvFlow`, which keeps
    ``image_size`` and reads it nowhere, as the JAX model."""
    return ConditionalConvFlow(noise_dimension, condition_dimension,
                               num_blocks, latent_dimension,
                               image_size=image_size,
                               compute_dtype=compute_dtype, **options)


def create_mlp_mixer_flow(noise_dimension: int, latent_dimension: int,
                          num_blocks: int, condition_dimension: int,
                          compute_dtype: torch.dtype = torch.float32,
                          **options) -> ConditionalMLPMixerFlow:
    """``options``: ``token_mix_dim``, ``channel_mix_dim``, ``num_channels``,
    ``num_latent_tokens``, ``stage_tokens``, ``factorized_stages``,
    ``encoder_context_tokens``."""
    return ConditionalMLPMixerFlow(noise_dimension, condition_dimension,
                                   num_blocks, latent_dimension,
                                   compute_dtype=compute_dtype, **options)


def create_simple_conv_flow(noise_dimension: int, latent_dimension: int,
                            num_blocks: int, condition_dimension: int,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> SimpleConvFlow:
    return SimpleConvFlow(noise_dimension, condition_dimension, num_blocks,
                          latent_dimension, compute_dtype=compute_dtype)


_BUILDERS = {
    "mlp": create_mlp_flow,
    "convnet": create_conv_flow,
    "mlp_mixer": create_mlp_mixer_flow,
    "simple_conv": create_simple_conv_flow,
}


def create_flow_model(config: CodecConfig,
                      generator: torch.Generator | None = None,
                      compute_dtype: torch.dtype | None = None) -> nn.Module:
    """Build the flow model the config names, computing in
    ``compute_dtype`` (by default the dtype of its ``precision``), with
    weights drawn from ``generator`` (CPU); move it to the device
    afterwards. With ``loss_weighting: "learned"`` the model also
    holds the weighting's polynomial, which the JAX trainer and
    ``load_flow_state`` merge into the param tree."""
    architecture = config.architecture or "mlp"
    builder = _BUILDERS.get(architecture)
    if builder is None:
        raise ValueError(
            f"Unknown architecture: {architecture}. "
            "Must be one of: 'mlp', 'convnet', 'mlp_mixer', 'simple_conv'")
    model = builder(noise_dimension=config.noise_dimension,
                    latent_dimension=config.latent_dimension,
                    num_blocks=config.num_blocks,
                    condition_dimension=config.condition_dimension,
                    compute_dtype=compute_dtype or compute_dtype_for(config),
                    **config.architecture_options)
    if (config.loss_weighting or "uniform") == "learned":
        attach_learned_weighting(model)
    return init_weights(model, generator)
