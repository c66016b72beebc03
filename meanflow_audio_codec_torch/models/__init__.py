"""The port's flow model families: ConvNeXt, MLP, MLP-Mixer, simple conv;
counterpart of ``meanflow_audio_codec_tpu/models``, whose names this
package exports (``TrainState`` is the port's, ``training/optim.py``)."""

from meanflow_audio_codec_torch.models.blocks import (
    MLP,
    ConditionalResidualBlock,
    ConvNeXtBlock,
    FiLM,
    GlobalResponseNormalization,
    MixerBlock,
)
from meanflow_audio_codec_torch.models.conv_flow import (
    ConditionalConvFlow,
    ConvEncoder,
    ConvStage,
)
from meanflow_audio_codec_torch.models.factories import (
    compute_dtype_for,
    create_conv_flow,
    create_flow_model,
    create_mlp_flow,
    create_mlp_mixer_flow,
    create_simple_conv_flow,
)
from meanflow_audio_codec_torch.models.mlp_flow import (
    ConditionalFlow,
    MLPEncoder,
)
from meanflow_audio_codec_torch.models.mlp_mixer import (
    ConditionalMLPMixerFlow,
    MLPMixerAutoencoder,
    MLPMixerDecoder,
    MLPMixerEncoder,
    MixerStage,
)
from meanflow_audio_codec_torch.models.simple_conv_flow import (
    SimpleConvBlock,
    SimpleConvFlow,
)
from meanflow_audio_codec_torch.training.optim import TrainState

__all__ = [
    "MLP",
    "ConditionalResidualBlock",
    "ConvNeXtBlock",
    "FiLM",
    "GlobalResponseNormalization",
    "MixerBlock",
    "ConditionalConvFlow",
    "ConvEncoder",
    "ConvStage",
    "compute_dtype_for",
    "create_conv_flow",
    "create_flow_model",
    "create_mlp_flow",
    "create_mlp_mixer_flow",
    "create_simple_conv_flow",
    "ConditionalFlow",
    "MLPEncoder",
    "ConditionalMLPMixerFlow",
    "MLPMixerAutoencoder",
    "MLPMixerDecoder",
    "MLPMixerEncoder",
    "MixerStage",
    "SimpleConvBlock",
    "SimpleConvFlow",
    "TrainState",
]
