"""Transforms, tokenizers, embeddings, losses, schedules, time sampling,
the latent quantizers and the fused stage ops of the port, with the CUDA
kernel wrappers; counterpart of ``meanflow_audio_codec_tpu/ops``, whose
names this package exports. Importing it builds and loads no kernel: the
wrappers build theirs at their first launch.

As in the JAX package, ``ops.mdct`` is the function: the module is
``importlib.import_module("meanflow_audio_codec_torch.ops.mdct")``, or
``from meanflow_audio_codec_torch.ops.mdct import ...``.
"""

from meanflow_audio_codec_torch.ops.embeddings import (
    dual_time_embedding,
    sinusoidal_embedding,
)
from meanflow_audio_codec_torch.ops.latent_quant import (
    LatentBitstream,
    bitstream_kbps,
    dequantize_latents,
    pack_bitstream,
    quantize_latents,
    unpack_bitstream,
)
from meanflow_audio_codec_torch.ops.losses import (
    adaptive_weighted_loss,
    ema,
    mse_loss,
    normalized_mse_loss,
    weighted_l2_loss,
)
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    imdct,
    imdct_direct,
    imdct_fft,
    mdct,
    mdct_direct,
    mdct_fft,
    num_frames_for_length,
    output_length,
    sine_window,
)
from meanflow_audio_codec_torch.ops.mdct_layers import IMDCTLayer, MDCTLayer
from meanflow_audio_codec_torch.ops.schedules import (
    LinearNoiseSchedule,
    UniformNoiseSchedule,
    create_noise_schedule,
)
from meanflow_audio_codec_torch.ops.stage import (
    fused_gelu_grn,
    fused_ln_film,
    fused_ln_norm,
    stage_fusable,
)
from meanflow_audio_codec_torch.ops.time_sampling import (
    LogitNormalTimeSampling,
    MeanFlowTimeSampling,
    UniformTimeSampling,
    create_time_sampling,
    logit_normal,
    sample_tr,
)
from meanflow_audio_codec_torch.ops.tokenize import (
    Compose,
    MDCTTokenization,
    PreprocessingPipeline,
    ReshapeTokenization,
    TokenizationStrategy,
    compute_token_shape,
    compute_tokenized_dimension,
    create_mdct_pipeline,
    create_reshape_pipeline,
    create_tokenization_strategy,
    patchify_image,
    unpatchify_image,
)
