"""Training: the token adapter, the objectives, the optimiser and train
state, the train steps and chunk, and the trainer with its checkpoints,
logging and profiling; counterpart of ``meanflow_audio_codec_tpu/training``,
whose names this package exports.

As in the JAX package, ``training.train_step`` is the function: the module
is ``from meanflow_audio_codec_torch.training.train_step import ...``."""

from meanflow_audio_codec_torch.training.objectives import (
    AutoencoderObjective,
    FlowMatchingLoss,
    FlowMatchingObjective,
    ImprovedMeanFlowLoss,
    ImprovedMeanFlowObjective,
    LossStrategy,
    MeanFlowLoss,
    MeanFlowObjective,
    Objective,
    create_loss_strategy,
)
from meanflow_audio_codec_torch.training.train_step import (
    make_eval_step,
    make_train_step,
    train_step,
)
