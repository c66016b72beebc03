"""Mesh and sharding layer on ``torch.distributed``; counterpart of
``meanflow_audio_codec_tpu/parallel/``."""

from meanflow_audio_codec_torch.parallel.distributed import (
    global_batch_slice,
    initialize_distributed,
)
from meanflow_audio_codec_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    create_mesh,
    mesh_from_config,
    param_partition_spec,
    replicated,
    shard_state,
    state_shardings,
)
from meanflow_audio_codec_torch.parallel.sharded_state import (
    ShardedTrainState,
)
