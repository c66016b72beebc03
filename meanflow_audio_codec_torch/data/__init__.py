"""Training data: audio sources and loaders, MNIST, the device replay pool;
counterpart of ``meanflow_audio_codec_tpu/data``, whose names this package
exports. Importing it builds no native loader: that is built at its first
use."""

from meanflow_audio_codec_torch.data.audio import (
    DEFAULT_FRAME_SIZE,
    TARGET_SAMPLE_RATE,
    audio_to_frames,
    batch,
    buffer_shuffle,
    build_audio_pipeline,
    glob_audio_files,
    load_audio_file,
    load_audio_files,
    prefetch_batches,
    replay_pool_batches,
    synthetic_audio_pipeline,
    write_wav,
)
from meanflow_audio_codec_torch.data.mnist import (
    load_mnist,
    load_mnist_arrays,
    synthetic_mnist,
)
