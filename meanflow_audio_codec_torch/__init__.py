"""meanflow_audio_codec_torch — the MeanFlow audio codec in PyTorch for NVIDIA Hopper.

A port of ``meanflow_audio_codec_tpu`` (the JAX package, which stays the
reference). Module names mirror the JAX package so each counterpart is easy
to find. The port imports ``torch`` and ``numpy`` only: no JAX, Flax or
Optax, and nothing from the JAX package.

Entry points run on CUDA unless the caller passes ``device="cpu"``. On the
card the MDCT and IMDCT go through hand-written CUDA kernels
(``csrc/*.cu``); on the CPU the same functions run their plain PyTorch
versions.

Subpackages:
  ops       — MDCT/IMDCT (plain versions and CUDA kernel wrappers),
              tokenizer, time embeddings, dual-time sampler, the latent
              quantizers and MACB bitstream, the rANS coder's binding
  models    — ConvNeXt conditional flow and its encoder
  training  — the token adapter, iMF objective, optimiser, train steps and
              the trainer (``python -m meanflow_audio_codec_torch.train``)
  data      — synthetic audio sources, WAV input and the device replay pool
  tools     — the codec CLI (``python -m
              meanflow_audio_codec_torch.tools.codec_cli``)

``codec.AudioCodec`` serves a trained run (``from_workdir``, the byte API);
``streaming`` runs it on chunked audio.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "AudioCodec":
        from meanflow_audio_codec_torch.codec import AudioCodec
        return AudioCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
