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
  ops       — MDCT/IMDCT (direct and FFT plain versions, CUDA kernel
              wrappers), the MDCT and reshape tokenizers, time
              embeddings, samplers, the latent quantizers and MACB
              bitstream, the rANS coder's binding
  models    — the ConvNeXt, MLP, MLP-Mixer and simple-conv flows
  training  — the token adapter, the objectives, optimiser, train steps
              and the trainer (``python -m meanflow_audio_codec_torch.train``)
  data      — synthetic and file audio, the loaders, MNIST and the device
              replay pool
  tools     — the codec CLI, ``make_corpus`` and ``matrix_smoke``

``codec.AudioCodec`` serves a trained run (``from_workdir``, the byte API);
``streaming`` runs it on chunked audio.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "AudioCodec":
        from meanflow_audio_codec_torch.codec import AudioCodec
        return AudioCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
