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
              wrappers with their gradients, the MDCT layers), the MDCT
              and reshape tokenizers, time embeddings, samplers, the
              latent quantizers and MACB bitstream, the rANS coder's
              binding, the W8A8 int8 products of quantized serving
  models    — the ConvNeXt, MLP, MLP-Mixer and simple-conv flows
  configs   — the v2 JSON config (``CodecConfig``, also the sectioned
              ``TrainFlowConfig``), validation, migration, merge and diff
  training  — the token adapter, the objectives, optimiser, train steps,
              the trainer (``python -m meanflow_audio_codec_torch.train``)
              and the minimal ``simple_trainer``
  data      — synthetic and file audio, the loaders, MNIST and the device
              replay pool
  tools     — the codec CLI, ``make_corpus`` and ``matrix_smoke``

``codec.AudioCodec`` serves a trained run (``from_workdir``, the byte API,
``quantized=True`` for the int8 decoder);
``streaming`` runs it on chunked audio. ``AudioCodec``, ``StreamingCodec``,
``StreamingEncoder`` and ``StreamingDecoder`` are also the package's own
names, imported at first use. The subpackages export the JAX package's
names (``ops``, ``models``, ``training``, ``data``, ``evaluators``,
``parallel``; its ``configs`` package's are ``configs.py``'s).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as in the JAX package: a bare package import stays light
    if name == "AudioCodec":
        from meanflow_audio_codec_torch.codec import AudioCodec
        return AudioCodec
    if name in ("StreamingCodec", "StreamingEncoder", "StreamingDecoder"):
        from meanflow_audio_codec_torch import streaming
        return getattr(streaming, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
