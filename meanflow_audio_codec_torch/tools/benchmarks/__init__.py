"""Timing tools, one script per question, each ``python -m
meanflow_audio_codec_torch.tools.benchmarks.<name>`` on the card unless
``--device cpu`` is given; each prints the card's name and power limit,
then one JSON row per configuration. The codec and train geometries
(``benchmark_codec_geometry``, ``benchmark_conv_mfu``,
``benchmark_streaming``), the MDCT (``benchmark_mdct``), samplers and
objectives (``benchmark_sampler``, ``benchmark_train_objectives``,
``benchmark_meanflow_vs_improved``) and the host-side data path
(``benchmark_audio_decoders``, ``benchmark_audio_loader``,
``benchmark_pipeline_stages``, ``benchmark_prefetch``,
``benchmark_vs_torch``)."""
