"""Command-line tools: ``codec_cli``, ``make_corpus``, ``matrix_smoke``."""
