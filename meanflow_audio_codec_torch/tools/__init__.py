"""Command-line tools: ``codec_cli`` (WAV <-> .macb bitstream)."""
