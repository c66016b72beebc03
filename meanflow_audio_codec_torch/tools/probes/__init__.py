"""Probes of the W8A8 int8 path on the card: ``probe_int8`` (an 8192^2
product chain), ``probe_int8_conv`` (a 3x3 conv at the codec's grid),
``probe_stage_q`` (one decoder stage), ``probe_codec_ab`` (the codec bf16
against int8, alternating) and ``probe_hlo`` (the kernels one quantized
codec call launches). Each runs through ``main(argv)``, on the card unless
``--device cpu`` is given."""
