"""encode_ms.serve: median milliseconds of a call's encode
(AudioCodec.encode_with_gains), a span ending in a synchronize."""

from portbench import readers


def read(run):
    return readers.span_ms_median(run, "encode")
