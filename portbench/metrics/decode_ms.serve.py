"""decode_ms.serve: median milliseconds of a call's 1-NFE decode
(AudioCodec.decode), a span ending in a synchronize."""

from portbench import readers


def read(run):
    return readers.span_ms_median(run, "decode") if "calls" in run.window else None
