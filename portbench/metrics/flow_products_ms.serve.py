"""flow_products_ms.serve: device milliseconds a call inside the program's
``product`` spans under ``codec.flow`` (every Dense and Conv2d of the
decoder with its operand casts, padding and bias), over the profiled
half's decode calls."""

from portbench import program_spans


def read(run):
    return program_spans.per_decode_ms(run, "product")
