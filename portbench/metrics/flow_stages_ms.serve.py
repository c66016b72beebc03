"""flow_stages_ms.serve: device milliseconds a call of the program's
``flow.forward`` spans under ``codec.flow`` less their ``product``
children (the norms, FiLM, GELU, GRN, layer scales and residuals between
the products), over the profiled half's decode calls."""

from portbench import program_spans


def read(run):
    return program_spans.per_decode_ms(run, "flow.forward", self_time=True)
