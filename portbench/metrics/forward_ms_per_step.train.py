"""forward_ms_per_step.train: device milliseconds a step inside the
program's ``step.forward`` spans (the encoder, the boundary, dual and
primal forwards and the loss), over the profiled half's steps."""

from portbench import program_spans


def read(run):
    return program_spans.per_step_ms(run, "step.forward")
