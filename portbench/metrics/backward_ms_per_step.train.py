"""backward_ms_per_step.train: device milliseconds a step inside the
program's ``step.backward`` spans (``torch.autograd.grad``, with the remat
recompute), over the profiled half's steps."""

from portbench import program_spans


def read(run):
    return program_spans.per_step_ms(run, "step.backward")
