"""update_ms_per_step.train: device milliseconds a step inside the
program's ``step.update`` spans (the gradient's global norm, clip, AdamW,
EMA, the non-finite guard and the commit), over the profiled half's
steps."""

from portbench import program_spans


def read(run):
    return program_spans.per_step_ms(run, "step.update")
