"""mfu.train: the reference FLOPs of the window's training steps over its
time, as a share of the bf16 peak (work.train_step_flops)."""

from portbench import readers, work


def read(run):
    w = run.window
    if "steps" not in w:
        return None
    s, rows = w["sizes"], w["rows"] // w["steps"]
    return readers.mfu_pct(run, w["steps"] * work.train_step_flops(s.family, s.geo, rows))
