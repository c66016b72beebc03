"""device_idle_pct.train: share of the traced window with nothing running
on the card."""

from portbench import readers


def read(run):
    return readers.idle_pct(run) if "steps" in run.window else None
