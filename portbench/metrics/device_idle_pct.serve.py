"""device_idle_pct.serve: share of the traced window with nothing running
on the card."""

from portbench import readers


def read(run):
    return readers.idle_pct(run) if "calls" in run.window else None
