"""pool_ms_per_step.train: host milliseconds a step inside the spans around
DeviceReplayPool.sample and refresh."""

from portbench import readers


def read(run):
    steps = run.window.get("steps")
    within = readers.untraced(run) if steps else None
    spent = (run.spans.seconds("sample", within)
             + run.spans.seconds("refresh", within)) if steps else []
    if not steps or not spent:
        return None
    return 1000.0 * sum(spent) / steps
