"""mdct_roofline.train: the MDCT kernel's least time over its traced time,
at the train step's [batch x channels, frame_size] signal."""

from portbench import readers


def read(run):
    s = run.window.get("sizes")
    if s is None or "steps" not in run.window:
        return None
    return readers.kernel_roofline_pct(
        run, "mdct_kernel", readers.mdct_bound(run, 2 * s.batch, s.frame_size))
