"""mdct_roofline.serve: the MDCT kernel's least time over its traced time,
at a call's [clips x channels, samples] signal."""

from portbench import readers


def read(run):
    w = run.window
    if "calls" not in w:
        return None
    return readers.kernel_roofline_pct(
        run, "mdct_kernel", readers.mdct_bound(run, 2 * w["clips"], w["samples"]))
