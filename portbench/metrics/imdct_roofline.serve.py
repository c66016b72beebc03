"""imdct_roofline.serve: the inverse MDCT kernel's least time over its
traced time, at a call's [clips x channels, frames, W] coefficients."""

from portbench import readers


def read(run):
    w = run.window
    if "calls" not in w:
        return None
    frames = w["sizes"].frames(w["samples"])
    return readers.kernel_roofline_pct(
        run, "imdct_kernel", readers.imdct_bound(run, 2 * w["clips"], frames))
