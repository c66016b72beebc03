"""mfu.serve: the reference FLOPs of the window's codec calls (encode plus
one decoder call a row) over its time, as a share of the bf16 peak."""

from portbench import readers, work


def read(run):
    w = run.window
    if "calls" not in w:
        return None
    s = w["sizes"]
    return readers.mfu_pct(run, work.codec_call_flops(s.family, s.geo, w["rows"]))
