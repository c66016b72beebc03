"""The program's own spans (``meanflow_audio_codec_torch.tracing``) in a
traced run, for the per-layer readers.

The program's span store records while ``torch.profiler`` records, so a
traced run's second half, which ``harness.execute`` measures under the
profiler, holds spans, and its first half and the untraced runs none. The
store is read where the program loaded it (``sys.modules``): this module
imports nothing of the program, and a program without a store leaves the
readers nothing to read.

Each span carries its name, id, parent's id, thread, ``time.time_ns()``
stamps, counts and, for a device span, ``device_ms`` (CUDA events on the
card's stream) and ``self_ms`` (less its children's).
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter, defaultdict

from portbench import tracing

STORE = "meanflow_audio_codec_torch.tracing"


def spans(run) -> list | None:
    """The program's spans of the run's profiled half, collected from the
    store once a run (kept as ``run.program_spans``); None without a
    profiled half or a store."""
    if "program_spans" not in vars(run):
        store = sys.modules.get(STORE)
        found = None
        if store is not None and run.device_trace is not None:
            found = store.collect()
        run.program_spans = found
    return run.program_spans


def named(found: list, name: str) -> list:
    return [s for s in found if s.name == name]


def under(found: list, ancestor: str) -> set[int]:
    """Ids of the spans with a span called ``ancestor`` above them (a
    parent's id is lower than its children's)."""
    inside = set()
    for s in sorted(found, key=lambda s: s.id):
        if s.name == ancestor or s.parent in inside:
            inside.add(s.id)
    return inside


def per_step_ms(run, name: str) -> float | None:
    """Device ms of the ``name`` spans over the profiled half's steps."""
    found = spans(run) if "steps" in run.window else None
    steps = len(named(found, "step")) if found else 0
    parts = named(found, name) if steps else []
    if not parts:
        return None
    return sum(s.device_ms for s in parts) / steps


def per_decode_ms(run, name: str, self_time: bool = False) -> float | None:
    """Device ms (or self ms) of the ``name`` spans under ``codec.flow``
    over the profiled half's decode calls."""
    found = spans(run) if "calls" in run.window else None
    calls = len(named(found, "codec.decode")) if found else 0
    if not calls:
        return None
    inside = under(found, "codec.flow")
    parts = [s for s in named(found, name) if s.parent in inside]
    if not parts:
        return None
    return sum(s.self_ms if self_time else s.device_ms for s in parts) / calls


def idle_gaps_by_program_span(trace: tracing.DeviceTrace, found: list) -> list:
    """The profiled half's idle seconds by the innermost program span open
    at each gap's middle on the launching thread (the thread most spans
    ran on; ``host`` where none was open), longest first."""
    thread = Counter(s.thread for s in found).most_common(1)[0][0] if found else None
    mine = sorted((s for s in found if s.thread == thread), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in mine]
    idle = defaultdict(float)
    for a, b in tracing.idle_gaps(trace):
        mid, label = (a + b) // 2, "host"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if mine[i].end_ns >= mid:
                label = mine[i].name
                break
        idle[label] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]
