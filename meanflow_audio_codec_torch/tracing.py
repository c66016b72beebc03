"""Spans at the port's layer boundaries, kept in memory.

Off by default. Every site tests one module flag, ``ON``: off, ``span``
hands back one shared no-op context, so a site allocates nothing and
records no event. The store records while :func:`on` holds it
(``TraceCapture``, ``ProfilingTrainer``) or while ``torch.profiler``
records: a root span, opened where a train chunk, a codec call or a pool
call begins, looks at both and sets ``ON`` for the sites under it, and
bounds how deep below it spans record.

A span holds its name, its id, its parent's id (the span open on the same
thread when it began: one opened on another thread, such as autograd's
device thread recomputing under ``remat``, has none), a request id (a
root's number among the roots of its name since the store came on, a
train step's index in its chunk; children take their parent's), the
native thread id, ``time.time_ns()`` stamps (the clock ``torch.profiler``
stamps its events with) and counts such as ``rows``. A device span also
records a ``torch.cuda.Event`` on the current stream at entry and exit;
the pair is read in :func:`collect`, so the hot path never waits for the
card. On the CPU, where operations run synchronously, a device span's
device time is its host time.

    tracing.on()
    state, series = chunk(state, batches, generator)
    spans = tracing.collect()  # [Span]; device_ms, self_ms
    tracing.off()
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch

#: whether the sites record; set by :func:`on`, :func:`off` and each root
ON = False

_holders = 0  # on() calls not yet matched by off()
_cuda = False  # device spans record CUDA events (the last root's device)
_depth = None  # levels below the last root that record (None: all)
_root_thread = None  # the last root's thread: alone records under a depth
_ids = itertools.count(1)
_calls: Counter = Counter()  # roots opened per name since the store came on
_local = threading.local()  # per thread: the stack of open spans, the id
_done: list = []  # finished spans, not yet collected
_free: list = []  # CUDA events for reuse
_kept: list[list] = []  # lists that every collect() also fills


@dataclass
class Span:
    """A finished span. ``device_ms`` is None for a host span; ``self_ms``
    is ``device_ms`` less its children's."""

    name: str
    id: int
    parent: int | None
    request: int | None
    thread: int
    start_ns: int
    end_ns: int
    counts: dict = field(default_factory=dict)
    device_ms: float | None = None
    self_ms: float | None = None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.thread = threading.get_native_id()
        _local.stack = []
        return _local.stack


def _event() -> torch.cuda.Event:
    try:
        return _free.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Open:
    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns",
                 "end_ns", "counts", "device", "events", "stream")

    def __init__(self, name: str, request: int | None, device: bool):
        self.name, self.request, self.device = name, request, device
        self.counts = None
        self.events = (_event(), _event()) if device and _cuda else None

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        if self.request is None and top:
            self.request = top.request
        self.id = next(_ids)
        self.thread = _local.thread
        stack.append(self)
        # the stream of the outermost span of the thread, read once
        self.stream = top.stream if top else None
        self.start_ns = time.time_ns()
        if self.events:
            if self.stream is None:
                self.stream = torch.cuda.current_stream()
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events:
            self.events[1].record(self.stream)
        self.end_ns = time.time_ns()
        _local.stack.pop()
        _done.append(self)
        return False


def _profiling() -> bool:
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def _set(on_now: bool) -> None:
    global ON, _depth
    if on_now and not ON:
        _calls.clear()
        _depth = None
    ON = on_now


def span(name: str, request: int | None = None):
    """A device span around a ``with`` block (the shared no-op when off, or
    deeper below the last root than it records)."""
    if not ON:
        return _OFF
    if _depth is not None and (len(_stack()) > _depth
                               or _local.thread != _root_thread):
        return _OFF
    return _Open(name, request, True)


def root(name: str, device: torch.device | None = None,
         depth: int | None = None):
    """A span that begins a unit of work, numbered among the roots of its
    name; first decides whether the store records. With ``device`` it is a
    device span, and the spans under it time that device; without, a host
    span. ``depth`` bounds the levels below it that record, on its thread
    alone (a train chunk records its steps and their phases, not the
    model's products nor autograd's recomputation)."""
    global _cuda, _depth, _root_thread
    _set(_holders > 0 or _profiling())
    if not ON:
        return _OFF
    if device is not None:
        _cuda = device.type == "cuda"
    _depth = depth
    _stack()
    _root_thread = _local.thread
    request = _calls[name]
    _calls[name] += 1
    return _Open(name, request, device is not None)


def count(name: str, value: int) -> None:
    """Add ``value`` to the count ``name`` of the innermost open span of
    this thread."""
    if ON:
        stack = _stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + int(value)


def rows(tensor: torch.Tensor, leading: int = 1) -> None:
    """Count the rows of ``tensor`` (the product of its first ``leading``
    sizes) on the innermost open span of this thread."""
    if ON:
        n = 1
        for size in tensor.shape[:leading]:
            n *= size
        count("rows", n)


def on(kept: list | None = None) -> None:
    """Record until the matching :func:`off`; ``kept``, while it is on,
    also receives every span :func:`collect` hands out."""
    global _holders
    _holders += 1
    if kept is not None:
        _kept.append(kept)
    _set(True)


def off(kept: list | None = None) -> None:
    """Undo one :func:`on` (and its ``kept``)."""
    global _holders
    _holders = max(_holders - 1, 0)
    if kept is not None:
        _kept.remove(kept)
    _set(_holders > 0 or _profiling())


def collect() -> list[Span]:
    """The spans finished since the last call, in the order they opened,
    with their device times resolved (a synchronize when they hold CUDA
    events); the store forgets them."""
    global _done
    done, _done = _done, []
    if any(s.events for s in done):
        torch.cuda.synchronize()
    spans = []
    for s in done:
        device_ms = None
        if s.events:
            device_ms = s.events[0].elapsed_time(s.events[1])
            _free.extend(s.events)
        elif s.device:
            device_ms = (s.end_ns - s.start_ns) / 1e6
        spans.append(Span(s.name, s.id, s.parent, s.request, s.thread,
                          s.start_ns, s.end_ns, s.counts or {}, device_ms))
    spans.sort(key=lambda s: s.id)
    children = defaultdict(float)
    for s in spans:
        if s.parent is not None and s.device_ms is not None:
            children[s.parent] += s.device_ms
    for s in spans:
        if s.device_ms is not None:
            s.self_ms = s.device_ms - children[s.id]
    for kept in _kept:
        kept.extend(spans)
    _set(_holders > 0 or _profiling())
    return spans
