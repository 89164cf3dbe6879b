"""The program's span and counter recorder, and the profiler helpers on it.

``span(name)`` marks one layer of the work (``search``,
``search.plan``, ``engine.probe``, ...); ``count(name, n)`` adds a host
integer; ``count_device(name, tensor)`` adds ``tensor.sum()`` into a small
tensor on the tensor's own device, without a synchronize. Recording is off
until ``enable()``; ``drain()`` returns what was recorded and clears it.

Off, ``span`` tests two module flags (the recorder's and torch.profiler's)
and returns a shared no-op; the counters test one. Under a running
``torch.profiler`` a span opens a ``record_function`` of its name, so the
spans of the profiling thread appear in its trace whether or not the
recorder is on. On, a span also records its name, its start and end on
``time.perf_counter_ns()``, its thread, its id, its parent's id and the id
of its call: the outermost span of its thread, or the call of the thread
that handed the work over through ``bind``. Each thread records into its
own buffer, so searches on separate threads keep separate trees.

``enable()`` reads ``perf_counter_ns`` and ``time_ns`` once, which maps the
recorder's times onto a Chrome trace's clock (``trace_us``): a torch
profiler trace's ``ts`` is ``(time_ns() - baseTimeNanoseconds) / 1e3``.
Spans on threads the profiler does not follow (the host gather's worker)
reach the device's timeline that way.

``trace(log_dir)`` profiles the enclosed region with the recorder on and
writes one Chrome trace: the profiler's events and the program's spans of
every other thread. ``annotate`` is ``span``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _prof  # its _is_profiler_enabled flag
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = [
    "span",
    "annotate",
    "count",
    "count_device",
    "bind",
    "enable",
    "disable",
    "enabled",
    "drain",
    "trace_us",
    "trace",
]

_ON = False  # the recorder's flag
_ids = itertools.count(1)
_lock = threading.Lock()
_buffers: list["_Buffer"] = []  # every thread's buffer, for drain()
_device_counts: dict[tuple[str, str], torch.Tensor] = {}
_clock: tuple[int, int] = (0, 0)  # (perf_counter_ns, time_ns) read at enable()
_local = threading.local()


class _Buffer:
    """One thread's recording: finished spans, host counters, the open
    spans' stack and the call handed over by ``bind``."""

    def __init__(self) -> None:
        self.thread = threading.get_ident()
        self.spans: list[tuple] = []
        self.counts: dict[str, int] = {}
        self.stack: list[tuple[int, int]] = []  # (span id, call id)
        self.inherited: tuple[int, int] | None = None


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _lock:
            _buffers.append(buf)
    return buf


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "buf", "sid", "parent", "call", "t0", "rf")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        buf = self.buf = _buffer()
        outer = buf.stack[-1] if buf.stack else buf.inherited
        self.sid = next(_ids)
        self.parent, self.call = outer if outer is not None else (0, self.sid)
        buf.stack.append((self.sid, self.call))
        self.rf = None
        if _prof._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        buf = self.buf
        buf.stack.pop()
        buf.spans.append((self.name, self.t0, t1, buf.thread, self.sid, self.parent, self.call))
        return False


def span(name: str):
    """Context manager marking a layer of the work (see the module doc)."""
    if _ON:
        return _Span(name)
    if _prof._is_profiler_enabled:
        return record_function(name)
    return _NOOP


annotate = span


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name``."""
    if _ON:
        counts = _buffer().counts
        counts[name] = counts.get(name, 0) + int(n)


def count_device(name: str, tensor: torch.Tensor) -> None:
    """Add ``tensor.sum()`` to counter ``name`` on the tensor's device,
    without a synchronize: read back only by ``drain()``."""
    if not _ON:
        return
    key = (name, str(tensor.device))
    with torch.inference_mode():
        acc = _device_counts.get(key)
        if acc is None:
            with _lock:
                acc = _device_counts.setdefault(
                    key, torch.zeros((), dtype=torch.int64, device=tensor.device)
                )
        acc.add_(tensor.sum(dtype=torch.int64))


def bind(fn):
    """``fn`` to run on another thread as part of the calling thread's open
    span: its spans join that span's call. ``fn`` itself when off."""
    if not _ON:
        return fn
    buf = _buffer()
    outer = buf.stack[-1] if buf.stack else buf.inherited

    def bound(*args, **kwargs):
        mine = _buffer()
        saved, mine.inherited = mine.inherited, outer
        try:
            return fn(*args, **kwargs)
        finally:
            mine.inherited = saved

    return bound


def enable() -> None:
    """Start recording (spans and counters); reads the clock pair that
    ``trace_us`` maps with."""
    global _ON, _clock
    _clock = (time.perf_counter_ns(), time.time_ns())
    _ON = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain()``."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def drain(clear: bool = True) -> dict:
    """What was recorded since the last drain, and clear it (call it while
    no traced work runs).

    ``spans``: dicts of name, start_ns and end_ns (``perf_counter_ns``),
    thread, id, parent (0 at a call's root) and call, in start
    order. ``counters``: host and device counters summed by name (reading
    the device ones synchronizes their devices). ``clock``: the
    (perf_counter_ns, time_ns) pair read at ``enable()``.
    """
    spans: list[tuple] = []
    counters: dict[str, int] = {}
    with _lock:
        buffers = list(_buffers)
        devs = list(_device_counts.items())
        if clear:
            _device_counts.clear()
            live = {t.ident for t in threading.enumerate()}
            _buffers[:] = [b for b in _buffers if b.thread in live]
    for buf in buffers:
        got, counts = buf.spans, buf.counts
        if clear:
            buf.spans, buf.counts = [], {}
        spans.extend(got)
        for k, v in counts.items():
            counters[k] = counters.get(k, 0) + v
    for (name, _), acc in devs:
        counters[name] = counters.get(name, 0) + int(acc.item())
    keys = ("name", "start_ns", "end_ns", "thread", "id", "parent", "call")
    return {
        "spans": [dict(zip(keys, s)) for s in sorted(spans, key=lambda s: s[1])],
        "counters": counters,
        "clock": _clock,
    }


def trace_us(t_ns: int, base_time_ns: int, clock: tuple[int, int] | None = None) -> float:
    """A recorder time (``perf_counter_ns``) on the clock of a Chrome trace
    whose ``baseTimeNanoseconds`` is ``base_time_ns``, in microseconds."""
    p0, w0 = _clock if clock is None else clock
    return (t_ns - p0 + w0 - base_time_ns) / 1e3


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region with the recorder on; write
    ``trace_<ns>.json`` into log_dir.

    Yields the ``torch.profiler.profile`` object, whose ``key_averages()``
    give the time by operator and kernel. The program's spans of threads
    other than this one, which the profiler does not follow, are added to
    the file (category ``program_span``) on its clock. A recorder that was
    already on stays on and keeps what it recorded.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _ON
    if not was_on:
        enable()
    me, t_start = threading.get_ident(), time.perf_counter_ns()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        rec = drain(clear=not was_on)
        if not was_on:
            disable()
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {
            "ph": "X",
            "cat": "program_span",
            "name": s["name"],
            "pid": pid,
            "tid": s["thread"],
            "ts": trace_us(s["start_ns"], base, rec["clock"]),
            "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
            "args": {"id": s["id"], "parent": s["parent"], "call": s["call"]},
        }
        for s in rec["spans"]
        if s["thread"] != me and s["start_ns"] >= t_start
    )
    with open(path, "w") as f:
        json.dump(doc, f)
