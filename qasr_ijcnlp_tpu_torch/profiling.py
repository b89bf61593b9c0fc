"""Spans, counters and traces of the port's layers.

* :func:`span` — a named region at a layer boundary (the frontend, a
  request, the encoder, the prompt pass, the token loop, a training step's
  phases).  While recording it enters ``record_function`` (the region shows
  on a ``torch.profiler`` timeline as a ``user_annotation``) and, on the
  card, an NVTX range, and appends to the recorder: its name, start and end
  in ns, the id of its parent span and of its root span (the root's id is
  the request id).  The parent chain is kept per thread, so the spans of an
  engine's worker thread never hang under the caller's;
* :func:`count` — adds to a named counter in the same recorder;
* :func:`recording` — clears the recorder, turns recording on for the
  enclosed region and yields the recorder (``spans``, ``counters``,
  ``summary()``);
* :func:`trace` — a ``torch.profiler`` capture of a region (CPU and, where
  torch sees a card, CUDA activities) under :func:`recording`, written into
  ``log_dir`` as a Chrome trace (``chrome://tracing`` or Perfetto load it)
  and beside it the recorder with the device work laid under each span
  (:func:`attribute`).

Recording is on inside :func:`recording` and while a ``torch.profiler``
profile runs, so any profile of the port carries its spans, and the
recorder holds them until the next :func:`recording` clears it.  Off, a
span is one shared null context: it reads no clock, enters no
``record_function`` or NVTX range and allocates nothing; nor does a span
inside code that ``torch.export`` or ``torch.compile`` traces.

Spans are stamped with ``time.time_ns()``, the clock of the profiler's
Chrome trace: an event's ``ts`` (µs) plus the trace's
``baseTimeNanoseconds`` / 1000 is a ``time.time_ns()`` / 1000 reading.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

# Chrome trace categories: device work, and the host calls that launch it
# (their ``correlation`` id is the device op's)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int


class Recorder:
    """The spans and counters of one recording."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.counters = {}

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``calls``, ``total_ms`` and ``self_ms`` on the
        host (self: less the part its child spans cover), ``mean_ms``."""
        child = _child_ns(self.spans)
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            d = s.end_ns - s.start_ns
            o = out.setdefault(s.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
            o["calls"] += 1
            o["total_ms"] += d / 1e6
            o["self_ms"] += (d - child[s.id]) / 1e6
        for o in out.values():
            o["mean_ms"] = o["total_ms"] / o["calls"]
        return out


def _child_ns(spans: Iterable[Span]) -> Dict[int, int]:
    """Nanoseconds each span's children cover (one thread's children run
    one after another)."""
    child: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            child[s.parent] += s.end_ns - s.start_ns
    return child


RECORDER = Recorder()
_recording = False
_ids = itertools.count(1)
_local = threading.local()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "_rf", "_nvtx", "_id", "_parent", "_root", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._id = next(_ids)
        self._parent, self._root = stack[-1] if stack else (None, self._id)
        stack.append((self._id, self._root))
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._start = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        RECORDER.spans.append(Span(self._id, self.name, self._start, end, self._parent,
                                   self._root))
        return False


def _on() -> bool:
    return _recording or torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context manager marking a layer's region (see the module)."""
    if not _on() or torch.compiler.is_compiling():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if _on():
        RECORDER.add(name, n)


@contextlib.contextmanager
def recording():
    """Clear the recorder, record the enclosed region, yield the recorder
    (which keeps what it recorded after the region ends)."""
    global _recording
    RECORDER.clear()
    outer, _recording = _recording, True
    try:
        yield RECORDER
    finally:
        _recording = outer


@contextlib.contextmanager
def trace(log_dir: str = "qasr_profile"):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace_<pid>_<n>.json`` and the recorder into
    ``log_dir/spans_<pid>_<n>.json`` (``spans``, ``counters``, and per span
    name the host and device split of :func:`attribute`); yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with recording() as rec:
        prof.start()
        try:
            yield log_dir
        finally:
            prof.stop()
            n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
            path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                chrome = json.load(f)
            with open(os.path.join(log_dir, f"spans_{os.getpid()}_{n}.json"), "w") as f:
                json.dump({"spans": [s._asdict() for s in rec.spans],
                           "counters": rec.counters,
                           "by_name": attribute(chrome, rec.spans)}, f)


def _merge(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def attribute(chrome: dict, spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """The device work of a Chrome trace (``torch.profiler``'s, a dict with
    ``traceEvents`` and ``baseTimeNanoseconds``) laid under ``spans``.

    A device op (kernel, copy, fill) belongs to the innermost span whose
    host interval holds the host call that launched it, matched by the
    trace's ``correlation`` id on any thread (the autograd engine's
    launches fall in the span its caller waits in), and counts for that
    span's ancestors too.  A span's window runs from its host start to the
    later of its host end and the end of its last op.  Per span name:
    ``calls``, ``host_s``, ``self_host_s`` (less its children's host time),
    ``device_s`` and ``launches`` (kernels) of its ops, ``window_s`` and
    ``idle_s`` (the part of the window in which the device ran nothing)."""
    events = chrome.get("traceEvents", [])
    base_ns = int(chrome.get("baseTimeNanoseconds", 0))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ops = sorted((launched[e["args"]["correlation"]], e["ts"], e["ts"] + e.get("dur", 0),
                  e["cat"] == "kernel") for e in device
                 if e.get("args", {}).get("correlation") in launched)
    busy = _merge((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    ends = [e for _, e in busy]
    before = list(itertools.accumulate((e - s for s, e in busy), initial=0.0))

    def busy_until(t: float) -> float:  # device-busy µs in (-inf, t]
        i = bisect.bisect_right(ends, t)
        part = min(t, busy[i][1]) - busy[i][0] if i < len(busy) and busy[i][0] < t else 0.0
        return before[i] + part

    # spans on the trace's clock (µs), then a sweep over the ops' launch
    # times keeping the open spans; the innermost is the latest opened
    us = {s.id: ((s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3) for s in spans}
    order = sorted(spans, key=lambda s: us[s.id][0])
    dev_s: Dict[int, float] = defaultdict(float)
    kernels: Dict[int, int] = defaultdict(int)
    last_end: Dict[int, float] = {}
    parent = {s.id: s.parent for s in spans}
    open_, closing, nxt, inner = {}, [], 0, None
    for t, s0, e0, is_kernel in ops:
        changed = False
        while nxt < len(order) and us[order[nxt].id][0] <= t:
            sid = order[nxt].id
            open_[sid] = us[sid][0]
            heapq.heappush(closing, (us[sid][1], sid))
            nxt, changed = nxt + 1, True
        while closing and closing[0][0] < t:
            open_.pop(heapq.heappop(closing)[1], None)
            changed = True
        if changed:
            inner = max(open_, key=lambda k: (open_[k], -us[k][1])) if open_ else None
        sid = inner
        while sid is not None:
            dev_s[sid] += (e0 - s0) / 1e6
            kernels[sid] += is_kernel
            last_end[sid] = max(last_end.get(sid, e0), e0)
            sid = parent.get(sid)
    child = _child_ns(spans)
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        start, end = us[s.id]
        end = max(end, last_end.get(s.id, end))
        o = out.setdefault(s.name, dict.fromkeys(
            ("calls", "host_s", "self_host_s", "device_s", "launches", "window_s", "idle_s"), 0))
        o["calls"] += 1
        o["host_s"] += (s.end_ns - s.start_ns) / 1e9
        o["self_host_s"] += (s.end_ns - s.start_ns - child[s.id]) / 1e9
        o["device_s"] += dev_s[s.id]
        o["launches"] += kernels[s.id]
        o["window_s"] += (end - start) / 1e6
        o["idle_s"] += (end - start - (busy_until(end) - busy_until(start))) / 1e6
    return out
