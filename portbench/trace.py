"""A profiler session over part of a run, reduced to what the metrics read.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host operations and
CUDA activity), writes the Chrome trace into the run's temporary directory,
reads it back and deletes it.  The summary holds the device's busy seconds
(the union of kernel, copy and fill intervals), the traced window's length
on the host clock, every device kernel's count and seconds by name, and the
longest idle gaps of the device, each named by the innermost host operation
running at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[Dict], window_s: float) -> Optional[Dict]:
    """The summary of a Chrome trace's events (times in microseconds), or
    None where the trace holds no device activity."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not device:
        return None
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in device:
        k = kernels[e["name"]]
        k[0] += 1
        k[1] += e.get("dur", 0) / 1e6
    busy = _merge((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    named = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2
        covering = [h for h in host[:bisect.bisect_right(starts, mid)] if h[1] >= mid]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "(no host op)"
        named.append([name, length / 1e6])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": window_s,
        "kernels": {n: (c, s) for n, (c, s) in kernels.items()},
        "launches": sum(1 for e in device if e["cat"] == "kernel"),
        "idle_gaps": named,
    }


def profiled(fn: Callable[[], None]) -> Optional[Dict]:
    """Run ``fn`` traced and return the summary (None: the trace showed no
    device time, so trace-based metrics are not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    del prof
    return summarize(events, window_s)


def breakdown(summary: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps."""
    top = sorted(summary["kernels"].items(), key=lambda kv: kv[1][1], reverse=True)[:10]
    return {"device_ops": [[n[:200], s] for n, (_, s) in top],
            "idle_gaps": [[n[:200], s] for n, s in summary["idle_gaps"]]}
