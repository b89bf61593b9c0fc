"""Tracing and per-step timing.

Port of ``qasr_ijcnlp_tpu/profiling.py``:

* :func:`trace` — a ``torch.profiler`` capture of a region (CPU and, where
  torch sees a card, CUDA activities) written as a Chrome trace into
  ``log_dir`` (``chrome://tracing`` or Perfetto load it);
* :func:`annotate` — a named region on that timeline
  (``record_function``), and on the card also an NVTX range;
* :class:`StepTimer` — wall-clock totals per named step, taken after the
  device has finished the step's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "qasr_profile"):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace_<pid>_<n>.json``; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that appears on the profiler timeline (and, on the
    card, as an NVTX range)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _sync(obj) -> None:
    """Wait for the device that holds ``obj``'s last tensor (a tensor, or a
    list, tuple or dict of them); with no tensor, for the current CUDA
    device, which runs its queue in order.  The CPU needs no wait."""
    tensors = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                collect(y)
        elif isinstance(x, dict):
            for y in x.values():
                collect(y)

    collect(obj)
    if tensors:
        if tensors[-1].is_cuda:
            torch.cuda.synchronize(tensors[-1].device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates device-synchronized timings per step name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def step(self, name: str, result_holder: Optional[list] = None):
        """Time the enclosed block; append the step's output to
        ``result_holder`` to wait for its device, else the current CUDA
        device's queue is flushed (otherwise only the launch time would be
        recorded)."""
        t0 = time.perf_counter()
        yield
        _sync(result_holder[-1] if result_holder else None)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its output's device, record the wall time,
        return the output."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self, log=print):
        for name, s in sorted(self.summary().items()):
            log(f"{name:<28} {s['count']:>6} x {s['mean_ms']:9.2f} ms "
                f"= {s['total_s']:8.2f} s")
