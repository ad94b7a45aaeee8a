"""Profiling hooks: named zones and chrome-trace output (counterpart of
tds_tpu/utils/profiling.py).

- :func:`profile_zone`: a ``torch.profiler.record_function`` range, and an
  NVTX range on the card, so the zone shows in ``torch.profiler`` traces
  and in Nsight timelines;
- :class:`ChromeTracer`: a host-side chrome://tracing writer for coarse
  phase timing (the JAX package's format);
- :func:`trace_to`: a ``torch.profiler`` trace of the block, written to a
  directory as a chrome trace.
"""

import contextlib
import json
import os
import threading
import time

import torch


@contextlib.contextmanager
def profile_zone(name: str):
    """A named zone in ``torch.profiler`` traces, and in NVTX when a CUDA
    device is in use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block (CPU, and CUDA when available) and write its
    chrome trace to ``log_dir/trace.json``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ChromeTracer:
    """Host-side chrome://tracing JSON writer."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def zone(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self.events.append(
                    {
                        "name": name,
                        "ph": "X",
                        "ts": (start - self._t0) * 1e6,
                        "dur": (end - start) * 1e6,
                        "pid": os.getpid(),
                        "tid": threading.get_ident() % (1 << 31),
                    }
                )

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)
