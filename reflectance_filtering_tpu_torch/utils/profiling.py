"""Tracing and profiling utilities (port of reflectance_filtering_tpu/utils/
profiling.py).

The reference instrumented with timeit spans and persisted rates to plain
text (train_with_barrista_helper.py:275-298, 530-552).  This module keeps
that plain-text contract and adds the device trace: ``torch.profiler``
over the CPU and, where there is a card, CUDA activities, written as a
Chrome trace (open it in chrome://tracing or Perfetto).

Usage::

    with span("predict") as s: ...
    print(s.seconds)

    with device_trace("/tmp/trace"):   # every op and kernel inside
        run_pipeline(...)
"""
from __future__ import annotations

import contextlib
import os
import time
import timeit
from typing import Iterator, Optional


class Span:
    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None
        self._start: Optional[float] = None


@contextlib.contextmanager
def span(name: str, verbose: bool = False) -> Iterator[Span]:
    """Wall-clock span (the reference's timeit.default_timer idiom)."""
    s = Span(name)
    s._start = timeit.default_timer()
    try:
        yield s
    finally:
        s.seconds = timeit.default_timer() - s._start
        if verbose:
            print("[span] {}: {:.4f}s".format(name, s.seconds))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of everything inside, CPU and (when torch
    sees a GPU) CUDA activities, written to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format) on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace_{}_{}.json".format(
        os.getpid(), time.time_ns())))


def write_rate_artifact(path: str, num_items: int, seconds: float):
    """Persist an items/second rate the way the reference wrote
    framerates/*.txt (helper:548-552)."""
    parent = os.path.dirname(path)
    if parent:  # bare filename: write to the current directory
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(str(num_items / seconds))
