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
from typing import Callable, Iterator, Optional


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


# Calls a profile traces and discards before the calls it keeps.  On an
# H100 a torch.profiler session lost the first records of its window (6-14
# once the process had loaded and run the port's kernels, none in a fresh
# process, warm-up steps or not): the loss falls on calls run before the
# kept ones, more of them at each new attempt.
PROFILE_WARMUP_CALLS = 3
PROFILE_LEAD_CALLS = (2, 8, 32)
# the kernel that starts each call on the card's timeline
# (torch.cuda._sleep), so calls are told apart by the card's clock alone
MARKER = "spin_kernel"


def profile_calls(fn: Callable[[], object], calls: int):
    """The device events of ``calls`` calls of fn() on the card, from
    ``torch.profiler`` with a schedule: PROFILE_WARMUP_CALLS calls traced
    and discarded, then lead calls, the kept calls and one more, each after a
    marker kernel and followed by a synchronize, so that a call's events
    are those between its marker and the next on the card's timeline.
    Returns (one list per kept call of (name, start µs, end µs): its
    kernels, copies and memsets, user annotations left out; the profile's
    events).  Every call runs the same kernels, so a profile whose kept
    calls hold different names or counts lost records: it is taken again
    with more lead calls (PROFILE_LEAD_CALLS), and then raises
    RuntimeError."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    warmup = PROFILE_WARMUP_CALLS
    for lead in PROFILE_LEAD_CALLS:
        active = lead + calls + 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup,
                                       active=active, repeat=1)) as prof:
            for _ in range(warmup + active):
                torch.cuda._sleep(1)
                fn()
                torch.cuda.synchronize()
                prof.step()
        events = prof.events()
        groups = []
        for start, end, name in sorted(
                (e.time_range.start, e.time_range.end, e.name)
                for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            if MARKER in name:
                groups.append([])
            elif groups:
                groups[-1].append((name, start, end))
        per_call = groups[-calls - 1:-1]
        kinds = {tuple(sorted(name for name, _, _ in call))
                 for call in per_call}
        if len(per_call) == calls and len(kinds) == 1 and per_call[0]:
            return per_call, events
    raise RuntimeError(
        "torch.profiler lost device records in {} profiles of {} calls "
        "(the kept calls' kernels differ; the last profile's calls held {} "
        "records)".format(len(PROFILE_LEAD_CALLS), calls,
                          [len(c) for c in groups]))


def write_rate_artifact(path: str, num_items: int, seconds: float):
    """Persist an items/second rate the way the reference wrote
    framerates/*.txt (helper:548-552)."""
    parent = os.path.dirname(path)
    if parent:  # bare filename: write to the current directory
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(str(num_items / seconds))
