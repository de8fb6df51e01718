"""Tracing and profiling utilities (port of reflectance_filtering_tpu/utils/
profiling.py).

The reference instrumented with timeit spans and persisted rates to plain
text (train_with_barrista_helper.py:275-298, 530-552).  This module keeps
that plain-text contract and adds:

* program spans: ``with span("serve.cnn") as s:`` times its block
  (``s.seconds``) and, while a ``torch.profiler`` session runs, records
  the span (name, start and end on ``time.time_ns``'s clock, which the
  profiler stamps its events with, its parent and its trace) in a bounded
  ring that :func:`spans` reads;
* the device trace: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activities, written as a Chrome trace (open it in
  chrome://tracing or Perfetto) with a track of the program's spans, and
  beside it the card's idle time summed by the span that issued the work
  ending each idle gap.

Usage::

    with span("predict.device") as s: ...
    print(s.seconds)

    with device_trace("/tmp/trace"):   # every op and kernel inside
        run_pipeline(...)
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# records the ring keeps; past this the oldest is dropped
SPAN_RING_SIZE = 65536


class SpanRecord(NamedTuple):
    """One span as recorded: start and end in ``time.time_ns()``; ``id``
    unique in the process; ``parent`` the id of the span open on the same
    thread when it began (None for a root); ``trace`` the id of its root;
    ``thread`` the thread's native id (the profiler's thread id)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    trace: int
    thread: int


# deque.append and next(count) are atomic: threads share both unlocked
_RING: collections.deque = collections.deque(maxlen=SPAN_RING_SIZE)
_IDS = itertools.count(1)
# .stack: [(id, trace)] of the thread's recording spans; .thread: its id
_OPEN = threading.local()
_now = time.time_ns


def _tracing_a_graph() -> bool:
    """A graph is being traced (torch.export, torch.compile): a span
    there runs once, at tracing, not when the graph runs.  (No span lies
    in code a CUDA graph captures; asking the card whether one is being
    captured costs a CUDA call, which a profiler session traces.)"""
    return torch.compiler.is_compiling()


class Span:
    """A timed block: ``seconds`` is its wall time once it has closed.
    With no profiler session running it records nothing; with one, it is
    appended to the ring when it closes.  Cheap enough for the hot path
    (a small object and two clock reads while nothing records)."""
    __slots__ = ("name", "_start", "_end", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __enter__(self) -> "Span":
        # the flag torch sets for every profiler session, whatever it traces
        if _autograd_profiler._is_profiler_enabled and \
                not _tracing_a_graph():
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
                _OPEN.thread = threading.get_native_id()
            sid = next(_IDS)
            if stack:
                parent, trace = stack[-1]
            else:
                parent, trace = None, sid
            self._open = (sid, parent, trace)
            stack.append((sid, trace))
        self._start = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._end = _now()
        if self._open is not None:
            sid, parent, trace = self._open
            _OPEN.stack.pop()
            _RING.append(SpanRecord(self.name, self._start, self._end, sid,
                                    parent, trace, _OPEN.thread))

    @property
    def seconds(self) -> Optional[float]:
        """The block's wall seconds once it has closed, else None."""
        end = getattr(self, "_end", None)
        return None if end is None else (end - self._start) * 1e-9


span = Span


def spans(name: Optional[str] = None) -> List[SpanRecord]:
    """The ring's records (all, or those named ``name``), oldest first."""
    return [r for r in list(_RING) if name is None or r.name == name]


# the Chrome trace's categories of work on the card, and of the host calls
# that issue it (a launch, copy or memset; a graph launch issues all of the
# graph's kernels under one correlation)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_NAME = re.compile(r"Launch|Memcpy|Memset")
OUTSIDE = "outside the program"
UNMATCHED = "unmatched"
# the span track's process id: above any Linux pid (at most 2**22), so it
# shares a row with no process or device of the trace
SPAN_TRACK_PID = 1 << 24


def _innermost_names(spans, times):
    """time -> the name of the innermost of ``spans`` ((start, end, name)
    of one thread's spans, which nest) open at that time, or None."""
    order = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    out, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] < order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[t] = stack[-1][2] if stack else None
    return out


def idle_by_span(trace_events: List[Dict], records: List[SpanRecord],
                 base_ns: int = 0) -> Dict:
    """The card's idle time in a Chrome trace, summed by span.

    The window runs from the first device operation's start to the last
    one's end; each idle gap in it (no operation running on any stream)
    is charged to the innermost span of ``records`` that was open, on the
    launching thread, when the operation ending the gap was launched (the
    trace's ``correlation`` ties a device operation to its launch), or to
    OUTSIDE when none was.  A gap goes to UNMATCHED when the operation
    ending it or the one before it has no launch record, or when a launch
    between those two operations' launches has no device record: the gap
    may hold a lost operation's time.  Span times are placed on the trace's
    timeline as the profiler places its events, ``(ns - base_ns) / 1000``
    µs.  Returns the window, busy and idle µs, idle µs by span (largest
    first; they sum to the idle time), and the records missing: device
    operations without a launch, launches without a device operation (by
    name, and how many of them came before the window)."""
    ops, launches = [], {}
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATEGORIES:
            ops.append((float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0)), corr))
        elif (e.get("cat") in LAUNCH_CATEGORIES and corr is not None
              and LAUNCH_NAME.search(e.get("name", ""))):
            launches[corr] = (float(e["ts"]), e.get("tid"), e["name"])
    ops.sort(key=lambda o: o[:2])
    with_op = {corr for _, _, corr in ops}
    lost = [launch for corr, launch in launches.items()
            if corr not in with_op]
    # each gap: (µs, the operation ending it, the one whose end began it)
    gaps, end, ender = [], None, None
    for start, stop, corr in ops:
        if end is not None and start > end:
            gaps.append((start - end, corr, ender))
        if end is None or stop >= end:
            end, ender = stop, corr
    window = ops[-1][1] - ops[0][0] if ops else 0.0
    idle = sum(g for g, _, _ in gaps)

    by_thread = collections.defaultdict(list)
    for r in records:
        by_thread[r.thread].append(((r.start_ns - base_ns) / 1e3,
                                    (r.end_ns - base_ns) / 1e3, r.name))
    asked = collections.defaultdict(list)
    for _, corr, _ in gaps:
        if corr in launches:
            t, tid, _ = launches[corr]
            asked[tid].append(t)
    names = {tid: _innermost_names(by_thread.get(tid, ()), times)
             for tid, times in asked.items()}

    by_span = collections.Counter()
    for gap, corr, before in gaps:
        if corr not in launches:
            by_span[UNMATCHED] += gap
            continue
        t, tid, _ = launches[corr]
        # without the launch of the op before the gap, a lost launch
        # since it cannot be ruled out
        if before not in launches or any(
                launches[before][0] < x[0] < t for x in lost):
            by_span[UNMATCHED] += gap
            continue
        by_span[names[tid][t] or OUTSIDE] += gap
    first = min((launches[c][0] for _, _, c in ops if c in launches),
                default=None)
    return {"window_us": window, "busy_us": window - idle, "idle_us": idle,
            "gaps": len(gaps),
            "idle_us_by_span": dict(by_span.most_common()),
            "device_ops": len(ops),
            "device_ops_without_launch": sum(1 for _, _, c in ops
                                             if c not in launches),
            # by name; those launched before the first recorded operation's
            # launch lie before the window and charge no gap
            "launches_without_device_op": dict(collections.Counter(
                name for _, _, name in lost).most_common()),
            "launches_without_device_op_before_the_window": sum(
                1 for t, _, _ in lost if first is None or t < first)}


def span_track(records: List[SpanRecord], base_ns: int = 0) -> List[Dict]:
    """Chrome trace events that draw ``records`` as a track of their own,
    a row a thread, on the profiler's timeline."""
    out = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK_PID,
            "tid": 0, "args": {"name": "program spans"}}]
    for r in records:
        out.append({"ph": "X", "cat": "program_span", "name": r.name,
                    "pid": SPAN_TRACK_PID, "tid": r.thread,
                    "ts": (r.start_ns - base_ns) / 1e3,
                    "dur": (r.end_ns - r.start_ns) / 1e3,
                    "args": {"id": r.id, "parent": r.parent,
                             "trace": r.trace}})
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of everything inside, CPU and (when torch
    sees a GPU) CUDA activities, written on exit to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format), with the
    program's spans as a track of their own, and beside it
    ``idle_<pid>_<ns>.json``: the card's idle time by span
    (:func:`idle_by_span`)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    records = [r for r in spans() if r.start_ns >= start]
    stem = "{}_{}.json".format(os.getpid(), time.time_ns())
    path = os.path.join(log_dir, "trace_" + stem)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # the profiler writes each event at (its time_ns - this base) / 1000 µs
    base = int(trace.get("baseTimeNanoseconds", 0))
    idle = idle_by_span(trace["traceEvents"], records, base)
    trace["traceEvents"].extend(span_track(records, base))
    with open(path, "w") as f:
        json.dump(trace, f)
    idle["trace"] = os.path.basename(path)
    with open(os.path.join(log_dir, "idle_" + stem), "w") as f:
        json.dump(idle, f, indent=1)


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
