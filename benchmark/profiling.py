"""The benchmark's device trace: a frozen copy of the port's
``utils/profiling.py::profile_calls``, reshaped so that one session can
also follow calls that the program makes itself (fit's chunks).

On an H100 a ``torch.profiler`` session was seen to lose the first records
of its window once the process had run the port's kernels, and the card's
clock is off the host's.  So, as ``profile_calls`` does, each call starts
after a marker kernel (``torch.cuda._sleep``), calls are told apart on the
card's clock alone, lead calls are traced and dropped, and the kept calls
must hold the same kernels, else the session is taken again with more lead
calls.  A call's span is the card's time from its marker to the next
marker, so busy time and span come from one clock.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import torch

# the kernel that starts each call on the card's timeline
MARKER = "spin_kernel"
# calls traced and dropped before the kept ones, one session each
LEAD_CALLS = (2, 8, 32)

Event = Tuple[str, float, float]     # (name, start us, end us)


class Call:
    """One traced call: its device events, and its span on the card's
    clock from its marker's start (``start_us``) to the next marker's
    start."""

    def __init__(self, events: List[Event], start_us: float,
                 span_us: float):
        self.events = events
        self.start_us = start_us
        self.span_us = span_us

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted(name for name, _, _ in self.events))

    def busy_us(self) -> float:
        """The union of the call's event intervals."""
        busy, end = 0.0, None
        for _, s, e in sorted(self.events, key=lambda ev: ev[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def gaps(self) -> List[Tuple[str, float]]:
        """The call's idle intervals (us), each named by the device
        operation that ended it; busy time and gaps fill the span."""
        out, end = [], self.start_us
        for name, s, e in sorted(self.events, key=lambda ev: ev[1]):
            if s > end:
                out.append(("before " + name, s - end))
            end = max(end, e)
        tail = self.start_us + self.span_us - end
        if tail > 0:
            out.append(("after the last operation", tail))
        return out


class Session:
    """A ``torch.profiler`` session whose calls are split by markers:
    ``start()``, then ``mark()`` before each call, and ``stop()`` after a
    marker that follows the last call."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        # the card's activity alone: tracing the host's operators too
        # slows the host and reads as idle time on the card
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def mark(self) -> None:
        torch.cuda._sleep(1)

    def stop(self) -> List[Call]:
        """The calls between consecutive markers, in order."""
        torch.cuda.synchronize()
        self._prof.stop()
        events = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in self._prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
        calls, current, begun = [], None, None
        for start, end, name in events:
            if MARKER in name:
                if current is not None:
                    calls.append(Call(current, begun, start - begun))
                current, begun = [], start
            elif current is not None:
                current.append((name, start, end))
        return calls


def kept(calls: List[Call], n: int) -> Optional[List[Call]]:
    """The last ``n`` calls, if they hold the same kernels and some."""
    tail = calls[-n:]
    if len(tail) == n and len({c.kinds() for c in tail}) == 1 and \
            tail[0].events:
        return tail
    return None


def trace_calls(fn: Callable[[], object], calls: int) -> List[Call]:
    """``calls`` calls of fn() traced on the card, each after a marker and
    followed by a synchronize; lead calls before them are dropped.  Raises
    RuntimeError when every session's kept calls differ."""
    sizes = []
    for lead in LEAD_CALLS:
        session = Session()
        session.start()
        for _ in range(lead + calls):
            session.mark()
            fn()
            torch.cuda.synchronize()
        session.mark()
        got = session.stop()
        sizes = [len(c.events) for c in got]
        out = kept(got, calls)
        if out is not None:
            return out
    raise RuntimeError("torch.profiler lost device records in {} sessions "
                       "of {} calls (the last held {} records a call)"
                       .format(len(LEAD_CALLS), calls, sizes))


def _short(name: str, most: int = 120) -> str:
    return name if len(name) <= most else name[:most - 3] + "..."


def breakdown(calls: List[Call]) -> Dict[str, List[List]]:
    """The device operations that took most time and the longest idle gaps
    (seconds summed over the calls, by name, names cut to 120 letters),
    ten of each."""
    ops, gaps = collections.Counter(), collections.Counter()
    for call in calls:
        for name, s, e in call.events:
            ops[_short(name)] += (e - s) * 1e-6
        for name, us in call.gaps():
            gaps[_short(name)] += us * 1e-6
    return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(10)]}
