"""Arithmetic the per-layer metric readers share.  A reader takes the run
(:class:`benchmark.harness.Run`) and returns its number, or None where the
run holds nothing to read."""
from __future__ import annotations

import re
import statistics
from typing import Optional, Sequence


def idle_share(run) -> Optional[float]:
    """100 x (1 - the union of the traced calls' kernel, copy and memset
    intervals over their spans on the card's clock)."""
    if not run.calls:
        return None
    busy = sum(c.busy_us() for c in run.calls)
    span = sum(c.span_us for c in run.calls)
    return 100.0 * (1.0 - busy / span)


def kernel_s_per_unit(run, patterns: Sequence[str]) -> Optional[float]:
    """Seconds of the device events whose names match one of ``patterns``
    (regular expressions), a unit of work (a batch, a step, a frame);
    None where no event matches."""
    if not run.calls:
        return None
    found = [e - s for c in run.calls for name, s, e in c.events
             if any(re.search(p, name) for p in patterns)]
    if not found:
        return None
    return sum(found) * 1e-6 / (len(run.calls) * run.per_call)


def roofline(run, patterns: Sequence[str], bound_s: float
             ) -> Optional[float]:
    """100 x the least time the work could take over the matched
    kernels' device time, a unit of work."""
    t = kernel_s_per_unit(run, patterns)
    return None if t is None else 100.0 * bound_s / t


def window_s_per_unit(run) -> Optional[float]:
    """The window's wall seconds a request (batch, step or frame)."""
    if not run.window.get("requests"):
        return None
    return run.window["wall_s"] / run.window["requests"]


def median_ms(values: Sequence[float]) -> Optional[float]:
    return 1e3 * statistics.median(values) if values else None
