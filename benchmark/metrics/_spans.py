"""Readers of the program's own spans.  The port records a span (a
``SpanRecord``: name, start and end in ns) while a ``torch.profiler``
session runs, which the traced calls are: a reader takes the span's last
records, one a traced call (request, frame or chunk), from
``reflectance_filtering_tpu_torch.utils.profiling.spans``.

The readings are those of traced calls: CUPTI, which the session runs,
lengthens each launch a span holds, so a span over many launches reads
longer than the same issue untraced.

A ``profiling`` module that fails to import, or has no ``spans``, fails
the run."""
from __future__ import annotations

import statistics
from typing import Optional

from reflectance_filtering_tpu_torch.utils import profiling


def program_spans(name: str) -> list:
    """The program's records of span ``name``, oldest first."""
    return profiling.spans(name)


def traced_median_ms(run, name: str) -> Optional[float]:
    """The median host duration (ms) of the last ``len(run.calls)``
    records of span ``name``, those of the traced calls; None where there
    are fewer."""
    n = len(run.calls) if run.calls else 0
    got = program_spans(name)[-n:] if n else []
    if not n or len(got) < n:
        return None
    return 1e-6 * statistics.median(r.end_ns - r.start_ns for r in got)
