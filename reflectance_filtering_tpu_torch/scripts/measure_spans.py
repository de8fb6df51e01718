"""What a program span (``utils/profiling.py::span``) costs on the host:

* off: µs a span with no profiler session running (the hot path's cost in
  every untraced call), a tight loop of empty spans less the loop alone;
* recording: µs a span under a CUDA-only ``torch.profiler`` session, as
  the benchmark's traced calls open one (the ring's append included).

    python -m reflectance_filtering_tpu_torch.scripts.measure_spans

Prints one JSON line.  Needs a CUDA device: without one it exits nonzero.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from ..utils import profiling
from .measure_fit_steady import card

LOOP, REPEATS = 200_000, 7


def per_span_us(loop: int = LOOP) -> float:
    """The best of REPEATS timings of ``loop`` empty spans, less an empty
    loop's, µs a span."""
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(loop):
            with profiling.span("measure.empty"):
                pass
        t1 = time.perf_counter()
        for _ in range(loop):
            pass
        t2 = time.perf_counter()
        best = min(best, (t1 - t0) - (t2 - t1))
    return 1e6 * best / loop


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = {"card": card(), "off_us_a_span": per_span_us()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        out["recording_us_a_span"] = per_span_us(LOOP // 10)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
