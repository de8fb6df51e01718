"""One client's closed loop: the next request is sent when the last one's
outputs are readable on the host.  The window runs until ``seconds`` have
passed on the host's clock; every request in it is timed and a sample of
their outputs, drawn from the seed, is kept for the comparison."""
from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

clock = time.perf_counter


class Reservoir:
    """A uniform sample of ``size`` of the items offered (Algorithm R),
    drawn from ``seed``: keeping one costs no copy."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: List[Tuple[int, Any]] = []
        self._rng = random.Random(seed)
        self._seen = 0

    def offer(self, item: Any) -> None:
        if len(self.items) < self.size:
            self.items.append((self._seen, item))
        else:
            j = self._rng.randrange(self._seen + 1)
            if j < self.size:
                self.items[j] = (self._seen, item)
        self._seen += 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(request: Callable[[int], Any], pool: int, seconds: float,
        device: torch.device, sample: Reservoir) -> Dict[str, Any]:
    """Requests i = 0, 1, ... on pool entry i mod ``pool`` until the window
    closes.  ``request(j)`` issues one request and returns its outputs
    (host tensors, or tensors on the device, not yet waited for); the loop
    waits for the device, then offers (j, outputs) to ``sample``.
    Returns the window's start and wall seconds, the requests, and each
    request's latency and host issue time (seconds)."""
    latency, issue = [], []
    start = clock()
    i = 0
    while True:
        t0 = clock()
        out = request(i % pool)
        t1 = clock()
        sync(device)
        t2 = clock()
        latency.append(t2 - t0)
        issue.append(t1 - t0)
        sample.offer((i % pool, out))
        i += 1
        if t2 - start >= seconds:
            break
    return {"start": start, "wall_s": t2 - start, "requests": i,
            "latency_s": latency, "issue_s": issue}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)
