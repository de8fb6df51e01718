"""The device ms a step outside the convolution kernels (those that
``conv_roofline.KERNELS`` matches): the ReLUs, concatenations, layout
copies, the resize and its backward, the recovery, the losses, WHDR's
gather and scatter, Adam, the copies and memsets, summed."""
from __future__ import annotations

import re

LAYER = "kernels"


def read(run):
    from benchmark.metrics.conv_roofline import KERNELS
    if not run.calls:
        return None
    rest = [e - s for c in run.calls for name, s, e in c.events
            if not any(re.search(p, name) for p in KERNELS)]
    return 1e-3 * sum(rest) / (len(run.calls) * run.per_call)
