"""The step's batch norms (ATen's kernels: the batch statistics, the
running statistics' update, the normalisation, and the backward's
reduction and gradient): their bound a step over their device time a
step.  The bound is the entry's (``norm_bound_s`` in the window: for
pix2pix, the bytes a step's batch norms must move at the HBM's rate,
``counts_pix2pix.norm_bound_s``); a window without it gives None.  The
kernels matched a step must be at least the batch norms the program
counted a step (``batch_norm.launches``, where the program counts them),
else the patterns miss some."""
from __future__ import annotations

import re

LAYER = "kernels"
# what ATen launches for a batch norm on a card: its channels-last and
# contiguous kernels (batch_norm_collect_statistics_*,
# batch_norm_transform_input_*, batch_norm_backward_reduce_*,
# batch_norm_backward_elemt_*) and the elementwise kernel that moves the
# running statistics, each named after its batch_norm_* function
KERNELS = (r"batch_norm",)


def read(run):
    from benchmark.metrics._shares import roofline
    if not run.calls or "norm_bound_s" not in run.window:
        return None
    per_step = sum(1 for c in run.calls for name, _, _ in c.events
                   if any(re.search(p, name) for p in KERNELS)) / (
        len(run.calls) * run.per_call)
    counted = run.window.get("norms_per_step")
    if counted is not None and per_step < counted:
        raise RuntimeError(
            "norm_roofline: {:.1f} kernels a step match the patterns, under "
            "the {:.1f} batch norms the program issued a step".format(
                per_step, counted))
    return roofline(run, KERNELS, run.window["norm_bound_s"])
