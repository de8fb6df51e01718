"""The step's convolutions (cuDNN's forward, data-gradient and
weight-gradient kernels, the transposed convolutions among them): their
bound a step over their device time a step.  The bound is the entry's
(``conv_bound_s`` in the window: for the uNet, 3 x 2 x the network's MACs
at the TF32 peak, ``counts_unet.conv_bound_s``), so that each network
counts its own; a window without it gives None.  The kernels matched a
step must be at least the convolutions the program counted a step
(``conv2d.launches`` and ``deconv2d.launches``, where the program counts
them), else the patterns miss some."""
from __future__ import annotations

import re

LAYER = "kernels"
# what cuDNN launches for a convolution on an H100, its float32 algorithms
# as a traced step of the cell names them: implicit GEMMs (xmma fprop,
# dgrad), the direct engines (convolve_common_engine, wgrad_alg0_engine,
# dgrad_engine, dgrad2d_alg1), Winograd, FFT (fft2d_*, DSE::*,
# region_transform, and the complex GEMMs of cuBLAS and CUTLASS it calls),
# and cuDNN's own layout and scaling kernels (nhwcToNchw, nchwToNhwc,
# scalePackedTensor); nothing else in the step calls cuBLAS
KERNELS = (r"cudnn", r"xmma", r"cutlass", r"fft", r"DSE::",
           r"region_transform", r"convolve", r"wgrad", r"dgrad",
           r"winograd")


def read(run):
    from benchmark.metrics._shares import roofline
    if not run.calls or "conv_bound_s" not in run.window:
        return None
    per_step = sum(1 for c in run.calls for name, _, _ in c.events
                   if any(re.search(p, name) for p in KERNELS)) / (
        len(run.calls) * run.per_call)
    counted = run.window.get("convs_per_step")
    if counted is not None and per_step < counted:
        raise RuntimeError(
            "conv_roofline: {:.1f} kernels a step match the patterns, under "
            "the {:.1f} convolutions the program issued a step".format(
                per_step, counted))
    return roofline(run, KERNELS, run.window["conv_bound_s"])
