"""K2: the self-guided gray bilateral filter
(csrc/bilateral_gray_self.cu), its plain PyTorch version and its wrapper.

Port of reflectance_filtering_tpu/ops/bilateral_pallas.py::
bilateral_gray_self_batched (and its lane-packed twin, the same function):
x [N, H, W] float32 in 0-255 units, read as ``reps`` identical channels,
filtered by OpenCV's disk bilateral with joint == src.  Both versions
compute the TPU kernel's weight ``exp(reps^2 * d^2 * gcc + r^2 * gsc)``
with the disk cut exactly at r^2 <= radius^2 and one divide at the end;
they sum in different orders, so they agree to f32 rounding (the uint8
gate), not bitwise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from .bilateral import opencv_bilateral_params, pad_reflect101


def bilateral_gray_self_plain(x: torch.Tensor, d: int = -1,
                              sigma_color: float = 20.0,
                              sigma_space: float = 22.0,
                              reps: int = 3) -> torch.Tensor:
    """Plain version of K2: a loop over the disk's taps on whole planes."""
    radius, gcc, gsc, _ = opencv_bilateral_params(d, sigma_color,
                                                  sigma_space)
    n, h, w = x.shape
    xp = pad_reflect101(x, radius)
    g2 = np.float32(gcc * float(reps * reps))
    gsc = np.float32(gsc)
    acc = torch.zeros_like(x)
    wsum = torch.zeros_like(x)
    for dy in range(-radius, radius + 1):
        dxmax = math.isqrt(radius * radius - dy * dy)
        for dx in range(-dxmax, dxmax + 1):
            v = xp[:, radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            diff = v - x
            # the spatial term in f32, as the kernel computes it
            wgt = torch.exp(diff * diff * g2
                            + np.float32(dy * dy + dx * dx) * gsc)
            acc += wgt * v
            wsum += wgt
    return acc / wsum


def bilateral_gray_self(x: torch.Tensor, d: int = -1,
                        sigma_color: float = 20.0,
                        sigma_space: float = 22.0,
                        reps: int = 3) -> torch.Tensor:
    """Self-guided gray bilateral: x [N, H, W] float32 (0-255 units,
    ``reps`` identical channels) -> [N, H, W].

    A CPU tensor runs :func:`bilateral_gray_self_plain`; a CUDA tensor
    launches the kernel."""
    _build.check_tensor(x, "x", torch.float32, 3)
    if x.device.type == "cpu":
        return bilateral_gray_self_plain(x, d, sigma_color, sigma_space, reps)
    _build.require_cuda(x, "bilateral_gray_self")
    n, h, w = x.shape
    if n > 65535:
        raise ValueError("batch {} exceeds the kernel's grid limit of "
                         "65535".format(n))
    radius, gcc, gsc, _ = opencv_bilateral_params(d, sigma_color,
                                                  sigma_space)
    out = torch.empty_like(x)
    if out.numel():
        _build.launch("rf_bilateral_gray_self", x.device, x.data_ptr(),
                      out.data_ptr(), n, h, w, radius,
                      gcc * float(reps * reps), gsc)
        bilateral_gray_self.launches += 1
    return out


bilateral_gray_self.launches = 0
