"""K2: the self-guided gray bilateral filter
(csrc/bilateral_gray_self.cu), its plain PyTorch version and its wrapper.

Port of reflectance_filtering_tpu/ops/bilateral_pallas.py::
bilateral_gray_self_batched (and its lane-packed twin, the same function):
x [N, H, W] read as ``reps`` identical channels, filtered by OpenCV's disk
bilateral with joint == src (the disk cut exactly at r^2 <= radius^2, one
divide at the end).  The weight depends on the input's type:

  * uint8 levels (both product callers): cv2's table form, ``sw[dx^2 +
    dy^2] * cw[|d|]`` with the float64-built tables of
    :func:`~.bilateral.range_weights` and :func:`~.bilateral.space_weights`;
  * float32 in 0-255 units (the JAX function's float domain): the TPU
    kernel's ``exp(reps^2 * d^2 * gcc + r^2 * gsc)``.

On integer levels the two forms differ only in float32 rounding.  Kernel
and plain version sum in the same tap order but round differently (the
kernel fuses multiply and add), so they agree to f32 rounding (the uint8
gate), not bitwise.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build
from .bilateral import (opencv_bilateral_coeffs, pad_reflect101,
                        range_weights, space_weights)


def _taps(radius: int):
    """The disk's taps (dy, dx) in the kernel's order: row by row, dx
    ascending."""
    for dy in range(-radius, radius + 1):
        dxmax = math.isqrt(radius * radius - dy * dy)
        for dx in range(-dxmax, dxmax + 1):
            yield dy, dx


def bilateral_gray_self_plain(x: torch.Tensor, d: int = -1,
                              sigma_color: float = 20.0,
                              sigma_space: float = 22.0,
                              reps: int = 3) -> torch.Tensor:
    """Plain version of K2: a loop over the disk's taps on whole planes,
    in the kernel's tap order, with its weight form for x's type."""
    radius, gcc, gsc = opencv_bilateral_coeffs(d, sigma_color,
                                               sigma_space)
    n, h, w = x.shape
    xp = pad_reflect101(x, radius)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    wsum = torch.zeros_like(acc)
    if x.dtype == torch.uint8:
        cw = torch.from_numpy(range_weights(gcc, reps)).to(x.device)
        sw = space_weights(radius, gsc)
        center, xpl, xpf = x.long(), xp.long(), xp.to(torch.float32)
        for dy, dx in _taps(radius):
            at = (slice(None), slice(radius + dy, radius + dy + h),
                  slice(radius + dx, radius + dx + w))
            wgt = cw[(xpl[at] - center).abs()] * float(sw[dy * dy + dx * dx])
            acc += wgt * xpf[at]
            wsum += wgt
        return acc / wsum
    g2 = np.float32(gcc * float(reps * reps))
    gsc = np.float32(gsc)
    for dy, dx in _taps(radius):
        v = xp[:, radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        diff = v - x
        # the spatial term in f32, as the kernel computes it
        wgt = torch.exp(diff * diff * g2 + np.float32(dy * dy + dx * dx) * gsc)
        acc += wgt * v
        wsum += wgt
    return acc / wsum


@functools.lru_cache(maxsize=16)
def _tables(device: torch.device, radius: int, reps: int, gcc: float,
            gsc: float, planes: int = 1) -> torch.Tensor:
    """[cw (255 planes + 1) | sw (radius^2 + 1)] float32 on ``device``, the
    uint8 form's tables (K2's one plane, K6's joint planes), uploaded once
    per parameter set."""
    return torch.from_numpy(np.concatenate([
        range_weights(gcc, reps, planes), space_weights(radius, gsc)])).to(
            device)


def bilateral_gray_self(x: torch.Tensor, d: int = -1,
                        sigma_color: float = 20.0,
                        sigma_space: float = 22.0,
                        reps: int = 3) -> torch.Tensor:
    """Self-guided gray bilateral: x [N, H, W] uint8 levels (cv2's table
    form) or float32 in 0-255 units (the exp form), ``reps`` identical
    channels -> float32 [N, H, W].

    A CPU tensor runs :func:`bilateral_gray_self_plain`; a CUDA tensor
    launches the kernel."""
    if isinstance(x, torch.Tensor) and x.dtype not in (torch.uint8,
                                                       torch.float32):
        raise TypeError("x must be uint8 levels or float32, got {}".format(
            x.dtype))
    _build.check_tensor(x, "x", x.dtype, 3)
    if x.device.type == "cpu":
        return bilateral_gray_self_plain(x, d, sigma_color, sigma_space, reps)
    _build.require_cuda(x, "bilateral_gray_self")
    n, h, w = x.shape
    if n > 65535:
        raise ValueError("batch {} exceeds the kernel's grid limit of "
                         "65535".format(n))
    radius, gcc, gsc = opencv_bilateral_coeffs(d, sigma_color,
                                               sigma_space)
    u8 = x.dtype == torch.uint8
    tables = _tables(x.device, radius, reps, gcc, gsc) if u8 else None
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        _build.launch("rf_bilateral_gray_self", x.device, x.data_ptr(),
                      out.data_ptr(), tables.data_ptr() if u8 else None,
                      n, h, w, int(u8), radius, gcc * float(reps * reps),
                      gsc)
        bilateral_gray_self.launches += 1
    return out


bilateral_gray_self.launches = 0
