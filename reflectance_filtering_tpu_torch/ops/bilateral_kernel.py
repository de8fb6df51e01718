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

Any radius runs: where the tile, its halo and the tables pass a block's
shared memory (uint8 past radius 113, float32 past 100), the kernel takes
the disk's rows in bands (:func:`band_rows`), with the same taps in the same
order.  On integer levels the two forms differ only in float32 rounding.  Kernel
and plain version sum in the same tap order but round differently (the
kernel fuses multiply and add), so they agree to f32 rounding (the uint8
gate), not bitwise.

The wrapper runs the ``torch.library`` operator ``rf::bilateral_gray_self``
(the bf serving artifact records it, utils/serving.py); the operator's
body makes the tables and checks the radius when it runs.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build
from .bilateral import (opencv_bilateral_coeffs, pad_reflect101,
                        range_weights, space_weights)


SMEM_LIMIT = 232448      # shared memory one H100 block can take
# the kernel's geometry by input type (csrc/bilateral_gray_self.cu): tile
# columns (16 threads x pixels a thread) and rows (threads down a block)
_TILE = {True: (128, 32), False: (64, 16)}
_RANGE_TABLE_BYTES = 511 * 32 * 4   # RangeTable: a copy per bank


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _tile_pitch(u8: bool, radius: int) -> int:
    """Elements of a tile row (``tile_pitch`` in
    csrc/bilateral_gray_self.cuh)."""
    cols = _TILE[u8][0] + 2 * radius
    return (cols - 64 + 127) // 128 * 128 + 64 if u8 else cols + 1


def smem_bytes(u8: bool, radius: int, band: int = None) -> int:
    """Shared memory of one block: ``band`` None, the one-band kernel's
    (``smem_bytes``: the tile and its halo, and for uint8 levels the
    spatial weights and the range table); else the banded kernel's for
    bands of ``band`` disk rows (``banded_smem_bytes``: band + rows - 1
    tile rows, and for uint8 levels the range table; the spatial weights
    stay in device memory)."""
    rows = _TILE[u8][1]
    tile_rows = rows + 2 * radius if band is None else band + rows - 1
    tile = tile_rows * _tile_pitch(u8, radius) * (1 if u8 else 4)
    if not u8:
        return tile
    if band is not None:
        return _align16(tile) + _RANGE_TABLE_BYTES
    return (_align16(tile) + _align16((radius * radius + 1) * 4)
            + _RANGE_TABLE_BYTES)


def band_rows(u8: bool, radius: int) -> int:
    """The disk rows each band of the launch stages (``band_rows`` in
    csrc/bilateral_gray_self.cuh): the whole disk (2r + 1) where the
    one-band kernel fits :data:`SMEM_LIMIT`, else the most rows whose
    banded kernel fits it, evened out over the bands; 0 where not one row
    fits."""
    from .bilateral_joint_kernel import even_band
    disk = 2 * radius + 1
    if smem_bytes(u8, radius) <= SMEM_LIMIT:
        return disk
    row = _tile_pitch(u8, radius) * (1 if u8 else 4)
    most = SMEM_LIMIT // row - (_TILE[u8][1] - 1)
    while most > 0 and smem_bytes(u8, radius, most) > SMEM_LIMIT:
        most -= 1
    return even_band(disk, most, 1)


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


@torch.library.custom_op("rf::bilateral_gray_self", mutates_args=(),
                         schema="(Tensor x, int d, float sigma_color, "
                                "float sigma_space, int reps) -> Tensor")
def _bilateral_gray_self_op(x: torch.Tensor, d: int, sigma_color: float,
                            sigma_space: float, reps: int) -> torch.Tensor:
    """K2 as an operator ``torch.export`` can trace: a CPU tensor runs
    :func:`bilateral_gray_self_plain`, a CUDA tensor launches the kernel
    (its tables built here, once per device and parameter set)."""
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
    if band_rows(u8, radius) < 1:
        raise ValueError("bilateral_gray_self: radius {} leaves no room for "
                         "one disk row of a tile in a block's shared "
                         "memory".format(radius))
    tables = _tables(x.device, radius, reps, gcc, gsc) if u8 else None
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        _build.launch("rf_bilateral_gray_self", x.device, x.data_ptr(),
                      out.data_ptr(), tables.data_ptr() if u8 else None,
                      n, h, w, int(u8), radius, gcc * float(reps * reps),
                      gsc)
        _build.count(bilateral_gray_self)
    return out


@_bilateral_gray_self_op.register_fake
def _(x, d, sigma_color, sigma_space, reps):
    return x.new_empty(x.shape, dtype=torch.float32)


def bilateral_gray_self(x: torch.Tensor, d: int = -1,
                        sigma_color: float = 20.0,
                        sigma_space: float = 22.0,
                        reps: int = 3) -> torch.Tensor:
    """Self-guided gray bilateral: x [N, H, W] uint8 levels (cv2's table
    form) or float32 in 0-255 units (the exp form), ``reps`` identical
    channels -> float32 [N, H, W].

    Runs the operator ``torch.ops.rf.bilateral_gray_self``: a CPU tensor
    runs :func:`bilateral_gray_self_plain`; a CUDA tensor launches the
    kernel."""
    if isinstance(x, torch.Tensor) and x.dtype not in (torch.uint8,
                                                       torch.float32):
        raise TypeError("x must be uint8 levels or float32, got {}".format(
            x.dtype))
    _build.check_tensor(x, "x", x.dtype, 3)
    if x.device.type != "cpu":
        _build.require_cuda(x, "bilateral_gray_self")
    return torch.ops.rf.bilateral_gray_self(x, int(d), float(sigma_color),
                                            float(sigma_space), int(reps))


bilateral_gray_self.launches = 0
