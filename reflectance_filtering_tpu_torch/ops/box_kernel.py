"""K4: the separable box filter over planes (csrc/box_filter.cu), its plain
PyTorch version and its wrapper.

Port of reflectance_filtering_tpu/ops/box_pallas.py::box_filter_pallas
(and ::box_filter_fused, the same function tiled for the TPU): x [B, H, W]
float32 -> the (2r+1)^2 window mean (or sum, ``normalize=False``) of each
plane, with BORDER_REFLECT ("reflect") or BORDER_REFLECT_101
("reflect101") borders.  The plain version is the block-local sliding sum
of ops/boxfilter.py in float32; the kernel sums in float64 (a sliding
column window, then each row's prefix sums) and rounds once, so the two
agree to float32 rounding of sums bounded by 512 * w * max|x|.
"""
from __future__ import annotations

import torch

from . import _build
from .boxfilter import box_filter_axes, check_border

_GRID_LIMIT = 65535
ROW_WARPS = 8              # rows a row block of the kernel takes, at most
SMEM_LIMIT = 227 * 1024    # shared memory one H100 block can take
FUSED_WIDEST = 512         # the fused form: a thread per column, at most
PATHS = {"auto": 0, "two-pass": 1, "fused": 2}


def fused_band(planes: int, h: int, sms: int = 132) -> int:
    """Output rows per fused block (``fused_band`` in csrc/box_filter.cu,
    the SM count read from the device there): the tallest of 64, 32 and 16
    rows whose grid of planes x ceil(h / band) blocks gives every SM two,
    else 8."""
    for band in (64, 32, 16):
        if planes * -(-h // band) >= 2 * sms:
            return band
    return 8


def fused_path(w: int, path: str = "auto") -> bool:
    """Whether a call takes the fused form: by shape, rows up to
    :data:`FUSED_WIDEST` wide; or as ``path`` forces it."""
    return w <= FUSED_WIDEST if path == "auto" else path == "fused"


def row_warps(w: int) -> int:
    """Rows (a warp each) a block of the kernel's row pass takes
    (``row_warps`` in csrc/box_filter.cu): ROW_WARPS where their prefix
    buffers, w + 1 doubles a row, fit a block's shared memory, fewer for
    wide rows, 0 where one row's does not (the buffers then live in a
    device-memory scratch)."""
    return min(SMEM_LIMIT // ((w + 1) * 8), ROW_WARPS)


def box_filter_planar_plain(x: torch.Tensor, radius: int,
                            border: str = "reflect",
                            normalize: bool = True) -> torch.Tensor:
    """Plain version of K4: the block-local sliding sum over axes 1, 2."""
    return box_filter_axes(x, radius, (1, 2), border, normalize)


def box_filter_planar(x: torch.Tensor, radius: int, border: str = "reflect",
                      normalize: bool = True, path: str = "auto",
                      band: int = 0) -> torch.Tensor:
    """Box filter of each plane of x [B, H, W] float32.

    A CPU tensor runs :func:`box_filter_planar_plain`; a CUDA tensor
    launches the kernel: its fused form for rows up to
    :data:`FUSED_WIDEST` wide, else its two passes (:func:`fused_path`);
    ``path`` "fused" or "two-pass" forces one and ``band`` sets the fused
    blocks' rows (0: :func:`fused_band`'s rule), for the tests and the
    measurements.  radius 0 returns x itself, as the JAX filter does."""
    _build.check_tensor(x, "x", torch.float32, 3)
    check_border(border)
    if radius < 0:
        raise ValueError("radius must be >= 0, got {}".format(radius))
    if path not in PATHS:
        raise ValueError("path must be one of {}, got {!r}".format(
            sorted(PATHS), path))
    if x.device.type == "cpu":
        return box_filter_planar_plain(x, radius, border, normalize)
    _build.require_cuda(x, "box_filter_planar")
    if radius == 0:
        return x
    b, h, w = x.shape
    if b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError("box_filter_planar: {} planes of {} rows exceed the "
                         "kernel's grid limit of {}".format(b, h, _GRID_LIMIT))
    fused = fused_path(w, path)
    if fused and w > FUSED_WIDEST:
        raise ValueError("box_filter_planar: the fused form takes rows up to "
                         "{} wide, not {}".format(FUSED_WIDEST, w))
    out = torch.empty_like(x)
    if out.numel():
        tmp = scratch = None
        if not fused:
            tmp = torch.empty_like(x)
            if row_warps(w) == 0:
                scratch = torch.empty(b * h * (w + 1), dtype=torch.float64,
                                      device=x.device)
        _build.launch("rf_box_filter", x.device, x.data_ptr(), out.data_ptr(),
                      None if tmp is None else tmp.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), b, h,
                      w, radius, int(border == "reflect101"), int(normalize),
                      PATHS[path], band)
        _build.count(box_filter_planar)
        if fused:
            _build.count(box_filter_planar, "fused_launches")
    return out


box_filter_planar.launches = 0
box_filter_planar.fused_launches = 0
