"""K4: the separable box filter over planes (csrc/box_filter.cu), its plain
PyTorch version and its wrapper.

Port of reflectance_filtering_tpu/ops/box_pallas.py::box_filter_pallas
(and ::box_filter_fused, the same function tiled for the TPU): x [B, H, W]
float32 -> the (2r+1)^2 window mean (or sum, ``normalize=False``) of each
plane, with BORDER_REFLECT ("reflect") or BORDER_REFLECT_101
("reflect101") borders.  The plain version is the block-local sliding sum
of ops/boxfilter.py in float32; the kernel sums in float64 and rounds once,
so the two agree to float32 rounding of sums bounded by 512 * w * max|x|.
"""
from __future__ import annotations

import torch

from . import _build
from .boxfilter import box_filter_axes, check_border

_GRID_LIMIT = 65535


def box_filter_planar_plain(x: torch.Tensor, radius: int,
                            border: str = "reflect",
                            normalize: bool = True) -> torch.Tensor:
    """Plain version of K4: the block-local sliding sum over axes 1, 2."""
    return box_filter_axes(x, radius, (1, 2), border, normalize)


def box_filter_planar(x: torch.Tensor, radius: int, border: str = "reflect",
                      normalize: bool = True) -> torch.Tensor:
    """Box filter of each plane of x [B, H, W] float32.

    A CPU tensor runs :func:`box_filter_planar_plain`; a CUDA tensor
    launches the kernel.  radius 0 returns x itself, as the JAX filter
    does."""
    _build.check_tensor(x, "x", torch.float32, 3)
    check_border(border)
    if radius < 0:
        raise ValueError("radius must be >= 0, got {}".format(radius))
    if x.device.type == "cpu":
        return box_filter_planar_plain(x, radius, border, normalize)
    _build.require_cuda(x, "box_filter_planar")
    if radius == 0:
        return x
    b, h, w = x.shape
    if b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError("box_filter_planar: {} planes of {} rows exceed the "
                         "kernel's grid limit of {}".format(b, h, _GRID_LIMIT))
    out = torch.empty_like(x)
    if out.numel():
        tmp = torch.empty_like(x)
        _build.launch("rf_box_filter", x.device, x.data_ptr(), out.data_ptr(),
                      tmp.data_ptr(), b, h, w, radius,
                      int(border == "reflect101"), int(normalize))
        box_filter_planar.launches += 1
    return out


box_filter_planar.launches = 0
