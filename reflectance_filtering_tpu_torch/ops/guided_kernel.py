"""K5: the color-guide guided filter (csrc/guided.cu), its plain PyTorch
version and its wrapper.

Port of reflectance_filtering_tpu/ops/guided_mxu.py::guided_filter_mxu
(any src channel count) and ops/guided_pallas.py::guided_filter_fused (one
src channel), which compute the same function: guide [N, 3, H, W] and src
[N, C, H, W] float32 in guide-value units (0-255 for the product) ->
[N, C, H, W], with BORDER_REFLECT box means and eps in (0-255)^2 units.

The plain version is the JAX package's generic planar path
(``ops/guided.py::_guided_filter_color_planar``) over the plain box
(ops/boxfilter.py): one box pass over the 9 + 4C moment planes, the 3x3
cofactor solve, one box pass over (a0, a1, a2, b).  The kernel forms the
same moments and solve but sums its windows in float64, so the two agree
to the plain box's float32 rounding, not bitwise.  On the card the kernel
runs its fused pair (the moment planes kept in shared memory) wherever
that fits the frame's width (:func:`fused_fits`), else its four passes;
:func:`fused_path` mirrors the choice.

The wrapper runs the ``torch.library`` operator ``rf::guided_filter`` (the
gf serving artifact records it, utils/serving.py); the operator's body
allocates the kernel's workspaces and splits the channels into groups.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import _build
from .box_kernel import box_filter_planar_plain

_GRID_LIMIT = 65535
_INT_LIMIT = 2 ** 31 - 1
GUIDE_PLANES = 9          # I0 I1 I2 and the 6 unique I_i I_j
# the fused kernels (csrc/guided.cu): threads a block, the widest frame
# they serve by shape, a block's shared-memory limit on an H100
FUSED_WIDEST = 512        # a thread per column, at most
SMEM_LIMIT = 227 * 1024
PATHS = {"auto": 0, "four-pass": 1, "fused": 2}
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))

Box = Callable[[torch.Tensor, int], torch.Tensor]


def box_planes(x: torch.Tensor, radius: int, box: Box) -> torch.Tensor:
    """The box mean of each plane of x [N, K, H, W]."""
    n, k, h, w = x.shape
    return box(x.reshape(n * k, h, w).contiguous(), radius).reshape(
        n, k, h, w)


def guide_products(I: torch.Tensor) -> torch.Tensor:
    """The 6 unique products I_a I_b of the guide I [N, 3, H, W]."""
    return torch.stack([I[:, a] * I[:, b] for a, b in _PAIRS], dim=1)


def guide_cofactors(mean_I: torch.Tensor, m: torch.Tensor, eps):
    """The cofactors (c00, c01, c02, c11, c12, c22) of V = mean(I I^T) -
    mI mI^T + eps Id and 1 / det(V), from mean_I [N, 3, H, W] and the box
    means m [N, 6, H, W] of :func:`guide_products`."""
    rr = m[:, 0] - mean_I[:, 0] * mean_I[:, 0] + eps
    rg = m[:, 1] - mean_I[:, 0] * mean_I[:, 1]
    rb = m[:, 2] - mean_I[:, 0] * mean_I[:, 2]
    gg = m[:, 3] - mean_I[:, 1] * mean_I[:, 1] + eps
    gb = m[:, 4] - mean_I[:, 1] * mean_I[:, 2]
    bb = m[:, 5] - mean_I[:, 2] * mean_I[:, 2] + eps

    c00 = gg * bb - gb * gb
    c01 = gb * rb - rg * bb
    c02 = rg * gb - gg * rb
    c11 = rr * bb - rb * rb
    c12 = rb * rg - rr * gb
    c22 = rr * gg - rg * rg
    inv_det = 1.0 / (rr * c00 + rg * c01 + rb * c02)
    return (c00, c01, c02, c11, c12, c22), inv_det


def guided_ab_means(I: torch.Tensor, p: torch.Tensor, radius: int, eps,
                    box: Box) -> torch.Tensor:
    """The box means of the guided filter's coefficients: I [N, 3, H, W],
    p [N, C, H, W] -> [N, 4C, H, W] = [mean(a0) | mean(a1) | mean(a2) |
    mean(b)], each C planes; ``box(x [B, H, W], radius)`` is the box mean
    (the JAX package's ``_guided_filter_color_planar``, :118-175)."""
    n, _, h, w = I.shape
    c = p.shape[1]
    # one box pass over all first/second-moment planes:
    # [I (3) | p (C) | I*p (3C) | unique I x I (6)]
    Ip = (I[:, :, None] * p[:, None]).reshape(n, 3 * c, h, w)
    moments = box_planes(torch.cat([I, p, Ip, guide_products(I)], dim=1),
                         radius, box)
    mean_I = moments[:, 0:3]
    mean_p = moments[:, 3:3 + c]
    cov_Ip = moments[:, 3 + c:3 + 4 * c].reshape(n, 3, c, h, w)
    cov_Ip = cov_Ip - mean_I[:, :, None] * mean_p[:, None]
    (c00, c01, c02, c11, c12, c22), inv_det = guide_cofactors(
        mean_I, moments[:, 3 + 4 * c:], eps)

    cov0, cov1, cov2 = cov_Ip[:, 0], cov_Ip[:, 1], cov_Ip[:, 2]  # [N,C,H,W]
    a0 = (c00[:, None] * cov0 + c01[:, None] * cov1 +
          c02[:, None] * cov2) * inv_det[:, None]
    a1 = (c01[:, None] * cov0 + c11[:, None] * cov1 +
          c12[:, None] * cov2) * inv_det[:, None]
    a2 = (c02[:, None] * cov0 + c12[:, None] * cov1 +
          c22[:, None] * cov2) * inv_det[:, None]
    b = mean_p - (a0 * mean_I[:, 0:1] + a1 * mean_I[:, 1:2] +
                  a2 * mean_I[:, 2:3])
    return box_planes(torch.cat([a0, a1, a2, b], dim=1), radius, box)


def guided_apply(means: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """q = mean(a) . I + mean(b) from :func:`guided_ab_means`' planes."""
    c = means.shape[1] // 4
    return (means[:, :c] * I[:, 0:1] + means[:, c:2 * c] * I[:, 1:2] +
            means[:, 2 * c:3 * c] * I[:, 2:3] + means[:, 3 * c:])


def guided_filter_fused_plain(guide: torch.Tensor, src: torch.Tensor,
                              radius: int, eps: float) -> torch.Tensor:
    """Plain version of K5: the generic planar path over the plain box."""
    return guided_apply(guided_ab_means(guide, src, radius, float(eps),
                                        box_filter_planar_plain), guide)


def check_guided(guide: torch.Tensor, radius: int, others=()) -> None:
    """Raise unless guide is a contiguous float32 [N, 3, H, W], each
    (name, tensor) of ``others`` a contiguous float32 [N, C, H, W] on the
    guide's device, and radius >= 0."""
    _build.check_tensor(guide, "guide", torch.float32, 4)
    n, k, h, w = guide.shape
    if k != 3:
        raise ValueError("guide must be [N, 3, H, W], got {}".format(
            tuple(guide.shape)))
    for name, t in others:
        _build.check_tensor(t, name, torch.float32, 4)
        if t.shape[0] != n or t.shape[2:] != guide.shape[2:]:
            raise ValueError("{} must be [N, C, H, W] with the guide's N, H, "
                             "W {}; got {}".format(name, (n, h, w),
                                                   tuple(t.shape)))
        if t.device != guide.device:
            raise ValueError("{} and guide must share a device".format(name))
    if radius < 0:
        raise ValueError("radius must be >= 0, got {}".format(radius))


def check_grid(wrapper: str, n: int, h: int, w: int, planes: int) -> None:
    """Raise unless n images of h x w with ``planes`` planes in their
    widest column pass fit the kernels' grids and int arguments: n, h and
    n * planes at most 65,535 (a row pass's grid is (columns, h, n), a
    column pass's (columns, at most h, n * planes)), w below 2^31."""
    if (n > _GRID_LIMIT or h > _GRID_LIMIT or n * planes > _GRID_LIMIT
            or w > _INT_LIMIT):
        raise ValueError("{}: {} images of {}x{} with {} planes each "
                         "exceed the kernel's grid limit of {} (or a width "
                         "of 2^31)".format(wrapper, n, h, w, planes,
                                           _GRID_LIMIT))


def fused_smem(planes: int, w: int) -> int:
    """Shared memory of a fused block over ``planes`` planes of rows of w
    (``fused_smem`` in csrc/guided.cu): the column sums and the row
    prefixes in float64, two buffers each, a column's planes padded to an
    odd count."""
    return 2 * (planes | 1) * (2 * w + 1) * 8


def fused_fits(c: int, w: int) -> bool:
    """Whether the fused kernels take ``c`` src channels on frames w wide
    (``fused_fits`` in csrc/guided.cu): a thread per column
    (:data:`FUSED_WIDEST`) and the stats-and-solve block (9 + 4c planes)
    within :data:`SMEM_LIMIT`."""
    return (w <= FUSED_WIDEST
            and fused_smem(GUIDE_PLANES + 4 * c, w) <= SMEM_LIMIT)


def fused_path(c: int, w: int, path: str = "auto") -> bool:
    """Whether a launch of ``c`` src channels on frames w wide takes the
    fused kernels (``guided_any`` in csrc/guided.cu): by shape, wherever
    they fit (they beat the four passes at every shape measured on an
    H100); or as ``path`` forces it."""
    return fused_fits(c, w) if path == "auto" else path == "fused"


def fused_band(n: int, c: int, h: int, w: int, sms: int = 132) -> int:
    """Output rows per fused block (``fused_band`` in csrc/guided.cu, the
    device's SM count read there): 32 where the grid of n x ceil(h / band)
    blocks fills at least 90% of the slots the solve kernel's shared memory
    leaves resident (per SM, at most 8), else 16 where that does, else
    8."""
    per_sm = (228 * 1024) // (fused_smem(GUIDE_PLANES + 4 * c, w) + 1024)
    slots = sms * min(max(per_sm, 1), 8)
    for band in (32, 16):
        if 10 * n * -(-h // band) >= 9 * slots:
            return band
    return 8


def by_channel_groups(src: torch.Tensor, launch) -> torch.Tensor:
    """out [N, C, H, W] from ``launch(s, o)`` on src's channels in groups
    of at most three (the kernels' templates take C = 1, 2 or 3)."""
    c = src.shape[1]
    out = torch.empty_like(src)
    for g in range(0, c, 3):
        s = src[:, g:g + 3].contiguous()
        o = out if c <= 3 else torch.empty_like(s)
        launch(s, o)
        if c > 3:
            out[:, g:g + 3] = o
    return out


@torch.library.custom_op("rf::guided_filter", mutates_args=(),
                         schema="(Tensor guide, Tensor src, int radius, "
                                "float eps, str path, int band) -> Tensor")
def _guided_filter_op(guide: torch.Tensor, src: torch.Tensor, radius: int,
                      eps: float, path: str, band: int) -> torch.Tensor:
    """K5 as an operator ``torch.export`` can trace: a CPU tensor runs
    :func:`guided_filter_fused_plain`, a CUDA tensor launches the kernel
    (its workspaces allocated here, so they are no inputs of a graph)."""
    if guide.device.type == "cpu":
        return guided_filter_fused_plain(guide, src, radius, eps)
    _build.require_cuda(guide, "guided_filter_fused")
    n, c, h, w = src.shape
    group = min(c, 3)
    check_grid("guided_filter_fused", n, h, w, 4 * group)
    # the widest group (most planes) is the last to fit the fused kernels
    fused = fused_path(group, w, path)
    if fused and not fused_fits(group, w):
        raise ValueError("guided_filter_fused: the fused kernels take frames "
                         "up to their shared memory's width, not {}".format(w))
    if not src.numel():
        return torch.empty_like(src)
    mom = None if fused else torch.empty((n, 9 + 4 * group, h, w),
                                         dtype=torch.float32,
                                         device=src.device)
    ab = torch.empty((n, 4 * group, h, w), dtype=torch.float32,
                     device=src.device)

    def launch(s, o):
        _build.launch("rf_guided_filter", src.device, guide.data_ptr(),
                      s.data_ptr(), o.data_ptr(),
                      None if mom is None else mom.data_ptr(), ab.data_ptr(),
                      n, s.shape[1], h, w, radius, float(eps), PATHS[path],
                      band)
        _build.count(guided_filter_fused)
        if fused_path(s.shape[1], w, path):
            _build.count(guided_filter_fused, "fused_launches")

    return by_channel_groups(src, launch)


@_guided_filter_op.register_fake
def _(guide, src, radius, eps, path, band):
    return torch.empty_like(src)


def guided_filter_fused(guide: torch.Tensor, src: torch.Tensor, radius: int,
                        eps: float, path: str = "auto",
                        band: int = 0) -> torch.Tensor:
    """Guided filter with a color guide: guide [N, 3, H, W], src
    [N, C, H, W] float32 -> [N, C, H, W].

    Runs the operator ``torch.ops.rf.guided_filter``: a CPU tensor runs
    :func:`guided_filter_fused_plain`; a CUDA tensor launches the kernel
    (src channels in groups of at most three, each group one kernel call
    that recomputes the guide's statistics).  The kernel takes its fused
    pair or its four passes by shape (:func:`fused_path`); ``path``
    "fused" or "four-pass" forces one (the tests and the measurements), and
    ``band`` sets the fused blocks' output rows (0: :func:`fused_band`'s
    rule)."""
    check_guided(guide, radius, (("src", src),))
    if path not in PATHS:
        raise ValueError("path must be one of {}, got {!r}".format(
            sorted(PATHS), path))
    if guide.device.type != "cpu":
        _build.require_cuda(guide, "guided_filter_fused")
    return torch.ops.rf.guided_filter(guide, src, int(radius), float(eps),
                                      path, int(band))


guided_filter_fused.launches = 0
guided_filter_fused.fused_launches = 0
