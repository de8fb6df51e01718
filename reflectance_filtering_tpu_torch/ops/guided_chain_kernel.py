"""K9: the iterated guided-filter chain with the guide statistics computed
once (csrc/guided_chain.cu), its plain PyTorch versions and its wrappers.

Port of reflectance_filtering_tpu/ops/guided_pallas.py::
guided_filter_fused_iterated (the Zoran-style "3x iterated GF" of the JAX
bench's config 4) with its kernels' calls ``_stats_call``, ``_apply_call``,
``_stage2_call`` (the banded branch) and ``_fused_iter1_call``,
``_fused_apply_call`` (the band-dot branch).  guide [N, 3, H, W] and src
[N, C, H, W] float32 in guide-value units; ``iterations`` times, src <-
the guided filter of src with the guide (BORDER_REFLECT box means, the
cofactor solve of ops/guided_kernel.py).  What depends only on the guide,
radius and eps is computed once per call and reused by every application
and src channel: the 9 planes [mI0 mI1 mI2 | d00 d01 d02 d11 d12 d22],
d = cofactor * (1 / det), as the band-dot branch stores them.  Nothing is
cached across calls.

The plain versions compute the same with the plain box (ops/boxfilter.py);
the kernel sums its windows in float64, so the two agree to the plain
box's float32 rounding, not bitwise.

On CUDA each column-then-row pair runs as one fused kernel where the
shape fits its shared memory (:func:`fused_route`; the radius bounds it:
about 100 for the statistics, 200 for an application at C = 1), else as
two passes through scratch column sums.
``.launches`` counts the wrappers' launches and ``.fused`` those that took
the fused kernels.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import _build
from .box_kernel import box_filter_planar_plain
from .guided_kernel import (box_planes, by_channel_groups, check_grid,
                            check_guided, guide_cofactors, guide_products,
                            guided_apply)

STAT_PLANES = 9


def guide_stats_plain(guide: torch.Tensor, radius: int, eps) -> torch.Tensor:
    """Plain version of :func:`guide_stats`: guide [N, 3, H, W] -> the 9
    stat planes [N, 9, H, W]."""
    m = box_planes(torch.cat([guide, guide_products(guide)], dim=1), radius,
                   box_filter_planar_plain)
    cof, inv_det = guide_cofactors(m[:, :3], m[:, 3:], float(eps))
    d = torch.stack([c * inv_det for c in cof], dim=1)
    return torch.cat([m[:, :3], d], dim=1)


def guided_apply_cached_plain(stats: torch.Tensor, guide: torch.Tensor,
                              src: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of :func:`guided_apply_cached`: one guided filter of
    src [N, C, H, W] from the guide's cached statistics."""
    n, c, h, w = src.shape
    Ip = (guide[:, :, None] * src[:, None]).reshape(n, 3 * c, h, w)
    m = box_planes(torch.cat([src, Ip], dim=1), radius,
                   box_filter_planar_plain)
    mean_p = m[:, :c]
    mi = [stats[:, k:k + 1] for k in range(3)]
    d00, d01, d02, d11, d12, d22 = (stats[:, k:k + 1] for k in range(3, 9))
    cov0, cov1, cov2 = (m[:, c * (1 + k):c * (2 + k)] - mi[k] * mean_p
                        for k in range(3))
    a0 = d00 * cov0 + d01 * cov1 + d02 * cov2
    a1 = d01 * cov0 + d11 * cov1 + d12 * cov2
    a2 = d02 * cov0 + d12 * cov1 + d22 * cov2
    b = mean_p - a0 * mi[0] - a1 * mi[1] - a2 * mi[2]
    return guided_apply(box_planes(torch.cat([a0, a1, a2, b], dim=1), radius,
                                   box_filter_planar_plain), guide)


def guided_filter_chain_plain(guide: torch.Tensor, src: torch.Tensor,
                              radius: int, eps,
                              iterations: int = 3) -> torch.Tensor:
    """Plain version of :func:`guided_filter_chain`."""
    if iterations <= 0:
        return src
    stats = guide_stats_plain(guide, radius, eps)
    for _ in range(iterations):
        src = guided_apply_cached_plain(stats, guide, src, radius)
    return src


PLAN_FIELDS = ("ok", "cluster", "columns", "band_rows", "tile", "rows",
               "ring", "smem")
_plans = {}  # (device index, pass, c, n, h, w, radius, seg) -> plan


def fused_plan(device: torch.device, pass_: int, c: int, n: int, h: int,
               w: int, radius: int, seg: int = 0) -> dict:
    """The plan of K9's fused pass ``pass_`` (6 the statistics, 7 the
    solve, 8 the apply; ``rf_guided_chain_plan``) at ``c`` <= 3 channels
    on ``device`` for n images of h x w at ``radius``, blocks of ``seg``
    rows (0: the plan's): {"ok": the fused kernel takes the shape,
    "cluster": blocks a cluster, "columns": column sums a block,
    "band_rows", "tile": output columns a cluster, "rows": a block's rows,
    "ring": the ring's slots, "smem": bytes a block}; kept per shape."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    key = (index, pass_, c, n, h, w, radius, seg)
    if key not in _plans:
        out = (ctypes.c_int * len(PLAN_FIELDS))()
        handle = _build.lib()
        with torch.cuda.device(index):
            rc = handle.rf_guided_chain_plan(pass_, c, n, h, w, radius, seg,
                                             ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError("rf_guided_chain_plan failed: CUDA error {} "
                               "({})".format(rc, handle.rf_error_string(rc)
                                             .decode()))
        _plans[key] = dict(zip(PLAN_FIELDS, out))
    return _plans[key]


def fused_route(device: torch.device, stage: int, c: int, n: int, h: int,
                w: int, radius: int) -> bool:
    """Whether :func:`guide_stats` (stage 0) or one launch of
    :func:`guided_apply_cached` on ``c`` <= 3 channels (stage 1) takes
    K9's fused kernels: where their plans (:func:`fused_plan`, the
    kernel's own choice by shape and the device's shared memory and
    clusters) take the shape, as the entry points decide."""
    passes = (6,) if stage == 0 else (7, 8)
    return all(fused_plan(device, p, c, n, h, w, radius)["ok"]
               for p in passes)


def guide_stats(guide: torch.Tensor, radius: int, eps) -> torch.Tensor:
    """The guide's statistics for :func:`guided_apply_cached`: guide
    [N, 3, H, W] float32 -> [N, 9, H, W] = [mI0 mI1 mI2 | d00 d01 d02 d11
    d12 d22].  A CPU tensor runs :func:`guide_stats_plain`; a CUDA tensor
    launches the kernel's statistics: the fused kernel where
    :func:`fused_route` says so, else two passes through scratch column
    sums."""
    check_guided(guide, radius)
    if guide.device.type == "cpu":
        return guide_stats_plain(guide, radius, eps)
    _build.require_cuda(guide, "guide_stats")
    n, _, h, w = guide.shape
    check_grid("guide_stats", n, h, w, 1)
    stats = torch.empty((n, STAT_PLANES, h, w), dtype=torch.float32,
                        device=guide.device)
    if stats.numel():
        fused = fused_route(guide.device, 0, 1, n, h, w, radius)
        mom = None if fused else torch.empty_like(stats)
        _build.launch("rf_guide_stats", guide.device, guide.data_ptr(),
                      stats.data_ptr(), None if fused else mom.data_ptr(), n,
                      h, w, radius, float(eps))
        _build.count(guide_stats)
        if fused:
            _build.count(guide_stats, "fused")
    return stats


def guided_apply_cached(stats: torch.Tensor, guide: torch.Tensor,
                        src: torch.Tensor, radius: int) -> torch.Tensor:
    """One guided filter of src [N, C, H, W] float32 with the guide's
    statistics ``stats`` (from :func:`guide_stats` with the same guide and
    radius) -> [N, C, H, W].  A CPU tensor runs
    :func:`guided_apply_cached_plain`; a CUDA tensor launches the kernel's
    application (two fused kernels where :func:`fused_route` says so, else
    four passes), src channels in groups of at most three (one launch
    each)."""
    check_guided(guide, radius, (("stats", stats), ("src", src)))
    if stats.shape[1] != STAT_PLANES:
        raise ValueError("stats must have {} planes, got {}".format(
            STAT_PLANES, stats.shape[1]))
    if guide.device.type == "cpu":
        return guided_apply_cached_plain(stats, guide, src, radius)
    _build.require_cuda(guide, "guided_apply_cached")
    n, c, h, w = src.shape
    group = min(c, 3)
    check_grid("guided_apply_cached", n, h, w, 4 * group)
    if not src.numel():
        return torch.empty_like(src)
    fused = {k: fused_route(src.device, 1, k, n, h, w, radius)
             for k in {min(3, c - g) for g in range(0, c, 3)}}
    ab = torch.empty((n, 4 * group, h, w), dtype=torch.float32,
                     device=src.device)
    mom = None if all(fused.values()) else torch.empty_like(ab)

    def launch(s, o):
        k = s.shape[1]
        _build.launch("rf_guided_apply_cached", src.device, stats.data_ptr(),
                      guide.data_ptr(), s.data_ptr(), o.data_ptr(),
                      None if fused[k] else mom.data_ptr(), ab.data_ptr(), n,
                      k, h, w, radius)
        _build.count(guided_apply_cached)
        if fused[k]:
            _build.count(guided_apply_cached, "fused")

    return by_channel_groups(src, launch)


def guided_filter_chain(guide: torch.Tensor, src: torch.Tensor, radius: int,
                        eps, iterations: int = 3) -> torch.Tensor:
    """``iterations`` guided filters of src [N, C, H, W] with the guide
    [N, 3, H, W] (float32), the guide's statistics computed once:
    K9 on CUDA, the plain versions on the CPU.  iterations <= 0 returns
    src."""
    if iterations <= 0:
        return src
    # the issue up to the first launch, which the card waits for; the
    # applications' launches overlap the statistics pass on the card
    with span("guided.stats"):
        stats = guide_stats(guide, radius, eps)
    for _ in range(iterations):
        src = guided_apply_cached(stats, guide, src, radius)
    return src


guide_stats.launches = 0
guide_stats.fused = 0
guided_apply_cached.launches = 0
guided_apply_cached.fused = 0
