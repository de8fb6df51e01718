"""K3: the WHDR point-pair gather and K8: its backward scatter-add
(csrc/whdr_gather.cu), their plain PyTorch versions and their wrappers.

Port of reflectance_filtering_tpu/ops/whdr_gather_pallas.py::gather_pairs:
plane [B, H, W] float32 and int32 indices [B, K], already clipped into
range -> (l1, l2) [B, K].  The forward kernel copies values, so it is
bitwise equal to indexing.  ``gather_pairs`` is differentiable with respect
to the plane: its backward is :func:`scatter_pairs` (K8 on CUDA), which sums
the cotangents of all points that read the same pixel, in a fixed order.

At 32 x 1,181 comparisons K3 runs ~2 us on the card, so a call costs its
host path: the checks in one pass, one [2, B, K] allocation whose rows are
l1 and l2, and one ctypes launch (``_build.launch``); the wrapper keeps
each short, so that the call costs less host time than one indexing call.
K8's wrapper takes the same path: its six tensors checked in one pass, one
allocation, one launch.

Where no gradient is wanted, :func:`whdr_scores` scores a whole batch in
one launch beside K3 (``rf_whdr_scores``): the indices, the gather, the
classification and the sums that ``losses/whdr.py`` otherwise composes
from K3 and ~35 ATen launches (a served batch's WHDR, whose host time the
benchmark's ``whdr_issue_ms`` reads).  Its wrapper takes K3's short host
path; its plain version is that composition (``whdr_per_image(...,
kernels=False)``).

K8 runs one of two kernels, chosen by shape (:func:`sort_path`): up to
``SORT_MAX_POINTS`` points an image, each image's pixels are cut into
bands, one block a band (as many as fill the SMs once, at most 8), and a
block sorts the points that read its band by (pixel, comparison order) in
a bitonic network; above, the quadratic search, which
:func:`_scatter_quadratic` also runs at any K for tests and timings.  Both
give the same bits.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build


def gather_pairs_plain(plane: torch.Tensor, y1: torch.Tensor,
                       x1: torch.Tensor, y2: torch.Tensor, x2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: advanced indexing."""
    bidx = torch.arange(plane.shape[0], device=plane.device)[:, None]
    return (plane[bidx, y1.long(), x1.long()],
            plane[bidx, y2.long(), x2.long()])


def scatter_pairs_plain(shape: Sequence[int], y1: torch.Tensor,
                        x1: torch.Tensor, y2: torch.Tensor, x2: torch.Tensor,
                        g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: ``index_put_(accumulate=True)`` of both points'
    cotangents into a zero plane of ``shape`` [B, H, W]."""
    out = torch.zeros(tuple(shape), dtype=torch.float32, device=g1.device)
    bidx = torch.arange(shape[0], device=g1.device)[:, None].expand_as(y1)
    index = (torch.cat([bidx, bidx], dim=1),
             torch.cat([y1, y2], dim=1).long(),
             torch.cat([x1, x2], dim=1).long())
    return out.index_put_(index, torch.cat([g1, g2], dim=1), accumulate=True)


# points an image (2K) up to which K8 sorts them in one block (kSortMax in
# csrc/whdr_gather.cu)
SORT_MAX_POINTS = 16384

_INDEX_ARGS = tuple((name, torch.int32) for name in ("y1", "x1", "y2", "x2"))
_SCATTER_ARGS = _INDEX_ARGS + (("g1", torch.float32), ("g2", torch.float32))


def _check_indices(plane_shape, device, tensors, args=_INDEX_ARGS) -> None:
    """Raise unless ``tensors`` (named and typed by ``args``: the four
    indices, int32, and for K8 the two cotangents, float32) are contiguous
    [B, K] tensors of one shape, with the plane's B, on ``device``: one
    pass, whose common case is a few attribute reads per tensor (the
    messages come from ``check_tensor``)."""
    shape = tensors[0].shape if isinstance(tensors[0], torch.Tensor) else None
    for (name, dtype), t in zip(args, tensors):
        if not (isinstance(t, torch.Tensor) and t.dtype == dtype
                and t.dim() == 2 and t.is_contiguous()):
            _build.check_tensor(t, name, dtype, 2)
        if t.shape != shape or shape[0] != plane_shape[0]:
            raise ValueError("indices and cotangents must all be [B, K] with "
                             "B = {}, got {} for {}".format(
                                 plane_shape[0], tuple(t.shape), name))
        if t.device != device:
            raise ValueError("indices, cotangents and plane must share a "
                             "device")


def sort_path(k: int) -> bool:
    """Whether K8 takes its sort path for K comparisons an image (the
    kernel's own rule, by shape only)."""
    return 2 * k <= SORT_MAX_POINTS


def _gather(plane: torch.Tensor, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l1, l2): on CUDA, the two rows of one [2, B, K] allocation."""
    if not plane.is_cuda:
        if plane.device.type == "cpu":
            return gather_pairs_plain(plane, *idx)
        _build.require_cuda(plane, "gather_pairs")
    b, h, w = plane.shape
    k = idx[0].shape[1]
    out = plane.new_empty((2, b, k))
    if b * k:
        ptr = out.data_ptr()
        _build.launch("rf_whdr_gather", plane.device, plane.data_ptr(),
                      idx[0].data_ptr(), idx[1].data_ptr(),
                      idx[2].data_ptr(), idx[3].data_ptr(), ptr,
                      ptr + 4 * b * k, b, h, w, k)
        _build.count(gather_pairs)
    return out.unbind(0)


def _scatter(shape: Sequence[int], tensors, entry: str) -> torch.Tensor:
    b, h, w = (int(v) for v in shape)
    g1 = tensors[4]
    _check_indices((b, h, w), g1.device, tensors, _SCATTER_ARGS)
    if g1.device.type == "cpu":
        return scatter_pairs_plain((b, h, w), *tensors)
    _build.require_cuda(g1, "scatter_pairs")
    out = torch.empty((b, h, w), dtype=torch.float32, device=g1.device)
    if out.numel():
        _build.launch(entry, g1.device, *(t.data_ptr() for t in tensors),
                      out.data_ptr(), b, h, w, tensors[0].shape[1])
        _build.count(scatter_pairs)
    return out


def scatter_pairs(shape: Sequence[int], y1: torch.Tensor, x1: torch.Tensor,
                  y2: torch.Tensor, x2: torch.Tensor, g1: torch.Tensor,
                  g2: torch.Tensor) -> torch.Tensor:
    """The backward of :func:`gather_pairs`: dplane [B, H, W] with
    dplane[b, y, x] = the sum of g1[b, k] over the k whose point 1 is
    (y, x) plus the same for g2 and point 2.

    A CPU tensor runs :func:`scatter_pairs_plain`; a CUDA tensor launches
    K8, which sums each pixel's cotangents in comparison order with no
    float atomic (bitwise repeatable), by the kernel :func:`sort_path`
    picks."""
    return _scatter(shape, (y1, x1, y2, x2, g1, g2), "rf_whdr_scatter")


def _scatter_quadratic(shape: Sequence[int], y1: torch.Tensor,
                       x1: torch.Tensor, y2: torch.Tensor, x2: torch.Tensor,
                       g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_pairs` through K8's quadratic search at any K (the
    tests and timings that hold the sort path against it); counted in
    ``scatter_pairs.launches``."""
    return _scatter(shape, (y1, x1, y2, x2, g1, g2),
                    "rf_whdr_scatter_quadratic")


scatter_pairs.launches = 0


class _GatherPairs(torch.autograd.Function):
    """K3 going forward, K8 going back (each dispatching on the device)."""

    @staticmethod
    def forward(ctx, plane, y1, x1, y2, x2):
        ctx.save_for_backward(y1, x1, y2, x2)
        ctx.plane_shape = tuple(plane.shape)
        return _gather(plane, (y1, x1, y2, x2))

    @staticmethod
    def backward(ctx, g1: Optional[torch.Tensor], g2: Optional[torch.Tensor]):
        y1, x1, y2, x2 = ctx.saved_tensors
        ref = g1 if g1 is not None else g2
        g1 = torch.zeros_like(ref) if g1 is None else g1.contiguous()
        g2 = torch.zeros_like(ref) if g2 is None else g2.contiguous()
        dplane = scatter_pairs(ctx.plane_shape, y1, x1, y2, x2,
                               g1.to(torch.float32), g2.to(torch.float32))
        return dplane, None, None, None, None


def gather_pairs(plane: torch.Tensor, y1: torch.Tensor, x1: torch.Tensor,
                 y2: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """l1[b, k] = plane[b, y1[b, k], x1[b, k]], l2 likewise from (y2, x2).

    A CPU tensor runs :func:`gather_pairs_plain`; a CUDA tensor launches
    K3.  When the plane requires grad the call is differentiable, with
    :func:`scatter_pairs` as its backward."""
    if not (isinstance(plane, torch.Tensor) and plane.dtype == torch.float32
            and plane.dim() == 3 and plane.is_contiguous()):
        _build.check_tensor(plane, "plane", torch.float32, 3)
    idx = (y1, x1, y2, x2)
    _check_indices(plane.shape, plane.device, idx)
    if plane.requires_grad and torch.is_grad_enabled():
        return _GatherPairs.apply(plane, *idx)
    return _gather(plane, idx)


gather_pairs.launches = 0


def whdr_scores(plane: torch.Tensor, comparisons: torch.Tensor,
                delta: float) -> torch.Tensor:
    """Each image's exact WHDR [B] float32 from the lightness plane [B, H,
    W] float32 and the packed comparisons [B, K+1, 6] float32 (rows [x1,
    y1, x2, y2, darker, weight], the last row's first value the count of
    valid rows), both contiguous on one CUDA device: one launch, with the
    classes taken against the float32 threshold ``1 + delta``, as the
    composition in ``losses/whdr.py`` compares.  Differentiable it is not;
    the caller takes the composition where a gradient is wanted, and on the
    CPU.  Nothing here waits for the card."""
    if not (isinstance(plane, torch.Tensor) and plane.dtype == torch.float32
            and plane.dim() == 3 and plane.is_contiguous()):
        _build.check_tensor(plane, "plane", torch.float32, 3)
    if not (isinstance(comparisons, torch.Tensor)
            and comparisons.dtype == torch.float32
            and comparisons.dim() == 3 and comparisons.is_contiguous()):
        _build.check_tensor(comparisons, "comparisons", torch.float32, 3)
    b, h, w = plane.shape
    _, k1, cols = comparisons.shape
    if comparisons.shape[0] != b or k1 < 1 or cols != 6 or not h * w:
        raise ValueError("whdr_scores takes a plane [B, H, W] with H, W >= 1 "
                         "and comparisons [B, K+1, 6], got {} and {}".format(
                             tuple(plane.shape), tuple(comparisons.shape)))
    if comparisons.device != plane.device or plane.device.type != "cuda":
        raise ValueError("whdr_scores: plane and comparisons must share one "
                         "CUDA device (the CPU takes whdr_per_image's "
                         "composition), got {} and {}".format(
                             plane.device, comparisons.device))
    out = plane.new_empty((b,))
    if b:
        _build.launch("rf_whdr_scores", plane.device, plane.data_ptr(),
                      comparisons.data_ptr(), out.data_ptr(), b, h, w,
                      k1 - 1, 1.0 + delta)
        _build.count(whdr_scores)
    return out


whdr_scores.launches = 0
