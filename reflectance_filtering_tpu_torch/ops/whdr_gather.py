"""K3: the WHDR point-pair gather and K8: its backward scatter-add
(csrc/whdr_gather.cu), their plain PyTorch versions and their wrappers.

Port of reflectance_filtering_tpu/ops/whdr_gather_pallas.py::gather_pairs:
plane [B, H, W] float32 and int32 indices [B, K], already clipped into
range -> (l1, l2) [B, K].  The forward kernel copies values, so it is
bitwise equal to indexing.  ``gather_pairs`` is differentiable with respect
to the plane: its backward is :func:`scatter_pairs` (K8 on CUDA), which sums
the cotangents of all points that read the same pixel, in a fixed order.
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


def _check_indices(plane_shape, device, idx) -> None:
    for name, t in zip(("y1", "x1", "y2", "x2"), idx):
        _build.check_tensor(t, name, torch.int32, 2)
        if t.shape != idx[0].shape or t.shape[0] != plane_shape[0]:
            raise ValueError("indices must all be [B, K] with B = {}, got "
                             "{} for {}".format(plane_shape[0],
                                                tuple(t.shape), name))
        if t.device != device:
            raise ValueError("indices and plane must share a device")


def _gather(plane: torch.Tensor, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    if plane.device.type == "cpu":
        return gather_pairs_plain(plane, *idx)
    _build.require_cuda(plane, "gather_pairs")
    b, h, w = plane.shape
    k = idx[0].shape[1]
    l1 = torch.empty((b, k), dtype=torch.float32, device=plane.device)
    l2 = torch.empty_like(l1)
    if l1.numel():
        _build.launch("rf_whdr_gather", plane.device, plane.data_ptr(),
                      *(t.data_ptr() for t in idx), l1.data_ptr(),
                      l2.data_ptr(), b, h, w, k)
        gather_pairs.launches += 1
    return l1, l2


def scatter_pairs(shape: Sequence[int], y1: torch.Tensor, x1: torch.Tensor,
                  y2: torch.Tensor, x2: torch.Tensor, g1: torch.Tensor,
                  g2: torch.Tensor) -> torch.Tensor:
    """The backward of :func:`gather_pairs`: dplane [B, H, W] with
    dplane[b, y, x] = the sum of g1[b, k] over the k whose point 1 is
    (y, x) plus the same for g2 and point 2.

    A CPU tensor runs :func:`scatter_pairs_plain`; a CUDA tensor launches
    K8, which sums each pixel's cotangents in comparison order with no
    float atomic (bitwise repeatable)."""
    idx = (y1, x1, y2, x2)
    b, h, w = (int(v) for v in shape)
    _check_indices((b, h, w), g1.device, idx)
    for name, t in (("g1", g1), ("g2", g2)):
        _build.check_tensor(t, name, torch.float32, 2)
        if t.shape != y1.shape or t.device != g1.device:
            raise ValueError("{} must be [B, K] like the indices".format(name))
    if g1.device.type == "cpu":
        return scatter_pairs_plain((b, h, w), *idx, g1, g2)
    _build.require_cuda(g1, "scatter_pairs")
    if b > 65535:
        raise ValueError("batch {} exceeds the kernel's grid limit of "
                         "65535".format(b))
    out = torch.empty((b, h, w), dtype=torch.float32, device=g1.device)
    if out.numel():
        _build.launch("rf_whdr_scatter", g1.device,
                      *(t.data_ptr() for t in idx), g1.data_ptr(),
                      g2.data_ptr(), out.data_ptr(), b, h, w, y1.shape[1])
        scatter_pairs.launches += 1
    return out


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
    _build.check_tensor(plane, "plane", torch.float32, 3)
    idx = (y1, x1, y2, x2)
    _check_indices(plane.shape, plane.device, idx)
    if plane.requires_grad and torch.is_grad_enabled():
        return _GatherPairs.apply(plane, *idx)
    return _gather(plane, idx)


gather_pairs.launches = 0
