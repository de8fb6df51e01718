"""K3: the WHDR point-pair gather (csrc/whdr_gather.cu), its plain
PyTorch version and its wrapper.

Port of reflectance_filtering_tpu/ops/whdr_gather_pallas.py::gather_pairs
(forward): plane [B, H, W] float32 and int32 indices [B, K], already
clipped into range -> (l1, l2) [B, K].  The kernel copies values, so it is
bitwise equal to indexing.  The backward scatter-add is training work
(ROADMAP kernel queue item 6); on CUDA the wrapper refuses a plane that
requires grad rather than differentiate through the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build


def gather_pairs_plain(plane: torch.Tensor, y1: torch.Tensor,
                       x1: torch.Tensor, y2: torch.Tensor, x2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: advanced indexing."""
    bidx = torch.arange(plane.shape[0], device=plane.device)[:, None]
    return (plane[bidx, y1.long(), x1.long()],
            plane[bidx, y2.long(), x2.long()])


def gather_pairs(plane: torch.Tensor, y1: torch.Tensor, x1: torch.Tensor,
                 y2: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """l1[b, k] = plane[b, y1[b, k], x1[b, k]], l2 likewise from (y2, x2).

    A CPU tensor runs :func:`gather_pairs_plain`; a CUDA tensor launches
    the kernel."""
    _build.check_tensor(plane, "plane", torch.float32, 3)
    idx = (y1, x1, y2, x2)
    for name, t in zip(("y1", "x1", "y2", "x2"), idx):
        _build.check_tensor(t, name, torch.int32, 2)
        if t.shape != y1.shape or t.shape[0] != plane.shape[0]:
            raise ValueError("indices must all be [B, K] with B = {}, got "
                             "{} for {}".format(plane.shape[0],
                                                tuple(t.shape), name))
        if t.device != plane.device:
            raise ValueError("indices and plane must share a device")
    if plane.device.type == "cpu":
        return gather_pairs_plain(plane, *idx)
    _build.require_cuda(plane, "gather_pairs")
    if plane.requires_grad:
        raise NotImplementedError(
            "gather_pairs on CUDA has no backward kernel yet (ROADMAP kernel "
            "queue item 6); detach the plane")
    b, h, w = plane.shape
    k = y1.shape[1]
    l1 = torch.empty((b, k), dtype=torch.float32, device=plane.device)
    l2 = torch.empty_like(l1)
    if l1.numel():
        _build.launch("rf_whdr_gather", plane.device, plane.data_ptr(),
                      y1.data_ptr(), x1.data_ptr(), y2.data_ptr(),
                      x2.data_ptr(), l1.data_ptr(), l2.data_ptr(), b, h, w, k)
        gather_pairs.launches += 1
    return l1, l2


gather_pairs.launches = 0
