"""WHDR metric (port of reflectance_filtering_tpu/losses/whdr.py:44-183).

Reference semantics (the reference's training/layers/whdr_layer.py):

  * exact Bell-2014 WHDR: per comparison classify l2/l1 > 1+delta ->
    darker 1, l1/l2 > 1+delta -> darker 2, else E(0); error = sum of
    weights where the human label disagrees; whdr = error_sum / weight_sum
    (0 if weight_sum == 0).
  * lightness L = max(float32_eps, mean(RGB)) for 3 channels, max(eps, r)
    for 1 channel.
  * normalized coords scaled by width/height and *truncated* to int.

The comparisons blob is the packed format [K+1, 6] per image: rows
[x1, y1, x2, y2, darker, weight] (normalized coords, NaN padded), last row
metadata [num_comparisons, ...].  The batched gather goes through
``ops.whdr_gather.gather_pairs`` (K3 on CUDA); classify and reduce are
plain torch.  The hinge loss family waits for the training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.whdr_gather import gather_pairs

EPS = np.float32(np.finfo(np.float32).eps)


def _indices(rows: torch.Tensor, valid: torch.Tensor, height: int,
             width: int):
    """Truncated, clipped int32 pixel coordinates and labels of the rows
    [..., K, 6]; invalid (padded) rows read as zeros."""
    safe = torch.where(valid[..., None], rows, torch.zeros_like(rows))

    def coord(col, n):
        return torch.clamp((safe[..., col] * n).to(torch.int32), 0, n - 1)

    return (coord(0, width), coord(1, height), coord(2, width),
            coord(3, height), safe[..., 4].to(torch.int32), safe[..., 5])


def comparisons_to_pixel_indices(comparisons: torch.Tensor, height: int,
                                 width: int):
    """Split a [K+1, 6] padded comparisons blob into gather-ready pieces.

    Returns (x1, y1, x2, y2, darker, weight, valid_mask, num_comparisons)
    where coordinates are int32 pixel indices clamped into bounds.
    """
    num = comparisons[-1, 0].to(torch.int32)
    rows = comparisons[:-1]
    valid = torch.arange(rows.shape[0], device=rows.device) < num
    x1, y1, x2, y2, darker, weight = _indices(rows, valid, height, width)
    return x1, y1, x2, y2, darker, weight, valid, num


def _floor_eps(lightness: torch.Tensor) -> torch.Tensor:
    return torch.clamp(lightness, min=float(EPS))


def _classify_error(l1, l2, darker, weight, valid, delta: float):
    """Per-comparison-set error and weight sums over the last axis."""
    alg = torch.where(l2 / l1 > 1 + delta, 1,
                      torch.where(l1 / l2 > 1 + delta, 2, 0))
    zero = torch.zeros_like(weight)
    err = torch.where(valid & (alg != darker), weight, zero).sum(dim=-1)
    wsum = torch.where(valid, weight, zero).sum(dim=-1)
    return torch.where(wsum > 0, err / wsum, torch.zeros_like(wsum))


def whdr(reflectance: torch.Tensor, comparisons: torch.Tensor,
         delta: float = 0.1) -> torch.Tensor:
    """Exact Bell-2014 WHDR for one image.

    reflectance: [H, W, C] linear; comparisons: [K+1, 6] padded blob.
    Returns a float32 scalar in [0, 1].
    """
    h, w = reflectance.shape[:2]
    x1, y1, x2, y2, darker, weight, valid, _ = comparisons_to_pixel_indices(
        comparisons, h, w)
    l1 = _floor_eps(reflectance[y1.long(), x1.long()].mean(dim=-1))
    l2 = _floor_eps(reflectance[y2.long(), x2.long()].mean(dim=-1))
    return _classify_error(l1, l2, darker, weight, valid, delta)


def _batch_lightness_pairs(reflectance: torch.Tensor,
                           comparisons: torch.Tensor):
    """Batched gather: (l1, l2, darker, weight, valid, num), each [B, K].

    reflectance [B, H, W] or [B, H, W, C]; lightness (the channel mean)
    commutes with the pixel gather, so the plane is reduced first and the
    pairs come from ``gather_pairs`` (K3 on CUDA, indexing on the CPU)."""
    b, h, w = reflectance.shape[:3]
    k = comparisons.shape[1] - 1
    num = comparisons[:, -1, 0].to(torch.int32)
    rows = comparisons[:, :-1, :]
    valid = (torch.arange(k, device=rows.device)[None, :] < num[:, None])
    x1, y1, x2, y2, darker, weight = _indices(rows, valid, h, w)
    plane = (reflectance if reflectance.dim() == 3
             else reflectance.mean(dim=-1))
    l1, l2 = gather_pairs(plane.contiguous(), y1.contiguous(),
                          x1.contiguous(), y2.contiguous(), x2.contiguous())
    return _floor_eps(l1), _floor_eps(l2), darker, weight, valid, num


def whdr_per_image(reflectance: torch.Tensor, comparisons: torch.Tensor,
                   delta: float = 0.1) -> torch.Tensor:
    """Per-image WHDR [B].  reflectance [B,H,W] or [B,H,W,C], comparisons
    [B,K+1,6] on the same device."""
    l1, l2, darker, weight, valid, _ = _batch_lightness_pairs(
        reflectance, comparisons)
    return _classify_error(l1, l2, darker, weight, valid, delta)


def whdr_batch(reflectance: torch.Tensor, comparisons: torch.Tensor,
               delta: float = 0.1) -> torch.Tensor:
    """Batch mean WHDR (the mean of the per-image values)."""
    return whdr_per_image(reflectance, comparisons, delta).mean()
