"""WHDR (Bell et al. 2014, the reference's whdr_layer.py) and the WHDR
hinge loss (whdr_hinge_loss_layer.py) on packed comparison blobs [B, K+1,
6]: rows [x1, y1, x2, y2, darker, weight] in normalized coordinates
(truncated to pixels), NaN padded, the last row [num, ...]."""
from __future__ import annotations

import torch

EPS = float(torch.finfo(torch.float32).eps)


def _pairs(plane: torch.Tensor, comps: torch.Tensor):
    """Lightness at both points, the labels, weights and validity, [B, K]
    each; plane [B, H, W]."""
    b, h, w = plane.shape
    k = comps.shape[1] - 1
    num = comps[:, -1, 0].to(torch.int64)
    rows = comps[:, :-1]
    valid = torch.arange(k, device=comps.device)[None] < num[:, None]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))

    def at(cx, cy):
        x = torch.clamp((rows[..., cx] * w).to(torch.int32), 0, w - 1)
        y = torch.clamp((rows[..., cy] * h).to(torch.int32), 0, h - 1)
        flat = plane.reshape(b, h * w)
        got = torch.gather(flat, 1, (y.to(torch.int64) * w + x))
        return torch.clamp(got, min=EPS)

    return (at(0, 1), at(2, 3), rows[..., 4].to(torch.int64), rows[..., 5],
            valid)


def whdr(plane: torch.Tensor, comps: torch.Tensor, delta: float = 0.1,
         low: bool = False) -> torch.Tensor:
    """Per-image WHDR [B] of the reflectance plane [B, H, W] (float32;
    its lightness in bfloat16 with ``low``)."""
    if low:
        plane = plane.to(torch.bfloat16)
    l1, l2, darker, weight, valid = _pairs(plane, comps)
    l1, l2 = l1.to(torch.float32), l2.to(torch.float32)
    alg = torch.where(l2 / l1 > 1 + delta, 1,
                      torch.where(l1 / l2 > 1 + delta, 2, 0))
    zero = torch.zeros_like(weight)
    err = torch.where(valid & (alg != darker), weight, zero).sum(dim=1)
    wsum = torch.where(valid, weight, zero).sum(dim=1)
    return torch.where(wsum > 0, err / wsum, torch.zeros_like(wsum))


def hinge(plane: torch.Tensor, comps: torch.Tensor, delta: float = 0.1,
          margin: float = 0.05) -> torch.Tensor:
    """The batch mean of the per-image WHDR hinge loss (every comparison
    evaluated: K <= 1,500, ratio 1, dense), for margin <= delta."""
    l1, l2, darker, weight, valid = _pairs(plane, comps)
    y = l1 / l2
    b12 = 1.0 + delta + margin
    br = 1.0 + delta - margin
    loss = torch.where(
        darker == 1, torch.relu(y - 1.0 / b12),
        torch.where(darker == 2, torch.relu(b12 - y),
                    torch.relu(y - br) + torch.relu(1.0 / br - y)))
    zero = torch.zeros_like(weight)
    err = torch.where(valid, weight * loss, zero).sum(dim=1)
    wsum = torch.where(valid, weight, zero).sum(dim=1)
    per = torch.where(wsum > 0, err / torch.where(wsum > 0, wsum, 1.0),
                      torch.zeros_like(wsum))
    return per.mean()
