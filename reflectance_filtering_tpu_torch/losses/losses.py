"""Boundary and Lambertian reconstruction losses (port of
reflectance_filtering_tpu/losses/losses.py; reference:
training/layers/boundary_loss_layer.py:65-120 and
training/networks.py:281-299)."""
from __future__ import annotations

import torch


def boundary_loss(rgb: torch.Tensor, norm: str = "L1") -> torch.Tensor:
    """Mean penalty of the channel-mean intensity outside [0, 1].

    rgb: [B, H, W, 3] (or any [..., 3]).  Returns a scalar."""
    intensity = torch.mean(rgb, dim=-1)
    below = torch.relu(-intensity)
    above = torch.relu(intensity - 1.0)
    if norm == "L1":
        loss = below + above
    elif norm == "L2":
        loss = below ** 2 + above ** 2
    else:
        raise ValueError("boundary loss norm must be 'L1' or 'L2'")
    return torch.mean(loss)


def lambert_loss(reflectance: torch.Tensor, shading: torch.Tensor,
                 images: torch.Tensor) -> torch.Tensor:
    """Caffe EuclideanLoss(R*S, I) = sum((R*S - I)^2) / (2 * batch_size)."""
    batch = images.shape[0]
    diff = reflectance * shading - images
    return torch.sum(diff ** 2) / (2.0 * batch)
