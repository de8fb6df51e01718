"""Trivial decomposition baselines from the reference's evaluation suite
(port of reflectance_filtering_tpu/ops/baselines.py).

  * Rescaling baseline (the reference's README, the ~10^-2.5 s plot-floor
    method): map image intensity linearly into [0.55, 1] and call it
    reflectance.
  * The rgbMean / rgbNorm movie baselines live in train/predict.py
    (save_movie_baseline).
"""
from __future__ import annotations

import numpy as np
import torch

EPS = np.float32(np.finfo(np.float32).eps)


def rescaling_baseline(images: torch.Tensor, lo: float = 0.55,
                       hi: float = 1.0):
    """Per-image linear rescale of intensity into [lo, hi] as reflectance,
    on the tensor's device.

    images: [..., H, W, 3] linear RGB.  Returns (reflectance_intensity
    [..., H, W], shading [..., H, W]) with I_mean = R * S."""
    intensity = images.mean(dim=-1)
    mn = intensity.amin(dim=(-2, -1), keepdim=True)
    mx = intensity.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(mx > mn, (hi - lo) / (mx - mn),
                        torch.zeros_like(mx))
    reflectance = lo + (intensity - mn) * scale
    shading = intensity / torch.clamp(reflectance, min=float(EPS))
    return reflectance, shading
