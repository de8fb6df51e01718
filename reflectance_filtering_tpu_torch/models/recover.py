"""Reflectance/shading recovery from the network estimate (port of
reflectance_filtering_tpu/models/recover.py; reference:
training/layers/recover_reflectance_shading_layer.py).

All 14 modes are differentiable torch expressions.  Feature maps are NHWC;
``estimate`` has 1, 3 or 6 channels per the mode; ``images`` is linear RGB
[B, H, W, 3].  ``torch.maximum`` against eps splits the gradient evenly at
a tie, as ``jnp.maximum`` does (``torch.clamp`` would pass all of it).
"""
from __future__ import annotations

import numpy as np
import torch

EPS = np.float32(np.finfo(np.float32).eps)

RS_EST_MODES = (
    "sAbs", "S", "rAbs", "R", "RS",
    "rRelNorm", "rRelMean", "rRelY", "rRelMax",
    "sRelNorm", "sRelMean", "sRelY", "sRelMax",
    "rDirectly",
)


def threshold(x: torch.Tensor) -> torch.Tensor:
    """max(x, float32 eps) (recover_reflectance_shading_layer.py:430-431)."""
    return torch.maximum(x, x.new_full((), float(EPS)))


def _norm_mean(image):
    """(r+g+b)/3 as in Bell et al. 2014 (:403-405)."""
    return torch.sum(image, dim=-1, keepdim=True) / 3


def _norm_l2(image):
    """L2 norm over color (:408-410), sqrt(sum(x^2)) as jnp.linalg.norm."""
    return torch.sqrt(torch.sum(image * image, dim=-1, keepdim=True))


def _norm_lightness(image):
    """Perceptual lightness 0.299/0.587/0.114 (:413-419)."""
    return (0.299 * image[..., 0:1] +
            0.587 * image[..., 1:2] +
            0.114 * image[..., 2:3])


def _norm_max(image):
    """L_inf over color (:422-427); amax shares the gradient among ties, as
    jnp.max does."""
    return torch.amax(image, dim=-1, keepdim=True)


_NORMS = {
    "Norm": _norm_l2,
    "Mean": _norm_mean,
    "Y": _norm_lightness,
    "Max": _norm_max,
}


def recover_reflectance_shading(estimate: torch.Tensor, images: torch.Tensor,
                                rs_est_mode: str):
    """Map (estimate, images) -> (reflectance, shading), both [B,H,W,3]
    (rDirectly: the ReLU of the estimate for both; RS: 3+3 split; R/S: RGB
    estimate, the other = I/est; rAbs/sAbs: scalar absolute intensity;
    rRel<N>/sRel<N>: scalar relative to the image intensity under norm N,
    with sRelMean/sRelY/sRelMax wired to the reflectance interpreter as the
    reference wires them)."""
    mode = rs_est_mode.split("-")[0]

    if mode == "rDirectly":
        return torch.relu(estimate), torch.relu(estimate)

    if mode == "RS":
        return estimate[..., 0:3], estimate[..., 3:6]

    if mode == "R":
        r = threshold(estimate)
        return r, images / r

    if mode == "S":
        s = threshold(estimate)
        return images / s, s

    if mode == "rAbs":
        r_i = threshold(estimate)
        return r_i * images, (1.0 / r_i) * torch.ones_like(images)

    if mode == "sAbs":
        s = threshold(estimate)
        return images / s, s * torch.ones_like(images)

    if mode.startswith("rRel") or mode in ("sRelMean", "sRelY", "sRelMax"):
        norm = _NORMS[mode[4:]]
        r_i = threshold(estimate)
        intensity = threshold(norm(images))
        normalized = images / intensity
        reflectance = r_i * normalized
        shading = (intensity / r_i) * torch.ones_like(images)
        return reflectance, shading

    if mode == "sRelNorm":
        s = threshold(estimate)
        intensity = threshold(_norm_l2(images))
        reflectance = images / intensity / s
        shading = intensity * s * torch.ones_like(images)
        return reflectance, shading

    raise ValueError("RS_est_mode '{}' not known".format(rs_est_mode))
