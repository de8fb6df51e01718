"""Image numerics and IO conventions (port of reflectance_filtering_tpu/
utils/image.py).

The numpy host functions are copied verbatim from the JAX package, so
file IO keeps the reference's byte semantics and quirks (the reference's
image_utils.py:32-92):

  * sRGB <-> linear is the Bell-2014 piecewise curve with thresholds
    0.04045 / 0.0031308, exponent 2.4, slope 12.92.
  * ``imwrite`` of non-uint8 input normalizes by the 99.9th percentile
    ('lower'), clips to [0,1], optionally encodes sRGB, then scales by 255
    and *truncates* to uint8.
  * ``colorize`` runs on whatever value range it is given — the CLI feeds
    it the RAW uint8 BGR image, so shading comes out in 0-255 units.
  * ``imread`` returns uint8 BGR HWC via OpenCV.

``srgb_to_rgb_t`` is the torch twin of the JAX ``srgb_to_rgb_jnp``, used by
the plain version of the CNN kernel.
"""
from __future__ import annotations

import numpy as np
import torch

_SRGB_LIN_THRESH = 0.04045
_LIN_SRGB_THRESH = 0.0031308
_SRGB_SLOPE = 12.92
_SRGB_EXP = 2.4


def srgb_to_rgb(srgb):
    """sRGB -> linear RGB (numpy)."""
    srgb = np.asarray(srgb)
    return np.where(
        srgb <= _SRGB_LIN_THRESH,
        srgb / _SRGB_SLOPE,
        np.power(np.maximum((srgb + 0.055) / 1.055, 0.0), _SRGB_EXP),
    )


def rgb_to_srgb(rgb):
    """linear RGB -> sRGB (numpy)."""
    rgb = np.asarray(rgb)
    return np.where(
        rgb <= _LIN_SRGB_THRESH,
        rgb * _SRGB_SLOPE,
        np.power(np.maximum(1.055 * rgb, 0.0), 1.0 / _SRGB_EXP) - 0.055,
    )


def srgb_to_rgb_t(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear RGB on a tensor, in its own dtype and device.  Same
    math as :func:`srgb_to_rgb` (and the CNN kernel's fused gamma)."""
    return torch.where(
        srgb <= _SRGB_LIN_THRESH,
        srgb / _SRGB_SLOPE,
        torch.pow(torch.clamp((srgb + 0.055) / 1.055, min=0.0), _SRGB_EXP),
    )


def rgb_uint8_to_linear(rgb_u8):
    """uint8 RGB HWC -> float32 linear RGB, computed in float64.

    The linearization of the predict/decompose family
    (train_with_barrista_helper.py:653-662 runs numpy's default float64
    before the blob's float32 cast); the decompose CLI's K1 path
    linearizes in float32 instead."""
    return srgb_to_rgb(rgb_u8.astype(np.float64) / 255.0).astype(
        np.float32)


def imread(filename):
    """Read an image as uint8 BGR HWC; raise on failure."""
    import cv2

    img = cv2.imread(filename)
    if img is None:
        raise IOError("Input image not readable: {}".format(filename))
    return img


def imwrite(filename, image, sRGB=False):
    """Write an image, normalizing non-uint8 input first.

    Float input: divide by the 99.9th percentile (interpolation='lower'),
    clip to [0,1], optionally sRGB-encode, scale by 255, truncate to uint8.
    """
    import cv2

    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = normalize(image)
        if sRGB:
            image = rgb_to_srgb(image)
        image = (image * 255).astype(np.uint8)
    success = cv2.imwrite(filename, image)
    if not success:
        raise IOError(
            "Not able to write {}, does the folder exist?".format(filename))


def normalize(img):
    """Scale to [0,1] by the 99.9th percentile ('lower') if max > 1."""
    img = np.array(img, copy=True)
    if np.max(img) > 1:
        img = img / np.percentile(img, 99.9, method="lower")
        img = np.clip(img, 0, 1)
    return img


def colorize(intensity, image, eps=1e-3):
    """Reconstruct color reflectance/shading from scalar reflectance intensity.

    shading = mean_c(image) / intensity; reflectance = image / max(shading, eps).
    The caller decides the value range of ``image`` — the CLI passes raw
    uint8 BGR.
    """
    image = np.asarray(image)
    norm_input = np.mean(image, axis=2)
    shading = norm_input / intensity
    reflectance = image / np.maximum(shading, eps)[:, :, np.newaxis]
    return reflectance, shading
