"""Joint bilateral filter with OpenCV-compatible semantics (port of
reflectance_filtering_tpu/ops/bilateral.py).

OpenCV semantics (cv2.ximgproc.jointBilateralFilter, invoked by the
reference as ``jointBilateralFilter(joint, image, d=-1, sigmaColor,
sigmaSpace)`` on uint8 images):

  * sigma_color/sigma_space <= 0 are clamped to 1.
  * d <= 0  =>  radius = round(1.5 * sigma_space); radius = max(radius, 1);
    window is the *disk* of taps with sqrt(dx^2+dy^2) <= radius.
  * spatial weight  exp(-(dx^2+dy^2) / (2 sigma_space^2))
  * range weight    exp(-(sum_c |J_c(q)-J_c(p)|)^2 / (2 sigma_color^2)),
    computed on the *joint* (guidance) image values.
  * border BORDER_REFLECT_101; float32 accumulation; round-to-nearest-even
    on the uint8 output (cvRound).

``joint_bilateral_filter`` is the plain float filter, a loop over the tap
list that is the twin of the JAX ``_jbf_scan`` (the tests' oracle).
``joint_bilateral_filter_u8`` keeps the JAX package's TPU dispatch on every
device: the self-guided gray case (the BF(CNN,CNN) -r.png) goes to the K2
wrapper (ops/bilateral_kernel.py), color self-guided and joint != src to
the K6 wrappers (ops/bilateral_joint_kernel.py); each runs its kernel on
CUDA and its plain version on the CPU.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def opencv_bilateral_coeffs(d: int, sigma_color: float, sigma_space: float
                            ) -> Tuple[int, float, float]:
    """OpenCV's parameter preprocessing without the tap list: (radius,
    gauss_color_coeff, gauss_space_coeff), cheap enough for every kernel
    call (the tap list is a few milliseconds of Python at radius 33)."""
    if sigma_color <= 0:
        sigma_color = 1.0
    if sigma_space <= 0:
        sigma_space = 1.0
    gauss_color_coeff = -0.5 / (sigma_color * sigma_color)
    gauss_space_coeff = -0.5 / (sigma_space * sigma_space)
    if d <= 0:
        radius = int(round(sigma_space * 1.5))
    else:
        radius = d // 2
    return max(radius, 1), gauss_color_coeff, gauss_space_coeff


def opencv_bilateral_params(d: int, sigma_color: float, sigma_space: float
                            ) -> Tuple[int, float, float, np.ndarray]:
    """Replicate OpenCV's parameter preprocessing.

    Returns (radius, gauss_color_coeff, gauss_space_coeff,
    taps[[dy, dx, space_weight], ...]) with the disk mask applied in
    OpenCV's tap order (row-major over the square, skipping r > radius).
    """
    radius, gauss_color_coeff, gauss_space_coeff = opencv_bilateral_coeffs(
        d, sigma_color, sigma_space)
    taps = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(i * i + j * j)
            if r > radius:
                continue
            w = math.exp((i * i + j * j) * gauss_space_coeff)
            taps.append((i, j, w))
    return radius, gauss_color_coeff, gauss_space_coeff, np.asarray(
        taps, dtype=np.float64)


def range_weights(gauss_color_coeff: float, reps: int = 1,
                  planes: int = 1) -> np.ndarray:
    """cv2.bilateralFilter's color_weight for ``planes`` planes of uint8
    levels, each standing for ``reps`` identical channels: cw[i] =
    f32(exp((reps*i)^2 * gauss_color_coeff)), i = sum over the planes of
    |x(q) - x(p)| in 0..255*planes, computed in float64 before the cast, as
    cv2 computes it (the summed |delta| over the channels is reps*i,
    squared as an integer)."""
    return np.asarray([math.exp((reps * i) ** 2 * gauss_color_coeff)
                       for i in range(255 * planes + 1)], dtype=np.float32)


def space_weights(radius: int, gauss_space_coeff: float) -> np.ndarray:
    """The disk's spatial weights by squared distance: sw[s] = f32(exp(s *
    gauss_space_coeff)), s = dx^2 + dy^2 in 0..radius^2, in float64 before
    the cast (each tap's weight in :func:`opencv_bilateral_params`)."""
    return np.asarray([math.exp(s * gauss_space_coeff)
                       for s in range(radius * radius + 1)],
                      dtype=np.float32)


def reflect101_index(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each of the n + 2*radius padded positions under
    BORDER_REFLECT_101, reflecting again and again when radius >= n
    (period 2(n-1), as OpenCV's borderInterpolate and numpy's "reflect"
    pad; ``torch.nn.functional.pad`` refuses pads that large).  A
    1-wide dimension maps everything to 0."""
    i = torch.arange(-radius, n + radius, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def pad_reflect101(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Reflect-101 pad of the last two axes by ``radius``."""
    h, w = x.shape[-2:]
    iy = reflect101_index(h, radius, x.device)
    ix = reflect101_index(w, radius, x.device)
    return x[..., iy, :][..., ix]


def joint_bilateral_filter(joint, src, d: int = -1,
                           sigma_color: float = 20.0,
                           sigma_space: float = 22.0) -> torch.Tensor:
    """Float joint bilateral filter (the plain loop over the tap list).

    joint: [H,W,C_j] or [H,W]; src: [H,W,C] or [H,W] (tensors or arrays),
    values in the units sigma_color refers to (0-255 for the reference
    pipeline).  Returns float32 of src's shape, on src's device.
    """
    src = torch.as_tensor(src).to(torch.float32)
    joint = torch.as_tensor(joint).to(device=src.device, dtype=torch.float32)
    squeeze = src.dim() == 2
    if joint.dim() == 2:
        joint = joint[..., None]
    if src.dim() == 2:
        src = src[..., None]
    h, w = src.shape[:2]

    radius, gcc, _gsc, taps = opencv_bilateral_params(
        d, sigma_color, sigma_space)
    # channels first, so the reflect pad runs over the spatial axes
    joint_pad = pad_reflect101(joint.permute(2, 0, 1), radius)
    src_pad = pad_reflect101(src.permute(2, 0, 1), radius)
    center = joint.permute(2, 0, 1)
    gcc = np.float32(gcc)

    acc = torch.zeros_like(src_pad[:, :h, :w])
    wsum = torch.zeros((h, w), dtype=torch.float32, device=src.device)
    for dy, dx, sw in zip(taps[:, 0].astype(np.int64) + radius,
                          taps[:, 1].astype(np.int64) + radius,
                          taps[:, 2].astype(np.float32)):
        js = joint_pad[:, dy:dy + h, dx:dx + w]
        ss = src_pad[:, dy:dy + h, dx:dx + w]
        diff = torch.sum(torch.abs(js - center), dim=0)
        wgt = sw * torch.exp(diff * diff * gcc)
        acc += wgt * ss
        wsum += wgt
    out = (acc / wsum).permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def joint_bilateral_filter_u8(joint_u8, src_u8, d: int = -1,
                              sigma_color: float = 20.0,
                              sigma_space: float = 22.0,
                              device="cuda") -> np.ndarray:
    """uint8 wrapper with cvRound (round-half-to-even) output, on
    ``device`` (the card unless the caller asks for the CPU).

    The JAX package's dispatch (reflectance_filtering_tpu/ops/
    bilateral.py:139-180): joint == src with identical channels (the
    BF(CNN,CNN) -r.png) runs the gray self-guided filter (K2, on the uint8
    plane itself: cv2's table form); joint == src
    in color runs the color self-guided filter (cv2.bilateralFilter); every
    other pairing runs the u8 joint filter on the joint and src reduced to
    their distinct planes (a mono joint to one plane standing for its
    channel count, a mono src to one plane, repeated back after)."""
    from .bilateral_joint_kernel import (bilateral_color_self_batched,
                                         bilateral_packed_joint_batched,
                                         check_channels)
    from . import _build
    from .bilateral_kernel import bilateral_gray_self

    device = _build.target_device(device)
    j = np.asarray(joint_u8)
    s = np.asarray(src_u8)
    self_joint = j is s or (j.shape == s.shape and np.array_equal(j, s))
    mono = j.ndim == 2 or (j.ndim == 3 and bool((j[..., :1] == j).all()))
    # a replicated-channel joint contributes |delta| per channel to cv2's
    # summed-abs diff; a genuinely 1-channel array does not
    j_reps = j.shape[-1] if j.ndim == 3 else 1

    def planar(a):  # [H, W, C] -> [1, C, H, W] float32 on device
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            a.astype(np.float32), -1, 0))[None]).to(device)

    if self_joint and mono:
        plane = j if j.ndim == 2 else j[..., 0]
        # uint8 levels take K2's table form, any other dtype its float form
        if plane.dtype != np.uint8:
            plane = plane.astype(np.float32)
        plane = torch.from_numpy(np.ascontiguousarray(plane)).to(device)
        out = bilateral_gray_self(plane[None], d, sigma_color,
                                  sigma_space, reps=j_reps)[0].cpu().numpy()
        if j.ndim == 3:
            out = np.repeat(out[..., None], j.shape[-1], axis=-1)
    elif self_joint and j.ndim == 3 and j.shape[-1] == 3:
        out = bilateral_color_self_batched(
            planar(j), d, sigma_color, sigma_space)[0].permute(
                1, 2, 0).cpu().numpy()
    else:
        s_mono = s.ndim == 2 or bool((s[..., :1] == s).all())
        jp = (j[..., None] if j.ndim == 2
              else j[..., :1] if mono else j)
        sp = (s[..., None] if s.ndim == 2
              else s[..., :1] if s_mono else s)
        check_channels(jp.shape[-1], sp.shape[-1])
        q = bilateral_packed_joint_batched(
            planar(jp), planar(sp), d, sigma_color, sigma_space,
            joint_reps=j_reps if mono else 1)[0]
        out = q.permute(1, 2, 0).cpu().numpy()
        if s.ndim == 2:
            out = out[..., 0]
        elif s_mono and s.shape[-1] > 1:
            out = np.repeat(out[..., :1], s.shape[-1], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
