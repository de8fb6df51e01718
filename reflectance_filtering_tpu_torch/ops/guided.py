"""Guided filter (He et al. 2013) with OpenCV ximgproc semantics (port of
reflectance_filtering_tpu/ops/guided.py).

The reference calls ``guidedFilter(guide=joint, src=image,
radius=int(sigma_spatial), eps=sigma_color)`` on uint8 0-255 images, so eps
is in (0-255)^2 units and is not rescaled.  Every mean is a normalized
(2r+1)^2 box with BORDER_REFLECT borders; the color-guide system is solved
by the cofactors of the symmetric 3x3 matrix; the uint8 output is
round-half-to-even and clipped (OpenCV's saturate_cast).

Dispatch, by the device of the tensors:
  * a color guide runs K5 (ops/guided_kernel.py) on CUDA, at any frame
    size, and its plain version on the CPU;
  * a gray guide runs the scalar formulas over K4 (ops/box_kernel.py) on
    CUDA and over the plain box on the CPU;
  * the Fast Guided Filter (``--subsample``) computes the coefficients at
    1/s resolution over K4 and upsamples them;
  * the iterated chain (``guided_filter_iterated(planar=True)``) runs K9
    (ops/guided_chain_kernel.py) on CUDA, at any frame size, and its plain
    version on the CPU.
The JAX package's TPU-only predicates (fits_mxu_guided, fits_fused_guided)
and its bf16 storage of uint8 guides do not carry over.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _build
from .box_kernel import box_filter_planar
from .guided_chain_kernel import guided_filter_chain
from .guided_kernel import guided_ab_means, guided_apply, guided_filter_fused


def _box(x: torch.Tensor, radius: int) -> torch.Tensor:
    return box_filter_planar(x, radius, border="reflect")


def guided_filter_planar(guide: torch.Tensor, src: torch.Tensor, radius: int,
                         eps) -> torch.Tensor:
    """Color guide [N, 3, H, W], src [N, C, H, W] (any float or uint8
    dtype; computed in float32) -> [N, C, H, W] float32: K5 on CUDA, its
    plain version on the CPU."""
    return guided_filter_fused(guide.to(torch.float32).contiguous(),
                               src.to(torch.float32).contiguous(),
                               int(radius), float(eps))


def _guided_filter_color_planar(I: torch.Tensor, p: torch.Tensor,
                                radius: int, eps) -> torch.Tensor:
    """The generic planar color-guide path over K4's wrapper (the plain box
    on the CPU); the same math as K5."""
    return guided_apply(guided_ab_means(I, p, radius, eps, _box), I)


def _guided_filter_gray(I: torch.Tensor, p: torch.Tensor, radius: int,
                        eps) -> torch.Tensor:
    """Scalar guide I [N, H, W], src p [N, C, H, W] -> [N, C, H, W]."""
    n, c, h, w = p.shape

    def box(x):  # [N, K, H, W]
        k = x.shape[1]
        return _box(x.reshape(n * k, h, w).contiguous(), radius).reshape(
            n, k, h, w)

    Ic = I[:, None]
    m = box(torch.cat([Ic, p, Ic * p, Ic * Ic], dim=1))
    mean_I, mean_p = m[:, :1], m[:, 1:1 + c]
    corr_Ip, corr_II = m[:, 1 + c:1 + 2 * c], m[:, 1 + 2 * c:]
    var_I = corr_II - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    mab = box(torch.cat([a, b], dim=1))
    return mab[:, :c] * Ic + mab[:, c:]


def guided_filter(guide, src, radius: int, eps,
                  batched: bool = False) -> torch.Tensor:
    """Guided filter on float values in guide units (0-255 for the
    reference pipeline), on the device of ``src``.

    Unbatched: guide [H, W, 3] (color) or [H, W] (gray); src [H, W, C] or
    [H, W].  Batched (batched=True): a leading N on both.  Returns float32
    of src's shape."""
    src = torch.as_tensor(src).to(torch.float32)
    guide = torch.as_tensor(guide).to(device=src.device, dtype=torch.float32)
    spatial_nd = 3 if batched else 2
    squeeze = src.dim() == spatial_nd
    if squeeze:
        src = src[..., None]
    if not batched:
        guide, src = guide[None], src[None]
    p = src.permute(0, 3, 1, 2).contiguous()
    if guide.dim() == 4 and guide.shape[-1] == 3:
        q = guided_filter_planar(guide.permute(0, 3, 1, 2), p, radius, eps)
    elif guide.dim() == 3:
        q = _guided_filter_gray(guide, p, radius, float(eps))
    else:
        raise ValueError("guide shape {} invalid (batched={})".format(
            tuple(guide.shape[0 if batched else 1:]), batched))
    q = q.permute(0, 2, 3, 1)
    if not batched:
        q = q[0]
    return q[..., 0] if squeeze else q


def guided_filter_iterated(guide, src, radius: int, eps, iterations: int = 3,
                           planar: bool = False, guide_u8: bool = False):
    """Guided-filter src ``iterations`` times against the same guide: the
    Zoran-style "3x iterated GF" chain (the JAX bench's config 4).

    planar=True takes and returns [N, C, H, W] (guide [N, 3, H, W]) and
    runs :func:`guided_filter_chain`, the guide's statistics computed once
    per call: K9 on CUDA at any frame size, its plain version on the CPU.
    planar=False repeats :func:`guided_filter` on the HWC layouts it takes.
    ``guide_u8`` is accepted for the JAX signature and changes nothing
    (the JAX package's bf16 storage of uint8-valued guides is a TPU
    device).  iterations <= 0 returns src."""
    del guide_u8
    if iterations <= 0:
        return src
    with span("guided.iterated"):
        if planar:
            return guided_filter_chain(guide.to(torch.float32).contiguous(),
                                       src.to(torch.float32).contiguous(),
                                       int(radius), float(eps), iterations)
        batched = np.ndim(src) == 4
        out = src
        for _ in range(iterations):
            out = guided_filter(guide, out, radius, eps, batched=batched)
        return out


def fast_guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int,
                       eps, subsample: int = 4) -> torch.Tensor:
    """Fast Guided Filter (He & Sun 2015, arXiv:1505.00996): the a, b
    coefficient means at 1/s resolution, bilinearly upsampled, applied to
    the full-resolution guide.  An opt-in approximation of the exact
    filter.  guide [N, 3, H, W], src [N, C, H, W]; subsample <= 1 is the
    exact filter.

    The downsample is bilinear with antialiasing, as ``jax.image.resize``
    does when it shrinks; the radius at low resolution is
    ``max(1, round(radius / subsample))`` with Python's half-to-even
    ``round``."""
    if subsample <= 1:
        return guided_filter_planar(guide, src, radius, eps)
    n, _, h, w = guide.shape
    hs, ws = max(1, h // subsample), max(1, w // subsample)
    rs = max(1, int(round(radius / subsample)))
    g32 = guide.to(torch.float32)

    def down(x):
        return F.interpolate(x, size=(hs, ws), mode="bilinear",
                             align_corners=False, antialias=True)

    means = guided_ab_means(down(g32), down(src.to(torch.float32)), rs,
                            float(eps), _box)
    up = F.interpolate(means, size=(h, w), mode="bilinear",
                       align_corners=False)
    return guided_apply(up, g32)


def _u8_out(q: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(q), 0, 255).astype(np.uint8)


def _planar_u8(guide3: np.ndarray, src_u8: np.ndarray, device, filt):
    """Run ``filt(guide [1,3,H,W], src [1,C,H,W])`` on ``device`` for a
    uint8 HWC color guide and an HW or HWC src; a src whose channels are
    all equal (the CNN's -r.png decodes to three) is filtered once and
    replicated, as the GF of each src channel is independent."""
    gp = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(guide3, -1, 0)[None])).to(device)
    sa = (np.moveaxis(src_u8, -1, 0) if src_u8.ndim == 3
          else src_u8[None])[None]
    mono = bool((sa[:, :1] == sa).all())
    sp = torch.from_numpy(np.ascontiguousarray(
        sa[:, :1] if mono else sa)).to(device)
    q = filt(gp, sp).cpu().numpy()
    if mono:
        q = np.broadcast_to(q, sa.shape)
    q = np.moveaxis(q[0], 0, -1)
    return q[..., 0] if src_u8.ndim == 2 else q


def guided_filter_u8(guide_u8, src_u8, radius: int, eps,
                     device="cuda") -> np.ndarray:
    """uint8 wrapper with OpenCV rounding: float32 math on ``device`` (the
    card unless the caller asks for the CPU), round-half-to-even, clip to
    0-255.  A color guide runs the planar filter (K5 on CUDA), a gray one
    the scalar formulas (over K4)."""
    device = _build.target_device(device)
    g = np.asarray(guide_u8)
    s = np.asarray(src_u8)
    if g.ndim == 3 and g.shape[-1] == 3:
        q = _planar_u8(g, s, device, lambda gp, sp: guided_filter_planar(
            gp, sp, radius, eps))
    else:
        q = guided_filter(torch.from_numpy(g).to(device),
                          torch.from_numpy(s).to(device), radius,
                          eps).cpu().numpy()
    return _u8_out(q)


def fast_guided_filter_u8(guide_u8, src_u8, radius: int, eps,
                          subsample: int = 4, device="cuda") -> np.ndarray:
    """uint8 wrapper for :func:`fast_guided_filter`, the CLI's
    ``--subsample`` mode, on ``device`` (the card unless the caller asks
    for the CPU).  A gray guide is replicated to three channels: the fast
    filter approximates the exact product path, which feeds the CNN's
    replicated-gray -r.png through the 3-channel filter too."""
    device = _build.target_device(device)
    g = np.asarray(guide_u8)
    s = np.asarray(src_u8)
    if subsample <= 1:
        return guided_filter_u8(g, s, radius, eps, device=device)
    g3 = g if g.ndim == 3 else np.repeat(g[..., None], 3, axis=-1)
    q = _planar_u8(g3, s, torch.device(device), lambda gp, sp:
                   fast_guided_filter(gp, sp, radius, float(eps), subsample))
    return _u8_out(q)
