"""Bilateral-grid fast bilateral filter (Paris & Durand 2006 / Chen 2007),
port of reflectance_filtering_tpu/ops/bilateral_grid.py.

An OPTIONAL approximate speed mode beyond the reference's capability
surface: the exact OpenCV-semantics filters (ops/bilateral.py, K2 and K6)
remain the parity path.  The grid costs a few uint8 levels against the
exact filter on natural images.

Algorithm (gray guide J, per-channel src S, all 0-255 units):
  splat  : accumulate (w=1, S) into a coarse grid over (y/ss, x/ss, J/sr)
           with trilinear weights, as B intensity-bin hat masks (masked
           plane sums pooled by ss with box weights, no scatter);
  blur   : a small separable Gaussian over the two spatial grid axes and
           the intensity axis (sigma = sigma_space/ss, sigma_color/sr in
           grid cells);
  slice  : a trilinear read at (y/ss, x/ss, J(p)/sr) — a bilinear upsample
           of each bin plane and per-pixel intensity hat weights — and the
           homogeneous divide.

The JAX package computes this with plain XLA ops and no Pallas kernel (the
grid is ~ss*ss*sr times smaller than the image); its counterpart here is
plain torch ops on the tensor's device.  The upsample is
``F.interpolate(bilinear, align_corners=False)`` at the integer factor ss:
it clamps the edge samples where ``jax.image.resize`` drops the samples
outside the input and renormalises, and at an integer upsampling both give
the edge cell's value there.

Parameter conventions are cv2.ximgproc.jointBilateralFilter's
(the reference's filter_reflectance.py): sigma_color on 0-255 guide values,
sigma_space in pixels; the guide is the image itself or a separate joint
image.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build


def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_axis(g: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Separable 1-D Gaussian along ``axis`` with replicate edges."""
    r = (len(kernel) - 1) // 2
    n = g.shape[axis]
    idx = torch.clamp(torch.arange(-r, n + r, device=g.device), 0, n - 1)
    gp = g.index_select(axis, idx)
    out = torch.zeros_like(g)
    for i, w in enumerate(kernel.tolist()):
        out = out + np.float32(w) * gp.narrow(axis, i, n)
    return out


def bilateral_grid_gray(joint: torch.Tensor, src: torch.Tensor,
                        sigma_color: float = 20.0, sigma_space: float = 22.0,
                        ss: int = None, sr: int = None) -> torch.Tensor:
    """Fast approximate joint bilateral, gray guide, on the tensors'
    device.

    joint [N,H,W] (0-255), src [N,C,H,W] -> [N,C,H,W] float32.  ss/sr: the
    spatial and range cell sizes (pixels, intensity levels); None picks
    ~sigma_space/3 and ~1.2 sigma_color, the JAX package's defaults.
    Larger cells trade accuracy for speed; keep ss a divisor of H and W (a
    non-dividing ss pads the frame)."""
    if ss is None:      # ~sigma/3, snapped to a multiple of 4
        ss = max(2, 4 * int(round(sigma_space / 12.0)))
    if sr is None:
        sr = max(2, int(round(1.2 * sigma_color)))
    joint = joint.to(torch.float32)
    src = src.to(device=joint.device, dtype=torch.float32)
    n, h, w = joint.shape
    c = src.shape[1]
    hs, ws = -(-h // ss), -(-w // ss)
    nb = int(np.ceil(255.0 / sr)) + 1          # bin centers b*sr
    hp, wp = hs * ss, ws * ss

    # zero-pad to grid multiples and mask the splat weights: padded pixels
    # contribute nothing to either accumulator, and the homogeneous divide
    # self-corrects the partial border cells
    jp = F.pad(joint, (0, wp - w, 0, hp - h))
    sp = F.pad(src, (0, wp - w, 0, hp - h))
    mask = F.pad(torch.ones_like(joint), (0, wp - w, 0, hp - h))

    # --- splat: trilinear hat in intensity, box pool in space -------------
    z = jp / float(sr)                          # [N,Hp,Wp] in bin units
    bins = torch.arange(nb, dtype=torch.float32, device=joint.device)
    hat_p = torch.clamp(1.0 - torch.abs(z[:, None]
                                        - bins[None, :, None, None]), min=0.0)
    hat = mask[:, None] * hat_p                 # [N,nb,Hp,Wp]
    wgrid = hat.reshape(n, nb, hs, ss, ws, ss).mean(dim=(3, 5))
    sgrid = (hat[:, None] * sp[:, :, None]).reshape(
        n, c, nb, hs, ss, ws, ss).mean(dim=(4, 6))   # [N,C,nb,hs,ws]

    # --- blur: separable Gaussian over the (bin, y, x) grid axes ----------
    # spatial kernel truncated at 1.5 sigma (OpenCV's radius =
    # round(1.5 sigma_space) window rule), range kernel at 2 sigma
    kz = _gauss_kernel(sigma_color / sr, max(1, int(round(
        2 * sigma_color / sr))))
    ks = _gauss_kernel(sigma_space / ss, max(1, int(round(
        1.5 * sigma_space / ss))))
    for g_ax, kern in ((1, kz), (2, ks), (3, ks)):
        wgrid = _blur_axis(wgrid, kern, g_ax)
    for g_ax, kern in ((2, kz), (3, ks), (4, ks)):
        sgrid = _blur_axis(sgrid, kern, g_ax)

    # --- slice: bilinear spatial upsample per bin + intensity hat ---------
    def up(g):
        return F.interpolate(g, size=(hp, wp), mode="bilinear",
                             align_corners=False)
    wup = up(wgrid)                                          # [N,nb,Hp,Wp]
    sup = up(sgrid.reshape(n, c * nb, hs, ws)).reshape(n, c, nb, hp, wp)
    den = torch.sum(hat_p * wup, dim=1)                      # [N,Hp,Wp]
    num = torch.sum(hat_p[:, None] * sup, dim=2)             # [N,C,Hp,Wp]
    out = num / torch.clamp(den, min=1e-20)[:, None]
    return out[:, :, :h, :w]


def bilateral_grid_u8(joint_u8, src_u8, sigma_color: float = 20.0,
                      sigma_space: float = 22.0, ss: int = None,
                      sr: int = None, device="cuda") -> np.ndarray:
    """uint8 wrapper (gray or replicated-channel joint) on ``device`` (the
    card unless the caller asks for the CPU).

    A color joint is reduced to its channel mean (the grid treats the guide
    as scalar, the standard luminance-grid approximation), and sigma_color
    is divided by the channel count to match the exact filter's summed-abs
    range diff (3 identical channels -> 3|delta|)."""
    device = _build.target_device(device)
    j = np.asarray(joint_u8)
    s = np.asarray(src_u8)
    if j.ndim == 3:
        sigma_color = sigma_color / j.shape[-1]
        j = j.mean(axis=-1)
    sp = (s[None, None] if s.ndim == 2 else np.moveaxis(s, -1, 0)[None])
    out = bilateral_grid_gray(
        torch.from_numpy(np.ascontiguousarray(j[None], np.float32)).to(
            device),
        torch.from_numpy(np.ascontiguousarray(sp, np.float32)).to(device),
        float(sigma_color), float(sigma_space), ss, sr)[0].cpu().numpy()
    out = out[0] if s.ndim == 2 else np.moveaxis(out, 0, -1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
