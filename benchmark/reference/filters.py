"""OpenCV's filters as the reference pipeline calls them, written from
their definitions.

* ``bilateral_gray``: ``cv2.bilateralFilter(img, -1, sigma_color,
  sigma_space)`` on a gray image read back as three equal uint8 channels
  (the -r.png byte path): radius round(1.5 sigma_space), the disk dx^2 +
  dy^2 <= r^2, BORDER_REFLECT_101, the color weight
  f32(exp((3|d|)^2 * -0.5 / sigma_color^2)) and the space weight
  f32(exp((dx^2 + dy^2) * -0.5 / sigma_space^2)) as OpenCV tabulates them,
  the sums here in float64.
* ``guided``: He et al.'s guided filter with a color guide as
  ``cv2.ximgproc.guidedFilter`` computes it: normalized (2r+1)^2 box means
  with BORDER_REFLECT, the 3x3 system solved per pixel, in float64.
* ``guided_chain``: the guided filter applied ``iterations`` times with the
  same guide.

With ``low=True`` each computes one step below float32 instead (the
control), its sums in float32: the bilateral holds its weights and
weighted values in bfloat16; the guided filter holds in bfloat16 the
planes a filter keeps between its passes (the inverse's entries, the
coefficients a and b and their means) and its output.  (Holding the
guide's means in bfloat16 too breaks the filter outright: the covariances
cancel to their rounding, and 4K frames read gaps of 1e10 levels.)
"""
from __future__ import annotations

import math

import torch


def _precision(low: bool):
    """(the compute dtype, the rounding of what is held): float64 and
    none, or float32 with every held value rounded to bfloat16."""
    if low:
        return torch.float32, lambda t: t.to(torch.bfloat16).to(
            torch.float32)
    return torch.float64, lambda t: t


def _reflect101(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each of n + 2 radius positions, BORDER_REFLECT_101
    (period 2(n - 1))."""
    i = torch.arange(-radius, n + radius, device=device)
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * (n - 1)
    i = torch.remainder(i, p)
    return torch.where(i >= n, p - i, i)


def _reflect(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each of n + 2 radius positions, BORDER_REFLECT
    (the edge repeated, period 2n)."""
    i = torch.remainder(torch.arange(-radius, n + radius, device=device),
                        2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def bilateral_gray(levels: torch.Tensor, sigma_color: float,
                   sigma_space: float, reps: int = 3,
                   low: bool = False) -> torch.Tensor:
    """levels [B, H, W] uint8-valued -> the filtered image [B, H, W]
    (float64), before the output's rounding."""
    dtype, held = _precision(low)
    b, h, w = levels.shape
    radius = max(int(round(sigma_space * 1.5)), 1)
    gcc = -0.5 / (sigma_color * sigma_color)
    gsc = -0.5 / (sigma_space * sigma_space)
    dev = levels.device
    color = torch.tensor([math.exp((reps * i) ** 2 * gcc)
                          for i in range(256)], dtype=torch.float32,
                         device=dev)
    color = held(color.to(dtype))
    x = levels.to(torch.int64)
    xp = x[:, _reflect101(h, radius, dev)][:, :, _reflect101(w, radius, dev)]
    xpf = xp.to(dtype)
    acc = torch.zeros((b, h, w), dtype=dtype, device=dev)
    wsum = torch.zeros_like(acc)
    for dy in range(-radius, radius + 1):
        reach = math.isqrt(radius * radius - dy * dy)
        for dx in range(-reach, reach + 1):
            space = float(held(torch.tensor(
                math.exp((dx * dx + dy * dy) * gsc), dtype=torch.float32)))
            at = (slice(None), slice(radius + dy, radius + dy + h),
                  slice(radius + dx, radius + dx + w))
            wgt = held(color[(xp[at] - x).abs()] * space)
            acc += held(wgt * xpf[at])
            wsum += wgt
    return (acc / wsum).to(torch.float64)


def box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Normalized (2r+1)^2 box mean of x [..., H, W] with BORDER_REFLECT,
    by running sums in x's dtype."""
    h, w = x.shape[-2:]
    k = 2 * radius + 1
    xp = x[..., _reflect(h, radius, x.device), :]
    c = torch.nn.functional.pad(torch.cumsum(xp, dim=-2), (0, 0, 1, 0))
    rows = c[..., k:, :] - c[..., :-k, :]
    rp = rows[..., _reflect(w, radius, x.device)]
    c = torch.nn.functional.pad(torch.cumsum(rp, dim=-1), (1, 0))
    return (c[..., k:] - c[..., :-k]) / (k * k)


def guide_stats(guide: torch.Tensor, radius: int, eps: float, held):
    """The guide's part of the filter, [N, 3, H, W] in the compute dtype:
    its box means and the inverse of (covariance + eps I), as the 6
    entries of a symmetric 3x3 matrix; ``held`` rounds what is kept."""
    m = box_mean(guide, radius)
    r, g, b = guide[:, 0], guide[:, 1], guide[:, 2]
    mr, mg, mb = m[:, 0], m[:, 1], m[:, 2]
    prods = torch.stack([r * r, r * g, r * b, g * g, g * b, b * b], dim=1)
    c = box_mean(prods, radius)
    arr = c[:, 0] - mr * mr + eps
    arg = c[:, 1] - mr * mg
    arb = c[:, 2] - mr * mb
    agg = c[:, 3] - mg * mg + eps
    agb = c[:, 4] - mg * mb
    abb = c[:, 5] - mb * mb + eps
    inv = [agg * abb - agb * agb, agb * arb - arg * abb,
           arg * agb - agg * arb, arr * abb - arb * arb,
           arb * arg - arr * agb, arr * agg - arg * arg]
    det = arr * inv[0] + arg * inv[1] + arb * inv[2]
    return m, [held(v / det) for v in inv]


def guided_apply(guide: torch.Tensor, src: torch.Tensor, stats,
                 radius: int, held) -> torch.Tensor:
    """One guided filter of src [N, 1, H, W] from the guide's stats."""
    m, (i00, i01, i02, i11, i12, i22) = stats
    p = src[:, 0]
    mp = box_mean(p, radius)
    cip = box_mean(guide * p[:, None], radius)
    c0 = cip[:, 0] - m[:, 0] * mp
    c1 = cip[:, 1] - m[:, 1] * mp
    c2 = cip[:, 2] - m[:, 2] * mp
    a0 = i00 * c0 + i01 * c1 + i02 * c2
    a1 = i01 * c0 + i11 * c1 + i12 * c2
    a2 = i02 * c0 + i12 * c1 + i22 * c2
    bb = mp - a0 * m[:, 0] - a1 * m[:, 1] - a2 * m[:, 2]
    ma = held(box_mean(held(torch.stack([a0, a1, a2, bb], dim=1)),
                       radius))
    return held(ma[:, 0] * guide[:, 0] + ma[:, 1] * guide[:, 1]
                + ma[:, 2] * guide[:, 2] + ma[:, 3])[:, None]


def guided_chain(guide: torch.Tensor, src: torch.Tensor, radius: int,
                 eps: float, iterations: int = 1,
                 low: bool = False) -> torch.Tensor:
    """The guided filter of src [N, 1, H, W] with the color guide [N, 3,
    H, W] (guide units, 0-255), ``iterations`` times -> float64 [N, 1, H,
    W]."""
    dtype, held = _precision(low)
    guide = held(guide.to(dtype))
    src = held(src.to(dtype))
    stats = guide_stats(guide, radius, eps, held)
    for _ in range(iterations):
        src = guided_apply(guide, src, stats, radius, held)
    return src.to(torch.float64)
