"""Normalized box filter, the plain version (port of
reflectance_filtering_tpu/ops/boxfilter.py).

OpenCV ``boxFilter(..., normalize=true)`` semantics: the mean over a
(2r+1)x(2r+1) window with the border extrapolated by index.

Numerics, kept from the JAX package: a *global* cumulative sum in float32
is not acceptable here.  For 256x256 squared 0-255 guide values an
integral image reaches ~4e9, where the float32 ulp is 512, and the guided
filter's variances are differences of such sums.  Each axis pass instead
uses a *block-local* sliding sum: inclusive/exclusive prefix sums within
blocks of length B >= window, and a window that crosses at most one block
boundary is assembled as

    sum x[i .. i+w-1] = L[i+w-1] - E[i] + (crosses ? T[block(i)] : 0)

with L/E the inclusive/exclusive local prefixes and T the block totals.
Every term is at most B * max|x|, so the rounding error is a few ulps of
(B * max|x|) whatever the image size.

Border modes:
  * 'reflect'    = OpenCV BORDER_REFLECT     (edge pixel repeated: cba|abc)
  * 'reflect101' = OpenCV BORDER_REFLECT_101 (edge pixel not repeated: dcb|abc)
"""
from __future__ import annotations

from typing import Sequence

import torch

from .bilateral import reflect101_index

_BLOCK = 512  # >= any window length used; a power of two


def reflect_index(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each of the n + 2*radius padded positions under
    BORDER_REFLECT (numpy's "symmetric" pad): period 2n, reflecting again
    and again when radius >= n; a 1-wide dimension maps everything to 0.
    ``torch.nn.functional.pad`` has no symmetric mode and refuses pads
    as wide as the image."""
    i = torch.remainder(torch.arange(-radius, n + radius, device=device),
                        2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


_INDEX = {"reflect": reflect_index, "reflect101": reflect101_index}


def check_border(border: str) -> None:
    if border not in _INDEX:
        raise ValueError("border must be 'reflect' or 'reflect101', got "
                         "{!r}".format(border))


def border_index(border: str, n: int, radius: int, device) -> torch.Tensor:
    check_border(border)
    return _INDEX[border](n, radius, device)


def _sliding_sum_last(xp: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """Window sums of length-w windows along the last axis of xp (length
    n_out + w - 1); returns length n_out."""
    if w == 1:
        return xp
    npad = xp.shape[-1]
    block = _BLOCK
    while block < w:  # a block holds a whole window start-to-boundary span
        block *= 2
    nblocks = -(-npad // block)
    total = nblocks * block
    x = torch.nn.functional.pad(xp, (0, total - npad))
    xb = x.reshape(x.shape[:-1] + (nblocks, block))
    incl = torch.cumsum(xb, dim=-1)            # L within the block
    excl = incl - xb                           # E within the block
    tot = incl[..., -1:].expand_as(incl)       # T, broadcast over the block
    L = incl.reshape(x.shape)
    E = excl.reshape(x.shape)
    T = tot.reshape(x.shape)
    i = torch.arange(n_out, device=xp.device)
    crosses = (((i % block) + w) > block).to(xp.dtype)
    return L[..., w - 1:w - 1 + n_out] - E[..., :n_out] + crosses * T[
        ..., :n_out]


def box_filter_axes(x: torch.Tensor, radius: int, axes: Sequence[int],
                    border: str = "reflect",
                    normalize: bool = True) -> torch.Tensor:
    """Box filter of ``x`` over the two spatial ``axes``."""
    if radius == 0:
        return x
    w = 2 * radius + 1
    s = x
    for ax in axes:
        n = x.shape[ax]
        idx = border_index(border, n, radius, x.device)
        s = torch.movedim(s, ax, -1)[..., idx]
        s = torch.movedim(_sliding_sum_last(s, w, n), -1, ax)
    if normalize:
        s = s * (1.0 / (w * w))
    return s


def box_filter(x: torch.Tensor, radius: int, border: str = "reflect",
               normalize: bool = True) -> torch.Tensor:
    """Box filter over a (2r+1)^2 window on the spatial axes.

    Accepts [H, W], [H, W, C] or [N, H, W, C]; the spatial axes are the
    first two for <= 3-D input and axes (1, 2) for 4-D input, as in the
    JAX package."""
    return box_filter_axes(x, radius, (1, 2) if x.dim() == 4 else (0, 1),
                           border, normalize)
