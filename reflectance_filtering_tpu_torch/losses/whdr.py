"""WHDR metric and WHDR hinge loss (port of
reflectance_filtering_tpu/losses/whdr.py).

Reference semantics (the reference's training/layers/whdr_layer.py):

  * exact Bell-2014 WHDR: per comparison classify l2/l1 > 1+delta ->
    darker 1, l1/l2 > 1+delta -> darker 2, else E(0); error = sum of
    weights where the human label disagrees; whdr = error_sum / weight_sum
    (0 if weight_sum == 0).
  * lightness L = max(float32_eps, mean(RGB)) for 3 channels, max(eps, r)
    for 1 channel.
  * normalized coords scaled by width/height and *truncated* to int.

  * hinge (whdr_hinge_loss_layer.py:126-230): y = L1/L2; darker 1:
    max(0, y - 1/(1+d+m)); darker 2: max(0, (1+d+m) - y); darker E, m<=d:
    two-sided hinge outside [1/(1+d-m), 1+d-m]; m>d: max(1/border - y,
    y - border).  Per-image normalization by the evaluated weight sum, then
    the batch mean; dense-skip, ratio subsampling and the 1500 cap select
    the evaluated comparisons.

The comparisons blob is the packed format [K+1, 6] per image: rows
[x1, y1, x2, y2, darker, weight] (normalized coords, NaN padded), last row
metadata [num_comparisons, ...].  The batched gather goes through
``ops.whdr_gather.gather_pairs`` (K3 on CUDA, with K8 as its backward);
classify, hinge and reduce are plain torch.  Lightness is floored at eps
with ``torch.maximum``, which splits the gradient evenly at a tie as
``jnp.maximum`` does.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.whdr_gather import gather_pairs, gather_pairs_plain
from ..utils.profiling import span

EPS = np.float32(np.finfo(np.float32).eps)
MAX_EVALUATED_COMPARISONS = 1500  # whdr_hinge_loss_layer.py:36
DENSE_SKIP_THRESHOLD = 300        # whdr_hinge_loss_layer.py:136-138


def _indices(rows: torch.Tensor, valid: torch.Tensor, height: int,
             width: int):
    """Truncated, clipped int32 pixel coordinates and labels of the rows
    [..., K, 6]; invalid (padded) rows read as zeros."""
    safe = torch.where(valid[..., None], rows, torch.zeros_like(rows))

    def coord(col, n):
        return torch.clamp((safe[..., col] * n).to(torch.int32), 0, n - 1)

    return (coord(0, width), coord(1, height), coord(2, width),
            coord(3, height), safe[..., 4].to(torch.int32), safe[..., 5])


def comparisons_to_pixel_indices(comparisons: torch.Tensor, height: int,
                                 width: int):
    """Split a [K+1, 6] padded comparisons blob into gather-ready pieces.

    Returns (x1, y1, x2, y2, darker, weight, valid_mask, num_comparisons)
    where coordinates are int32 pixel indices clamped into bounds.
    """
    num = comparisons[-1, 0].to(torch.int32)
    rows = comparisons[:-1]
    valid = torch.arange(rows.shape[0], device=rows.device) < num
    x1, y1, x2, y2, darker, weight = _indices(rows, valid, height, width)
    return x1, y1, x2, y2, darker, weight, valid, num


def _floor_eps(lightness: torch.Tensor) -> torch.Tensor:
    # new_full fills on the device: torch.tensor(EPS, device=...) would
    # copy from the host and wait for the stream on every call
    return torch.maximum(lightness, lightness.new_full((), float(EPS)))


def _classify_error(l1, l2, darker, weight, valid, delta: float):
    """Per-comparison-set error and weight sums over the last axis."""
    alg = torch.where(l2 / l1 > 1 + delta, 1,
                      torch.where(l1 / l2 > 1 + delta, 2, 0))
    zero = torch.zeros_like(weight)
    err = torch.where(valid & (alg != darker), weight, zero).sum(dim=-1)
    wsum = torch.where(valid, weight, zero).sum(dim=-1)
    return torch.where(wsum > 0, err / wsum, torch.zeros_like(wsum))


def whdr(reflectance: torch.Tensor, comparisons: torch.Tensor,
         delta: float = 0.1) -> torch.Tensor:
    """Exact Bell-2014 WHDR for one image.

    reflectance: [H, W, C] linear; comparisons: [K+1, 6] padded blob.
    Returns a float32 scalar in [0, 1].
    """
    h, w = reflectance.shape[:2]
    x1, y1, x2, y2, darker, weight, valid, _ = comparisons_to_pixel_indices(
        comparisons, h, w)
    l1 = _floor_eps(reflectance[y1.long(), x1.long()].mean(dim=-1))
    l2 = _floor_eps(reflectance[y2.long(), x2.long()].mean(dim=-1))
    return _classify_error(l1, l2, darker, weight, valid, delta)


def _batch_lightness_pairs(reflectance: torch.Tensor,
                           comparisons: torch.Tensor, kernels: bool = True):
    """Batched gather: (l1, l2, darker, weight, valid, num), each [B, K].

    reflectance [B, H, W] or [B, H, W, C]; lightness (the channel mean)
    commutes with the pixel gather, so the plane is reduced first and the
    pairs come from ``gather_pairs`` (K3 on CUDA, indexing on the CPU), or
    from its plain version on any device when ``kernels`` is false."""
    b, h, w = reflectance.shape[:3]
    k = comparisons.shape[1] - 1
    num = comparisons[:, -1, 0].to(torch.int32)
    rows = comparisons[:, :-1, :]
    valid = (torch.arange(k, device=rows.device)[None, :] < num[:, None])
    x1, y1, x2, y2, darker, weight = _indices(rows, valid, h, w)
    plane = (reflectance if reflectance.dim() == 3
             else reflectance.mean(dim=-1))
    gather = gather_pairs if kernels else gather_pairs_plain
    l1, l2 = gather(plane.contiguous(), y1.contiguous(), x1.contiguous(),
                    y2.contiguous(), x2.contiguous())
    return _floor_eps(l1), _floor_eps(l2), darker, weight, valid, num


def _whdr_per_image(reflectance, comparisons, delta, kernels):
    l1, l2, darker, weight, valid, _ = _batch_lightness_pairs(
        reflectance, comparisons, kernels)
    return _classify_error(l1, l2, darker, weight, valid, delta)


def whdr_per_image(reflectance: torch.Tensor, comparisons: torch.Tensor,
                   delta: float = 0.1, kernels: bool = True) -> torch.Tensor:
    """Per-image WHDR [B].  reflectance [B,H,W] or [B,H,W,C], comparisons
    [B,K+1,6] on the same device."""
    with span("whdr.per_image"):
        return _whdr_per_image(reflectance, comparisons, delta, kernels)


def whdr_batch(reflectance: torch.Tensor, comparisons: torch.Tensor,
               delta: float = 0.1, kernels: bool = True) -> torch.Tensor:
    """Batch mean WHDR (the mean of the per-image values).  No span: the
    training step calls it, and a captured step's code runs only at its
    capture."""
    return _whdr_per_image(reflectance, comparisons, delta, kernels).mean()


@functools.lru_cache(maxsize=16)
def _ratio_table(ratio: float, k: int, device: torch.device) -> torch.Tensor:
    """int(np.ceil(ratio * n)) for n = 0..k, an int32 table made once on
    ``device`` in float64 (numpy's rounding): a training step captured in a
    CUDA graph copies nothing from the host."""
    n = torch.arange(k + 1, dtype=torch.float64, device=device)
    return torch.ceil(ratio * n).to(torch.int32)


def _ratio_ceil(num_eval: torch.Tensor, ratio: float, k: int) -> torch.Tensor:
    """Exact reference subsample count int(np.ceil(ratio * n)) in float64
    (whdr_hinge_loss_layer.py:139-140), from :func:`_ratio_table`."""
    return _ratio_table(ratio, k, num_eval.device)[num_eval.long()]


def _hinge_per_comparison(y: torch.Tensor, darker: torch.Tensor,
                          delta: float, margin: float) -> torch.Tensor:
    """Hinge loss for one ratio y given the human label
    (whdr_hinge_loss_layer.py:183-221)."""
    b12 = 1.0 + delta + margin
    loss1 = torch.relu(y - 1.0 / b12)           # darker == 1
    loss2 = torch.relu(b12 - y)                 # darker == 2
    if margin <= delta:
        br = 1.0 + delta - margin
        loss0 = torch.relu(y - br) + torch.relu(1.0 / br - y)
    else:
        border = 1.0 + delta - margin
        loss0 = torch.maximum(1.0 / border - y, y - border)
        # Documented gradient deviation, kept from the JAX package (loss
        # values match the reference): for margin > delta the reference
        # hand-codes dl/dy = sign(y - 1), while autodiff of the max gives
        # -1 wherever the first arm dominates, up to y = (border +
        # 1/border)/2 > 1.  The autodiff subgradient is the one of the loss
        # as written.  margin > delta is outside every shipped config.
    return torch.where(darker == 1, loss1,
                       torch.where(darker == 2, loss2, loss0))


def _eval_selection_mask(valid: torch.Tensor, num: torch.Tensor,
                         ratio: float, eval_dense: bool,
                         generator: Optional[torch.Generator],
                         k: int, draw_rows: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """Which comparisons get evaluated (whdr_hinge_loss_layer.py:136-148):
    a prefix of num_eval rows (dense-skip, then the ratio), and above
    MAX_EVALUATED_COMPARISONS a uniform choice of that many without
    replacement, drawn from ``generator`` (torch's numbers, not
    ``jax.random``'s; training selects on the host instead,
    :func:`select_comparisons_host`).  ``draw_rows=(offset, total)``: the
    rows are rows offset.. of a batch of ``total``, whose draw is made
    whole and sliced (a data-parallel rank draws the global batch's)."""
    num_eval = num
    if not eval_dense:
        num_eval = torch.where(num > DENSE_SKIP_THRESHOLD,
                               torch.ones_like(num), num_eval)
    if ratio < 1.0:
        num_eval = _ratio_ceil(num_eval, ratio, k)
    mask = torch.arange(k, device=num.device) < num_eval[..., None]
    if k > MAX_EVALUATED_COMPARISONS:
        if generator is None:
            raise ValueError(
                "{} comparison rows exceed MAX_EVALUATED_COMPARISONS ({}): "
                "select them on the host (select_comparisons_host) or pass a "
                "generator for the capped draw".format(
                    k, MAX_EVALUATED_COMPARISONS))
        if draw_rows is None:
            r = torch.rand(tuple(num_eval.shape) + (k,), generator=generator,
                           device=num.device)
        else:
            offset, total = draw_rows
            r = torch.rand((total, k), generator=generator,
                           device=num.device)[offset:offset + len(num_eval)]
        r = torch.where(mask, r, torch.full_like(r, 2.0))  # unselected last
        rank = torch.argsort(torch.argsort(r, dim=-1), dim=-1)
        cap_mask = rank < MAX_EVALUATED_COMPARISONS
        mask = torch.where((num_eval > MAX_EVALUATED_COMPARISONS)[..., None],
                           mask & cap_mask, mask)
    return mask & valid


def select_comparisons_host(blob: np.ndarray, ratio: float,
                            eval_dense: bool,
                            rng: np.random.RandomState,
                            cap: int = None) -> np.ndarray:
    """Host-side evaluation selection for oversized comparison blobs (the
    'augmented' K=60,049 case): the dense-skip / ratio / cap rules of
    :func:`_eval_selection_mask` in numpy, the selected rows packed into a
    compact [B, cap+1, 6] blob (NaN padded, metadata row [m, file, 0]).
    Feeding the compact blob with ratio=1, eval_dense=True is the same
    hinge as masking the full blob.  The cap draw uses ``rng`` (uniform,
    without replacement); key it by the global step.  A verbatim copy of
    the JAX package's, so both select the same rows from the same rng."""
    if cap is None:
        cap = MAX_EVALUATED_COMPARISONS
    b, k1, _ = blob.shape
    k = k1 - 1
    out = np.full((b, cap + 1, 6), np.nan, blob.dtype)
    for i in range(b):
        num = int(blob[i, -1, 0])
        num_eval = num
        if not eval_dense and num > DENSE_SKIP_THRESHOLD:
            num_eval = 1
        if ratio < 1.0:
            num_eval = int(np.ceil(ratio * float(num_eval)))
        num_eval = min(num_eval, k)
        if num_eval > cap:
            sel = np.sort(rng.choice(num_eval, cap, replace=False))
        else:
            sel = np.arange(num_eval)
        m = len(sel)
        out[i, :m] = blob[i, sel]
        out[i, cap, 0] = m
        out[i, cap, 1] = blob[i, -1, 1]
        out[i, cap, 2] = 0
    return out


def whdr_hinge(reflectance: torch.Tensor, comparisons: torch.Tensor,
               delta: float = 0.1, margin: float = 0.05, ratio: float = 1.0,
               eval_dense: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Differentiable WHDR hinge loss for one image
    (whdr_hinge_loss_layer.py:93-162): reflectance [H, W, C], comparisons
    [K+1, 6].  Returns a float32 scalar."""
    h, w = reflectance.shape[:2]
    x1, y1, x2, y2, darker, weight, valid, num = comparisons_to_pixel_indices(
        comparisons, h, w)
    mask = _eval_selection_mask(valid, num, ratio, eval_dense, generator,
                                valid.shape[0])
    l1 = _floor_eps(reflectance[y1.long(), x1.long()].mean(dim=-1))
    l2 = _floor_eps(reflectance[y2.long(), x2.long()].mean(dim=-1))
    loss = _hinge_per_comparison(l1 / l2, darker, delta, margin)
    zero = torch.zeros_like(weight)
    err = torch.where(mask, weight * loss, zero).sum()
    wsum = torch.where(mask, weight, zero).sum()
    return torch.where(wsum > 0, err / torch.where(wsum > 0, wsum, 1.0),
                       torch.zeros_like(wsum))


def whdr_hinge_batch(reflectance: torch.Tensor, comparisons: torch.Tensor,
                     delta: float = 0.1, margin: float = 0.05,
                     ratio: float = 1.0, eval_dense: bool = True,
                     generator: Optional[torch.Generator] = None,
                     kernels: bool = True,
                     draw_rows: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Batch-mean hinge loss (whdr_hinge_loss_layer.py:102-110):
    reflectance [B,H,W] or [B,H,W,C], comparisons [B,K+1,6].  The pairs
    come from one batched gather (K3 on CUDA), whose backward is one
    scatter-add (K8); ``kernels=False`` gathers with the plain version.
    ``draw_rows``: see :func:`_eval_selection_mask`."""
    k = comparisons.shape[1] - 1
    l1, l2, darker, weight, valid, num = _batch_lightness_pairs(
        reflectance, comparisons, kernels)
    mask = _eval_selection_mask(valid, num, ratio, eval_dense, generator, k,
                                draw_rows)
    loss = _hinge_per_comparison(l1 / l2, darker, delta, margin)
    zero = torch.zeros_like(weight)
    err = torch.where(mask, weight * loss, zero).sum(dim=1)
    wsum = torch.where(mask, weight, zero).sum(dim=1)
    per_img = torch.where(wsum > 0, err / torch.where(wsum > 0, wsum, 1.0),
                          torch.zeros_like(wsum))
    return per_img.mean()


def parse_wdm_string(wdm: str):
    """Parse the reference's underscore-packed '0.1_0.05_1.0_1' flag
    (whdr_hinge_loss_layer.py:58-80)."""
    if wdm == "":
        return 0.1, 0.0, 1.0, True
    parts = wdm.split("_")
    if len(parts) != 4:
        raise ValueError(
            "parameters to WhdrHingeLoss were not as expected: {} — need "
            "delta_margin_ratio_dense".format(wdm))
    delta, margin, ratio = float(parts[0]), float(parts[1]), float(parts[2])
    eval_dense = bool(int(parts[3]))
    assert delta >= 0 and margin >= 0 and 0 < ratio <= 1
    return delta, margin, ratio, eval_dense
