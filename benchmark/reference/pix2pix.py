"""pix2pix's U-Net-256 generator (Isola, Zhu, Zhou and Efros, Image-to-Image
Translation with Conditional Adversarial Networks, CVPR 2017,
arXiv:1611.07004, appendix 6.1.1; ``UnetGenerator`` and
``UnetSkipConnectionBlock`` of github.com/junyanz/pytorch-CycleGAN-and-pix2pix
with ``--netG unet_256 --norm batch``) trained on this system's loss, in
plain PyTorch: NCHW, float32, TF32 off for matmuls and cuDNN.

The layers, with n = num_downs and ngf the first width (widths ngf, 2 ngf,
4 ngf, then 8 ngf), every convolution 4x4 with stride 2 and padding 1 and
without a bias but the last:

* down path: down1 on the input; down2 .. down(n-1) each LeakyReLU(0.2),
  the convolution, BatchNorm; the innermost down n LeakyReLU(0.2) and the
  convolution, to 1x1 at 2**n;
* up path: the innermost up n ReLU, the transposed convolution, BatchNorm;
  then up(n-1) .. up2 each on [the down path's map of that scale, the up
  path's] (the skip first), ReLU, the transposed convolution, BatchNorm;
  the outermost up1 ReLU, the transposed convolution with a bias, tanh.
  The published in-place LeakyReLU overwrites each block's input before
  its concatenation reads it, and the ReLU after makes that ReLU(x): the
  skip is carried as it was;
* BatchNorm is PyTorch's BatchNorm2d: gamma and beta, eps 1e-5, training
  normalising with the batch's biased variance, the running statistics
  moved by running = 0.9 running + 0.1 batch with the unbiased variance
  (:func:`running_statistics`).

Departures from the published network:

* one output channel, the rRelMax estimate, not pix2pix's three;
* the head maps tanh's t to the estimate (1 + t) / 2, pix2pix's own map of
  its output to an image (``util.tensor2im``);
* no dropout: pix2pix's default applies Dropout(0.5) after the three
  512-wide up blocks at 4x4, 8x8 and 16x16, whose masks no reference can
  follow draw for draw; its ``--no_dropout`` option trains without it;
* the input is linear RGB in [0, 1], as every network type of this system
  receives it, not pix2pix's [-1, 1];
* the transposed convolution applies its HWIO kernel K read back to front,
  as the program's ``deconv2d`` does: out[2i + a - 1] gets x[i] K[3 - a]
  (PyTorch's ConvTranspose2d reads K[a]).  With seeded weights this only
  renames the taps.

The loss is the uNet reference's (``reference/unet.py``: rRelMax, 10 x the
WHDR hinge on the reflectance's channel mean and 0.1 x the L1 boundary
losses); Adam (0.9, 0.999, eps 1e-8) is written out.  A gradient is held
to this one past the flips of ReLU inputs that float32 leaves undetermined
in the small maps (``undetermined``, for ``unet.gradient_gaps``).
``low=True``
computes one precision step lower: TF32 on for matmuls and cuDNN and every
convolution's operands rounded to TF32 (the CPU has no TF32), the control
that a comparison has to fail.  Parameters are the program's: {"downI",
"upI": {"kernel": [4, 4, in, out]}, "up1": also "bias", "downI_bn",
"upI_bn": {"gamma", "beta", "mean", "var"}}.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .unet import (ADAM_EPS, BAND_ROUNDING, BETAS, _tf32, floored, loss_of,
                   precision)

KERNEL = 4
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
LEAK = 0.2
RUNNING = ("mean", "var")
# the ReLU and LeakyReLU inputs whose slope float32 leaves undetermined, at
# most, a step, and the largest map they are sought in (``undetermined``):
# a flip moves a leaf by about 1 / sqrt(its map's elements)
BAND_SITES, SMALL_MAP = 24, 1 << 19

Params = Dict[str, Dict[str, torch.Tensor]]


def widths(num_downs: int, ngf: int) -> List[int]:
    """Each down convolution's output width, outermost first."""
    return [ngf * min(2 ** i, 8) for i in range(num_downs)]


def param_shapes(num_downs: int, ngf: int, head: int = 1
                 ) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Each layer's parts and their shapes, the running statistics
    included."""
    w, k, out = widths(num_downs, ngf), KERNEL, {}
    n = num_downs
    for i in range(1, n + 1):
        out["down{}".format(i)] = {"kernel": (k, k, 3 if i == 1
                                              else w[i - 2], w[i - 1])}
        if 1 < i < n:
            out["down{}_bn".format(i)] = {p: (w[i - 1],) for p in
                                          ("gamma", "beta") + RUNNING}
    for i in range(n, 0, -1):
        co = head if i == 1 else w[i - 2]
        out["up{}".format(i)] = {"kernel": (k, k, w[i - 1] * (1 if i == n
                                                              else 2), co)}
        if i > 1:
            out["up{}_bn".format(i)] = {p: (co,) for p in
                                        ("gamma", "beta") + RUNNING}
    out["up1"]["bias"] = (head,)
    return out


def _depth(params: Params) -> int:
    return sum(1 for name in params if re.fullmatch(r"down\d+", name))


def _down(x: torch.Tensor, kernel: torch.Tensor, low: bool) -> torch.Tensor:
    w = kernel.permute(3, 2, 0, 1)
    if low:
        x, w = _tf32(x), _tf32(w)
    return F.conv2d(x, w, stride=2, padding=1)


def _up(x: torch.Tensor, kernel: torch.Tensor, low: bool) -> torch.Tensor:
    """The 4x4 stride-2 transposed convolution, padding 1:
    out[n, o, 2i + a - 1, 2j + b - 1] gets sum_c x[n, c, i, j]
    K[3 - a, 3 - b, c, o], each tap's product written out and added into
    place."""
    k = kernel.flip(0, 1)
    if low:
        x, k = _tf32(x), _tf32(k)
    taps = torch.einsum("nchw,abco->noabhw", x, k)
    n, o, kh, kw, h, w = taps.shape
    full = taps.new_zeros((n, o, 2 * h + kh - 2, 2 * w + kw - 2))
    for a in range(kh):
        for b in range(kw):
            full[:, :, a:a + 2 * h:2, b:b + 2 * w:2] += taps[:, :, a, b]
    return full[:, :, 1:-1, 1:-1]


def _batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]):
    """(y, the batch's mean and unbiased variance, detached)."""
    mean = x.mean(dim=(0, 2, 3))
    centred = x - mean[None, :, None, None]
    var = (centred * centred).mean(dim=(0, 2, 3))
    y = centred / torch.sqrt(var + BN_EPS)[None, :, None, None]
    m = x.numel() // x.shape[1]
    stats = {"mean": mean.detach(), "var": var.detach() * m / (m - 1)}
    return (y * p["gamma"][None, :, None, None]
            + p["beta"][None, :, None, None]), stats


def forward(params: Params, images: torch.Tensor, low: bool = False,
            sites: List[torch.Tensor] = None):
    """images [B, H, W, 3] linear RGB (H, W 2**num_downs) -> (the head's
    estimate [B, 1, H, W], each batch norm's batch statistics).  Each
    ReLU's and LeakyReLU's input is appended to ``sites`` where given."""
    n = _depth(params)
    stats = {}

    def norm(name, x):
        y, stats[name] = _batch_norm(x, params[name])
        return y

    def act(x, leak=0.0):
        if sites is not None:
            sites.append(x)
        return F.leaky_relu(x, leak) if leak else torch.relu(x)

    maps = [_down(images.permute(0, 3, 1, 2), params["down1"]["kernel"],
                  low)]
    for i in range(2, n + 1):
        x = _down(act(maps[-1], LEAK), params["down{}".format(i)]["kernel"],
                  low)
        maps.append(norm("down{}_bn".format(i), x) if i < n else x)
    x = maps.pop()
    for i in range(n, 1, -1):
        x = norm("up{}_bn".format(i), _up(act(x), params[
            "up{}".format(i)]["kernel"], low))
        x = torch.cat([maps.pop(), x], dim=1)
    t = torch.tanh(_up(act(x), params["up1"]["kernel"], low)
                   + params["up1"]["bias"][None, :, None, None])
    return (1.0 + t) * 0.5, stats


def loss(params: Params, images: torch.Tensor, comps: torch.Tensor,
         low: bool = False):
    """(the step's loss, the batch statistics): images [B, H, W, 3],
    comps [B, K+1, 6]."""
    with precision(low):
        est, stats = forward(params, images, low)
    return loss_of(floored(est), images, comps), stats


def trainable(params: Params) -> List[Tuple[str, str]]:
    """The (layer, part) keys that Adam trains: all but the running
    statistics."""
    return [(n, k) for n in params for k in params[n] if k not in RUNNING]


def gradient(params: Params, images: torch.Tensor, comps: torch.Tensor,
             low: bool = False):
    """(the loss, its gradient nested as the trainable parts, the batch
    statistics)."""
    params = {n: {k: v.detach().clone().requires_grad_(k not in RUNNING)
                  for k, v in p.items()} for n, p in params.items()}
    keys = trainable(params)
    value, stats = loss(params, images, comps, low)
    with precision(low):
        g = iter(torch.autograd.grad(value, [params[n][k]
                                             for n, k in keys]))
    grad: Params = {}
    for n, k in keys:
        grad.setdefault(n, {})[k] = next(g)
    return float(value.detach()), grad, stats


def running_statistics(params: Params, stats: Dict) -> Params:
    """Each batch norm's running mean and variance after a step: PyTorch's
    rule from the running ones before (``params``) and the step's batch
    statistics (``stats``)."""
    return {name: {k: (1.0 - BN_MOMENTUM) * params[name][k].detach()
                   + BN_MOMENTUM * batch[k] for k in RUNNING}
            for name, batch in stats.items()}


def adam_step(params: Params, state: Dict, images: torch.Tensor,
              comps: torch.Tensor, lr: float, low: bool = False):
    """One Adam step from ``params`` and Adam's ``state`` ({"count",
    "mu", "nu"}, the moments nested as the trainable parts; count 0 and
    no moments at the start) -> (the loss, the gradients, the params
    after, their running statistics moved, the state after)."""
    value, grad, stats = gradient(params, images, comps, low)
    b1, b2 = BETAS
    t = state.get("count", 0) + 1
    new = {"count": t, "mu": {}, "nu": {}}
    after = {n: {k: v.detach() for k, v in p.items()}
             for n, p in params.items()}
    with torch.no_grad():
        for n, k in trainable(params):
            gk = grad[n][k]
            mu = state["mu"][n][k] if "mu" in state else 0.0
            nu = state["nu"][n][k] if "nu" in state else 0.0
            new["mu"].setdefault(n, {})[k] = b1 * mu + (1 - b1) * gk
            new["nu"].setdefault(n, {})[k] = b2 * nu + (1 - b2) * gk * gk
            mhat = new["mu"][n][k] / (1 - b1 ** t)
            vhat = new["nu"][n][k] / (1 - b2 ** t)
            after[n][k] = after[n][k] - lr * mhat / (vhat.sqrt() + ADAM_EPS)
        for name, moved in running_statistics(params, stats).items():
            after[name].update(moved)
    return value, grad, after, new


def adam_steps(params0: Params, batches: List[Tuple[torch.Tensor,
                                                     torch.Tensor]],
               lr: float, low: bool = False):
    """Adam from ``params0`` over ``batches``, one step each -> (each
    step's loss, gradients, params after and state after)."""
    params, state, out = params0, {}, []
    for images, comps in batches:
        value, grad, params, state = adam_step(params, state, images, comps,
                                               lr, low)
        out.append((value, grad, params, state))
    return out



def undetermined(params: Params, images: torch.Tensor, comps: torch.Tensor):
    """The part of the gradient that float32 does not determine, from the
    reference's own float32 and float64 runs alone, in the form
    ``unet.gradient_gaps`` takes: (the gradients [m, P] (float64, the
    trained parts flattened in ``trainable``'s order) of the ReLU and
    LeakyReLU inputs that float32 may put on either side of 0, in the
    maps of at most SMALL_MAP elements, the nearest first, BAND_SITES at
    most; zeros [P]; 0, as a flip at 0 does not move the loss).

    An input within float32's rounding of 0 takes either slope, which adds
    or drops the gradient that reaches the layers below through it: about
    1 / sqrt(its map's elements) of a leaf, ~1e-2 in the innermost maps
    at 20 x 256x256.  The ~100 flips a step in the larger maps move a leaf
    by a few 1e-3 together, which the limit holds.  An input's rounding is
    BAND_ROUNDING x the gap between its float32 and its float64 value.
    ``comps`` is unused: the flips depend on the network alone."""
    del comps
    p32 = {a: {k: v.float() for k, v in q.items()} for a, q in params.items()}
    leaves = {a: {k: v.detach().double().requires_grad_(k not in RUNNING)
                  for k, v in q.items()} for a, q in params.items()}
    keys = trainable(leaves)
    s32, s64 = [], []
    with torch.no_grad(), precision(False):
        forward(p32, images.float(), sites=s32)
    with precision(False):
        forward(leaves, images.double(), sites=s64)
        picked = []
        for j, (a32, a64) in enumerate(zip(s32, s64)):
            if a64.numel() > SMALL_MAP:
                continue
            a64 = a64.detach().reshape(-1)
            rounding = BAND_ROUNDING * (a32.double().reshape(-1) - a64).abs()
            near = a64.abs() / rounding.clamp_min(
                torch.finfo(torch.float64).tiny)
            picked += [(float(near[e]), j, e) for e in
                       (near < 1.0).nonzero().reshape(-1).tolist()]
        rows = []
        for _, j, e in sorted(picked)[:BAND_SITES]:
            got = torch.autograd.grad(s64[j].reshape(-1)[e],
                                      [leaves[a][k] for a, k in keys],
                                      retain_graph=True, allow_unused=True)
            rows.append(torch.cat([
                (torch.zeros_like(leaves[a][k]) if g is None else g)
                .reshape(-1) for (a, k), g in zip(keys, got)]))
    size = sum(leaves[a][k].numel() for a, k in keys)
    noise = torch.zeros(size, dtype=torch.float64, device=images.device)
    rows = torch.stack(rows) if rows else noise.new_zeros((0, size))
    return rows, noise, 0.0
