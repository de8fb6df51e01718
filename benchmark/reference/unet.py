"""The reference's two-stream uNet (create_uNet, training/networks.py:304-507
of github.com/tnestmeyer/reflectance-filtering; the local/global streams of
Narihira, Maire and Yu, Direct Intrinsics, ICCV 2015) and one training step
of it, in plain PyTorch: NCHW, float32, TF32 off for matmuls and cuDNN.

The layer list, with n = numLayers and k = 2 kernel_pad + 1 (a ReLU after
every conv but the head):

* local stream: Conv1 3x3 s2 3->16, n k x k 16->16 (d1); Conv2 3x3 s2
  16->32, n (d2); Conv3 3x3 s2 32->64, n (d3); Conv4 7x7 64->64 at 1/8
  resolution, n (d4);
* global stream on a fixed 256x256 resize of the input: Conv5 5x5 s4 3->32,
  Conv6 5x5 s4 32->32, Conv7 5x5 s4 32->32, Conv8 3x3 pad 0 32->64, the
  spatial mean broadcast over the local map;
* combination: the concat (128), n k x k (comb), comb_final 3x3 -> 64;
* up path, three times: a 2x2 stride-2 deconvolution (up3 64->64, up2
  32->16, up1 16->3), the concat with the skip of that scale (l2, l1, the
  input), n k x k convs and a 3x3 final (r2 -> 32, r1 -> 16; at full
  resolution n convs 6->3 (out) and the 3x3 head, no ReLU).

Departures from the published network, each a reconstruction:

* ``resize_layer`` and ``broadcast_layer`` are PythonLayers that the
  reference repository does not ship.  The resize is taken as bilinear
  with half-pixel centres, antialiased where it shrinks (as
  ``jax.image.resize``); the broadcast as the spatial mean of Conv8's
  output, repeated over the local stream's map.
* The deconvolution applies its HWIO kernel read back to front
  (out[2i + a] = x[i] K[1 - a]), as ``lax.conv_transpose`` without
  ``transpose_kernel`` does; caffe's reads it front to back.  With seeded
  weights this only renames the taps.

The head is rRelMax (reflectance = max(estimate, eps) x image / max over
colour of the image); the loss is 10 x the WHDR hinge (delta 0.1, margin
0.05) on the reflectance's channel mean plus 0.1 x the L1 boundary losses
of reflectance and shading; Adam (0.9, 0.999, eps 1e-8) is written out.

``low=True`` computes one precision step lower: TF32 on for matmuls and
cuDNN, and every product's operands rounded to TF32 in the forward (the
CPU has no TF32).  That is the control that a comparison has to fail.
Parameters are {name: {"kernel": [kh, kw, in, out], "bias": [out]}}.

A gradient is held to this one by ``gradient_gaps``, past the part that
float32 leaves undetermined near rRelMax's floor (``undetermined``, from
this reference's own float32 and float64 runs).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

GLOBAL_SIZE = 256
LOSS_SCALE_WHDR, LOSS_SCALE_BOUNDARIES = 10.0, 0.1
DELTA, MARGIN = 0.1, 0.05
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
EPS = float(torch.finfo(torch.float32).eps)
# the pixels whose weight float32 leaves undetermined, at most, a step:
# those of the largest uncertain weight (``undetermined``)
BAND_PIXELS = 1024
# a pixel's rounding, in units of the gap between the float32 and the
# float64 estimate there (another float32 program rounds otherwise)
BAND_ROUNDING = 16.0
# the rows of the estimate's Jacobian one batched backward takes
JACOBIAN_ROWS = 32
# random-sign draws of the move that the other pixels' uncertain weights
# give the gradient, and the multiple of its typical size a leaf's gap is
# discounted by (``gradient_gaps``)
NOISE_DRAWS, NOISE_SIGMAS = 4, 3.0

Params = Dict[str, Dict[str, torch.Tensor]]


def param_shapes(num_layers: int, kernel: int, head: int = 1
                 ) -> Dict[str, Tuple[int, int, int, int]]:
    """Each layer's kernel shape (kh, kw, in, out), in the reference's
    order."""
    n, k, out = num_layers, kernel, {}

    def conv(name, kk, ci, co):
        out[name] = (kk, kk, ci, co)

    def block(name, ci, co):
        for i in range(n):
            conv("{}_{}".format(name, i), k, ci if i == 0 else co, co)

    conv("Conv1", 3, 3, 16)
    block("d1", 16, 16)
    conv("Conv2", 3, 16, 32)
    block("d2", 32, 32)
    conv("Conv3", 3, 32, 64)
    block("d3", 64, 64)
    conv("Conv4", 7, 64, 64)
    block("d4", 64, 64)
    conv("Conv5", 5, 3, 32)
    conv("Conv6", 5, 32, 32)
    conv("Conv7", 5, 32, 32)
    conv("Conv8", 3, 32, 64)
    block("comb", 128, 64)
    conv("comb_final", 3, 128 if n == 0 else 64, 64)
    conv("up3", 2, 64, 64)
    block("r2", 32 + 64, 32)
    conv("r2_final", 3, 32 + 64 if n == 0 else 32, 32)
    conv("up2", 2, 32, 16)
    block("r1", 16 + 16, 16)
    conv("r1_final", 3, 16 + 16 if n == 0 else 16, 16)
    conv("up1", 2, 16, 3)
    block("out", 3 + 3, 3)
    conv("head", 3, 3 + 3 if n == 0 else 3, head)
    return out


@contextlib.contextmanager
def precision(low: bool):
    """TF32 off for matmuls and cuDNN (on with ``low``) inside the
    block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest) in the
    forward, its gradient passed through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


def _conv(p, x, stride, pad, low):
    w = p["kernel"].permute(3, 2, 0, 1)
    if low:
        x, w = _tf32(x), _tf32(w)
    return F.conv2d(x, w, p["bias"], stride=stride, padding=pad)


def _deconv(p, x, low):
    """The 2x2 stride-2 deconvolution: out[n, o, 2i + a, 2j + b] =
    bias[o] + sum_c x[n, c, i, j] K[1 - a, 1 - b, c, o]."""
    k = p["kernel"].flip(0, 1)
    if low:
        x, k = _tf32(x), _tf32(k)
    y = torch.einsum("nchw,abco->nohawb", x, k)
    n, o, h, _, w, _ = y.shape
    return y.reshape(n, o, 2 * h, 2 * w) + p["bias"][None, :, None, None]


def estimate(params: Params, images: torch.Tensor, num_layers: int,
             kernel_pad: int, low: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] linear RGB (H, W multiples of 8) -> the head's
    estimate [B, 1, H, W]."""
    n, p = num_layers, kernel_pad
    x0 = images.permute(0, 3, 1, 2)

    def conv(name, x, stride=1, pad=None):
        return _conv(params[name], x, stride, p if pad is None else pad, low)

    def relu_convs(name, x, count):
        for i in range(count):
            x = torch.relu(conv("{}_{}".format(name, i), x))
        return x

    l1 = relu_convs("d1", torch.relu(conv("Conv1", x0, 2, 1)), n)
    l2 = relu_convs("d2", torch.relu(conv("Conv2", l1, 2, 1)), n)
    l3 = relu_convs("d3", torch.relu(conv("Conv3", l2, 2, 1)), n)
    local = relu_convs("d4", torch.relu(conv("Conv4", l3, 1, 3)), n)

    g = F.interpolate(x0, size=(GLOBAL_SIZE, GLOBAL_SIZE), mode="bilinear",
                      align_corners=False, antialias=True)
    for name in ("Conv5", "Conv6", "Conv7"):
        g = torch.relu(conv(name, g, 4, 2))
    g = torch.relu(conv("Conv8", g, 1, 0))
    g = g.mean(dim=(2, 3), keepdim=True).expand(-1, -1, *local.shape[2:])

    def stage(name, x):
        return torch.relu(conv(name + "_final", relu_convs(name, x, n),
                               pad=1))

    r3 = stage("comb", torch.cat([local, g], dim=1))
    r2 = stage("r2", torch.cat([l2, _deconv(params["up3"], r3, low)], dim=1))
    r1 = stage("r1", torch.cat([l1, _deconv(params["up2"], r2, low)], dim=1))
    x = relu_convs("out", torch.cat([x0, _deconv(params["up1"], r1, low)],
                                    dim=1), n)
    return conv("head", x, pad=1)


def recover_rrelmax(r_i: torch.Tensor, images: torch.Tensor):
    """rRelMax from the estimate floored at eps, ``r_i`` [B, 1, H, W]:
    (reflectance, shading), NCHW [B, 3, H, W]; images NHWC."""
    x = images.permute(0, 3, 1, 2)
    intensity = torch.amax(x, dim=1, keepdim=True)
    intensity = torch.maximum(intensity, intensity.new_full((), EPS))
    return r_i * (x / intensity), (intensity / r_i).expand_as(x)


def floored(est: torch.Tensor) -> torch.Tensor:
    """rRelMax's floor: the estimate, at least eps."""
    return torch.maximum(est, est.new_full((), EPS))


def boundary_l1(rgb: torch.Tensor) -> torch.Tensor:
    """The mean distance of the channel mean outside [0, 1]; NCHW."""
    i = rgb.mean(dim=1)
    return torch.mean(torch.relu(-i) + torch.relu(i - 1.0))


def whdr_hinge(plane: torch.Tensor, comps: torch.Tensor,
               through: bool = False) -> torch.Tensor:
    """The batch mean of the per-image WHDR hinge (every comparison
    evaluated) of the lightness plane [B, H, W] on the packed blobs [B, K+1,
    6]: rows [x1, y1, x2, y2, darker, weight] in normalized coordinates
    (truncated to pixels), NaN padded, the last row [num, ...].  A
    gathered lightness is floored at eps; ``through`` passes the gradient
    through the floor, as though the value lay just above it."""
    b, h, w = plane.shape
    k = comps.shape[1] - 1
    num = comps[:, -1, 0].to(torch.int64)
    rows = comps[:, :-1]
    valid = torch.arange(k, device=comps.device)[None] < num[:, None]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    flat = plane.reshape(b, h * w)

    def at(cx, cy):
        x = torch.clamp((rows[..., cx] * w).to(torch.int32), 0, w - 1)
        y = torch.clamp((rows[..., cy] * h).to(torch.int32), 0, h - 1)
        got = torch.gather(flat, 1, y.to(torch.int64) * w + x)
        low = torch.maximum(got, got.new_full((), EPS))
        return got + (low - got).detach() if through else low

    y = at(0, 1) / at(2, 3)
    darker, weight = rows[..., 4].to(torch.int64), rows[..., 5]
    b12, br = 1.0 + DELTA + MARGIN, 1.0 + DELTA - MARGIN
    loss = torch.where(
        darker == 1, torch.relu(y - 1.0 / b12),
        torch.where(darker == 2, torch.relu(b12 - y),
                    torch.relu(y - br) + torch.relu(1.0 / br - y)))
    zero = torch.zeros_like(weight)
    err = torch.where(valid, weight * loss, zero).sum(dim=1)
    wsum = torch.where(valid, weight, zero).sum(dim=1)
    per = torch.where(wsum > 0, err / torch.where(wsum > 0, wsum, 1.0),
                      torch.zeros_like(wsum))
    return per.mean()


def loss_of(r_i: torch.Tensor, images: torch.Tensor, comps: torch.Tensor,
            boundaries: float = LOSS_SCALE_BOUNDARIES,
            through: bool = False) -> torch.Tensor:
    """The step's loss from the floored estimate ``r_i``: 10 x the WHDR
    hinge (``through`` as there) plus ``boundaries`` x the boundary losses
    (none at 0)."""
    refl, shading = recover_rrelmax(r_i, images)
    value = LOSS_SCALE_WHDR * whdr_hinge(refl.mean(dim=1), comps, through)
    if boundaries:
        value = value + boundaries * (boundary_l1(refl)
                                      + boundary_l1(shading))
    return value


def loss(params: Params, images: torch.Tensor, comps: torch.Tensor,
         num_layers: int, kernel_pad: int, low: bool = False,
         boundaries: float = LOSS_SCALE_BOUNDARIES) -> torch.Tensor:
    """The step's loss: images [B, H, W, 3] linear RGB, comps [B, K+1,
    6]; ``boundaries`` 0 leaves the WHDR term alone."""
    with precision(low):
        est = estimate(params, images, num_layers, kernel_pad, low)
    return loss_of(floored(est), images, comps, boundaries)


def gradient(params: Params, images: torch.Tensor, comps: torch.Tensor,
             num_layers: int, kernel_pad: int, low: bool = False,
             boundaries: float = LOSS_SCALE_BOUNDARIES):
    """(the loss, its gradient nested as ``params``)."""
    params = {n: {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()} for n, p in params.items()}
    leaves = [params[n][k] for n in params for k in params[n]]
    value = loss(params, images, comps, num_layers, kernel_pad, low,
                 boundaries)
    with precision(low):
        g = iter(torch.autograd.grad(value, leaves))
    return float(value.detach()), {n: {k: next(g) for k in params[n]}
                                   for n in params}


def undetermined(params: Params, images: torch.Tensor, comps: torch.Tensor,
                 num_layers: int, kernel_pad: int,
                 boundaries: float = LOSS_SCALE_BOUNDARIES):
    """The part of the gradient that float32 does not determine, from the
    reference's own float32 and float64 runs alone: (the estimate's
    gradients [m, P] (float64, the parameters flattened in ``params``'
    order) at the pixels that float32 may put on either side of a floor,
    those of the largest weight first, BAND_PIXELS at most; the typical
    move [P] that the other pixels' uncertain weights give the gradient,
    element by element; how far the estimate's rounding can move the
    loss, to first order).

    A pixel's weight is the loss's derivative by its estimate.  Near
    rRelMax's eps floor it is undetermined: the boundary loss of the
    shading weighs a pixel by 1 / estimate^2, and the WHDR hinge a
    comparison's darker side by its ratio over it; so too where the hinge
    floors a gathered lightness (the estimate times the mean over colour
    of image / intensity) at eps.  A pixel's rounding is
    BAND_ROUNDING x the gap between the float32 and the float64 estimate
    there, and at least the batch's widest such gap (cuDNN's estimate was
    seen off by up to 1e5 times this gap at a pixel, never past the
    batch's widest: 3 seeds at 20 x 512x512).  Its uncertain weight is
    its weight times the relative move of 1 / estimate^2 over that
    rounding, or its whole weight just above a floor where the rounding
    reaches it: float32 may put it on either side, so the gradient's part
    along its gradient is left out, and the rest is a random move."""
    n, p = num_layers, kernel_pad
    p32 = {a: {k: v.float() for k, v in q.items()} for a, q in params.items()}
    p64 = {a: {k: v.double() for k, v in q.items()} for a, q in params.items()}
    images32 = images.float()
    with torch.no_grad(), precision(False):
        est32 = estimate(p32, images32, n, p).double()
        est64 = estimate(p64, images.double(), n, p)
    images64, comps64 = images.double(), comps.double()
    est64.requires_grad_(True)
    weight, = torch.autograd.grad(loss_of(floored(est64), images64, comps64,
                                          boundaries), est64)
    weight = weight.abs()
    est64 = est64.detach()
    r_i = floored(est64).requires_grad_(True)
    above, = torch.autograd.grad(
        loss_of(r_i, images64, comps64, boundaries, through=True), r_i)
    above = above.abs()
    live = weight > 0
    zero = torch.zeros_like(above)
    gap = (est32 - est64).abs()
    rounding = torch.maximum(BAND_ROUNDING * gap, gap.max()).clamp_min(
        torch.finfo(torch.float64).tiny)
    # the floors: the estimate's, and the WHDR gather's of the lightness
    # (the estimate times the mean over colour of image / intensity)
    x = images64.permute(0, 3, 1, 2)
    share = (x / x.amax(dim=1, keepdim=True).clamp_min(EPS)).mean(
        dim=1, keepdim=True)
    near = torch.zeros_like(est64)
    for floor in (EPS, EPS / share.clamp_min(EPS)):
        near = torch.maximum(near, torch.clamp(
            1.0 - (est64 - floor).abs() / rounding, min=0.0))
    undecided = above * near
    uncertain = torch.maximum(
        weight * torch.where(live, torch.clamp(2.0 * rounding / est64,
                                               max=1.0), zero),
        undecided)
    loss_rounding = float((torch.where(live | (near > 0), above, zero)
                           * rounding).sum())
    # a pixel whose uncertain weight lies under one float32 unit of the
    # summed weights moves the gradient no more than any float32 sum does
    flat, pick = uncertain.reshape(-1), undecided.reshape(-1)
    m = min(BAND_PIXELS, int((pick > weight.sum() * 2.0 ** -23).sum()))
    pixels = torch.topk(pick, m).indices
    per = est64[0].numel()
    rows = []

    def leaves():
        return {a: {k: v.detach().clone().requires_grad_(True)
                    for k, v in q.items()} for a, q in p32.items()}

    with precision(False):
        image = pixels.div(per, rounding_mode="floor")
        for b in image.unique().tolist():
            mine = leaves()
            est = estimate(mine, images32[b:b + 1], n, p).reshape(-1)
            wanted = [v for q in mine.values() for v in q.values()]
            for chunk in (pixels[image == b] % per).split(JACOBIAN_ROWS):
                ones = torch.zeros((len(chunk), per), device=est.device)
                ones[torch.arange(len(chunk)), chunk] = 1.0
                got = torch.autograd.grad(est, wanted, grad_outputs=ones,
                                          retain_graph=True,
                                          is_grads_batched=True)
                rows.append(torch.cat([g.reshape(len(chunk), -1).double()
                                       for g in got], dim=1))
        # the other pixels' weights, each moved by its uncertain part
        # with a random sign: the typical move of the gradient, element
        # by element (rounding errors of different pixels are independent)
        rest = flat.clone()
        rest[pixels] = 0.0
        rest = rest.view_as(est64).float()
        mine = leaves()
        est = estimate(mine, images32, n, p)
        wanted = [v for q in mine.values() for v in q.values()]
        gen = torch.Generator(images.device).manual_seed(0)
        noise = 0.0
        for _ in range(NOISE_DRAWS):
            signs = torch.randint(0, 2, rest.shape, generator=gen,
                                  device=rest.device) * 2.0 - 1.0
            got = torch.autograd.grad(est, wanted, grad_outputs=signs * rest,
                                      retain_graph=True)
            noise = noise + torch.cat([g.reshape(-1).double()
                                       for g in got]) ** 2
        noise = (noise / NOISE_DRAWS).sqrt()
    rows = torch.cat(rows) if rows else noise.new_zeros((0, noise.numel()))
    return rows, noise, loss_rounding


def gradient_gaps(got: Params, want: Params, band) -> Dict[Tuple[str, str],
                                                            float]:
    """Each leaf's gap of the gradient ``got`` from ``want`` past what
    float32 leaves undetermined (``band``, from :func:`undetermined`), on
    the scale of the leaf (the larger of its and the median leaf's norm
    of ``want``): the norm of the difference once its least-squares fit
    by the band's gradients, on that scale, is taken out, less
    NOISE_SIGMAS x the leaf's typical move.  The leaves are taken in
    ``want``'s order, the band's."""
    rows, noise, _ = band
    keys = [(a, k) for a, q in want.items() for k in q]
    norms = {(a, k): float(want[a][k].double().norm()) for a, k in keys}
    median = sorted(norms.values())[len(norms) // 2]
    sizes = [want[a][k].numel() for a, k in keys]
    scales = [max(norms[key], median) for key in keys]
    inverse = torch.cat([noise.new_full((size,), 1.0 / scale if scale
                                        else 1.0)
                         for size, scale in zip(sizes, scales)])
    diff = torch.cat([(got[a][k].double() - want[a][k].double()).reshape(-1)
                      for a, k in keys]) * inverse
    if len(rows):
        basis, _ = torch.linalg.qr((rows * inverse).t())
        diff = diff - basis @ (basis.t() @ diff)
    noise = noise * inverse
    out, at = {}, 0
    for key, size, scale in zip(keys, sizes, scales):
        excess = max(0.0, float(diff[at:at + size].norm())
                     - NOISE_SIGMAS * float(noise[at:at + size].norm()))
        out[key] = excess if scale else (math.inf if excess else 0.0)
        at += size
    return out


def adam_step(params: Params, state: Dict, images: torch.Tensor,
              comps: torch.Tensor, lr: float, num_layers: int,
              kernel_pad: int, low: bool = False):
    """One Adam step from ``params`` and Adam's ``state`` ({"count", "mu",
    "nu"}, the moments nested as the params; count 0 and no moments at the
    start) -> (the loss, the gradients, the params after, the state
    after)."""
    value, grad = gradient(params, images, comps, num_layers, kernel_pad,
                           low)
    b1, b2 = BETAS
    t = state.get("count", 0) + 1
    new = {"count": t, "mu": {}, "nu": {}}
    after = {}
    with torch.no_grad():
        for n in params:
            new["mu"][n], new["nu"][n], after[n] = {}, {}, {}
            for k in params[n]:
                gk = grad[n][k]
                mu = state["mu"][n][k] if "mu" in state else 0.0
                nu = state["nu"][n][k] if "nu" in state else 0.0
                new["mu"][n][k] = b1 * mu + (1 - b1) * gk
                new["nu"][n][k] = b2 * nu + (1 - b2) * gk * gk
                mhat = new["mu"][n][k] / (1 - b1 ** t)
                vhat = new["nu"][n][k] / (1 - b2 ** t)
                after[n][k] = (params[n][k].detach()
                               - lr * mhat / (vhat.sqrt() + ADAM_EPS))
    return value, grad, after, new


def adam_steps(params0: Params, batches: List[Tuple[torch.Tensor,
                                                     torch.Tensor]],
               lr: float, num_layers: int, kernel_pad: int,
               low: bool = False):
    """Adam from ``params0`` over ``batches``, one step each -> (each
    step's loss, gradients, params after and state after)."""
    params, state, out = params0, {}, []
    for images, comps in batches:
        value, grad, params, state = adam_step(
            params, state, images, comps, lr, num_layers, kernel_pad, low)
        out.append((value, grad, params, state))
    return out
