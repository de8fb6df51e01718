"""The flagship's training step as the reference trains it
(train_with_barrista.py, the rDirectly head): the trunk on linear RGB
images, reflectance = sigmoid of the fuse, loss = 10 x the WHDR hinge
(delta 0.1, margin 0.05), Adam (b1 0.9, b2 0.999, eps 1e-8) written out."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .flagship import trunk
from .whdr import hinge

LOSS_SCALE_WHDR = 10.0
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
LAYERS = ["conv{}".format(i) for i in range(5)] + ["fuse_skip_layers"]

Params = Dict[str, Dict[str, torch.Tensor]]


def loss(params: Params, images: torch.Tensor, comps: torch.Tensor,
         low: bool = False) -> torch.Tensor:
    """The step's loss: images [B, H, W, 3] linear RGB, comps [B, K+1,
    6]."""
    layers = [(params[n]["kernel"][0, 0], params[n]["bias"]) for n in LAYERS]
    r = torch.sigmoid(trunk(layers, images, low))[..., 0]
    return LOSS_SCALE_WHDR * hinge(r, comps)


def adam_step(params: Params, state: Dict, images: torch.Tensor,
              comps: torch.Tensor, lr: float, low: bool = False):
    """One Adam step from ``params`` and Adam's ``state`` ({"count",
    "mu", "nu"}, the moments nested as the params; count 0 and no moments
    at the start) -> (the loss, the gradients, the params after, the state
    after)."""
    params = {n: {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()} for n, p in params.items()}
    leaves = [params[n][k] for n in params for k in params[n]]
    value = loss(params, images, comps, low)
    g = iter(torch.autograd.grad(value, leaves))
    grad = {n: {k: next(g) for k in params[n]} for n in params}
    b1, b2 = BETAS
    t = state.get("count", 0) + 1
    new = {"count": t, "mu": {}, "nu": {}}
    after = {}
    with torch.no_grad():
        for n in params:
            for key in ("mu", "nu"):
                new[key][n] = {}
            after[n] = {}
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
    return float(value.detach()), grad, after, new


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
