"""Training loop (port of reflectance_filtering_tpu/train/loop.py).

One step is forward (the network trunk -> R/S recovery -> losses), backward
(torch autograd, through the fused trunk K7 and the WHDR gather K3/K8 on
CUDA) and the optimizer update; the host feeds batches and observes scalar
metrics.  Unlike the JAX package, parameters are updated in place
(``torch.optim``), so a snapshot is written before the next step runs.

Loss graph wiring mirrors the reference's training/networks.py:222-301:
  * whdr hinge on the configured comparisons type, weight loss_scale_whdr;
  * exact WHDR as a 0-weight 'accuracy' metric (delta pinned to 0.1);
  * boundary losses on reflectance and shading when
    loss_scale_boundaries01 != 0 and RS_est_mode != rDirectly;
  * lambert (EuclideanLoss of R*S vs I) when RS_est_mode == 'RS'.
The cascade network is not ported (ROADMAP module queue item 10).

Solver semantics follow the reference's _get_solver: ADAM (caffe defaults
b1=.9, b2=.999, eps=1e-8; torch's Adam and optax's adam are the same
bias-corrected formula, eps outside the sqrt) or plain SGD.  Batches cycle
through the training set in order; ``iterations`` counts samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..losses.losses import boundary_loss, lambert_loss
from ..losses.whdr import (MAX_EVALUATED_COMPARISONS, parse_wdm_string,
                           select_comparisons_host, whdr_batch,
                           whdr_hinge_batch, whdr_per_image)
from ..models.networks import (NetworkConfig, apply_network, init_network,
                               params_to_torch)
from ..models.recover import recover_reflectance_shading


@dataclasses.dataclass
class LossConfig:
    """Loss-shaping flags (train_with_barrista.py:172-295)."""
    loss_scale_whdr: float = 10.0
    loss_scale_lambert: float = 0.0
    loss_scale_boundaries01: float = 0.1
    shading_unary_type: str = "L1_0.5"      # first two chars pick the norm
    whdr_delta_margin_ratio_dense: str = "0.1_0.05_1.0_1"

    @property
    def boundary_norm(self) -> str:
        return self.shading_unary_type[:2]

    @property
    def wdm(self):
        return parse_wdm_string(self.whdr_delta_margin_ratio_dense)


@dataclasses.dataclass
class TrainState:
    params: Any            # the port's params (torch tensors)
    opt_state: Any         # {"count", "mu", "nu"} as numpy, or None (SGD)
    step: int = 0          # optimizer steps taken
    samples: int = 0       # samples processed (the reference's 'iter')


# Whole-dataset device residency cap for fit()'s feeding path: the training
# set is uploaded once and each batch is a slice of it on the card.
DEVICE_FEED_BUDGET_BYTES = 8 * 1024 ** 3

# Device-residency cap for the live-validation split (make_val_whdr_fn).
VAL_FEED_BUDGET_BYTES = 2 * 1024 ** 3


def param_leaves(params: Dict) -> List[torch.Tensor]:
    """The parameter tensors in the JAX package's flattening order (layers
    sorted by name, then bias before kernel)."""
    return [params[layer][part] for layer in sorted(params)
            for part in sorted(params[layer])]


def make_optimizer(solver_type: str, base_lr: float,
                   params: Dict) -> torch.optim.Optimizer:
    """The reference's _get_solver (helper:447-460) over ``params``."""
    leaves = param_leaves(params)
    if solver_type in ("SGD", "sgd"):
        return torch.optim.SGD(leaves, lr=base_lr)
    if solver_type in ("ADAM", "Adam", "adam"):
        return torch.optim.Adam(leaves, lr=base_lr, betas=(0.9, 0.999),
                                eps=1e-8)
    raise ValueError("solverType not known: {}".format(solver_type))


def optimizer_state(optimizer: torch.optim.Optimizer,
                    params: Dict) -> Optional[Dict]:
    """Adam's state as the checkpoint's {"count", "mu", "nu"} (numpy, the
    params' nesting); None for SGD, which keeps none."""
    if not isinstance(optimizer, torch.optim.Adam):
        return None
    out = {"count": 0, "mu": {}, "nu": {}}
    for layer in params:
        for part, t in params[layer].items():
            st = optimizer.state.get(t, {})
            for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                v = st.get(key)
                out[name].setdefault(layer, {})[part] = (
                    np.zeros(tuple(t.shape), np.float32) if v is None
                    else v.detach().cpu().numpy())
            if "step" in st:
                out["count"] = int(st["step"])
    return out


def load_optimizer_state(optimizer: torch.optim.Optimizer, params: Dict,
                         opt_state: Dict) -> None:
    """Put a checkpoint's Adam state into ``optimizer`` (over ``params``)."""
    if not isinstance(optimizer, torch.optim.Adam):
        return
    for layer in params:
        for part, t in params[layer].items():
            optimizer.state[t] = {
                "step": torch.tensor(float(opt_state["count"]),
                                     dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(
                    opt_state["mu"][layer][part], np.float32),
                    device=t.device),
                "exp_avg_sq": torch.tensor(np.asarray(
                    opt_state["nu"][layer][part], np.float32),
                    device=t.device)}


def trainable(params: Dict, device) -> Dict:
    """Fresh leaf tensors on ``device`` that require grad, from the port's
    params or the JAX package's numpy pytree."""
    out = {}
    for layer, parts in params.items():
        out[layer] = {}
        for part, v in parts.items():
            t = (v.detach().to(device=device, dtype=torch.float32).clone()
                 if isinstance(v, torch.Tensor)
                 else params_to_torch({layer: {part: v}}, device)[layer][part])
            out[layer][part] = t.requires_grad_(True)
    return out


def _reflectance(blobs: Dict, images: torch.Tensor, net_cfg: NetworkConfig):
    if net_cfg.rs_est_mode.split("-")[0] == "rDirectly":
        r = torch.relu(blobs["RS_est"])
        return r, r
    return recover_reflectance_shading(blobs["RS_est"], images,
                                       net_cfg.rs_est_mode)


def compute_losses(params: Dict, images: torch.Tensor,
                   comparisons: torch.Tensor, net_cfg: NetworkConfig,
                   loss_cfg: LossConfig,
                   generator: Optional[torch.Generator] = None,
                   train: bool = True,
                   metric_comparisons: Optional[torch.Tensor] = None,
                   preselected: bool = False, kernels: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + the full loss graph.  images NHWC, comparisons [B,K+1,6].

    ``comparisons`` drives the hinge loss (the configured comparisonsType);
    ``metric_comparisons`` (default: the same blob) drives the 0-weight
    whdr_original metric.  ``preselected``: the blob already went through
    :func:`select_comparisons_host`, so the hinge applies only the prefix
    mask.  ``generator`` draws the hinge's >1500 cap on the device.
    ``kernels=False`` runs the trunk and the gather through their plain
    versions on any device (the reference run on the card)."""
    if metric_comparisons is None:
        metric_comparisons = comparisons
    delta, margin, ratio, eval_dense = loss_cfg.wdm
    if preselected:
        ratio, eval_dense = 1.0, True
    blobs = apply_network(params, images, net_cfg, train=train,
                          kernels=kernels)
    mode = net_cfg.rs_est_mode.split("-")[0]
    reflectance, shading = _reflectance(blobs, images, net_cfg)

    metrics: Dict[str, torch.Tensor] = {}
    hinge = whdr_hinge_batch(reflectance, comparisons, delta, margin, ratio,
                             eval_dense, generator, kernels)
    metrics["loss_whdr_hinge"] = hinge
    total = loss_cfg.loss_scale_whdr * hinge

    with torch.no_grad():
        metrics["whdr_original"] = whdr_batch(reflectance.detach(),
                                              metric_comparisons, 0.1,
                                              kernels)

    if loss_cfg.loss_scale_boundaries01 and mode != "rDirectly":
        br = boundary_loss(reflectance, loss_cfg.boundary_norm)
        bs = boundary_loss(shading, loss_cfg.boundary_norm)
        metrics["loss_boundaries_reflectance"] = br
        metrics["loss_boundaries_shading"] = bs
        total = total + loss_cfg.loss_scale_boundaries01 * (br + bs)

    if mode == "RS":
        lam = lambert_loss(reflectance, shading, images)
        metrics["loss_lambert"] = lam
        total = total + loss_cfg.loss_scale_lambert * lam

    metrics["loss_total"] = total
    return total, metrics


def make_train_step(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                    params: Dict, optimizer: torch.optim.Optimizer,
                    preselected: bool = False, kernels: bool = True
                    ) -> Callable:
    """One training step over ``params`` (updated in place):
    (images, comparisons, generator=None, metric_comparisons=None) ->
    metrics (0-d tensors on the device, detached)."""

    def step(images, comparisons, generator=None, metric_comparisons=None):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = compute_losses(
            params, images, comparisons, net_cfg, loss_cfg, generator,
            train=True, metric_comparisons=metric_comparisons,
            preselected=preselected, kernels=kernels)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_val_whdr_fn(net_cfg: NetworkConfig, X_val: Dict,
                     batch_size: int = 20, device="cuda"
                     ) -> Optional[Callable]:
    """Live validation metric for fit(): the mean exact WHDR (delta 0.1)
    of the val split under the current params, as the reference's
    interleaved test phase shows it.  The split stays on the device for
    the whole fit when it fits VAL_FEED_BUDGET_BYTES, else it is fed per
    batch.  Returns ``params -> float``, or None for an empty split."""
    images = np.asarray(X_val["images"], np.float32)
    comps = np.asarray(X_val["comparisons"], np.float32)
    n = images.shape[0]
    if n == 0:
        return None
    device = torch.device(device)
    bs = min(batch_size, n)
    resident = images.nbytes + comps.nbytes <= VAL_FEED_BUDGET_BYTES
    if resident:
        im_d = torch.from_numpy(images).to(device)
        cp_d = torch.from_numpy(comps).to(device)

    def val_whdr(params) -> float:
        ws = []
        with torch.no_grad():
            for s in range(0, n, bs):
                if resident:
                    im, cp = im_d[s:s + bs], cp_d[s:s + bs]
                else:
                    im = torch.from_numpy(images[s:s + bs]).to(device)
                    cp = torch.from_numpy(comps[s:s + bs]).to(device)
                blobs = apply_network(params, im, net_cfg, train=False)
                refl, _ = _reflectance(blobs, im, net_cfg)
                ws.append(whdr_per_image(refl, cp, 0.1))
        return float(torch.cat(ws).mean())

    return val_whdr


def _to_host(values: torch.Tensor):
    """Start copying a step's metrics to the host without waiting for later
    work on the stream: (host tensor, event or None)."""
    if values.device.type != "cuda":
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fit(net_cfg: NetworkConfig, loss_cfg: LossConfig, X: Dict,
        iterations: int, batch_size: int,
        solver_type: str = "ADAM", base_lr: float = 0.001,
        random_seed: int = -1,
        comparisons_type: str = "comparisons",
        init_params=None, init_opt_state=None, base_samples: int = 0,
        callbacks=(), checkpointer=None,
        progress: Optional[Callable] = None,
        on_checkpoint: Optional[Callable] = None,
        val_fn: Optional[Callable] = None,
        device="cuda", kernels: bool = True) -> TrainState:
    """Train for ``iterations`` samples (the reference's unit) on
    ``device``.

    X: {'images' [N,H,W,3], 'comparisons' [N,K+1,6][, 'augmented']} — the
    loader's NHWC layout.  Batch s takes rows (cursor + arange(bs)) % N with
    cursor = (base_samples + s * bs) % N.  When the training set fits
    DEVICE_FEED_BUDGET_BYTES it is uploaded once (wrap-padded by bs - 1
    rows) and each batch is a slice of it on the card.  Hinge blobs with
    K > 1500 are selected on the host (select_comparisons_host) with
    ``np.random.RandomState([seed & 0x7fffffff, global_step])``.

    Resume: pass ``init_params``/``init_opt_state`` from a checkpoint plus
    ``base_samples``; the data cursor, checkpoint numbering and the host
    selection continue where the original run left off, so fit(n) equals
    fit(k) + a resume to n.  Without ``init_params`` the params start from
    init_network with a generator seeded ``seed``, made on the CPU, so that
    every device starts from the same numbers.

    Checkpoints (the crossing rule), callbacks, progress and the live val
    WHDR follow the JAX package's order: each step's metrics go to the
    callbacks, then a checkpoint due at that step is written and evaluated,
    and later steps carry its 'val_whdr'.  ``kernels=False`` trains
    through the plain versions of the trunk and the gather on any device."""
    device = torch.device(device)
    seed = random_seed if random_seed >= 0 else np.random.randint(2 ** 31)
    if init_params is None:
        init_params = init_network(net_cfg, torch.Generator().manual_seed(
            int(seed)))
    params = trainable(init_params, device)
    optimizer = make_optimizer(solver_type, base_lr, params)
    if init_opt_state is not None:
        load_optimizer_state(optimizer, params, init_opt_state)

    images = np.asarray(X["images"], np.float32)
    comps = np.asarray(X[comparisons_type], np.float32)
    # the whdr_original metric always reads the plain comparisons blob
    metric_comps = np.asarray(X["comparisons"], np.float32)
    shared_metric = comparisons_type == "comparisons"
    n = images.shape[0]

    host_select = comps.shape[1] - 1 > MAX_EVALUATED_COMPARISONS
    step_fn = make_train_step(net_cfg, loss_cfg, params, optimizer,
                              preselected=host_select, kernels=kernels)
    _, _, sel_ratio, sel_dense = loss_cfg.wdm

    base_steps = base_samples // batch_size
    num_steps = max(0, (iterations - base_samples) // batch_size)

    feed_bytes = (images.nbytes + (0 if host_select else comps.nbytes)
                  + (0 if shared_metric else metric_comps.nbytes))
    # n >= batch_size keeps a wrap-padded slice equal to the modulo rows
    resident = (feed_bytes <= DEVICE_FEED_BUDGET_BYTES
                and n >= batch_size and num_steps > 0)

    def _wrap_pad(a):
        if batch_size > 1:
            a = np.concatenate([a, a[:batch_size - 1]], axis=0)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if resident:
        images_d = _wrap_pad(images)
        metric_d = _wrap_pad(metric_comps)
        comps_d = (None if host_select
                   else metric_d if shared_metric else _wrap_pad(comps))

    def batch(s: int):
        start = (base_samples + s * batch_size) % n
        idx = (start + np.arange(batch_size)) % n
        if host_select:
            sel_rng = np.random.RandomState(
                np.array([seed & 0x7fffffff, base_steps + s],
                         dtype=np.uint32))
            b_comps = torch.from_numpy(select_comparisons_host(
                comps[idx], sel_ratio, sel_dense, sel_rng)).to(device)
        elif resident:
            b_comps = comps_d[start:start + batch_size]
        else:
            b_comps = torch.from_numpy(comps[idx]).to(device)
        if resident:
            return (images_d[start:start + batch_size], b_comps,
                    metric_d[start:start + batch_size])
        return (torch.from_numpy(images[idx]).to(device), b_comps,
                torch.from_numpy(metric_comps[idx]).to(device))

    last_val = [None]

    def fan_out_metrics(s_global, samples, host_metrics):
        if last_val[0] is not None:
            host_metrics.setdefault("val_whdr", last_val[0])
        # callbacks see the GLOBAL step, so a resumed run keeps the step
        # sequence monotonic
        for cb in callbacks:  # each: (step, metrics) -> metrics | None
            out = cb(s_global, host_metrics)
            if isinstance(out, dict):
                host_metrics = out
        if progress is not None:
            progress(s_global, samples, host_metrics)

    def on_saved(samples):
        if val_fn is not None:
            last_val[0] = val_fn(params)
            print("Validation WHDR at iteration {}: {:.2f}"
                  .format(samples, 100.0 * last_val[0]))
        if on_checkpoint is not None:
            on_checkpoint(samples, params)

    def drain(pending):
        s_global, samples, keys, (host, event) = pending
        if event is not None:
            event.synchronize()
        fan_out_metrics(s_global, samples,
                        {k: float(v) for k, v in zip(keys, host.tolist())})

    # A step's metrics reach the host while the next step runs: their copy
    # is queued right after the step, and the fan-out waits only for it.
    # A step that saves a checkpoint is drained at once, before the next
    # step updates the params in place.
    pending = None
    samples = base_samples
    for s in range(num_steps):
        b_images, b_comps, b_metric = batch(s)
        metrics = step_fn(b_images, b_comps, None, b_metric)
        prev, samples = samples, base_samples + (s + 1) * batch_size
        keys = sorted(metrics)
        ready = (base_steps + s, samples, keys, _to_host(
            torch.stack([metrics[k].to(torch.float32) for k in keys])))
        if pending is not None:
            drain(pending)
        pending = ready
        if (checkpointer is not None
                and checkpointer.would_save(samples, prev=prev)):
            drain(pending)
            pending = None
            saved = checkpointer.maybe_save(
                samples, params, optimizer_state(optimizer, params),
                prev=prev)
            if saved:
                on_saved(samples)
    if pending is not None:
        drain(pending)
    if checkpointer is not None and num_steps > 0:
        saved = checkpointer.maybe_save(
            samples, params, optimizer_state(optimizer, params),
            finalize=True)
        if saved:
            on_saved(samples)
    return TrainState(params, optimizer_state(optimizer, params),
                      base_steps + num_steps, samples)
