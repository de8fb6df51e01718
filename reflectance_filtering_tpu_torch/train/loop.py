"""Training loop (port of reflectance_filtering_tpu/train/loop.py).

One step is forward (the network trunk -> R/S recovery -> losses), backward
(torch autograd, through the fused trunk K7 and the WHDR gather K3/K8 on
CUDA) and the optimizer update; the host feeds batches and observes scalar
metrics.  Unlike the JAX package, parameters are updated in place
(``torch.optim``), so a snapshot is written before the next step runs.
Over a set resident on the card, fit() runs chunks of TRAIN_CHUNK_STEPS
steps, each step a replay of one captured CUDA graph, and the host waits
once a chunk (:func:`make_train_chunk`, the JAX package's scan chunks).

Loss graph wiring mirrors the reference's training/networks.py:222-301:
  * whdr hinge on the configured comparisons type, weight loss_scale_whdr;
  * exact WHDR as a 0-weight 'accuracy' metric (delta pinned to 0.1);
  * boundary losses on reflectance and shading when
    loss_scale_boundaries01 != 0 and RS_est_mode != rDirectly;
  * lambert (EuclideanLoss of R*S vs I) when RS_est_mode == 'RS';
  * cascadeSkipLayers adds the level-0 hinge and WHDR.
Caffe's batch normalization's running statistics are folded in after each
optimizer step; pix2pix's affine batch norm moves its own in the forward,
in place (a captured step's replays move them too), and trains its gamma
and beta with the other parameters.

Solver semantics follow the reference's _get_solver: ADAM (caffe defaults
b1=.9, b2=.999, eps=1e-8; torch's Adam and optax's adam are the same
bias-corrected formula, eps outside the sqrt) or plain SGD.  Batches cycle
through the training set in order; ``iterations`` counts samples.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..losses.losses import boundary_loss, lambert_loss
from ..losses.whdr import (MAX_EVALUATED_COMPARISONS, parse_wdm_string,
                           select_comparisons_host, whdr_batch,
                           whdr_hinge_batch, whdr_per_image)
from ..models.networks import (NetworkConfig, apply_network, init_network,
                               params_to_torch, update_bn_stats)
from ..models.recover import recover_reflectance_shading
from ..ops import _build
from ..utils.profiling import span


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

# Steps a chunk of fit()'s device-resident trainer runs (the JAX package's
# value).  Large enough to amortize the per-chunk host round trip (one copy
# of the stacked metrics, one wait), small enough that checkpoint-boundary
# remainder chunks stay few.  Each step of a chunk replays the same captured
# graph, so unlike the JAX scan a new chunk length costs no compile.
TRAIN_CHUNK_STEPS = 32

# Eager steps that make_train_chunk runs on a card, on a side stream, before
# it captures the step: one step creates every lazily made thing (Adam's
# state, K7's launch plan and its library's per-device cache, the hinge's
# ratio table) outside the capture.  It is a step of the trajectory.
CAPTURE_WARMUP_STEPS = 1


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
        # capturable on a card: the step count and the bias correction stay
        # on the device (float32, as optax computes them), so that
        # make_train_chunk can capture the update; the per-step trainer
        # steps the same optimizer
        return torch.optim.Adam(leaves, lr=base_lr, betas=(0.9, 0.999),
                                eps=1e-8, capturable=leaves[0].is_cuda)
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
            # a leaf that never had a gradient (batch norm's running
            # statistics) has no state: zeros, as the JAX package's Adam
            # keeps for it
            st = optimizer.state.get(t, {})
            for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                v = st.get(key)
                out[name].setdefault(layer, {})[part] = (
                    np.zeros(tuple(t.shape), np.float32) if v is None
                    else v.detach().cpu().numpy())
            if "step" in st:
                out["count"] = max(out["count"], int(st["step"]))
    return out


def load_optimizer_state(optimizer: torch.optim.Optimizer, params: Dict,
                         opt_state: Dict) -> None:
    """Put a checkpoint's Adam state into ``optimizer`` (over ``params``).
    A capturable Adam keeps its step count on the params' device, the other
    on the CPU."""
    if not isinstance(optimizer, torch.optim.Adam):
        return
    capturable = optimizer.defaults["capturable"]
    for layer in params:
        for part, t in params[layer].items():
            optimizer.state[t] = {
                "step": torch.tensor(float(opt_state["count"]),
                                     dtype=torch.float32,
                                     device=t.device if capturable else None),
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
                   preselected: bool = False, kernels: bool = True,
                   bn_group=None, draw_rows: Optional[Tuple[int, int]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + the full loss graph.  images NHWC, comparisons [B,K+1,6].

    ``comparisons`` drives the hinge loss (the configured comparisonsType);
    ``metric_comparisons`` (default: the same blob) drives the 0-weight
    whdr_original metric.  ``preselected``: the blob already went through
    :func:`select_comparisons_host`, so the hinge applies only the prefix
    mask.  ``generator`` draws the hinge's >1500 cap on the device.
    ``kernels=False`` runs the trunk and the gather through their plain
    versions on any device (the reference run on the card).  With batch
    normalization in training, metrics['bn_stats'] holds the detached batch
    statistics for :func:`update_bn_stats`.  A data-parallel rank passes
    its process group as ``bn_group`` (batch norm's moments over the global
    batch) and ``draw_rows`` = (its first row, the global batch) for the
    capped draw."""
    if metric_comparisons is None:
        metric_comparisons = comparisons
    delta, margin, ratio, eval_dense = loss_cfg.wdm
    if preselected:
        ratio, eval_dense = 1.0, True
    blobs = apply_network(params, images, net_cfg, train=train,
                          kernels=kernels, bn_group=bn_group)
    mode = net_cfg.rs_est_mode.split("-")[0]
    reflectance, shading = _reflectance(blobs, images, net_cfg)

    metrics: Dict[str, Any] = {}
    bn_stats = blobs.get("__bn_stats__")
    if bn_stats:
        metrics["bn_stats"] = {name: {k: v.detach() for k, v in st.items()}
                               for name, st in bn_stats.items()}
    # the JAX package draws both levels' hinge selections from one key
    draw_state = None if generator is None else generator.get_state()
    hinge = whdr_hinge_batch(reflectance, comparisons, delta, margin, ratio,
                             eval_dense, generator, kernels, draw_rows)
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

    if net_cfg.network_type == "cascadeSkipLayers":
        refl0 = blobs["reflectance_level0"]
        if generator is not None:
            generator.set_state(draw_state)
        hinge0 = whdr_hinge_batch(refl0, comparisons, delta, margin, ratio,
                                  eval_dense, generator, kernels, draw_rows)
        metrics["loss_whdr_hinge_level0"] = hinge0
        total = total + loss_cfg.loss_scale_whdr * hinge0
        with torch.no_grad():
            metrics["whdr_original_level0"] = whdr_batch(
                refl0.detach(), metric_comparisons, 0.1, kernels)

    metrics["loss_total"] = total
    return total, metrics


def _make_step_body(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                    params: Dict, optimizer: torch.optim.Optimizer,
                    preselected: bool = False, kernels: bool = True,
                    mesh=None) -> Callable:
    """The training step of :func:`make_train_step` and, with a ``mesh``
    (parallel/mesh.py), of the data-parallel step: each rank's blobs are its
    rows of the global batch, batch norm takes the global moments, the
    gradients are all-reduced as a mean before the optimizer steps (the
    loss is a mean of per-image terms) and the metrics are the ranks'
    means."""
    leaves = param_leaves(params)

    def step(images, comparisons, generator=None, metric_comparisons=None):
        optimizer.zero_grad(set_to_none=True)
        dp = {}
        if mesh is not None:
            n = images.shape[0]
            dp = dict(bn_group=mesh.group,
                      draw_rows=(mesh.rank * n, mesh.size * n))
        total, metrics = compute_losses(
            params, images, comparisons, net_cfg, loss_cfg, generator,
            train=True, metric_comparisons=metric_comparisons,
            preselected=preselected, kernels=kernels, **dp)
        total.backward()
        if mesh is not None:
            grads = [p.grad for p in leaves if p.grad is not None]
            flat = mesh.all_reduce_(torch.cat([g.reshape(-1)
                                               for g in grads]))
            flat /= mesh.size
            for g, part in zip(grads, flat.split([g.numel()
                                                  for g in grads])):
                g.copy_(part.view_as(g))
        optimizer.step()
        bn_stats = metrics.pop("bn_stats", None)
        if bn_stats:
            update_bn_stats(params, bn_stats)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            keys = sorted(metrics)
            means = mesh.all_reduce_(torch.stack(
                [metrics[k].to(torch.float32) for k in keys])) / mesh.size
            metrics = dict(zip(keys, means.unbind()))
        return metrics

    return step


def make_train_step(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                    params: Dict, optimizer: torch.optim.Optimizer,
                    preselected: bool = False, kernels: bool = True
                    ) -> Callable:
    """One training step over ``params`` (updated in place):
    (images, comparisons, generator=None, metric_comparisons=None) ->
    metrics (0-d tensors on the device, detached).  Batch normalization's
    running statistics are folded in after the optimizer step, or moved
    in the forward by the affine batch norm (their mean/var leaves get no
    gradient, so the optimizer leaves them)."""
    return _make_step_body(net_cfg, loss_cfg, params, optimizer,
                           preselected, kernels)


def make_train_chunk(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                     params: Dict, optimizer: torch.optim.Optimizer,
                     images_v: torch.Tensor, comps_v: torch.Tensor,
                     metric_v: torch.Tensor, batch_size: int,
                     kernels: bool = True) -> Callable:
    """Chunked trainer over a device-resident set (the JAX package's
    ``make_train_chunk``): ``images_v``/``comps_v``/``metric_v`` on one
    device, wrap-padded by batch_size - 1 rows (``metric_v`` may be
    ``comps_v``), so the true length is rows - (batch_size - 1).

    Returns chunk(step0, cursor0, k) -> stacked: k consecutive steps over
    ``params`` (updated in place, as by :func:`make_train_step`), step j on
    rows cursor0 + j * batch_size (mod the length) onwards, as the per-step
    trainer's batches; ``stacked`` is a [k, M] float32 tensor on the device,
    each step's metrics in the order of ``chunk.keys`` (sorted, set by the
    first step).  k is at most TRAIN_CHUNK_STEPS; ``step0``, the global step
    of the chunk's first step, names a failed capture.

    The tensors' device sets the path.  On a card the first
    CAPTURE_WARMUP_STEPS steps run eagerly on a side stream, then the step is
    captured once as a CUDA graph, and every later step is one replay: the
    graph gathers its batch from the resident set at a cursor on the device,
    which it advances, and writes its metrics into row j of a device buffer,
    so the host issues one replay a step and reads nothing back.  The
    kernels' wrappers record their launches in the capture, and every
    replay counts them (``_build.count_replays``).  The graph is captured
    again only when the parameter or optimizer-state tensors change
    identity (:func:`load_optimizer_state`).  A failed capture raises; it
    never falls back to eager steps.  On the CPU the same step runs eagerly
    k times."""
    body = _make_step_body(net_cfg, loss_cfg, params, optimizer,
                           kernels=kernels)
    device = images_v.device
    n = images_v.shape[0] - (batch_size - 1)
    offsets = torch.arange(batch_size, device=device)
    cursor = torch.zeros(1, dtype=torch.int64, device=device)
    row = torch.zeros(1, dtype=torch.int64, device=device)
    # the metrics' keys and buffer (made by the first step), the graph, the
    # tensors it updates in place, and the warm-up steps still to run.  No
    # closure here refers to ``chunk``: with no reference cycle the graph
    # and its memory go when the caller drops ``chunk``, not at a garbage
    # collection that could fall inside a later capture.
    keys = []
    state = {"out": None, "graph": None, "captured": [], "tally": None,
             "warmup": CAPTURE_WARMUP_STEPS}

    def one_step():
        idx = cursor + offsets
        b_comps = comps_v.index_select(0, idx)
        b_metric = (b_comps if metric_v is comps_v
                    else metric_v.index_select(0, idx))
        metrics = body(images_v.index_select(0, idx), b_comps, None,
                       b_metric)
        if not keys:
            keys.extend(sorted(metrics))
            state["out"] = torch.empty((TRAIN_CHUNK_STEPS, len(keys)),
                                       device=device)
        state["out"].index_copy_(0, row, torch.stack(
            [metrics[key].to(torch.float32) for key in keys])[None])
        row.add_(1)
        cursor.add_(batch_size).remainder_(n)

    def in_place_tensors():
        """The tensors a captured step updates in place: every parameter
        and its optimizer state."""
        out = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                out.append(p)
                out.extend(v for v in optimizer.state.get(p, {}).values()
                           if isinstance(v, torch.Tensor))
        return out

    def replay(step, count):
        now = in_place_tensors()
        if (state["graph"] is None or len(now) != len(state["captured"])
                or any(a is not b for a, b in zip(now, state["captured"]))):
            # a CUDA object that cyclic garbage holds (another graph, an
            # event) must not be destroyed inside the capture, which that
            # would invalidate: collect it first
            gc.collect()
            graph = torch.cuda.CUDAGraph()
            try:
                with span("fit.capture"), \
                        _build.record_launches() as tally, \
                        torch.cuda.graph(graph):
                    one_step()
            except RuntimeError as exc:   # CUDA's and the launches' errors
                raise RuntimeError(
                    "capturing the training step (global step {}) as a CUDA "
                    "graph failed: {}".format(step, exc)) from exc
            state["graph"], state["captured"] = graph, now
            state["tally"] = tally
        for _ in range(count):
            state["graph"].replay()
        _build.count_replays(state["tally"], count)

    def chunk(step0: int, cursor0: int, k: int) -> torch.Tensor:
        if not 1 <= k <= TRAIN_CHUNK_STEPS:
            raise ValueError("a chunk runs 1..{} steps, got {}".format(
                TRAIN_CHUNK_STEPS, k))
        cursor.fill_(cursor0)
        row.zero_()
        if device.type == "cpu":
            for _ in range(k):
                one_step()
            return state["out"][:k]
        with torch.cuda.device(device):
            warm = min(k, state["warmup"])
            if warm:
                main = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    for _ in range(warm):
                        one_step()
                main.wait_stream(side)
                state["warmup"] -= warm
            if warm < k:
                replay(step0 + warm, k - warm)
        return state["out"][:k]

    chunk.keys = keys
    return chunk


def _drain_chunk(pending, fan_out_metrics, maybe_checkpoint,
                 batch_size: int) -> None:
    """Host side of one dispatched chunk: ONE wait for its stacked metrics,
    then each step's metrics to the callbacks in order, then the checkpoint
    due at its last step."""
    step0, k, samples0, keys, (host, event) = pending
    with span("fit.wait"):
        if event is not None:
            event.synchronize()
    for j, values in enumerate(host.tolist()):
        fan_out_metrics(step0 + j, samples0 + (j + 1) * batch_size,
                        dict(zip(keys, values)))
    maybe_checkpoint(samples0 + k * batch_size)


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
    """Start copying a step's or a chunk's metrics to the host without
    waiting for later work on the stream: (host tensor, event or None).
    ``values`` may be overwritten by the next dispatch (a chunk's buffer):
    on a card the copy is queued before it, on the CPU it is made now."""
    if values.device.type != "cuda":
        return values.clone(), None
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
    DEVICE_FEED_BUDGET_BYTES and N >= bs it is uploaded once (wrap-padded
    by bs - 1 rows) and each batch is rows of it on the device.  Hinge blobs
    with K > 1500 are selected on the host (select_comparisons_host) with
    ``np.random.RandomState([seed & 0x7fffffff, global_step])``, a step at
    a time.  Otherwise (the JAX package's condition) a resident set trains
    in chunks of up to TRAIN_CHUNK_STEPS steps (:func:`make_train_chunk`:
    on a card each step a replay of one captured CUDA graph, one host wait
    a chunk), the chunk ends aligned so that every checkpoint falls on the
    last step of its chunk; the values, batches, checkpoints and callback
    order are the per-step trainer's.

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
    through the plain versions of the trunk and the gather on any device
    (on a card the chunked trainer captures those in its graph)."""
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

    def save_due(samples):
        return checkpointer is not None and checkpointer.would_save(
            samples, prev=samples - batch_size)

    def maybe_checkpoint(samples):
        if save_due(samples) and checkpointer.maybe_save(
                samples, params, optimizer_state(optimizer, params),
                prev=samples - batch_size):
            on_saved(samples)

    if resident and not host_select:
        # the JAX package's condition: k steps a chunk on the card, chunk
        # ends aligned so that every checkpoint step is the LAST step of
        # its chunk
        chunk_fn = make_train_chunk(net_cfg, loss_cfg, params, optimizer,
                                    images_d, comps_d, metric_d, batch_size,
                                    kernels=kernels)

        def chunk_len(s):
            limit = min(s + TRAIN_CHUNK_STEPS, num_steps)
            return next((j - s + 1 for j in range(s, limit)
                         if save_due(base_samples + (j + 1) * batch_size)),
                        limit - s)

        def dispatch(s):
            k = chunk_len(s)
            stacked = chunk_fn(base_steps + s,
                               (base_samples + s * batch_size) % n, k)
            return k, chunk_fn.keys, stacked
    else:
        def dispatch(s):
            b_images, b_comps, b_metric = batch(s)
            metrics = step_fn(b_images, b_comps, None, b_metric)
            keys = sorted(metrics)
            return 1, keys, torch.stack(
                [metrics[key].to(torch.float32) for key in keys])[None]

    # A chunk's (or a step's) metrics reach the host while the next one
    # runs: their copy is queued right after it, and the fan-out waits only
    # for it.  One that ends at a checkpoint is drained, saved and
    # evaluated at once, before the next updates the params in place.
    pending = None
    s = 0
    while s < num_steps:
        with span("fit.dispatch"):
            k, keys, stacked = dispatch(s)
            ready = (base_steps + s, k, base_samples + s * batch_size, keys,
                     _to_host(stacked))
        if pending is not None:
            _drain_chunk(pending, fan_out_metrics, maybe_checkpoint,
                         batch_size)
        pending = ready
        s += k
        if save_due(base_samples + s * batch_size):
            _drain_chunk(pending, fan_out_metrics, maybe_checkpoint,
                         batch_size)
            pending = None
    if pending is not None:
        _drain_chunk(pending, fan_out_metrics, maybe_checkpoint, batch_size)
    samples = base_samples + num_steps * batch_size
    if checkpointer is not None and num_steps > 0:
        saved = checkpointer.maybe_save(
            samples, params, optimizer_state(optimizer, params),
            finalize=True)
        if saved:
            on_saved(samples)
    return TrainState(params, optimizer_state(optimizer, params),
                      base_steps + num_steps, samples)
