"""Data parallelism over processes: batched eval and training (port of
reflectance_filtering_tpu/parallel/mesh.py).

The JAX package shards the batch axis over a ``jax.sharding.Mesh`` and lets
XLA insert the collectives.  The torch idiom is one process per card over
``torch.distributed``; a :class:`Mesh` here is that process's view of the
group: the process group, its rank and size, and the card it computes on.
The same code serves one host and many (the JAX pair initialize_multihost /
shard_batch_multihost).

  * ``shard_batch`` hands each rank its rows of a global batch (params are
    replicated: :func:`replicate` broadcasts rank 0's);
  * the training step all-reduces the gradients as a mean and then steps
    the optimizer, so every rank holds the same parameters; batch
    normalization takes its moments over the global batch;
  * eval masks its mean to the valid rows, so the duplicates that pad a
    ragged batch cannot bias it.

Collectives run on tensors on the mesh's device: NCCL takes CUDA tensors
only, gloo takes CPU tensors and, for all_reduce, all_gather and broadcast
(the only collectives used here), CUDA tensors too.  Width-sharded filters
of single large frames live in parallel/spatial.py.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..losses.whdr import whdr_per_image
from ..models.networks import NetworkConfig, apply_network
from ..ops import _build
from ..train.loop import LossConfig, _make_step_body, _reflectance


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of a data-parallel group: ``group`` (None for a
    mesh of one outside torch.distributed, which communicates with no one;
    a group of one still runs its collectives), this process's ``rank`` in
    it, the group's ``size`` and the ``device`` this rank computes on."""
    group: Any
    rank: int
    size: int
    device: torch.device

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on each), in rank
        order."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        if self.group is None:
            return t
        return torch.cat(self.all_gather(t), dim=dim)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns ``t``."""
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return t


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of this process: over ``group`` (default: the whole
    initialized process group), or a mesh of one when torch.distributed is
    not initialized.  ``device`` is the card by default: "cuda" without an
    index takes card ``rank % device_count``; the CPU only when the caller
    asks for it (the gloo backend).  Raises without a GPU for "cuda", and
    for a CPU device under NCCL, which takes CUDA tensors only."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        backend = dist.get_backend(group)
    else:
        if group is not None:
            raise ValueError("a group was given but torch.distributed is "
                             "not initialized")
        rank, size, backend = 0, 1, None
    device = _build.target_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend takes CUDA tensors only; device "
                         "{} needs the gloo backend".format(device))
    return Mesh(group, rank, size, device)


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: Optional[str] = None, device="cuda",
                         store=None,
                         timeout: Optional[datetime.timedelta] = None
                         ) -> Mesh:
    """Join a job of ``world_size`` processes (one per card, on one host or
    many): ``init_process_group`` at ``init_method`` (e.g.
    "tcp://host:port"; None reads the ``env://`` variables) or over a
    ``store``, then the mesh over the whole group.  ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU; a gloo group on the card is
    a backend the caller names.  Returns this process's :class:`Mesh`."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method, store=store,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)
    return make_mesh(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(tree, mesh: Mesh):
    """A copy of a tree of tensors or arrays (e.g. params) on the mesh's
    device, each leaf rank 0's value on every rank."""
    def put(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        return mesh.broadcast_(t.detach().to(mesh.device, copy=True))
    return _tree_map(put, tree)


def _check_rows(n: int, mesh: Mesh) -> int:
    if n % mesh.size:
        raise ValueError("batch of {} rows does not divide by the mesh size "
                         "{} (use pad_to_multiple)".format(n, mesh.size))
    return n // mesh.size


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (array or tensor; the
    leading axis divides by the mesh size), on the mesh's device.  Every
    process holds the whole batch; in a job where each holds only its own
    slice use :func:`shard_batch_multihost`."""
    n = _check_rows(x.shape[0], mesh)
    rows = x[mesh.rank * n:(mesh.rank + 1) * n]
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(mesh.device)


def shard_batch_multihost(local_x, mesh: Mesh) -> torch.Tensor:
    """This process's LOCAL slice of a global batch, on the mesh's device:
    the global batch is the rank-ordered concatenation of every process's
    slice, which must all have the same number of rows (checked across the
    group).  With one process it equals :func:`shard_batch`."""
    t = torch.as_tensor(np.asarray(local_x) if not isinstance(
        local_x, torch.Tensor) else local_x).to(mesh.device)
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=mesh.device)
    sizes = [int(s) for s in mesh.gather(n)]
    if len(set(sizes)) != 1:
        raise ValueError("local slices must have equal rows, got {} by "
                         "rank".format(sizes))
    return t


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the batch axis up to a multiple (repeat last element); returns
    (padded, original_n)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)
    return x, n


def make_sharded_eval(net_cfg: NetworkConfig, mesh: Mesh,
                      delta: float = 0.1):
    """The data-parallel evaluator: eval_fn(params, images, comparisons,
    valid) -> (mean_whdr 0-d tensor, per_image_whdr [N]), where images
    [n,H,W,3], comparisons [n,K+1,6] and valid [n] (float 0/1) are this
    rank's rows (:func:`shard_batch`) and N = n * mesh.size.  The mean is
    masked to the valid rows across the group, so the duplicates that pad
    a ragged set (:func:`pad_to_multiple`, marked 0 in ``valid``) cannot
    bias it.  On CUDA the network's trunk runs K7's forward and the WHDR
    gather K3."""

    def eval_fn(params, images, comparisons, valid):
        with torch.no_grad():
            blobs = apply_network(params, images, net_cfg, train=False)
            refl, _ = _reflectance(blobs, images, net_cfg)
            per_image = whdr_per_image(refl, comparisons, delta)
            valid = valid.to(per_image.dtype)
            sums = mesh.all_reduce_(torch.stack([(per_image * valid).sum(),
                                                 valid.sum()]))
            return sums[0] / sums[1], mesh.gather(per_image)

    return eval_fn


def make_sharded_train_step(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                            params: Dict, optimizer, mesh: Mesh,
                            preselected: bool = False):
    """The data-parallel training step over ``params`` (updated in place,
    the same on every rank): step(images, comparisons, generator=None,
    metric_comparisons=None) -> metrics, where the blobs are this rank's
    rows of the global batch (:func:`shard_batch`).

    The step body is :func:`train.loop.make_train_step`'s; the loss is the
    mean of per-image terms, so the gradients are all-reduced as a mean
    before the optimizer steps, and the metrics are the group's means.
    Batch normalization takes its moments over the global batch.  The
    hinge's draw above the 1,500-comparison cap (``generator``, seeded
    alike on every rank) draws the global batch's mask on every rank, and
    each rank takes its rows: the single-process step's mask for the same
    global batch.  ``preselected`` as in make_train_step (blobs compacted
    on the host by select_comparisons_host)."""
    return _make_step_body(net_cfg, loss_cfg, params, optimizer,
                           preselected=preselected, mesh=mesh)


def eval_dataset_sharded(params, X: Dict, net_cfg: NetworkConfig,
                         mesh: Mesh, delta: float = 0.1,
                         batch_size: Optional[int] = None
                         ) -> Tuple[float, np.ndarray]:
    """Data-parallel WHDR over a whole dataset dict (every rank holds X);
    returns (mean, [N]).

    ``batch_size`` (per rank) chunks the sweep into batches of batch_size *
    mesh.size images, bounding device residency for splits too large to
    evaluate at once; None evaluates the whole set as one batch (padded to
    a multiple of the mesh size)."""
    images = np.asarray(X["images"], np.float32)
    comps = np.asarray(X["comparisons"], np.float32)
    n = images.shape[0]
    eval_fn = make_sharded_eval(net_cfg, mesh, delta)
    params_r = replicate(params, mesh)

    chunk = (-(-n // mesh.size) * mesh.size if batch_size is None
             else batch_size * mesh.size)
    outs = []
    for s in range(0, n, chunk):
        im, _ = pad_to_multiple(images[s:s + chunk], chunk)
        cp, k = pad_to_multiple(comps[s:s + chunk], chunk)
        valid = np.zeros(im.shape[0], np.float32)
        valid[:k] = 1.0
        _, per_image = eval_fn(params_r, shard_batch(im, mesh),
                               shard_batch(cp, mesh),
                               shard_batch(valid, mesh))
        outs.append(per_image.cpu().numpy()[:k])
    per_image = np.concatenate(outs)
    return float(np.mean(per_image)), per_image
