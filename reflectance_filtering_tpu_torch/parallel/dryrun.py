"""Multi-process dry run: the data-parallel training step and the
width-sharded filters on n processes, each result held against the
single-process run (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m reflectance_filtering_tpu_torch.parallel.dryrun [n]

:func:`spawn` runs a function on n fresh processes joined in one
``torch.distributed`` group over a ``FileStore`` in a temporary directory
(no port is opened); :func:`dryrun_multichip` uses it with gloo on the CPU.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch


# how long spawn() waits for its ranks
RANK_TIMEOUT_S = 600.0


def _rank_main(rank: int, world_size: int, tmp: str, backend: str, device,
               fn: Callable, args: tuple) -> None:
    import torch.distributed as dist
    from .mesh import initialize_multihost
    torch.set_num_threads(1)     # ranks share the host's cores
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        mesh = initialize_multihost(
            world_size=world_size, rank=rank, backend=backend,
            device=device, store=store,
            timeout=datetime.timedelta(seconds=120))
        result = ("ok", fn(mesh, *args))
    except BaseException:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = os.path.join(tmp, "rank{}.pkl".format(rank))
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


def spawn(world_size: int, fn: Callable, *args, backend: str = "gloo",
          device="cpu") -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes (the spawn
    start method), rank r in a group of ``backend`` with its mesh on
    ``device`` ("cuda" without an index: card r % count); ``fn`` is a
    module-level function and its result picklable.  Returns the ranks'
    results in rank order; raises RuntimeError with a failing rank's
    traceback, and TimeoutError (after ending every process) when the
    ranks outlast RANK_TIMEOUT_S seconds."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, world_size, tmp, backend, str(device),
                                   fn, args))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.kill()
                p.join()
        results = []
        for rank, p in enumerate(procs):
            path = os.path.join(tmp, "rank{}.pkl".format(rank))
            if not os.path.exists(path):
                results.append(("error", "rank {} wrote no result (exit code "
                                "{})".format(rank, p.exitcode)))
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    errors = [(rank, msg) for rank, (status, msg) in enumerate(results)
              if status != "ok"]
    if errors:
        raise RuntimeError("\n".join("rank {}: {}".format(rank, msg)
                                     for rank, msg in errors))
    if late:
        raise TimeoutError("{} of {} ranks outlasted {} s".format(
            len(late), world_size, RANK_TIMEOUT_S))
    return [value for _, value in results]


def _max_err(a, b) -> float:
    a = torch.as_tensor(a).cpu().to(torch.float64)
    b = torch.as_tensor(b).cpu().to(torch.float64)
    if not bool(torch.isfinite(a).all()):
        raise RuntimeError("non-finite values in a sharded result")
    return float((a - b).abs().max())


def _dryrun_rank(mesh, seed: int) -> Dict[str, Any]:
    """One rank of :func:`dryrun_multichip`: each sharded result's max
    error against the same work in this process alone."""
    from ..models.networks import NetworkConfig, init_network
    from ..ops.bilateral import joint_bilateral_filter
    from ..ops.bilateral_kernel import bilateral_gray_self
    from ..ops.guided import guided_filter, guided_filter_iterated
    from ..train.loop import (LossConfig, make_optimizer, make_train_step,
                              param_leaves, trainable)
    from ..utils.testimages import make_synthetic_comps
    from .mesh import make_sharded_train_step, shard_batch
    from .spatial import (sharded_bilateral_gray_self,
                          sharded_guided_filter,
                          sharded_guided_filter_iterated,
                          sharded_joint_bilateral)

    n, dev = mesh.size, mesh.device
    rng = np.random.RandomState(seed)
    errs: Dict[str, Any] = {}

    # the data-parallel training step against the single-process step on
    # the same global batch
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    init = init_network(cfg, torch.Generator().manual_seed(seed))
    b = 2 * n
    images = rng.rand(b, 16, 16, 3).astype(np.float32)
    comps = make_synthetic_comps(seed + 1, 8, batch=b)
    single = trainable(init, dev)
    m1 = make_train_step(cfg, LossConfig(), single,
                         make_optimizer("ADAM", 1e-3, single))(
        torch.from_numpy(images).to(dev), torch.from_numpy(comps).to(dev))
    sharded = trainable(init, dev)
    m2 = make_sharded_train_step(cfg, LossConfig(), sharded,
                                 make_optimizer("ADAM", 1e-3, sharded),
                                 mesh)(shard_batch(images, mesh),
                                       shard_batch(comps, mesh))
    errs["train_step_params"] = max(
        _max_err(a.detach(), c.detach()) for a, c in zip(
            param_leaves(sharded), param_leaves(single)))
    errs["train_step_hinge"] = abs(float(m1["loss_whdr_hinge"])
                                   - float(m2["loss_whdr_hinge"]))
    errs["params"] = [p.detach().cpu().numpy()
                      for p in param_leaves(sharded)]

    # halo/shard-width ratios at or beyond the product's, on tiny frames:
    # r=9 bilateral on 24-column shards, r=9 guided (2r = 18) and the 3x
    # chain (6r = 54) on 64-column shards
    joint = torch.from_numpy(rng.rand(16, 24 * n, 3).astype(np.float32)
                             * 255).to(dev)
    src = torch.from_numpy(rng.rand(16, 24 * n, 3).astype(np.float32)
                           * 255).to(dev)
    errs["joint_bilateral"] = _max_err(
        sharded_joint_bilateral(joint, src, mesh, sigma_space=6.0),
        joint_bilateral_filter(joint, src, -1, 20.0, 6.0))
    gray = torch.floor(joint[..., 0]).to(torch.uint8)
    errs["gray_self_bilateral"] = _max_err(
        sharded_bilateral_gray_self(gray, mesh, sigma_space=6.0, reps=3),
        bilateral_gray_self(gray[None], -1, 20.0, 6.0, reps=3)[0])
    gj = torch.from_numpy(rng.rand(16, 64 * n, 3).astype(np.float32)
                          * 255).to(dev)
    gs = torch.from_numpy(rng.rand(16, 64 * n).astype(np.float32)
                          * 255).to(dev)
    errs["guided"] = _max_err(sharded_guided_filter(gj, gs, 9, 9.0, mesh),
                              guided_filter(gj, gs, 9, 9.0))
    errs["chain"] = _max_err(
        sharded_guided_filter_iterated(gj, gs, 9, 3.0, 3, mesh),
        guided_filter_iterated(gj, gs, 9, 3.0, 3))
    return errs


def dryrun_multichip(n_devices: int, seed: int = 0) -> Dict[str, float]:
    """One data-parallel training step, the joint and gray self-guided
    sharded bilateral, the sharded guided filter and the 3x sharded chain
    at the product's ratio of halos, on ``n_devices`` gloo processes on the
    CPU.  Returns each result's max abs error against the single-process
    run (rank 0's; every rank's parameters after the step must be equal,
    else RuntimeError)."""
    results = spawn(n_devices, _dryrun_rank, seed)
    for rank, res in enumerate(results[1:], 1):
        for a, b in zip(res["params"], results[0]["params"]):
            if not np.array_equal(a, b):
                raise RuntimeError("rank {}'s parameters differ from rank "
                                   "0's after the step".format(rank))
    errs = {k: v for k, v in results[0].items() if k != "params"}
    print("dryrun_multichip({}) OK: dp train step + sp halo filters (joint "
          "+ gray-self bilateral r9, guided r9, 3x-iterated guided chain "
          "6r-halo); max abs err against one process: {}".format(
              n_devices, errs))
    return errs


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
