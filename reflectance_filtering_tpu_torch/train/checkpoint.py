"""Checkpointing: params + optimizer state with self-describing filenames
(port of reflectance_filtering_tpu/train/checkpoint.py).

One ``.npz`` per snapshot, in the JAX package's layout key for key, so a
snapshot written by either package loads in the other:

* ``param/<layer>/kernel`` (HWIO) and ``param/<layer>/bias``;
* the Adam state as ``opt/0/.count`` (int32), ``opt/0/.mu/<layer>/<part>``
  and ``opt/0/.nu/<layer>/<part>`` (optax's ScaleByAdamState; SGD has no
  state and writes no ``opt/`` key);
* ``__metadata__``, a JSON blob as uint8.

The filename keeps the reference's ``{description}_barrista_iter_{N}``
naming, N = samples processed.  In the port the optimizer state is a plain
dict ``{"count": int, "mu": params-like, "nu": params-like}`` of numpy
arrays; ``train.loop`` moves it in and out of ``torch.optim.Adam``
(``step``, ``exp_avg``, ``exp_avg_sq``: the same update formula).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_ADAM = "0/."


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"{}{}/{}".format(prefix, layer, part): _np(v)
            for layer, parts in tree.items() for part, v in parts.items()}


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        layer, part = key.rsplit("/", 1)
        out.setdefault(layer, {})[part] = v
    return out


def save_checkpoint(path: str, params: Dict, opt_state: Optional[Dict] = None,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write params (+ optional optimizer state, metadata) to one .npz."""
    payload = _flatten(params, "param/")
    if opt_state is not None:
        payload["opt/" + _ADAM + "count"] = np.asarray(opt_state["count"],
                                                       np.int32)
        for part in ("mu", "nu"):
            payload.update(_flatten(opt_state[part],
                                    "opt/" + _ADAM + part + "/"))
    payload["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str) -> Tuple[Dict, Optional[Dict], Dict]:
    """Read a checkpoint back as (params, opt_state or None, metadata), all
    numpy (``models.networks.params_to_torch`` makes tensors)."""
    with np.load(path) as npz:
        files = list(npz.files)
        params = _nest({k[len("param/"):]: npz[k] for k in files
                        if k.startswith("param/")})
        opt = {k[len("opt/"):]: npz[k] for k in files if k.startswith("opt/")}
        meta = {}
        if "__metadata__" in files:
            meta = json.loads(bytes(npz["__metadata__"]).decode())
    opt_state = None
    if _ADAM + "count" in opt:
        opt_state = {"count": int(opt[_ADAM + "count"])}
        for part in ("mu", "nu"):
            pre = _ADAM + part + "/"
            opt_state[part] = _nest({k[len(pre):]: v for k, v in opt.items()
                                     if k.startswith(pre)})
    return params, opt_state, meta


class Checkpointer:
    """Periodic snapshots named the reference way
    (extend_monitoring.py:83-165): every ``interval`` *samples*, plus a
    forced final snapshot; filename iteration = samples processed."""

    def __init__(self, snapshot_dir: str, description: str, interval: int):
        assert interval > 0
        self.snapshot_dir = snapshot_dir
        self.description = description
        self.interval = interval
        self.created = []

    def path(self, samples: int) -> str:
        return os.path.join(
            self.snapshot_dir,
            "{}_barrista_iter_{}.npz".format(self.description, samples))

    def would_save(self, samples: int, prev: Optional[int] = None) -> bool:
        """True if maybe_save would write (modulo the dedup list).  With
        ``prev`` (the previous step's sample count) a save fires when the
        count crosses an interval boundary, which keeps saving on a resume
        whose batch size walks off the old sample grid; without it, the
        exact-multiple rule."""
        if prev is None:
            return samples % self.interval == 0
        return samples // self.interval > prev // self.interval

    def maybe_save(self, samples: int, params, opt_state=None,
                   metadata=None, finalize: bool = False,
                   prev: Optional[int] = None):
        if samples in self.created:
            return None
        if self.would_save(samples, prev) or finalize:
            path = self.path(samples)
            save_checkpoint(path, params, opt_state, metadata)
            self.created.append(samples)
            return path
        return None

    def highest_iteration(self) -> int:
        """The latest checkpoint's sample count in the snapshot dir (no
        fnmatch: descriptions contain '[')."""
        prefix = self.description + "_barrista_iter_"
        best = 0
        if not os.path.isdir(self.snapshot_dir):
            return 0
        for f in os.listdir(self.snapshot_dir):
            if f.startswith(prefix):
                m = re.match(r".*_barrista_iter_(\d+)\.npz$", f)
                if m:
                    best = max(best, int(m.group(1)))
        return best
