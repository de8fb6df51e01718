"""Faults planted under the timed path, for the readings that set a cell's
limits (``calibrate.py``) and for the tests that see ``correct`` come out
false.  Each is a context manager that patches the program while it is
open; the names say what the fault does:

* ``unchanged``: a step returns its state unchanged (training: Adam's step
  does nothing; the chain: one iteration fewer);
* ``half``: half of the batch left out (training: the loss's mean over the
  first half; serving: the second half's outputs zero; the chain: the
  lower half of the frame left unfiltered);
* ``answer``: an answer altered where it is produced (training: the
  reported loss 1% high; serving: one image's levels one higher; the
  chain: one value one level higher);
* ``score``: serving only, one image's WHDR 0.01 higher;
* ``stale_count``: training only, every step after the first leaves
  Adam's count as it found it (its bias correction then stale).
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = {"serve": ("half", "answer", "score"),
          "chain": ("unchanged", "half", "answer"),
          "train": ("unchanged", "half", "answer", "stale_count")}


@contextlib.contextmanager
def plant(entry: str, fault: str):
    if fault not in FAULTS[entry]:
        raise ValueError("no fault '{}' for entry '{}'".format(fault, entry))
    with globals()["_" + entry](fault):
        yield


@contextlib.contextmanager
def _serve(fault: str):
    from reflectance_filtering_tpu_torch.losses import whdr
    from reflectance_filtering_tpu_torch.utils import serving

    forward = serving.FlagshipModule.forward
    per_image = whdr.whdr_per_image
    if fault == "half":
        def patched(self, x):
            q = forward(self, x[:x.shape[0] // 2])
            return torch.cat([q, torch.zeros_like(q[:x.shape[0] - len(q)])])
        target, name = serving.FlagshipModule, "forward"
    elif fault == "answer":
        def patched(self, x):
            q = forward(self, x)
            q[0] = torch.clamp(q[0] + 1.0, 0.0, 255.0)
            return q
        target, name = serving.FlagshipModule, "forward"
    else:
        def patched(*args, **kwargs):
            w = per_image(*args, **kwargs)
            w[0] += 0.01
            return w
        target, name = whdr, "whdr_per_image"
    with mock.patch.object(target, name, patched):
        yield


@contextlib.contextmanager
def _chain(fault: str):
    from reflectance_filtering_tpu_torch.ops import guided

    iterated = guided.guided_filter_iterated

    def patched(guide, src, radius, eps, iterations=3, **kw):
        if fault == "unchanged":
            return iterated(guide, src, radius, eps, iterations - 1, **kw)
        out = iterated(guide, src, radius, eps, iterations, **kw)
        if fault == "half":
            h = out.shape[2]
            out[:, :, h // 2:] = src[:, :, h // 2:]
        else:
            out[0, 0, 0, 0] += 1.0
        return out

    with mock.patch.object(guided, "guided_filter_iterated", patched):
        yield


@contextlib.contextmanager
def _train(fault: str):
    from reflectance_filtering_tpu_torch.train import loop

    if fault in ("unchanged", "stale_count"):
        make = loop.make_optimizer

        def patched(*args, **kwargs):
            opt = make(*args, **kwargs)
            if fault == "unchanged":
                opt.step = lambda *a, **k: None
                return opt
            step, calls = opt.step, [0]

            def stale(*a, **k):
                out = step(*a, **k)
                calls[0] += 1
                # a graph captured here records the rewind: each replay
                # then steps from the count the first step left
                if calls[0] > 1:
                    with torch.no_grad():
                        for st in opt.state.values():
                            st["step"].sub_(1)
                return out
            opt.step = stale
            return opt
        target = ("make_optimizer", patched)
    elif fault == "half":
        hinge = loop.whdr_hinge_batch

        def patched(reflectance, comparisons, *args, **kwargs):
            n = reflectance.shape[0] // 2
            return hinge(reflectance[:n], comparisons[:n], *args, **kwargs)
        target = ("whdr_hinge_batch", patched)
    else:
        losses = loop.compute_losses

        def patched(*args, **kwargs):
            total, metrics = losses(*args, **kwargs)
            metrics["loss_total"] = metrics["loss_total"] * 1.01
            return total, metrics
        target = ("compute_losses", patched)
    with mock.patch.object(loop, *target):
        yield
