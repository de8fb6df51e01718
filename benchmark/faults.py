"""Faults planted under the timed path, for the readings that set a cell's
limits (``calibrate.py``) and for the tests that see ``correct`` come out
false.  An entry module declares the faults its cells take (``FAULTS``: a
fault's name and the context manager that plants it, most drawn from the
planters here by :func:`planted`), and :func:`plant` reads that
declaration, so an entry added later brings its faults, or a planter of
its own, in its own file.  A planter patches the program while it is open;
the names say what the fault does:

* ``unchanged``: a step returns its state unchanged (:func:`training`:
  Adam's step does nothing; :func:`guided_chain`: one iteration fewer);
* ``half``: half of the batch left out (training: the loss's mean over the
  first half; :func:`serving`: the second half's outputs zero; the chain:
  the lower half of the frame left unfiltered);
* ``answer``: an answer altered where it is produced (training: the
  reported loss 1% high; serving: one image's levels one higher; the
  chain: one value one level higher);
* ``score``: serving only, one image's WHDR 0.01 higher;
* ``stale_count``: training only, every step after the first leaves
  Adam's count as it found it (its bias correction then stale).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, ContextManager, Dict
from unittest import mock

import torch

from .harness import load_entry


def plant(entry: str, fault: str) -> ContextManager:
    """The context manager that plants ``fault`` under the timed path of
    entry ``entry``, as the entry's ``FAULTS`` declares it."""
    declared = load_entry(entry).FAULTS
    if fault not in declared:
        raise ValueError("no fault '{}' for entry '{}'".format(fault, entry))
    return declared[fault]()


def planted(planter: Callable[[str], ContextManager], *names: str
            ) -> Dict[str, Callable[[], ContextManager]]:
    """An entry's ``FAULTS``: each of ``names`` planted by
    ``planter(name)``."""
    return {name: functools.partial(planter, name) for name in names}


@contextlib.contextmanager
def serving(fault: str):
    """A fault of ``pipeline_fn``'s forward or of ``whdr_per_image``."""
    from reflectance_filtering_tpu_torch.losses import whdr
    from reflectance_filtering_tpu_torch.utils.serving import FlagshipModule

    forward = FlagshipModule.forward
    per_image = whdr.whdr_per_image
    if fault == "half":
        def patched(self, x):
            q = forward(self, x[:x.shape[0] // 2])
            return torch.cat([q, torch.zeros_like(q[:x.shape[0] - len(q)])])
        target, name = FlagshipModule, "forward"
    elif fault == "answer":
        def patched(self, x):
            q = forward(self, x)
            q[0] = torch.clamp(q[0] + 1.0, 0.0, 255.0)
            return q
        target, name = FlagshipModule, "forward"
    else:
        def patched(*args, **kwargs):
            w = per_image(*args, **kwargs)
            w[0] += 0.01
            return w
        target, name = whdr, "whdr_per_image"
    with mock.patch.object(target, name, patched):
        yield


@contextlib.contextmanager
def guided_chain(fault: str):
    """A fault of ``guided_filter_iterated``."""
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
def training(fault: str):
    """A fault of ``fit``'s optimizer, loss or reported metrics."""
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
