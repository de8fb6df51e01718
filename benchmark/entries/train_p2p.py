"""Training pix2pix's U-Net-256 generator (configuration ``pix2pix_unet256``:
num_downs 8, ngf 64, rRelMax) through ``train/loop.py::fit`` over a set
resident on the card, as ``entries/train_unet.py`` trains the uNet, whose
helpers this entry imports: one ``fit`` call under
``matmul_precision("highest")`` (TF32 off, as the train CLI runs it), its
first CHECKED_STEPS steps set-up (eager, captured, replayed), the window
the chunks of replays after, one host wait a chunk.

The comparison holds each checked step, from the program's state before
it, to the reference (``benchmark/reference/pix2pix.py``) computed in
float64.  Unlike the uNet's, the estimate (1 + tanh) / 2 keeps far from
rRelMax's eps floor, so no pixel's weight is left undetermined there; what
float32 leaves undetermined here is the slope of a ReLU or LeakyReLU input
within its rounding of 0, whose flip in one of the innermost maps moves a
leaf by ~1e-2, and a gradient is compared past those
(``reference/pix2pix.py::undetermined``).  Batch norm's running statistics
are held to PyTorch's rule from the reference's batch statistics.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from .. import closed_loop, counts_pix2pix, faults
from . import widest
from .train import CHECKED_STEPS, WindowClosed, _Recorder, _batches, _on
from .train_unet import _conv_launches, _difference_gaps, _loss_config
from ..profiling import LEAD_CALLS, Session as TraceSession, kept
from ..reference import pix2pix as ref_p2p
from ..reference import unet as ref_unet
from ..reference.flagship import srgb_to_linear
from ..traffic import generate

# the traffic keys this entry reads
TRAFFIC = ("batch", "images", "height", "width")
FAULTS = faults.planted(faults.training, "unchanged", "half", "answer",
                        "stale_count")
# a cell cut to a size a CPU test holds: the same code paths; the smallest
# U-Net the published code builds (num_downs 5) at ngf 4, 32x32
CPU_SIZES = {"traffic": {"batch": 4, "images": 12, "height": 32,
                         "width": 32},
             "config": {"network": {"type": "pix2pixUnet", "num_downs": 5,
                                    "ngf": 4}}}


def _network(config: Dict):
    net = config["network"]
    return net["num_downs"], net["ngf"]


def p2p_weights(gen: torch.Generator, config: Dict
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The seeded initial parameters on the generator's device, in the
    trainer's layout: pix2pix's normal init from one draw (kernels
    N(0, 0.02), gamma N(1, 0.02)), beta and the bias 0, running mean 0
    and variance 1."""
    shapes = ref_p2p.param_shapes(*_network(config))
    drawn = [(a, k) for a, q in shapes.items() for k in q
             if k in ("kernel", "gamma")]
    sizes = [math.prod(shapes[a][k]) for a, k in drawn]
    z = torch.randn(sum(sizes), generator=gen, device=gen.device)
    out = {a: {k: torch.full(s, 1.0 if k == "var" else 0.0,
                             device=gen.device) for k, s in q.items()}
           for a, q in shapes.items()}
    at = 0
    for (a, k), size in zip(drawn, sizes):
        out[a][k] = (z[at:at + size] * 0.02 + (1.0 if k == "gamma" else 0.0)
                     ).reshape(shapes[a][k]).contiguous()
        at += size
    return out


def _norm_launches():
    """The program's count of batch norms issued (replays included); None
    from a program that does not count them."""
    from reflectance_filtering_tpu_torch.models import networks
    return getattr(networks.batch_norm, "launches", None)


def _net_config(config: Dict):
    from reflectance_filtering_tpu_torch.models.networks import NetworkConfig
    n, ngf = _network(config)
    return NetworkConfig(network_type="pix2pixUnet", num_layers=n,
                         num_filters_log=int(math.log2(ngf)),
                         rs_est_mode=config["train"]["head"])


class Session:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.device, self.config, self.traffic = device, config, traffic
        n, h, w = traffic["images"], traffic["height"], traffic["width"]
        gen = torch.Generator(device).manual_seed(seed)
        self.params0 = p2p_weights(gen, config)
        photos = generate.device_photos(gen, n, h, w)
        self.images = srgb_to_linear(photos / 255.0).permute(
            0, 2, 3, 1).contiguous()
        self.comps = generate.comparisons(gen, n, config["whdr"]
                                          ["comparisons"])
        self.losses: List[float] = []
        self.recorder = None

    def window(self, seconds: float, trace_calls: int = 0
               ) -> Dict[str, Any]:
        """The run's fit call: set-up steps, the window, then, with
        ``trace_calls``, that many chunks traced (one a traced call) and
        the convolutions and batch norms the program counted over them."""
        from reflectance_filtering_tpu_torch.models.networks import (
            matmul_precision)
        from reflectance_filtering_tpu_torch.train import loop

        bs = self.traffic["batch"]
        chunk = loop.TRAIN_CHUNK_STEPS
        got: Dict[str, Any] = {}
        trace = {"session": None, "marks": [], "leads": list(LEAD_CALLS)}

        def opened():
            got["start"] = closed_loop.clock()

        def per_step(marks, i):
            first, last = marks[-trace_calls - 1][i], marks[-1][i]
            if first is not None:
                return (last - first) / (trace_calls * chunk)
            return None

        def progress(step: int, samples: int, metrics: Dict) -> None:
            if step < CHECKED_STEPS:
                self.losses.append(float(metrics["loss_total"]))
                return
            k = step - CHECKED_STEPS
            if k % chunk:
                return
            # the first step of a drained chunk: the chunk has run
            now = closed_loop.clock()
            if "wall_s" not in got:
                if now - got["start"] < seconds:
                    return
                got["wall_s"] = now - got["start"]
                got["requests"] = k + chunk
                if not trace_calls:
                    raise WindowClosed
            if trace["session"] is None:
                trace["session"] = TraceSession()
                trace["session"].start()
                trace["marks"] = []
            trace["session"].mark()
            # the launches issued up to the marker: those of the chunks
            # dispatched before it
            trace["marks"].append((_conv_launches(), _norm_launches()))
            # a traced call is the chunk between two markers
            if len(trace["marks"]) == trace["leads"][0] + trace_calls + 1:
                calls = kept(trace["session"].stop(), trace_calls)
                trace["session"] = None
                trace["leads"].pop(0)
                if calls is not None or not trace["leads"]:
                    got["calls"] = calls
                    for i, key in enumerate(("convs_per_step",
                                             "norms_per_step")):
                        value = per_step(trace["marks"], i)
                        if value is not None:
                            got[key] = value
                    raise WindowClosed

        self.recorder = _Recorder(bs, opened)
        data = {"images": self.images.cpu().numpy(),
                "comparisons": self.comps.cpu().numpy()}
        steps = CHECKED_STEPS + chunk * 1_000_000
        try:
            with matmul_precision("highest"):
                loop.fit(_net_config(self.config), _loss_config(self.config),
                         data, steps * bs, bs, solver_type="ADAM",
                         base_lr=self.config["train"]["lr"], random_seed=0,
                         init_params=self.params0,
                         checkpointer=self.recorder, progress=progress,
                         device=self.device)
        except WindowClosed:
            closed_loop.sync(self.device)
        h, w = self.traffic["height"], self.traffic["width"]
        sizes = (bs, h, w) + _network(self.config)
        got["metrics"] = {"train_images_per_s":
                          bs * got["requests"] / got["wall_s"]}
        got["model_flops"] = counts_pix2pix.train_step_flops(*sizes)
        got["conv_bound_s"] = counts_pix2pix.conv_bound_s(*sizes)
        got["norm_bound_s"] = counts_pix2pix.norm_bound_s(*sizes)
        got["per_call"] = chunk
        return got

    def release(self) -> Dict[str, Any]:
        return {"inputs": {"params0": self.params0, "images": self.images,
                           "comps": self.comps},
                "outputs": {"losses": self.losses,
                            "states": [self.recorder.states.get(samples)
                                       for samples in self.recorder.due]}}


def judge(config: Dict, traffic: Dict, inputs: Dict, outputs: Dict,
          device: torch.device) -> Dict[str, float]:
    """The first CHECKED_STEPS steps, step 1 eager and the rest replays of
    the captured step, each from the program's state before it (step 1:
    the seeded start) against the reference at those parameters computed
    in float64, so that a reading holds the program's rounding alone, with
    Adam's count the step's index.  A leaf's gap is the norm of the
    difference over the larger of the leaf's and the median leaf's norm
    of what it is held to:

    * ``loss_gap``: the step's loss, relative;
    * ``grad_gap``: the step's gradient as Adam got it (from the program's
      first moments before and after it) against the reference's, by the
      worst trained leaf, gamma and beta included, past the flips of
      ReLU inputs near 0 that float32 leaves undetermined in the small
      maps (``reference/pix2pix.py::undetermined``,
      ``unet.gradient_gaps``); the ~100 flips a step in the larger maps
      move a leaf by a few 1e-3 together, which the limit holds;
    * ``change_gap``: the step's change of each trained leaf against
      Adam's update from the program's own moments after it and the
      step's index (Adam scales each element to a step of about lr
      whatever its size, so a change follows the rounding of every small
      gradient element: the change is held to the moments, and the
      moments to the reference);
    * ``moment_gap``: Adam's second moment after the step against its
      update from the program's moment before it and its gradient;
    * ``count_gap``: Adam's count after the step against its index;
    * ``bn_stats_gap``: each batch norm's move of its running mean and
      variance in the step against PyTorch's rule (0.1 x the reference's
      batch mean or unbiased variance less the running one before), by
      the worst leaf."""
    if len(outputs["losses"]) < CHECKED_STEPS or None in outputs["states"]:
        raise RuntimeError("the run did not reach step {}".format(
            CHECKED_STEPS))
    lr = config["train"]["lr"]
    b1, b2 = ref_p2p.BETAS
    params = _on(inputs["params0"], device)
    names = ref_p2p.trainable(params)
    mu = {a: {k: torch.zeros_like(params[a][k]) for k in q}
          for a, q in params.items()}
    nu = mu
    gaps = {k: [] for k in ("loss_gap", "grad_gap", "change_gap",
                            "moment_gap", "count_gap", "bn_stats_gap")}
    for t, ((images, comps), loss, (p_after, s_after)) in enumerate(
            zip(_batches(traffic, inputs), outputs["losses"],
                outputs["states"]), start=1):
        p_after, s_after = _on(p_after, device), _on(s_after, device)
        p64 = {a: {k: v.double() for k, v in q.items()}
               for a, q in params.items()}
        value, grad, stats = ref_p2p.gradient(p64, images.double(),
                                              comps.double())
        got, r_nu, step = {}, {}, {}
        for a, k in names:
            g = (s_after["mu"][a][k].double() - b1 * mu[a][k].double()) / (
                1.0 - b1)
            got.setdefault(a, {})[k] = g
            r_nu.setdefault(a, {})[k] = (b2 * nu[a][k].double()
                                         + (1 - b2) * g * g)
            step.setdefault(a, {})[k] = -lr * (
                s_after["mu"][a][k].double() / (1 - b1 ** t)) / (
                (s_after["nu"][a][k].double() / (1 - b2 ** t)).sqrt()
                + ref_p2p.ADAM_EPS)
        change = {a: {k: p_after[a][k].double() - params[a][k].double()
                      for k in q} for a, q in step.items()}
        running = [(a, k) for a in stats for k in ref_p2p.RUNNING]
        moved = {a: {k: p_after[a][k].double() - p64[a][k] for k in
                     ref_p2p.RUNNING} for a in stats}
        want = {a: {k: v - p64[a][k] for k, v in q.items()} for a, q in
                ref_p2p.running_statistics(p64, stats).items()}
        gaps["loss_gap"].append(abs(loss - value) / abs(value))
        band = ref_p2p.undetermined(params, images, comps)
        gaps["grad_gap"].extend(ref_unet.gradient_gaps(got, grad, band)
                                .values())
        gaps["change_gap"].extend(_difference_gaps(change, step, names)
                                  .values())
        gaps["moment_gap"].extend(_difference_gaps(s_after["nu"], r_nu,
                                                   names).values())
        gaps["count_gap"].append(abs(float(s_after["count"]) - t))
        gaps["bn_stats_gap"].extend(_difference_gaps(moved, want, running)
                                    .values())
        params, mu, nu = p_after, s_after["mu"], s_after["nu"]
    return {k: widest(v) for k, v in gaps.items()}


def control_outputs(config: Dict, traffic: Dict, inputs: Dict,
                    outputs: Dict, device: torch.device) -> Dict:
    """The reference one precision step lower (TF32 on, its convolutions'
    operands rounded to TF32) in the program's place."""
    steps = ref_p2p.adam_steps(inputs["params0"], _batches(traffic, inputs),
                               config["train"]["lr"], low=True)
    return {"losses": [value for value, _, _, _ in steps],
            "states": [(after, state) for _, _, after, state in steps]}
