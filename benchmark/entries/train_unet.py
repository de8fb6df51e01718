"""Training the reference's two-stream uNet (configuration ``unet_n2k3_512``:
numLayers 2, kernel 3, rRelMax) through ``train/loop.py::fit`` over a set
resident on the card, as ``entries/train.py`` trains the flagship, whose
helpers this entry imports: one ``fit`` call under
``matmul_precision("highest")`` (TF32 off, as the train CLI runs it), its
first CHECKED_STEPS steps set-up (eager, captured, replayed), the window
the chunks of replays after, one host wait a chunk.

The comparison differs from the flagship's where this network forces it.
rRelMax floors the estimate at float32's eps, and the boundary loss of the
shading (image intensity / estimate) weighs a pixel by 1 / estimate^2.  At
20 x 512x512 a step holds hundreds of pixels whose estimate lies within a
few eps of the floor: float32 rounding puts some of them on either side of
it and moves the weight of the others by up to a percent, and these
pixels can hold most of the gradient.  So a gradient is compared with the
reference's past the directions that float32 leaves undetermined there,
which the reference finds from its own float32 and float64 runs
(``benchmark/reference/unet.py``: ``undetermined``, ``gradient_gaps``); and the WHDR
term's gradient, which the boundary term can drown, is compared on its
own: the program's, from its loss with the boundary weight 0 at each
checked step's parameters, against the reference's.  Adam's second moment
and change are compared with Adam's arithmetic on the program's own
gradient.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from .. import closed_loop, counts_unet, faults
from . import widest
from .train import CHECKED_STEPS, WindowClosed, _Recorder, _batches, _on
from ..profiling import LEAD_CALLS, Session as TraceSession, kept
from ..reference import unet as ref_unet
from ..reference.flagship import srgb_to_linear
from ..traffic import generate

# the traffic keys this entry reads
TRAFFIC = ("batch", "images", "height", "width")
FAULTS = faults.planted(faults.training, "unchanged", "half", "answer",
                        "stale_count")
# a cell cut to a size a CPU test holds: the same code paths; 24x32 is
# divisible by 8, as the network's three strides need
CPU_SIZES = {"traffic": {"batch": 4, "images": 12, "height": 24,
                         "width": 32},
             "config": {}}


def _network(config: Dict):
    net = config["network"]
    return net["num_layers"], net["kernel_pad"]


def unet_weights(gen: torch.Generator, config: Dict
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The seeded initial parameters on the generator's device, in the
    trainer's layout: caffe's xavier (uniform, bound sqrt(3 / fan_in),
    fan_in = kh kw in) from one draw, zero biases."""
    n, p = _network(config)
    shapes = ref_unet.param_shapes(n, 2 * p + 1)
    sizes = [kh * kw * ci * co for kh, kw, ci, co in shapes.values()]
    u = torch.rand(sum(sizes), generator=gen, device=gen.device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        a = (3.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
        out[name] = {"kernel": ((u[at:at + size] * 2.0 - 1.0) * a)
                     .reshape(shape).contiguous(),
                     "bias": torch.zeros(shape[3], device=gen.device)}
        at += size
    return out


def _loss_config(config: Dict, boundaries: float = None):
    """The program's LossConfig of the configuration, its boundary weight
    ``boundaries`` where given."""
    from reflectance_filtering_tpu_torch.train import loop

    train = config["train"]
    if boundaries is None:
        boundaries = train["loss_scale_boundaries01"]
    return loop.LossConfig(
        loss_scale_whdr=train["loss_scale_whdr"],
        loss_scale_lambert=train["loss_scale_lambert"],
        loss_scale_boundaries01=boundaries,
        shading_unary_type=train["boundary_norm"] + "_0.5",
        whdr_delta_margin_ratio_dense="{}_{}_1.0_1".format(
            config["whdr"]["delta"], train["margin"]))


def _conv_launches():
    """The program's count of convolutions and deconvolutions issued
    (replays included); None from a program that does not count them."""
    from reflectance_filtering_tpu_torch.models import networks
    got = [getattr(f, "launches", None)
           for f in (networks.conv2d, networks.deconv2d)]
    return None if None in got else sum(got)


class Session:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.device, self.config, self.traffic = device, config, traffic
        n, h, w = traffic["images"], traffic["height"], traffic["width"]
        gen = torch.Generator(device).manual_seed(seed)
        self.params0 = unet_weights(gen, config)
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
        the convolutions the program counted over them."""
        from reflectance_filtering_tpu_torch.models.networks import (
            NetworkConfig, matmul_precision)
        from reflectance_filtering_tpu_torch.train import loop

        bs, train = self.traffic["batch"], self.config["train"]
        n, p = _network(self.config)
        chunk = loop.TRAIN_CHUNK_STEPS
        got: Dict[str, Any] = {}
        trace = {"session": None, "marks": [], "leads": list(LEAD_CALLS)}

        def opened():
            got["start"] = closed_loop.clock()

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
            # the convolutions issued up to the marker: those of the
            # chunks dispatched before it
            trace["marks"].append(_conv_launches())
            # a traced call is the chunk between two markers
            if len(trace["marks"]) == trace["leads"][0] + trace_calls + 1:
                calls = kept(trace["session"].stop(), trace_calls)
                trace["session"] = None
                trace["leads"].pop(0)
                if calls is not None or not trace["leads"]:
                    got["calls"] = calls
                    first, last = trace["marks"][-trace_calls - 1], \
                        trace["marks"][-1]
                    if first is not None:
                        got["convs_per_step"] = (last - first) / (
                            trace_calls * chunk)
                    raise WindowClosed

        self.recorder = _Recorder(bs, opened)
        data = {"images": self.images.cpu().numpy(),
                "comparisons": self.comps.cpu().numpy()}
        steps = CHECKED_STEPS + chunk * 1_000_000
        net = NetworkConfig(network_type="uNet", num_layers=n, kernel_pad=p,
                            rs_est_mode=train["head"])
        losses = _loss_config(self.config)
        try:
            with matmul_precision("highest"):
                loop.fit(net, losses, data, steps * bs, bs,
                         solver_type="ADAM", base_lr=train["lr"],
                         random_seed=0, init_params=self.params0,
                         checkpointer=self.recorder, progress=progress,
                         device=self.device)
        except WindowClosed:
            closed_loop.sync(self.device)
        h, w = self.traffic["height"], self.traffic["width"]
        got["metrics"] = {"train_images_per_s":
                          bs * got["requests"] / got["wall_s"]}
        got["model_flops"] = counts_unet.train_step_flops(bs, h, w, n,
                                                          2 * p + 1)
        got["conv_bound_s"] = counts_unet.conv_bound_s(bs, h, w, n,
                                                       2 * p + 1)
        got["per_call"] = chunk
        return got

    def release(self) -> Dict[str, Any]:
        states = [self.recorder.states.get(samples)
                  for samples in self.recorder.due]
        return {"inputs": {"params0": self.params0, "images": self.images,
                           "comps": self.comps},
                "outputs": {"losses": self.losses, "states": states,
                            "whdr_grads": self._whdr_grads(states)}}

    def _whdr_grads(self, states) -> List[Dict]:
        """The program's gradient of its loss with the boundary weight 0
        (10 x the WHDR hinge) at each checked step's parameters and batch,
        eager, TF32 off."""
        from reflectance_filtering_tpu_torch.models.networks import (
            NetworkConfig, matmul_precision)
        from reflectance_filtering_tpu_torch.train import loop

        if None in states:
            return []
        n, p = _network(self.config)
        net = NetworkConfig(network_type="uNet", num_layers=n, kernel_pad=p,
                            rs_est_mode=self.config["train"]["head"])
        losses = _loss_config(self.config, boundaries=0.0)
        inputs = {"images": self.images, "comps": self.comps}
        befores = [self.params0] + [after for after, _ in states[:-1]]
        out = []
        for params, (images, comps) in zip(
                befores, _batches(self.traffic, inputs)):
            leaves = loop.trainable(_on(params, self.device), self.device)
            keys = [(a, k) for a, q in leaves.items() for k in q]
            with matmul_precision("highest"):
                total, _ = loop.compute_losses(leaves, images, comps, net,
                                               losses)
                grads = torch.autograd.grad(
                    total, [leaves[a][k] for a, k in keys])
            grad = {}
            for (a, k), g in zip(keys, grads):
                grad.setdefault(a, {})[k] = g.detach()
            out.append(grad)
        return out


def _difference_gaps(got: Dict, want: Dict, names) -> Dict:
    """Each leaf's norm of ``got`` - ``want`` over the larger of the
    leaf's and the median leaf's norm of ``want``; where both are 0, 0 if
    that norm is, else infinite."""
    norms = {key: float(want[key[0]][key[1]].double().norm())
             for key in names}
    median = sorted(norms.values())[len(norms) // 2]
    out = {}
    for a, k in names:
        gap = float((got[a][k].double() - want[a][k].double()).norm())
        scale = max(norms[(a, k)], median)
        out[(a, k)] = gap / scale if scale else (math.inf if gap else 0.0)
    return out


def judge(config: Dict, traffic: Dict, inputs: Dict, outputs: Dict,
          device: torch.device) -> Dict[str, float]:
    """The first CHECKED_STEPS steps, step 1 eager and the rest replays of
    the captured step, each from the program's state before it (step 1:
    the seeded start) against the reference at those parameters computed
    in float64, so that a reading holds the program's rounding alone (the
    float32 reference's own sums miss a leaf's gradient by up to 7e-3 on
    the CPU), with Adam's count the step's index:

    * ``loss_gap``: the step's loss, relative, past the first-order move
      that the estimate's rounding can make (``undetermined``): the
      shading's boundary loss weighs a pixel by 1 / estimate too;
    * ``grad_gap``: the step's gradient as Adam got it (from the program's
      first moments before and after it) against the reference's, by the
      worst leaf, past what float32 leaves undetermined
      (``gradient_gaps``);
    * ``whdr_grad_gap``: the same of the gradient of 10 x the WHDR hinge
      alone (the boundary weight 0), the program's from its own loss at
      the step's parameters: the boundary term's gradient can drown it;
    * ``moment_gap``: Adam's second moment after the step against its
      update from the program's moment before it and that gradient, by
      the worst leaf (as ``change_gap``);
    * ``change_gap``: the step's change of each parameter leaf against
      Adam's update from the program's own moments after it and the
      step's index, by the worst leaf (the norm of the difference over
      the update's norm, or the median leaf's).  Adam scales each element
      to a step of about lr whatever its size, so a change follows the
      rounding of every small gradient element: the change is held to
      the moments, and the moments to the reference;
    * ``count_gap``: Adam's count after the step against its index."""
    if len(outputs["losses"]) < CHECKED_STEPS or None in outputs["states"] \
            or len(outputs["whdr_grads"]) < CHECKED_STEPS:
        raise RuntimeError("the run did not reach step {}".format(
            CHECKED_STEPS))
    n, p = _network(config)
    lr = config["train"]["lr"]
    b1, b2 = ref_unet.BETAS
    params = _on(inputs["params0"], device)
    names = [(a, k) for a in params for k in params[a]]
    mu = {a: {k: torch.zeros_like(v) for k, v in q.items()}
          for a, q in params.items()}
    nu = mu
    gaps = {k: [] for k in ("loss_gap", "grad_gap", "whdr_grad_gap",
                            "change_gap", "moment_gap", "count_gap")}
    for t, ((images, comps), loss, (p_after, s_after), whdr) in enumerate(
            zip(_batches(traffic, inputs), outputs["losses"],
                outputs["states"], outputs["whdr_grads"]), start=1):
        p_after, s_after = _on(p_after, device), _on(s_after, device)
        p64 = {a: {k: v.double() for k, v in q.items()}
               for a, q in params.items()}
        value, grad = ref_unet.gradient(p64, images.double(),
                                        comps.double(), n, p)
        _, whdr_want = ref_unet.gradient(p64, images.double(),
                                         comps.double(), n, p,
                                         boundaries=0.0)
        band = ref_unet.undetermined(params, images, comps, n, p)
        got = {a: {k: (s_after["mu"][a][k].double()
                       - b1 * mu[a][k].double()) / (1.0 - b1)
                   for k in q} for a, q in params.items()}
        gaps["grad_gap"].extend(ref_unet.gradient_gaps(got, grad, band)
                                .values())
        gaps["whdr_grad_gap"].extend(ref_unet.gradient_gaps(
            _on(whdr, device), whdr_want, ref_unet.undetermined(
                params, images, comps, n, p, boundaries=0.0)).values())
        r_nu, step = {}, {}
        for a, k in names:
            g = got[a][k]
            r_nu.setdefault(a, {})[k] = (b2 * nu[a][k].double()
                                         + (1 - b2) * g * g)
            step.setdefault(a, {})[k] = -lr * (
                s_after["mu"][a][k].double() / (1 - b1 ** t)) / (
                (s_after["nu"][a][k].double() / (1 - b2 ** t)).sqrt()
                + ref_unet.ADAM_EPS)
        change = {a: {k: v.double() - params[a][k].double()
                      for k, v in q.items()} for a, q in p_after.items()}
        gaps["loss_gap"].append(max(0.0, abs(loss - value) - band[2])
                                / abs(value))
        gaps["change_gap"].extend(_difference_gaps(change, step, names)
                                  .values())
        gaps["moment_gap"].extend(_difference_gaps(s_after["nu"], r_nu,
                                                   names).values())
        gaps["count_gap"].append(abs(float(s_after["count"]) - t))
        params, mu, nu = p_after, s_after["mu"], s_after["nu"]
    return {k: widest(v) for k, v in gaps.items()}


def control_outputs(config: Dict, traffic: Dict, inputs: Dict,
                    outputs: Dict, device: torch.device) -> Dict:
    """The reference one precision step lower (TF32 on, its products'
    operands rounded to TF32) in the program's place."""
    n, p = _network(config)
    batches = _batches(traffic, inputs)
    steps = ref_unet.adam_steps(inputs["params0"], batches,
                                config["train"]["lr"], n, p, low=True)
    befores = [inputs["params0"]] + [after for _, _, after, _ in steps[:-1]]
    return {"losses": [value for value, _, _, _ in steps],
            "states": [(after, state) for _, _, after, state in steps],
            "whdr_grads": [ref_unet.gradient(before, images, comps, n, p,
                                             low=True, boundaries=0.0)[1]
                           for before, (images, comps) in zip(befores,
                                                              batches)]}
