"""Served batches: ``utils/serving.py::pipeline_fn(kind)`` then
``losses/whdr.py::whdr_per_image``, as a client sends them.

A request uploads a batch of uint8 BGR photos from pinned host memory,
runs the pipeline, turns its result into uint8 levels on the card, scores
it by WHDR against the batch's comparisons, and copies the levels and the
per-image WHDR back into pinned host memory.  The batches come from a pool
of distinct seeded batches, cycled."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import closed_loop, counts, faults
from . import widest
from ..profiling import trace_calls as trace_calls_of
from ..reference import filters, flagship, whdr
from ..traffic import generate

# the traffic keys this entry reads
TRAFFIC = ("pipeline", "batch", "height", "width", "pool", "warmup",
           "sample", "metrics")
FAULTS = faults.planted(faults.serving, "half", "answer", "score")
# a cell cut to a size a CPU test holds: the same code paths
CPU_SIZES = {"traffic": {"batch": 2, "height": 40, "width": 48, "pool": 3,
                         "warmup": 1, "sample": 4},
             "config": {}}


class Session:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        from reflectance_filtering_tpu_torch.losses.whdr import (
            whdr_per_image)
        from reflectance_filtering_tpu_torch.models.networks import (
            ReflectanceNet)
        from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn

        self.device, self.traffic = device, traffic
        b, h, w = traffic["batch"], traffic["height"], traffic["width"]
        gen = torch.Generator(device).manual_seed(seed)
        self.layers = generate.flagship_weights(gen)
        pin = device.type == "cuda"
        self.photos = [generate.device_photos(gen, b, h, w).to(torch.uint8)
                       .cpu() for _ in range(traffic["pool"])]
        if pin:
            self.photos = [p.pin_memory() for p in self.photos]
        self.comps = [generate.comparisons(gen, b, config["whdr"]
                                           ["comparisons"])
                      for _ in range(traffic["pool"])]
        net = ReflectanceNet().to(device)
        state = {}
        for i, (wt, bias) in enumerate(self.layers[:-1]):
            state["weights.{}".format(i)] = wt
            state["biases.{}".format(i)] = bias
        state["fuse_weight"] = self.layers[-1][0].reshape(-1)
        state["fuse_bias"] = self.layers[-1][1]
        net.load_state_dict(state)
        module = pipeline_fn(traffic["pipeline"], net, device)
        delta = config["whdr"]["delta"]

        def request(j: int):
            x = self.photos[j].to(device, non_blocking=True)
            q = module(x)
            levels = q.to(torch.uint8)
            scores = whdr_per_image(q / 255.0, self.comps[j], delta)
            out = []
            for t in (levels, scores):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                host.copy_(t, non_blocking=True)
                out.append(host)
            return out

        self.request = request
        self.sample = closed_loop.Reservoir(traffic["sample"], seed)
        for j in range(traffic["warmup"]):
            request(j % traffic["pool"])
        closed_loop.sync(device)

    def window(self, seconds: float, trace_calls: int = 0
               ) -> Dict[str, Any]:
        """The window, then, with ``trace_calls``, that many requests
        traced (one a traced call)."""
        b = self.traffic["batch"]
        got = closed_loop.run(self.request, self.traffic["pool"], seconds,
                              self.device, self.sample)
        names = self.traffic["metrics"]
        got["metrics"] = {
            names["images_per_s"]: b * got["requests"] / got["wall_s"],
            names["batch_ms_p95"]: 1e3 * closed_loop.percentile(
                got["latency_s"], 95)}
        got["pixels"] = b * self.traffic["height"] * self.traffic["width"]
        got["model_flops"] = counts.forward_flops(got["pixels"])
        if trace_calls:
            got["calls"] = trace_calls_of(lambda: self.request(0),
                                          trace_calls)
            got["per_call"] = 1
        return got

    def release(self) -> Dict[str, Any]:
        """Drop the program's objects; the inputs and the sampled outputs
        (pool index, uint8 levels, WHDR) stay for :func:`judge`."""
        self.request = None
        outputs = [(j, levels, scores)
                   for _, (j, (levels, scores)) in self.sample.items]
        return {"inputs": {"layers": self.layers, "photos": self.photos,
                           "comps": self.comps}, "outputs": outputs}


def reference_outputs(config: Dict, traffic: Dict, inputs: Dict, j: int,
                      device: torch.device, low: bool = False):
    """The reference pipeline on pool batch ``j``: (uint8 levels [B, H, W],
    WHDR [B]), one precision step lower with ``low`` (the control)."""
    photos = inputs["photos"][j].to(device)
    r = flagship.reflectance(inputs["layers"], photos, low)
    levels = torch.floor(r * 255.0)
    if traffic["pipeline"] == "bf":
        bf = config["bilateral"]
        q = filters.bilateral_gray(levels, bf["sigma_color"],
                                   bf["sigma_space"], low=low)
    else:
        gf = config["guided"]
        guide = photos.flip(1).to(torch.float32)
        q = filters.guided_chain(guide, levels[:, None], gf["radius"],
                                 gf["eps"], 1, low=low)[:, 0]
    out = torch.clamp(torch.round(q.to(torch.float64)), 0, 255).to(
        torch.uint8)
    scores = whdr.whdr(out.to(torch.float32) / 255.0, inputs["comps"][j],
                       config["whdr"]["delta"], low=low)
    return out, scores


def judge(config: Dict, traffic: Dict, inputs: Dict,
          outputs: List, device: torch.device) -> Dict[str, float]:
    """The sampled requests against the reference: the mean gap of an
    output byte from the reference pipeline's, in levels (a byte off by n
    levels counts n times, so few bytes far off fail it as many bytes a
    level off do), and the widest gap of a served WHDR from the
    reference's WHDR of the same served bytes."""
    ref = {}
    level_sum, total, gaps = 0, 0, []
    for j, levels, scores in outputs:
        if j not in ref:
            ref[j] = reference_outputs(config, traffic, inputs, j,
                                       device)[0]
        levels = levels.to(device)
        level_sum += int((levels.to(torch.int32)
                          - ref[j].to(torch.int32)).abs().sum())
        total += levels.numel()
        again = whdr.whdr(levels.to(torch.float32) / 255.0,
                          inputs["comps"][j], config["whdr"]["delta"])
        gaps.append((scores.to(device) - again).abs().max())
    return {"level_mean_gap": level_sum / total, "whdr_gap": widest(gaps)}


def control_outputs(config: Dict, traffic: Dict, inputs: Dict,
                    outputs: List, device: torch.device) -> List:
    """The control in the program's place: the reference one precision
    step lower, on the same sampled requests."""
    out = []
    for j, _, _ in outputs:
        levels, scores = reference_outputs(config, traffic, inputs, j,
                                           device, low=True)
        out.append((j, levels, scores))
    return out
