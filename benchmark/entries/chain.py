"""Frames through ``ops/guided.py::guided_filter_iterated(planar=True)``,
the iterated guided filter of a video caller: each frame's guide (three
planes) and source (one plane) already on the card, one frame at a time,
each result waited for before the next frame starts.  The frames come
from a pool of distinct seeded frames made on the card, cycled."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import closed_loop, faults
from . import widest
from ..profiling import trace_calls as trace_calls_of
from ..reference import filters
from ..traffic import generate

# the traffic keys this entry reads
TRAFFIC = ("pool", "warmup", "sample")
FAULTS = faults.planted(faults.guided_chain, "unchanged", "half", "answer")
# a cell cut to a size a CPU test holds: the same code paths on a small
# frame, which the configuration sets
CPU_SIZES = {"traffic": {"pool": 2, "warmup": 1, "sample": 2},
             "config": {"height": 60, "width": 72}}


class Session:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        from reflectance_filtering_tpu_torch.ops.guided import (
            guided_filter_iterated)

        self.device, self.traffic, self.config = device, traffic, config
        h, w = config["height"], config["width"]
        gen = torch.Generator(device).manual_seed(seed)
        self.guides = [generate.device_photos(gen, 1, h, w)
                       for _ in range(traffic["pool"])]
        self.srcs = [generate.pink_planes(gen, 1, h, w)
                     for _ in range(traffic["pool"])]
        radius, eps = config["radius"], config["eps"]
        iterations = config["iterations"]

        def request(j: int):
            return guided_filter_iterated(self.guides[j], self.srcs[j],
                                          radius, eps, iterations,
                                          planar=True)

        self.request = request
        self.sample = closed_loop.Reservoir(traffic["sample"], seed)
        for j in range(traffic["warmup"]):
            request(j % traffic["pool"])
        closed_loop.sync(device)

    def window(self, seconds: float, trace_calls: int = 0
               ) -> Dict[str, Any]:
        """The window, then, with ``trace_calls``, that many requests
        traced (one a traced call)."""
        got = closed_loop.run(self.request, self.traffic["pool"], seconds,
                              self.device, self.sample)
        mp = self.config["height"] * self.config["width"] * 1e-6
        got["metrics"] = {"chain_mpix_per_s":
                          mp * got["requests"] / got["wall_s"]}
        got["pixels"] = self.config["height"] * self.config["width"]
        if trace_calls:
            got["calls"] = trace_calls_of(lambda: self.request(0),
                                          trace_calls)
            got["per_call"] = 1
        return got

    def release(self) -> Dict[str, Any]:
        self.request = None
        outputs = [(j, out) for _, (j, out) in self.sample.items]
        return {"inputs": {"guides": self.guides, "srcs": self.srcs},
                "outputs": outputs}


def _reference(config: Dict, inputs: Dict, j: int, low: bool = False):
    return filters.guided_chain(inputs["guides"][j], inputs["srcs"][j],
                                config["radius"], config["eps"],
                                config["iterations"], low=low)


def judge(config: Dict, traffic: Dict, inputs: Dict, outputs: List,
          device: torch.device) -> Dict[str, float]:
    """The sampled frames against the reference chain in float64: the
    widest gap of an output value, in levels."""
    ref, gaps = {}, []
    for j, out in outputs:
        if j not in ref:
            ref[j] = _reference(config, inputs, j)
        gaps.append((out.to(torch.float64) - ref[j]).abs().max())
    return {"max_gap": widest(gaps)}


def control_outputs(config: Dict, traffic: Dict, inputs: Dict,
                    outputs: List, device: torch.device) -> List:
    """The reference chain in bfloat16 in the program's place."""
    return [(j, _reference(config, inputs, j, low=True).to(torch.float32))
            for j, _ in outputs]
