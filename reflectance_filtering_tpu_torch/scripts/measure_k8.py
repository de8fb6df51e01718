"""K8's two kernels on the card: the sort path and the quadratic search,
in turns, on the training step's points and beside them.

    python -m reflectance_filtering_tpu_torch.scripts.measure_k8 [--seed N]

K8 (``csrc/whdr_gather.cu``, the WHDR scatter-add, the backward of the
point-pair gather) takes its sort path up to 8,192 comparisons an image:
each image's pixels are cut into bands, a block a band sorting its points
by (pixel, comparison order); above, the quadratic search.
``ops.whdr_gather._scatter_quadratic`` forces the second.  This script
holds the two bitwise equal on each case, then times each wrapper by CUDA
events around ITERS back-to-back calls, in turns (sort, quadratic,
quadratic, sort, ... over ROUNDS pairs, medians), and each path's device
time, kernel and memset apart, by ``torch.profiler`` over PROFILE_CALLS
calls.  The cases, made on the card from ``--seed``: the training step's
20 x 256x256 at K = 1181 with the points spread over the image and with
half of them crowded into a 12x12 corner (one band holds them), K = 600,
4 planes of 2048x2048 (64-bit keys) and K = 8000 (16 keys a thread).

Needs a CUDA device: without one it exits nonzero and builds nothing.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict

import torch

from ..ops.whdr_gather import _scatter_quadratic, scatter_pairs
from ..utils.profiling import profile_calls

# name -> (images, height, width, K, half of the points in a 12x12 corner)
CASES = {"training step": (20, 256, 256, 1181, False),
         "training step, crowded": (20, 256, 256, 1181, True),
         "K=600": (20, 256, 256, 600, False),
         "64-bit keys": (4, 2048, 2048, 1181, False),
         "K=8000": (2, 256, 256, 8000, False)}
ITERS, WARMUP, ROUNDS, PROFILE_CALLS = 100, 3, 3, 20
PATHS = {"sort": scatter_pairs, "quadratic": _scatter_quadratic}


def make_inputs(device, seed: int = 0, cases=CASES) -> Dict[str, tuple]:
    """name -> (shape, indices, g1, g2) on ``device``: int32 indices into
    the plane and float32 cotangents, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (b, h, w, k, crowded) in cases.items():
        idx = [torch.randint(0, n, (b, k), device=device, dtype=torch.int32,
                             generator=gen) for n in (h, w, h, w)]
        if crowded:
            for t in idx:
                t[:, : k // 2] %= 12
        g1, g2 = (torch.randn(b, k, device=device, generator=gen)
                  for _ in range(2))
        out[name] = ((b, h, w), idx, g1, g2)
    return out


def _ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _device_ms(fn) -> Dict[str, float]:
    """{"kernel": ms, "memset": ms} per call from torch.profiler."""
    out = {"kernel": 0.0, "memset": 0.0}
    for call in profile_calls(fn, PROFILE_CALLS)[0]:
        for name, start, end in call:
            part = ("kernel" if "whdr_scatter" in name
                    else "memset" if "Memset" in name else None)
            if part:
                out[part] += (end - start) / 1e3
    return {part: ms / PROFILE_CALLS for part, ms in out.items()}


def measure(inputs: Dict[str, tuple]) -> Dict[str, dict]:
    """name -> {"wrapper": {path: ms}, "device": {path: {"kernel",
    "memset"}}}, path "sort" or "quadratic"; raises if a case's two paths
    differ in any bit."""
    out = {}
    for name, (shape, idx, g1, g2) in inputs.items():
        runs = {path: (lambda fn=fn: fn(shape, *idx, g1, g2))
                for path, fn in PATHS.items()}
        if not torch.equal(runs["sort"](), runs["quadratic"]()):
            raise RuntimeError("K8's sort path and quadratic search differ "
                               "on " + name)
        times = {path: [] for path in PATHS}
        for r in range(ROUNDS):
            for path in (list(PATHS) if r % 2 == 0 else list(PATHS)[::-1]):
                times[path].append(_ms(runs[path]))
        out[name] = {
            "wrapper": {path: statistics.median(ms)
                        for path, ms in times.items()},
            "device": {path: _device_ms(run) for path, run in runs.items()}}
    return out


def print_table(result: Dict[str, dict]) -> None:
    for name, r in result.items():
        b, h, w, k, _ = CASES[name]
        dev = r["device"]
        print("K8 {} ({}x{}x{}, K={}): wrapper ms sort path {:.4f}, "
              "quadratic {:.4f}; device ms kernel {:.4f} + memset {:.4f}, "
              "quadratic {:.4f} + {:.4f}".format(
                  name, b, h, w, k, r["wrapper"]["sort"],
                  r["wrapper"]["quadratic"], dev["sort"]["kernel"],
                  dev["sort"]["memset"], dev["quadratic"]["kernel"],
                  dev["quadratic"]["memset"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_k8: needs a CUDA device (it times kernels; there "
                 "is no CPU version)")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    print_table(measure(make_inputs(dev, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
