"""K5's two paths and K4's passes timed on the card, and the times a
before/after comparison of two trees takes.

    python -m reflectance_filtering_tpu_torch.scripts.measure_box_guided \\
        [--seed N] [--compare LABEL]

K5 (``ops/guided_kernel.py``, ``csrc/guided.cu``) runs a call as its
fused pair (stats and solve, then apply; the moment planes never leave
the card's shared memory) or as its four passes (moment columns, solve
rows, (a, b) columns, apply rows).  ``measure`` times both paths, in
turns, on the served gf batch (32 x 256x256, r = 45, eps = 3, C = 1, and
C = 3), the fused pair at band heights of 8-64 rows beside the product's
rule (``fused_band``), and both paths at other frame widths and batch
sizes, the evidence for the product's taking the fused pair wherever it
fits (``fused_fits``); and K4's fused form beside its two passes
(column sums, then each row's prefixes) on its timed stack, the guided
CLI's ``--subsample=4`` planes and a 4K plane.  Before timing, each path's
output is held within 0.05 (K5) or 1e-3 (K4) of the other's.  ``profile``
splits one call into its kernels by ``torch.profiler``: K4 by each form on
[32, 256, 256] at r = 45, K5 by each path on the served batch.

``--compare LABEL`` prints one JSON line of times (CUDA events, inputs
made on the card from ``--seed``) through the wrappers as a tree of the
previous PR has them too: K2 at radius 33 on uint8 levels and on float32,
K6's three main instantiations at radius 33, K4, K5, the 4K and 8K 3x
chains, the bf and gf served batches (``utils.serving.pipeline_fn``, seeded
weights) and K1 on one 256-pixel row, where the host binds it.  Run it
from the roots of two trees in one call on the card, in turns (a, b, b,
a), to compare them on one card.

Needs a CUDA device: without one it exits nonzero and builds nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict

import torch

B, H, W = 32, 256, 256          # the served gf batch
RADIUS, EPS = 45, 3.0
BANDS = (8, 16, 32, 64)
# (n, h, w) frames for the width rule: the served batch, wider frames at a
# like pixel count, and single frames (the guided CLI, the chain check)
FRAMES = [(32, 256, 256), (16, 256, 384), (16, 256, 512), (8, 512, 512),
          (1, 256, 256), (1, 341, 512), (1, 480, 512), (1, 1024, 512)]
# K4: the timed stack, the guided CLI's --subsample=4 moment planes (13
# planes of 64x64 at round(45 / 4)), a 4K plane
BOX_SHAPES = [((B, H, W), RADIUS), ((13, 64, 64), 11), ((1, 2160, 3840),
                                                       RADIUS)]
ITERS, ROUNDS = 20, 3


def time_ms(fn: Callable, iters: int = ITERS, warmup: int = 2) -> float:
    """Mean device ms of fn() over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: Dict[str, Callable], iters: int = ITERS,
             rounds: int = ROUNDS) -> Dict[str, float]:
    """name -> mean of time_ms over ``rounds`` passes through ``fns``, in
    order, then reversed, and so on."""
    names = list(fns)
    got = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            got[name].append(time_ms(fns[name], iters))
    return {name: sum(v) / len(v) for name, v in got.items()}


def kernel_ms(fn: Callable, calls: int = 5) -> Dict[str, float]:
    """Device ms per call of each kernel that fn() launches, from
    torch.profiler over ``calls`` calls (``utils.profiling.profile_calls``,
    after its warm-up calls)."""
    from ..utils.profiling import profile_calls
    out: Dict[str, float] = {}
    for call in profile_calls(fn, calls)[0]:
        for name, start, end in call:
            out[name] = out.get(name, 0.0) + (end - start) / calls / 1e3
    return out


def levels(gen: torch.Generator, *shape) -> torch.Tensor:
    """uint8-valued float32 on the generator's device."""
    return torch.floor(torch.rand(shape, device=gen.device, generator=gen)
                       * 256)


def _gf_inputs(gen, n, h, w, c=1):
    return levels(gen, n, 3, h, w), levels(gen, n, c, h, w)


def measure(device, seed: int = 0) -> Dict[str, dict]:
    """{"served": {path: ms}, "c3": {path: ms}, "frames": {(n, h, w):
    {path: ms}}} on ``device``; paths "four-pass", "fused" (the product's
    band) and "fused band B"."""
    from ..ops.box_kernel import FUSED_WIDEST, box_filter_planar
    from ..ops.guided_kernel import fused_fits, guided_filter_fused
    gen = torch.Generator(device=device).manual_seed(seed)

    def paths(g, s, bands=()):
        fns = {"four-pass": lambda: guided_filter_fused(
            g, s, RADIUS, EPS, path="four-pass")}
        if fused_fits(min(s.shape[1], 3), s.shape[3]):
            fns["fused"] = lambda: guided_filter_fused(g, s, RADIUS, EPS,
                                                       path="fused")
            for band in bands:
                fns["fused band {}".format(band)] = (
                    lambda band=band: guided_filter_fused(
                        g, s, RADIUS, EPS, path="fused", band=band))
        want = fns["four-pass"]()
        for name, fn in fns.items():
            err = (fn() - want).abs().max().item()
            if err > 0.05:
                raise RuntimeError("K5 {} is {:.3e} from its four passes at "
                                   "{}".format(name, err, tuple(s.shape)))
        return in_turns(fns)

    out = {"served": paths(*_gf_inputs(gen, B, H, W), BANDS),
           "c3": paths(*_gf_inputs(gen, B, H, W, 3), BANDS), "frames": {}}
    for n, h, w in FRAMES:
        out["frames"][(n, h, w)] = paths(*_gf_inputs(gen, n, h, w))
    out["box"] = {}
    for (b, h, w), radius in BOX_SHAPES:
        x = levels(gen, b, h, w)
        fns = {"two-pass": lambda: box_filter_planar(x, radius,
                                                     path="two-pass")}
        if w <= FUSED_WIDEST:
            fns["fused"] = lambda: box_filter_planar(x, radius, path="fused")
            for band in BANDS if b * h >= B * H else ():
                fns["fused band {}".format(band)] = (
                    lambda band=band: box_filter_planar(
                        x, radius, path="fused", band=band))
        want = fns["two-pass"]()
        for name, fn in fns.items():
            err = (fn() - want).abs().max().item()
            if err > 1e-3:
                raise RuntimeError("K4 {} is {:.3e} from its two passes at "
                                   "{}".format(name, err, (b, h, w)))
        out["box"][(b, h, w, radius)] = in_turns(fns)
    return out


def profile(device, seed: int = 0) -> Dict[str, Dict[str, float]]:
    """What :func:`kernel_ms` splits: K4 on [32, 256, 256] at r = 45, and
    K5 on the served batch by each path."""
    from ..ops.box_kernel import box_filter_planar
    from ..ops.guided_kernel import guided_filter_fused
    gen = torch.Generator(device=device).manual_seed(seed)
    planes = levels(gen, B, H, W)
    g, s = _gf_inputs(gen, B, H, W)
    return {
        "K4 fused, [32, 256, 256] r=45": kernel_ms(
            lambda: box_filter_planar(planes, RADIUS, path="fused")),
        "K4 two passes, [32, 256, 256] r=45": kernel_ms(
            lambda: box_filter_planar(planes, RADIUS, path="two-pass")),
        "K5 fused pair, 32x256x256 C=1": kernel_ms(
            lambda: guided_filter_fused(g, s, RADIUS, EPS, path="fused")),
        "K5 four passes, 32x256x256 C=1": kernel_ms(
            lambda: guided_filter_fused(g, s, RADIUS, EPS,
                                        path="four-pass"))}


def print_split(split: Dict[str, dict]) -> None:
    for what, kernels in split.items():
        total = sum(kernels.values())
        print("{}: {:.4f} ms device time per call".format(what, total))
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print("  {:9.4f} ms  {}".format(ms, name[:100]))


def print_tables(result: Dict[str, dict]) -> None:
    def row(times):
        return "; ".join("{} {:.4f}".format(k, v) for k, v in times.items())
    print("K5 32x{}x{} C=1 r={} ms, in turns: {}".format(H, W, RADIUS, row(
        result["served"])))
    print("K5 32x{}x{} C=3 r={} ms, in turns: {}".format(H, W, RADIUS, row(
        result["c3"])))
    for (n, h, w), times in result["frames"].items():
        print("K5 {}x{}x{} C=1 ms: {}".format(n, h, w, row(times)))
    for (b, h, w, radius), times in result["box"].items():
        print("K4 [{}, {}, {}] r={} ms, in turns: {}".format(b, h, w, radius,
                                                          row(times)))


def compare(device, seed: int = 0) -> Dict[str, float]:
    """ms of each timed call, through wrappers the previous PR's tree has
    as well (inputs made on the card from ``seed``)."""
    from ..ops.bilateral_joint_kernel import (
        bilateral_color_self_batched, bilateral_packed_joint_batched,
        joint_bilateral_planar_batched)
    from ..ops.bilateral_kernel import bilateral_gray_self
    from ..ops.box_kernel import box_filter_planar
    from ..ops.guided import guided_filter_iterated
    from ..ops.guided_kernel import guided_filter_fused
    gen = torch.Generator(device=device).manual_seed(seed)
    gray = levels(gen, B, H, W)
    photo, refl = levels(gen, 8, 3, H, W), levels(gen, 8, 1, H, W)
    floats = torch.rand((8, 3, H, W), device=device, generator=gen) * 255
    src = torch.rand((8, 1, H, W), device=device, generator=gen) * 255
    g, s = _gf_inputs(gen, B, H, W)
    times = {
        "K2 uint8 32x256x256 r=33": time_ms(
            lambda: bilateral_gray_self(gray.to(torch.uint8)), 10),
        "K2 float32 32x256x256 r=33": time_ms(
            lambda: bilateral_gray_self(gray), 5),
        "K6 color-self 8x256x256 r=33": time_ms(
            lambda: bilateral_color_self_batched(photo), 10),
        "K6 u8 joint cj=3 cs=1 8x256x256 r=33": time_ms(
            lambda: bilateral_packed_joint_batched(photo, refl), 10),
        "K6 float cj=3 cs=1 8x256x256 r=33": time_ms(
            lambda: joint_bilateral_planar_batched(floats, src), 10),
        "K4 [32, 256, 256] r=45": time_ms(
            lambda: box_filter_planar(gray, RADIUS)),
        "K5 32x256x256 C=1 r=45": time_ms(
            lambda: guided_filter_fused(g, s, RADIUS, EPS))}
    for name, (h, w) in (("4K", (2160, 3840)), ("8K", (4320, 7680))):
        cg, cs = _gf_inputs(gen, 1, h, w)
        times["3x chain {} r=45".format(name)] = time_ms(
            lambda: guided_filter_iterated(cg, cs, RADIUS, EPS, 3,
                                           planar=True), 10 if h < 4000
            else 4)
        del cg, cs
    # the served batches end to end and K1 where the host binds it (one
    # 256-pixel row): what the wrappers' dispatch costs a call
    from ..models.networks import (ReflectanceNet, params_from_numpy,
                                   seeded_reference_params)
    from ..ops.cnn_kernel import pack_weights, reflectance_cnn
    from ..utils.serving import pipeline_fn
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(seeded_reference_params(seed)))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    photos = levels(gen, B, 3, H, W).to(torch.uint8)
    for kind in ("bf", "gf"):
        serve = pipeline_fn(kind, net, device)
        times["{} served 32x256x256".format(kind)] = time_ms(
            lambda: serve(photos), 10)
    w = pack_weights(net).to(device)
    row = torch.rand((1, 3, 256), device=device, generator=gen)
    times["K1 1x3x256 (host-bound)"] = time_ms(
        lambda: reflectance_cnn(row, w, srgb_input=True), 200)
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compare", metavar="LABEL")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_box_guided: needs a CUDA device (it times kernels; "
                 "there is no CPU version)")
    dev = torch.device("cuda", 0)
    if args.compare:
        print(json.dumps({"tree": args.compare,
                          "device": torch.cuda.get_device_name(0),
                          "ms": compare(dev, args.seed)}))
        return 0
    print(torch.cuda.get_device_name(0))
    print_tables(measure(dev, args.seed))
    print_split(profile(dev, args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
