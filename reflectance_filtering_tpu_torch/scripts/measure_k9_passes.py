"""K9's passes timed apart on the card, the column passes and the fused
pairs at each segment length tried.

    python -m reflectance_filtering_tpu_torch.scripts.measure_k9_passes \\
        [--seed N]

The 3x iterated guided chain (``ops/guided_chain_kernel.py``, r = 45,
eps = 3, C = 1) is three column-then-row pairs (``csrc/guided_chain.cu``,
chain_pass): the statistics once, then per application the solve and the
apply.  Each pair runs as one fused kernel (passes 6, 7, 8: the product's
route at these shapes) or as two passes through scratch column sums
(passes 0-5: the statistics' column and row passes, the moment columns,
the solve's rows, the column sums of (a, b) and the apply's rows).
``rf_guided_chain_pass`` launches one of them alone; this script times
each on a 2160x3840 and a 4320x7680 frame made on the card from
``--seed`` (uint8-valued floats): the six passes' column passes at the
product's segments (0: ``csrc/box_common.cuh``, col_launch) and at 64,
128, 256 and 512 rows, the fused pairs at their plan's segments (0:
fused_plan) and at 256, 512 and 1024 rows, each by CUDA events around
ITERS launches after WARMUP, the segments in turns (then reversed) and
averaged.  A chain's time at a segment length is the sum of its passes:
the statistics and three applications.  Before timing, the fused pairs at
their plan's segments are held bitwise equal to the product's two entry
points, and the six passes and the fused pairs at every other segment
length within 1e-3 of them (the float64 sums start at other rows and
columns).

Needs a CUDA device: without one it exits nonzero and builds nothing.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from ..ops import _build
from ..ops import guided_chain_kernel as k9

FRAMES = {"4K": (2160, 3840), "8K": (4320, 7680)}
SEGS = (0, 64, 128, 256, 512)   # 0: the product's (col_launch)
FUSED_SEGS = (0, 256, 512, 1024)  # 0: the product's (fused_plan)
RADIUS, EPS, ITERATIONS = 45, 3.0, 3
ITERS, WARMUP = 10, 2
PASSES = ("stats cols", "stats rows", "moment cols", "solve rows", "ab cols",
          "apply rows", "stats fused", "solve fused", "apply fused")
COL_PASSES = (0, 2, 4)
ROW_PASSES = (1, 3, 5)
FUSED_PASSES = (6, 7, 8)


def make_buffers(device, seed: int, h: int, w: int) -> Dict[str, torch.Tensor]:
    """A seeded guide [1, 3, h, w] and src [1, 1, h, w] of uint8 values on
    ``device``, and every plane the passes read and write."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def planes(k):
        return torch.floor(torch.rand((1, k, h, w), device=device,
                                      generator=gen) * 256)
    return {"guide": planes(3), "src": planes(1),
            "stats": torch.empty((1, k9.STAT_PLANES, h, w), device=device),
            "out": torch.empty((1, 1, h, w), device=device),
            "mom": torch.empty((1, k9.STAT_PLANES, h, w), device=device),
            "ab": torch.empty((1, 4, h, w), device=device)}


def run_pass(p: int, seg: int, buf: Dict[str, torch.Tensor],
             radius: int = RADIUS) -> None:
    """Launch pass ``p`` of the chain alone on ``buf``."""
    _, _, h, w = buf["src"].shape
    _build.launch("rf_guided_chain_pass", buf["src"].device, p, seg,
                  buf["stats"].data_ptr(), buf["guide"].data_ptr(),
                  buf["src"].data_ptr(), buf["out"].data_ptr(),
                  buf["mom"].data_ptr(), buf["ab"].data_ptr(), 1, 1, h, w,
                  radius, EPS)


def run_route(passes, seg: int, buf: Dict[str, torch.Tensor],
              radius: int = RADIUS) -> float:
    """Passes ``passes`` in order at segment ``seg`` on ``buf``; returns
    how far the output lies from the product's entry points."""
    stats = k9.guide_stats(buf["guide"], radius, EPS)
    want = k9.guided_apply_cached(stats, buf["guide"], buf["src"], radius)
    for p in passes:
        run_pass(p, seg, buf, radius)
    buf["want_stats"], buf["want_out"] = stats, want
    return (buf["out"] - want).abs().max().item()


def _check(buf: Dict[str, torch.Tensor]) -> None:
    """Both routes' passes in order against the product's entry points."""
    for passes, segs in ((range(6), SEGS), (FUSED_PASSES, FUSED_SEGS)):
        for seg in segs:
            err = run_route(passes, seg, buf)
            if seg == 0 and passes == FUSED_PASSES and not (
                    torch.equal(buf["stats"], buf["want_stats"])
                    and torch.equal(buf["out"], buf["want_out"])):
                raise RuntimeError("the fused pairs differ from the "
                                   "product's entry points")
            if err > 1e-3:
                raise RuntimeError("passes {} at segment {} are {:.3e} from "
                                   "the product".format(tuple(passes), seg,
                                                        err))


def _ms(p: int, seg: int, buf: Dict[str, torch.Tensor]) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        run_pass(p, seg, buf)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def measure(device, seed: int = 0, frames=FRAMES) -> Dict[str, dict]:
    """frame -> {"rows": {pass: ms}, "cols": {seg: {pass: ms}}, "chain":
    {seg: ms}, "fused": {seg: {pass: ms}}, "fused_chain": {seg: ms},
    "plans": {pass: the fused plan}} on ``device``."""
    out = {}
    for name, (h, w) in frames.items():
        buf = make_buffers(device, seed, h, w)
        _check(buf)
        for p in range(len(PASSES)):       # every pass's inputs are written
            for _ in range(WARMUP):
                run_pass(p, 0, buf)
        rows = {}
        for p in ROW_PASSES + tuple(reversed(ROW_PASSES)):
            for _ in range(WARMUP):
                run_pass(p, 0, buf)
            rows[PASSES[p]] = rows.get(PASSES[p], 0.0) + _ms(p, 0, buf) / 2
        cols = {seg: {} for seg in SEGS}
        for seg in SEGS + tuple(reversed(SEGS)):
            for p in COL_PASSES:
                for _ in range(WARMUP):
                    run_pass(p, seg, buf)
                ms = _ms(p, seg, buf) / 2
                cols[seg][PASSES[p]] = cols[seg].get(PASSES[p], 0.0) + ms
        fused = {seg: {} for seg in FUSED_SEGS}
        for seg in FUSED_SEGS + tuple(reversed(FUSED_SEGS)):
            for p in FUSED_PASSES:
                for _ in range(WARMUP):
                    run_pass(p, seg, buf)
                ms = _ms(p, seg, buf) / 2
                fused[seg][PASSES[p]] = fused[seg].get(PASSES[p], 0.0) + ms
        chain = {}
        for seg in SEGS:
            t = dict(rows, **cols[seg])
            chain[seg] = (t["stats cols"] + t["stats rows"] + ITERATIONS * (
                t["moment cols"] + t["solve rows"] + t["ab cols"]
                + t["apply rows"]))
        fused_chain = {seg: t["stats fused"] + ITERATIONS * (
            t["solve fused"] + t["apply fused"]) for seg, t in fused.items()}
        plans = {PASSES[p]: k9.fused_plan(device, p, 1, 1, h, w, RADIUS)
                 for p in FUSED_PASSES}
        out[name] = {"rows": rows, "cols": cols, "chain": chain,
                     "fused": fused, "fused_chain": fused_chain,
                     "plans": plans}
        del buf
    return out


def print_table(result: Dict[str, dict]) -> None:
    for name, r in result.items():
        h, w = FRAMES[name]
        rows = r["rows"]
        print("K9 passes, {} 1x{}x{}, r={}, C=1, ms per launch: {}".format(
            name, h, w, RADIUS, "; ".join("{} {:.4f}".format(p, ms)
                                          for p, ms in rows.items())))
        row_ms = rows["stats rows"] + ITERATIONS * (rows["solve rows"]
                                                    + rows["apply rows"])
        for seg in SEGS:
            cols = r["cols"][seg]
            col_ms = cols["stats cols"] + ITERATIONS * (cols["moment cols"]
                                                        + cols["ab cols"])
            print("  segment {}: {}; per 3x chain: row passes "
                  "{:.4f}, column passes {:.4f}, sum {:.4f} ms".format(
                      "{:3d} rows".format(seg) if seg else "col_seg's "
                      "(product)",
                      "; ".join("{} {:.4f}".format(p, ms)
                                for p, ms in cols.items()),
                      row_ms, col_ms, r["chain"][seg]))
        for seg, t in r["fused"].items():
            print("  fused pairs, segments of {}: {}; per 3x chain {:.4f} "
                  "ms".format("{:4d} rows".format(seg) if seg else
                              "fused_plan's (product)",
                              "; ".join("{} {:.4f}".format(p, ms)
                                        for p, ms in t.items()),
                              r["fused_chain"][seg]))
        for p, plan in r["plans"].items():
            print("  plan of {}: {}".format(p, ", ".join(
                "{} {}".format(k, v) for k, v in plan.items())))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_k9_passes: needs a CUDA device (it times kernels; "
                 "there is no CPU version)")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    print_table(measure(dev, args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
