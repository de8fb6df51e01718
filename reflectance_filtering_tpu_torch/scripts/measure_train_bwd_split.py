"""K7's backward split by phase on the card (the port's counterpart of
scripts/measure_train_bwd_split.py, TPU kernel 19).

    python -m reflectance_filtering_tpu_torch.scripts.measure_train_bwd_split \\
        [--seed N]

Times the timing variants of the training backward
(``ops/cnn_train_kernel.py::trunk_backward_variant``, the template
instantiations of ``csrc/cnn_train.cu``), each with one more phase removed,
at the product's block count and shared-memory layout, on the flagship
trunk (n=5, ci=3, f=32, cout=1) at 20 x 256x256 (P = 1,310,720) with
weights and inputs made from ``--seed`` with numpy:

  full              rematerialisation, fuse head, chain, dW, block sum
  -dw               drop dW_l (db_l and the chain stay)
  -dw-chain         also drop the chain's W_{l+1} dz_{l+1} term
  -dw-chain-head    also drop the fuse head's dW (db_fuse stays)
  empty(DMA floor)  load each tile, touch its first x and g, block sum
  block sum         the fixed-order sum of the blocks' rows alone

Each is timed by CUDA events around single launches, the median of ITERS
launches after WARMUP rounds, the variants taken in turns; the product
backward (``trunk_backward``) is timed in the same turns.  A row's stage is
the difference to the row above: the phase it removed, beside that phase's
bound: its matrix products' MACs as 3xTF32 on the tensor cores (3 TF32
products per float32 MAC at 494.7 TFLOP/s), the fuse's 160-wide products
with one output on the FP32 pipe (66.9 TFLOP/s, FMA = 2), the larger of
the two; beside it, the bound with every FMA on the FP32 pipe, the figure
earlier measurements were read against.  The registers and spills of
each instantiation come from the build's ptxas report.

Needs a CUDA device: without one it exits nonzero and builds nothing.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import sys
from typing import Dict

import numpy as np
import torch

from ..ops import _build
from ..ops import cnn_train_kernel as k7

B, H, W = 20, 256, 256
PIXELS = B * H * W
SHAPE = (5, 3, 32, 1)                      # (n, ci, f, cout): the flagship
ITERS, WARMUP = 20, 3
# the card's peak rates for the bounds (H100 SXM)
F32_FLOP_S = 132 * 128 * 2 * 1.98e9        # 66.9 TFLOP/s, FMA = 2
TF32_FLOP_S = 494.7e12                     # dense tensor cores, MAC = 2
TF32X3_MAC_S = TF32_FLOP_S / (2 * 3)       # float32 MACs as 3 TF32 products
F64_ADD_S = 132 * 64 * 1.98e9              # 16.7 T float64 adds/s
HBM_BYTES_S = 3.35e12
# the variants in the JAX script's order and names (its floor is
# "empty(DMA floor)"), then the port's own row, the block sum
ROWS = k7.BWD_VARIANTS[:4] + ("empty(DMA floor)",) + k7.BWD_VARIANTS[5:]
# the phase whose removal each row after the first measures
STAGES = (None, "dW", "chain", "head", "rematerialisation", None)


def phase_fmas() -> Dict[str, int]:
    """Float32 FMAs per pixel that each row's delta removes; their sum is
    the whole backward's count (without dx).  The rematerialisation bundle
    is the conv layers' activations and the W_f g term of every dz_l (no
    variant but the floor drops it); the backward does not recompute the
    fuse's output.  The head is dW_fuse alone."""
    n, ci, f, cout = SHAPE
    return {"rematerialisation": ci * f + (n - 1) * f * f + n * f * cout,
            "chain": (n - 1) * f * f,
            "dW": (n - 1) * f * f + ci * f,
            "head": n * f * cout}


def phase_fuse_fmas() -> Dict[str, int]:
    """The part of each phase's FMAs per pixel that is a product with the
    fuse's cout-wide side (W_f g in the rematerialisation, dW_fuse in the
    head): matrix-vector work, counted on the FP32 pipe."""
    n, _, f, cout = SHAPE
    return {"rematerialisation": n * f * cout, "chain": 0, "dW": 0,
            "head": n * f * cout}


def matmul_ms(macs: float, fuse_fmas: float = 0.0, pixels: int = PIXELS,
              tensor_cores: bool = True) -> float:
    """The least ms for ``macs`` float32 MACs of matrix products and
    ``fuse_fmas`` FMAs of fuse products per pixel, at ``pixels`` pixels:
    the matrix products as 3xTF32 on the tensor cores beside the fuse on
    the FP32 pipe (the two run at once, so the larger); with
    ``tensor_cores=False`` all of it on the FP32 pipe."""
    if not tensor_cores:
        return 2.0 * (macs + fuse_fmas) * pixels / F32_FLOP_S * 1e3
    return max(macs * pixels / TF32X3_MAC_S,
               2.0 * fuse_fmas * pixels / F32_FLOP_S) * 1e3


def phase_bounds_ms(tensor_cores: bool = True) -> Dict[str, float]:
    """Each phase's least time on the card at PIXELS, and the total (the
    two pipes' sums, the larger), in ms; ``tensor_cores=False`` gives the
    FP32-pipe figure."""
    fuse = phase_fuse_fmas()
    out = {name: matmul_ms(fmas - fuse[name], fuse[name],
                           tensor_cores=tensor_cores)
           for name, fmas in phase_fmas().items()}
    out["total"] = matmul_ms(sum(phase_fmas().values()) - sum(fuse.values()),
                             sum(fuse.values()), tensor_cores=tensor_cores)
    return out


def block_sum_bound_ms(blocks: int) -> float:
    """The block sum moves blocks rows of the parameters in, one out."""
    return (blocks + 1) * 4.0 * k7.num_params(SHAPE) / HBM_BYTES_S * 1e3


def make_inputs(device, seed: int = 0):
    """(x [PIXELS, ci], g [PIXELS, cout], flat parameters) on ``device``:
    the JAX script's recipe (kernels N(0, 0.1), biases N(0, 0.01), x and g
    uniform), made with numpy."""
    n, ci, f, cout = SHAPE
    rng = np.random.RandomState(seed)
    weights, biases = [], []
    for fin in [ci] + [f] * (n - 1):
        weights.append(rng.randn(fin, f) * .1)
        biases.append(rng.randn(f) * .01)
    weights.append(rng.randn(n * f, cout) * .1)
    biases.append(rng.randn(cout) * .01)
    flat = k7.pack([torch.tensor(w, dtype=torch.float32) for w in weights],
                   [torch.tensor(b, dtype=torch.float32) for b in biases])
    x = torch.from_numpy(rng.rand(PIXELS, ci).astype(np.float32))
    g = torch.from_numpy(rng.rand(PIXELS, cout).astype(np.float32))
    return x.to(device), g.to(device), flat.to(device)


def register_report() -> Dict[int, str]:
    """mask -> 'N registers, S bytes spill stores, L bytes spill loads' of
    each instantiation of the backward, from the build's ptxas report."""
    out, mask, spill = {}, None, ""
    with open(os.path.join(_build.build_dir(), "build.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                km = re.search(r"trunk_bwd_kernelILi(\d+)E", m.group(1))
                mask = int(km.group(1)) if km else None
                continue
            if mask is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = "{} bytes spill stores, {} bytes spill loads".format(
                    *m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[mask] = "{} registers, {}".format(m.group(1), spill)
                mask = None
    return out


def _median_ms(pairs) -> float:
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def measure(x, g, flat) -> Dict[str, object]:
    """Time every variant and the product backward on x's CUDA device, in
    turns: {"ms": {row: median ms}, "product_ms", "blocks"}."""
    work = k7.backward_workspace(x, SHAPE)
    runs = [(row, lambda v=v: k7.trunk_backward_variant(x, g, flat, SHAPE, v,
                                                        work))
            for v, row in enumerate(ROWS)]
    runs.append(("product", lambda: k7.trunk_backward(x, g, flat, SHAPE,
                                                      False)))
    for _ in range(WARMUP):
        for _, fn in runs:
            fn()
    events = {row: [] for row, _ in runs}
    for _ in range(ITERS):
        for row, fn in runs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events[row].append((start, end))
    torch.cuda.synchronize()
    ms = {row: _median_ms(pairs) for row, pairs in events.items()}
    return {"ms": {row: ms[row] for row in ROWS}, "product_ms": ms["product"],
            "blocks": work.shape[0]}


def print_table(result, registers=None) -> Dict[str, float]:
    """Print the split; returns {phase: delta ms}."""
    ms = result["ms"]
    bounds = phase_bounds_ms()
    print("K7 backward split, (n, ci, f, cout) = {}, P = {}, {} blocks; "
          "median ms of single launches (CUDA events)".format(
              SHAPE, PIXELS, result["blocks"]))
    f32 = phase_bounds_ms(tensor_cores=False)
    print("{:<18} {:>9}  {:<18} {:>9} {:>9} {:>9} {:>9}".format(
        "variant", "ms", "stage", "delta ms", "bound ms", "of rate",
        "FP32 ms"))
    deltas = {}
    for i, row in enumerate(ROWS[:5]):
        stage = STAGES[i]
        if stage is None:
            print("{:<18} {:9.4f}".format(row, ms[row]))
            continue
        delta = ms[ROWS[i - 1]] - ms[row]
        deltas[stage] = delta
        print("{:<18} {:9.4f}  {:<18} {:9.4f} {:9.4f} {:8.1%} {:9.4f}".format(
            row, ms[row], stage, delta, bounds[stage],
            bounds[stage] / delta if delta > 0 else float("nan"), f32[stage]))
    sum_bound = block_sum_bound_ms(result["blocks"])
    print("{:<18} {:9.4f}  {:<18} {:>9} {:9.4f} {:8.1%}".format(
        "block sum", ms["block sum"], "(alone)", "", sum_bound,
        sum_bound / ms["block sum"]))
    print("floor without the block sum: {:.4f} ms".format(
        ms["empty(DMA floor)"] - ms["block sum"]))
    print("product backward (rf_cnn_train_bwd): {:.4f} ms, full variant "
          "{:.4f} ms, bound {:.4f} ms ({:.1%} of its rate; on the FP32 pipe "
          "{:.4f} ms, {:.1%})".format(
              result["product_ms"], ms["full"], bounds["total"],
              bounds["total"] / result["product_ms"], f32["total"],
              f32["total"] / result["product_ms"]))
    rates = {stage: bounds[stage] / d for stage, d in deltas.items() if d > 0}
    for stage in sorted(rates, key=rates.get):
        print("  {:<18} {:.4f} ms against its bound {:.4f} ms: {:.1%} of "
              "the bound's rate".format(stage, deltas[stage], bounds[stage],
                                        rates[stage]))
    if registers:
        for mask, row in zip(k7.BWD_MASKS, ROWS):
            print("  ptxas {:<18} (mask {:2d}): {}".format(
                row, mask, registers.get(mask, "not in the report")))
    return deltas


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_train_bwd_split: needs a CUDA device (the split "
                 "times kernels; there is no CPU version)")
    dev = torch.device("cuda", 0)
    x, g, flat = make_inputs(dev, args.seed)
    _build.lib()
    print(torch.cuda.get_device_name(0))
    print_table(measure(x, g, flat), registers=register_report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
