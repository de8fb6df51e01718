"""K2's range table in shared memory: three layouts on the card.

    python -m reflectance_filtering_tpu_torch.scripts.measure_k2_table \\
        [--seed N]

K2's uint8 form (``csrc/bilateral_gray_self.cu``) looks up a range weight
per tap.  The product's table is replicated per bank, one entry per signed
difference (511 x 32 floats, 64 KB); ``k2_table_layouts.cu`` beside this
script instantiates the same kernel template with one signed table stored
once (511 floats, 2 KB, which conflicts when a warp's differences spread)
and with a table of |d| replicated per bank (256 x 32 floats, 32 KB).  All
three run on uint8 planes of 32 x 256x256 at sigma_c = 20, sigma_s = 22
(radius 33, 3,409 taps), reps = 3: seeded 1/f levels (a natural image's
spectrum) and uniform random levels (the widest spread), or whatever planes
a caller passes to :func:`measure`.  The layouts give the same weights in
the same order, so their outputs are held bitwise equal.  Each is timed by
CUDA events around ITERS launches after WARMUP launches, in turns (the
order of LAYOUTS, then reversed), and averaged.

Needs a CUDA device: without one it exits nonzero and builds nothing.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys
from typing import Dict

import numpy as np
import torch

from ..ops import _build
from ..ops.bilateral import opencv_bilateral_coeffs
from ..ops.bilateral_kernel import _tables, bilateral_gray_self
from ..utils.testimages import pink_noise

B, H, W = 32, 256, 256
SIGMA_C, SIGMA_S, REPS = 20.0, 22.0, 3
ITERS, WARMUP = 10, 2
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "k2_table_layouts.cu")
# the product's layout, then the source's layouts 0 and 1
LAYOUTS = ("replicated signed (product)", "one signed table",
           "replicated |d|")

_fn = None


def _layout_fn():
    """rf_k2_table_layout from its own library, built at first use beside
    the product's (nvcc with the product's flags)."""
    global _fn
    if _fn is None:
        fn = _build.script_library(SOURCE, ("bilateral_gray_self.cuh",
                                            "bilateral_common.cuh"),
                                   "k2_table").rf_k2_table_layout
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def run(layout: int, x: torch.Tensor) -> torch.Tensor:
    """K2's uint8 form on LAYOUTS[layout]: x uint8 [N, H, W] on the card
    -> float32 [N, H, W]."""
    if layout == 0:
        return bilateral_gray_self(x, -1, SIGMA_C, SIGMA_S, reps=REPS)
    radius, gcc, gsc = opencv_bilateral_coeffs(-1, SIGMA_C, SIGMA_S)
    tables = _tables(x.device, radius, REPS, gcc, gsc)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rc = _layout_fn()(layout - 1, x.data_ptr(), out.data_ptr(),
                      tables.data_ptr(), *x.shape, radius,
                      gcc * REPS * REPS, gsc,
                      torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rf_k2_table_layout failed: CUDA error "
                           "{}".format(rc))
    return out


def make_inputs(device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded uint8 planes [B, H, W], made with numpy: 1/f levels and
    uniform random levels."""
    rng = np.random.RandomState(seed)
    pink = np.stack([pink_noise(rng, H, W) for _ in range(B)])
    uniform = rng.randint(0, 256, size=(B, H, W))
    return {name: torch.from_numpy(a.astype(np.uint8)).to(device)
            for name, a in (("1/f levels", pink), ("uniform levels",
                                                    uniform))}


def _ms(layout: int, x: torch.Tensor) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        run(layout, x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def measure(planes: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, float]]:
    """name -> {layout: ms} for each uint8 [N, H, W] input on the card;
    raises unless every layout's output is bitwise the product's."""
    out = {}
    layouts = range(len(LAYOUTS))
    for name, x in planes.items():
        want = run(0, x)
        for layout in layouts:
            if not torch.equal(run(layout, x), want):
                raise RuntimeError("{} disagrees with the product on "
                                   "{}".format(LAYOUTS[layout], name))
            for _ in range(WARMUP):
                run(layout, x)
        turns = [(layout, _ms(layout, x))
                 for layout in list(layouts) + list(reversed(layouts))]
        out[name] = {LAYOUTS[layout]: sum(ms for l_, ms in turns
                                          if l_ == layout) / 2
                     for layout in layouts}
    return out


def print_table(result: Dict[str, Dict[str, float]]) -> None:
    for name, ms in result.items():
        print("K2 uint8 range table, {} {}x{}x{}: {}".format(
            name, B, H, W, "; ".join("{} {:.4f} ms".format(layout, t)
                                     for layout, t in ms.items())))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_k2_table: needs a CUDA device (it times kernels; "
                 "there is no CPU version)")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    print_table(measure(make_inputs(dev, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
