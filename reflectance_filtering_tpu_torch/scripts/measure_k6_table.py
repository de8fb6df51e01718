"""K6's uint8 range table in shared memory: three layouts on the card.

    python -m reflectance_filtering_tpu_torch.scripts.measure_k6_table \\
        [--seed N]

K6's uint8 form (``csrc/bilateral_joint_u8.cuh``) looks up a range weight
per tap, indexed by the sum over the joint planes of |delta| (766 entries
at three planes).  The product's table is held in 16 copies (49 KB at
three planes); ``k6_table_layouts.cu`` beside this script instantiates the
same kernel template with a copy per bank (98 KB) and with one table (3
KB).
All three run the two u8 wrappers' main cases at 8 x 256x256, sigma_c =
20, sigma_s = 22 (radius 33, 3,409 taps): the color self-guided filter on
seeded 1/f photos, and BF(reflectance, photo) with the photo as the joint
(or whatever planes a caller passes to :func:`measure`).  The layouts give
the same weights in the same order, so their outputs are held bitwise
equal.  Each is timed by CUDA events around ITERS launches after WARMUP
launches, in turns (the order of LAYOUTS, then reversed), and averaged.

Needs a CUDA device: without one it exits nonzero and builds nothing.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.bilateral import opencv_bilateral_coeffs
from ..ops.bilateral_joint_kernel import (
    _tables, bilateral_color_self_batched, bilateral_packed_joint_batched)
from ..utils.testimages import pink_noise

N, H, W = 8, 256, 256
SIGMA_C, SIGMA_S = 20.0, 22.0
ITERS, WARMUP = 10, 2
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "k6_table_layouts.cu")
# the product's layout, then the source's layouts 0 and 1
LAYOUTS = ("16 copies (product)", "a copy per bank", "one table")

_fn = None


def _layout_fn():
    """rf_k6_table_layout from its own library, built at first use beside
    the product's (nvcc with the product's flags)."""
    global _fn
    if _fn is None:
        fn = _build.script_library(SOURCE, ("bilateral_joint_u8.cuh",
                                            "bilateral_common.cuh"),
                                   "k6_table").rf_k6_table_layout
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def run(layout: int, joint: torch.Tensor, src) -> torch.Tensor:
    """K6's uint8 form on LAYOUTS[layout]: joint [N, cj, H, W] and src
    [N, cs, H, W] float32 levels on the card (src None: the color
    self-guided filter) -> float32 [N, cs, H, W]."""
    if layout == 0:
        if src is None:
            return bilateral_color_self_batched(joint, -1, SIGMA_C, SIGMA_S)
        return bilateral_packed_joint_batched(joint, src, -1, SIGMA_C,
                                              SIGMA_S)
    radius, gcc, gsc = opencv_bilateral_coeffs(-1, SIGMA_C, SIGMA_S)
    n, cj, h, w = joint.shape
    s = joint if src is None else src
    tables = _tables(joint.device, radius, 1, gcc, gsc, cj)
    out = torch.empty_like(s)
    rc = _layout_fn()(layout - 1, joint.data_ptr(), s.data_ptr(),
                      out.data_ptr(), tables.data_ptr(), n, cj, s.shape[1],
                      h, w, int(src is None), radius,
                      torch.cuda.current_stream(joint.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rf_k6_table_layout failed: CUDA error "
                           "{}".format(rc))
    return out


def make_inputs(device, seed: int = 0
                ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Seeded float32 levels made with numpy: name -> (joint, src or
    None): N photos of three 1/f planes by themselves, and one 1/f plane
    (the reflectance) guided by them."""
    rng = np.random.RandomState(seed)

    def planes(c):
        return torch.from_numpy(np.stack([
            [pink_noise(rng, H, W) for _ in range(c)]
            for _ in range(N)]).astype(np.float32)).to(device)

    photo = planes(3)
    return {"color-self": (photo, None),
            "BF(reflectance, photo)": (photo, planes(1))}


def _ms(layout: int, joint, src) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        run(layout, joint, src)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def measure(cases) -> Dict[str, Dict[str, float]]:
    """name -> {layout: ms} for each (joint, src or None) on the card;
    raises unless every layout's output is bitwise the product's."""
    out = {}
    layouts = range(len(LAYOUTS))
    for name, (joint, src) in cases.items():
        want = run(0, joint, src)
        for layout in layouts:
            if not torch.equal(run(layout, joint, src), want):
                raise RuntimeError("{} disagrees with the product on "
                                   "{}".format(LAYOUTS[layout], name))
            for _ in range(WARMUP):
                run(layout, joint, src)
        turns = [(layout, _ms(layout, joint, src))
                 for layout in list(layouts) + list(reversed(layouts))]
        out[name] = {LAYOUTS[layout]: sum(ms for l_, ms in turns
                                          if l_ == layout) / 2
                     for layout in layouts}
    return out


def print_table(result: Dict[str, Dict[str, float]]) -> None:
    for name, ms in result.items():
        print("K6 uint8 range table, {} {}x{}x{}: {}".format(
            name, N, H, W, "; ".join("{} {:.4f} ms".format(layout, t)
                                     for layout, t in ms.items())))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_k6_table: needs a CUDA device (it times kernels; "
                 "there is no CPU version)")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    print_table(measure(make_inputs(dev, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
