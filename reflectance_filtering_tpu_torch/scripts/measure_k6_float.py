"""K6's float form on the card: the product's geometry beside its first
port and three other geometries.

    python -m reflectance_filtering_tpu_torch.scripts.measure_k6_float \\
        [--seed N]

K6's float form (``csrc/bilateral_joint_float.cuh``, the float joint
bilateral of ``joint_bilateral_planar_batched``) takes 4 adjacent pixels
of a row a thread, splits the disk's rows over 4 groups of warps (512
threads a block) and adds the spatial term in the exponent of its one
ex2 a tap.  ``k6_float_geometries.cu`` beside this script builds the same
template with 4 pixels a thread and no split (128 threads), 8 pixels and
4 groups (256), 2 pixels and 2 groups (512), the product's geometry with
the factored weight (a table of spatial weights times the range factor's
ex2), and the form's first port (one pixel a thread, an expf a tap).
Each runs at 8 x 256x256, sigma_c = 20, sigma_s = 22 (radius 33, 3,409
taps) on seeded float planes with fractional values: every variant on the
timed pairing (a 3-plane joint, one src plane), the product and the first
port on the other three pairings.  Their sums run in other orders, so each output is held within
1e-3 of the product's.  Each is timed by CUDA events around ITERS launches
after WARMUP launches, in turns (the order of the geometries, then
reversed), and averaged.

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
    _space_table, joint_bilateral_planar_batched, range_scale)

N, H, W = 8, 256, 256
SIGMA_C, SIGMA_S = 20.0, 22.0
ITERS, WARMUP = 10, 2
TOL = 1e-3                  # each geometry against the product, 0-255 units
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "k6_float_geometries.cu")
# the product, then the source's variants 0-4
GEOMETRIES = ("4 px x 4 groups, 512 threads (product)",
              "first port: 1 px, 512 threads, expf",
              "4 px, 128 threads", "8 px x 4 groups, 256 threads",
              "2 px x 2 groups, 512 threads",
              "4 px x 4 groups, factored weight")
FACTORED = 5                # reads the spatial weights, not their log2
TIMED = (3, 1)              # the pairing every geometry runs
PAIRINGS = ((1, 1), (1, 3), (3, 1), (3, 3))

_lib = None


def _library() -> ctypes.CDLL:
    """The script's library, built at first use beside the product's
    (nvcc with the product's flags), rf_k6_float_geometry's argtypes
    set."""
    global _lib
    if _lib is None:
        lib = _build.script_library(SOURCE, ("bilateral_joint_float.cuh",
                                             "bilateral_common.cuh"),
                                    "k6_float")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rf_k6_float_geometry.argtypes = [i, p, p, p, p, i, i, i, i, i,
                                             i, f, f, f, p]
        lib.rf_k6_float_geometry.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_path() -> str:
    """The script's library file (built if it is not yet), for its
    machine code."""
    return _library()._name


def run(geometry: int, joint: torch.Tensor, src: torch.Tensor
        ) -> torch.Tensor:
    """K6's float form on GEOMETRIES[geometry]: joint [N, cj, H, W] and src
    [N, cs, H, W] float32 on the card -> float32 [N, cs, H, W]."""
    if geometry == 0:
        return joint_bilateral_planar_batched(joint, src, -1, SIGMA_C,
                                              SIGMA_S)
    radius, gcc, gsc = opencv_bilateral_coeffs(-1, SIGMA_C, SIGMA_S)
    n, cj, h, w = joint.shape
    sw = _space_table(joint.device, radius, gsc, geometry != FACTORED)
    out = torch.empty_like(src)
    rc = _library().rf_k6_float_geometry(
        geometry - 1, joint.data_ptr(), src.data_ptr(), out.data_ptr(),
        sw.data_ptr(), n, cj, src.shape[1], h, w, radius,
        range_scale(gcc), gcc, gsc,
        torch.cuda.current_stream(joint.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rf_k6_float_geometry failed: CUDA error "
                           "{}".format(rc))
    return out


def make_inputs(device, seed: int = 0
                ) -> Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]:
    """(cj, cs) -> (joint, src): seeded float32 planes in [0, 255) with
    fractional values, made with numpy."""
    rng = np.random.RandomState(seed)

    def planes(c):
        return torch.from_numpy((rng.rand(N, c, H, W) * 255).astype(
            np.float32)).to(device)

    joint3, joint1 = planes(3), planes(1)
    src3, src1 = planes(3), planes(1)
    return {(cj, cs): (joint3 if cj == 3 else joint1,
                       src3 if cs == 3 else src1) for cj, cs in PAIRINGS}


def _ms(geometry: int, joint, src) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        run(geometry, joint, src)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def measure(cases) -> Dict[Tuple[int, int], Dict[str, float]]:
    """(cj, cs) -> {geometry: ms} for each (joint, src) on the card: every
    geometry on TIMED, the product and the first port elsewhere; raises
    unless each output is within TOL of the product's."""
    out = {}
    for pairing, (joint, src) in cases.items():
        geometries = (range(len(GEOMETRIES)) if pairing == TIMED
                      else (0, 1))
        want = run(0, joint, src)
        for geometry in geometries:
            err = (run(geometry, joint, src) - want).abs().max().item()
            if not err <= TOL:
                raise RuntimeError("{} is {:.3e} from the product at "
                                   "{}".format(GEOMETRIES[geometry], err,
                                               pairing))
            for _ in range(WARMUP):
                run(geometry, joint, src)
        turns = [(g, _ms(g, joint, src))
                 for g in list(geometries) + list(reversed(geometries))]
        out[pairing] = {GEOMETRIES[g]: sum(ms for g_, ms in turns
                                           if g_ == g) / 2
                        for g in geometries}
    return out


def print_table(result: Dict[Tuple[int, int], Dict[str, float]]) -> None:
    for (cj, cs), ms in result.items():
        print("K6 float form, cj={} cs={} {}x{}x{}: {}".format(
            cj, cs, N, H, W, "; ".join("{} {:.4f} ms".format(g, t)
                                       for g, t in ms.items())))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_k6_float: needs a CUDA device (it times kernels; "
                 "there is no CPU version)")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    print_table(measure(make_inputs(dev, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
