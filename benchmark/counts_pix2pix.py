"""The work counts of pix2pix's U-Net-256 generator (configuration
``pix2pix_unet256``), for the peak and roofline shares of its training
cell.

MACs come from the layer shapes alone: a down convolution's output pixels
times its 16 taps times its input and output channels; a transposed
convolution's input pixels times its 16 taps times its channels (each
input pixel meets every tap, the border's taps that padding crops
included, as a FLOP counter counts them).  A training step is the forward
and a backward of twice it, at the TF32 peak, as ``counts_unet.py`` counts
the uNet's.  Batch norm is counted by its bytes: a step reads each
normalised element and writes its output in the forward, and reads it and
its output's gradient and writes its gradient in the backward, 5 float32
accesses, 20 B (PERF.md section 4).
"""
from __future__ import annotations

from typing import List, Tuple

from .counts import HBM_BYTES_S, TF32_FLOP_S, bound_s

KERNEL = 4
NORM_BYTES_PER_ELEMENT = 20.0


def _widths(num_downs: int, ngf: int) -> List[int]:
    return [ngf * min(2 ** i, 8) for i in range(num_downs)]


def layer_macs(height: int, width: int, num_downs: int = 8, ngf: int = 64,
               head: int = 1) -> List[Tuple[str, int]]:
    """(layer, MACs an image) of every convolution and transposed
    convolution, in the forward's order; frames divisible by
    2**num_downs."""
    w, taps, out = _widths(num_downs, ngf), KERNEL * KERNEL, []
    for i in range(1, num_downs + 1):
        ci = 3 if i == 1 else w[i - 2]
        pixels = (height >> i) * (width >> i)
        out.append(("down{}".format(i), pixels * taps * ci * w[i - 1]))
    for i in range(num_downs, 0, -1):
        ci = w[i - 1] * (1 if i == num_downs else 2)
        co = head if i == 1 else w[i - 2]
        pixels = (height >> i) * (width >> i)
        out.append(("up{}".format(i), pixels * taps * ci * co))
    return out


def forward_macs(height: int, width: int, num_downs: int = 8,
                 ngf: int = 64) -> int:
    """MACs of an image's forward: 5,981,077,504 at 256x256, num_downs 8,
    ngf 64 (91,264 a pixel)."""
    return sum(m for _, m in layer_macs(height, width, num_downs, ngf))


def train_step_flops(batch: int, height: int, width: int,
                     num_downs: int = 8, ngf: int = 64) -> float:
    """A training step's model FLOPs: the forward and a backward of twice
    the forward, 3 x 2 a MAC (717.73 GFLOP a step of 20 x 256x256)."""
    return 3.0 * 2.0 * batch * forward_macs(height, width, num_downs, ngf)


def conv_bound_s(batch: int, height: int, width: int, num_downs: int = 8,
                 ngf: int = 64) -> float:
    """The step's convolutions, forward, data and weight gradients: their
    FLOPs at the TF32 dense peak (1.451 ms at 20 x 256x256)."""
    return bound_s(train_step_flops(batch, height, width, num_downs, ngf),
                   TF32_FLOP_S)


def norm_elements(height: int, width: int, num_downs: int = 8,
                  ngf: int = 64) -> int:
    """Elements an image that batch norm normalises: the outputs of down2
    to down(n-1) and of up2 to upn (2,969,600 at 256x256)."""
    w = _widths(num_downs, ngf)
    down = sum((height >> i) * (width >> i) * w[i - 1]
               for i in range(2, num_downs))
    up = sum((height >> (i - 1)) * (width >> (i - 1)) * w[i - 2]
             for i in range(2, num_downs + 1))
    return down + up


def norm_bound_s(batch: int, height: int, width: int, num_downs: int = 8,
                 ngf: int = 64) -> float:
    """The step's batch norms, forward and backward: their bytes at the
    HBM's rate (0.355 ms at 20 x 256x256)."""
    return NORM_BYTES_PER_ELEMENT * batch * norm_elements(
        height, width, num_downs, ngf) / HBM_BYTES_S
