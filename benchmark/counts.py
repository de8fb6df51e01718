"""The card's peaks and the work counts that the roofline and peak shares
divide by.

Every count is the work the function needs, worked out from its shapes,
never from how a kernel computes it: each input read once and each output
written once at the narrowest type the pipeline holds it in, matrix work
counted once at TF32's dense peak (the highest rate any scheme accurate to
float32 could reach on this card).  So a share cannot pass 100% whatever a
later kernel does.  The formulas are written out in PERF.md.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5, dense, at its 700 W limit (NVIDIA's data sheet)
TF32_FLOP_S = 494.7e12        # tensor cores, TF32 (a MAC is 2 FLOPs)
F32_FLOP_S = 66.9e12          # CUDA cores, float32 (an FMA is 2 FLOPs)
HBM_BYTES_S = 3.35e12         # HBM3

# the flagship network (models/networks.py REFERENCE_CONFIG): five 1x1
# convs of width 32 from 3 channels, skip-concat of the five, 160 -> 1 fuse
FLAGSHIP_IN, FLAGSHIP_WIDTH, FLAGSHIP_LAYERS = 3, 32, 5


def flagship_macs_per_pixel() -> int:
    """Multiply-adds a pixel of the flagship's forward: 3x32 + 4x32x32 +
    160x1 = 4,352."""
    w = FLAGSHIP_WIDTH
    return (FLAGSHIP_IN * w + (FLAGSHIP_LAYERS - 1) * w * w
            + FLAGSHIP_LAYERS * w)


def forward_flops(pixels: int) -> float:
    """The flagship forward's model FLOPs over ``pixels`` (2 a MAC)."""
    return 2.0 * flagship_macs_per_pixel() * pixels


def train_step_flops(pixels: int) -> float:
    """A training step's model FLOPs: the forward and a backward of twice
    the forward, 3 x 8,704 a pixel."""
    return 3.0 * forward_flops(pixels)


def bound_s(flops: float = 0.0, rate: float = TF32_FLOP_S,
            nbytes: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the
    operations at ``rate`` and the bytes at the HBM's rate."""
    return max(flops / rate, nbytes / HBM_BYTES_S)


def disk_taps(radius: int) -> int:
    """Taps of OpenCV's bilateral disk: offsets with dx^2 + dy^2 <= r^2."""
    return sum(2 * math.isqrt(radius * radius - dy * dy) + 1
               for dy in range(-radius, radius + 1))


def bilateral_radius(sigma_space: float) -> int:
    """OpenCV's radius for d <= 0: round(1.5 sigma_space)."""
    return max(int(round(sigma_space * 1.5)), 1)


def k1_bound_s(pixels: int) -> float:
    """K1, the flagship forward: its MACs at the TF32 peak; bytes: the
    photo as uint8 (3 B) in, the reflectance as its byte level (1 B) out."""
    return bound_s(forward_flops(pixels), TF32_FLOP_S, 4.0 * pixels)


def k2_bound_s(pixels: int, sigma_space: float) -> float:
    """K2, the self-guided gray bilateral: 2 FMAs a tap (the weighted sum
    and the weight sum) over the disk at the float32 peak; bytes: one byte
    level in and one out a pixel."""
    taps = disk_taps(bilateral_radius(sigma_space))
    return bound_s(2.0 * 2.0 * taps * pixels, F32_FLOP_S, 2.0 * pixels)


# a pixel of the color-guided filter of one source channel: 9 products
# (6 of the guide's pairs, 3 guide x source), 17 box sums (13 moment
# planes, then a0 a1 a2 b) at 4 adds each (an add and a subtract a
# dimension of a running sum), the 3x3 solve of the coefficients (30), and
# the output a.I + b (3 FMAs, 6 FLOPs)
GUIDED_FLOPS_PER_PIXEL = 9 + 17 * 4 + 30 + 6


def k5_bound_s(pixels: int) -> float:
    """K5, the guided filter with a color guide and one source channel:
    GUIDED_FLOPS_PER_PIXEL at the float32 peak; bytes: the photo as uint8
    (3 B), the source and the output as byte levels (1 B each)."""
    return bound_s(GUIDED_FLOPS_PER_PIXEL * pixels, F32_FLOP_S,
                   5.0 * pixels)


def k7_bwd_bound_s(pixels: int) -> float:
    """K7's backward: twice the forward's MACs (8,704 a pixel) at the TF32
    peak."""
    return bound_s(2.0 * forward_flops(pixels), TF32_FLOP_S)


def k9_bound_s(pixels: int, iterations: int) -> float:
    """K9, the iterated guided chain: the guide's 3 float32 planes and the
    source's one read once, the output written once (20 B a pixel); the
    operations, ``iterations`` guided filters, lie far below."""
    return bound_s(GUIDED_FLOPS_PER_PIXEL * iterations * pixels,
                   F32_FLOP_S, 20.0 * pixels)
