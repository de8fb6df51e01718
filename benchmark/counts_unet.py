"""The work counts of the reference's two-stream uNet (configuration
``unet_n2k3_512``), for the peak and roofline shares of its training cell.

MACs come from the layer shapes alone: a convolution's output pixels times
its taps times its input and output channels (padding taps included, as a
FLOP counter counts them); a 2x2 stride-2 deconvolution's input pixels
times 4 taps times its channels.  The global stream runs on a fixed
256x256 resize, so its MACs do not grow with the frame, and a frame's
count is not a constant times its pixels.  A training step is the forward
and a backward of twice it, counted at the TF32 peak as ``counts.py``
counts the flagship's (PERF.md section 4).
"""
from __future__ import annotations

from typing import List, Tuple

from .counts import TF32_FLOP_S, bound_s

GLOBAL_SIZE = 256


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def layer_macs(height: int, width: int, num_layers: int = 2,
               kernel: int = 3, head: int = 1) -> List[Tuple[str, int]]:
    """(layer, MACs an image) of every convolution and deconvolution, in
    the forward's order; frames divisible by 8."""
    n, k, p = num_layers, kernel, (kernel - 1) // 2
    out: List[Tuple[str, int]] = []

    def conv(name, h, w, kk, stride, pad, ci, co):
        ho, wo = _out(h, kk, stride, pad), _out(w, kk, stride, pad)
        out.append((name, ho * wo * kk * kk * ci * co))
        return ho, wo

    def block(name, h, w, ci, co):
        for i in range(n):
            conv("{}_{}".format(name, i), h, w, k, 1, p, ci if i == 0 else co,
                 co)

    def deconv(name, h, w, ci, co):
        out.append((name, h * w * 4 * ci * co))
        return 2 * h, 2 * w

    h1, w1 = conv("Conv1", height, width, 3, 2, 1, 3, 16)
    block("d1", h1, w1, 16, 16)
    h2, w2 = conv("Conv2", h1, w1, 3, 2, 1, 16, 32)
    block("d2", h2, w2, 32, 32)
    h3, w3 = conv("Conv3", h2, w2, 3, 2, 1, 32, 64)
    block("d3", h3, w3, 64, 64)
    conv("Conv4", h3, w3, 7, 1, 3, 64, 64)
    block("d4", h3, w3, 64, 64)
    g = conv("Conv5", GLOBAL_SIZE, GLOBAL_SIZE, 5, 4, 2, 3, 32)
    g = conv("Conv6", *g, 5, 4, 2, 32, 32)
    g = conv("Conv7", *g, 5, 4, 2, 32, 32)
    conv("Conv8", *g, 3, 1, 0, 32, 64)
    block("comb", h3, w3, 128, 64)
    conv("comb_final", h3, w3, 3, 1, 1, 128 if n == 0 else 64, 64)
    deconv("up3", h3, w3, 64, 64)
    block("r2", h2, w2, 32 + 64, 32)
    conv("r2_final", h2, w2, 3, 1, 1, 32 + 64 if n == 0 else 32, 32)
    deconv("up2", h2, w2, 32, 16)
    block("r1", h1, w1, 16 + 16, 16)
    conv("r1_final", h1, w1, 3, 1, 1, 16 + 16 if n == 0 else 16, 16)
    deconv("up1", h1, w1, 16, 3)
    block("out", height, width, 3 + 3, 3)
    conv("head", height, width, 3, 1, 1, 3 + 3 if n == 0 else 3, head)
    return out


def forward_macs(height: int, width: int, num_layers: int = 2,
                 kernel: int = 3) -> int:
    """MACs of an image's forward: 4,373,176,320 at 512x512, n2 k3 (16,682
    a pixel)."""
    return sum(m for _, m in layer_macs(height, width, num_layers, kernel))


def train_step_flops(batch: int, height: int, width: int,
                     num_layers: int = 2, kernel: int = 3) -> float:
    """A training step's model FLOPs: the forward and a backward of twice
    the forward, 3 x 2 a MAC (525 GFLOP a step of 20 x 512x512)."""
    return 3.0 * 2.0 * batch * forward_macs(height, width, num_layers, kernel)


def conv_bound_s(batch: int, height: int, width: int, num_layers: int = 2,
                 kernel: int = 3) -> float:
    """The step's convolutions, forward, data and weight gradients: their
    FLOPs at the TF32 dense peak."""
    return bound_s(train_step_flops(batch, height, width, num_layers, kernel),
                   TF32_FLOP_S)
