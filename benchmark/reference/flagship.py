"""The flagship network (Nestmeyer & Gehler, CVPR 2017, the reference's
network_definition.prototxt): sRGB in [0, 1] decoded to linear, five 1x1
convs of width 32 with ReLU, the skip-concat of the five to 160 channels,
a 160 -> 1 fuse and a sigmoid, per pixel."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def no_tf32():
    """Pin float32 products to float32 (TF32 off) for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest), as the
    tensor cores read a float32 operand in TF32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ w on TF32-rounded operands, forward and backward, as the
    tensor cores multiply float32 in TF32."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return tf32(a) @ tf32(w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(w).transpose(-1, -2), (
            tf32(a).reshape(-1, a.shape[-1]).transpose(0, 1)
            @ g.reshape(-1, g.shape[-1]))


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """The sRGB decode (IEC 61966-2-1) of values in [0, 1]."""
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow(torch.clamp((x + 0.055) / 1.055, min=0.0),
                                 2.4))


def trunk(layers: Layers, x: torch.Tensor, low: bool = False
          ) -> torch.Tensor:
    """x [..., 3] linear RGB -> the fuse's output [..., 1] before the
    sigmoid: ``layers`` = [(W [in, out], b [out])] x 5, then the fuse's."""
    no_tf32()
    mm = _Tf32Matmul.apply if low else (lambda a, w: a @ w)
    skips: List[torch.Tensor] = []
    for w, b in layers[:-1]:
        x = torch.relu(mm(x, w) + b)
        skips.append(x)
    w, b = layers[-1]
    return mm(torch.cat(skips, dim=-1), w.reshape(-1, 1)) + b


def reflectance(layers: Layers, photos_bgr: torch.Tensor, low: bool = False,
                block: int = 4) -> torch.Tensor:
    """uint8-valued BGR photos [B, 3, H, W] -> reflectance [B, H, W] in
    (0, 1), ``block`` images at a time."""
    out = []
    for i in range(0, photos_bgr.shape[0], block):
        x = photos_bgr[i:i + block].flip(1).to(torch.float32) / 255.0
        x = srgb_to_linear(x).permute(0, 2, 3, 1)
        out.append(torch.sigmoid(trunk(layers, x, low))[..., 0])
    return torch.cat(out)
