"""The one generator of the benchmark's inputs, read by every traffic mix.

Frozen copies of the port's seeded generators, so that a later change to
the program cannot change what the benchmark feeds it:

* :func:`device_photos` is ``chip_smoke.py::device_photos`` (1/f noise per
  channel with a shared luminance component, made on the device);
* :func:`comparisons` is ``utils/testimages.py::make_synthetic_comps`` (the
  packed IIW-style comparison blob), drawn from a torch generator on the
  device instead of numpy's RandomState, whose seeds stop at 2**32;
* :func:`flagship_weights` follows ``models/networks.py::
  seeded_reference_params`` (normal kernels of std 1.5/sqrt(fan_in), 6/sqrt
  (160) for the fuse, biases of std 0.1), drawn in one call;
* :func:`training_weights` follows the trainer's caffe ``xavier`` filler
  (uniform kernels of bound sqrt(3/fan_in), zero biases), drawn in one call.

Every function draws from a ``torch.Generator`` on the device that the
data lives on, so a run makes its inputs in a few large calls on the card,
and the same seed gives the same inputs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# the flagship network: five 1x1 convs of width 32 from 3 channels, the
# 160 -> 1 fuse (models/networks.py, REFERENCE_CONFIG)
FLAGSHIP_LAYERS = 5
FLAGSHIP_WIDTH = 32


def device_photos(gen: torch.Generator, n: int, h: int, w: int
                  ) -> torch.Tensor:
    """Seeded uint8-valued float32 photos [n, 3, h, w] made on the
    generator's device: 1/f noise per channel (a natural-image spectrum)
    with a shared luminance component."""
    dev = gen.device
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.fftfreq(w, device=dev)[None, :]
    amp = 1.0 / torch.sqrt(fy * fy + fx * fx).clamp_min(1e-30)
    amp[0, 0] = 1.0

    def pink():
        phase = 2 * math.pi * torch.rand((h, w), device=dev, generator=gen)
        img = torch.fft.ifft2(torch.polar(amp, phase)).real
        return torch.floor((img - img.min()) / (img.max() - img.min() + 1e-12)
                           * 255.0)

    out = torch.empty((n, 3, h, w), device=dev)
    for i in range(n):
        lum = pink()
        for c in range(3):
            out[i, c] = torch.floor(torch.clamp(0.6 * lum + 0.4 * pink(), 0,
                                                255))
    return out


def pink_planes(gen: torch.Generator, n: int, h: int, w: int
                ) -> torch.Tensor:
    """n seeded 1/f planes [n, 1, h, w] of uint8-valued float32 levels (the
    luminance recipe of :func:`device_photos` alone)."""
    return device_photos(gen, n, h, w)[:, :1].contiguous()


def comparisons(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """Packed IIW-style comparison blobs [n, k+1, 6] float32 on the
    generator's device: rows [x1, y1, x2, y2, darker, weight] in
    normalized coordinates, darker in {0, 1, 2}, random weights, and the
    metadata last row [k, 1.0, 0, nan, nan, nan]."""
    dev = gen.device
    c = torch.full((n, k + 1, 6), float("nan"), device=dev)
    c[:, :k, :4] = torch.rand((n, k, 4), generator=gen, device=dev)
    c[:, :k, 4] = torch.randint(0, 3, (n, k), generator=gen,
                                device=dev).to(torch.float32)
    c[:, :k, 5] = torch.rand((n, k), generator=gen, device=dev)
    c[:, k, 0] = k
    c[:, k, 1] = 1.0
    c[:, k, 2] = 0
    return c


def _layer_shapes() -> List[Tuple[int, int]]:
    """(fan in, fan out) of the five trunk layers, then the fuse."""
    dims = [3] + [FLAGSHIP_WIDTH] * FLAGSHIP_LAYERS
    return list(zip(dims[:-1], dims[1:])) + [
        (FLAGSHIP_WIDTH * FLAGSHIP_LAYERS, 1)]


def flagship_weights(gen: torch.Generator) -> List[Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """The served flagship's seeded weights on the generator's device:
    [(W [in, out], b [out])] for the five layers and the fuse, from one
    normal draw."""
    shapes = _layer_shapes()
    total = sum(i * o + o for i, o in shapes)
    z = torch.randn(total, generator=gen, device=gen.device)
    out, at = [], 0
    for j, (fan_in, fan_out) in enumerate(shapes):
        scale = (6.0 if j == len(shapes) - 1 else 1.5) / math.sqrt(fan_in)
        w = z[at:at + fan_in * fan_out].reshape(fan_in, fan_out) * scale
        at += fan_in * fan_out
        b = z[at:at + fan_out] * 0.1
        at += fan_out
        out.append((w.contiguous(), b.contiguous()))
    return out


def training_weights(gen: torch.Generator) -> Dict[str, Dict[str,
                                                             torch.Tensor]]:
    """The trainer's seeded initial parameters on the generator's device,
    in its layout ({conv0..conv4, fuse_skip_layers: {kernel [1, 1, in,
    out], bias [out]}}): uniform kernels of bound sqrt(3 / fan_in) from one
    draw, zero biases."""
    shapes = _layer_shapes()
    u = torch.rand(sum(i * o for i, o in shapes), generator=gen,
                   device=gen.device)
    names = ["conv{}".format(i) for i in range(FLAGSHIP_LAYERS)] + [
        "fuse_skip_layers"]
    out, at = {}, 0
    for name, (fan_in, fan_out) in zip(names, shapes):
        a = math.sqrt(3.0 / fan_in)
        k = (u[at:at + fan_in * fan_out] * 2.0 - 1.0) * a
        at += fan_in * fan_out
        out[name] = {"kernel": k.reshape(1, 1, fan_in, fan_out).contiguous(),
                     "bias": torch.zeros(fan_out, device=gen.device)}
    return out
