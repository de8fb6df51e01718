"""Synthetic workloads shared by the chip smoke run and the tests (numpy
only; copied from reflectance_filtering_tpu/utils/testimages.py so both
packages score the same workload)."""
from __future__ import annotations

import numpy as np


def pink_noise(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """1/f 'pink' noise — random phase over a 1/f amplitude spectrum,
    span-normalized and floored to uint8 levels.  Returns float64 values
    in {0..255} (callers cast)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    img = np.real(np.fft.ifft2(np.exp(2j * np.pi * rng.rand(h, w)) / rad))
    return np.floor((img - img.min()) / (img.max() - img.min() + 1e-12)
                    * 255.0)


def make_synthetic_comps(seed: int, k: int, batch: int = None) -> np.ndarray:
    """Deterministic packed IIW-style comparison blob [K+1, 6] (or
    [B, K+1, 6] with ``batch``): rows [x1, y1, x2, y2, darker, weight]
    in normalized coordinates, darker in {0,1,2}, random weights, and
    the metadata last row [num_comparisons, 1.0, 0, nan...]."""
    rr = np.random.RandomState(seed)
    b = 1 if batch is None else batch
    c = np.full((b, k + 1, 6), np.nan, np.float32)
    c[:, :k, :4] = rr.rand(b, k, 4)
    c[:, :k, 4] = rr.randint(0, 3, (b, k))
    c[:, :k, 5] = rr.rand(b, k)
    c[:, k, 0] = k
    c[:, k, 1] = 1.0
    c[:, k, 2] = 0
    return c[0] if batch is None else c
