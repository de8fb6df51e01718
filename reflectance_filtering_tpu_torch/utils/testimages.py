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


def whdr_edge_cases(delta: float = 0.1):
    """Batches where WHDR's truncation, masks and rounding decide the
    score: (plane [8, 4, 5] float32, comparisons [8, 5, 6] float32,
    expected per-image WHDR [8]), each image's score exact in float32.

    Images: 0-2 ratios exactly at the float32 threshold t = 1 + delta (not
    above it: class E) and one ulp above (darker 1); 3 coordinates 0.0 and
    1.0 (1.0 clamped to the last pixel), one row wrong; 4 zero weights
    only (a weight sum of 0 scores 0); 5 a NaN lightness (class E) beside
    one floored at eps; 6 num = 0 over finite rows; 7 num < K, the rest
    NaN-padded.  Pixels are addressed at their centres."""
    h, w, k = 4, 5, 4
    t = np.float32(1.0 + delta)
    plane = np.full((h, w), 0.25, np.float32)
    plane[0, :5] = [1.0, t, np.nextafter(t, np.float32(2.0)), 0.0, np.nan]
    plane[h - 1, w - 1] = 0.5

    def at(y, x):
        return [(x + 0.5) / w, (y + 0.5) / h]

    corner = [0.0, 0.0, 1.0, 1.0]          # (0, 0) against (h-1, w-1)
    images = [  # (rows [x1, y1, x2, y2, darker, weight], num, expected)
        ([at(0, 0) + at(0, 1) + [1, 1.0]], 1, 1.0),
        ([at(0, 0) + at(0, 2) + [1, 1.0]], 1, 0.0),
        ([at(0, 1) + at(0, 0) + [2, 1.0]], 1, 1.0),
        ([corner + [2, 0.75], corner + [1, 0.25]], 2, 0.25),
        ([at(0, 0) + at(0, 2) + [2, 0.0], at(0, 0) + at(0, 2) + [1, 0.0]],
         2, 0.0),
        ([at(0, 4) + at(0, 0) + [1, 0.5], at(0, 3) + at(0, 0) + [1, 0.5]],
         2, 0.5),
        ([at(0, 0) + at(0, 2) + [2, 1.0]] * k, 0, 0.0),
        ([at(0, 0) + at(0, 2) + [2, 0.25], at(0, 0) + at(0, 2) + [1, 0.75]],
         2, 0.25),
    ]
    comps = np.full((len(images), k + 1, 6), np.nan, np.float32)
    for i, (rows, num, _) in enumerate(images):
        comps[i, :len(rows)] = rows
        comps[i, k, :3] = [num, 1.0, 0.0]
    expected = np.array([e for _, _, e in images], np.float32)
    return np.repeat(plane[None], len(images), axis=0), comps, expected
