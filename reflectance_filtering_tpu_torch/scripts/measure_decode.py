"""Host PNG decode: the native thread-pool batch decoder against cv2, in
turns, on the host this runs on.

    python -m reflectance_filtering_tpu_torch.scripts.measure_decode \\
        [--count 32] [--height 768] [--width 1024] [--seed N]

Writes ``--count`` seeded PNGs of ``--height`` x ``--width`` (smooth color
fields with noise, as phase 5d of chip_smoke.py writes) into a temporary
directory, holds the two decoders bitwise equal on them, then times each
over the whole set ROUNDS times in turns (native, cv2, cv2, native, ...):
``data/native_loader.load_batch_rgb`` (the C++ thread pool, one call), and
``cv2.imread`` one file after another (the decoder a machine without
libpng or libjpeg falls back to).  Prints the host's core count and each
decoder's median seconds as one JSON object.  Needs no card; where the
native library cannot be built it times cv2 alone.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from ..data import native_loader

ROUNDS = 3


def write_pngs(folder: str, count: int, h: int, w: int,
               seed: int) -> List[str]:
    import cv2
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    paths = []
    for i in range(count):
        base = np.stack([120 + 80 * np.sin(xx / (40.0 + i)),
                         100 + 60 * np.cos(yy / 45.0),
                         90 + 50 * np.sin((xx + yy) / 80.0)], -1)
        img = np.clip(base + 20 * rng.rand(h, w, 3), 0, 255).astype(np.uint8)
        paths.append(os.path.join(folder, "{:03d}.png".format(i)))
        cv2.imwrite(paths[-1], img)
    return paths


def _cv2_serial(paths, h, w) -> np.ndarray:
    import cv2
    return np.stack([cv2.imread(p)[:, :, ::-1] for p in paths])


def measure(paths: List[str], h: int, w: int) -> Dict[str, float]:
    """{decoder: median seconds to decode ``paths``}; raises if the two
    decoders differ in any byte."""
    runs = {"cv2": lambda: _cv2_serial(paths, h, w)}
    if native_loader.native_available():
        runs["native"] = lambda: native_loader.load_batch_rgb(paths, h, w)
        if not np.array_equal(runs["native"](), runs["cv2"]()):
            raise RuntimeError("the native decoder and cv2 differ")
    order = sorted(runs, reverse=True)      # native first where it is there
    times = {name: [] for name in runs}
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            start = time.perf_counter()
            runs[name]()
            times[name].append(time.perf_counter() - start)
    return {name: statistics.median(s) for name, s in times.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--count", type=int, default=32)
    parser.add_argument("--height", type=int, default=768)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as folder:
        paths = write_pngs(folder, args.count, args.height, args.width,
                           args.seed)
        seconds = measure(paths, args.height, args.width)
    print(json.dumps({"pngs": args.count, "height": args.height,
                      "width": args.width, "cores": os.cpu_count(),
                      "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
