"""Dataset loading (a numpy copy of reflectance_filtering_tpu/data/loader.py)
— the reference's getData contract
(/root/reference/training/data_handling.py:34-84) with a configurable root.

Returns {'images', 'comparisons'[, 'augmented'][, 'albedos']} from
``<root>/<dataset>/<description>.npz``.  File layout is the reference's
(images NCHW); ``as_nhwc=True`` converts images (and albedos) to the
device-native NHWC layout and squeezes the comparisons' singleton axis to
[N, K+1, 6] for the loss ops.

Keeps the retry-with-backoff loop on MemoryError (data_handling.py:54-77).
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

DEFAULT_ROOT = os.path.join(os.path.expanduser("~"), "LMDBs")


def get_data(dataset: str, description: str,
             comparisons_type: str = "comparisons",
             root: Optional[str] = None,
             as_nhwc: bool = True,
             retries: int = 10,
             rng: Optional[np.random.RandomState] = None) -> Dict:
    """Load a packed .npz shard (data_handling.py:34-84)."""
    root = root or DEFAULT_ROOT
    full_path = os.path.join(root, dataset, description + ".npz")
    if not os.path.isfile(full_path):
        raise IOError("File {} could not be found.".format(full_path))

    rng = rng or np.random.RandomState()
    data: Dict = {}
    last_err = None
    if retries < 1:
        raise ValueError("retries must be >= 1, got {}".format(retries))
    for _attempt in range(retries):
        try:
            with np.load(full_path) as npz:
                for kind in ["images", "comparisons"]:
                    data[kind] = npz[kind]
                if comparisons_type == "augmented":
                    data["augmented"] = npz["augmented"]
                if dataset in ("sintel", "mixed"):
                    data["albedos"] = npz["albedos"]
            break
        except MemoryError as err:  # pragma: no cover - hard to trigger
            last_err = err
            data = {}
            time.sleep(rng.rand() * 60)
    else:  # pragma: no cover
        raise last_err

    if as_nhwc:
        data["images"] = np.ascontiguousarray(
            np.transpose(data["images"], (0, 2, 3, 1)).astype(np.float32))
        if "albedos" in data:
            data["albedos"] = np.ascontiguousarray(
                np.transpose(data["albedos"], (0, 2, 3, 1)).astype(np.float32))
        for k in ("comparisons", "augmented"):
            if k in data and data[k].ndim == 4:
                data[k] = np.ascontiguousarray(
                    data[k][:, :, 0, :].astype(np.float32))
    return data
