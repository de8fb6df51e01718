"""Prediction and scoring (port of the scoring half of
reflectance_filtering_tpu/train/predict.py).

``predict_and_score`` keeps the reference's artifact contract
(train_with_barrista_helper.py:490-583): score cache file
``scores/{description}_imgs{N}.txt`` (a value < 100 is returned without
recompute), frame rate written to ``framerates/...txt``, sentinel score 100
when prediction fails.  Batches run on one device.  The decompose family
(images, movies, npz) is not ported yet (ROADMAP module queue item 12).
"""
from __future__ import annotations

import os
import timeit
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch

from ..losses.whdr import whdr_per_image
from ..models.networks import NetworkConfig, apply_network
from ..models.recover import recover_reflectance_shading


def percent(num) -> str:
    """helper:442-444."""
    return "{:.2f}%".format(num * 100)


def make_predict_fn(net_cfg: NetworkConfig) -> Callable:
    """(params, images NHWC tensor) -> {RS_est, reflectance, shading}, plus
    the cascade's ``reflectance_level0`` when the network makes it (JAX
    ``train/predict.py:67-68``), with no autograd graph."""

    def predict(params, images):
        with torch.no_grad():
            blobs = apply_network(params, images, net_cfg, train=False)
            if net_cfg.rs_est_mode.split("-")[0] == "rDirectly":
                refl = torch.relu(blobs["RS_est"])
                shad = refl
            else:
                refl, shad = recover_reflectance_shading(
                    blobs["RS_est"], images, net_cfg.rs_est_mode)
        out = {"RS_est": blobs["RS_est"], "reflectance": refl,
               "shading": shad}
        if "reflectance_level0" in blobs:
            out["reflectance_level0"] = blobs["reflectance_level0"]
        return out

    return predict


def predict_batched(predict_fn: Callable, params, images: np.ndarray,
                    batch_size: int = 32, device="cuda"
                    ) -> Dict[str, np.ndarray]:
    """Run prediction over [N,H,W,3] in batches of ``batch_size`` on
    ``device``; the outputs come back as numpy."""
    outs: Dict[str, List[np.ndarray]] = {}
    for start in range(0, images.shape[0], batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(
            images[start:start + batch_size], np.float32)).to(device)
        for k, v in predict_fn(params, chunk).items():
            outs.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def score_whdr_per_image(reflectances: np.ndarray, comps: np.ndarray,
                         delta: float = 0.1, device="cuda") -> np.ndarray:
    """Per-image WHDR over a whole prediction set in one call on
    ``device``."""
    r = torch.from_numpy(np.asarray(reflectances, np.float32)).to(device)
    c = torch.from_numpy(np.asarray(comps, np.float32)).to(device)
    return whdr_per_image(r, c, delta).cpu().numpy()


def predict_and_score(X_val: Dict, params, net_cfg: NetworkConfig,
                      results_dir: str, description: str,
                      delta: float = 0.1, batch_size: int = 32,
                      predict_fn=None, device="cuda") -> float:
    """Score a checkpoint on a validation set; returns WHDR in percent,
    with the score cache, the frame-rate file and the sentinel 100 of the
    reference (helper:498-583)."""
    num_images = X_val["images"].shape[0]
    description = description + "_imgs{}".format(num_images)
    score_filename = os.path.join(results_dir, "scores",
                                  description + ".txt")
    if os.path.isfile(score_filename):
        try:
            with open(score_filename) as f:
                result = float(f.readline())
        except ValueError:
            # an interrupted eval can leave an empty or garbled cache file
            result = 100.0
        if result < 100:
            return result

    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)

    start = timeit.default_timer()
    try:
        results = predict_batched(predict_fn, params,
                                  np.asarray(X_val["images"], np.float32),
                                  batch_size, device)
    except Exception:  # noqa: BLE001 — the reference's sentinel contract
        traceback.print_exc()
        print("Prediction was not possible, returning 100 as default!")
        return 100
    prediction_time = timeit.default_timer() - start
    rate = num_images / prediction_time
    print("Predicting", num_images, "images took", prediction_time,
          "seconds, i.e.,", prediction_time / num_images, "per image and",
          rate, "images per second.")

    os.makedirs(os.path.join(results_dir, "framerates"), exist_ok=True)
    with open(os.path.join(results_dir, "framerates",
                           description + ".txt"), "w") as f:
        f.write(str(rate))

    whdrs = score_whdr_per_image(results["reflectance"],
                                 np.asarray(X_val["comparisons"], np.float32),
                                 delta, device)
    mean_whdr = float(np.mean(whdrs))
    score = mean_whdr * 100

    print("WHDR on learned reflectance for:", description)
    print("WHDRs:",
          "\t min", percent(float(np.min(whdrs))),
          "\t max", percent(float(np.max(whdrs))),
          "\t median", percent(float(np.median(whdrs))),
          "\t mean", percent(mean_whdr))

    os.makedirs(os.path.join(results_dir, "scores"), exist_ok=True)
    tmp = score_filename + ".tmp"     # atomic publish
    with open(tmp, "w") as f:
        f.write(str(score))
    os.replace(tmp, score_filename)
    return score
