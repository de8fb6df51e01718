"""Host-side training monitors — the reference's barrista Monitor plug-ins
(training/extend_monitoring.py) re-expressed around a training step.

A copy of reflectance_filtering_tpu/train/monitors.py: no framework, plain
Python and numpy.  The monitors observe per-step metric dicts of floats
and numpy parameters; they never sit inside the step.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import numpy as np


class CombineLosses:
    """Weighted combined-loss scalar (extend_monitoring.py:168-194)."""

    def __init__(self, loss_scale_whdr: float, loss_scale_lambert: float):
        self.scale_whdr = loss_scale_whdr
        self.scale_lambert = loss_scale_lambert

    def __call__(self, step: int, metrics: Dict[str, float]
                 ) -> Dict[str, float]:
        loss = 0.0
        if self.scale_whdr:
            loss += self.scale_whdr * metrics.get("loss_whdr_hinge", 0.0)
        if self.scale_lambert:
            loss += self.scale_lambert * metrics.get("loss_lambert", 0.0)
        metrics["loss_combined"] = loss
        return metrics


class RunningAverage:
    """NaN-aware epoch ring buffer of WHDR (extend_monitoring.py:197-218)."""

    def __init__(self, train_size: int, batch_size: int):
        self.num_samples = max(int(train_size / batch_size), 1)
        self.cycle_whdrs = np.full(self.num_samples, np.nan)

    def __call__(self, step: int, metrics: Dict[str, float]
                 ) -> Dict[str, float]:
        index = step % self.num_samples
        self.cycle_whdrs[index] = metrics.get("whdr_original", np.nan)
        metrics["running_average"] = float(np.nanmean(self.cycle_whdrs))
        return metrics


class JsonlLogger:
    """Training-metric logger writing logs/barrista_<name>.jsonl.

    The reference wired a barrista JSONLogger but shipped it disabled
    (helper:251-261); this is the working equivalent: one JSON object per
    step with the extracted blobs (§5.5 log_results set).
    """

    def __init__(self, log_dir: str, name: str):
        import os

        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "barrista_" + name + ".jsonl")
        self._fh = open(self.path, "a")

    def __call__(self, step: int, metrics: Dict[str, float]):
        import json
        import math

        # json.dumps emits bare NaN/Infinity tokens (invalid JSON) for
        # non-finite floats — a diverged step would corrupt the artifact
        # for strict jsonl consumers. Serialize those as null.
        rec = {"step": step}
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                rec[k] = None if (isinstance(v, float)
                                  and not math.isfinite(v)) else v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


def vis_square(data: np.ndarray, padsize: int = 1, padval: float = 0
               ) -> np.ndarray:
    """Tile a stack of filters/feature maps into one square image
    (train_with_barrista.py:105-120, the caffe notebook helper)."""
    data = np.array(data, dtype=np.float64, copy=True)
    data -= data.min()
    if data.max() > 0:
        data /= data.max()
    n = int(np.ceil(np.sqrt(data.shape[0])))
    padding = (((0, n ** 2 - data.shape[0]), (0, padsize), (0, padsize)) +
               ((0, 0),) * (data.ndim - 3))
    data = np.pad(data, padding, mode="constant",
                  constant_values=(padval, padval))
    data = data.reshape((n, n) + data.shape[1:]).transpose(
        (0, 2, 1, 3) + tuple(range(4, data.ndim + 1)))
    data = data.reshape((n * data.shape[1], n * data.shape[3]) +
                        data.shape[4:])
    return data


class FilterVisualizer:
    """Writes a vis_square grid of the first conv layer's filters to the
    results tree's ``images/`` dir whenever a checkpoint lands — realizes
    the intent of the reference's (never-wired) _vis_square helper
    (train_with_barrista.py:105-120) and populates the ``images``
    artifact dir it creates (train_with_barrista.py:319-331).

    Call with (samples, params); writes images/filters_iter_{N}.png for
    conv kernels spatially larger than 1x1, or a weight-matrix heatmap
    for 1x1 stacks."""

    def __init__(self, results_dir: str):
        self.dir = os.path.join(results_dir, "images")
        self._last = -1

    def __call__(self, samples: int, params) -> None:
        # fires only from on_checkpoint (actual saves), so dedupe by the
        # exact sample count: an interval-bucket gate would skip the
        # forced FINAL checkpoint whenever it shares a bucket with the
        # previous save (e.g. interval 1000, finalize at 2500)
        if samples == self._last:
            return
        self._last = samples
        conv0 = params.get("conv0") or params.get("conv0_level0")
        if conv0 is None:
            return
        k = np.asarray(conv0["kernel"])          # [kh, kw, ci, co]
        kh, kw, ci, co = k.shape
        if kh == 1 and kw == 1:
            grid = vis_square(np.moveaxis(k[0, 0], -1, 0)[:, :, None])
        else:
            grid = vis_square(np.transpose(k, (3, 0, 1, 2))[..., 0])
        os.makedirs(self.dir, exist_ok=True)
        import cv2

        cv2.imwrite(os.path.join(
            self.dir, "filters_iter_{}.png".format(samples)),
            (grid * 255).astype(np.uint8))


class ProgressPrinter:
    """Console progress with the reference's field set
    (extend_monitoring.py:221-360: Loss/Hinge/BR/BS/Lamb/WHDR/RunAvg)."""

    def __init__(self, max_samples: int,
                 loss_scale_whdr: float = 1.0,
                 loss_scale_boundaries01: float = 1.0,
                 loss_scale_lambert: float = 1.0,
                 print_every: int = 50,
                 stream=None):
        self.max_samples = max_samples
        self.scale_whdr = loss_scale_whdr
        self.scale_b = loss_scale_boundaries01
        self.scale_l = loss_scale_lambert
        self.print_every = print_every
        self.stream = stream or sys.stdout
        self.start = time.time()

    def __call__(self, step: int, samples: int,
                 metrics: Dict[str, float]):
        if step % self.print_every:
            return
        parts = ["|Iter: {}/{}".format(samples, self.max_samples)]
        if "loss_combined" in metrics:
            parts.append("|Loss: {0:.4f}".format(metrics["loss_combined"]))
        if "loss_whdr_hinge_level0" in metrics:
            parts.append("|HL0: {0:.2f}".format(
                self.scale_whdr * metrics["loss_whdr_hinge_level0"]))
        if "loss_whdr_hinge" in metrics:
            parts.append("|Hinge: {0:.2f}".format(
                self.scale_whdr * metrics["loss_whdr_hinge"]))
        if "loss_boundaries_reflectance" in metrics:
            parts.append("|BR: {0:.2f}".format(
                self.scale_b * metrics["loss_boundaries_reflectance"]))
        if "loss_boundaries_shading" in metrics:
            parts.append("|BS: {0:.2f}".format(
                self.scale_b * metrics["loss_boundaries_shading"]))
        if "loss_lambert" in metrics:
            parts.append("|Lamb: {0:.4f}".format(
                self.scale_l * metrics["loss_lambert"]))
        if "whdr_original_level0" in metrics:
            parts.append("|WL0: {0:5.2f}".format(
                metrics["whdr_original_level0"] * 100))
        if "whdr_original" in metrics:
            parts.append("|WHDR: {0:5.2f}".format(
                metrics["whdr_original"] * 100))
        if "val_whdr" in metrics:
            # live validation WHDR from the latest checkpoint (the
            # reference progressbar's 'Test' field,
            # extend_monitoring.py:326-360)
            parts.append("|Test: {0:5.2f}".format(
                metrics["val_whdr"] * 100))
        ra = metrics.get("running_average", np.nan)
        if not np.isnan(ra):
            parts.append("|RunAvg: {0:5.2f}".format(ra * 100))
        elapsed = time.time() - self.start
        parts.append("|{0:.1f}s".format(elapsed))
        print("".join(parts), file=self.stream)
        self.stream.flush()
