"""Bell-2014-compatible WHDR scoring from IIW JSON judgments (port of
reflectance_filtering_tpu/losses/bell.py, numpy only): the independent
referee of the packed-blob WHDR in losses/whdr.py.

The reference's headline metric is computed by the IIW release's whdr.py
(``compute_whdr(reflectance, judgements, delta=0.10)``) on the written
reflectance images (train_with_barrista_helper.py:68-73, 1068-1076).  This
module reimplements that public algorithm so evaluation does not need the
external IIW code: for each comparison with a darker judgment in
{'1', '2', 'E'}, both points opaque and darker_score > 0, read the
reflectance luminance L = mean(RGB) at r[int(y * rows), int(x * cols)]
(floored at 1e-10); classify l2/l1 > 1 + delta -> '1', l1/l2 > 1 + delta
-> '2', else 'E'; sum the weight of the disagreements over the weight of
all.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Union

import numpy as np


def compute_whdr(reflectance: np.ndarray, judgements: Dict,
                 delta: float = 0.10) -> float:
    """WHDR of an HWC (or HW) reflectance image against IIW judgments.

    Mirrors the IIW release's whdr.py scoring function.
    """
    points = {p["id"]: p for p in judgements["intrinsic_points"]}
    rows, cols = reflectance.shape[0:2]

    error_sum = 0.0
    weight_sum = 0.0
    for c in judgements["intrinsic_comparisons"]:
        point1 = points[c["point1"]]
        point2 = points[c["point2"]]
        darker = c["darker"]
        if not point1["opaque"] or not point2["opaque"]:
            continue
        if darker not in ("1", "2", "E"):
            continue
        weight = c["darker_score"]
        if weight is None or weight <= 0:
            continue

        def lum(p):
            v = reflectance[int(p["y"] * rows), int(p["x"] * cols)]
            return max(1e-10, float(np.mean(v)))

        l1 = lum(point1)
        l2 = lum(point2)
        if l2 / l1 > 1.0 + delta:
            alg_darker = "1"
        elif l1 / l2 > 1.0 + delta:
            alg_darker = "2"
        else:
            alg_darker = "E"
        if darker != alg_darker:
            error_sum += weight
        weight_sum += weight
    if weight_sum:
        return error_sum / weight_sum
    return 0.0


def whdr_bell(reflectance_hwc: np.ndarray, file_id: Union[str, int],
              iiw_data_dir: str, delta: float = 0.10) -> float:
    """Score against ``<iiw_data_dir>/<file_id>.json``
    (train_with_barrista_helper.py:1068-1076)."""
    path = os.path.join(iiw_data_dir, "{}.json".format(file_id))
    with open(path) as f:
        return compute_whdr(reflectance_hwc, json.load(f), delta)
