"""The port's Bell-2014 WHDR referee (reflectance_filtering_tpu_torch/
losses/bell.py) against the JAX package's, on IIW-style JSON the test
writes from a seed: equal results, including the skipped comparisons
(a point not opaque, an unknown judgment, a weight of zero or None)."""
import json

import numpy as np
import pytest

from reflectance_filtering_tpu.losses import bell as jb
from reflectance_filtering_tpu_torch.losses import bell as tb


def _judgements(seed, n_points=12, n_comps=40):
    rng = np.random.RandomState(seed)
    points = [{"id": i, "x": float(rng.rand()), "y": float(rng.rand()),
               "opaque": bool(rng.rand() > 0.1)} for i in range(n_points)]
    comps = []
    for _ in range(n_comps):
        a, b = rng.choice(n_points, 2, replace=False)
        weight = [None, 0.0, float(rng.rand())][rng.choice(3, p=[.1, .1, .8])]
        comps.append({"point1": int(a), "point2": int(b),
                      "darker": str(rng.choice(["1", "2", "E", "X"])),
                      "darker_score": weight})
    return {"intrinsic_points": points, "intrinsic_comparisons": comps}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("delta", [0.10, 0.25])
@pytest.mark.parametrize("shape", [(24, 32, 3), (17, 9)])
def test_compute_whdr_equals_jax(seed, delta, shape):
    rng = np.random.RandomState(seed + 100)
    refl = rng.rand(*shape).astype(np.float32)
    judgements = _judgements(seed)
    got = tb.compute_whdr(refl, judgements, delta)
    assert got == jb.compute_whdr(refl, judgements, delta)
    assert 0.0 <= got <= 1.0


def test_whdr_bell_reads_the_json(tmp_path):
    refl = np.random.RandomState(7).rand(20, 30, 3)
    judgements = _judgements(7)
    with open(str(tmp_path / "1234.json"), "w") as f:
        json.dump(judgements, f)
    got = tb.whdr_bell(refl, 1234, str(tmp_path))
    assert got == jb.whdr_bell(refl, "1234", str(tmp_path))
    assert got == tb.compute_whdr(refl, judgements)


def test_no_usable_comparison_scores_zero():
    judgements = _judgements(3)
    for c in judgements["intrinsic_comparisons"]:
        c["darker_score"] = 0.0
    assert tb.compute_whdr(np.ones((4, 4)), judgements) == 0.0
