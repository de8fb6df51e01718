"""The K8 measurement script (reflectance_filtering_tpu_torch/scripts/
measure_k8.py) on the CPU: it refuses to run without a card, and its
seeded cases are the shapes it names, each on the sort path, the crowded
one with half of its points in a 12x12 corner."""
import pytest
import torch

from reflectance_filtering_tpu_torch.ops.whdr_gather import (
    scatter_pairs, scatter_pairs_plain, sort_path)
from reflectance_filtering_tpu_torch.scripts import measure_k8


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        measure_k8.main([])
    assert "CUDA" in str(exc.value.code)


def test_cases_are_seeded_and_on_the_sort_path():
    small = {"spread": (2, 17, 9, 40, False), "crowded": (3, 30, 20, 64, True)}
    a = measure_k8.make_inputs("cpu", 5, small)
    b = measure_k8.make_inputs("cpu", 5, small)
    for name, (n, h, w, k, crowded) in small.items():
        shape, idx, g1, g2 = a[name]
        assert shape == (n, h, w) and sort_path(k)
        assert all(t.dtype == torch.int32 and t.shape == (n, k) for t in idx)
        assert all(torch.equal(x, y) for x, y in zip(idx, b[name][1]))
        assert torch.equal(g1, b[name][2]) and g2.dtype == torch.float32
        assert int(idx[0].max()) < h and int(idx[1].max()) < w
        corner = all(int(t[:, : k // 2].max()) < 12 for t in idx)
        assert corner == crowded
        assert torch.equal(scatter_pairs(shape, *idx, g1, g2),
                           scatter_pairs_plain(shape, *idx, g1, g2))
    assert all(sort_path(k) for _, _, _, k, _ in measure_k8.CASES.values())
