"""Tests of the benchmark: CPU tests at small sizes; those that need the
card carry the ``cuda`` marker and skip inside a fixture without one."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    # the shapes here are small: one thread a worker process, as more
    # only contend for the cores
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips without one")


@pytest.fixture
def small_cell():
    """name -> cell ``name`` of BENCHMARK.json, cut to its entry's CPU
    sizes (``CPU_SIZES``)."""
    from benchmark import harness

    def load(name):
        cell = copy.deepcopy(harness.Cell.load(name))
        sizes = harness.load_entry(cell.traffic["entry"]).CPU_SIZES
        cell.traffic.update(sizes["traffic"])
        cell.config.update(sizes["config"])
        return cell
    return load


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
