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


# each cell cut to a size a CPU test holds: the same code paths
SMALL = {"serve": {"batch": 2, "height": 40, "width": 48, "pool": 3,
                   "warmup": 1, "sample": 4},
         "train": {"batch": 4, "images": 12, "height": 24, "width": 32},
         "chain": {"pool": 2, "warmup": 1, "sample": 2}}
SMALL_FRAME = {"height": 60, "width": 72}


@pytest.fixture
def small_cell():
    """name -> cell ``name`` of BENCHMARK.json, its shapes cut for the
    CPU."""
    from benchmark import harness

    def load(name):
        cell = copy.deepcopy(harness.Cell.load(name))
        cell.traffic.update(SMALL[cell.traffic["entry"]])
        if cell.traffic["entry"] == "chain":
            cell.config.update(SMALL_FRAME)
        return cell
    return load


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
