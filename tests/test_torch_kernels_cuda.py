"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips where torch sees no GPU (the CPU
tests of the same modules hold the plain versions against the JAX
package).  On a GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu_torch.models.networks import (
    ReflectanceNet, params_from_numpy, seeded_reference_params)
from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
    bilateral_gray_self, bilateral_gray_self_plain)
from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
    pack_weights, reflectance_cnn, reflectance_cnn_plain)
from reflectance_filtering_tpu_torch.ops.whdr_gather import (
    gather_pairs, gather_pairs_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hw", [1, 255, 4099])
@pytest.mark.parametrize("srgb_input", [True, False])
def test_cnn_kernel_matches_plain(dev, hw, srgb_input):
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(seeded_reference_params(3)))
    w = pack_weights(net.to(dev))
    x = torch.rand(3, 3, hw, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    before = reflectance_cnn.launches
    got = reflectance_cnn(x, w, srgb_input=srgb_input)
    assert reflectance_cnn.launches == before + 1
    exp = reflectance_cnn_plain(x, w, srgb_input=srgb_input)
    assert (got - exp).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape,sigma_space", [((2, 37, 70), 22.0),
                                               ((1, 20, 27), 22.0),
                                               ((1, 1, 40), 22.0),
                                               ((3, 50, 33), 3.0)])
def test_bilateral_kernel_matches_plain(dev, shape, sigma_space):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(np.floor(rng.rand(*shape) * 256).astype(
        np.float32)).to(dev)
    got = bilateral_gray_self(x, -1, 20.0, sigma_space)
    exp = bilateral_gray_self_plain(x, -1, 20.0, sigma_space)
    d = (torch.round(got) - torch.round(exp)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 1e-3


def test_bilateral_kernel_refuses_too_large_a_radius(dev):
    x = torch.zeros(1, 8, 8, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bilateral_gray_self(x, -1, 20.0, 80.0)      # radius 120


def test_gather_kernel_bitwise(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    plane = torch.rand(4, 33, 47, device=dev, generator=g)
    idx = [torch.randint(0, n, (4, 1181), device=dev, dtype=torch.int32,
                         generator=g) for n in (33, 47, 33, 47)]
    got = gather_pairs(plane, *idx)
    exp = gather_pairs_plain(plane, *idx)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))
    with pytest.raises(NotImplementedError):
        gather_pairs(plane.requires_grad_(), *idx)
