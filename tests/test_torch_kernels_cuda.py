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
from reflectance_filtering_tpu_torch.ops import bilateral_joint_kernel as k6
from reflectance_filtering_tpu_torch.ops.bilateral import (
    opencv_bilateral_params)
from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
    bilateral_gray_self, bilateral_gray_self_plain)
from reflectance_filtering_tpu_torch.ops.box_kernel import (
    box_filter_planar, box_filter_planar_plain)
from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
    pack_weights, reflectance_cnn, reflectance_cnn_plain)
from reflectance_filtering_tpu_torch.ops.guided_kernel import (
    guided_filter_fused, guided_filter_fused_plain)
from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
from reflectance_filtering_tpu_torch.ops.whdr_gather import (
    gather_pairs, gather_pairs_plain, scatter_pairs, scatter_pairs_plain)

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


# every instantiation of K6: (cj, cs, self-guided, u8 storage)
K6_INSTANCES = [(3, 3, True, True)] + [
    (cj, cs, False, u8) for u8 in (True, False) for cj in (1, 3)
    for cs in (1, 3)]


@pytest.mark.parametrize("sigma_space", [3.0, 22.0])
@pytest.mark.parametrize("cj,cs,self_guided,u8", K6_INSTANCES)
def test_bilateral_joint_kernel_matches_plain(dev, cj, cs, self_guided, u8,
                                              sigma_space):
    """K6 through its three wrappers against the plain loop over the disk:
    u8 storage on integer values (a 1-plane joint standing for three
    channels), float storage on non-integer values; within 1 uint8 level,
    equal on >= 99.9%, and 1e-3 in float (as K2)."""
    rng = np.random.RandomState(6)

    def planes(c):
        v = rng.rand(2, c, 64, 80) * 255
        return torch.from_numpy((np.floor(v * 256 / 255) if u8 else v)
                                .astype(np.float32)).to(dev)

    joint = planes(cj)
    src = joint if self_guided else planes(cs)
    reps = 3 if u8 and cj == 1 else 1
    if self_guided:
        fn, args = k6.bilateral_color_self_batched, (joint,)
    elif u8:
        fn, args = k6.bilateral_packed_joint_batched, (joint, src)
    else:
        fn, args = k6.joint_bilateral_planar_batched, (joint, src)
    kwargs = {"joint_reps": reps} if fn is k6.bilateral_packed_joint_batched \
        else {}
    before = fn.launches
    got = fn(*args, -1, 20.0, sigma_space, **kwargs)
    assert fn.launches == before + 1
    radius, gcc, gsc, _ = opencv_bilateral_params(-1, 20.0, sigma_space)
    exp = k6.bilateral_joint_plain(joint, src, radius, gcc * reps * reps, gsc)
    d = (torch.round(got) - torch.round(exp)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 1e-3


def test_bilateral_joint_kernel_refuses_too_large_a_radius(dev):
    """Float 3 + 3 planes at sigma_s 30 (radius 45) need 310 KB of shared
    memory: a ValueError naming radius 37, before any launch."""
    x = torch.zeros(1, 3, 8, 8, device=dev)
    before = k6.joint_bilateral_planar_batched.launches
    with pytest.raises(ValueError, match="largest radius .* is 37"):
        k6.joint_bilateral_planar_batched(x, x, -1, 20.0, 30.0)
    assert k6.joint_bilateral_planar_batched.launches == before


def test_gather_kernel_bitwise(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    plane = torch.rand(4, 33, 47, device=dev, generator=g)
    idx = [torch.randint(0, n, (4, 1181), device=dev, dtype=torch.int32,
                         generator=g) for n in (33, 47, 33, 47)]
    got = gather_pairs(plane, *idx)
    exp = gather_pairs_plain(plane, *idx)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))
    # a plane that requires grad: K3 forward (bitwise), K8 backward
    leaf = plane.clone().requires_grad_()
    before = (gather_pairs.launches, scatter_pairs.launches)
    l1, l2 = gather_pairs(leaf, *idx)
    assert torch.equal(l1, exp[0]) and torch.equal(l2, exp[1])
    (l1 * 2.0 + l2).sum().backward()
    assert (gather_pairs.launches, scatter_pairs.launches) == (
        before[0] + 1, before[1] + 1)
    g1 = torch.full_like(l1, 2.0)
    want = scatter_pairs_plain(plane.shape, *idx, g1, torch.ones_like(l2))
    assert (leaf.grad - want).abs().max().item() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("border", ["reflect", "reflect101"])
@pytest.mark.parametrize("shape,radius,normalize", [
    ((3, 64, 96), 45, True), ((2, 37, 300), 8, True), ((1, 20, 27), 45, True),
    ((2, 1, 40), 3, True), ((4, 70, 33), 5, False)])
def test_box_kernel_matches_plain(dev, shape, radius, normalize, border):
    """K4 against the block-local float32 sliding sum; (1, 20, 27) and
    (2, 1, 40) are narrower than the window: reflection repeats.  The
    kernel sums in float64; the plain version's float32 partials reach
    L * w * 255 (L the padded length, at most the block of 512), so the
    two agree to 8 float32 ulps of that, scaled like the output."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).to(dev)
    before = box_filter_planar.launches
    got = box_filter_planar(x, radius, border, normalize)
    assert box_filter_planar.launches == before + 1
    exp = box_filter_planar_plain(x, radius, border, normalize)
    w = 2 * radius + 1
    partial = min(max(shape[1:]) + 2 * radius, 512) * w * 255.0
    tol = 8 * 2.0 ** -24 * partial / (w * w if normalize else 1)
    assert (got - exp).abs().max().item() <= tol


@pytest.mark.parametrize("n,c,h,w,radius", [
    (2, 1, 64, 96, 45), (2, 3, 41, 53, 8), (1, 1, 40, 512, 45),
    (1, 1, 12, 40, 45), (1, 2, 20, 27, 45), (1, 5, 23, 31, 4)])
def test_guided_kernel_matches_plain(dev, n, c, h, w, radius):
    """K5 against its plain version (the generic planar path over the
    plain box) on uint8-valued images: within 1 uint8 level, equal on
    >= 99.9% of pixels, and 0.05 in float (the JAX package's own gate
    between its guided paths).  (40, 512) and (12, 40) are narrower than
    the window; C=5 runs as two kernel calls, each counted."""
    rng = np.random.RandomState(5)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(n, c, h, w) * 256).astype(
        np.float32)).to(dev)
    before = guided_filter_fused.launches
    got = guided_filter_fused(g, s, radius, 3.0)
    assert guided_filter_fused.launches == before + -(-c // 3)
    exp = guided_filter_fused_plain(g, s, radius, 3.0)
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 0.05


def test_guided_kernel_refuses_bad_shapes(dev):
    g = torch.zeros(1, 3, 8, 8, device=dev)
    with pytest.raises(ValueError):
        guided_filter_fused(g, torch.zeros(2, 1, 8, 8, device=dev), 2, 3.0)
    with pytest.raises(ValueError, match="grid limit"):
        guided_filter_fused(torch.zeros(70000, 3, 1, 1, device=dev),
                            torch.zeros(70000, 1, 1, 1, device=dev), 2, 3.0)
    with pytest.raises(ValueError, match="grid limit"):
        box_filter_planar(torch.zeros(70000, 1, 1, device=dev), 2)


# K7 configurations (n, ci, f, cout) and pixel counts: the flagship, the
# JAX package's test configs, RS's 6-wide head, an odd 37x53 frame, the
# widest filters and the most input/output channels fits_fused_trunk admits
K7_CASES = [((5, 3, 32, 1), 3 * 4099), ((2, 3, 16, 1), 37 * 53),
            ((1, 3, 32, 1), 1000), ((2, 3, 128, 1), 2 * 48 * 64),
            ((3, 3, 16, 6), 37 * 53), ((3, 8, 256, 8), 777),
            ((2, 5, 40, 3), 129), ((1, 1, 8, 1), 5)]


def _k7_inputs(dev, shape, p, seed=0):
    n, ci, f, cout = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(p, ci, device=dev, generator=g)
    cot = torch.randn(p, cout, device=dev, generator=g)
    flat = torch.randn(k7.num_params(shape), device=dev, generator=g) * 0.3
    return x, cot, flat


@pytest.mark.parametrize("shape,p", K7_CASES)
def test_trunk_kernels_match_plain(dev, shape, p):
    """K7 forward against the plain trunk (1e-5 relative), its backward
    against plain autograd: each parameter gradient within 2e-4 of its
    leaf's max (the JAX package's gate for its fused trunk), dx within
    5e-5; two backward launches bitwise equal; input_grad=False leaves the
    parameter gradient bitwise unchanged."""
    x, cot, flat = _k7_inputs(dev, shape, p)
    before = (k7.trunk_forward.launches, k7.trunk_backward.launches)
    pre = k7.trunk_forward(x, flat, shape)
    exp = k7.trunk_forward_plain(x, flat, shape)
    assert (pre - exp).abs().max().item() <= 1e-5 * exp.abs().max().item()
    grad, dx = k7.trunk_backward(x, cot, flat, shape, True)
    assert (k7.trunk_forward.launches, k7.trunk_backward.launches) == (
        before[0] + 1, before[1] + 1)
    egrad, edx = k7.trunk_backward_plain(x, cot, flat, shape, True)
    for got, want in zip(*(k7.unpack(v, shape)[0] + k7.unpack(v, shape)[1]
                           for v in (grad, egrad))):
        assert (got - want).abs().max().item() <= (
            2e-4 * want.abs().max().item() + 1e-30)
    assert (dx - edx).abs().max().item() <= 5e-5 * edx.abs().max().item()
    grad2, none = k7.trunk_backward(x, cot, flat, shape, False)
    assert none is None and torch.equal(grad, grad2)


def test_trunk_through_apply_network(dev):
    """apply_network on a CUDA tensor sends an admitted config to K7 and
    gives the gradients of the plain per-layer path; kernels=False takes
    that path on the card and launches nothing."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, apply_network, init_network)
    cfg = NetworkConfig()
    params = init_network(cfg, torch.Generator().manual_seed(1), dev)
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_()
    imgs = torch.rand(2, 40, 56, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    before = k7.trunk_forward.launches
    pre = apply_network(params, imgs, cfg)["RS_est_before_sigmoid"]
    assert k7.trunk_forward.launches == before + 1
    got = torch.autograd.grad(pre.sum(), params["conv0"]["kernel"])[0]
    plain = k7.skip_trunk_pre_plain(params, imgs, num_layers=5)
    want = torch.autograd.grad(plain.sum(), params["conv0"]["kernel"])[0]
    assert (pre - plain).abs().max().item() <= 1e-5 * plain.abs().max()
    assert (got - want).abs().max().item() <= 2e-4 * want.abs().max()
    before = (k7.trunk_forward.launches, k7.trunk_backward.launches)
    off = apply_network(params, imgs, cfg, kernels=False)
    torch.autograd.grad(off["RS_est_before_sigmoid"].sum(),
                        params["conv0"]["kernel"])
    assert (k7.trunk_forward.launches, k7.trunk_backward.launches) == before
    assert (off["RS_est_before_sigmoid"] - plain).abs().max().item() <= (
        1e-5 * plain.abs().max())


@pytest.mark.parametrize("b,h,w,k", [(20, 256, 256, 1181), (2, 3, 3, 1500),
                                     (3, 17, 9, 1)])
def test_scatter_kernel_matches_index_put(dev, b, h, w, k):
    """K8 against index_put_(accumulate=True), collisions forced by small
    planes: within 1e-6 of the largest value, bitwise equal on a second
    launch."""
    g = torch.Generator(device=dev).manual_seed(3)
    idx = [torch.randint(0, n, (b, k), device=dev, dtype=torch.int32,
                         generator=g) for n in (h, w, h, w)]
    g1, g2 = (torch.randn(b, k, device=dev, generator=g) for _ in range(2))
    before = scatter_pairs.launches
    got = scatter_pairs((b, h, w), *idx, g1, g2)
    assert scatter_pairs.launches == before + 1
    want = scatter_pairs_plain((b, h, w), *idx, g1, g2)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    assert torch.equal(got, scatter_pairs((b, h, w), *idx, g1, g2))
