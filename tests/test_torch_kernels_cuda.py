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
from reflectance_filtering_tpu_torch.ops.guided import guided_filter_iterated
from reflectance_filtering_tpu_torch.ops import guided_chain_kernel as k9
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


@pytest.mark.parametrize("shape", [(2, 37, 70), (1, 20, 27), (1, 1, 40),
                                   (3, 50, 33), (2, 64, 128)])
@pytest.mark.parametrize("sigma_space", [22.0, 2.0])     # radius 33, 3
def test_bilateral_kernel_u8_matches_plain(dev, shape, sigma_space):
    """K2's uint8 form (cv2's table form) against its plain version on the
    same levels: ragged tiles, a plane smaller than the radius, 1-wide and
    whole tiles; within 1e-3, 1 uint8 level, equal on >= 99.9%."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randint(0, 256, size=shape).astype(
        np.uint8)).to(dev)
    before = bilateral_gray_self.launches
    got = bilateral_gray_self(x, -1, 20.0, sigma_space)
    assert bilateral_gray_self.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == shape
    exp = bilateral_gray_self_plain(x, -1, 20.0, sigma_space)
    d = (torch.round(got) - torch.round(exp)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_bilateral_kernel_refuses_other_dtypes(dev, dtype):
    before = bilateral_gray_self.launches
    with pytest.raises(TypeError, match="uint8 levels or float32"):
        bilateral_gray_self(torch.zeros(1, 8, 8, dtype=dtype, device=dev))
    assert bilateral_gray_self.launches == before


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
    exp = k6.bilateral_joint_plain(joint, src, radius, gcc, gsc, reps, u8)
    d = (torch.round(got) - torch.round(exp)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 1e-3


# K6's uint8 pairings (cj, cs, self-guided, joint_reps) at their largest
# radius, and cj = 1 standing for three channels
K6_U8_EDGES = [(3, 3, True, 1), (3, 1, False, 1), (3, 3, False, 1),
               (1, 1, False, 3), (1, 3, False, 3)]


@pytest.mark.parametrize("cj,cs,self_guided,reps", K6_U8_EDGES)
def test_bilateral_joint_u8_at_max_radius(dev, cj, cs, self_guided, reps):
    """K6's uint8 form at max_radius (its shared memory at the block's
    limit; the frame smaller than the radius, so reflection repeats) and
    at radius 33 on a frame with ragged tiles in both directions, against
    the plain table form: within 1 uint8 level, equal on >= 99.9%; one
    radius more raises before any launch."""
    rng = np.random.RandomState(9)
    r_max = k6.max_radius(cj, cs, self_guided, True)
    assert r_max >= 33
    fn = (k6.bilateral_color_self_batched if self_guided
          else k6.bilateral_packed_joint_batched)
    for (n, h, w), radius in (((1, 40, 52), r_max), ((2, 70, 150), 33)):
        joint = torch.from_numpy(rng.randint(0, 256, (n, cj, h, w)).astype(
            np.float32)).to(dev)
        src = joint if self_guided else torch.from_numpy(rng.randint(
            0, 256, (n, cs, h, w)).astype(np.float32)).to(dev)
        args = (joint,) if self_guided else (joint, src)
        kwargs = {} if self_guided else {"joint_reps": reps}
        before = fn.launches
        got = fn(*args, 2 * radius + 1, 20.0, 22.0, **kwargs)
        assert fn.launches == before + 1
        _, gcc, gsc = k6.opencv_bilateral_coeffs(2 * radius + 1, 20.0, 22.0)
        exp = k6.bilateral_joint_plain(joint, src, radius, gcc, gsc, reps,
                                       u8=True)
        d = (torch.round(got) - torch.round(exp)).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
        assert (got - exp).abs().max().item() <= 1e-3
    with pytest.raises(ValueError, match="largest radius .* is {}".format(
            r_max)):
        fn(*args, 2 * r_max + 3, 20.0, 22.0, **kwargs)


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


def test_gather_kernel_one_allocation_and_failed_launch(dev, monkeypatch):
    """K3's two outputs are the two rows of one allocation; a launch whose
    entry point reports an error still raises, with the CUDA error's
    text."""
    from reflectance_filtering_tpu_torch.ops import _build
    g = torch.Generator(device=dev).manual_seed(3)
    plane = torch.rand(2, 16, 24, device=dev, generator=g)
    idx = [torch.randint(0, n, (2, 50), device=dev, dtype=torch.int32,
                         generator=g) for n in (16, 24, 16, 24)]
    l1, l2 = gather_pairs(plane, *idx)
    assert l1._base is not None and l1._base is l2._base
    assert l2.data_ptr() == l1.data_ptr() + 4 * l1.numel()
    _build.lib()
    monkeypatch.setitem(_build._fns, "rf_whdr_gather",
                        lambda *args: 1)      # cudaErrorInvalidValue
    before = gather_pairs.launches
    with pytest.raises(RuntimeError, match="rf_whdr_gather failed: CUDA "
                                           "error 1"):
        gather_pairs(plane, *idx)
    assert gather_pairs.launches == before


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


def _within_gate(got, exp):
    """rtol 1e-3 / atol 0.05 in float, within 1 uint8 level after rint."""
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    return (d.max().item() <= 1
            and torch.allclose(got, exp, rtol=1e-3, atol=0.05))


@pytest.mark.parametrize("n,c,h,w,radius", [
    (2, 1, 64, 96, 45), (1, 3, 41, 53, 8), (1, 1, 12, 40, 45),
    (2, 2, 23, 31, 4), (1, 5, 37, 29, 6), (1, 1, 300, 257, 45)])
def test_guided_chain_kernel_matches_plain(dev, n, c, h, w, radius):
    """K9 against its plain versions on uint8-valued images: the 3x chain
    within the float and uint8 gates, and the guide statistics alone, each
    plane within 1e-3 of its largest magnitude (the plain box's float32
    rounding).  (12, 40) is narrower than the window; C=5 runs each
    application as two launches, each counted; stats once per chain."""
    rng = np.random.RandomState(9)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(n, c, h, w) * 256).astype(
        np.float32)).to(dev)
    before = (k9.guide_stats.launches, k9.guided_apply_cached.launches)
    got = k9.guided_filter_chain(g, s, radius, 3.0, 3)
    assert (k9.guide_stats.launches, k9.guided_apply_cached.launches) == (
        before[0] + 1, before[1] + 3 * -(-c // 3))
    assert _within_gate(got, k9.guided_filter_chain_plain(g, s, radius, 3.0,
                                                          3))
    st = k9.guide_stats(g, radius, 3.0)
    stp = k9.guide_stats_plain(g, radius, 3.0)
    for k in range(k9.STAT_PLANES):
        scale = stp[:, k].abs().max().item()
        assert (st[:, k] - stp[:, k]).abs().max().item() <= 1e-3 * scale, k
    # one application from the kernel's statistics
    one = k9.guided_apply_cached(st, g, s, radius)
    assert _within_gate(one, k9.guided_apply_cached_plain(st, g, s, radius))


def test_guided_filter_iterated_runs_k9(dev):
    """guided_filter_iterated(planar=True) on CUDA goes through K9 (stats
    once, one application per iteration), never K5, and is the chain."""
    rng = np.random.RandomState(10)
    g = torch.from_numpy(np.floor(rng.rand(1, 3, 48, 70) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(1, 1, 48, 70) * 256).astype(
        np.float32)).to(dev)
    before = (k9.guide_stats.launches, k9.guided_apply_cached.launches,
              guided_filter_fused.launches)
    got = guided_filter_iterated(g, s, 8, 3.0, 3, planar=True)
    assert (k9.guide_stats.launches, k9.guided_apply_cached.launches,
            guided_filter_fused.launches) == (before[0] + 1, before[1] + 3,
                                              before[2])
    assert torch.equal(got, k9.guided_filter_chain(g, s, 8, 3.0, 3))


def test_guided_chain_kernel_refuses_bad_shapes(dev):
    g = torch.zeros(1, 3, 8, 8, device=dev)
    st = k9.guide_stats(g, 2, 3.0)
    with pytest.raises(ValueError):
        k9.guided_apply_cached(st, g, torch.zeros(2, 1, 8, 8, device=dev), 2)
    with pytest.raises(ValueError, match="share a device"):
        k9.guided_apply_cached(st, g, torch.zeros(1, 1, 8, 8), 2)
    with pytest.raises(ValueError, match="grid limit"):
        k9.guide_stats(torch.zeros(1, 3, 70000, 1, device=dev), 2, 3.0)
    big = torch.zeros(6000, 3, 1, 1, device=dev)
    with pytest.raises(ValueError, match="grid limit"):
        k9.guided_apply_cached(torch.zeros(6000, 9, 1, 1, device=dev), big,
                               torch.zeros(6000, 3, 1, 1, device=dev), 2)


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
# widest filters and the most input/output channels fits_fused_trunk admits,
# and the widest trunk at the flagship's depth over many tiles a block (its
# dz and activations in the workspace, its dW summed per tile into the row)
K7_CASES = [((5, 3, 32, 1), 3 * 4099), ((2, 3, 16, 1), 37 * 53),
            ((1, 3, 32, 1), 1000), ((2, 3, 128, 1), 2 * 48 * 64),
            ((3, 3, 16, 6), 37 * 53), ((3, 8, 256, 8), 777),
            ((2, 5, 40, 3), 129), ((1, 1, 8, 1), 5),
            ((5, 3, 256, 1), 4 * 96 * 128)]


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


@pytest.mark.parametrize("shape,p", [((5, 3, 32, 1), 4 * 96 * 128),
                                     ((2, 5, 40, 3), 129),
                                     ((3, 8, 256, 8), 777)])
def test_backward_variants_match_plain(dev, shape, p):
    """K7's timing variants (TPU kernel 19): the full one bitwise equal to
    the product backward, the others within 2e-4 of each leaf's max of
    their plain versions, the block sum alone bitwise equal to the rows
    the last launch left summed in order (the wide trunk keeps its
    activations in the workspace instead of shared memory)."""
    x, cot, flat = _k7_inputs(dev, shape, p, seed=4)
    work = k7.backward_workspace(x, shape)
    product, _ = k7.trunk_backward(x, cot, flat, shape, False)
    before = k7.trunk_backward_variant.launches
    for variant in range(5):
        got = k7.trunk_backward_variant(x, cot, flat, shape, variant, work)
        if variant == 0:
            assert torch.equal(got, product)
        want = k7.trunk_backward_variant_plain(x, cot, flat, shape, variant)
        for part in (0, 1):
            for a, b in zip(k7.unpack(got, shape)[part],
                            k7.unpack(want, shape)[part]):
                assert (a - b).abs().max().item() <= (
                    2e-4 * b.abs().max().item()), (variant, part)
    summed = k7.trunk_backward_variant(x, cot, flat, shape, 5, work)
    assert torch.equal(summed, k7.block_sum_plain(work, shape))
    assert torch.equal(summed, got)    # the rows variant 4 left
    assert k7.trunk_backward_variant.launches == before + 6
    with pytest.raises(ValueError, match="work"):
        k7.trunk_backward_variant(x, cot, flat, shape, 5, work[:1])


def test_cascade_through_apply_network(dev):
    """cascadeSkipLayers on the card: both levels' trunks run K7 (two
    forward and two backward launches, the level-1 backward with the input
    cotangent that carries the loss back to level 0), and every gradient,
    level 0's included, matches the plain per-layer path on the card
    within 2e-4 of its leaf's max."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, apply_network, init_network)
    cfg = NetworkConfig(network_type="cascadeSkipLayers", num_layers=3,
                        num_filters_log=4, rs_est_mode="rRelMax")
    params = init_network(cfg, torch.Generator().manual_seed(2), dev)
    leaves = [t.requires_grad_() for layer in params.values()
              for t in layer.values()]
    imgs = torch.rand(2, 40, 56, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    grads = {}
    for kernels in (True, False):
        before = (k7.trunk_forward.launches, k7.trunk_backward.launches,
                  k7.trunk_backward.dx_launches)
        blobs = apply_network(params, imgs, cfg, train=True, kernels=kernels)
        loss = (blobs["RS_est"] ** 2).sum()
        grads[kernels] = torch.autograd.grad(loss, leaves)
        after = (k7.trunk_forward.launches, k7.trunk_backward.launches,
                 k7.trunk_backward.dx_launches)
        assert after == ((before[0] + 2, before[1] + 2, before[2] + 1)
                         if kernels else before)
    names = [(name, part) for name, layer in params.items() for part in layer]
    for (name, part), a, b in zip(names, grads[True], grads[False]):
        assert b.abs().max().item() > 0, (name, part)
        assert (a - b).abs().max().item() <= 2e-4 * b.abs().max().item(), (
            name, part)


@pytest.mark.parametrize("batch", [1, 33])
@pytest.mark.parametrize("hw", [1, 255, 4099, 65536])
@pytest.mark.parametrize("srgb_input", [True, False])
def test_cnn_kernel_3xtf32_shapes_and_repeat(dev, batch, hw, srgb_input):
    """K1 on the tensor cores (3xTF32) at ragged and whole 32-pixel steps,
    one image and more images than one wave of the persistent grid takes
    at once: within 1e-5 of its plain version, <= 1 level of floor(r *
    255), and bitwise equal on a second launch."""
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(seeded_reference_params(6)))
    w = pack_weights(net.to(dev))
    x = torch.rand(batch, 3, hw, device=dev, generator=torch.Generator(
        device=dev).manual_seed(hw + batch))
    before = reflectance_cnn.launches
    got = reflectance_cnn(x, w, srgb_input=srgb_input)
    again = reflectance_cnn(x, w, srgb_input=srgb_input)
    assert reflectance_cnn.launches == before + 2
    exp = reflectance_cnn_plain(x, w, srgb_input=srgb_input)
    assert got.shape == (batch, hw)
    assert (got - exp).abs().max().item() <= 1e-5
    assert (torch.floor(got * 255) - torch.floor(exp * 255)).abs().max() <= 1
    assert torch.equal(got, again)


# (n, c, h, w, radius): runs of 33 outputs and row blocks of 1056 columns
# cut at other widths, windows wider than the frame (a run's window
# reflects at both borders), r = 0 and 1, C = 1, 2, 3; radii whose
# leaving and entering taps are staged apart (2r + 1 > the block's
# columns), and whose staging narrows the block to fit its shared memory
# (K5's 21 planes at C = 3: 29 runs at r = 200, 20 at r = 1300)
ROW_PASS_CASES = [(1, 1, 12, 40, 45), (1, 2, 12, 40, 0), (1, 3, 12, 40, 100),
                  (2, 1, 17, 1057, 45), (1, 2, 9, 2113, 1),
                  (1, 3, 5, 1100, 100), (1, 1, 33, 67, 0),
                  (2, 3, 7, 1056, 45), (1, 1, 3, 250, 100),
                  (1, 3, 480, 512, 200), (1, 3, 12, 40, 300),
                  (1, 3, 6, 1100, 200), (1, 3, 5, 1100, 1300),
                  (1, 1, 4, 2200, 700)]


@pytest.mark.parametrize("n,c,h,w,radius", ROW_PASS_CASES)
def test_sliding_row_passes_match_plain(dev, n, c, h, w, radius):
    """K9's chain and K5 on the sliding row passes against their plain
    versions in float64 (the chain's float and uint8 gate; the statistics
    within 1e-3 of each plane's largest magnitude; K5 within 1 uint8 level
    and 0.05), each launched twice and held bitwise equal.  The reference
    is float64 because at r = 1 the plain float32 box's block partials
    (up to 512 x 255^2) swamp a 3x3 window's moments: 0.2 off after three
    iterations on these inputs, where the kernel's float64 sums stay within
    the gate."""
    rng = np.random.RandomState(12)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(n, c, h, w) * 256).astype(
        np.float32)).to(dev)
    g64, s64 = g.double(), s.double()
    chain = k9.guided_filter_chain(g, s, radius, 3.0, 3)
    assert torch.equal(chain, k9.guided_filter_chain(g, s, radius, 3.0, 3))
    assert _within_gate(chain, k9.guided_filter_chain_plain(
        g64, s64, radius, 3.0, 3).float())
    st = k9.guide_stats(g, radius, 3.0)
    stp = k9.guide_stats_plain(g64, radius, 3.0)
    for k in range(k9.STAT_PLANES):
        scale = stp[:, k].abs().max().item()
        assert (st[:, k] - stp[:, k]).abs().max().item() <= 1e-3 * scale, k
    got = guided_filter_fused(g, s, radius, 3.0)
    assert torch.equal(got, guided_filter_fused(g, s, radius, 3.0))
    exp = guided_filter_fused_plain(g64, s64, radius, 3.0).float()
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    assert d.max().item() <= 1 and (got - exp).abs().max().item() <= 0.05


def test_chain_passes_alone_are_the_entry_points(dev):
    """rf_guided_chain_pass (the passes timed apart): passes 0-5 at the
    product's segment are bitwise the two entry points; at the other
    segments tried within 1e-3; a pass or segment out of range raises."""
    from reflectance_filtering_tpu_torch.scripts import measure_k9_passes
    buf = measure_k9_passes.make_buffers(dev, 3, 300, 1500)
    stats = k9.guide_stats(buf["guide"], measure_k9_passes.RADIUS,
                           measure_k9_passes.EPS)
    want = k9.guided_apply_cached(stats, buf["guide"], buf["src"],
                                  measure_k9_passes.RADIUS)
    for seg in measure_k9_passes.SEGS:
        for p in range(6):
            measure_k9_passes.run_pass(p, seg, buf)
        if seg == 0:                     # the product's segments
            assert torch.equal(buf["stats"], stats)
            assert torch.equal(buf["out"], want)
        assert (buf["out"] - want).abs().max().item() <= 1e-3
    for p, seg in ((6, 32), (0, -1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            measure_k9_passes.run_pass(p, seg, buf)
