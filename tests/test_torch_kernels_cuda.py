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
    """Radius 120 runs (in bands); only a radius past the banded kernel's
    reach (float32: 1,783, not one disk row of a tile fits a block) is
    refused, before any launch."""
    from reflectance_filtering_tpu_torch.ops import bilateral_kernel as k2
    x = torch.zeros(1, 8, 8, device=dev)
    assert torch.equal(bilateral_gray_self(x, -1, 20.0, 80.0), x)
    before = bilateral_gray_self.launches
    assert k2.band_rows(False, 1784) == 0
    with pytest.raises(ValueError, match="radius 1784"):
        bilateral_gray_self(x, 2 * 1784 + 1, 20.0, 80.0)
    assert bilateral_gray_self.launches == before


@pytest.mark.parametrize("u8", [True, False])
def test_bilateral_kernel_in_bands_at_radius_120(dev, u8):
    """K2 at sigma_s 80 (radius 120, past the one-band kernel's 113 for
    uint8 and 100 for float32: the disk's rows in bands) on 1 x 192x256
    against its plain version, whose float32 sums run in the kernel's tap
    order: within 1e-3, 1 uint8 level, equal on >= 99.9%."""
    from reflectance_filtering_tpu_torch.ops import bilateral_kernel as k2
    assert k2.smem_bytes(u8, 120) > k2.SMEM_LIMIT
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randint(0, 256, size=(1, 192, 256)).astype(
        np.uint8 if u8 else np.float32)).to(dev)
    before = bilateral_gray_self.launches
    got = bilateral_gray_self(x, -1, 20.0, 80.0)
    assert bilateral_gray_self.launches == before + 1
    exp = bilateral_gray_self_plain(x, -1, 20.0, 80.0)
    d = (torch.round(got) - torch.round(exp)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 1e-3


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
    """K6's uint8 form at its one-band kernel's largest radius (shared
    memory at the block's limit; the frame smaller than the radius, so
    reflection repeats), one radius more (the banded kernel), and radius
    33 on a frame with ragged tiles in both directions, against the plain
    table form: within 1 uint8 level, equal on >= 99.9%, 1e-3 in float."""
    rng = np.random.RandomState(9)
    r_one = k6.one_band_radius(cj, cs, self_guided, True)
    assert r_one >= 33
    fn = (k6.bilateral_color_self_batched if self_guided
          else k6.bilateral_packed_joint_batched)
    for (n, h, w), radius in (((1, 40, 52), r_one), ((1, 40, 52), r_one + 1),
                              ((2, 70, 150), 33)):
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


@pytest.mark.parametrize("cj,cs", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_bilateral_joint_float_at_max_radius(dev, cj, cs):
    """K6's float form at its one-band kernel's largest radius (shared
    memory at the block's limit; the frame smaller than the radius, so
    reflection repeats), one radius more (the banded kernel), and radius
    33 on a frame with ragged tiles in both directions, on non-integer
    values, against the plain exp form: within 1 uint8 level, equal on >=
    99.9%, 1e-3 in float; past radius 33 against the plain version in
    float64 (the float32 one's running sums over the disk, 16,757 taps at
    radius 73, drift by ~1e-3 themselves)."""
    rng = np.random.RandomState(10)
    r_one = k6.one_band_radius(cj, cs, False, False)
    assert r_one >= {(1, 1): 73, (1, 3): 48, (3, 1): 48, (3, 3): 37}[cj, cs]
    fn = k6.joint_bilateral_planar_batched
    for (n, h, w), radius in (((1, 40, 52), r_one), ((1, 40, 52), r_one + 1),
                              ((2, 70, 150), 33)):
        joint, src = (torch.from_numpy((rng.rand(n, c, h, w) * 255).astype(
            np.float32)).to(dev) for c in (cj, cs))
        before = fn.launches
        got = fn(joint, src, 2 * radius + 1, 20.0, 22.0)
        assert fn.launches == before + 1
        _, gcc, gsc = k6.opencv_bilateral_coeffs(2 * radius + 1, 20.0, 22.0)
        if radius > 33:
            exp = k6.bilateral_joint_plain(joint.double(), src.double(),
                                           radius, gcc, gsc).float()
        else:
            exp = k6.bilateral_joint_plain(joint, src, radius, gcc, gsc)
        d = (torch.round(got) - torch.round(exp)).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
        assert (got - exp).abs().max().item() <= 1e-3


@pytest.mark.parametrize("cj,cs,self_guided,u8", K6_INSTANCES)
def test_bilateral_joint_in_bands_at_radius_120(dev, cj, cs, self_guided,
                                                u8):
    """Every instantiation of K6 at sigma_s 80 (radius 120, past every
    one-band kernel: the disk's rows in bands) on 1 x 192x256 against its
    plain version: within 1 uint8 level, equal on >= 99.9%, and 1e-3 in
    float (the uint8 form against the float32 plain version, which sums in
    its order; the float form against the float64 one)."""
    assert k6.band_rows(cj, cs, self_guided, u8, 120) < 241
    rng = np.random.RandomState(13)

    def planes(c):
        v = rng.rand(1, c, 192, 256) * 255
        return torch.from_numpy((np.floor(v * 256 / 255) if u8 else v)
                                .astype(np.float32)).to(dev)

    joint = planes(cj)
    src = joint if self_guided else planes(cs)
    if self_guided:
        fn, args = k6.bilateral_color_self_batched, (joint,)
    elif u8:
        fn, args = k6.bilateral_packed_joint_batched, (joint, src)
    else:
        fn, args = k6.joint_bilateral_planar_batched, (joint, src)
    before = fn.launches
    got = fn(*args, -1, 20.0, 80.0)
    assert fn.launches == before + 1
    radius, gcc, gsc, _ = opencv_bilateral_params(-1, 20.0, 80.0)
    assert radius == 120
    if u8:
        exp = k6.bilateral_joint_plain(joint, src, radius, gcc, gsc, 1, True)
    else:
        exp = k6.bilateral_joint_plain(joint.double(), src.double(), radius,
                                       gcc, gsc).float()
    d = (torch.round(got) - torch.round(exp)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 1e-3


def test_bilateral_joint_kernel_refuses_too_large_a_radius(dev):
    """Float 3 + 3 planes at sigma_s 30 (radius 45, past the one-band
    kernel's 37) run in bands; only a radius past the banded kernel's
    reach (287: not one disk row of the 16 x 32 tile fits a block) is
    refused, with a ValueError before any launch."""
    x = torch.zeros(1, 3, 8, 8, device=dev)
    assert torch.equal(k6.joint_bilateral_planar_batched(x, x, -1, 20.0,
                                                         30.0), x)
    before = k6.joint_bilateral_planar_batched.launches
    with pytest.raises(ValueError, match="radius 287"):
        k6.joint_bilateral_planar_batched(x, x, 2 * 287 + 1, 20.0, 30.0)
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


# K5's shapes for both paths: the served gf batch, the golden fixtures'
# frames (96x128 at r = 3, 128x160 at r = 45 and 52, C = 1 and 3), and
# frames smaller than the window (reflection repeats; r = 300 on 12x40)
K5_PATH_CASES = [(32, 1, 256, 256, 45), (1, 1, 96, 128, 3),
                 (1, 3, 96, 128, 3), (1, 1, 128, 160, 45),
                 (1, 3, 128, 160, 52), (1, 1, 12, 40, 300),
                 (1, 3, 12, 40, 300), (2, 2, 37, 300, 20)]


@pytest.mark.parametrize("path", ["fused", "four-pass"])
@pytest.mark.parametrize("n,c,h,w,radius", K5_PATH_CASES)
def test_guided_kernel_paths_match_plain(dev, n, c, h, w, radius, path):
    """K5's fused pair and its four passes, each forced, against the plain
    version on uint8-valued images: within 1 uint8 level, equal on >=
    99.9%, 0.05 in float; past the frame (r = 300) against the plain
    version in float64, whose float32 box partials would swamp a window
    that wide.  The fused launches are counted apart."""
    rng = np.random.RandomState(14)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(n, c, h, w) * 256).astype(
        np.float32)).to(dev)
    before = (guided_filter_fused.launches,
              guided_filter_fused.fused_launches)
    got = guided_filter_fused(g, s, radius, 3.0, path=path)
    assert (guided_filter_fused.launches,
            guided_filter_fused.fused_launches) == (
                before[0] + 1, before[1] + (path == "fused"))
    if radius >= min(h, w):
        exp = guided_filter_fused_plain(g.double(), s.double(), radius,
                                        3.0).float()
    else:
        exp = guided_filter_fused_plain(g, s, radius, 3.0)
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 0.05


# The fused blocks' heights that the band rules choose among, on the
# served gf batch (scripts/measure_box_guided.py times each)
FUSED_BANDS = [8, 16, 32, 64]


@pytest.mark.parametrize("band", FUSED_BANDS)
@pytest.mark.parametrize("c", [1, 3])
def test_guided_kernel_fused_bands_match_plain(dev, c, band):
    """K5's fused pair at each band height, forced, on the served gf batch
    (32 x 256x256, r = 45) at C = 1 and 3, against the plain version:
    within 1 uint8 level, equal on >= 99.9%, 0.05 in float."""
    rng = np.random.RandomState(16)
    g = torch.from_numpy(np.floor(rng.rand(32, 3, 256, 256) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(32, c, 256, 256) * 256).astype(
        np.float32)).to(dev)
    before = guided_filter_fused.fused_launches
    got = guided_filter_fused(g, s, 45, 3.0, path="fused", band=band)
    assert guided_filter_fused.fused_launches == before + 1
    exp = guided_filter_fused_plain(g, s, 45, 3.0)
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 0.05


# (n, h, w) frames on each side of the width rule at r = 45, C = 1: wider
# frames at the served batch's pixel count, single frames (the guided CLI,
# the chain check), a frame taller than it is wide
K5_FRAMES = [(16, 256, 384), (16, 256, 512), (8, 512, 512), (1, 256, 256),
             (1, 341, 512), (1, 480, 512), (1, 1024, 512)]


@pytest.mark.parametrize("path", ["fused", "four-pass"])
@pytest.mark.parametrize("n,h,w", K5_FRAMES)
def test_guided_kernel_paths_on_frames_match_plain(dev, n, h, w, path):
    """K5's two paths, each forced, on frames up to the fused pair's widest
    (512 columns), against the plain version in float64: within 1 uint8
    level, equal on >= 99.9%, 0.05 in float."""
    from reflectance_filtering_tpu_torch.ops.guided_kernel import fused_fits
    assert fused_fits(1, w)
    rng = np.random.RandomState(17)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(n, 1, h, w) * 256)).to(dev)
    got = guided_filter_fused(g.float(), s.float(), 45, 3.0, path=path)
    exp = guided_filter_fused_plain(g, s, 45, 3.0).float()
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    assert (got - exp).abs().max().item() <= 0.05


@pytest.mark.parametrize("path", ["fused", "four-pass"])
def test_guided_golden_fixtures_by_path(dev, path):
    """Each path on the 12 color-guide golden fixtures
    (tests/fixtures/guided_golden.npz: a color guide over a gray or a
    color src at r = 3, 45, 52 and eps = 3, 7), after the product's
    rounding: within 1 uint8 level of every fixture.  (The 6 gray-guide
    fixtures take the scalar formulas over K4, not K5; chip_smoke.py
    phase 3b holds all 18 through guided_filter_u8.)"""
    import os
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "guided_golden.npz")
    golden = dict(np.load(fixture))
    for radius in (3, 45, 52):
        key = "small" if radius == 3 else "big"
        for eps in (3.0, 7.0):
            for kind in ("color", "colorsrc"):
                g_u8 = golden["img_{}_guide_color".format(key)]
                s_u8 = g_u8 if kind == "colorsrc" else golden[
                    "img_{}_src".format(key)]
                gp = torch.from_numpy(np.ascontiguousarray(
                    np.moveaxis(g_u8, -1, 0)[None])).to(dev).float()
                sa = np.moveaxis(s_u8, -1, 0) if s_u8.ndim == 3 \
                    else s_u8[None]
                sp = torch.from_numpy(np.ascontiguousarray(sa[None])).to(
                    dev).float()
                q = guided_filter_fused(gp, sp, radius, eps, path=path)
                got = torch.clamp(torch.round(q), 0, 255)[0].cpu().numpy()
                exp = golden["out_r{}_e{}_{}".format(radius, int(eps),
                                                     kind)]
                exp = np.moveaxis(exp, -1, 0) if exp.ndim == 3 \
                    else exp[None]
                assert np.abs(got.astype(int) - exp.astype(int)).max() \
                    <= 1, (radius, eps, kind)


@pytest.mark.parametrize("border", ["reflect", "reflect101"])
@pytest.mark.parametrize("shape,radius,path", [
    ((32, 256, 256), 45, "fused"), ((32, 256, 256), 45, "two-pass"),
    ((13, 64, 64), 11, "fused"), ((13, 64, 64), 11, "two-pass"),
    ((2, 20, 27), 45, "fused"), ((2, 20, 27), 45, "two-pass"),
    ((1, 5, 512), 3, "fused"), ((1, 5, 700), 3, "two-pass")])
def test_box_kernel_forms_match_plain(dev, shape, radius, path, border):
    """K4's fused form and its two passes, each forced (the fused form up
    to 512 columns), on the timed stack, the guided CLI's --subsample=4
    planes (13 of 64x64 at r = 11), a plane narrower than the window and
    rows at and past the fused form's widest, against the block-local
    float32 sliding sum: within 8 float32 ulps of its largest partial,
    scaled like the output."""
    rng = np.random.RandomState(15)
    x = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).to(dev)
    before = (box_filter_planar.launches, box_filter_planar.fused_launches)
    got = box_filter_planar(x, radius, border, path=path)
    assert (box_filter_planar.launches,
            box_filter_planar.fused_launches) == (
                before[0] + 1, before[1] + (path == "fused"))
    exp = box_filter_planar_plain(x, radius, border)
    w = 2 * radius + 1
    partial = min(max(shape[1:]) + 2 * radius, 512) * w * 255.0
    assert (got - exp).abs().max().item() <= 8 * 2.0 ** -24 * partial / (w * w)


@pytest.mark.parametrize("band", FUSED_BANDS)
def test_box_kernel_fused_bands_match_plain(dev, band):
    """K4's fused form at each band height, forced, on its timed stack
    ([32, 256, 256], r = 45), against the block-local float32 sliding sum:
    within 8 float32 ulps of its largest partial, scaled like the
    output."""
    rng = np.random.RandomState(18)
    x = torch.from_numpy((rng.rand(32, 256, 256) * 255).astype(
        np.float32)).to(dev)
    before = box_filter_planar.fused_launches
    got = box_filter_planar(x, 45, path="fused", band=band)
    assert box_filter_planar.fused_launches == before + 1
    exp = box_filter_planar_plain(x, 45)
    partial = (256 + 90) * 91 * 255.0
    assert (got - exp).abs().max().item() <= 8 * 2.0 ** -24 * partial / 91**2


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
    """K7 forward against the plain trunk (1e-5 relative) through the
    kernel its shape takes (counted on the tensor cores for the shapes
    forward_on_tensor_cores admits), its backward against plain autograd:
    each parameter gradient within 2e-4 of its leaf's max (the JAX
    package's gate for its fused trunk), dx within 5e-5; two backward
    launches bitwise equal; input_grad=False leaves the parameter gradient
    bitwise unchanged."""
    x, cot, flat = _k7_inputs(dev, shape, p)
    before = (k7.trunk_forward.launches, k7.trunk_backward.launches)
    tc_before = k7.trunk_forward.tensor_core_launches
    pre = k7.trunk_forward(x, flat, shape)
    assert k7.trunk_forward.tensor_core_launches == tc_before + int(
        k7.forward_on_tensor_cores(shape))
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


def test_trunk_forward_cases_take_both_kernels(dev):
    """K7_CASES reach both forward kernels: the tensor cores' for the
    flagship and the narrow trunks, the FP32 one for the wide trunks; the
    forward is bitwise repeatable on each."""
    kinds = set()
    for shape, p in K7_CASES:
        x, _, flat = _k7_inputs(dev, shape, p, seed=5)
        before = k7.trunk_forward.tensor_core_launches
        pre = k7.trunk_forward(x, flat, shape)
        kinds.add(k7.trunk_forward.tensor_core_launches - before)
        assert torch.equal(pre, k7.trunk_forward(x, flat, shape))
    assert kinds == {0, 1}
    assert k7.forward_on_tensor_cores(K7_CASES[0][0])


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


def _scatter_inputs(dev, b, h, w, k):
    g = torch.Generator(device=dev).manual_seed(3)
    idx = [torch.randint(0, n, (b, k), device=dev, dtype=torch.int32,
                         generator=g) for n in (h, w, h, w)]
    g1, g2 = (torch.randn(b, k, device=dev, generator=g) for _ in range(2))
    return idx, g1, g2


@pytest.mark.parametrize("b,h,w,k", [(20, 256, 256, 1181), (2, 3, 3, 1500),
                                     (3, 17, 9, 1), (2, 40, 30, 9000)])
def test_scatter_kernel_matches_index_put(dev, b, h, w, k):
    """K8 against index_put_(accumulate=True), collisions forced by small
    planes: within 1e-6 of the largest value, bitwise equal on a second
    launch.  K = 9000 (18,000 points an image) is above the sort path's
    limit: the quadratic search runs."""
    idx, g1, g2 = _scatter_inputs(dev, b, h, w, k)
    before = scatter_pairs.launches
    got = scatter_pairs((b, h, w), *idx, g1, g2)
    assert scatter_pairs.launches == before + 1
    want = scatter_pairs_plain((b, h, w), *idx, g1, g2)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    assert torch.equal(got, scatter_pairs((b, h, w), *idx, g1, g2))


@pytest.mark.parametrize("b,h,w,k", [(20, 256, 256, 1181), (2, 3, 3, 1500),
                                     (3, 17, 9, 1), (1, 2048, 2048, 600),
                                     (4, 2048, 2048, 1181),
                                     (1, 1024, 1024, 2048),
                                     (2, 256, 256, 8000),
                                     (2, 64, 64, 8192)])
def test_scatter_sort_path_equals_quadratic(dev, b, h, w, k):
    """K8's sort path bitwise equal to its quadratic search: the same
    cotangents summed in the same order.  2048 x 2048 at K = 600 and 1181
    needs the 64-bit key; 1024 x 1024 at K = 2048 too, at 4,096 keys a
    block, whose shared memory is just above 48 KB; K = 8000 at 256 x 256
    (16 keys a thread) and K = 8192, the largest K the sort path takes."""
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        _scatter_quadratic, sort_path)
    assert sort_path(k)
    idx, g1, g2 = _scatter_inputs(dev, b, h, w, k)
    got = scatter_pairs((b, h, w), *idx, g1, g2)
    want = _scatter_quadratic((b, h, w), *idx, g1, g2)
    assert torch.equal(got, want)


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


# (n, c, h, w, radius) for the streamed column pass: the 4K frame at C = 1
# and C = 3 (its moment pass past the ring that holds the window: the
# leaving rows streamed again), frames shorter than the window, widths
# that are not a multiple of the 32-column strip (nor of 4: each lane
# copies its own column), radii wider than the frame, n > 1, r = 0 and 1
COLUMN_PASS_CASES = [(1, 1, 2160, 3840, 45), (1, 3, 2160, 3840, 45),
                     (2, 1, 50, 96, 45), (1, 2, 37, 45, 20),
                     (3, 1, 130, 70, 45), (1, 1, 12, 40, 100),
                     (1, 3, 9, 33, 60), (2, 2, 64, 100, 1),
                     (1, 1, 33, 64, 0)]


@pytest.mark.parametrize("n,c,h,w,radius", COLUMN_PASS_CASES)
def test_column_pass_streams_match_plain(dev, n, c, h, w, radius):
    """K9's two entry points on the streamed column pass against their
    plain versions in float64: the statistics within 1e-3 of each plane's
    largest magnitude, one application from the kernel's statistics
    within the chain's float and uint8 gate, each launched twice and held
    bitwise equal."""
    rng = np.random.RandomState(21)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(n, c, h, w) * 256).astype(
        np.float32)).to(dev)
    g64, s64 = g.double(), s.double()
    st = k9.guide_stats(g, radius, 3.0)
    assert torch.equal(st, k9.guide_stats(g, radius, 3.0))
    stp = k9.guide_stats_plain(g64, radius, 3.0)
    for k in range(k9.STAT_PLANES):
        scale = stp[:, k].abs().max().item()
        assert (st[:, k] - stp[:, k]).abs().max().item() <= 1e-3 * scale, k
    del stp
    one = k9.guided_apply_cached(st, g, s, radius)
    assert torch.equal(one, k9.guided_apply_cached(st, g, s, radius))
    assert _within_gate(one, k9.guided_apply_cached_plain(
        st.double(), g64, s64, radius).float())


def test_column_pass_serves_k4_and_k5(dev):
    """K4's two passes (rows past the fused form's 512) and K5's four
    passes take the same streamed column pass: against their plain
    versions in float64, K4 within 8 float32 ulps of its window sum's
    bound and K5 within 1 uint8 level and 0.05."""
    rng = np.random.RandomState(22)
    x = torch.from_numpy((rng.rand(3, 70, 700) * 255).astype(
        np.float32)).to(dev)
    got = box_filter_planar(x, 45, "reflect101", path="two-pass")
    exp = box_filter_planar_plain(x.double(), 45, "reflect101").float()
    assert (got - exp).abs().max().item() <= 8 * 2.0 ** -24 * 255
    g = torch.from_numpy(np.floor(rng.rand(2, 3, 150, 610) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(2, 2, 150, 610) * 256).astype(
        np.float32)).to(dev)
    got = guided_filter_fused(g, s, 45, 3.0, path="four-pass")
    exp = guided_filter_fused_plain(g.double(), s.double(), 45, 3.0).float()
    d = (torch.round(got).clamp(0, 255) - torch.round(exp).clamp(0, 255)).abs()
    assert d.max().item() <= 1 and (got - exp).abs().max().item() <= 0.05


def test_chain_passes_alone_are_the_entry_points(dev):
    """rf_guided_chain_pass (the passes timed apart): the fused pairs
    (passes 6-8) at their plan's segments are bitwise the two entry points
    (which take them at this shape), and within 1e-3 at the other segments
    tried; the six passes (0-5) within 1e-3 at every segment tried, and
    bitwise the entry points at a radius past the fused kernels' (r = 300,
    where the entry points run them); a pass or segment out of range, or a
    fused pass at that radius, raises."""
    from reflectance_filtering_tpu_torch.scripts import measure_k9_passes
    mk = measure_k9_passes
    buf = mk.make_buffers(dev, 3, 300, 1500)
    for seg in mk.FUSED_SEGS:
        err = mk.run_route(mk.FUSED_PASSES, seg, buf)
        if seg == 0:                     # the product's segments
            assert torch.equal(buf["stats"], buf["want_stats"])
            assert torch.equal(buf["out"], buf["want_out"])
        assert err <= 1e-3
    for seg in mk.SEGS:
        assert mk.run_route(range(6), seg, buf) <= 1e-3
    big = 300
    assert not k9.fused_route(dev, 0, 1, 1, 300, 1500, big)
    assert not k9.fused_route(dev, 1, 1, 1, 300, 1500, big)
    mk.run_route(range(6), 0, buf, big)
    assert torch.equal(buf["stats"], buf["want_stats"])
    assert torch.equal(buf["out"], buf["want_out"])
    for p, seg, radius in ((9, 32, 45), (0, -1, 45), (6, 0, big)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            mk.run_pass(p, seg, buf, radius)


# (n, c, h, w, radius) for K9's fused pairs: widths that are a multiple of
# neither a block's columns nor a cluster's tile (several tiles and
# clusters, their edges), frames narrower than the window and radii wider
# than the frame, n > 1, r = 0 and 1, C = 1, 2, 3, the 4K frame at
# C = 1 and 3, and the 8K frame, whose plan cuts other segments
FUSED_CASES = [(1, 1, 70, 1001, 45), (2, 2, 50, 96, 45),
               (1, 3, 41, 2050, 20), (1, 1, 12, 40, 45), (1, 2, 37, 45, 60),
               (1, 1, 130, 700, 1), (1, 3, 33, 64, 0), (3, 1, 64, 300, 8),
               (1, 1, 2160, 3840, 45), (1, 3, 2160, 3840, 45),
               (1, 1, 4320, 7680, 45)]


@pytest.mark.parametrize("n,c,h,w,radius", FUSED_CASES)
def test_fused_pairs_match_plain(dev, n, c, h, w, radius):
    """K9's fused pairs (the route their plans take at these shapes,
    counted on .fused) against the plain versions in float64: the
    statistics within 1e-3 of each plane's largest magnitude, one
    application from the kernel's statistics within the chain's float and
    uint8 gate, each launched twice and held bitwise equal."""
    rng = np.random.RandomState(23)
    g = torch.from_numpy(np.floor(rng.rand(n, 3, h, w) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy((rng.rand(n, c, h, w) * 255).astype(
        np.float32)).to(dev)
    groups = [min(3, c - i) for i in range(0, c, 3)]
    assert k9.fused_route(dev, 0, 1, n, h, w, radius)
    assert all(k9.fused_route(dev, 1, k, n, h, w, radius) for k in groups)
    before = (k9.guide_stats.fused, k9.guided_apply_cached.fused)
    st = k9.guide_stats(g, radius, 3.0)
    assert torch.equal(st, k9.guide_stats(g, radius, 3.0))
    one = k9.guided_apply_cached(st, g, s, radius)
    assert torch.equal(one, k9.guided_apply_cached(st, g, s, radius))
    assert (k9.guide_stats.fused, k9.guided_apply_cached.fused) == (
        before[0] + 2, before[1] + 2 * len(groups))
    g64 = g.double()
    stp = k9.guide_stats_plain(g64, radius, 3.0)
    for k in range(k9.STAT_PLANES):
        scale = stp[:, k].abs().max().item()
        assert (st[:, k] - stp[:, k]).abs().max().item() <= 1e-3 * scale, k
    del stp
    assert _within_gate(one, k9.guided_apply_cached_plain(
        st.double(), g64, s.double(), radius).float())


def test_fused_route_by_shape(dev):
    """The route is the shape's: the 4K frame (r = 45, C = 1) has a plan
    for each fused pair and takes them; at a radius past what a block's
    ring and bands hold (r = 300) the statistics and the applications run
    the six passes (counted on .launches, not on .fused), within the
    chain's gate of the plain chain in float64."""
    assert all(k9.fused_plan(dev, p, 1, 1, 2160, 3840, 45)["ok"]
               for p in (6, 7, 8))
    assert k9.fused_route(dev, 0, 1, 1, 2160, 3840, 45)
    assert k9.fused_route(dev, 1, 1, 1, 2160, 3840, 45)
    rng = np.random.RandomState(24)
    g = torch.from_numpy(np.floor(rng.rand(1, 3, 40, 700) * 256).astype(
        np.float32)).to(dev)
    s = torch.from_numpy(np.floor(rng.rand(1, 1, 40, 700) * 256).astype(
        np.float32)).to(dev)
    assert not k9.fused_route(dev, 0, 1, 1, 40, 700, 300)
    assert not k9.fused_route(dev, 1, 1, 1, 40, 700, 300)
    counters = (k9.guide_stats, k9.guided_apply_cached)
    before = [(f.launches, f.fused) for f in counters]
    chain = k9.guided_filter_chain(g, s, 300, 3.0, 3)
    assert [(f.launches, f.fused) for f in counters] == [
        (before[0][0] + 1, before[0][1]), (before[1][0] + 3, before[1][1])]
    assert _within_gate(chain, k9.guided_filter_chain_plain(
        g.double(), s.double(), 300, 3.0, 3).float())


def test_train_cli_decompose_on_cuda_matches_cpu(dev, tmp_path):
    """The train CLI's ``--stage=predict --decompose`` of the flagship's
    trunk (5 layers of 32 1x1 filters, rDirectly) on cuda, through K7's
    forward, against ``--device cpu`` on the same seeded checkpoint and
    files: every PNG within 1 uint8 level, the npz arrays within 1e-4."""
    import os

    import cv2

    from reflectance_filtering_tpu_torch.cli.train import main
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.train.checkpoint import (
        save_checkpoint)
    rng = np.random.RandomState(9)
    ckpt = str(tmp_path / "seeded.npz")
    save_checkpoint(ckpt, init_network(NetworkConfig(),
                                       torch.Generator().manual_seed(9)))
    flags = ["--networkType=convStaticSkipLayers", "--numLayers=5",
             "--num_filters_log=5", "--kernel_pad=0",
             "--RS_est_mode=rDirectly"]
    images = [(rng.rand(40, 56, 3) * 255).astype(np.uint8) for _ in range(3)]
    stack = (rng.rand(2, 16, 16, 3) * 255).astype(np.uint8)
    res = {}
    for device in ("cuda", "cpu"):
        folder = tmp_path / device
        folder.mkdir()
        for i, img in enumerate(images):
            cv2.imwrite(str(folder / "p{}.png".format(i)), img)
        np.savez(str(folder / "s.npz"), images=stack)
        before = k7.trunk_forward.launches
        main(["--stage=predict", "--predictCaffemodel", ckpt, "--decompose",
              str(folder), "--experiment=d", "--data_root",
              str(tmp_path / "none"), "--results_root",
              str(tmp_path / ("res_" + device)), "--device", device] + flags)
        launched = k7.trunk_forward.launches - before
        # cuda: one batch of photos and the npz stack twice
        assert launched == (3 if device == "cuda" else 0)
        res[device] = (str(folder), str(tmp_path / ("res_" + device) / "d"))
    for sub in ("decompositions_linear", "decompositions_sRGB"):
        names = sorted(n for n in os.listdir(os.path.join(res["cpu"][1], sub))
                       if n.endswith(".png"))
        assert len(names) == 9
        for name in names:
            a = cv2.imread(os.path.join(res["cuda"][1], sub, name))
            b = cv2.imread(os.path.join(res["cpu"][1], sub, name))
            assert np.abs(a.astype(int) - b).max() <= 1, (sub, name)
    with np.load(os.path.join(res["cuda"][0], "s_decomposed.npz")) as g, \
            np.load(os.path.join(res["cpu"][0], "s_decomposed.npz")) as w:
        for key in w.files:
            assert np.abs(g[key].astype(np.float64) - w[key]).max() <= 1e-4


def test_k8_measurement_script_runs(dev):
    """scripts/measure_k8.py on two small cases: both paths bitwise equal
    (it raises otherwise), every time positive."""
    from reflectance_filtering_tpu_torch.scripts import measure_k8
    cases = {"spread": (2, 17, 9, 300, False), "crowded": (2, 40, 30, 900,
                                                             True)}
    out = measure_k8.measure(measure_k8.make_inputs(dev, 1, cases))
    for r in out.values():
        assert all(ms > 0 for ms in r["wrapper"].values())
        assert all(r["device"][path]["kernel"] > 0 for path in ("sort",
                                                                "quadratic"))


SHARDED = ["box", "joint", "joint_u8", "gray_self", "color_self", "guided",
           "chain"]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_filter_world_one_matches_kernel(dev, name):
    """Each width-sharded filter on a mesh of one (no group) on the card:
    the exchange makes the border itself and the kernel runs on the haloed
    block.  The bilateral kernels sum each pixel's taps in a fixed order,
    so K2's and K6's results are bitwise the single-device kernel's; K4,
    K5 and K9 slide float64 sums from the block's start, held to the JAX
    package's sharded gates."""
    from reflectance_filtering_tpu_torch.ops.guided import (
        guided_filter_planar)
    from reflectance_filtering_tpu_torch.parallel import mesh as pm
    from reflectance_filtering_tpu_torch.parallel import spatial as ps
    mesh = pm.make_mesh(dev)
    rng = np.random.RandomState(3)
    h, w = 96, 640
    f = torch.from_numpy((rng.rand(h, w, 3) * 255).astype(np.float32)).to(dev)
    u8 = torch.floor(f).to(torch.uint8)

    def planar(t):
        return t.permute(2, 0, 1)[None].float().contiguous()

    if name == "box":
        got = ps.sharded_box_filter(f, 5, mesh)
        exp = box_filter_planar(planar(f)[0], 5, "reflect101").permute(
            1, 2, 0)
        tol = (1e-5, 1e-3)
    elif name == "joint":
        got = ps.sharded_joint_bilateral(f, f[..., :1], mesh)
        exp = k6.joint_bilateral_planar_batched(
            planar(f), planar(f[..., :1]))[0].permute(1, 2, 0)
        tol = None
    elif name == "joint_u8":
        got = ps.sharded_joint_bilateral(u8, u8[..., 1:2], mesh)
        exp = k6.bilateral_packed_joint_batched(
            planar(u8), planar(u8[..., 1:2]))[0].permute(1, 2, 0)
        tol = None
    elif name == "gray_self":
        got = ps.sharded_bilateral_gray_self(u8[..., 0], mesh, reps=3)
        exp = bilateral_gray_self(u8[..., 0][None].contiguous(), reps=3)[0]
        tol = None
    elif name == "color_self":
        got = ps.sharded_bilateral_color_self(u8, mesh)
        exp = k6.bilateral_color_self_batched(planar(u8))[0].permute(1, 2, 0)
        tol = None
    elif name == "guided":
        got = ps.sharded_guided_filter(f, f[..., 0], 45, 3.0, mesh)
        exp = guided_filter_planar(planar(f), planar(f[..., :1]), 45,
                                   3.0)[0, 0]
        tol = (1e-4, 5e-3)
    else:
        got = ps.sharded_guided_filter_iterated(u8.float(), u8[..., 0].float(),
                                                45, 3.0, 3, mesh)
        exp = guided_filter_iterated(planar(u8), planar(u8[..., :1]), 45,
                                     3.0, 3, planar=True)[0, 0]
        tol = (1e-4, 0.05)
    assert got.shape == exp.shape and got.device.type == "cuda"
    if tol is None:
        assert torch.equal(got, exp)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("ss,sr", [(None, None), (8, 6), (16, 10)])
def test_bilateral_grid_cuda_matches_cpu(dev, ss, sr):
    """The grid's plain torch ops on the card against the same call on the
    CPU: within 1e-3 as floats, 1 uint8 level after rint."""
    from reflectance_filtering_tpu_torch.ops.bilateral_grid import (
        bilateral_grid_gray, bilateral_grid_u8)
    rng = np.random.RandomState(4)
    j = torch.from_numpy(np.floor(rng.rand(4, 97, 131) * 256).astype(
        np.float32))
    s = torch.from_numpy(np.floor(rng.rand(4, 3, 97, 131) * 256).astype(
        np.float32))
    got = bilateral_grid_gray(j.to(dev), s.to(dev), 20.0 / 3, 22.0, ss, sr)
    want = bilateral_grid_gray(j, s, 20.0 / 3, 22.0, ss, sr)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-3)
    g = np.repeat(j[0].numpy().astype(np.uint8)[..., None], 3, -1)
    a = bilateral_grid_u8(g, g, 20.0, 22.0, ss, sr, device=dev)
    b = bilateral_grid_u8(g, g, 20.0, 22.0, ss, sr, device="cpu")
    assert np.abs(a.astype(np.int32) - b).max() <= 1


# the wrappers whose launches each serving pipeline adds, once a batch
SERVED_KERNELS = {"cnn": (reflectance_cnn,),
                  "bf": (reflectance_cnn, bilateral_gray_self),
                  "gf": (reflectance_cnn, guided_filter_fused)}


def _seeded_model(tmp_path):
    """(a seeded caffemodel's path, the same weights as a ReflectanceNet)."""
    from test_torch_caffe_io import caffemodel_bytes
    params = seeded_reference_params(6)
    path = tmp_path / "seeded.caffemodel"
    path.write_bytes(caffemodel_bytes(params))
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(params))
    return str(path), net


def _served_photos(dev, shape, seed):
    return torch.from_numpy((np.random.RandomState(seed).rand(*shape)
                             * 255).astype(np.uint8)).to(dev)


@pytest.mark.parametrize("kind", ["cnn", "bf", "gf"])
def test_cuda_artifact_is_bitwise_the_direct_call(dev, kind, tmp_path):
    """An artifact exported on the card runs K1, K2 and K5 through the rf::
    operators: bitwise pipeline_fn's output, one launch a kernel a call."""
    from reflectance_filtering_tpu_torch.utils import serving
    model_path, net = _seeded_model(tmp_path)
    path = str(tmp_path / "{}.pt2".format(kind))
    serving.export_flagship(path, 2, 64, 80, device=dev, pipeline=kind,
                            weights_path=model_path)
    fn = serving.load_flagship(path)
    img = _served_photos(dev, (2, 3, 64, 80), 1)
    with torch.no_grad():
        exp = serving.pipeline_fn(kind, net, dev)(img)
    kernels = (reflectance_cnn, bilateral_gray_self, guided_filter_fused)
    before = [k.launches for k in kernels]
    got = fn(img)
    torch.cuda.synchronize()
    rose = [k.launches - b for k, b in zip(kernels, before)]
    assert rose == [int(k in SERVED_KERNELS[kind]) for k in kernels]
    assert got.device.type == "cuda" and torch.equal(got, exp)


def test_cuda_symbolic_artifact_serves_any_shape(dev, tmp_path):
    from reflectance_filtering_tpu_torch.cli.decompose import decompose_planar
    from reflectance_filtering_tpu_torch.utils import serving
    model_path, net = _seeded_model(tmp_path)
    path = str(tmp_path / "any.pt2")
    serving.export_flagship(path, 0, 0, 0, device=dev, symbolic=True,
                            weights_path=model_path)
    fn = serving.load_flagship(path)
    weights = pack_weights(net.to(dev))
    for i, shape in enumerate([(1, 3, 45, 67), (3, 3, 32, 32)]):
        img = _served_photos(dev, shape, 2 + i)
        before = reflectance_cnn.launches
        got = fn(img)
        assert reflectance_cnn.launches == before + 1
        assert torch.equal(got, decompose_planar(weights, img))


def test_ops_launch_the_kernels_and_match_plain(dev):
    """The rf:: operators called directly: on a CUDA tensor each launches
    its kernel (counted once), bitwise its wrapper, and agrees with its
    plain version as the wrapper tests gate it."""
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(seeded_reference_params(3)))
    w = pack_weights(net.to(dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(2, 3, 999, device=dev, generator=gen)
    levels = (torch.rand(2, 37, 70, device=dev, generator=gen)
              * 255).to(torch.uint8)
    guide = torch.floor(torch.rand(2, 3, 40, 52, device=dev, generator=gen)
                        * 256)
    src = torch.floor(torch.rand(2, 1, 40, 52, device=dev, generator=gen)
                      * 256)
    cases = [
        (reflectance_cnn, lambda: torch.ops.rf.cnn_fwd(x, w, True),
         lambda: reflectance_cnn(x, w, srgb_input=True),
         lambda: reflectance_cnn_plain(x, w, srgb_input=True), 1e-5),
        (bilateral_gray_self,
         lambda: torch.ops.rf.bilateral_gray_self(levels, -1, 20.0, 22.0, 3),
         lambda: bilateral_gray_self(levels, -1, 20.0, 22.0, 3),
         lambda: bilateral_gray_self_plain(levels, -1, 20.0, 22.0, 3), 1e-3),
        (guided_filter_fused,
         lambda: torch.ops.rf.guided_filter(guide, src, 9, 3.0, "auto", 0),
         lambda: guided_filter_fused(guide, src, 9, 3.0),
         lambda: guided_filter_fused_plain(guide, src, 9, 3.0), 0.05),
    ]
    for wrapper, op, via_wrapper, plain, atol in cases:
        before = wrapper.launches
        got = op()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(got, via_wrapper())
        assert (got - plain()).abs().max().item() <= atol


@pytest.mark.parametrize("solver,kernels", [("ADAM", True), ("SGD", True),
                                            ("ADAM", False)])
def test_train_chunk_replays_match_eager_steps(dev, solver, kernels):
    """make_train_chunk on the card (CAPTURE_WARMUP_STEPS eager steps, one
    capture, the rest replays of the graph) against the same 39 steps run
    eagerly by make_train_step on the same rows: a chunk of
    TRAIN_CHUNK_STEPS from cursor 5, then one of 7 (all replays), the
    flagship at 8 x 64x64, K = 1181, 12 images (the batches wrap).  Params
    and every step's metrics within 1e-6 (bitwise where the kernels and
    torch's reductions repeat); capturable Adam, SGD as it is, and the
    plain versions (kernels=False) all capture.  The wrappers' counts follow
    the launches: one K7 forward and backward, two K3 and one K8 a step,
    whether the step ran eagerly or as a replay, none in the capture."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.train import loop
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    cfg, lcfg, n, bs = NetworkConfig(), loop.LossConfig(), 12, 8
    rng = np.random.RandomState(4)
    images = rng.rand(n, 64, 64, 3).astype(np.float32) * 0.8 + 0.1
    comps = make_synthetic_comps(5, 1181, batch=n)
    im_d, cp_d = (torch.from_numpy(np.concatenate([a, a[:bs - 1]])).to(dev)
                  for a in (images, comps))
    init = init_network(cfg, torch.Generator().manual_seed(6))
    pa, pb = loop.trainable(init, dev), loop.trainable(init, dev)
    chunk = loop.make_train_chunk(cfg, lcfg, pa, loop.make_optimizer(
        solver, 1e-3, pa), im_d, cp_d, cp_d, bs, kernels=kernels)
    step = loop.make_train_step(cfg, lcfg, pb, loop.make_optimizer(
        solver, 1e-3, pb), kernels=kernels)
    cursor, stacked, eager = 5, [], []
    wrappers = (k7.trunk_forward, k7.trunk_backward, gather_pairs,
                scatter_pairs)
    before = [fn.launches for fn in wrappers]
    for k in (loop.TRAIN_CHUNK_STEPS, 7):
        stacked.append(chunk(0, cursor, k).cpu())
        cursor = (cursor + k * bs) % n
    steps = loop.TRAIN_CHUNK_STEPS + 7
    assert [fn.launches - b for fn, b in zip(wrappers, before)] == (
        [steps, steps, 2 * steps, steps] if kernels else [0, 0, 0, 0])
    cursor = 5
    for _ in range(loop.TRAIN_CHUNK_STEPS + 7):
        met = step(im_d[cursor:cursor + bs], cp_d[cursor:cursor + bs])
        eager.append([met[key].item() for key in chunk.keys])
        cursor = (cursor + bs) % n
    got = torch.cat(stacked).numpy()
    np.testing.assert_allclose(got, np.array(eager, np.float32), rtol=1e-6,
                               atol=1e-7)
    for layer in pb:
        for part in pb[layer]:
            d = (pa[layer][part] - pb[layer][part]).abs().max().item()
            assert d <= 1e-6, (layer, part, d)


def test_train_chunk_recaptures_when_state_tensors_change(dev):
    """make_train_chunk captures its step once, and again only when the
    optimizer's state tensors are replaced (load_optimizer_state with the
    same values): K7's forward wrapper counts one launch a step in each
    chunk, the warm-up step's, the replays' and none for either capture;
    the params stay make_train_step's (1e-6)."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.train import loop
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    cfg, lcfg, n, bs = NetworkConfig(), loop.LossConfig(), 6, 4
    rng = np.random.RandomState(8)
    im_d, cp_d = (torch.from_numpy(np.concatenate([a, a[:bs - 1]])).to(dev)
                  for a in (rng.rand(n, 32, 32, 3).astype(np.float32),
                            make_synthetic_comps(9, 300, batch=n)))
    init = init_network(cfg, torch.Generator().manual_seed(2))
    pa, pb = loop.trainable(init, dev), loop.trainable(init, dev)
    opt_a = loop.make_optimizer("ADAM", 1e-3, pa)
    opt_b = loop.make_optimizer("ADAM", 1e-3, pb)
    chunk = loop.make_train_chunk(cfg, lcfg, pa, opt_a, im_d, cp_d, cp_d, bs)
    step = loop.make_train_step(cfg, lcfg, pb, opt_b)
    cursor, counts = 0, []
    for k, reload in ((5, False), (3, False), (3, True)):
        if reload:
            for params, opt in ((pa, opt_a), (pb, opt_b)):
                loop.load_optimizer_state(opt, params,
                                          loop.optimizer_state(opt, params))
        before = k7.trunk_forward.launches
        chunk(0, cursor, k)
        counts.append(k7.trunk_forward.launches - before)
        for _ in range(k):
            step(im_d[cursor:cursor + bs], cp_d[cursor:cursor + bs])
            cursor = (cursor + bs) % n
    assert counts == [5, 3, 3]
    for layer in pb:
        for part in pb[layer]:
            d = (pa[layer][part] - pb[layer][part]).abs().max().item()
            assert d <= 1e-6, (layer, part, d)


def test_k8_sort_path_captures_in_a_graph(dev):
    """K8's sort path at 64-bit keys and K = 2048 (a block's shared memory
    above 48 KB, so every launch sets the kernel's attribute) captured in a
    CUDA graph: the replay is bitwise the eager launch."""
    b, side, k = 1, 1024, 2048
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = [torch.randint(0, side, (b, k), device=dev, generator=gen,
                         dtype=torch.int32) for _ in range(4)]
    g = [torch.randn(b, k, device=dev, generator=gen) for _ in range(2)]
    exp = scatter_pairs((b, side, side), *idx, *g)
    graph = torch.cuda.CUDAGraph()
    before = scatter_pairs.launches
    with torch.cuda.graph(graph):
        out = scatter_pairs((b, side, side), *idx, *g)
    assert scatter_pairs.launches == before    # a capture runs nothing
    out.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, exp)


def _merged_idle_us(events):
    """The card's idle µs in a Chrome trace, counted apart from
    ``utils/profiling.py``: from the first device operation's start to
    the last one's end, less the union of their intervals."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return spans[-1][1] - spans[0][0] - busy


def _served_request(dev, kind):
    from reflectance_filtering_tpu_torch.losses.whdr import whdr_per_image
    from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(seeded_reference_params(6)))
    module = pipeline_fn(kind, net, dev)
    img = _served_photos(dev, (4, 3, 64, 80), 2)
    comps = torch.from_numpy(make_synthetic_comps(5, 200, batch=4)).to(dev)

    def request():
        q = module(img)
        return whdr_per_image(q / 255.0, comps)
    request()
    torch.cuda.synchronize()
    return request


@pytest.mark.parametrize("kind", ["bf", "gf"])
def test_spans_and_kernels_share_a_cuda_only_profiles_timeline(dev, kind,
                                                               tmp_path):
    """Under a CUDA-only torch.profiler session, as the benchmark opens
    one: torch's profiler flag is set, the spans record, and on the
    trace's timeline every kernel starts after the span it was launched in
    began (K1's after serve.cnn's start) and after its launch."""
    import json
    import time
    from torch.profiler import ProfilerActivity, profile
    from reflectance_filtering_tpu_torch.utils import profiling
    request = _served_request(dev, kind)
    t0 = time.time_ns()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    enabled = torch.autograd.profiler._is_profiler_enabled
    for _ in range(3):
        request()
        torch.cuda.synchronize()
    prof.stop()
    assert enabled
    records = [r for r in profiling.spans() if r.start_ns >= t0]
    names = [r.name for r in records]
    assert names.count("serve.forward") == names.count("whdr.per_image") == 3
    assert names.count("serve.cnn") == names.count("serve.filter") == 3
    path = str(tmp_path / "cuda_only.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X" and e.get("cat") in profiling
                .LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"
               and "spin_kernel" not in e["name"]]
    assert kernels
    spans = [(r.name, (r.start_ns - base) / 1e3, (r.end_ns - base) / 1e3)
             for r in records]
    checked = k1 = 0
    for k in kernels:
        t = launches.get(k["args"].get("correlation"))
        if t is None:
            continue
        assert k["ts"] >= t, (k["name"], k["ts"] - t)
        inside = [(n, s) for n, s, e in spans if s <= t <= e]
        if not inside:           # q / 255 between the pipeline and WHDR
            continue
        assert all(k["ts"] >= s for _, s in inside), k["name"]
        checked += 1
        if "cnn_fwd" in k["name"]:
            assert "serve.cnn" in [n for n, _ in inside]
            k1 += 1
    assert k1 == 3 and checked >= len(kernels) // 2, (checked, len(kernels))


def test_device_trace_charges_the_served_requests_idle_time(dev, tmp_path):
    """device_trace around served gf requests, in a process that has run
    the port's kernels: the idle file's parts sum to the trace's device
    idle time within 1%, most of it charged to the program's spans, and
    its record counts say whether the profile lost any.  The same card
    trace with one kernel's record taken out, as a profile that lost it
    would read: its launch is counted as lost and the gap it leaves goes
    to UNMATCHED, to no span."""
    import json
    import os
    from reflectance_filtering_tpu_torch.utils import profiling
    request = _served_request(dev, "gf")
    with profiling.device_trace(str(tmp_path)):
        for _ in range(5):
            request()
            torch.cuda.synchronize()
    idle_name, trace_name = sorted(os.listdir(str(tmp_path)))
    with open(str(tmp_path / idle_name)) as f:
        idle = json.load(f)
    with open(str(tmp_path / trace_name)) as f:
        events = json.load(f)["traceEvents"]
    print("served gf requests:", json.dumps(idle))
    want = _merged_idle_us(events)
    assert sum(idle["idle_us_by_span"].values()) == pytest.approx(
        want, rel=0.01)
    assert idle["idle_us"] == pytest.approx(want, rel=0.01)
    named = sum(v for k, v in idle["idle_us_by_span"].items()
                if k.startswith(("serve.", "whdr.")))
    assert named > 0
    # a launch whose device record was lost inside the window charges the
    # gap it falls in to UNMATCHED, never to a span
    lost = sum(idle["launches_without_device_op"].values())
    if lost > idle["launches_without_device_op_before_the_window"]:
        assert idle["idle_us_by_span"].get(profiling.UNMATCHED, 0) > 0
    with open(str(tmp_path / trace_name)) as f:
        base = int(json.load(f).get("baseTimeNanoseconds", 0))
    records = profiling.spans()
    full = profiling.idle_by_span(events, records, base)
    assert full["idle_us_by_span"] == pytest.approx(idle["idle_us_by_span"])
    launched = {e["args"]["correlation"] for e in events
                if e.get("ph") == "X"
                and e.get("cat") in profiling.LAUNCH_CATEGORIES
                and "correlation" in e.get("args", {})}
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in profiling.DEVICE_CATEGORIES),
                 key=lambda e: e["ts"])

    def alone(i):
        """ops[i], a kernel between two ops, none overlapping, each
        with its launch."""
        a, k, b = ops[i - 1:i + 2]
        return (k.get("cat") == "kernel" and k.get("dur", 0) > 0
                and a["ts"] + a.get("dur", 0) <= k["ts"]
                and k["ts"] + k["dur"] <= b["ts"]
                and all(o["args"].get("correlation") in launched
                        for o in (a, k, b)))
    middle = len(ops) // 2
    (i, *_) = sorted((i for i in range(1, len(ops) - 1) if alone(i)),
                     key=lambda i: abs(i - middle))
    dropped = ops[i]
    cut = profiling.idle_by_span([e for e in events if e is not dropped],
                                 records, base)
    print("one kernel record taken out:", dropped["name"][:80],
          json.dumps(cut["idle_us_by_span"]))
    assert sum(cut["launches_without_device_op"].values()) == lost + 1
    unmatched = profiling.UNMATCHED
    assert cut["idle_us_by_span"].get(unmatched, 0) >= \
        full["idle_us_by_span"].get(unmatched, 0) + dropped["dur"] - 1e-6
    for name, us in cut["idle_us_by_span"].items():
        if name != unmatched:
            assert us <= full["idle_us_by_span"].get(name, 0) + 1e-6, name


def test_decompose_profile_dir_idle_file_accounts_for_the_idle(dev,
                                                               tmp_path,
                                                               monkeypatch):
    """``cli/decompose.py --profile_dir`` on cuda (seeded weights): the
    idle file accounts for the trace's device idle time within 1%."""
    import json
    import os
    import cv2
    from reflectance_filtering_tpu_torch.cli import decompose
    monkeypatch.setattr(decompose, "load_reference_weights",
                        lambda path: seeded_reference_params(6))
    png = str(tmp_path / "photo.png")
    cv2.imwrite(png, np.moveaxis(_served_photos("cpu", (1, 3, 96, 128), 3)
                                 [0].numpy(), 0, -1))
    out, trace_dir = tmp_path / "out", tmp_path / "trace"
    out.mkdir()
    decompose.main(["--filename_in", png, "--path_out", str(out),
                    "--device", "cuda", "--profile_dir", str(trace_dir)])
    assert (out / "photo-r.png").exists()
    idle_name, trace_name = sorted(os.listdir(str(trace_dir)))
    with open(str(trace_dir / idle_name)) as f:
        idle = json.load(f)
    with open(str(trace_dir / trace_name)) as f:
        events = json.load(f)["traceEvents"]
    print("decompose --profile_dir:", json.dumps(idle))
    want = _merged_idle_us(events)
    assert idle["device_ops"] > 0
    assert sum(idle["idle_us_by_span"].values()) == pytest.approx(
        want, rel=0.01)
    assert set(idle) >= {"device_ops_without_launch",
                         "launches_without_device_op",
                         "launches_without_device_op_before_the_window"}
