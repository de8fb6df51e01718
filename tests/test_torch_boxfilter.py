"""The port's plain box filter (ops/boxfilter.py, K4's plain version in
ops/box_kernel.py) against the JAX package: the XLA block-local sliding
sum ``box_filter`` and the Pallas kernels ``box_filter_pallas`` and
``box_filter_fused`` in TPU-interpret mode.  Gate: 1e-3 in input units
(inputs in 0-255), or 8 float32 ulps of the largest block partial where
that is larger: both sides sum in float32 blocks of up to 512, in
different orders, so a partial of L * w * 255 carries their difference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.ops.box_pallas import (box_filter_fused,
                                                      box_filter_pallas)
from reflectance_filtering_tpu.ops.boxfilter import box_filter as j_box
from reflectance_filtering_tpu_torch.ops.boxfilter import (box_filter,
                                                           reflect_index)
from reflectance_filtering_tpu_torch.ops.box_kernel import (
    box_filter_planar, box_filter_planar_plain)

ATOL = 1e-3


def _tol(length, radius, normalize=True):
    """The gate for a padded axis of ``length`` (see the docstring)."""
    w = 2 * radius + 1
    ulps = 8 * 2.0 ** -24 * min(length + 2 * radius, 512) * w * 255.0
    return max(ATOL, ulps / w ** 2) if normalize else max(ATOL * w * w, ulps)


@pytest.mark.parametrize("n,radius", [(1, 3), (2, 5), (5, 2), (5, 11),
                                      (7, 33), (40, 45), (3, 0)])
def test_reflect_index_matches_numpy_symmetric(n, radius):
    """BORDER_REFLECT is numpy's "symmetric" pad, repeated when the
    radius exceeds n; a 1-wide dimension maps to 0."""
    exp = np.pad(np.arange(n), radius, mode="symmetric")
    np.testing.assert_array_equal(
        reflect_index(n, radius, "cpu").numpy(), exp)


@pytest.mark.parametrize("border", ["reflect", "reflect101"])
@pytest.mark.parametrize("shape,radius", [((30, 40), 4), ((30, 40, 2), 7),
                                          ((2, 9, 13, 3), 5), ((7, 9), 12),
                                          ((5, 600), 3)])
def test_box_filter_matches_xla(shape, radius, border, rng):
    """All three layouts of the JAX filter; (7, 9) at r=12 reflects more
    than once, (5, 600) spans two blocks of 512."""
    x = (rng.rand(*shape) * 255).astype(np.float32)
    exp = np.asarray(j_box(jnp.asarray(x), radius, border))
    got = box_filter(torch.from_numpy(x), radius, border).numpy()
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=_tol(max(shape[-3:][:2]), radius))


@pytest.mark.parametrize("normalize", [True, False])
def test_box_filter_unnormalized_and_radius_zero(normalize, rng):
    x = (rng.rand(12, 17) * 255).astype(np.float32)
    exp = np.asarray(j_box(jnp.asarray(x), 3, normalize=normalize))
    got = box_filter(torch.from_numpy(x), 3, normalize=normalize).numpy()
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=_tol(17, 3, normalize))
    t = torch.from_numpy(x)
    assert box_filter(t, 0, normalize=normalize) is t


@pytest.mark.parametrize("border", ["reflect", "reflect101"])
@pytest.mark.parametrize("shape,radius", [((2, 16, 128), 5), ((3, 21, 35), 4),
                                          ((1, 12, 40), 45)])
def test_planar_plain_matches_pallas_interpret(shape, radius, border, rng):
    """K4's plain version against the TPU kernels it stands for: the
    whole-plane kernel (aligned (16, 128)), the two-pass kernels
    (unaligned) and the tiled fused kernel; (12, 40) at r=45 is narrower
    than the window."""
    x = (rng.rand(*shape) * 255).astype(np.float32)
    got = box_filter_planar_plain(torch.from_numpy(x), radius,
                                  border).numpy()
    with pltpu.force_tpu_interpret_mode():
        for fn in (box_filter_pallas, box_filter_fused):
            exp = np.asarray(fn(jnp.asarray(x), radius, border))
            np.testing.assert_allclose(got, exp, rtol=0,
                                       atol=_tol(max(shape[1:]), radius),
                                       err_msg=fn.__name__)


def test_wrapper_cpu_dispatch_and_checks(rng):
    x = torch.from_numpy((rng.rand(2, 9, 10) * 255).astype(np.float32))
    before = box_filter_planar.launches
    np.testing.assert_array_equal(
        box_filter_planar(x, 3, "reflect101").numpy(),
        box_filter_planar_plain(x, 3, "reflect101").numpy())
    assert box_filter_planar.launches == before   # the CPU launches nothing
    with pytest.raises(ValueError):
        box_filter_planar(x[0], 3)
    with pytest.raises(TypeError):
        box_filter_planar(x.double(), 3)
    with pytest.raises(ValueError):
        box_filter_planar(x.transpose(1, 2), 3)
    with pytest.raises(ValueError, match="border"):
        box_filter_planar(x, 3, border="wrap")
    with pytest.raises(ValueError, match="radius"):
        box_filter_planar(x, -1)
    with pytest.raises(ValueError, match="path"):
        box_filter_planar(x, 3, path="three-pass")


def _prefix_window_sums(row, radius, r101):
    """The kernel's row window (csrc/box_common.cuh: warp_prefix,
    prefix_at, window_sum) in float64 numpy: the row's prefix sums, and
    each window as whole periods of the bordered row plus a difference of
    two prefixes, the second half of a period running over the row
    backwards."""
    w = row.shape[0]
    pre = np.concatenate([[0.0], np.cumsum(row.astype(np.float64))])
    o = 1 if r101 else 0
    p = 2 * (w - o)

    def at(a):
        if p == 0:
            return 0, a, True
        m = a // p
        b = a - m * p
        return (m, b, True) if b <= w else (m, 2 * w - o - b, False)

    out = np.empty(w)
    for x in range(w):
        if p == 0:
            out[x] = (2 * radius + 1) * pre[1]
            continue
        (m0, j0, up0), (m1, j1, up1) = at(x - radius), at(x + radius + 1)
        s = (pre[j1] if up1 else -pre[j1]) - (pre[j0] if up0 else -pre[j0])
        u = pre[w] + pre[w - o]
        s += ((0 if up1 else 1) - (0 if up0 else 1)) * u
        s += (m1 - m0) * (u - pre[o])
        out[x] = s
    return out


@pytest.mark.parametrize("border", ["reflect", "reflect101"])
@pytest.mark.parametrize("w,radius", [(1, 0), (1, 3), (2, 5), (3, 1), (7, 3),
                                      (40, 45), (40, 300), (256, 45),
                                      (97, 96), (33, 16)])
def test_row_window_by_prefix_sums(w, radius, border, rng):
    """K4's row pass and K5's fused kernels take each window as a
    difference of two prefix sums of the row, with whole periods of the
    bordered row for radii past the frame: the same window sums as the
    plain box's row pass, to float64 rounding, at any radius."""
    row = rng.rand(w) * 255
    got = _prefix_window_sums(row, radius, border == "reflect101")
    exp = box_filter_planar_plain(torch.from_numpy(row[None, None]).double(),
                                  radius, border, normalize=False)
    # the plain box sums columns too: one row is the window over rows of
    # the bordered 1-high plane, (2r + 1) copies of the row's sums
    exp = exp[0, 0].numpy() / (2 * radius + 1)
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("w,fused,warps", [
    (1, True, 8), (512, True, 8), (513, False, 8), (3631, False, 8),
    (3632, False, 7), (29055, False, 1), (29056, False, 0)])
def test_kernel_forms_at_their_limits(w, fused, warps):
    """The wrapper's mirrors of csrc/box_filter.cu: the fused form takes
    rows up to FUSED_WIDEST wide by shape, the two passes the rest; a row
    block of the two passes holds 8 rows' prefix buffers (w + 1 doubles
    each) while they fit a block's shared memory, fewer for wider rows,
    and none (a device-memory scratch) past 29,055 columns."""
    from reflectance_filtering_tpu_torch.ops import box_kernel as k4
    assert k4.fused_path(w) == fused
    assert k4.fused_path(w, "two-pass") is False
    assert k4.fused_path(w, "fused") is True
    assert k4.row_warps(w) == warps
    if warps:
        assert warps * (w + 1) * 8 <= k4.SMEM_LIMIT
    if warps < k4.ROW_WARPS:
        assert (warps + 1) * (w + 1) * 8 > k4.SMEM_LIMIT


@pytest.mark.parametrize("planes,h,band", [
    (32, 256, 16), (17, 256, 16), (16, 256, 8), (33, 256, 32),
    (264, 64, 64), (263, 64, 32), (13, 64, 8), (1, 2160, 8),
    (1, 16896, 64), (1, 16832, 32)])
def test_fused_band_rule(planes, h, band):
    """The fused form's rows per block (``fused_band``, 132 SMs): the
    tallest of 64, 32 and 16 rows whose grid gives every SM two blocks,
    else 8; [32, 256, 256] takes 16, the band measured fastest there."""
    from reflectance_filtering_tpu_torch.ops.box_kernel import fused_band
    assert fused_band(planes, h) == band
