"""K6's float form (csrc/bilateral_joint_float.cuh), its arithmetic emulated
on the CPU.

The kernel computes the TPU kernel's weight exp(D^2 gcc + (dx^2 + dy^2)
gsc) as 2^(lsw[dx^2 + dy^2] - (k D)^2): lsw the float64-built table of the
spatial term in the exponent (``space_log2_weights``), k = sqrt(-gcc
log2(e)) rounded to float32 (``range_scale``) and applied to the joint
values as the tile is filled (a float32 product), k D the float32 sum of
|differences| of the scaled values, the exponent one float32 FMA, and the
power one ex2.approx.ftz (here exp2 in float64 rounded to float32,
subnormals flushed: the approximation's own error of a few ulps is not
emulated).
Four groups of warps walk the disk rows with dy + radius = 0, 1, 2, 3
(mod 4), dx ascending, each summing a row's w S and w in float32 (FMA)
and adding them to its sums after the row; the groups' sums are added in
group order before the one divide.  Gates, with their reasons:
  * against ``bilateral_joint_plain`` (the exp form the card's gate holds
    the kernel to): within 1e-3 in 0-255 units, within 1 uint8 level after
    rounding and equal on >= 99.9% (tests/test_torch_kernels_cuda.py); at
    each pairing's largest radius the same gate against the plain version
    in float64, since the float32 one's running sums over the whole disk
    (16,757 taps at radius 73) drift by ~1e-3 themselves;
  * against the JAX package's kernel 7 (``_kernel``) in TPU-interpret
    mode: rtol 1e-4, atol 2e-3 (tests/test_torch_bilateral_joint.py's
    gate for the same kernel), and 1 level.
The JAX wrapper takes a 3-plane joint only; a 1-plane joint is its
3-plane replica at 3x sigma_color (the same D^2 gcc).  The kernel itself
is held against the plain version on the card (chip_smoke.py,
test_torch_kernels_cuda.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.ops import bilateral_pallas as jbp
from reflectance_filtering_tpu_torch.ops import bilateral_joint_kernel as k6
from reflectance_filtering_tpu_torch.ops.bilateral import (
    opencv_bilateral_coeffs, pad_reflect101, space_weights)

RTOL, ATOL = 1e-4, 2e-3
SIGMA_C = 20.0
SPLIT = k6.FLOAT_SPLIT


def emulated_float_form(joint, src, radius, gcc, gsc):
    """K6's float form as the kernel computes it, on joint [N, cj, H, W]
    and src [N, cs, H, W] float32 arrays -> float32 [N, cs, H, W]."""
    n, cj, h, w = joint.shape
    joint = joint * np.float32(k6.range_scale(gcc))
    jp = pad_reflect101(torch.from_numpy(joint), radius).numpy()
    sp = pad_reflect101(torch.from_numpy(src), radius).numpy()
    lsw = k6.space_log2_weights(radius, gsc).astype(np.float64)
    acc = np.zeros((SPLIT,) + src.shape, np.float32)
    wsum = np.zeros((SPLIT, n, 1, h, w), np.float32)
    for dy in range(-radius, radius + 1):
        grp = (dy + radius) % SPLIT
        dxm = math.isqrt(radius * radius - dy * dy)
        racc = np.zeros(src.shape, np.float32)
        rsum = np.zeros((n, 1, h, w), np.float32)
        for dx in range(-dxm, dxm + 1):
            ys = slice(radius + dy, radius + dy + h)
            xs = slice(radius + dx, radius + dx + w)
            diff = jp[:, :, ys, xs] - joint
            if cj == 1:
                d = diff
            else:
                d = np.abs(diff[:, :1])
                for c in range(1, cj):
                    d = d + np.abs(diff[:, c:c + 1])
            d = d.astype(np.float64)
            arg = (lsw[dy * dy + dx * dx] - d * d).astype(np.float32)
            wgt = np.exp2(arg.astype(np.float64)).astype(np.float32)
            wgt[wgt < np.finfo(np.float32).tiny] = 0.0
            racc = (wgt.astype(np.float64) * sp[:, :, ys, xs]
                    + racc).astype(np.float32)
            rsum = rsum + wgt
        acc[grp] = acc[grp] + racc
        wsum[grp] = wsum[grp] + rsum
    tot, ws = acc[0], wsum[0]
    for g in range(1, SPLIT):
        tot, ws = tot + acc[g], ws + wsum[g]
    return tot / ws


def _gate(got, exp, atol):
    d = np.abs(np.rint(got) - np.rint(exp))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                       (d == 0).mean())
    assert np.abs(got - exp).max() <= atol, np.abs(got - exp).max()


@pytest.mark.parametrize("cj,cs", [(1, 1), (1, 3), (3, 1), (3, 3)])
@pytest.mark.parametrize("shape,sigma_space", [((2, 24, 40), 3.0),
                                               ((1, 20, 27), 22.0)])
def test_factored_weight_matches_plain_and_pallas(cj, cs, shape,
                                                  sigma_space, rng):
    """Non-integer values at radius 4 on ragged 16 x 32 tiles and at radius
    33 on a frame smaller than the radius (reflection repeats): the
    emulation within 1e-3 and 1 level of the plain exp form; at radius 4
    also against the JAX kernel in interpret mode."""
    n, h, w = shape
    joint = (rng.rand(n, cj, h, w) * 255).astype(np.float32)
    src = (rng.rand(n, cs, h, w) * 255).astype(np.float32)
    radius, gcc, gsc = opencv_bilateral_coeffs(-1, SIGMA_C, sigma_space)
    got = emulated_float_form(joint, src, radius, gcc, gsc)
    plain = k6.bilateral_joint_plain(torch.from_numpy(joint),
                                     torch.from_numpy(src), radius, gcc,
                                     gsc).numpy()
    assert got.shape == (n, cs, h, w)
    _gate(got, plain, 1e-3)
    if radius > 4:
        return
    j3 = joint if cj == 3 else np.repeat(joint, 3, axis=1)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jbp.joint_bilateral_planar_batched(
            jnp.asarray(j3), jnp.asarray(src), -1, SIGMA_C * (4 - cj),
            sigma_space))
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    _gate(got, exp, ATOL + RTOL * 255)


@pytest.mark.parametrize("cj,cs", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_factored_weight_at_max_radius(cj, cs, rng):
    """At each pairing's largest one-band radius, on a frame smaller than
    the radius (reflection repeats): the emulation within 1e-3 and 1 level of the
    plain version in float64, and nearer to it than the float32 plain
    version is at radius 73 (whose running sums over 16,757 taps drift
    by ~1e-3)."""
    r = k6.one_band_radius(cj, cs, False, False)
    joint = (rng.rand(1, cj, 12, 20) * 255).astype(np.float32)
    src = (rng.rand(1, cs, 12, 20) * 255).astype(np.float32)
    _, gcc, gsc = opencv_bilateral_coeffs(2 * r + 1, SIGMA_C, 22.0)
    got = emulated_float_form(joint, src, r, gcc, gsc)
    exact = k6.bilateral_joint_plain(
        torch.from_numpy(joint).double(), torch.from_numpy(src).double(), r,
        gcc, gsc).numpy()
    _gate(got, exact, 1e-3)
    if r == 73:
        plain = k6.bilateral_joint_plain(torch.from_numpy(joint),
                                         torch.from_numpy(src), r, gcc,
                                         gsc).numpy()
        assert np.abs(got - exact).max() < np.abs(plain - exact).max()


@pytest.mark.parametrize("cj,cs,at_least", [(1, 1, 73), (1, 3, 48),
                                            (3, 1, 48), (3, 3, 37)])
def test_float_max_radius_per_pairing(cj, cs, at_least):
    """Each float pairing admits the first port's largest radius or more
    (the footprint is the same 16 x 32 tile); the shared memory mirror
    takes the split groups' partial sums where they outgrow the tile."""
    r = k6.one_band_radius(cj, cs, False, False)
    assert r >= at_least, (cj, cs, r)
    assert (k6.smem_bytes(cj, cs, False, False, r) <= k6.SMEM_LIMIT
            < k6.smem_bytes(cj, cs, False, False, r + 1))
    assert k6.smem_bytes(cj, cs, False, False, 0) == 4 * max(
        (cj + cs) * k6.TILE_H * k6.TILE_W,
        (SPLIT - 1) * (cs + 1) * k6.TILE_H * k6.TILE_W)


@pytest.mark.parametrize("sigma_space", [3.0, 22.0, 49.0])
def test_log_table_is_the_spatial_weights_exponent(sigma_space):
    """2^lsw[s] is space_weights' float64-built weight sw[s] to float32
    rounding (within 4e-7 relative) for every s up to radius^2."""
    radius, _, gsc = opencv_bilateral_coeffs(-1, SIGMA_C, sigma_space)
    lsw = k6.space_log2_weights(radius, gsc)
    sw = space_weights(radius, gsc)
    assert lsw.dtype == np.float32 and lsw.shape == (radius * radius + 1,)
    rel = np.abs(np.exp2(lsw.astype(np.float64)) / sw - 1)
    assert rel.max() <= 4e-7, rel.max()
