"""The port's iterated guided-filter chain (ops/guided_chain_kernel.py, K9's
plain versions, and ops/guided.py::guided_filter_iterated) against the JAX
package, on the CPU, with inputs made from numpy seeds.

Gates, each with its reason:
  * float outputs: rtol 1e-3, atol 0.05 (tests/test_pallas_ops.py holds the
    JAX package's own 3x chains to its XLA loop so), and within 1 uint8
    level after rint (the reference's parity contract);
  * guide statistics: each plane within 1e-4 of that plane's largest
    magnitude (the plain box's float32 rounding; the d planes are
    differences of window sums and cross zero, so a relative gate per
    element does not apply).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.ops import guided as jg
from reflectance_filtering_tpu.ops.guided_pallas import (
    _use_fused_mxu, guided_filter_fused_iterated)
from reflectance_filtering_tpu_torch.ops import guided as tg
from reflectance_filtering_tpu_torch.ops import guided_chain_kernel as k9

RTOL, ATOL = 1e-3, 0.05


def _u8(rng, *shape):
    return np.floor(rng.rand(*shape) * 256).astype(np.float32)


def _close(got, exp, tag=""):
    assert got.shape == exp.shape, tag
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL, err_msg=tag)
    d = np.abs(np.rint(got) - np.rint(exp))
    assert d.max() <= 1, (tag, float(d.max()))


def _port(g, s, radius, eps, iterations, **kw):
    return tg.guided_filter_iterated(torch.from_numpy(g), torch.from_numpy(s),
                                     radius, eps, iterations, planar=True,
                                     **kw).numpy()


@pytest.mark.parametrize("shape,c,radius,eps", [
    ((2, 64, 96), 1, 8, 9.0),
    ((1, 12, 40), 1, 45, 3.0),     # radius wider than the frame
    ((1, 17, 23), 2, 4, 9.0)])
def test_iterated_matches_jax_xla_loop(shape, c, radius, eps, rng):
    """guided_filter_iterated(planar=True) against the JAX function on the
    CPU, which loops its planar XLA filter (Pallas box in interpret
    mode); 12x40 at r=45 reflects repeatedly."""
    n, h, w = shape
    g, s = _u8(rng, n, 3, h, w), _u8(rng, n, c, h, w)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jg.guided_filter_iterated(
            jnp.asarray(g), jnp.asarray(s), radius, eps, 3, planar=True))
    _close(_port(g, s, radius, eps, 3), exp)


@pytest.mark.parametrize("h,w,c,radius,eps,th,fused", [
    (16, 128, 1, 4, 9.0, 16, False),     # kernel 16, VPU boxes
    (136, 200, 3, 8, 9.0, None, False),  # kernel 16, band-dot boxes
    (256, 272, 1, 45, 3.0, None, True),  # kernel 17
])
def test_chain_matches_tpu_kernels_interpret(h, w, c, radius, eps, th, fused,
                                             rng):
    """The chain against guided_filter_fused_iterated, the TPU kernels 16
    (banded: stats, apply, stage 2) and 17 (fused: stats in the first
    application, cached after it) run in interpret mode, 3 iterations."""
    assert _use_fused_mxu(h, radius, th) == fused
    g, s = _u8(rng, 1, 3, h, w), _u8(rng, 1, c, h, w)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(guided_filter_fused_iterated(
            jnp.asarray(g), jnp.asarray(s), radius, eps, 3, th=th))
    _close(_port(g, s, radius, eps, 3), exp)


@pytest.mark.parametrize("gray", [False, True])
def test_non_planar_matches_jax_loop(gray, rng):
    """planar=False repeats guided_filter on HWC layouts, a batched color
    or gray guide, as the JAX loop does."""
    g = _u8(rng, 2, 26, 33, 3)
    if gray:
        g = g[..., 0]
    s = _u8(rng, 2, 26, 33, 2)
    exp = np.asarray(jg.guided_filter_iterated(jnp.asarray(g), jnp.asarray(s),
                                               5, 7.0, 3))
    got = tg.guided_filter_iterated(g, s, 5, 7.0, 3).numpy()
    _close(got, exp)


def test_one_iteration_is_the_guided_filter(rng):
    """iterations=1 is one guided filter: the port's guided_filter_planar
    (K5's plain version), which solves with 1/det applied after the
    cofactor product instead of premultiplied."""
    g, s = _u8(rng, 2, 3, 30, 41), _u8(rng, 2, 3, 30, 41)
    exp = tg.guided_filter_planar(torch.from_numpy(g), torch.from_numpy(s), 6,
                                  3.0).numpy()
    _close(_port(g, s, 6, 3.0, 1), exp)


@pytest.mark.parametrize("planar", [True, False])
def test_zero_iterations_returns_src(planar, rng):
    g, s = _u8(rng, 1, 3, 8, 9), _u8(rng, 1, 1, 8, 9)
    if not planar:
        g, s = np.moveaxis(g[0], 0, -1), s[0, 0]
    src = torch.from_numpy(s)
    assert tg.guided_filter_iterated(torch.from_numpy(g), src, 3, 3.0, 0,
                                     planar=planar) is src


def test_guide_u8_changes_nothing(rng):
    g, s = _u8(rng, 1, 3, 20, 24), _u8(rng, 1, 1, 20, 24)
    np.testing.assert_array_equal(_port(g, s, 4, 3.0, 3, guide_u8=True),
                                  _port(g, s, 4, 3.0, 3))


def test_stats_computed_once_per_call(rng, monkeypatch):
    """One call computes the guide's statistics once for all iterations
    and src channels, and a second call computes them anew."""
    calls = []
    stats = k9.guide_stats

    def counted(*args):
        calls.append(args[1:])
        return stats(*args)

    monkeypatch.setattr(k9, "guide_stats", counted)
    g = torch.from_numpy(_u8(rng, 1, 3, 16, 20))
    s = torch.from_numpy(_u8(rng, 1, 3, 16, 20))
    first = k9.guided_filter_chain(g, s, 4, 3.0, 3)
    assert calls == [(4, 3.0)]
    second = k9.guided_filter_chain(g, s, 4, 3.0, 3)
    assert len(calls) == 2 and torch.equal(first, second)


def test_chain_is_its_plain_version_on_the_cpu(rng):
    g = torch.from_numpy(_u8(rng, 2, 3, 19, 22))
    s = torch.from_numpy(_u8(rng, 2, 2, 19, 22))
    before = (k9.guide_stats.launches, k9.guided_apply_cached.launches)
    got = k9.guided_filter_chain(g, s, 5, 3.0, 2)
    assert torch.equal(got, k9.guided_filter_chain_plain(g, s, 5, 3.0, 2))
    # the CPU launches nothing
    assert (k9.guide_stats.launches,
            k9.guided_apply_cached.launches) == before


@pytest.mark.parametrize("shape,radius", [((2, 30, 40), 4), ((1, 12, 40), 45)])
def test_guide_stats_match_jax_formulas(shape, radius, rng):
    """guide_stats_plain against the statistics formed from the JAX
    package's _guided_filter_color_planar formulas (box means over its
    Pallas box in interpret mode, cofactors times 1/det)."""
    n, h, w = shape
    g = _u8(rng, n, 3, h, w)
    I = jnp.asarray(g)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    planes = jnp.concatenate(
        [I, jnp.stack([I[:, a] * I[:, b] for a, b in pairs], axis=1)], axis=1)
    with pltpu.force_tpu_interpret_mode():
        m = jg._box_planar(planes.reshape(n * 9, h, w), radius).reshape(
            n, 9, h, w)
    mI, eps = m[:, :3], 3.0
    rr = m[:, 3] - mI[:, 0] * mI[:, 0] + eps
    rg = m[:, 4] - mI[:, 0] * mI[:, 1]
    rb = m[:, 5] - mI[:, 0] * mI[:, 2]
    gg = m[:, 6] - mI[:, 1] * mI[:, 1] + eps
    gb = m[:, 7] - mI[:, 1] * mI[:, 2]
    bb = m[:, 8] - mI[:, 2] * mI[:, 2] + eps
    cof = [gg * bb - gb * gb, gb * rb - rg * bb, rg * gb - gg * rb,
           rr * bb - rb * rb, rb * rg - rr * gb, rr * gg - rg * rg]
    inv_det = 1.0 / (rr * cof[0] + rg * cof[1] + rb * cof[2])
    exp = np.asarray(jnp.concatenate(
        [mI, jnp.stack([c * inv_det for c in cof], axis=1)], axis=1))
    got = k9.guide_stats_plain(torch.from_numpy(g), radius, eps).numpy()
    assert got.shape == (n, 9, h, w)
    for k in range(9):
        scale = np.abs(exp[:, k]).max()
        assert np.abs(got[:, k] - exp[:, k]).max() <= 1e-4 * scale, k


def test_wrappers_check_their_inputs(rng):
    g = torch.from_numpy(_u8(rng, 1, 3, 9, 10))
    s = torch.from_numpy(_u8(rng, 1, 2, 9, 10))
    st = k9.guide_stats(g, 2, 3.0)
    with pytest.raises(ValueError, match=r"\[N, 3, H, W\]"):
        k9.guide_stats(g[:, :2].contiguous(), 2, 3.0)
    with pytest.raises(TypeError):
        k9.guide_stats(g.double(), 2, 3.0)
    with pytest.raises(ValueError, match="radius"):
        k9.guide_stats(g, -1, 3.0)
    with pytest.raises(ValueError, match="src"):
        k9.guided_apply_cached(st, g, s[..., :5].contiguous(), 2)
    with pytest.raises(ValueError, match="9 planes"):
        k9.guided_apply_cached(st[:, :8].contiguous(), g, s, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k9.guided_apply_cached(st, g, s[:, :, :, ::2], 2)
