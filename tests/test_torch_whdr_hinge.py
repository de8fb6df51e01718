"""The port's WHDR hinge family (losses/whdr.py) and the differentiable
point-pair gather (ops/whdr_gather.py: K3 forward, K8 backward, here their
plain versions) against the JAX package: its hinge through the XLA gather
and through its MXU gather kernels (TPU kernels 5 and 6) in TPU-interpret
mode.

Tolerances: hinge values within 1e-5 relative; the gradient with respect to
the reflectance within 1e-5 of its largest entry (float32 rounding of the
same formulas; the MXU kernels' bf16x3 splits reconstruct float32 to about
an ulp)."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.ops.whdr_gather_pallas import (
    gather_pairs as j_gather_pairs)
from reflectance_filtering_tpu_torch.losses import whdr as tw
from reflectance_filtering_tpu_torch.ops.whdr_gather import (
    gather_pairs, scatter_pairs, scatter_pairs_plain)
from tests.test_whdr import make_blob, random_comps

# the module (the package re-exports a function of the same name)
jw = importlib.import_module("reflectance_filtering_tpu.losses.whdr")

EPS = np.float32(np.finfo(np.float32).eps)


def _blobs(rng, b, k, nums, darker=(0, 1, 2)):
    return np.stack([make_blob(random_comps(rng, n, darker), k)
                     for n in nums]).astype(np.float32)


def _jax_hinge(refl, comps, wdm, mxu, monkeypatch):
    delta, margin, ratio, dense = jw.parse_wdm_string(wdm)
    monkeypatch.setattr(jw, "FORCE_MXU_GATHER", mxu)

    def f(r):
        return jw.whdr_hinge_batch(r, jnp.asarray(comps), delta, margin,
                                   ratio, dense, jax.random.PRNGKey(0))

    with pltpu.force_tpu_interpret_mode():
        v, g = jax.value_and_grad(f)(jnp.asarray(refl))
    return float(v), np.asarray(g)


def _torch_hinge(refl, comps, wdm):
    delta, margin, ratio, dense = tw.parse_wdm_string(wdm)
    r = torch.from_numpy(refl).requires_grad_()
    v = tw.whdr_hinge_batch(r, torch.from_numpy(comps), delta, margin, ratio,
                            dense, torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad(v, r)
    return v.item(), g.numpy()


def _assert_match(got, want):
    (v, g), (jv, jg) = got, want
    assert np.isfinite(g).all()
    assert abs(v - jv) <= 1e-5 * max(abs(jv), 1e-30)
    assert np.abs(g - jg).max() <= 1e-5 * np.abs(jg).max()


@pytest.mark.parametrize("mxu", [True, False])
@pytest.mark.parametrize("case,wdm,nums,k,channels", [
    ("base", "0.1_0.05_1.0_1", (120, 0, 299), 300, 3),
    ("gray plane", "0.1_0.05_1.0_1", (200, 57), 240, None),
    ("ratio < 1", "0.1_0.05_0.6_1", (25, 199, 300), 300, 1),
    ("dense-skip", "0.1_0.05_1.0_0", (350, 120), 400, 3),
    ("margin > delta", "0.1_0.2_1.0_1", (180, 240), 240, 3)])
def test_hinge_batch_matches_jax(case, wdm, nums, k, channels, mxu, rng,
                                 monkeypatch):
    b, h, w = len(nums), 24, 31
    shape = (b, h, w) if channels is None else (b, h, w, channels)
    refl = (rng.rand(*shape) * 0.9 + 0.05).astype(np.float32)
    comps = _blobs(rng, b, k, nums)
    want = _jax_hinge(refl, comps, wdm, mxu, monkeypatch)
    _assert_match(_torch_hinge(refl, comps, wdm), want)


@pytest.mark.parametrize("mxu", [True, False])
def test_cap_through_host_selection_matches_jax(mxu, rng, monkeypatch):
    """K > 1500: both packages select on the host with the same
    RandomState (identical blobs), then the hinge runs on the compact blob
    as fit() runs it (ratio 1, dense)."""
    b, h, w, k = 2, 40, 48, 1800
    comps = _blobs(rng, b, k, (1700, 400))
    sel = [mod.select_comparisons_host(comps, 1.0, True,
                                       np.random.RandomState([7, 3]))
           for mod in (jw, tw)]
    np.testing.assert_array_equal(sel[0], sel[1])
    assert sel[0].shape == (b, 1501, 6) and sel[0][0, -1, 0] == 1500
    refl = (rng.rand(b, h, w, 3) * 0.9 + 0.05).astype(np.float32)
    want = _jax_hinge(refl, sel[0], "0.1_0.05_1.0_1", mxu, monkeypatch)
    _assert_match(_torch_hinge(refl, sel[1], "0.1_0.05_1.0_1"), want)


@pytest.mark.parametrize("value", [EPS, 0.0])
def test_lightness_on_and_below_eps_matches_jax(value, rng, monkeypatch):
    """A pixel whose lightness sits exactly on eps splits the floor's
    gradient 0.5/0.5 (jnp.maximum; torch.clamp would pass all of it); one at
    0 (a black pixel) gets none."""
    b, h, w, k = 2, 12, 14, 200
    refl = (rng.rand(b, h, w) * 0.9 + 0.05).astype(np.float32)
    refl[:, :6, :] = value
    comps = _blobs(rng, b, k, (200, 150))
    got = _torch_hinge(refl, comps, "0.1_0.05_1.0_1")
    _assert_match(got, _jax_hinge(refl, comps, "0.1_0.05_1.0_1", False,
                                  monkeypatch))
    if value == EPS:
        assert np.abs(got[1][:, :6, :]).max() > 0
    else:
        assert np.abs(got[1][:, :6, :]).max() == 0


def test_single_image_hinge_matches_jax(rng):
    refl = (rng.rand(19, 26, 3) * 0.9 + 0.05).astype(np.float32)
    comps = make_blob(random_comps(rng, 150), 250)
    jv, jg = jax.value_and_grad(lambda r: jw.whdr_hinge(
        r, jnp.asarray(comps)))(jnp.asarray(refl))
    r = torch.from_numpy(refl).requires_grad_()
    v = tw.whdr_hinge(r, torch.from_numpy(comps))
    (g,) = torch.autograd.grad(v, r)
    _assert_match((v.item(), g.numpy()), (float(jv), np.asarray(jg)))


def test_gather_grad_is_scatter_add_with_collisions(rng):
    """gather_pairs' backward sums every point's cotangent into its pixel;
    a 5x4 plane read by 2 x 300 points forces collisions.  Against numpy's
    add.at and the JAX package's MXU gather backward (TPU kernel 6)."""
    b, h, w, k = 2, 5, 4, 300
    plane = rng.rand(b, h, w).astype(np.float32)
    idx = [rng.randint(0, n, (b, k)).astype(np.int32) for n in (h, w, h, w)]
    w1, w2 = (rng.randn(b, k).astype(np.float32) for _ in range(2))
    p = torch.from_numpy(plane).requires_grad_()
    before = (gather_pairs.launches, scatter_pairs.launches)
    l1, l2 = gather_pairs(p, *(torch.from_numpy(i) for i in idx))
    (g,) = torch.autograd.grad((l1 * torch.from_numpy(w1)
                                + l2 * torch.from_numpy(w2)).sum(), p)
    assert (gather_pairs.launches, scatter_pairs.launches) == before
    ref = np.zeros((b, h, w), np.float64)
    bi = np.arange(b)[:, None]
    np.add.at(ref, (bi, idx[0], idx[1]), w1)
    np.add.at(ref, (bi, idx[2], idx[3]), w2)
    assert np.abs(g.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()

    def f(im):
        a, c = j_gather_pairs(im, *(jnp.asarray(i) for i in idx))
        return jnp.sum(a * w1 + c * w2)

    with pltpu.force_tpu_interpret_mode():
        jg = np.asarray(jax.grad(f)(jnp.asarray(plane)))
    assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_scatter_wrapper_checks_and_one_sided_grad(rng):
    b, h, w, k = 1, 6, 7, 20
    idx = [torch.from_numpy(rng.randint(0, n, (b, k)).astype(np.int32))
           for n in (h, w, h, w)]
    g1 = torch.from_numpy(rng.rand(b, k).astype(np.float32))
    out = scatter_pairs((b, h, w), *idx, g1, torch.zeros_like(g1))
    assert torch.equal(out, scatter_pairs_plain((b, h, w), *idx, g1,
                                                torch.zeros_like(g1)))
    with pytest.raises(TypeError):
        scatter_pairs((b, h, w), *idx, g1.double(), g1)
    with pytest.raises(ValueError):
        scatter_pairs((b, h, w), *idx, g1[:, :5].contiguous(), g1)
    # only l1 used: the missing cotangent of l2 counts as zero
    p = torch.rand(b, h, w, requires_grad=True)
    l1, _ = gather_pairs(p, *idx)
    (g,) = torch.autograd.grad(l1.sum(), p)
    assert torch.equal(g, scatter_pairs_plain((b, h, w), *idx,
                                              torch.ones_like(g1),
                                              torch.zeros_like(g1)))


def test_selection_mask_cap_draws_from_generator(rng):
    """On the device path (no host selection) the cap keeps exactly 1500
    of an image's rows, drawn from the generator: the same generator state
    draws the same rows.  Without a generator it raises rather than draw."""
    k = 1600
    valid = torch.ones(2, k, dtype=torch.bool)
    num = torch.tensor([1600, 900], dtype=torch.int32)
    with pytest.raises(ValueError, match="select_comparisons_host"):
        tw._eval_selection_mask(valid, num, 1.0, True, None, k)
    masks = [tw._eval_selection_mask(valid, num, 1.0, True,
                                     torch.Generator().manual_seed(5), k)
             for _ in range(2)]
    assert torch.equal(masks[0], masks[1])
    assert masks[0].sum(dim=1).tolist() == [1500, 900]
    assert masks[0][1, :900].all() and not masks[0][1, 900:].any()


@pytest.mark.parametrize("wdm", ["", "0.1_0.05_1.0_1", "0.2_0.1_0.5_0"])
def test_parse_wdm_string_matches_jax(wdm):
    assert tw.parse_wdm_string(wdm) == jw.parse_wdm_string(wdm)
    with pytest.raises(ValueError):
        tw.parse_wdm_string("0.1_0.05")
