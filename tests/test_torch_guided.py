"""The port's guided filter (ops/guided.py, K5's plain version in
ops/guided_kernel.py) and the GF(CNN, image) slice against the JAX
package, on the CPU, with inputs made from numpy seeds.

Gates, each with its reason:
  * float paths: rtol 1e-3, atol 0.05 (tests/test_pallas_ops.py holds the
    JAX package's own guided paths to each other so);
  * uint8 outputs: within 1 level (the reference's parity contract; the
    golden fixtures come from an independent C++ transcription);
  * the slice: within 1 level and |dWHDR| <= 0.001.
"""
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.cli import filter as jfilt
from reflectance_filtering_tpu.losses.whdr import (
    whdr_batch as j_whdr_batch)
from reflectance_filtering_tpu.models.networks import (
    reference_params_from_caffe, reflectance_net_apply)
from reflectance_filtering_tpu.ops import guided as jg
from reflectance_filtering_tpu.ops.guided_mxu import guided_filter_mxu
from reflectance_filtering_tpu.ops.guided_pallas import (
    guided_filter_fused as j_guided_fused)
from reflectance_filtering_tpu.utils.image import srgb_to_rgb_jnp
from reflectance_filtering_tpu_torch.cli import filter as tfilt
from reflectance_filtering_tpu_torch.losses.whdr import whdr_batch
from reflectance_filtering_tpu_torch.models.networks import (
    ReflectanceNet, params_from_numpy, seeded_reference_params)
from reflectance_filtering_tpu_torch.ops import guided as tg
from reflectance_filtering_tpu_torch.ops.guided_kernel import (
    guided_filter_fused, guided_filter_fused_plain)
from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn
from reflectance_filtering_tpu_torch.utils.testimages import (
    make_synthetic_comps)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from guided_cpp_oracle import guided_filter_cpp_color  # noqa: E402
from make_guided_fixtures import FIXTURE  # noqa: E402
from test_torch_pipeline import _photos  # noqa: E402

RTOL, ATOL = 1e-3, 0.05
COMBOS = [(r, e) for r in (3, 45, 52) for e in (3.0, 7.0)]
SEED = 7


def _u8(rng, *shape):
    return np.floor(rng.rand(*shape) * 256).astype(np.float32)


def _within_one_level(got, exp, tag=""):
    d = np.abs(got.astype(np.int32) - exp.astype(np.int32))
    assert got.shape == exp.shape, tag
    assert d.max() <= 1, (tag, int(d.max()), int((d > 1).sum()))


@pytest.mark.parametrize("c", [1, 3])
def test_plain_matches_mxu_kernel_interpret(c, rng):
    """K5's plain version against the whole-plane TPU kernel (kernel 14)
    at an odd size."""
    g, s = _u8(rng, 2, 3, 41, 53), _u8(rng, 2, c, 41, 53)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(guided_filter_mxu(jnp.asarray(g), jnp.asarray(s),
                                           8, 9.0))
    got = guided_filter_fused_plain(torch.from_numpy(g), torch.from_numpy(s),
                                    8, 9.0).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


def test_plain_matches_two_stage_kernel_interpret(rng):
    """K5's plain version against the two-stage TPU kernel (kernel 15)."""
    g, s = _u8(rng, 2, 3, 16, 128), _u8(rng, 2, 1, 16, 128)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(j_guided_fused(jnp.asarray(g), jnp.asarray(s), 4,
                                        9.0))
    got = guided_filter_fused_plain(torch.from_numpy(g), torch.from_numpy(s),
                                    4, 9.0).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


def test_generic_planar_matches_xla_planar(rng):
    """The generic planar path (over K4's wrapper) against the JAX one
    (over the Pallas box, interpret mode), two src channels."""
    g, s = _u8(rng, 2, 3, 30, 40), _u8(rng, 2, 2, 30, 40)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jg._guided_filter_planar_xla(
            jnp.asarray(g), jnp.asarray(s), 4, 9.0))
    got = tg._guided_filter_color_planar(torch.from_numpy(g),
                                         torch.from_numpy(s), 4, 9.0).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(40, 512), (20, 512), (12, 40)])
def test_degenerate_radius_matches_oracle(shape):
    """radius 45 >= a dimension: repeated reflection, against the C++
    transcription oracle (the shapes of tests/test_guided_golden.py)."""
    h, w = shape
    rng = np.random.RandomState(3)
    g8 = np.floor(rng.rand(h, w, 3) * 256).astype(np.uint8)
    s8 = np.floor(rng.rand(h, w) * 256).astype(np.uint8)
    want = guided_filter_cpp_color(g8, s8, 45, 3.0)
    q = guided_filter_fused(
        torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(g8, -1, 0)[None], dtype=np.float32)),
        torch.from_numpy(s8[None, None].astype(np.float32)), 45, 3.0)
    got = np.clip(np.rint(q[0, 0].numpy()), 0, 255).astype(np.uint8)
    _within_one_level(got, want, str(shape))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("gray", [False, True])
def test_guided_filter_hwc_matches_jax(gray, batched, rng):
    """The HWC entry: color guide (K5's path) and gray guide (the scalar
    formulas over K4's path), with a 2-channel and a 2-D src."""
    lead = (2,) if batched else ()
    g = _u8(rng, *lead, 26, 33, 3)
    if gray:
        g = g[..., 0]
    for s in (_u8(rng, *lead, 26, 33, 2), _u8(rng, *lead, 26, 33)):
        exp = np.asarray(jg.guided_filter(jnp.asarray(g), jnp.asarray(s), 5,
                                          7.0, batched=batched))
        got = tg.guided_filter(g, s, 5, 7.0, batched=batched).numpy()
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="guide shape"):
        tg.guided_filter(g[..., None], s, 5, 7.0, batched=batched)


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", ["color", "colorsrc", "gray"])
@pytest.mark.parametrize("radius,eps", COMBOS)
def test_guided_u8_matches_golden_fixtures(golden, radius, eps, kind):
    key = "small" if radius == 3 else "big"
    tag = "r{}_e{}".format(radius, int(eps))
    guide = golden["img_{}_guide_{}".format(
        key, "gray" if kind == "gray" else "color")]
    src = guide if kind == "colorsrc" else golden["img_{}_src".format(key)]
    got = tg.guided_filter_u8(guide, src, radius, eps, device="cpu")
    assert got.dtype == np.uint8
    _within_one_level(got, golden["out_{}_{}".format(tag, kind)],
                      tag + "_" + kind)


def test_guided_u8_mono_src_matches_jax(rng):
    """A src of three equal channels (the CNN's -r.png) is filtered once
    and replicated: the same bytes as the JAX package's filter."""
    g = np.floor(rng.rand(30, 41, 3) * 256).astype(np.uint8)
    s = np.repeat(np.floor(rng.rand(30, 41, 1) * 256).astype(np.uint8), 3,
                  axis=-1)
    exp = jg.guided_filter_u8(g, s, 8, 3.0)
    got = tg.guided_filter_u8(g, s, 8, 3.0, device="cpu")
    _within_one_level(got, exp)
    assert (got == got[..., :1]).all()


@pytest.mark.parametrize("gray_guide", [False, True])
def test_fast_guided_u8_matches_jax(gray_guide, rng):
    """--subsample 4 at an odd size: the antialiased bilinear downsample
    and the plain upsample against jax.image.resize.  Float gate 0.05
    (the resizes agree to ~1e-4 in 0-255 units), uint8 within 1 level."""
    g = np.floor(rng.rand(97, 131, 3) * 256).astype(np.uint8)
    if gray_guide:
        g = g[..., 0]
    s = np.floor(rng.rand(97, 131) * 256).astype(np.uint8)
    _within_one_level(
        tg.fast_guided_filter_u8(g, s, 8, 3.0, 4, device="cpu"),
        jg.fast_guided_filter_u8(g, s, 8, 3.0, 4))
    g3 = (g if g.ndim == 3 else np.repeat(g[..., None], 3, -1)).astype(
        np.float32)
    gp, sp = np.moveaxis(g3, -1, 0)[None], s[None, None].astype(np.float32)
    exp = np.asarray(jg.fast_guided_filter(jnp.asarray(gp), jnp.asarray(sp),
                                           8, 3.0, 4))
    got = tg.fast_guided_filter(torch.from_numpy(gp), torch.from_numpy(sp),
                                8, 3.0, 4).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


def test_fast_subsample_one_is_exact(rng):
    g = np.floor(rng.rand(20, 24, 3) * 256).astype(np.uint8)
    s = np.floor(rng.rand(20, 24) * 256).astype(np.uint8)
    np.testing.assert_array_equal(
        tg.fast_guided_filter_u8(g, s, 4, 3.0, 1, device="cpu"),
        tg.guided_filter_u8(g, s, 4, 3.0, device="cpu"))


def test_wrapper_cpu_dispatch_and_checks(rng):
    g = torch.from_numpy(_u8(rng, 1, 3, 9, 10))
    s = torch.from_numpy(_u8(rng, 1, 2, 9, 10))
    before = guided_filter_fused.launches
    np.testing.assert_array_equal(guided_filter_fused(g, s, 2, 3.0).numpy(),
                                  guided_filter_fused_plain(g, s, 2,
                                                            3.0).numpy())
    assert guided_filter_fused.launches == before   # the CPU launches nothing
    with pytest.raises(ValueError):
        guided_filter_fused(g[:, :2].contiguous(), s, 2, 3.0)
    with pytest.raises(ValueError):
        guided_filter_fused(g, s[..., :5].contiguous(), 2, 3.0)
    with pytest.raises(TypeError):
        guided_filter_fused(g.double(), s, 2, 3.0)
    with pytest.raises(ValueError, match="radius"):
        guided_filter_fused(g, s, -1, 3.0)


@pytest.mark.parametrize("n,h,w,planes,ok", [
    (65535, 65535, 1, 1, True),        # y and z at the limit
    (65536, 1, 1, 1, False),           # the row pass's z = n
    (1, 65536, 1, 1, False),           # the row pass's y = h
    (16383, 8, 8, 4, True),            # the (a, b) column sums' z = 4n
    (16384, 8, 8, 4, False),
    (5461, 8, 8, 12, True),            # C = 3: 12 planes
    (5462, 8, 8, 12, False),
    (1, 4, 2 ** 31 - 1, 1, True),      # the widest int w
    (1, 4, 2 ** 31, 1, False),         # w past the kernels' int
])
def test_check_grid_at_the_geometrys_limits(n, h, w, planes, ok):
    """check_grid refuses exactly the shapes whose grids exceed CUDA's
    limits: a row pass's y = h and z = n, a column pass's z = n * planes
    (its y, ceil(h / segment), is at most h), and a w past int."""
    from reflectance_filtering_tpu_torch.ops.guided_kernel import check_grid
    if ok:
        check_grid("t", n, h, w, planes)
    else:
        with pytest.raises(ValueError, match="grid limit"):
            check_grid("t", n, h, w, planes)


@pytest.mark.parametrize("c,widest", [(1, 512), (2, 426), (3, 345)])
def test_fused_path_at_its_limits(c, widest):
    """The wrapper's mirror of csrc/guided.cu: the fused pair takes frames
    up to ``widest`` columns (a thread per column up to 512, and the
    stats-and-solve block's float64 column sums and prefixes, 2 x (9 + 4c)
    x (2w + 1) doubles, within a block's shared memory), the four passes
    the rest; a forced path is taken as asked."""
    from reflectance_filtering_tpu_torch.ops import guided_kernel as k5
    assert k5.fused_fits(c, widest) and not k5.fused_fits(c, widest + 1)
    assert k5.fused_path(c, widest) and not k5.fused_path(c, widest + 1)
    assert k5.fused_smem(9 + 4 * c, widest) <= k5.SMEM_LIMIT
    if widest < k5.FUSED_WIDEST:
        assert k5.fused_smem(9 + 4 * c, widest + 1) > k5.SMEM_LIMIT
    assert k5.fused_path(c, 40, "four-pass") is False
    assert k5.fused_path(c, 4000, "fused") is True


@pytest.mark.parametrize("n,c,h,w,band", [
    (32, 1, 256, 256, 32), (32, 3, 256, 256, 32), (30, 1, 256, 256, 32),
    (29, 1, 256, 256, 16), (16, 1, 256, 256, 16), (8, 1, 256, 256, 8),
    (1, 1, 256, 256, 8), (1, 1, 3800, 512, 32), (1, 1, 3776, 512, 16),
    (1, 3, 96, 128, 8)])
def test_fused_band_rule(n, c, h, w, band):
    """The fused blocks' rows (``fused_band``, 132 SMs): 32 where the grid
    fills 90% of the slots the solve block's shared memory leaves (2 an SM
    at 32 x 256x256 and C = 1, 1 at C = 3 or 512 columns), else 16 where
    that does, else 8; the served batch takes 32, the band measured
    fastest there."""
    from reflectance_filtering_tpu_torch.ops.guided_kernel import fused_band
    assert fused_band(n, c, h, w) == band


def test_wrapper_refuses_a_bad_path(rng):
    g = torch.from_numpy(_u8(rng, 1, 3, 9, 10))
    s = torch.from_numpy(_u8(rng, 1, 1, 9, 10))
    with pytest.raises(ValueError, match="path"):
        guided_filter_fused(g, s, 2, 3.0, path="three-pass")


def _jax_gf(params, img):
    """The JAX package's gf pipeline, XLA form (utils/serving.py:98-116),
    on seeded weights."""
    p = reference_params_from_caffe(params)
    x = jnp.asarray(img)[:, ::-1].astype(jnp.float32) / 255.0
    refl = reflectance_net_apply(p, srgb_to_rgb_jnp(jnp.moveaxis(x, 1, -1)))
    r_u8 = jnp.floor(refl[..., 0] * 255.0)
    guide = jnp.asarray(img)[:, ::-1].astype(jnp.float32)
    q = jg.guided_filter(jnp.moveaxis(guide, 1, -1), r_u8, 45, 3.0,
                         batched=True)
    return jnp.clip(jnp.round(q), 0.0, 255.0)


def test_gf_slice_matches_jax():
    params = seeded_reference_params(SEED)
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(params))
    img = _photos(SEED, 2, 48, 64)
    comps = make_synthetic_comps(SEED, 300, batch=2)
    with torch.no_grad():
        q = pipeline_fn("gf", net, "cpu")(torch.from_numpy(img))
        score = whdr_batch(q / 255.0, torch.from_numpy(comps)).item()
    j_q = np.asarray(_jax_gf(params, img))
    j_score = float(j_whdr_batch((jnp.asarray(j_q) / 255.0)[..., None],
                                 jnp.asarray(comps)))
    q = q.numpy()
    assert q.shape == j_q.shape == (2, 48, 64)
    assert np.all(q == np.round(q)) and q.min() >= 0 and q.max() <= 255
    assert np.unique(q).size > 20               # the filter had real work
    _within_one_level(q, j_q)
    assert abs(score - j_score) <= 1e-3


@pytest.mark.parametrize("subsample", [1, 4])
def test_guided_cli_matches_jax_cli(subsample, tmp_path, capsys):
    """filter --filter_type=guided c3 s45 (exact, and --subsample=4) on a
    photo and a reflectance-like gray PNG, against the JAX CLI."""
    img = _photos(SEED + 2, 2, 60, 76)
    photo, refl = str(tmp_path / "photo.png"), str(tmp_path / "photo-r.png")
    cv2.imwrite(photo, np.moveaxis(img[0], 0, -1))
    cv2.imwrite(refl, img[1, 0])
    tout, jout = tmp_path / "port", tmp_path / "jax"
    tout.mkdir()
    jout.mkdir()
    tfilt.main(["--filter_type=guided", "--sigma_color=3",
                "--sigma_spatial=45", "--subsample={}".format(subsample),
                "--filename_in", refl, "--guidance_in", photo,
                "--path_out", str(tout), "--device", "cpu"])
    assert ("APPROXIMATE" in capsys.readouterr().err) == (subsample > 1)
    jfilt.read_filter_write("guided", refl, photo, 3.0, 45.0, str(jout),
                            subsample=subsample)
    name = "photo-r_guided{}_c3.0s45.0.png".format(
        "_sub4" if subsample > 1 else "")
    got = cv2.imread(str(tout / name))
    exp = cv2.imread(str(jout / name))
    assert got is not None and exp is not None
    _within_one_level(got, exp, name)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
