"""K6's plain versions (ops/bilateral_joint_kernel.py) and the bilateral
dispatch on every input case (ops/bilateral.py::joint_bilateral_filter_u8,
the filter CLI) against the JAX package, on the CPU, with inputs made from
numpy seeds.

Gates, each with its reason:
  * against the Pallas kernels 7-11 in TPU-interpret mode: rtol 1e-4,
    atol 2e-3 (tests/test_pallas_ops.py holds the JAX package's own
    bilateral paths to each other so);
  * uint8 outputs against the JAX dispatch: within 1 level on every pixel
    and equal on >= 99.9% (the reference's parity contract);
  * color self-guided against cv2.bilateralFilter: within 1 level, under
    2% differing (tests/test_golden_gate.py's gate for the same oracle).
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.cli import filter as jfilt
from reflectance_filtering_tpu.ops import bilateral as jbil
from reflectance_filtering_tpu.ops import bilateral_pallas as jbp
from reflectance_filtering_tpu_torch.cli import filter as tfilt
from reflectance_filtering_tpu_torch.ops import bilateral as tbil
from reflectance_filtering_tpu_torch.ops import bilateral_joint_kernel as k6

from test_torch_pipeline import _photos

RTOL, ATOL = 1e-4, 2e-3
N, H, W = 2, 24, 40
SIGMA_C, SIGMA_S = 20.0, 3.0          # radius 4 (round(4.5) is even)


def _u8(rng, *shape):
    return np.floor(rng.rand(*shape) * 256).astype(np.float32)


def _u8_gate(got, exp):
    d = np.abs(got.astype(int) - exp.astype(int))
    assert got.dtype == np.uint8 and got.shape == exp.shape
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                       (d == 0).mean())


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("packed", [False, True])
def test_color_self_matches_pallas_interpret(n, packed, rng):
    """Kernel 8, and at packed=True its lane-packed twin, kernel 9."""
    x = _u8(rng, n, 3, H, W)
    fn = (jbp.bilateral_color_self_packed_batched if packed
          else jbp.bilateral_color_self_batched)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(fn(jnp.asarray(x), -1, SIGMA_C, SIGMA_S))
    got = k6.bilateral_color_self_batched(torch.from_numpy(x), -1, SIGMA_C,
                                          SIGMA_S).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cj,cs", [(3, 1), (3, 3), (1, 1), (1, 3)])
@pytest.mark.parametrize("n,auto_pack", [(2, False), (3, True)])
def test_packed_joint_matches_pallas_interpret(cj, cs, n, auto_pack, rng):
    """Kernel 10, and at n=3 with auto_pack its lane-packed twin, kernel
    11; a 1-plane joint stands for 3 replicated channels."""
    joint, src = _u8(rng, n, cj, H, W), _u8(rng, n, cs, H, W)
    reps = 3 if cj == 1 else 1
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jbp.bilateral_packed_joint_batched(
            jnp.asarray(joint), jnp.asarray(src), -1, SIGMA_C, SIGMA_S,
            joint_reps=reps, auto_pack=auto_pack))
    got = k6.bilateral_packed_joint_batched(
        torch.from_numpy(joint), torch.from_numpy(src), -1, SIGMA_C,
        SIGMA_S, joint_reps=reps).numpy()
    assert got.shape == (n, cs, H, W)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cs", [1, 3])
def test_float_generic_matches_pallas_interpret(cs, rng):
    """Kernel 7 on non-integer values."""
    joint = (rng.rand(N, 3, H, W) * 255).astype(np.float32)
    src = (rng.rand(N, cs, H, W) * 255).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jbp.joint_bilateral_planar_batched(
            jnp.asarray(joint), jnp.asarray(src), -1, 30.0, SIGMA_S))
    got = k6.joint_bilateral_planar_batched(
        torch.from_numpy(joint), torch.from_numpy(src), -1, 30.0,
        SIGMA_S).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("joint_ndim,src_ndim", [(2, 3), (3, 2), (3, 3)])
def test_fast_adapter_matches_jax(joint_ndim, src_ndim, rng):
    """The HWC adapter: a 2-D joint is cv2's 1-channel rule (the JAX
    adapter's 3 planes at 3x sigma_color, here one plane)."""
    joint = (rng.rand(H, W, 3) * 255).astype(np.float32)
    src = (rng.rand(H, W, 3) * 255).astype(np.float32)
    joint = joint[..., 0] if joint_ndim == 2 else joint
    src = src[..., 1] if src_ndim == 2 else src
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jbp.joint_bilateral_filter_fast(
            joint, src, -1, SIGMA_C, SIGMA_S))
    got = k6.joint_bilateral_filter_fast(joint, src, -1, SIGMA_C,
                                         SIGMA_S).numpy()
    assert got.shape == src.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


DISPATCH_CASES = ["gray_self_3ch", "gray_self_2d", "color_self",
                  "bf_refl_photo", "gray3_joint_color_src",
                  "joint_2d_src_color", "joint_color_src_2d",
                  "bf_refl_photo_r33"]


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_u8_dispatch_matches_jax(case, rng):
    """Every branch of joint_bilateral_filter_u8 on the CPU against the JAX
    dispatch (off the TPU, the XLA tap scan).  bf_refl_photo_r33 runs the
    README's c20 s22 (radius 33) on a 40 x 48 image: reflection repeats."""
    h, w, sigma_space = 26, 31, SIGMA_S
    if case == "bf_refl_photo_r33":
        h, w, sigma_space = 40, 48, 22.0
    g = np.floor(rng.rand(h, w) * 256).astype(np.uint8)
    g3 = np.stack([g] * 3, axis=-1)
    color = np.floor(rng.rand(h, w, 3) * 256).astype(np.uint8)
    joint, src = {
        "gray_self_3ch": (g3, g3),        # the BF(CNN,CNN) -r.png
        "gray_self_2d": (g, g),
        "color_self": (color, color),     # cv2.bilateralFilter
        "bf_refl_photo": (color, g3),     # BF(-r.png, photo)
        "gray3_joint_color_src": (g3, color),
        "joint_2d_src_color": (g, color),
        "joint_color_src_2d": (color, g),
        "bf_refl_photo_r33": (color, g3),
    }[case]
    exp = jbil.joint_bilateral_filter_u8(joint, src, -1, SIGMA_C,
                                         sigma_space)
    got = tbil.joint_bilateral_filter_u8(joint, src, -1, SIGMA_C,
                                         sigma_space, device="cpu")
    _u8_gate(got, exp)


@pytest.mark.parametrize("shape,sc,ss", [((45, 67), 20.0, 22.0),
                                         ((48, 64), 30.0, 8.0)])
def test_color_self_matches_opencv(shape, sc, ss):
    img = np.moveaxis(_photos(11, 1, *shape)[0], 0, -1).copy()
    ref = cv2.bilateralFilter(img, -1, sc, ss)
    got = tbil.joint_bilateral_filter_u8(img, img, -1, sc, ss, device="cpu")
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("case", ["bf_refl_photo", "color_self"])
def test_bilateral_cli_matches_jax_cli(case, tmp_path):
    """filter --filter_type=bilateral c20 s22 through read_filter_write on
    the CPU, against the JAX CLI: the -r.png guided by the photo, and the
    photo by itself."""
    img = _photos(13, 2, 40, 52)
    photo, refl = str(tmp_path / "photo.png"), str(tmp_path / "photo-r.png")
    cv2.imwrite(photo, np.moveaxis(img[0], 0, -1))
    cv2.imwrite(refl, img[1, 0])
    src = refl if case == "bf_refl_photo" else photo
    tout, jout = tmp_path / "port", tmp_path / "jax"
    tout.mkdir()
    jout.mkdir()
    got = tfilt.read_filter_write("bilateral", src, photo, 20.0, 22.0,
                                  str(tout), device="cpu")
    exp = jfilt.read_filter_write("bilateral", src, photo, 20.0, 22.0,
                                  str(jout))
    name = "{}_bilateral_c20.0s22.0.png".format(
        "photo-r" if case == "bf_refl_photo" else "photo")
    _u8_gate(got, np.asarray(exp))
    _u8_gate(cv2.imread(str(tout / name)), cv2.imread(str(jout / name)))


def test_wrappers_cpu_dispatch_and_checks(rng):
    """A CPU tensor runs the plain version (the exp form for the float
    wrapper, the table form for the u8 ones) and counts no launch; shapes
    and plane counts without a kernel raise; every (cj, cs) fits radius 33
    (the repo's sweeps go up to sigma_s 22), and the float 3 + 3 planes
    stop at 37."""
    x = torch.from_numpy(_u8(rng, 1, 3, 9, 10))
    wrappers = (k6.joint_bilateral_planar_batched,
                k6.bilateral_color_self_batched,
                k6.bilateral_packed_joint_batched)
    before = [fn.launches for fn in wrappers]
    radius, gcc, gsc, _ = tbil.opencv_bilateral_params(-1, 20.0, 2.0)
    for fn in wrappers:
        got = fn(x, -1, 20.0, 2.0) if fn is k6.bilateral_color_self_batched \
            else fn(x, x, -1, 20.0, 2.0)
        exp = k6.bilateral_joint_plain(
            x, x, radius, gcc, gsc,
            u8=fn is not k6.joint_bilateral_planar_batched)
        np.testing.assert_array_equal(got.numpy(), exp.numpy())
    assert [fn.launches for fn in wrappers] == before
    with pytest.raises(ValueError, match="1 or 3"):
        k6.bilateral_packed_joint_batched(x[:, :2].contiguous(), x)
    with pytest.raises(ValueError, match="share N, H, W"):
        k6.joint_bilateral_planar_batched(x, x[:, :, :8].contiguous())
    with pytest.raises(ValueError):
        k6.bilateral_color_self_batched(x[:, :1].contiguous())
    with pytest.raises(TypeError):
        k6.bilateral_color_self_batched(x.double())
    for self_guided, u8, pairs in ((True, True, [(3, 3)]),
                                   (False, True, [(1, 1), (1, 3), (3, 1),
                                                  (3, 3)]),
                                   (False, False, [(1, 1), (1, 3), (3, 1),
                                                   (3, 3)])):
        for cj, cs in pairs:
            r = k6.max_radius(cj, cs, self_guided, u8)
            assert r >= 33, (cj, cs, self_guided, u8, r)
            assert (k6.smem_bytes(cj, cs, self_guided, u8, r)
                    <= k6.SMEM_LIMIT
                    < k6.smem_bytes(cj, cs, self_guided, u8, r + 1))
    assert k6.max_radius(3, 3, False, False) == 37


@pytest.mark.parametrize("cj", [1, 3])
@pytest.mark.parametrize("reps", [1, 3])
def test_range_table_is_cv2_color_weight(cj, reps):
    """The u8 form's range table over cj joint planes that each stand for
    ``reps`` channels is cv2's color_weight for cj * reps channels,
    f32(exp(i^2 * gauss_color_coeff)) computed in float64 (bilateralFilter_8u),
    at the summed |delta| reps * i: bitwise, for every i in 0..255 cj."""
    _, gcc, _ = tbil.opencv_bilateral_coeffs(-1, 20.0, 22.0)
    cw = tbil.range_weights(gcc, reps, cj)
    assert cw.dtype == np.float32 and cw.shape == (255 * cj + 1,)
    cv2_cw = np.array([np.exp(np.float64(i * i) * gcc)
                       for i in range(256 * cj * reps)]).astype(np.float32)
    np.testing.assert_array_equal(cw, cv2_cw[reps * np.arange(255 * cj + 1)])
    table = k6._tables(torch.device("cpu"), 4, reps, gcc, -0.5 / 9.0, cj)
    np.testing.assert_array_equal(table[:255 * cj + 1].numpy(), cw)
    np.testing.assert_array_equal(table[255 * cj + 1:].numpy(),
                                  tbil.space_weights(4, -0.5 / 9.0))


@pytest.mark.parametrize("cj,cs,reps,self_guided", [
    (3, 3, 1, True), (3, 1, 1, False), (1, 1, 3, False), (1, 3, 3, False),
    (3, 3, 1, False)])
def test_table_form_within_float32_of_exp_form(cj, cs, reps, self_guided,
                                               rng):
    """On integer levels the u8 wrappers' table form (cw[D] * sw[s]) and
    the exp form give the same filter to float32 rounding: within 2e-6 of
    the largest value, and 0 levels apart after rounding on >= 99.9% of
    pixels (the rest sit at a .5 tie), at radius 4 and at radius 33 on a
    frame smaller than the radius."""
    for h, w, ss in ((24, 40, 3.0), (20, 27, 22.0)):
        joint = torch.from_numpy(_u8(rng, 2, cj, h, w))
        src = joint if self_guided else torch.from_numpy(_u8(rng, 2, cs, h,
                                                             w))
        radius, gcc, gsc = tbil.opencv_bilateral_coeffs(-1, SIGMA_C, ss)
        table = k6.bilateral_joint_plain(joint, src, radius, gcc, gsc, reps,
                                         u8=True)
        expf = k6.bilateral_joint_plain(joint, src, radius, gcc, gsc, reps)
        assert table.shape == (2, cs, h, w)
        assert (table - expf).abs().max().item() <= 2e-6 * 255
        d = (torch.round(table) - torch.round(expf)).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean() >= 0.999


@pytest.mark.parametrize("cs", [1, 3])
def test_one_plane_joint_reps3_matches_jax_dispatch(cs, rng):
    """cj = 1 with joint_reps = 3 (a gray guide read as three equal
    channels) through the u8 wrapper's table form, against the JAX
    package's packed-joint kernel in interpret mode (rtol 1e-4, atol 2e-3)
    and, rounded to uint8, against cv2.bilateralFilter's sum over three
    equal guide channels (the 3-channel self filter of the guide, whose
    weights the joint filter shares when src is the guide)."""
    g = _u8(rng, 1, 1, 30, 44)
    src = g if cs == 1 else np.concatenate([g] * 3, axis=1)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jbp.bilateral_packed_joint_batched(
            jnp.asarray(g), jnp.asarray(src), -1, SIGMA_C, 22.0,
            joint_reps=3))
    got = k6.bilateral_packed_joint_batched(
        torch.from_numpy(g), torch.from_numpy(np.ascontiguousarray(src)),
        -1, SIGMA_C, 22.0, joint_reps=3).numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    img = np.repeat(g[0, 0, :, :, None], 3, axis=-1).astype(np.uint8)
    ref = cv2.bilateralFilter(img, -1, SIGMA_C, 22.0)[..., 0]
    d = np.abs(np.rint(got[0, 0]).astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())


def test_every_entry_point_has_a_signature():
    """Each ``extern "C" int rf_*`` entry point of csrc/*.cu has argtypes
    in ops/_build.py, one per parameter: ctypes cannot pass a float or a
    64-bit pointer without them."""
    import glob
    import os
    import re

    from reflectance_filtering_tpu_torch.ops import _build
    found = {}
    for path in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")):
        with open(path) as f:
            for name, params in re.findall(
                    r'extern "C" int (rf_\w+)\(([^)]*)\)', f.read()):
                found[name] = len(params.split(","))
    assert "rf_bilateral_joint" in found
    assert found == {name: len(argtypes)
                     for name, argtypes in _build._SIGNATURES.items()}
