"""The port's approximate fast modes (reflectance_filtering_tpu_torch/ops/
bilateral_grid.py, ops/baselines.py, the filter CLI's bilateral_grid) on
the CPU: the grid within 1 uint8 level of the JAX package's (within 1e-3
as floats, edge rows and columns and odd sizes included), the JAX grid
tests' gates (tests/test_bilateral_grid.py) held on the port, the quality
point's |dWHDR| <= 0.001 against cv2.bilateralFilter (bench.py's gate),
and the rescaling baseline against the JAX package's."""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu.cli import filter as j_filt
from reflectance_filtering_tpu.ops import baselines as jb
from reflectance_filtering_tpu.ops import bilateral_grid as jg
from reflectance_filtering_tpu_torch.cli import filter as t_filt
from reflectance_filtering_tpu_torch.losses.whdr import whdr
from reflectance_filtering_tpu_torch.ops import baselines as tb
from reflectance_filtering_tpu_torch.ops import bilateral_grid as tg
from reflectance_filtering_tpu_torch.ops.bilateral import (
    joint_bilateral_filter)
from reflectance_filtering_tpu_torch.utils.testimages import (
    make_synthetic_comps, pink_noise)
from tests.test_bilateral_grid import _natural


@pytest.mark.parametrize("h,w,ss,sr,src_channels", [
    (96, 128, None, None, 0),     # the default cells, self-guided
    (97, 131, 8, 6, 3),           # odd H and W: the [:h, :w] crop
    (61, 45, None, None, 1),      # smaller than a few cells
    (64, 64, 4, 3, 3),
    (33, 70, 16, 10, 0),          # the bench's fast cells
])
def test_grid_u8_matches_jax(rng, h, w, ss, sr, src_channels):
    """Within 1 uint8 level of the JAX package's grid, and within 1e-3 on
    floats, everywhere and on the edge rows and columns (where
    jax.image.resize renormalises and F.interpolate clamps)."""
    gray = (rng.rand(h, w) * 255).astype(np.uint8)
    j3 = np.repeat(gray[..., None], 3, -1)
    src = {0: j3, 1: (rng.rand(h, w) * 255).astype(np.uint8),
           3: (rng.rand(h, w, 3) * 255).astype(np.uint8)}[src_channels]
    got = tg.bilateral_grid_u8(j3, src, 20.0, 22.0, ss, sr, device="cpu")
    want = jg.bilateral_grid_u8(j3, src, 20.0, 22.0, ss, sr)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    sp = (src[None, None] if src.ndim == 2
          else np.moveaxis(src, -1, 0)[None]).astype(np.float32)
    jf = np.asarray(jg.bilateral_grid_gray(
        jnp.asarray(gray[None].astype(np.float32)), jnp.asarray(sp),
        20.0 / 3, 22.0, ss, sr))
    tf = tg.bilateral_grid_gray(torch.from_numpy(gray[None].astype(
        np.float32)), torch.from_numpy(sp), 20.0 / 3, 22.0, ss, sr).numpy()
    assert tf.shape == jf.shape
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3)
    for edge in (tf[..., 0, :] - jf[..., 0, :], tf[..., -1, :] - jf[..., -1, :],
                 tf[..., :, 0] - jf[..., :, 0], tf[..., :, -1] - jf[..., :, -1]):
        assert np.abs(edge).max() <= 1e-3


def _exact(img3, src=None):
    src = img3 if src is None else src
    return joint_bilateral_filter(img3.astype(np.float32),
                                  src.astype(np.float32), -1, 20.0,
                                  22.0).numpy()


def test_grid_close_to_exact_self(rng):
    img = _natural(rng, 96, 128)
    g3 = np.repeat(img[..., None], 3, -1)
    d = np.abs(tg.bilateral_grid_u8(g3, g3, 20.0, 22.0, device="cpu")
               .astype(np.float64) - _exact(g3))
    assert d.mean() <= 1.0
    assert np.percentile(d, 99) <= 4.0
    assert d.max() <= 8.0


def test_grid_joint_neq_src(rng):
    joint = _natural(rng, 64, 96)
    src = (rng.rand(64, 96) * 255).astype(np.uint8)
    j3 = np.repeat(joint[..., None], 3, -1)
    d = np.abs(tg.bilateral_grid_u8(j3, src, 20.0, 22.0, device="cpu")
               .astype(np.float64) - _exact(j3, src))
    assert d.mean() <= 2.5 and np.percentile(d, 99) <= 12.0


def test_grid_quality_point_p99(rng):
    """The quality operating point (ss=8, sr=6) holds p99 <= 1 uint8 level
    (max <= 4) per image across the 6-class quality set."""
    h, w = 256, 256
    yy, xx = np.mgrid[0:h, 0:w]
    study = np.clip(120 + 80 * np.sin(xx / 60.0) * np.cos(yy / 45.0)
                    + 30 * np.sin((xx + yy) / 15.0)
                    + 20 * rng.rand(h, w), 0, 255)
    study[60:120, 60:120] = 220
    imgs = np.floor(np.stack([
        study,
        rng.rand(h, w) * 255,
        (rng.rand(h, w) > 0.5) * 255.0,
        np.clip(128 + 25 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
                + 8 * rng.rand(h, w), 0, 255),
        (np.floor(xx / 32) * 36.0) % 256,
        pink_noise(rng, h, w),
    ])).astype(np.float32)
    x = torch.from_numpy(imgs)
    approx = tg.bilateral_grid_gray(x, x[:, None], 20.0 / 3.0, 22.0, ss=8,
                                    sr=6)[:, 0].numpy()
    for i in range(len(imgs)):
        exact = _exact(np.repeat(imgs[i][..., None], 3, -1))[..., 0]
        d = np.abs(np.clip(np.rint(approx[i]), 0, 255)
                   - np.clip(np.rint(exact), 0, 255))
        assert np.percentile(d, 99) <= 1.0, (i, np.percentile(d, 99))
        assert d.max() <= 4.0, (i, d.max())


def test_grid_quality_point_whdr_delta():
    """|dWHDR| <= 0.001 at ss=8, sr=6 against cv2.bilateralFilter, on the
    bench gate's two images and its 47,240-comparison blob."""
    rngg = np.random.RandomState(7)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    gray = np.clip(120 + 70 * np.sin(xx / 14.0) * np.cos(yy / 10.0)
                   + 12 * rngg.rand(96, 128), 0, 255).astype(np.uint8)
    pink = pink_noise(rngg, 96, 128).astype(np.uint8)
    comps = torch.from_numpy(make_synthetic_comps(11, 40 * 1181))

    def score(img):
        return float(whdr(torch.from_numpy(img.astype(np.float32) / 255.0),
                          comps))

    for img in (gray, pink):
        rep3 = np.repeat(img[..., None], 3, axis=-1)
        got = tg.bilateral_grid_u8(rep3, rep3, 20.0, 22.0, ss=8, sr=6,
                                   device="cpu")
        exp = cv2.bilateralFilter(rep3, -1, 20.0, 22.0)
        assert abs(score(got) - score(exp)) <= 0.001


def test_grid_batched_channels(rng):
    j = np.floor(rng.rand(2, 40, 48) * 256).astype(np.float32)
    s = np.floor(rng.rand(2, 3, 40, 48) * 256).astype(np.float32)
    out = tg.bilateral_grid_gray(torch.from_numpy(j), torch.from_numpy(s),
                                 10.0, 8.0).numpy()
    assert out.shape == (2, 3, 40, 48)
    assert np.isfinite(out).all()
    assert out.min() >= -1 and out.max() <= 256


def test_grid_u8_asks_for_the_cpu_without_a_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    g = (rng.rand(8, 8) * 255).astype(np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.bilateral_grid_u8(g, g)


@pytest.mark.parametrize("shape", [(2, 9, 11, 3), (5, 6, 3)])
def test_rescaling_baseline_matches_jax(rng, shape):
    images = rng.rand(*shape).astype(np.float32)
    images[0, 0, 0] = 0.0                   # a black pixel
    flat = np.full(shape, 0.3, np.float32)  # max == min: scale 0
    for x in (images, flat):
        r, s = tb.rescaling_baseline(torch.from_numpy(x))
        jr, js = jb.rescaling_baseline(jnp.asarray(x))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-7)


def test_filter_cli_grid_name_caveat_and_output(rng, tmp_path, capsys):
    """--filter_type=bilateral_grid on --device cpu: the JAX CLI's distinct
    output name and stderr caveat, its output within 1 level of the JAX
    CLI's; --grid_ss/--grid_sr reach the grid."""
    img = _natural(rng, 64, 80)
    path = str(tmp_path / "photo-r.png")
    cv2.imwrite(path, np.repeat(img[..., None], 3, -1))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for cells in ([], ["--grid_ss", "8", "--grid_sr", "6"]):
        args = ["--filter_type=bilateral_grid", "--sigma_color=20",
                "--sigma_spatial=22", "--filename_in", path, "--guidance_in",
                path] + cells
        t_filt.main(args + ["--path_out", str(tmp_path / "t"), "--device",
                            "cpu"])
        assert "APPROXIMATE" in capsys.readouterr().err
        j_filt.main(args + ["--path_out", str(tmp_path / "j")])
        capsys.readouterr()
        name = "photo-r_bilateral_grid_c20.0s22.0.png"
        assert os.listdir(str(tmp_path / "t")) == [name]
        got = cv2.imread(str(tmp_path / "t" / name))
        want = cv2.imread(str(tmp_path / "j" / name))
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        direct = tg.bilateral_grid_u8(
            cv2.imread(path), cv2.imread(path), 20.0, 22.0,
            *([8, 6] if cells else [None, None]), device="cpu")
        np.testing.assert_array_equal(got, direct)
