"""Port image numerics (reflectance_filtering_tpu_torch/utils/image.py,
utils/testimages.py) against the JAX package's."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reflectance_filtering_tpu.utils import image as jiu
from reflectance_filtering_tpu.utils import testimages as jti
from reflectance_filtering_tpu_torch.utils import image as tiu
from reflectance_filtering_tpu_torch.utils import testimages as tti


def _srgb_samples(rng):
    # both branches, the threshold itself and values around it
    x = rng.rand(4000).astype(np.float32)
    edge = np.float32(0.04045) + np.arange(-8, 9, dtype=np.float32) * 1e-6
    return np.concatenate([x, edge, np.float32([0.0, 1.0])])


def test_srgb_to_rgb_t_matches_jnp(rng):
    x = _srgb_samples(rng)
    got = tiu.srgb_to_rgb_t(torch.from_numpy(x)).numpy()
    exp = np.asarray(jiu.srgb_to_rgb_jnp(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["srgb_to_rgb", "rgb_to_srgb", "normalize"])
def test_numpy_functions_bitwise(fn, rng):
    x = (rng.rand(17, 23, 3) * 3).astype(np.float32)
    np.testing.assert_array_equal(getattr(tiu, fn)(x), getattr(jiu, fn)(x))


def test_colorize_bitwise_on_raw_uint8(rng):
    img = (rng.rand(12, 9, 3) * 255).astype(np.uint8)
    refl = rng.rand(12, 9).astype(np.float32) * 0.9 + 0.05
    for got, exp in zip(tiu.colorize(refl, img), jiu.colorize(refl, img)):
        np.testing.assert_array_equal(got, exp)


def test_imwrite_imread_bitwise(tmp_path, rng):
    refl = rng.rand(20, 30).astype(np.float32)
    colour = rng.rand(20, 30, 3) * 400.0     # triggers the normalize
    for name, img, srgb in (("r", refl, False), ("c", colour, True)):
        tiu.imwrite(str(tmp_path / (name + "_t.png")), img, sRGB=srgb)
        jiu.imwrite(str(tmp_path / (name + "_j.png")), img, sRGB=srgb)
        np.testing.assert_array_equal(
            tiu.imread(str(tmp_path / (name + "_t.png"))),
            jiu.imread(str(tmp_path / (name + "_j.png"))))
    with pytest.raises(IOError):
        tiu.imread(str(tmp_path / "missing.png"))


def test_testimages_bitwise():
    np.testing.assert_array_equal(
        tti.pink_noise(np.random.RandomState(3), 24, 40),
        jti.pink_noise(np.random.RandomState(3), 24, 40))
    np.testing.assert_array_equal(tti.make_synthetic_comps(5, 50, batch=2),
                                  jti.make_synthetic_comps(5, 50, batch=2))
