"""Port bilateral filters (ops/bilateral.py, ops/bilateral_kernel.py)
against the JAX package: the XLA tap scan ``joint_bilateral_filter``, the
Pallas gray-self kernel in TPU-interpret mode and the uint8 dispatch."""
import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.ops import bilateral as jbil
from reflectance_filtering_tpu.ops.bilateral_pallas import (
    bilateral_gray_self_batched)
from reflectance_filtering_tpu_torch.ops import bilateral as tbil
from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
    bilateral_gray_self, bilateral_gray_self_plain)


def _gray(rng, h, w):
    return (rng.rand(h, w) * 255).astype(np.float32)


@pytest.mark.parametrize("n,radius", [(1, 3), (2, 5), (5, 2), (5, 11),
                                      (7, 33), (40, 33)])
def test_reflect101_index_matches_numpy_pad(n, radius):
    x = np.arange(n)
    exp = np.pad(x, radius, mode="reflect") if n > 1 else np.zeros(
        n + 2 * radius, np.int64)
    got = tbil.reflect101_index(n, radius, "cpu").numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("shape,sigma_space", [((30, 40), 3.0),
                                               ((30, 40), 22.0),
                                               ((10, 13), 22.0)])
def test_float_filter_matches_xla_scan(shape, sigma_space, rng):
    """3-channel replicated joint == src, as -r.png reads back; (10, 13)
    is smaller than the radius (33): reflection repeats."""
    g3 = np.stack([_gray(rng, *shape)] * 3, axis=-1)
    exp = np.asarray(jbil.joint_bilateral_filter(g3, g3, -1, 20.0,
                                                 sigma_space))
    got = tbil.joint_bilateral_filter(g3, g3, -1, 20.0, sigma_space).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=2e-3)


def test_float_filter_joint_ne_src_matches_xla_scan(rng):
    joint = (rng.rand(18, 21, 3) * 255).astype(np.float32)
    src = _gray(rng, 18, 21)
    exp = np.asarray(jbil.joint_bilateral_filter(joint, src, -1, 30.0, 4.0))
    got = tbil.joint_bilateral_filter(joint, src, -1, 30.0, 4.0).numpy()
    assert got.shape == (18, 21)
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("shape,sigma_space", [((30, 40), 22.0),
                                               ((10, 13), 22.0),
                                               ((1, 9), 4.0)])
def test_gray_self_plain_matches_xla_scan(shape, sigma_space, rng):
    """K2's plain version (the kernel's weight formula) against the
    generic scan on the replicated 3-channel image."""
    g = _gray(rng, *shape)
    g3 = np.stack([g] * 3, axis=-1)
    exp = np.asarray(jbil.joint_bilateral_filter(g3, g3, -1, 20.0,
                                                 sigma_space))[..., 0]
    got = bilateral_gray_self(torch.from_numpy(g[None]), -1, 20.0,
                              sigma_space, reps=3)[0].numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("reps", [3, 1])
def test_gray_self_matches_pallas_interpret(reps, rng):
    x = np.stack([_gray(rng, 30, 40), _gray(rng, 30, 40)])
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(bilateral_gray_self_batched(
            jnp.asarray(x), -1, 20.0, 3.0, reps=reps, auto_pack=False))
    got = bilateral_gray_self(torch.from_numpy(x), -1, 20.0, 3.0,
                              reps=reps).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=2e-3)


def _u8_gate(got, exp):
    d = np.abs(got.astype(int) - exp.astype(int))
    assert got.dtype == np.uint8 and got.shape == exp.shape
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                       (d == 0).mean())


def _levels(rng, *shape):
    return np.floor(rng.rand(*shape) * 256).astype(np.uint8)


def _to_u8(q):
    return np.clip(np.rint(np.asarray(q)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("reps", [3, 1])
def test_gray_self_u8_matches_pallas_interpret(reps, rng):
    """K2's uint8 form (cv2's range and space tables) against the Pallas
    kernel's exp form in interpret mode, on the same levels as float32:
    within 1 uint8 level, equal on >= 99.9%."""
    x = _levels(rng, 2, 30, 40)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(bilateral_gray_self_batched(
            jnp.asarray(x.astype(np.float32)), -1, 20.0, 3.0, reps=reps,
            auto_pack=False))
    got = bilateral_gray_self(torch.from_numpy(x), -1, 20.0, 3.0,
                              reps=reps)
    assert got.dtype == torch.float32
    _u8_gate(_to_u8(got.numpy()), _to_u8(exp))


@pytest.mark.parametrize("shape,sigma_space", [((37, 53), 3.0),
                                               ((37, 53), 22.0),
                                               ((1, 40), 22.0),
                                               ((45, 1), 3.0)])
def test_gray_self_u8_matches_cv2(shape, sigma_space, rng):
    """K2's uint8 form on a gray image replicated to three channels (the
    -r.png) against cv2.bilateralFilter on that image: odd shapes, and
    1-wide ones (reflection maps every index to 0)."""
    g = _levels(rng, *shape)
    ref = cv2.bilateralFilter(np.stack([g] * 3, axis=-1), -1, 20.0,
                              sigma_space)[..., 0]
    got = bilateral_gray_self(torch.from_numpy(g[None]), -1, 20.0,
                              sigma_space, reps=3)[0]
    _u8_gate(_to_u8(got.numpy()), ref)


def test_gray_self_tables():
    """The uint8 form's tables are cv2's, in float64 before the cast: the
    range weight of |d| at reps 3 is color_weight[3 |d|], and each tap's
    spatial weight is opencv_bilateral_params' by its squared distance."""
    radius, gcc, gsc, taps = tbil.opencv_bilateral_params(-1, 20.0, 22.0)
    cw = tbil.range_weights(gcc, 3)
    assert cw.dtype == np.float32 and cw.shape == (256,)
    np.testing.assert_array_equal(cw, np.float32(
        [np.exp(float((3 * i) ** 2) * gcc) for i in range(256)]))
    sw = tbil.space_weights(radius, gsc)
    assert sw.shape == (radius * radius + 1,)
    s = (taps[:, 0] ** 2 + taps[:, 1] ** 2).astype(np.int64)
    np.testing.assert_array_equal(sw[s], taps[:, 2].astype(np.float32))


@pytest.mark.parametrize("case", ["gray_self_3ch", "gray_self_2d",
                                  "color_self", "joint_ne_src"])
def test_u8_dispatch_matches_jax(case, rng):
    g = np.floor(rng.rand(26, 31) * 256).astype(np.uint8)
    sigma_space = 22.0
    if case == "gray_self_3ch":        # the BF(CNN,CNN) -r.png
        joint = src = np.stack([g] * 3, axis=-1)
    elif case == "gray_self_2d":
        joint = src = g
    elif case == "color_self":
        joint = src = np.floor(rng.rand(26, 31, 3) * 256).astype(np.uint8)
        sigma_space = 3.0
    else:
        joint = np.floor(rng.rand(26, 31, 3) * 256).astype(np.uint8)
        src = np.stack([g] * 3, axis=-1)
        sigma_space = 3.0
    exp = jbil.joint_bilateral_filter_u8(joint, src, -1, 20.0, sigma_space)
    got = tbil.joint_bilateral_filter_u8(joint, src, -1, 20.0, sigma_space,
                                         device="cpu")
    _u8_gate(got, exp)


def test_u8_dispatch_raises_without_kernel_on_cuda(rng, monkeypatch):
    """Every case of the dispatch reaches the wrapper that it names (K2's
    or one of K6's), with the planes and joint_reps of the JAX dispatch;
    only a plane count that no kernel takes raises, on any device, before
    a tensor is made."""
    from reflectance_filtering_tpu_torch.ops import bilateral_joint_kernel
    from reflectance_filtering_tpu_torch.ops import bilateral_kernel
    calls = []

    def recorder(name):
        def wrapper(*args, **kwargs):
            shapes = [tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            calls.append((name, shapes, kwargs.get("reps",
                                                   kwargs.get("joint_reps"))))
            planes = args[1] if name == "packed_joint" else args[0]
            return torch.zeros_like(planes)
        return wrapper

    monkeypatch.setattr(bilateral_kernel, "bilateral_gray_self",
                        recorder("gray_self"))
    monkeypatch.setattr(bilateral_joint_kernel, "bilateral_color_self_batched",
                        recorder("color_self"))
    monkeypatch.setattr(bilateral_joint_kernel,
                        "bilateral_packed_joint_batched",
                        recorder("packed_joint"))
    g = np.floor(rng.rand(8, 9) * 256).astype(np.uint8)
    g3 = np.stack([g] * 3, axis=-1)
    color = np.floor(rng.rand(8, 9, 3) * 256).astype(np.uint8)
    cases = [
        (g3, g3, ("gray_self", [(1, 8, 9)], 3), (8, 9, 3)),
        (g, g, ("gray_self", [(1, 8, 9)], 1), (8, 9)),
        (color, color, ("color_self", [(1, 3, 8, 9)], None), (8, 9, 3)),
        (color, g3, ("packed_joint", [(1, 3, 8, 9), (1, 1, 8, 9)], 1),
         (8, 9, 3)),
        (g3, color, ("packed_joint", [(1, 1, 8, 9), (1, 3, 8, 9)], 3),
         (8, 9, 3)),
        (g, color, ("packed_joint", [(1, 1, 8, 9), (1, 3, 8, 9)], 1),
         (8, 9, 3)),
        (color, g, ("packed_joint", [(1, 3, 8, 9), (1, 1, 8, 9)], 1),
         (8, 9)),
    ]
    for joint, src, call, shape in cases:
        calls.clear()
        out = tbil.joint_bilateral_filter_u8(joint, src, -1, 20.0, 3.0,
                                             device="cpu")
        assert calls == [call] and out.shape == shape, (call, calls)
    calls.clear()
    two = np.floor(rng.rand(8, 9, 2) * 256).astype(np.uint8)
    # past the device check (the card is the default and is asked for
    # here): the plane count raises before any tensor is made on it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="1 or 3"):
        tbil.joint_bilateral_filter_u8(two, color, -1, 20.0, 3.0,
                                       device="cuda")
    assert calls == []


def test_kernel_wrapper_checks_and_cpu_dispatch(rng):
    x = torch.from_numpy(np.stack([_gray(rng, 9, 10)]))
    before = bilateral_gray_self.launches
    np.testing.assert_array_equal(
        bilateral_gray_self(x, -1, 20.0, 2.0).numpy(),
        bilateral_gray_self_plain(x, -1, 20.0, 2.0).numpy())
    levels = torch.from_numpy(_levels(rng, 1, 9, 10))
    np.testing.assert_array_equal(
        bilateral_gray_self(levels, -1, 20.0, 2.0).numpy(),
        bilateral_gray_self_plain(levels, -1, 20.0, 2.0).numpy())
    assert bilateral_gray_self.launches == before
    with pytest.raises(ValueError):
        bilateral_gray_self(x[0])
    with pytest.raises(TypeError):
        bilateral_gray_self(x.double())
    with pytest.raises(TypeError, match="uint8 levels or float32"):
        bilateral_gray_self(levels.to(torch.int32))
    with pytest.raises(ValueError):
        bilateral_gray_self(x.transpose(1, 2))


@pytest.mark.parametrize("u8,one_band,largest", [(True, 113, 2528),
                                                 (False, 100, 1783)])
def test_gray_self_band_rows(u8, one_band, largest):
    """K2's band sizing (band_rows, mirroring csrc/bilateral_gray_self.cuh):
    the whole disk in one band up to the one-band kernel's radius (33, the
    product's, among them), beyond it bands whose banded kernel fits a
    block's shared memory, and none past ``largest``."""
    from reflectance_filtering_tpu_torch.ops import bilateral_kernel as k2
    for radius in (0, 3, 33, one_band):
        assert k2.band_rows(u8, radius) == 2 * radius + 1
        assert k2.smem_bytes(u8, radius) <= k2.SMEM_LIMIT
    assert k2.smem_bytes(u8, one_band + 1) > k2.SMEM_LIMIT
    for radius in (one_band + 1, 120, 500, largest):
        band = k2.band_rows(u8, radius)
        assert 1 <= band <= 2 * radius + 1
        assert k2.smem_bytes(u8, radius, band) <= k2.SMEM_LIMIT
    assert k2.band_rows(u8, largest + 1) == 0
