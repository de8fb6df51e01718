"""Port flagship CNN (models/networks.py, ops/cnn_kernel.py) against the
JAX package: ``reflectance_net_apply`` and the Pallas kernel
``reflectance_cnn_pallas_planar`` in TPU-interpret mode.  On the CPU the
kernel wrapper runs its plain version; the kernel itself is held against
that plain version on the card (chip_smoke.py, test_torch_kernels_cuda.py).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.models.networks import (
    reference_params_from_caffe, reflectance_net_apply)
from reflectance_filtering_tpu.ops.cnn_pallas import (
    pack_weights as jax_pack_weights, reflectance_cnn_pallas_planar)
from reflectance_filtering_tpu.utils.image import srgb_to_rgb_jnp
from reflectance_filtering_tpu_torch.models import caffe_io as tcio
from reflectance_filtering_tpu_torch.models.networks import (
    ReflectanceNet, params_from_numpy, seeded_reference_params)
from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
    NUM_WEIGHTS, pack_weights, reflectance_cnn, reflectance_cnn_plain)

from test_torch_caffe_io import caffemodel_bytes


def _net(params):
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(params))
    return net


@pytest.fixture(params=["seeded", "caffe"])
def params(request, tmp_path):
    """Seeded weights as they are, and the same weights after a trip
    through caffemodel bytes and the port's own converter."""
    p = seeded_reference_params(4)
    if request.param == "caffe":
        path = tmp_path / "w.caffemodel"
        path.write_bytes(caffemodel_bytes(p))
        p = tcio.load_reference_weights(str(path))
    return p


def test_module_matches_reflectance_net_apply(params, rng):
    img = rng.rand(2, 17, 23, 3).astype(np.float32)
    exp = np.asarray(reflectance_net_apply(reference_params_from_caffe(
        params), jnp.asarray(img)))
    with torch.no_grad():
        got = _net(params)(torch.from_numpy(img)).numpy()
    assert got.shape == exp.shape == (2, 17, 23, 1)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


def test_output_spreads_over_byte_levels(rng):
    """Seeded weights give a reflectance that crosses many floor(r*255)
    levels, so the byte path and the filter get real work."""
    img = rng.rand(1, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        r = _net(seeded_reference_params(0))(torch.from_numpy(img))
    levels = torch.unique(torch.floor(r * 255)).numel()
    assert 0 < r.min() and r.max() < 1 and levels > 50


@pytest.mark.parametrize("srgb_input", [True, False])
def test_kernel_wrapper_matches_pallas_planar(params, srgb_input, rng):
    """K1's CPU path against the Pallas kernel (interpret mode, precise
    f32 scheme) on planar [B, 3, H, W] input."""
    x = rng.rand(2, 3, 20, 30).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(reflectance_cnn_pallas_planar(
            {k: jnp.asarray(v) for k, v in jax_pack_weights(
                reference_params_from_caffe(params)).items()},
            jnp.asarray(x), srgb_input=srgb_input, precise=True))
    w = pack_weights(_net(params))
    got = reflectance_cnn(torch.from_numpy(x).reshape(2, 3, 600), w,
                          srgb_input=srgb_input).reshape(2, 20, 30).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)


def test_plain_version_matches_xla_forward(params, rng):
    x = rng.rand(3, 3, 64).astype(np.float32)
    lin = srgb_to_rgb_jnp(jnp.moveaxis(jnp.asarray(x), 1, -1))
    exp = np.asarray(reflectance_net_apply(
        reference_params_from_caffe(params), lin))[..., 0]
    got = reflectance_cnn_plain(torch.from_numpy(x),
                                pack_weights(_net(params)),
                                srgb_input=True).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


def test_pack_weights_layout():
    params = seeded_reference_params(1)
    w = pack_weights(_net(params)).numpy()
    assert w.shape == (NUM_WEIGHTS,) and w.dtype == np.float32
    np.testing.assert_array_equal(w[:96], params["conv0"]["kernel"][0, 0]
                                  .reshape(-1))
    np.testing.assert_array_equal(w[96:128], params["conv0"]["bias"])
    np.testing.assert_array_equal(w[128:1152], params["conv1"]["kernel"]
                                  [0, 0].reshape(-1))
    np.testing.assert_array_equal(w[4352:4512], params["fuse_skip_layers"]
                                  ["kernel"][0, 0, :, 0])
    assert w[4512] == params["fuse_skip_layers"]["bias"][0]


def test_kernel_wrapper_checks_and_cpu_dispatch():
    w = pack_weights(_net(seeded_reference_params(0)))
    x = torch.rand(2, 3, 10)
    before = reflectance_cnn.launches
    reflectance_cnn(x, w, srgb_input=True)
    assert reflectance_cnn.launches == before   # CPU: plain, no launch
    with pytest.raises(ValueError):
        reflectance_cnn(torch.rand(2, 4, 10), w, srgb_input=True)
    with pytest.raises(ValueError):
        reflectance_cnn(torch.rand(2, 3, 4, 5), w, srgb_input=True)
    with pytest.raises(TypeError):
        reflectance_cnn(x.double(), w, srgb_input=True)
    with pytest.raises(ValueError):
        reflectance_cnn(torch.rand(2, 10, 3).transpose(1, 2), w,
                        srgb_input=True)
    with pytest.raises(ValueError):
        reflectance_cnn(x, w[:100], srgb_input=True)
    with pytest.raises(ValueError):
        reflectance_cnn(x.to("meta"), w.to("meta"), srgb_input=True)


def test_only_the_shipped_network_is_ported():
    from reflectance_filtering_tpu_torch.models.networks import NetworkConfig
    with pytest.raises(NotImplementedError):
        ReflectanceNet(NetworkConfig(num_layers=3))


def test_trained_weights_when_present(rng):
    """The trained model is not in the repository; when it is placed at
    caffe_io.REFERENCE_CAFFEMODEL, both packages must agree on it."""
    if not os.path.isfile(tcio.REFERENCE_CAFFEMODEL):
        pytest.skip("trained weights not in the repository")
    params = tcio.load_reference_weights()
    img = rng.rand(9, 11, 3).astype(np.float32)
    exp = np.asarray(reflectance_net_apply(
        reference_params_from_caffe(params), jnp.asarray(img)))
    with torch.no_grad():
        got = _net(params)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
