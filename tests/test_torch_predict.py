"""The port's ``make_predict_fn`` and ``predict_batched`` against the JAX
package's, on the CPU, from the same parameters (the JAX init carried
across with ``params_to_torch``).

The cascade (cascadeSkipLayers) makes a ``reflectance_level0`` blob, which
the JAX predict function returns beside RS_est, reflectance and shading
(``train/predict.py:67-68``); the port returns the same keys.  Tolerance:
each output within 1e-5 of its largest value, the gate of the network
tests (tests/test_torch_networks.py) for these trunks."""
import numpy as np
import pytest
import torch

import jax

from reflectance_filtering_tpu.models import networks as jn
from reflectance_filtering_tpu.train import predict as jp
from reflectance_filtering_tpu_torch.models import networks as tn
from reflectance_filtering_tpu_torch.train import predict as tp

REL = 1e-5


def _cfg(kind, bn, mode):
    return dict(network_type=kind, num_layers=2, num_filters_log=3,
                kernel_pad=1 if bn else 0, use_batch_normalization=bn,
                rs_est_mode=mode)


def _params(cfg_kw, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jn.init_network(jax.random.PRNGKey(seed),
                                    jn.NetworkConfig(**cfg_kw)))


def _images(n=3, h=16, w=24, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3) * 0.8 + 0.1).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("mode", ["rDirectly", "rRelMax", "RS"])
@pytest.mark.parametrize("kind,bn", [("cascadeSkipLayers", False),
                                     ("cascadeSkipLayers", True),
                                     ("convStaticSkipLayers", False)])
def test_predict_fn_matches_jax(kind, bn, mode):
    """The same keys as the JAX predict function (the cascade's
    reflectance_level0 among them), each output within 1e-5 of its
    largest value."""
    cfg_kw = _cfg(kind, bn, mode)
    params = _params(cfg_kw)
    images = _images()
    want = jp.make_predict_fn(jn.NetworkConfig(**cfg_kw))(
        jax.tree_util.tree_map(jax.numpy.asarray, params),
        jax.numpy.asarray(images))
    got = tp.make_predict_fn(tn.NetworkConfig(**cfg_kw))(
        tn.params_to_torch(params), torch.from_numpy(images))
    assert sorted(got) == sorted(want)
    assert ("reflectance_level0" in got) == (kind == "cascadeSkipLayers")
    for key in want:
        assert _rel(got[key].numpy(), want[key]) <= REL, key


def test_predict_batched_carries_the_cascade_key():
    """predict_batched over batches (a ragged last one) returns the JAX
    function's keys and outputs, reflectance_level0 included."""
    cfg_kw = _cfg("cascadeSkipLayers", False, "rRelMax")
    params = _params(cfg_kw, seed=2)
    images = _images(n=5, seed=2)
    want = jp.predict_batched(jp.make_predict_fn(jn.NetworkConfig(**cfg_kw)),
                              params, images, batch_size=2)
    got = tp.predict_batched(tp.make_predict_fn(tn.NetworkConfig(**cfg_kw)),
                             tn.params_to_torch(params), images,
                             batch_size=2, device="cpu")
    assert sorted(got) == sorted(want)
    assert "reflectance_level0" in got
    for key in want:
        assert got[key].shape[0] == 5
        assert _rel(got[key], want[key]) <= REL, key
