"""The port's fused-trunk module (ops/cnn_train_kernel.py: the plain trunk,
the differentiable ``skip_trunk_pre`` around the K7 launches, here on their
plain versions) against the JAX package's ``skip_trunk_pre``, whose Pallas
kernels (TPU kernel 18) run in TPU-interpret mode, and its XLA autodiff.

Tolerances: the forward within 5e-5 of the largest value (the Pallas
trunk's bf16x3 products carry ~1e-5 relative error per layer); every parameter
gradient within 2e-4 of its leaf's max (the JAX package's own gate for its
fused trunk, tests/test_cnn_train_pallas.py, set by its bf16x3 products);
the input cotangent within 5e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.models.networks import (
    NetworkConfig as JConfig, apply_network as j_apply, init_network as j_init)
from reflectance_filtering_tpu.ops.cnn_train_pallas import (
    fits_fused_trunk as j_fits, skip_trunk_pre as j_trunk)
from reflectance_filtering_tpu_torch.models.networks import (
    NetworkConfig, apply_network, params_to_torch)
from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7


def _case(num_layers, nfl, mode="rDirectly", shape=(2, 48, 64), seed=1):
    jcfg = JConfig(network_type="convStaticSkipLayers", num_layers=num_layers,
                   num_filters_log=nfl, kernel_pad=0, rs_est_mode=mode)
    params = jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(0)
    imgs = rng.rand(*shape, 3).astype(np.float32)
    cot = rng.rand(*shape, jcfg.num_output_final).astype(np.float32)
    return jcfg, params, imgs, cot


def _jax_grads(params, imgs, cot, num_layers, wrt_images=False):
    def loss(p, im):
        return jnp.sum(j_trunk(p, im, num_layers=num_layers, tile=512) * cot)

    with pltpu.force_tpu_interpret_mode():
        pre = np.asarray(j_trunk(params, jnp.asarray(imgs),
                                 num_layers=num_layers, tile=512))
        g = jax.grad(loss, argnums=1 if wrt_images else 0)(
            params, jnp.asarray(imgs))
    return pre, jax.tree_util.tree_map(np.asarray, g)


def _torch_grads(fn, params, imgs, cot, wrt_images=False):
    tp = params_to_torch(params)
    leaves = [t.requires_grad_() for layer in tp.values()
              for t in layer.values()]
    x = torch.from_numpy(imgs).requires_grad_(wrt_images)
    pre = fn(tp, x)
    out = torch.autograd.grad((pre * torch.from_numpy(cot)).sum(),
                              [x] if wrt_images else leaves)
    if wrt_images:
        return pre.detach().numpy(), out[0].numpy()
    it = iter(out)
    return pre.detach().numpy(), {name: {part: next(it).numpy()
                                         for part in layer}
                                  for name, layer in tp.items()}


def _plain(num_layers):
    return lambda p, x: k7.skip_trunk_pre_plain(p, x, num_layers=num_layers)


def _fused(num_layers):
    return lambda p, x: k7.skip_trunk_pre(p, x, num_layers=num_layers)


def _assert_grads(got, want, tol=2e-4):
    for name in want:
        for part in ("kernel", "bias"):
            a, b = got[name][part], want[name][part]
            assert a.shape == b.shape
            err = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
            assert err < tol, (name, part, err)


@pytest.mark.parametrize("which", ["plain", "fused"])
@pytest.mark.parametrize("num_layers,nfl,mode,shape", [
    (5, 5, "rDirectly", (2, 48, 64)), (2, 4, "rDirectly", (2, 48, 64)),
    (1, 5, "rDirectly", (2, 48, 64)), (2, 7, "rDirectly", (2, 48, 64)),
    (3, 4, "RS", (2, 48, 64)), (2, 3, "rDirectly", (1, 37, 53))])
def test_trunk_matches_jax_interpret(which, num_layers, nfl, mode, shape):
    """Forward and parameter gradients against the Pallas trunk: the flagship
    (5, 32), the JAX test's (2, 16), (1, 32), (2, 128), RS's 6-wide head,
    and an odd 37x53 frame (a ragged last tile)."""
    _, params, imgs, cot = _case(num_layers, nfl, mode, shape)
    jpre, jg = _jax_grads(params, imgs, cot, num_layers)
    fn = _plain(num_layers) if which == "plain" else _fused(num_layers)
    pre, g = _torch_grads(fn, params, imgs, cot)
    assert pre.shape == jpre.shape
    assert np.abs(pre - jpre).max() <= 5e-5 * np.abs(jpre).max()
    _assert_grads(g, jg)


@pytest.mark.parametrize("which", ["plain", "fused"])
def test_trunk_input_cotangent_matches_jax(which):
    _, params, imgs, cot = _case(2, 3, shape=(1, 24, 40), seed=2)
    _, jdx = _jax_grads(params, imgs, cot, 2, wrt_images=True)
    fn = _plain(2) if which == "plain" else _fused(2)
    _, dx = _torch_grads(fn, params, imgs, cot, wrt_images=True)
    assert np.abs(jdx).max() > 0
    assert np.abs(dx - jdx).max() <= 5e-5 * np.abs(jdx).max()


def test_plain_trunk_matches_xla_autodiff():
    """The plain trunk is the JAX package's own XLA path (apply_network on
    the CPU) to float32 rounding."""
    jcfg, params, imgs, cot = _case(5, 5)

    def loss(p):
        return jnp.sum(j_apply(p, jnp.asarray(imgs), jcfg,
                               train=True)["RS_est_before_sigmoid"] * cot)

    jg = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    _, g = _torch_grads(_plain(5), params, imgs, cot)
    _assert_grads(g, jg, tol=1e-5)


def test_input_grad_false_keeps_param_grads_and_zeroes_dx():
    _, params, imgs, cot = _case(2, 3, shape=(1, 24, 40), seed=2)
    tp = params_to_torch(params)
    leaves = [t.requires_grad_() for layer in tp.values()
              for t in layer.values()]
    grads = {}
    for ig in (True, False):
        x = torch.from_numpy(imgs).requires_grad_()
        pre = k7.skip_trunk_pre(tp, x, num_layers=2, input_grad=ig)
        out = torch.autograd.grad((pre * torch.from_numpy(cot)).sum(),
                                  leaves + [x])
        grads[ig] = out
    for a, b in zip(grads[True][:-1], grads[False][:-1]):
        assert torch.equal(a, b)
    assert grads[True][-1].abs().max().item() > 0
    assert grads[False][-1].abs().max().item() == 0.0


def test_pack_unpack_and_wrapper_checks():
    shape = (3, 3, 16, 6)
    flat = torch.arange(k7.num_params(shape), dtype=torch.float32)
    ws, bs = k7.unpack(flat, shape)
    assert [tuple(w.shape) for w in ws] == [(3, 16), (16, 16), (16, 16),
                                            (48, 6)]
    assert [b.numel() for b in bs] == [16, 16, 16, 6]
    assert torch.equal(k7.pack(ws, bs), flat)
    x = torch.rand(10, 3)
    before = (k7.trunk_forward.launches, k7.trunk_backward.launches)
    k7.trunk_backward(x, torch.rand(10, 6), flat, shape, True)
    k7.trunk_forward(x, flat, shape)
    assert (k7.trunk_forward.launches, k7.trunk_backward.launches) == before
    with pytest.raises(ValueError):
        k7.trunk_forward(x, flat[:-1].contiguous(), shape)
    with pytest.raises(TypeError):
        k7.trunk_forward(x.double(), flat, shape)
    with pytest.raises(ValueError):
        k7.trunk_forward(x.to("meta"), flat.to("meta"), shape)
    with pytest.raises(ValueError):
        k7.trunk_backward(x, torch.rand(10, 5), flat, shape, True)


@pytest.mark.parametrize("kw,ci,ok", [
    ({}, 3, True), ({"num_layers": 1, "num_filters_log": 3}, 8, True),
    ({"num_filters_log": 8, "rs_est_mode": "RS"}, 3, True),
    ({"use_batch_normalization": True}, 3, False),
    ({"kernel_pad": 1}, 3, False), ({}, 9, False),
    ({"dilation": 2}, 3, False), ({"num_layers": 0}, 3, False),
    ({"num_filters_log": 2}, 3, False), ({"num_filters_log": 9}, 3, False)])
def test_eligibility_gates_match_jax(kw, ci, ok):
    cfg = NetworkConfig(network_type="convStaticSkipLayers",
                        **{"kernel_pad": 0, **kw})
    jcfg = JConfig(network_type="convStaticSkipLayers",
                   **{"kernel_pad": 0, **kw})
    assert k7.fits_fused_trunk(cfg, ci) == j_fits(jcfg, ci) == ok


def test_apply_network_plain_path_on_cpu():
    """On the CPU apply_network takes the plain per-layer path (the JAX
    package's XLA path), also for configs the trunk does not admit (a 3x3
    kernel)."""
    for kw in ({}, {"kernel_pad": 1, "num_layers": 2, "num_filters_log": 3}):
        jcfg = JConfig(**{"network_type": "convStaticSkipLayers",
                          "kernel_pad": 0, **kw})
        cfg = NetworkConfig(**{"network_type": "convStaticSkipLayers",
                               "kernel_pad": 0, **kw})
        params = jax.tree_util.tree_map(
            np.asarray, j_init(jax.random.PRNGKey(4), jcfg))
        imgs = np.random.RandomState(3).rand(2, 11, 13, 3).astype(np.float32)
        before = k7.trunk_forward.launches
        got = apply_network(params_to_torch(params), torch.from_numpy(imgs),
                            cfg)["RS_est"].numpy()
        assert k7.trunk_forward.launches == before
        want = np.asarray(j_apply(params, jnp.asarray(imgs), jcfg)["RS_est"])
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
