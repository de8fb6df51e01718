"""The port's training factories (models/networks.py: all seven
networkTypes, batch normalization, the cascade) against the JAX package's,
on the CPU, from the same parameters (the JAX init carried across with
``params_to_torch``; the two packages' generators differ).

Tolerances: every forward blob within 1e-5 of its largest value (1e-4 for
uNet, whose 256x256 resize and 7x7 and 5x5 convolutions sum in another
order); the losses of one ``compute_losses`` within 1e-5 relative (1e-4
for uNet) and its parameter gradients within 2e-4 of each leaf's max (the
JAX package's gate for its fused trunk; float32 sums in another order);
batch norm's fold within 1e-5 relative; one Adam step within 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reflectance_filtering_tpu.models import networks as jn
from reflectance_filtering_tpu.train import loop as jloop
from reflectance_filtering_tpu_torch.models import networks as tn
from reflectance_filtering_tpu_torch.train import loop as tloop
from tests.test_whdr import make_blob, random_comps

MODES = ("rDirectly", "rRelMax", "RS")
# (networkType, bn, kernel_pad, frame): bn where the type has it; uNet on
# both sides of its 256x256 global resize (frames multiples of 8)
CASES = ([(t, False, 1, (16, 24)) for t in (
    "convStatic", "convStaticWithSigmoid", "simpleConvolutionsRelu",
    "convIncreasing")]
    + [("uNet", False, 1, (40, 48))]
    + [(t, bn, 1 if bn else 0, (16, 24)) for t in ("convStaticSkipLayers",
                                                   "cascadeSkipLayers")
       for bn in (False, True)])


def _cfg(kind, bn, pad, mode, num_layers=2):
    return dict(network_type=kind, num_layers=num_layers, num_filters_log=3,
                kernel_pad=pad, use_batch_normalization=bn, rs_est_mode=mode)


def _data(frame, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    images = (rng.rand(batch, *frame, 3) * 0.8 + 0.1).astype(np.float32)
    comps = np.stack([make_blob(random_comps(rng, 12)) for _ in range(batch)])
    return images, comps.astype(np.float32)


def _jparams(cfg_kw, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jn.init_network(jax.random.PRNGKey(seed),
                                    jn.NetworkConfig(**cfg_kw)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _grads(tparams, total):
    leaves = [t for layer in tparams.values() for t in layer.values()]
    # batch norm's running statistics are not read in training: no gradient
    got = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(got)
    return {name: {part: (lambda g, t: np.zeros(tuple(t.shape), np.float32)
                          if g is None else g.numpy())(next(it), t)
                   for part, t in layer.items()}
            for name, layer in tparams.items()}


def _trainable(jparams):
    tparams = tn.params_to_torch(jparams)
    for layer in tparams.values():
        for t in layer.values():
            t.requires_grad_()
    return tparams


def _check(kind, bn, pad, mode, frame):
    cfg_kw = _cfg(kind, bn, pad, mode)
    tol = 1e-4 if kind == "uNet" else 1e-5
    jparams = _jparams(cfg_kw)
    images, comps = _data(frame)
    jb = jn.apply_network(jparams, jnp.asarray(images),
                          jn.NetworkConfig(**cfg_kw), train=True)
    tparams = _trainable(jparams)
    tb = tn.apply_network(tparams, torch.from_numpy(images),
                          tn.NetworkConfig(**cfg_kw), train=True)
    assert sorted(tb) == sorted(jb)
    for key in jb:
        if key == "__bn_stats__":
            assert sorted(tb[key]) == sorted(jb[key])
            for name, stats in jb[key].items():
                for part in ("mean", "var"):
                    assert _rel(tb[key][name][part].detach().numpy(),
                                stats[part]) <= tol, (name, part)
        else:
            assert _rel(tb[key].detach().numpy(), jb[key]) <= tol, key

    def jf(p):
        return jloop.compute_losses(p, jnp.asarray(images),
                                    jnp.asarray(comps),
                                    jn.NetworkConfig(**cfg_kw),
                                    jloop.LossConfig())

    (_, jmet), jgrad = jax.value_and_grad(jf, has_aux=True)(jparams)
    total, met = tloop.compute_losses(
        tparams, torch.from_numpy(images), torch.from_numpy(comps),
        tn.NetworkConfig(**cfg_kw), tloop.LossConfig())
    assert sorted(met) == sorted(jmet)
    for key in jmet:
        if key != "bn_stats":
            assert abs(met[key].item() - float(jmet[key])) <= tol * max(
                abs(float(jmet[key])), 1e-6), key
    got = _grads(tparams, total)
    assert sorted(got) == sorted(jgrad)
    scale = max(float(np.abs(v).max()) for layer in jgrad.values()
                for v in layer.values())
    for name in jgrad:
        for part in jgrad[name]:
            if bn and part == "bias" and "bn" + name[4:] in jgrad:
                # batch norm subtracts the batch mean: the bias of the conv
                # before it has a zero gradient, both sides rounding noise
                for side in (got[name][part], jgrad[name][part]):
                    assert np.abs(np.asarray(side)).max() <= 1e-5 * scale
                continue
            assert _rel(got[name][part], jgrad[name][part]) <= 2e-4, (
                name, part)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind,bn,pad,frame", CASES)
def test_network_matches_jax(kind, bn, pad, frame, mode):
    """Forward blobs (RS_est and every other blob: concat_skip_layers,
    RS_est_before_sigmoid, the cascade's level-0 blobs, the bn batch
    statistics) and the gradients of the whole loss graph."""
    _check(kind, bn, pad, mode, frame)


def test_unet_downsampling_global_path_matches_jax():
    """uNet on a 264x272 frame: its global path's resize to 256x256 shrinks
    (antialiased), where the 40x48 cases enlarge.  rDirectly: on this
    frame the random init puts estimates of the other modes at the float32
    eps floor they divide by, where the gradients reach 1e5 and follow the
    last bits of the estimate."""
    _check("uNet", False, 1, "rDirectly", (264, 272))


@pytest.mark.parametrize("frame", [(40, 48), (264, 272), (256, 256)])
def test_unet_resize_matches_jax_image_resize(frame):
    images, _ = _data(frame, batch=1)
    want = jax.image.resize(jnp.asarray(images), (1, 256, 256, 3),
                            method="linear")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(images).permute(0, 3, 1, 2), size=(256, 256),
        mode="bilinear", align_corners=False, antialias=True
    ).permute(0, 2, 3, 1)
    assert _rel(got.numpy(), want) <= 1e-6


def test_deconv2d_matches_conv_transpose(rng):
    """uNet's up path: lax.conv_transpose of an HWIO kernel at stride 2
    without transpose_kernel, against the port's flipped conv_transpose2d."""
    params = {"kernel": rng.randn(2, 2, 5, 3).astype(np.float32),
              "bias": rng.randn(3).astype(np.float32)}
    x = rng.randn(2, 6, 7, 5).astype(np.float32)
    want = jn.deconv2d(jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(x))
    got = tn.deconv2d({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x))
    assert got.shape == (2, 12, 14, 3)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("kind", ["convStaticSkipLayers",
                                  "cascadeSkipLayers"])
def test_bn_train_step_folds_running_stats(kind):
    """One Adam step with batch normalization: the running statistics fold
    the batch's at momentum 0.999 after the step, Adam leaves them, its
    state for them stays zero, and everything matches the JAX step
    (tests/test_train.py:229-263)."""
    cfg_kw = _cfg(kind, True, 1, "rRelMax")
    jparams = _jparams(cfg_kw, seed=1)
    images, comps = _data((16, 24), batch=4, seed=1)
    opt = jloop.make_optimizer("ADAM", 1e-3)
    jstep = jloop.make_train_step(jn.NetworkConfig(**cfg_kw),
                                  jloop.LossConfig(), opt)
    jp2, jo2, jmet = jstep(jax.tree_util.tree_map(jnp.asarray, jparams),
                           opt.init(jparams), jnp.asarray(images),
                           jnp.asarray(comps), jax.random.PRNGKey(0))
    tparams = tloop.trainable(jparams, "cpu")
    before = tn.apply_network(tparams, torch.from_numpy(images),
                              tn.NetworkConfig(**cfg_kw), train=True)
    batch = {name: {k: v.detach().clone() for k, v in st.items()}
             for name, st in before["__bn_stats__"].items()}
    topt = tloop.make_optimizer("ADAM", 1e-3, tparams)
    step = tloop.make_train_step(tn.NetworkConfig(**cfg_kw),
                                 tloop.LossConfig(), tparams, topt)
    met = step(torch.from_numpy(images), torch.from_numpy(comps))
    assert all(v.dim() == 0 for v in met.values())
    assert sorted(met) == sorted(jmet)
    names = [n for n in tparams if n.startswith("bn")]
    assert names and sorted(names) == sorted(batch)
    for name in names:
        for part, init in (("mean", 0.0), ("var", 1.0)):
            want = tn.BN_MOMENTUM * init + (1 - tn.BN_MOMENTUM) * batch[
                name][part]
            got = tparams[name][part].detach()
            assert _rel(got.numpy(), want.numpy()) <= 1e-6, (name, part)
            assert _rel(got.numpy(), np.asarray(jp2[name][part])) <= 1e-5
    for name in tparams:
        if not name.startswith("bn"):
            for part in tparams[name]:
                if part == "bias" and "bn" + name[4:] in tparams:
                    continue   # a zero gradient's noise, scaled up by Adam
                np.testing.assert_allclose(
                    tparams[name][part].detach().numpy(),
                    np.asarray(jp2[name][part]), rtol=0, atol=1e-6)
    state = tloop.optimizer_state(topt, tparams)
    assert state["count"] == int(jo2[0].count) == 1
    for name in names:
        for part in ("mean", "var"):
            for key, jtree in (("mu", jo2[0].mu), ("nu", jo2[0].nu)):
                assert not state[key][name][part].any()
                assert not np.asarray(jtree[name][part]).any()


def test_bn_eval_uses_running_stats(rng):
    """train=False normalises with the stored statistics (caffe's TEST
    phase), so each batch sees the same normalisation; train=True with
    the batch's mean and population variance."""
    params = {"mean": np.array([1.0, -2.0], np.float32),
              "var": np.array([4.0, 0.25], np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = rng.randn(2, 3, 4, 2).astype(np.float32)
    for train in (False, True):
        want, wstats = jn.batch_norm(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            train=train)
        got, gstats = tn.batch_norm(tp, torch.from_numpy(x), train=train)
        assert _rel(got.numpy(), want) <= 1e-6
        for part in ("mean", "var"):
            assert _rel(gstats[part].numpy(), wstats[part]) <= 1e-6
    y1, _ = tn.batch_norm(tp, torch.from_numpy(x[:1]), train=False)
    y2, _ = tn.batch_norm(tp, torch.from_numpy(x), train=False)
    assert torch.equal(y1, y2[:1])
    np.testing.assert_allclose(y1.numpy(), (x[:1] - params["mean"])
                               / np.sqrt(params["var"] + 1e-5), rtol=1e-6)


def test_conv_static_grows_no_bn_params():
    """convStatic / convStaticWithSigmoid hardcode bn off
    (tests/test_train.py:384)."""
    for t in ("convStatic", "convStaticWithSigmoid"):
        cfg = tn.NetworkConfig(**_cfg(t, True, 1, "rRelMax"))
        params = tn.init_network(cfg, torch.Generator().manual_seed(0))
        assert not any(k.startswith("bn") for k in params), sorted(params)
        blobs = tn.apply_network(params, torch.rand(1, 8, 8, 3), cfg,
                                 train=True)
        assert blobs["__bn_stats__"] == {}


@pytest.mark.parametrize("kind", jn.NETWORK_TYPES)
@pytest.mark.parametrize("bn", [False, True])
def test_init_network_matches_jax_layout(kind, bn):
    """The same layers, parts and shapes as the JAX init, for every type
    the JAX package has (pix2pixUnet is the port's alone:
    tests/test_torch_pix2pix.py); xavier kernels, zero biases, running
    mean 0 and variance 1."""
    cfg_kw = _cfg(kind, bn, 1, "RS")
    want = _jparams(cfg_kw)
    got = tn.init_network(tn.NetworkConfig(**cfg_kw),
                          torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
        for part, v in want[name].items():
            assert tuple(got[name][part].shape) == v.shape, (name, part)
        if name.startswith("bn"):
            assert float(got[name]["mean"].abs().max()) == 0
            assert float((got[name]["var"] - 1).abs().max()) == 0
        else:
            k = got[name]["kernel"]
            a = np.sqrt(3.0 / np.prod(k.shape[:3]))
            assert 0 < float(k.abs().max()) <= a
            assert float(got[name]["bias"].abs().max()) == 0


def test_unknown_network_type_raises():
    with pytest.raises(ValueError, match="not known"):
        tn.init_network(tn.NetworkConfig(network_type="resNet"))
    with pytest.raises(ValueError, match="not known"):
        tn.apply_network({}, torch.zeros(1, 8, 8, 3),
                         tn.NetworkConfig(network_type="resNet"))
