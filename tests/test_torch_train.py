"""The port's training subsystem (models/recover.py, losses/losses.py,
train/loop.py, train/checkpoint.py, train/description.py, train/monitors.py,
train/predict.py, data/loader.py) against the JAX package, on the CPU, from
the same parameters (carried across with the converter; the two packages'
random generators differ).

Tolerances: losses within 1e-5 relative and parameter gradients within 1e-4
of each leaf's max (float32 sums taken in another order); one Adam step
within 1e-6 absolute, 8 fit steps within 1e-5 absolute (torch's Adam and
optax's adam are the same formula; their sums differ by ulps); exact where
both sides copy numbers (checkpoints, host selection, descriptions)."""
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reflectance_filtering_tpu.losses import losses as jl
from reflectance_filtering_tpu.models import recover as jr
from reflectance_filtering_tpu.models.networks import (
    NetworkConfig as JConfig, init_network as j_init)
from reflectance_filtering_tpu.train import checkpoint as jc
from reflectance_filtering_tpu.train import description as jd
from reflectance_filtering_tpu.train import loop as jloop
from reflectance_filtering_tpu.train import monitors as jm
from reflectance_filtering_tpu.train import predict as jp
from reflectance_filtering_tpu_torch.losses import losses as tl
from reflectance_filtering_tpu_torch.models import recover as tr
from reflectance_filtering_tpu_torch.models.networks import (
    NetworkConfig, init_network, params_to_numpy, params_to_torch)
from reflectance_filtering_tpu_torch.train import checkpoint as tc
from reflectance_filtering_tpu_torch.train import description as td
from reflectance_filtering_tpu_torch.train import loop as tloop
from reflectance_filtering_tpu_torch.train import monitors as tm
from reflectance_filtering_tpu_torch.train import predict as tp
from tests.test_whdr import make_blob, random_comps

SKIP = dict(network_type="convStaticSkipLayers", kernel_pad=0)


@pytest.fixture(scope="module")
def tiny_data():
    rng = np.random.RandomState(0)
    n, h, w = 6, 24, 24
    images = (rng.rand(n, h, w, 3).astype(np.float32) * 0.8 + 0.1)
    images[0, :5, :5] = 0.0             # black pixels: zero reflectance
    comps = np.stack([make_blob(random_comps(rng, 12)) for _ in range(n)])
    return {"images": images, "comparisons": comps.astype(np.float32)}


def _jparams(cfg_kw, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(seed), JConfig(**cfg_kw)))


def _leaves(tree):
    return [(layer, part) for layer in sorted(tree)
            for part in sorted(tree[layer])]


def _assert_trees(got, want, atol=0.0, rel=None):
    assert _leaves(got) == _leaves(want)
    for layer, part in _leaves(want):
        a = np.asarray(got[layer][part])
        b = np.asarray(want[layer][part])
        assert a.shape == b.shape, (layer, part)
        if rel is not None:
            err = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
            assert err <= rel, (layer, part, err)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg="{}/{}".format(layer, part))


@pytest.mark.parametrize("mode", tr.RS_EST_MODES)
def test_recover_modes_match_jax(mode, rng):
    c = {"RS": 6, "R": 3, "S": 3}.get(mode, 1)
    est = rng.rand(2, 5, 6, c).astype(np.float32) * 1.5 - 0.2
    est[0, 0, 0] = tr.EPS                # a tie with the eps floor
    images = rng.rand(2, 5, 6, 3).astype(np.float32)
    images[1, 2, 3] = 0.0                # a black pixel
    cot = [rng.rand(2, 5, 6, 3).astype(np.float32) for _ in range(2)]

    def jf(e):
        r, s = jr.recover_reflectance_shading(e, jnp.asarray(images), mode)
        return jnp.sum(r * cot[0]) + jnp.sum(s * cot[1]), (r, s)

    (_, (jr_, js)), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(est))
    e = torch.from_numpy(est).requires_grad_()
    r, s = tr.recover_reflectance_shading(e, torch.from_numpy(images), mode)
    (g,) = torch.autograd.grad((r * torch.from_numpy(cot[0])).sum()
                               + (s * torch.from_numpy(cot[1])).sum(), e)
    for a, b in ((r, jr_), (s, js)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_boundary_and_lambert_losses_match_jax(norm, rng):
    x = (rng.rand(2, 4, 5, 3) * 1.6 - 0.3).astype(np.float32)
    y = rng.rand(2, 4, 5, 3).astype(np.float32)
    img = rng.rand(2, 4, 5, 3).astype(np.float32)
    assert abs(tl.boundary_loss(torch.from_numpy(x), norm).item()
               - float(jl.boundary_loss(jnp.asarray(x), norm))) <= 1e-7
    assert abs(tl.lambert_loss(*map(torch.from_numpy, (x, y, img))).item()
               - float(jl.lambert_loss(*map(jnp.asarray, (x, y, img))))) \
        <= 1e-6
    with pytest.raises(ValueError):
        tl.boundary_loss(torch.from_numpy(x), "L3")


@pytest.mark.parametrize("cfg_kw,loss_kw,keys", [
    (dict(SKIP, num_layers=2, num_filters_log=3, rs_est_mode="rDirectly"),
     {}, ()),
    (dict(SKIP, num_layers=2, num_filters_log=3, rs_est_mode="rRelMax"),
     {}, ("loss_boundaries_reflectance", "loss_boundaries_shading")),
    (dict(SKIP, num_layers=1, num_filters_log=3, rs_est_mode="RS"),
     {"loss_scale_lambert": 1.0}, ("loss_lambert",)),
    (dict(network_type="convStaticSkipLayers", kernel_pad=1, num_layers=2,
          num_filters_log=2, rs_est_mode="rRelMean"), {}, ())])
def test_compute_losses_matches_jax(cfg_kw, loss_kw, keys, tiny_data):
    """rDirectly, rRelMax with its boundary losses (the images hold a black
    patch: zero reflectance there), RS with its lambert loss, and a 3x3
    kernel (the plain per-layer path): the loss graph and its gradients."""
    params = _jparams(cfg_kw)
    images = tiny_data["images"][:3]
    comps = tiny_data["comparisons"][:3]

    def jf(p):
        return jloop.compute_losses(p, jnp.asarray(images),
                                    jnp.asarray(comps), JConfig(**cfg_kw),
                                    jloop.LossConfig(**loss_kw))

    (jtot, jmet), jg = jax.value_and_grad(jf, has_aux=True)(params)
    tparams = params_to_torch(params)
    leaves = [t.requires_grad_() for layer in tparams.values()
              for t in layer.values()]
    tot, met = tloop.compute_losses(
        tparams, torch.from_numpy(images), torch.from_numpy(comps),
        NetworkConfig(**cfg_kw), tloop.LossConfig(**loss_kw))
    grads = torch.autograd.grad(tot, leaves)
    assert sorted(met) == sorted(k for k in jmet if k != "bn_stats")
    for k in ("loss_whdr_hinge", "whdr_original", "loss_total") + keys:
        assert k in met
        assert abs(met[k].item() - float(jmet[k])) <= 1e-5 * max(
            abs(float(jmet[k])), 1e-6), k
    it = iter(grads)
    got = {layer: {part: next(it).numpy() for part in parts}
           for layer, parts in tparams.items()}
    _assert_trees(got, jax.tree_util.tree_map(np.asarray, jg), rel=1e-4)


def test_one_adam_step_matches_optax(tiny_data):
    cfg_kw = dict(SKIP, num_layers=2, num_filters_log=3,
                  rs_est_mode="rDirectly")
    params = _jparams(cfg_kw, seed=1)
    images = tiny_data["images"][:4]
    comps = tiny_data["comparisons"][:4]
    opt = jloop.make_optimizer("ADAM", 1e-3)
    jstep = jloop.make_train_step(JConfig(**cfg_kw), jloop.LossConfig(), opt)
    jp2, jo2, jmet = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                           opt.init(params), jnp.asarray(images),
                           jnp.asarray(comps), jax.random.PRNGKey(0))
    tparams = tloop.trainable(params, "cpu")
    topt = tloop.make_optimizer("ADAM", 1e-3, tparams)
    step = tloop.make_train_step(NetworkConfig(**cfg_kw), tloop.LossConfig(),
                                 tparams, topt)
    met = step(torch.from_numpy(images), torch.from_numpy(comps))
    assert abs(met["loss_total"].item() - float(jmet["loss_total"])) <= 1e-6
    _assert_trees(params_to_numpy(tparams),
                  jax.tree_util.tree_map(np.asarray, jp2), atol=1e-6)
    state = tloop.optimizer_state(topt, tparams)
    assert state["count"] == int(jo2[0].count) == 1
    _assert_trees(state["mu"], jax.tree_util.tree_map(np.asarray, jo2[0].mu),
                  atol=1e-7)


def _fit_both(data, cfg_kw, iterations, tmp_path, **kw):
    params = _jparams(cfg_kw, seed=2)
    jlog, tlog = [], []
    jstate = jloop.fit(JConfig(**cfg_kw), jloop.LossConfig(), data,
                       iterations, 4, random_seed=0, init_params=params,
                       progress=lambda s, n, m: jlog.append((s, n, m)), **kw)
    tstate = tloop.fit(NetworkConfig(**cfg_kw), tloop.LossConfig(), data,
                       iterations, 4, random_seed=0, init_params=params,
                       progress=lambda s, n, m: tlog.append((s, n, m)),
                       device="cpu", **kw)
    return jstate, tstate, jlog, tlog


def test_fit_eight_steps_matches_jax(tiny_data, tmp_path):
    """8 steps of batch 4 over 6 images (the batches wrap) from the same
    params: every step's losses, the final params and the Adam state."""
    cfg_kw = dict(SKIP, num_layers=2, num_filters_log=3,
                  rs_est_mode="rDirectly")
    jstate, tstate, jlog, tlog = _fit_both(tiny_data, cfg_kw, 32, tmp_path)
    assert [(s, n) for s, n, _ in tlog] == [(s, n) for s, n, _ in jlog]
    assert len(tlog) == 8 and tstate.samples == jstate.samples == 32
    for (_, _, tmet), (_, _, jmet) in zip(tlog, jlog):
        assert sorted(tmet) == sorted(jmet)
        assert abs(tmet["loss_total"] - jmet["loss_total"]) <= 1e-5 * max(
            abs(jmet["loss_total"]), 1e-6)
    _assert_trees(params_to_numpy(tstate.params),
                  jax.tree_util.tree_map(np.asarray, jstate.params),
                  atol=1e-5)
    assert tstate.opt_state["count"] == 8


def test_fit_host_selection_matches_jax(tmp_path):
    """K > 1500: both fits select on the host, keyed by the global step, so
    they see identical compact blobs every step."""
    rng = np.random.RandomState(4)
    n, h, w, k = 4, 20, 20, 1600
    data = {"images": rng.rand(n, h, w, 3).astype(np.float32) * 0.8 + 0.1,
            "comparisons": np.stack([
                make_blob(random_comps(rng, num), k)
                for num in (1550, 1600, 30, 1501)]).astype(np.float32)}
    cfg_kw = dict(SKIP, num_layers=1, num_filters_log=3,
                  rs_est_mode="rDirectly")
    jstate, tstate, jlog, tlog = _fit_both(data, cfg_kw, 12, tmp_path)
    for (_, _, tmet), (_, _, jmet) in zip(tlog, jlog):
        assert abs(tmet["loss_whdr_hinge"] - jmet["loss_whdr_hinge"]) <= \
            1e-5 * abs(jmet["loss_whdr_hinge"])
    _assert_trees(params_to_numpy(tstate.params),
                  jax.tree_util.tree_map(np.asarray, jstate.params),
                  atol=1e-5)


def test_resume_equals_uninterrupted(tiny_data, tmp_path):
    cfg = NetworkConfig(**SKIP, num_layers=2, num_filters_log=3)
    lcfg = tloop.LossConfig()
    full = tloop.fit(cfg, lcfg, tiny_data, 32, 4, random_seed=3,
                     device="cpu")
    ck = tc.Checkpointer(str(tmp_path), "d", interval=16)
    tloop.fit(cfg, lcfg, tiny_data, 16, 4, random_seed=3, checkpointer=ck,
              device="cpu")
    params, opt_state, _ = tc.load_checkpoint(ck.path(16))
    resumed = tloop.fit(cfg, lcfg, tiny_data, 32, 4, random_seed=3,
                        init_params=params, init_opt_state=opt_state,
                        base_samples=16, device="cpu")
    assert resumed.samples == 32 and resumed.step == 8
    _assert_trees(params_to_numpy(resumed.params),
                  params_to_numpy(full.params), atol=1e-6)


def test_fit_checkpoints_callbacks_and_live_val(tiny_data, tmp_path):
    """The crossing rule, the order of callbacks, the live val WHDR carried
    into later steps, and the forced final snapshot, as in the JAX fit."""
    cfg_kw = dict(SKIP, num_layers=2, num_filters_log=3,
                  rs_est_mode="rDirectly")
    events = {"jax": [], "torch": []}

    def run(pkg, loop, cfg_cls, extra):
        log = events[pkg]
        ck = (jc if pkg == "jax" else tc).Checkpointer(
            str(tmp_path / pkg), "d", interval=8)
        os.makedirs(ck.snapshot_dir)
        val = {"jax": lambda p: 0.25, "torch": lambda p: 0.25}[pkg]
        loop.fit(cfg_cls(**cfg_kw), loop.LossConfig(), tiny_data, 22, 4,
                 random_seed=0, init_params=_jparams(cfg_kw), checkpointer=ck,
                 callbacks=[lambda s, m: log.append(("cb", s,
                                                     "val_whdr" in m))],
                 on_checkpoint=lambda n, p: log.append(("ckpt", n)),
                 val_fn=val, **extra)
        return sorted(os.listdir(ck.snapshot_dir))

    jsnaps = run("jax", jloop, JConfig, {})
    tsnaps = run("torch", tloop, NetworkConfig, {"device": "cpu"})
    assert tsnaps == jsnaps == ["d_barrista_iter_{}.npz".format(i)
                                for i in (16, 20, 8)]
    assert events["torch"] == events["jax"]


def test_checkpoints_cross_both_ways(tiny_data, tmp_path):
    """A JAX-written snapshot loads in the port (params and Adam state) and
    resumes there; the port's loads in the JAX package's load_checkpoint."""
    cfg_kw = dict(SKIP, num_layers=2, num_filters_log=3,
                  rs_est_mode="rDirectly")
    jck = jc.Checkpointer(str(tmp_path / "j"), "d", interval=8)
    os.makedirs(jck.snapshot_dir)
    jstate = jloop.fit(JConfig(**cfg_kw), jloop.LossConfig(), tiny_data, 8,
                       4, random_seed=0, init_params=_jparams(cfg_kw),
                       checkpointer=jck)
    params, opt_state, meta = tc.load_checkpoint(jck.path(8))
    _assert_trees(params, jax.tree_util.tree_map(np.asarray, jstate.params))
    assert opt_state["count"] == int(jstate.opt_state[0].count) == 2
    _assert_trees(opt_state["nu"], jax.tree_util.tree_map(
        np.asarray, jstate.opt_state[0].nu))
    # resume the JAX run in the port and in JAX: the same params
    jres = jloop.fit(JConfig(**cfg_kw), jloop.LossConfig(), tiny_data, 16,
                     4, random_seed=0, init_params=jstate.params,
                     init_opt_state=jstate.opt_state, base_samples=8)
    tres = tloop.fit(NetworkConfig(**cfg_kw), tloop.LossConfig(), tiny_data,
                     16, 4, random_seed=0, init_params=params,
                     init_opt_state=opt_state, base_samples=8, device="cpu")
    _assert_trees(params_to_numpy(tres.params),
                  jax.tree_util.tree_map(np.asarray, jres.params), atol=1e-5)
    # the port's snapshot in the JAX package
    path = str(tmp_path / "t.npz")
    tc.save_checkpoint(path, tres.params, tres.opt_state, {"iterations": 16})
    template = j_init(jax.random.PRNGKey(9), JConfig(**cfg_kw))
    opt = jloop.make_optimizer("ADAM", 1e-3)
    p2, o2, meta = jc.load_checkpoint(path, template, opt.init(template))
    assert meta == {"iterations": 16}
    _assert_trees(jax.tree_util.tree_map(np.asarray, p2),
                  params_to_numpy(tres.params))
    assert int(o2[0].count) == 4
    _assert_trees(jax.tree_util.tree_map(np.asarray, o2[0].mu),
                  tres.opt_state["mu"])


def _args(**kw):
    defaults = dict(networkType="convStaticSkipLayers", numLayers=5,
                    num_filters_log=5, kernel_pad=0, dilation=1,
                    use_batch_normalization=0, RS_est_mode="rDirectly",
                    whdr_delta_margin_ratio_dense="0.1_0.05_1.0_1",
                    loss_scale_whdr=10.0, loss_scale_lambert=0,
                    height=256, width=256, dataset="iiw",
                    solverType="ADAM", base_lr=0.001,
                    comparisonsType="comparisons")
    defaults.update(kw)
    return types.SimpleNamespace(**defaults)


@pytest.mark.parametrize("kw", [
    {}, dict(numLayers=3, num_filters_log=4, kernel_pad=1,
             RS_est_mode="rRelMax"),
    dict(numLayers=2, num_filters_log=4, kernel_pad=1, RS_est_mode="rRelMax",
         height=32, width=48, solverType="SGD", base_lr=0.01),
    dict(loss_scale_whdr=0.0, loss_scale_lambert=1e-30, dataset="sintel")])
def test_description_matches_jax(kw):
    args = _args(**kw)
    assert td.get_description(args) == jd.get_description(args)
    if not kw:
        assert td.get_description(args)[1] == (
            "convStaticSkipLayers_n5_f32_k1_d1_bn0_rDirectly_"
            "wdm0.1_0.05_1.0_1_loss[w1.0E+01,l0]_ADAM0.001_"
            "comparisons_h256w256iiw")
    name = td.get_description(args)[1] + "_barrista_iter_2000.npz"
    assert td.parse_description(name) == jd.parse_description(name)


def test_checkpoint_roundtrip_and_interval_naming(tmp_path):
    params = init_network(NetworkConfig(**SKIP, num_layers=2,
                                        num_filters_log=3),
                          torch.Generator().manual_seed(0))
    path = str(tmp_path / "ck.npz")
    tc.save_checkpoint(path, params, None, {"iterations": 42})
    p2, o2, meta = tc.load_checkpoint(path)
    assert meta["iterations"] == 42 and o2 is None
    _assert_trees(p2, params_to_numpy(params))
    ck = tc.Checkpointer(str(tmp_path), "desc", interval=40)
    assert ck.maybe_save(20, params) is None
    assert ck.maybe_save(40, params).endswith("desc_barrista_iter_40.npz")
    assert ck.maybe_save(40, params) is None   # double-save prevented
    ck.maybe_save(60, params, finalize=True)
    assert ck.highest_iteration() == 60
    assert ck.would_save(43, prev=38) and not ck.would_save(44, prev=41)


@pytest.mark.parametrize("which", ["combine_running", "jsonl", "vis"])
def test_monitors_match_jax(which, tmp_path):
    if which == "combine_running":
        for mod in (tm, jm):
            m = mod.CombineLosses(10.0, 2.0)(0, {"loss_whdr_hinge": 0.5,
                                                 "loss_lambert": 0.25})
            assert m["loss_combined"] == 10.0 * 0.5 + 2.0 * 0.25
        ras = [mod.RunningAverage(train_size=40, batch_size=10)
               for mod in (tm, jm)]
        for step, v in enumerate([0.4, 0.2, np.nan, 0.6, 0.1]):
            a, b = (ra(step, {"whdr_original": v}) for ra in ras)
            assert a == b
    elif which == "jsonl":
        recs = []
        for mod in (tm, jm):
            lg = mod.JsonlLogger(str(tmp_path / mod.__name__), "t")
            lg(0, {"loss": float("nan"), "lr": 0.1, "extra": float("inf"),
                   "skipme": "string"})
            lg(1, {"loss": 0.5})
            lg.close()
            with open(lg.path) as f:
                recs.append([json.loads(line) for line in f])
        assert recs[0] == recs[1] == [
            {"step": 0, "loss": None, "lr": 0.1, "extra": None},
            {"step": 1, "loss": 0.5}]
    else:
        data = np.random.RandomState(0).rand(10, 5, 5)
        out = tm.vis_square(data)
        assert out.shape == (4 * 6, 4 * 6)
        np.testing.assert_array_equal(out, jm.vis_square(data))
        tm.FilterVisualizer(str(tmp_path))(8, params_to_numpy(init_network(
            NetworkConfig(**SKIP, num_layers=1, num_filters_log=2))))
        assert os.listdir(str(tmp_path / "images")) == ["filters_iter_8.png"]


def test_predict_and_score_matches_jax(tiny_data, tmp_path):
    cfg_kw = dict(SKIP, num_layers=2, num_filters_log=3,
                  rs_est_mode="rRelMax")
    params = _jparams(cfg_kw)
    jscore = jp.predict_and_score(tiny_data, params, JConfig(**cfg_kw),
                                  str(tmp_path / "j"), "desc", batch_size=4)
    tdir = str(tmp_path / "t")
    score = tp.predict_and_score(tiny_data, params_to_torch(params),
                                 NetworkConfig(**cfg_kw), tdir, "desc",
                                 batch_size=4, device="cpu")
    assert abs(score - jscore) <= 1e-4
    n = tiny_data["images"].shape[0]
    score_file = os.path.join(tdir, "scores", "desc_imgs{}.txt".format(n))
    assert os.path.isfile(os.path.join(tdir, "framerates",
                                       "desc_imgs{}.txt".format(n)))
    with open(score_file, "w") as f:      # the score cache is read back
        f.write("12.5")
    assert tp.predict_and_score(tiny_data, None, NetworkConfig(**cfg_kw),
                                tdir, "desc", device="cpu") == 12.5
    # a prediction that fails returns the sentinel 100
    assert tp.predict_and_score(tiny_data, {}, NetworkConfig(**cfg_kw),
                                tdir, "other", device="cpu") == 100


def test_init_network_is_caffe_xavier():
    cfg = NetworkConfig(num_filters_log=6)
    p = init_network(cfg, torch.Generator().manual_seed(0))
    j = _jparams(dict(num_filters_log=6))
    _assert_trees(jax.tree_util.tree_map(np.zeros_like, j),
                  {k: {q: np.zeros_like(v.numpy()) for q, v in d.items()}
                   for k, d in p.items()})
    k = p["conv1"]["kernel"]
    a = np.sqrt(3.0 / 64)
    assert k.abs().max().item() <= a and k.abs().max().item() > 0.9 * a
    assert abs(k.std().item() - a / np.sqrt(3)) < 0.05 * a
    assert all(float(d["bias"].abs().max()) == 0 for d in p.values())
    again = init_network(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["conv3"]["kernel"], p["conv3"]["kernel"])
    # uNet, the cascade and batch normalization initialise as the JAX
    # package lays them out, and train: one Adam step moves every kernel
    for kw in (dict(network_type="uNet", num_layers=1),
               dict(network_type="cascadeSkipLayers", num_layers=2,
                    num_filters_log=3),
               dict(SKIP, num_layers=2, num_filters_log=3,
                    use_batch_normalization=True)):
        kw["rs_est_mode"] = "rRelMax"
        params = init_network(NetworkConfig(**kw),
                              torch.Generator().manual_seed(0))
        assert _leaves(params) == _leaves(_jparams(kw))
        tparams = tloop.trainable(params, "cpu")
        step = tloop.make_train_step(
            NetworkConfig(**kw), tloop.LossConfig(), tparams,
            tloop.make_optimizer("ADAM", 1e-3, tparams))
        rng = np.random.RandomState(1)
        met = step(torch.from_numpy(
            rng.rand(2, 16, 16, 3).astype(np.float32) * 0.8 + 0.1),
            torch.from_numpy(np.stack([make_blob(random_comps(rng, 12))
                                       for _ in range(2)])
                             .astype(np.float32)))
        assert np.isfinite(met["loss_total"].item()), kw
        for layer in params:
            if "kernel" in params[layer]:
                assert not torch.equal(tparams[layer]["kernel"],
                                       params[layer]["kernel"]), layer


def test_loader_matches_jax(tmp_path, rng):
    from reflectance_filtering_tpu.data.loader import get_data as j_get
    from reflectance_filtering_tpu_torch.data.loader import get_data
    os.makedirs(str(tmp_path / "iiw"))
    np.savez(str(tmp_path / "iiw" / "x.npz"),
             images=rng.rand(3, 3, 4, 5).astype(np.float32),
             comparisons=rng.rand(3, 7, 1, 6).astype(np.float32))
    a = get_data("iiw", "x", root=str(tmp_path))
    b = j_get("iiw", "x", root=str(tmp_path))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert a["images"].shape == (3, 4, 5, 3)
    with pytest.raises(IOError):
        get_data("iiw", "missing", root=str(tmp_path))


# ---------------------------------------------------------------------------
# fit's chunked trainer (make_train_chunk) against its per-step trainer and
# the JAX package's chunked fit
# ---------------------------------------------------------------------------

CHUNK_CFG = dict(SKIP, num_layers=2, num_filters_log=3,
                 rs_est_mode="rDirectly")


@pytest.fixture
def chunk_spy(monkeypatch):
    """Counts fit's make_train_chunk calls (which trainer ran)."""
    calls = []
    real = tloop.make_train_chunk

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(tloop, "make_train_chunk", spy)
    return calls


def _per_step(monkeypatch, fn):
    """fn() with fit forced onto its per-step trainer (no resident set)."""
    with monkeypatch.context() as m:
        m.setattr(tloop, "DEVICE_FEED_BUDGET_BYTES", 0)
        return fn()


@pytest.mark.parametrize("chunk_steps", [32, 3])
def test_fit_chunked_matches_per_step_trainer(tiny_data, monkeypatch,
                                              chunk_spy, chunk_steps):
    """The JAX package's gate (tests/test_train.py:398-421) on the port:
    40 samples at batch 4 (10 steps, the batches wrap), lr 0.01, seed 7; one
    chunk, then chunks of 3 (3, 3, 3 and a remainder of 1)."""
    monkeypatch.setattr(tloop, "TRAIN_CHUNK_STEPS", chunk_steps)
    cfg, lcfg = NetworkConfig(**CHUNK_CFG), tloop.LossConfig()

    def run():
        log = []
        st = tloop.fit(cfg, lcfg, tiny_data, iterations=40, batch_size=4,
                       base_lr=0.01, random_seed=7, device="cpu",
                       progress=lambda s, n, m: log.append((s, n, m)))
        return st, log

    chunked, clog = run()
    assert chunk_spy == [4]
    step, slog = _per_step(monkeypatch, run)
    assert chunk_spy == [4]              # the per-step run made no chunk
    assert [(s, n) for s, n, _ in clog] == [(s, n) for s, n, _ in slog] == [
        (s, 4 * (s + 1)) for s in range(10)]
    assert [m for _, _, m in clog] == [m for _, _, m in slog]
    assert chunked.step == step.step == 10
    assert chunked.opt_state["count"] == step.opt_state["count"] == 10
    for (layer, part) in _leaves(step.params):
        np.testing.assert_allclose(
            chunked.params[layer][part].detach().numpy(),
            step.params[layer][part].detach().numpy(), rtol=2e-5, atol=1e-7)


def test_fit_chunked_matches_jax_chunked_fit(tiny_data, monkeypatch):
    """12 steps over 6 images from the same weights: the JAX fit runs one
    scan chunk of 12, the port chunks of 5, 5 and 2; every step's losses and
    the final params and Adam state at test_fit_eight_steps_matches_jax's
    tolerances."""
    monkeypatch.setattr(tloop, "TRAIN_CHUNK_STEPS", 5)
    jstate, tstate, jlog, tlog = _fit_both(tiny_data, CHUNK_CFG, 48, None)
    assert [(s, n) for s, n, _ in tlog] == [(s, n) for s, n, _ in jlog]
    assert len(tlog) == 12 and tstate.samples == jstate.samples == 48
    for (_, _, tmet), (_, _, jmet) in zip(tlog, jlog):
        assert sorted(tmet) == sorted(jmet)
        for key in jmet:
            assert abs(tmet[key] - jmet[key]) <= 1e-5 * max(
                abs(jmet[key]), 1e-6), key
    _assert_trees(params_to_numpy(tstate.params),
                  jax.tree_util.tree_map(np.asarray, jstate.params),
                  atol=1e-5)
    assert tstate.opt_state["count"] == int(jstate.opt_state[0].count) == 12
    _assert_trees(tstate.opt_state["mu"], jax.tree_util.tree_map(
        np.asarray, jstate.opt_state[0].mu), atol=1e-6)


def test_fit_chunked_checkpoints_off_chunk_boundary(tiny_data, tmp_path,
                                                    monkeypatch, chunk_spy):
    """Chunks of 4 steps, a checkpoint every 6 (24 samples) over 14 steps:
    chunks of 4, 2 | 4, 2 | 2, each checkpoint the last step of its chunk.
    The chunked, per-step and JAX fits save the same sample counts, the
    callbacks see every global step once and in order, 'val_whdr' appears
    from the step after each save, and the val function sees the params
    of the checkpoint's step (the port's chunked and per-step runs agree on
    them)."""
    monkeypatch.setattr(tloop, "TRAIN_CHUNK_STEPS", 4)

    def run(pkg, extra=None):
        loop, ckm = ((jloop, jc) if pkg == "jax" else (tloop, tc))
        cfg = (JConfig if pkg == "jax" else NetworkConfig)(**CHUNK_CFG)
        ck = ckm.Checkpointer(str(tmp_path / pkg), "d", interval=24)
        os.makedirs(ck.snapshot_dir)
        log = []

        def val(p):
            leaf = np.asarray(p["conv0"]["kernel"].detach()
                              if pkg != "jax" else p["conv0"]["kernel"])
            return float(np.abs(leaf).sum())

        loop.fit(cfg, loop.LossConfig(), tiny_data, 56, 4, random_seed=0,
                 init_params=_jparams(CHUNK_CFG), checkpointer=ck,
                 callbacks=[lambda s, m: log.append(
                     ("cb", s, m.get("val_whdr")))],
                 on_checkpoint=lambda n, p: log.append(("ckpt", n)),
                 val_fn=val, **(extra or {}))
        return sorted(os.listdir(ck.snapshot_dir)), log

    tsnaps, tlog = run("chunked", {"device": "cpu"})
    assert chunk_spy == [4]
    psnaps, plog = _per_step(monkeypatch,
                             lambda: run("per-step", {"device": "cpu"}))
    jsnaps, jlog = run("jax")
    assert tsnaps == psnaps == jsnaps == [
        "d_barrista_iter_{}.npz".format(i) for i in (24, 48, 56)]
    assert tlog == plog
    # the JAX run's val values come from its own params (1e-6 relative)
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    steps = [e[1] for e in tlog if e[0] == "cb"]
    assert steps == list(range(14))
    ckpts = [i for i, e in enumerate(tlog) if e[0] == "ckpt"]
    assert [tlog[i][1] for i in ckpts] == [24, 48, 56]
    assert [tlog[i - 1][1] for i in ckpts] == [5, 11, 13]
    vals = [e[2] for e in tlog if e[0] == "cb"]
    assert vals[:6] == [None] * 6 and None not in vals[6:]
    assert vals[6] != vals[12]            # re-evaluated at the second save
    for a, b in zip([e[2] for e in jlog if e[0] == "cb"], vals):
        assert (a is None) == (b is None)
        assert a is None or abs(a - b) <= 1e-6 * abs(b)
    for name in tsnaps:
        pa, oa, _ = tc.load_checkpoint(str(tmp_path / "chunked" / name))
        pb, ob, _ = tc.load_checkpoint(str(tmp_path / "per-step" / name))
        _assert_trees(pa, pb, atol=1e-7)
        assert oa["count"] == ob["count"] == int(name[16:-4]) // 4


def test_resume_equals_uninterrupted_chunked(tiny_data, tmp_path,
                                             monkeypatch, chunk_spy):
    """fit(14 steps) against fit(7 steps) + checkpoint + resume to 14, all
    through chunks of 3 (the resumed run starts mid-set, at sample 28)."""
    monkeypatch.setattr(tloop, "TRAIN_CHUNK_STEPS", 3)
    cfg = NetworkConfig(**CHUNK_CFG)
    lcfg = tloop.LossConfig()
    full = tloop.fit(cfg, lcfg, tiny_data, 56, 4, random_seed=3,
                     device="cpu")
    ck = tc.Checkpointer(str(tmp_path), "d", interval=28)
    tloop.fit(cfg, lcfg, tiny_data, 28, 4, random_seed=3, checkpointer=ck,
              device="cpu")
    params, opt_state, _ = tc.load_checkpoint(ck.path(28))
    steps = []
    resumed = tloop.fit(cfg, lcfg, tiny_data, 56, 4, random_seed=3,
                        init_params=params, init_opt_state=opt_state,
                        base_samples=28, device="cpu",
                        progress=lambda s, n, m: steps.append((s, n)))
    assert chunk_spy == [4, 4, 4]
    assert steps == [(s, 4 * (s + 1)) for s in range(7, 14)]
    assert resumed.samples == 56 and resumed.step == 14
    assert resumed.opt_state["count"] == full.opt_state["count"] == 14
    _assert_trees(params_to_numpy(resumed.params),
                  params_to_numpy(full.params), atol=1e-6)


def test_fit_chunked_wdm_ratio_below_one(tiny_data, monkeypatch, chunk_spy):
    """The hinge's ratio subsampling (ceil(ratio * n) of each image's
    comparisons, from a table made once on the device) through chunks of 4:
    equal to the per-step trainer, and to the JAX package's fit at
    test_fit_eight_steps_matches_jax's tolerance."""
    from reflectance_filtering_tpu_torch.losses import whdr as tw
    monkeypatch.setattr(tloop, "TRAIN_CHUNK_STEPS", 4)
    wdm = "0.1_0.05_0.4_1"
    lkw = dict(whdr_delta_margin_ratio_dense=wdm)
    params = _jparams(CHUNK_CFG, seed=2)

    def run():
        log = []
        st = tloop.fit(NetworkConfig(**CHUNK_CFG), tloop.LossConfig(**lkw),
                       tiny_data, 40, 4, random_seed=0, init_params=params,
                       device="cpu",
                       progress=lambda s, n, m: log.append(m))
        return st, log

    tw._ratio_table.cache_clear()
    chunked, clog = run()
    assert chunk_spy == [4]
    # one table for the run: every step after the first read it cached
    assert tw._ratio_table.cache_info().misses == 1
    step, slog = _per_step(monkeypatch, run)
    assert clog == slog
    _assert_trees(params_to_numpy(chunked.params),
                  params_to_numpy(step.params), atol=1e-7)
    jlog = []
    jstate = jloop.fit(JConfig(**CHUNK_CFG), jloop.LossConfig(**lkw),
                       tiny_data, 40, 4, random_seed=0, init_params=params,
                       progress=lambda s, n, m: jlog.append(m))
    for tmet, jmet in zip(clog, jlog):
        assert abs(tmet["loss_whdr_hinge"] - jmet["loss_whdr_hinge"]) <= \
            1e-5 * max(abs(jmet["loss_whdr_hinge"]), 1e-6)
    _assert_trees(params_to_numpy(chunked.params),
                  jax.tree_util.tree_map(np.asarray, jstate.params),
                  atol=1e-5)


def test_make_train_chunk_matches_train_step(tiny_data):
    """make_train_chunk on the CPU against make_train_step on the same
    wrap-padded rows: chunks of 5 and 4 from cursor 3 (the batches wrap
    past the set's end), stacked metrics in sorted key order, params
    bitwise; a chunk of 0 or of more than TRAIN_CHUNK_STEPS raises."""
    cfg, lcfg, bs = NetworkConfig(**CHUNK_CFG), tloop.LossConfig(), 4
    images = np.concatenate([tiny_data["images"],
                             tiny_data["images"][:bs - 1]])
    comps = np.concatenate([tiny_data["comparisons"],
                            tiny_data["comparisons"][:bs - 1]])
    n = tiny_data["images"].shape[0]
    pa = tloop.trainable(_jparams(CHUNK_CFG), "cpu")
    pb = tloop.trainable(_jparams(CHUNK_CFG), "cpu")
    im_t, cp_t = torch.from_numpy(images), torch.from_numpy(comps)
    chunk = tloop.make_train_chunk(cfg, lcfg, pa, tloop.make_optimizer(
        "ADAM", 1e-3, pa), im_t, cp_t, cp_t, bs)
    step = tloop.make_train_step(cfg, lcfg, pb,
                                 tloop.make_optimizer("ADAM", 1e-3, pb))
    cursor = 3
    for k in (5, 4):
        stacked = chunk(0, cursor, k).clone()
        assert stacked.shape == (k, len(chunk.keys))
        for j in range(k):
            start = (cursor + j * bs) % n
            met = step(im_t[start:start + bs], cp_t[start:start + bs])
            assert chunk.keys == sorted(met)
            assert stacked[j].tolist() == [met[key].item()
                                           for key in chunk.keys]
        cursor = (cursor + k * bs) % n
    for layer, part in _leaves(pb):
        assert torch.equal(pa[layer][part], pb[layer][part]), (layer, part)
    for k in (0, tloop.TRAIN_CHUNK_STEPS + 1):
        with pytest.raises(ValueError):
            chunk(0, 0, k)


def test_make_train_chunk_is_freed_without_gc(tiny_data):
    """make_train_chunk's callable holds no reference cycle, so dropping it
    frees its state (on a card its CUDA graph and the graph's memory) at
    once, not at a garbage collection that could fall inside a later
    capture; its keys are the first step's metrics, sorted."""
    import gc
    import weakref
    cfg, bs = NetworkConfig(**CHUNK_CFG), 4
    images = torch.from_numpy(np.concatenate(
        [tiny_data["images"], tiny_data["images"][:bs - 1]]))
    comps = torch.from_numpy(np.concatenate(
        [tiny_data["comparisons"], tiny_data["comparisons"][:bs - 1]]))
    params = tloop.trainable(_jparams(CHUNK_CFG), "cpu")
    chunk = tloop.make_train_chunk(
        cfg, tloop.LossConfig(), params,
        tloop.make_optimizer("ADAM", 1e-3, params), images, comps, comps, bs)
    stacked = chunk(0, 0, 2)
    assert chunk.keys == sorted(chunk.keys) and stacked.shape == (
        2, len(chunk.keys))
    ref = weakref.ref(chunk)
    gc.disable()
    try:
        del chunk
        assert ref() is None
    finally:
        gc.enable()


def test_launch_counts_follow_graph_replays(monkeypatch):
    """A wrapper's launch inside a CUDA graph capture runs nothing, so it
    is not counted then: it goes into the open record_launches tally (or
    nowhere without one), and count_replays adds the tally once a replay,
    as make_train_chunk does after its replays."""
    from reflectance_filtering_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.dx_launches = 0
    _build.count(wrapper)
    assert wrapper.launches == 1
    monkeypatch.setattr(_build, "_capturing", lambda: True)
    _build.count(wrapper)                   # a capture with no tally open
    with _build.record_launches() as tally:
        _build.count(wrapper)
        _build.count(wrapper, "dx_launches", 2)
    assert (wrapper.launches, wrapper.dx_launches) == (1, 0)
    assert tally == {(wrapper, "launches"): 1, (wrapper, "dx_launches"): 2}
    monkeypatch.undo()
    _build.count_replays(tally, 5)
    assert (wrapper.launches, wrapper.dx_launches) == (6, 10)
    assert not _build._tallies
