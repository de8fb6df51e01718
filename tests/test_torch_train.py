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
