"""The port's multi-process parallelism (reflectance_filtering_tpu_torch/
parallel/) on the CPU: gloo groups of 2 and 4 spawned processes over a
FileStore (no port opened), each rank on the CPU, against the port's
single-process run and the JAX package's mesh (tests/test_parallel.py's
gates):

  * sharded eval and predict/score against the single-process port and
    JAX's make_predict_fn + whdr, to 1e-6; chunked eval against whole;
  * the sharded train step (plain, batch norm over the global batch, and
    K > 1,500 with the capped draw) against the single-process step and,
    where neither draws, JAX's make_train_step on the same global batch:
    params within rtol 1e-5 / atol 1e-7, the hinge within 1e-6, every
    rank's params identical;
  * each sharded filter against the port's single-device filter and (at 4
    ranks) JAX's sharded one: box rtol 1e-5 / atol 1e-3, bilateral rtol 1e-4 / atol
    1e-3 (self-guided 0.05), guided rtol 1e-4 / atol 5e-3, the chain at
    r=45 rtol 1e-4 / atol 0.05 with rint <= 1 level on < 1e-4 of pixels;
  * narrow shards and non-dividing widths raise ValueError;
  * dryrun_multichip(2).

The spawned ranks import this module, so it imports JAX only inside
fixtures and tests."""
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu_torch.models.networks import (
    NetworkConfig, params_to_torch)
from reflectance_filtering_tpu_torch.parallel import dryrun
from reflectance_filtering_tpu_torch.parallel import mesh as pm
from reflectance_filtering_tpu_torch.parallel import spatial as ps
from reflectance_filtering_tpu_torch.train import loop as tloop
from reflectance_filtering_tpu_torch.train import predict as tp

WORLDS = [2, 4]
CFG = dict(network_type="convStaticSkipLayers", num_layers=2,
           num_filters_log=3, kernel_pad=0, rs_est_mode="rDirectly")
# (name, network config, comparisons per image, capped-draw seed, solver).
# Batch norm steps by SGD: a conv bias before batch norm has a zero
# gradient up to rounding, which Adam's first step would turn into +-lr.
STEPS = [("plain", CFG, 10, None, "ADAM"),
         ("batch_norm", dict(CFG, use_batch_normalization=True), 10, None,
          "SGD"),
         ("k1600", CFG, 1600, 5, "ADAM")]
CHAIN = (45, 3.0, 3)          # r, eps, iterations: halo 270 <= 320 columns
JAX_WORLD = 4                 # the JAX package's sharded filters' mesh


def _step_inputs(seed, k, n=16, hw=24):
    rng = np.random.RandomState(seed)
    images = rng.rand(n, hw, hw, 3).astype(np.float32) * 0.8 + 0.1
    comps = np.full((n, k + 1, 6), np.nan, np.float32)
    comps[:, :k, :4] = rng.rand(n, k, 4)
    comps[:, :k, 4] = rng.randint(0, 3, (n, k))
    comps[:, :k, 5] = rng.rand(n, k)
    comps[:, k, 0] = k
    comps[:, k, 1] = 12345.0
    comps[:, k, 2] = 0
    return images, comps


def _filter_inputs():
    rng = np.random.RandomState(2)
    u8 = lambda *s: np.floor(rng.rand(*s) * 256).astype(np.uint8)  # noqa
    return {
        "box": (rng.rand(32, 64, 3) * 255).astype(np.float32),
        "joint": (rng.rand(24, 64, 3) * 255).astype(np.float32),
        "src": (rng.rand(24, 64, 3) * 255).astype(np.float32),
        "joint_u8": u8(24, 64, 3), "src_u8": u8(24, 64, 1),
        "gray": u8(16, 64), "color": u8(16, 64, 3),
        "guide": (rng.rand(24, 64, 3) * 255).astype(np.float32),
        "gsrc": (rng.rand(24, 64) * 255).astype(np.float32),
        "chain_guide": u8(16, 1280, 3).astype(np.float32),
        "chain_src": u8(16, 1280).astype(np.float32),
    }


def _filters(x, mesh):
    """Every sharded filter on the inputs ``x`` (numpy), as numpy."""
    r, eps, iters = CHAIN
    out = {
        "box": ps.sharded_box_filter(x["box"], 3, mesh),
        "joint": ps.sharded_joint_bilateral(x["joint"], x["src"], mesh,
                                            sigma_space=2.0),
        "joint_u8": ps.sharded_joint_bilateral(x["joint_u8"], x["src_u8"],
                                               mesh, sigma_space=2.0),
        "gray_self": ps.sharded_bilateral_gray_self(
            x["gray"], mesh, sigma_space=2.0, reps=3),
        "color_self": ps.sharded_bilateral_color_self(x["color"], mesh,
                                                      sigma_space=2.0),
        "guided": ps.sharded_guided_filter(x["guide"], x["gsrc"], 3, 9.0,
                                           mesh),
        "guided_gray": ps.sharded_guided_filter(x["guide"][..., 0],
                                                x["gsrc"], 3, 9.0, mesh),
        "chain": ps.sharded_guided_filter_iterated(
            x["chain_guide"], x["chain_src"], r, eps, iters, mesh),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def _rank_cases(mesh, params, steps, eval_data, x):
    """One rank's work: eval, predict/score, the train steps and the
    filters."""
    net_cfg = NetworkConfig(**CFG)
    res = {"rank": mesh.rank}
    res["eval"] = pm.eval_dataset_sharded(params, eval_data, net_cfg, mesh)
    sub = {k: v[:13] for k, v in eval_data.items()}
    res["eval_chunked"] = pm.eval_dataset_sharded(params, sub, net_cfg,
                                                  mesh, batch_size=1)
    tparams = params_to_torch(params, mesh.device)
    res["predict"] = tp.predict_batched(
        tp.make_predict_fn(net_cfg), tparams, eval_data["images"][:13],
        batch_size=4, mesh=mesh)
    res["score"] = tp.score_whdr_per_image(
        res["predict"]["reflectance"][:11], eval_data["comparisons"][:11],
        mesh=mesh)
    for name, cfg_kw, init, images, comps, draw_seed, solver in steps:
        p = tloop.trainable(init, mesh.device)
        cfg = NetworkConfig(**cfg_kw)
        step = pm.make_sharded_train_step(
            cfg, tloop.LossConfig(), p, tloop.make_optimizer(solver, 1e-3, p),
            mesh)
        gen = (None if draw_seed is None
               else torch.Generator(mesh.device).manual_seed(draw_seed))
        metrics = step(pm.shard_batch(images, mesh),
                       pm.shard_batch(comps, mesh), gen)
        res["step_" + name] = (
            {k: float(v) for k, v in metrics.items()},
            [t.detach().cpu().numpy() for t in tloop.param_leaves(p)])
    res["filters"] = _filters(x, mesh)
    # each rank's own slice of a global batch, and a ragged one
    n = eval_data["images"].shape[0] // mesh.size
    mine = eval_data["images"][mesh.rank * n:(mesh.rank + 1) * n]
    res["multihost_equal"] = torch.equal(
        pm.shard_batch_multihost(mine, mesh),
        pm.shard_batch(eval_data["images"], mesh))
    try:
        pm.shard_batch_multihost(mine[:1 + (mesh.rank == 0)], mesh)
        res["ragged_raised"] = False
    except ValueError:
        res["ragged_raised"] = True
    # rank 0's values on every rank
    res["replicated"] = pm.replicate(
        {"a": {"b": np.full(3, mesh.rank, np.float32)}}, mesh)[
            "a"]["b"].tolist()
    return res


@pytest.fixture(scope="module")
def inputs():
    import jax
    from reflectance_filtering_tpu.models.networks import (
        NetworkConfig as JConfig, init_network as j_init)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
    params = np_tree(j_init(jax.random.PRNGKey(0), JConfig(**CFG)))
    steps = []
    for i, (name, cfg_kw, k, draw_seed, solver) in enumerate(STEPS):
        images, comps = _step_inputs(7 + i, k)
        init = np_tree(j_init(jax.random.PRNGKey(0), JConfig(**cfg_kw)))
        steps.append((name, cfg_kw, init, images, comps, draw_seed, solver))
    images, comps = _step_inputs(0, 10)
    return {"params": params, "steps": steps,
            "eval": {"images": images, "comparisons": comps},
            "filters": _filter_inputs()}


def _rank_worlds(mesh, *args):
    """Each world of WORLDS on one spawn of max(WORLDS) ranks: the smaller
    ones over a subgroup of the first ranks (a mesh over a group)."""
    import torch.distributed as dist
    out = {}
    for n in WORLDS:
        if n == mesh.size:
            out[n] = _rank_cases(mesh, *args)
            continue
        group = dist.new_group(list(range(n)))   # every rank takes part
        if mesh.rank < n:
            out[n] = _rank_cases(pm.make_mesh("cpu", group), *args)
    return out


@pytest.fixture(scope="module")
def spawned_worlds(inputs):
    return dryrun.spawn(max(WORLDS), _rank_worlds, inputs["params"],
                        inputs["steps"], inputs["eval"], inputs["filters"])


@pytest.fixture(params=WORLDS, ids=lambda n: "world{}".format(n))
def spawned(request, spawned_worlds):
    n = request.param
    return n, [r[n] for r in spawned_worlds[:n]]


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process results (CPU, plain versions)."""
    mesh = pm.make_mesh("cpu")
    x = inputs["filters"]
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa
    r, eps, iters = CHAIN
    from reflectance_filtering_tpu_torch.ops.bilateral_joint_kernel import (
        bilateral_color_self_batched, bilateral_packed_joint_batched,
        joint_bilateral_filter_fast)
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self)
    from reflectance_filtering_tpu_torch.ops.box_kernel import (
        box_filter_planar)
    from reflectance_filtering_tpu_torch.ops.guided import (
        guided_filter, guided_filter_iterated)

    def planar(a):
        return t(a).permute(2, 0, 1)[None].float().contiguous()

    filters = {
        "box": box_filter_planar(planar(x["box"])[0], 3,
                                 "reflect101").permute(1, 2, 0),
        "joint": joint_bilateral_filter_fast(x["joint"], x["src"], -1, 20.0,
                                             2.0),
        "joint_u8": bilateral_packed_joint_batched(
            planar(x["joint_u8"]), planar(x["src_u8"]), -1, 20.0,
            2.0)[0].permute(1, 2, 0),
        "gray_self": bilateral_gray_self(t(x["gray"])[None], -1, 20.0, 2.0,
                                         reps=3)[0],
        "color_self": bilateral_color_self_batched(
            planar(x["color"]), -1, 20.0, 2.0)[0].permute(1, 2, 0),
        "guided": guided_filter(t(x["guide"]), t(x["gsrc"]), 3, 9.0),
        "guided_gray": guided_filter(t(x["guide"][..., 0]), t(x["gsrc"]), 3,
                                     9.0),
        "chain": guided_filter_iterated(
            planar(x["chain_guide"]), t(x["chain_src"])[None, None], r, eps,
            iters, planar=True)[0, 0],
    }
    steps = {}
    for name, cfg_kw, init, images, comps, draw_seed, solver in \
            inputs["steps"]:
        p = tloop.trainable(init, "cpu")
        cfg = NetworkConfig(**cfg_kw)
        step = tloop.make_train_step(cfg, tloop.LossConfig(), p,
                                     tloop.make_optimizer(solver, 1e-3, p))
        gen = (None if draw_seed is None
               else torch.Generator().manual_seed(draw_seed))
        metrics = step(t(images), t(comps), gen)
        steps[name] = ({k: float(v) for k, v in metrics.items()},
                       [a.detach().numpy() for a in tloop.param_leaves(p)])
    net_cfg = NetworkConfig(**CFG)
    ev = inputs["eval"]
    pred = tp.predict_batched(tp.make_predict_fn(net_cfg),
                              params_to_torch(inputs["params"]),
                              ev["images"][:13], batch_size=4, device="cpu")
    return {"mesh": mesh, "steps": steps, "predict": pred,
            "score": tp.score_whdr_per_image(pred["reflectance"][:11],
                                             ev["comparisons"][:11],
                                             device="cpu"),
            "filters": {k: v.numpy() for k, v in filters.items()}}


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """The JAX package's train steps (make_train_step, one device, on the
    global batch) and its sharded filters on a mesh of 4 CPU devices (JAX
    compiles for each mesh, so one size; tests/test_parallel.py holds them
    against its single-device filters)."""
    import jax
    import jax.numpy as jnp
    from reflectance_filtering_tpu.models.networks import (
        NetworkConfig as JConfig)
    from reflectance_filtering_tpu.parallel import mesh as jm
    from reflectance_filtering_tpu.parallel import spatial as js
    from reflectance_filtering_tpu.train import loop as jloop
    x = {k: jnp.asarray(v) for k, v in inputs["filters"].items()}
    r, eps, iters = CHAIN
    mesh = jm.make_mesh(JAX_WORLD)
    filters = {
        "box": js.sharded_box_filter(x["box"], 3, mesh),
        "joint": js.sharded_joint_bilateral(x["joint"], x["src"], mesh,
                                            sigma_color=20.0,
                                            sigma_space=2.0),
        "gray_self": js.sharded_bilateral_gray_self(
            x["gray"].astype(jnp.float32), mesh, sigma_color=20.0,
            sigma_space=2.0, reps=3, impl="xla"),
        "color_self": js.sharded_bilateral_color_self(
            x["color"].astype(jnp.float32), mesh, sigma_color=20.0,
            sigma_space=2.0, impl="xla"),
        "guided": js.sharded_guided_filter(x["guide"], x["gsrc"], 3, 9.0,
                                           mesh),
        "chain": js.sharded_guided_filter_iterated(
            x["chain_guide"], x["chain_src"], r, eps, iters, mesh),
    }
    steps = {}
    for name, cfg_kw, init, images, comps, draw_seed, solver in \
            inputs["steps"]:
        if draw_seed is not None:
            continue        # jax.random draws other numbers than torch
        params = jax.tree_util.tree_map(jnp.asarray, init)
        opt = jloop.make_optimizer(solver, 1e-3)
        step = jloop.make_train_step(JConfig(**cfg_kw), jloop.LossConfig(),
                                     opt)
        p2, _, m2 = step(params, opt.init(params), jnp.asarray(images),
                         jnp.asarray(comps), jax.random.PRNGKey(7))
        steps[name] = (float(m2["loss_whdr_hinge"]), [
            np.asarray(p2[layer][part]) for layer in sorted(p2)
            for part in sorted(p2[layer])])
    return {"filters": {k: np.asarray(v) for k, v in filters.items()},
            "steps": steps}


def test_sharded_eval_matches_single_and_jax(spawned, inputs):
    """Sharded eval == the JAX package's make_predict_fn + whdr per image
    (test_parallel.py:57-71), on every rank."""
    import jax.numpy as jnp
    from reflectance_filtering_tpu.losses.whdr import whdr
    from reflectance_filtering_tpu.models.networks import (
        NetworkConfig as JConfig)
    from reflectance_filtering_tpu.train.predict import make_predict_fn
    _, results = spawned
    ev = inputs["eval"]
    res = make_predict_fn(JConfig(**CFG))(inputs["params"],
                                          jnp.asarray(ev["images"]))
    refl = np.asarray(res["reflectance"])
    expected = [float(whdr(jnp.asarray(refl[b]),
                           jnp.asarray(ev["comparisons"][b])))
                for b in range(len(refl))]
    for r in results:
        mean_s, per_image = r["eval"]
        np.testing.assert_allclose(per_image, expected, atol=1e-6)
        assert abs(mean_s - np.mean(expected)) < 1e-6


def test_sharded_eval_chunked_matches_whole(spawned):
    """batch_size=1 chunks of mesh-size images, the ragged last chunk
    padded and masked (test_parallel.py:329)."""
    _, results = spawned
    for r in results:
        mean_w, per_w = r["eval"]
        mean_c, per_c = r["eval_chunked"]
        np.testing.assert_allclose(per_c, per_w[:13], atol=1e-6)
        assert abs(mean_c - np.mean(per_w[:13])) < 1e-6


def test_predict_and_score_sharded_match_single(spawned, single):
    _, results = spawned
    for r in results:
        for k, v in single["predict"].items():
            np.testing.assert_allclose(r["predict"][k], v, atol=1e-6)
        np.testing.assert_allclose(r["score"], single["score"], atol=1e-6)


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_sharded_train_step_matches_single_and_jax(spawned, single,
                                                   jax_refs, name):
    """One optimizer step on the global batch: every rank's params identical,
    within rtol 1e-5 / atol 1e-7 of the single-process step and of the JAX
    package's sharded step (not for the capped draw: jax.random draws
    other numbers), the hinge within 1e-6 (test_parallel.py:74-99)."""
    n, results = spawned
    metrics, params = results[0]["step_" + name]
    for r in results[1:]:
        for a, b in zip(r["step_" + name][1], params):
            np.testing.assert_array_equal(a, b)
        assert r["step_" + name][0] == metrics
    s_metrics, s_params = single["steps"][name]
    for a, b in zip(params, s_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert abs(metrics["loss_whdr_hinge"]
               - s_metrics["loss_whdr_hinge"]) < 1e-6
    if name in jax_refs["steps"]:
        j_hinge, j_params = jax_refs["steps"][name]
        for a, b in zip(params, j_params):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        assert abs(metrics["loss_whdr_hinge"] - j_hinge) < 1e-6


def test_capped_draw_takes_the_global_mask(inputs):
    """Above 1,500 comparisons each rank draws the whole batch's mask and
    takes its rows: the single-process mask, row for row."""
    from reflectance_filtering_tpu_torch.losses.whdr import (
        _eval_selection_mask)
    _, _, _, images, comps, seed, _ = inputs["steps"][-1]
    k = comps.shape[1] - 1
    num = torch.full((16,), k, dtype=torch.int32)
    valid = torch.ones((16, k), dtype=torch.bool)
    whole = _eval_selection_mask(valid, num, 1.0, True,
                                 torch.Generator().manual_seed(seed), k)
    assert int(whole[0].sum()) == 1500
    for rank in range(4):
        part = _eval_selection_mask(
            valid[4 * rank:4 * rank + 4], num[4 * rank:4 * rank + 4], 1.0,
            True, torch.Generator().manual_seed(seed), k, (4 * rank, 16))
        assert torch.equal(part, whole[4 * rank:4 * rank + 4])


# (filter, rtol, atol) against the port's single-device filter and JAX's
# sharded one; the self-guided bilateral against JAX's exp form: 0.05
FILTER_GATES = [("box", 1e-5, 1e-3), ("joint", 1e-4, 1e-3),
                ("joint_u8", 1e-4, 1e-3), ("gray_self", 1e-4, 0.05),
                ("color_self", 1e-4, 0.05), ("guided", 1e-4, 5e-3),
                ("guided_gray", 1e-4, 5e-3), ("chain", 1e-4, 0.05)]


def _chain_gate(got, exp):
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=0.05)
    d = np.abs(np.rint(np.clip(got, 0, 255)) - np.rint(np.clip(exp, 0, 255)))
    assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("name,rtol,atol", FILTER_GATES,
                         ids=[g[0] for g in FILTER_GATES])
def test_sharded_filter_matches_single_and_jax(spawned, single, jax_refs,
                                               name, rtol, atol):
    n, results = spawned
    got = results[0]["filters"][name]
    for r in results[1:]:
        np.testing.assert_array_equal(r["filters"][name], got)
    refs = [single["filters"][name]]
    if n == JAX_WORLD and name in jax_refs["filters"]:
        refs.append(jax_refs["filters"][name])
    for exp in refs:
        assert got.shape == exp.shape
        if name == "chain":
            _chain_gate(got, exp)
        else:
            np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol)


def test_multihost_slices_and_replicate(spawned):
    """shard_batch_multihost of each rank's own slice equals shard_batch of
    the global batch, and ragged slices raise on every rank; replicate
    gives every rank rank 0's values."""
    _, results = spawned
    for r in results:
        assert r["multihost_equal"] and r["ragged_raised"]
        assert r["replicated"] == [0.0, 0.0, 0.0]


def test_narrow_shards_and_widths_raise():
    """Every wrapper rejects too-narrow shards and non-dividing widths
    before any communication (test_parallel.py:264, :312)."""
    mesh = pm.Mesh(None, 0, 8, torch.device("cpu"))
    img = torch.zeros((16, 8 * 16, 3))              # 16 columns a shard
    with pytest.raises(ValueError, match="too narrow"):
        # radius 33 at the product sigmas >> 16-column shards
        ps.sharded_joint_bilateral(img, img, mesh, -1, 20.0, 22.0)
    with pytest.raises(ValueError, match="too narrow"):
        ps.sharded_bilateral_gray_self(img[..., 0], mesh)
    with pytest.raises(ValueError, match="too narrow"):
        ps.sharded_box_filter(img, 20, mesh)
    with pytest.raises(ValueError, match="too narrow"):
        ps.sharded_box_filter(img, 16, mesh)        # reflect101: r + 1
    with pytest.raises(ValueError, match="too narrow"):
        ps.sharded_guided_filter(img, img[..., 0], 9, 3.0, mesh)
    with pytest.raises(ValueError, match="divisible"):
        ps.sharded_box_filter(torch.zeros((16, 100, 3)), 2, mesh)
    with pytest.raises(ValueError, match="too narrow"):
        # 32 columns a shard < 3 * 2 * 45
        ps.sharded_guided_filter_iterated(torch.zeros((16, 256, 3)),
                                          torch.zeros((16, 256)), 45, 3.0, 3,
                                          mesh)
    with pytest.raises(ValueError, match="halo"):
        ps.sharded_apply_overlap(lambda b: b, -1, mesh)
    with pytest.raises(ValueError, match="mesh size"):
        pm.shard_batch(np.zeros((6, 2)), pm.Mesh(None, 0, 4,
                                                 torch.device("cpu")))


def test_pad_to_multiple_and_masked_mean():
    x = np.arange(10)[:, None]
    p, n = pm.pad_to_multiple(x, 8)
    assert p.shape[0] == 16 and n == 10
    np.testing.assert_array_equal(p[10:], np.repeat(x[-1:], 6, axis=0))
    # the eval mean counts the valid rows only, whatever the pad rows hold
    mesh = pm.make_mesh("cpu")
    cfg = NetworkConfig(**CFG)
    images, comps = _step_inputs(3, 10, n=5)
    from reflectance_filtering_tpu_torch.models.networks import init_network
    params = init_network(cfg, torch.Generator().manual_seed(0))
    eval_fn = pm.make_sharded_eval(cfg, mesh)
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    mean, per_image = eval_fn(params, torch.from_numpy(images),
                              torch.from_numpy(comps), valid)
    assert per_image.shape == (5,)
    assert abs(float(mean) - float(per_image[:3].mean())) < 1e-7
    assert pm.shard_batch(np.arange(6), mesh).tolist() == list(range(6))


def test_mesh_of_one_outside_a_group():
    mesh = pm.make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == torch.device("cpu")
    t = torch.arange(3.0)
    assert mesh.gather(t) is t and mesh.all_reduce_(t) is t
    params = {"conv0": {"kernel": np.ones((1, 1, 3, 2), np.float32)}}
    rep = pm.replicate(params, mesh)
    assert torch.equal(rep["conv0"]["kernel"], torch.ones((1, 1, 3, 2)))


def test_dryrun_multichip():
    errs = dryrun.dryrun_multichip(2)
    assert sorted(errs) == ["chain", "gray_self_bilateral", "guided",
                            "joint_bilateral", "train_step_hinge",
                            "train_step_params"]
    assert errs["gray_self_bilateral"] == 0.0
    assert errs["train_step_params"] <= 1e-6
    assert errs["train_step_hinge"] <= 1e-6
    for name in ("joint_bilateral", "guided", "chain"):
        assert errs[name] <= 0.05, (name, errs[name])


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1"):
        dryrun.spawn(2, _fail_on_rank_one)


def _fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank
