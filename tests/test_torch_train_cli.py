"""The port's train CLI (reflectance_filtering_tpu_torch.cli.train) on the
CPU, over a 32x32 synthetic dataset built by the JAX package's
data/builder.py: the experiment lifecycle of tests/test_train_cli.py, and
the port's CLI against the JAX package's CLI from the same warm start
(validation WHDR within 0.001, final params within 1e-5)."""
import json
import os

import numpy as np
import pytest

import jax

from reflectance_filtering_tpu.cli.train import main as j_main
from reflectance_filtering_tpu.data import builder as B
from reflectance_filtering_tpu.models.networks import (
    NetworkConfig as JConfig, init_network as j_init)
from reflectance_filtering_tpu.train.checkpoint import (
    save_checkpoint as j_save)
from reflectance_filtering_tpu_torch.cli.train import main
from reflectance_filtering_tpu_torch.train.checkpoint import load_checkpoint

FLAGS = ["--networkType=convStaticSkipLayers", "--numLayers=2",
         "--num_filters_log=3", "--kernel_pad=0", "--RS_est_mode=rDirectly",
         "--height=32", "--width=32", "--random_seed=0"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import cv2
    raw = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(5)
    for fid in range(100, 120):
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(raw / "{}.png".format(fid)), img)
        points = [{"id": i, "x": float(rng.rand()), "y": float(rng.rand()),
                   "opaque": True} for i in range(6)]
        comps = []
        for _ in range(6):
            a, b = rng.choice(6, 2, replace=False)
            comps.append({"point1": int(a), "point2": int(b),
                          "darker": str(rng.choice(["1", "2", "E"])),
                          "darker_score": float(rng.rand())})
        with open(str(raw / "{}.json".format(fid)), "w") as f:
            json.dump({"intrinsic_points": points,
                       "intrinsic_comparisons": comps}, f)
    lmdbs = tmp_path_factory.mktemp("lmdbs")
    (lmdbs / "iiw").mkdir()
    names = B.sorted_file_list(str(raw))
    train, val, test = B.narihira_split_three(names)
    for split, stem in ((train, "trainValTest_train"),
                        (val, "trainValTest_val"),
                        (test, "trainValTest_test")):
        B.build_dataset(str(raw), split, str(lmdbs / "iiw" / stem),
                        height=32, width=32, verbose=False)
    return str(lmdbs)


def _run(dataset, root, exp, *extra, device="cpu"):
    main(["--experiment=" + exp, "--data_root", dataset, "--results_root",
          root, "--device", device] + FLAGS + list(extra))
    return os.path.join(root, exp)


def test_fit_lifecycle(dataset, tmp_path, capsys):
    exp = _run(dataset, str(tmp_path), "t1", "--stage=fit",
               "--iterations=16", "--batch_size=4",
               "--checkpoint_interval=8")
    snaps = os.listdir(os.path.join(exp, "snapshots"))
    assert any("_barrista_iter_8.npz" in s for s in snaps)
    assert any("_barrista_iter_16.npz" in s for s in snaps)
    progs = os.listdir(os.path.join(exp, "progressions"))
    assert len(progs) == 1
    with open(os.path.join(exp, "progressions", progs[0])) as f:
        data = json.load(f)
    assert [e["NumIters"] for e in data["test"]] == [8, 16]
    assert os.listdir(os.path.join(exp, "scores"))
    assert os.listdir(os.path.join(exp, "framerates"))
    logs = os.listdir(os.path.join(exp, "logs"))
    assert len(logs) == 1
    with open(os.path.join(exp, "logs", logs[0])) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 4  # 16 samples / batch 4
    assert "loss_whdr_hinge" in lines[0] and "val_whdr" in lines[2]
    nets = os.listdir(os.path.join(exp, "networks"))
    assert any(f.endswith(".json") for f in nets)
    assert [f[:-4] for f in nets if f.endswith(".png")] == [
        f[:-5] for f in nets if f.endswith(".json")]     # the graph PNG
    assert any(i.startswith("filters_iter_")
               for i in os.listdir(os.path.join(exp, "images")))
    out = capsys.readouterr()
    assert "network graph rendering failed" not in out.err
    assert "Validation WHDR at iteration 8" in out.out


def test_cli_matches_jax_cli_from_the_same_warm_start(dataset, tmp_path):
    """Both CLIs start from one .npz (the JAX package's init, written by its
    save_checkpoint) and train 24 samples: the validation WHDR of every
    snapshot within 0.001, the final params within 1e-5."""
    params = j_init(jax.random.PRNGKey(3), JConfig(
        network_type="convStaticSkipLayers", num_layers=2, num_filters_log=3,
        kernel_pad=0))
    warm = str(tmp_path / "warm.npz")
    j_save(warm, params)
    args = ["--stage=fit", "--iterations=24", "--batch_size=4",
            "--checkpoint_interval=8", "--predictCaffemodel", warm,
            "--base_lr=0.01"]
    ours = _run(dataset, str(tmp_path / "t"), "w", *args)
    j_main(["--experiment=w", "--data_root", dataset, "--results_root",
            str(tmp_path / "j")] + FLAGS + args)
    theirs = os.path.join(str(tmp_path / "j"), "w")
    progs = []
    for exp in (ours, theirs):
        name = os.listdir(os.path.join(exp, "progressions"))[0]
        with open(os.path.join(exp, "progressions", name)) as f:
            progs.append(json.load(f)["test"])
    assert [e["NumIters"] for e in progs[0]] == [8, 16, 24]
    assert [e["NumIters"] for e in progs[1]] == [8, 16, 24]
    for a, b in zip(*progs):
        assert abs(a["WHDR"] - b["WHDR"]) / 100.0 <= 1e-3
    snap = [s for s in os.listdir(os.path.join(ours, "snapshots"))
            if s.endswith("_24.npz")][0]
    pa, oa, _ = load_checkpoint(os.path.join(ours, "snapshots", snap))
    pb, ob, _ = load_checkpoint(os.path.join(theirs, "snapshots", snap))
    for layer in pb:
        for part in pb[layer]:
            np.testing.assert_allclose(pa[layer][part], pb[layer][part],
                                       rtol=0, atol=1e-5)
    assert oa["count"] == ob["count"] == 6


def test_cli_default_network_flags_match_jax_cli(dataset, tmp_path):
    """The CLI's default network (convStaticWithSigmoid, 2 layers of 16
    3x3 filters, rRelMax: no network flag given) against the JAX CLI from
    one warm start, at the default learning rate (Adam's steps are about
    lr in size whatever the gradient, so a gradient near zero moves a
    parameter by a sign of rounding noise): the validation WHDR of every
    snapshot within 0.001, the final params within 1e-5."""
    params = j_init(jax.random.PRNGKey(4), JConfig(
        network_type="convStaticWithSigmoid", num_layers=2,
        num_filters_log=4, kernel_pad=1, rs_est_mode="rRelMax"))
    warm = str(tmp_path / "warm.npz")
    j_save(warm, params)
    flags = ["--height=32", "--width=32", "--random_seed=0", "--stage=fit",
             "--iterations=16", "--batch_size=4", "--checkpoint_interval=8",
             "--predictCaffemodel", warm]
    main(["--experiment=d", "--data_root", dataset, "--results_root",
          str(tmp_path / "t"), "--device", "cpu"] + flags)
    j_main(["--experiment=d", "--data_root", dataset, "--results_root",
            str(tmp_path / "j")] + flags)
    exps = [os.path.join(str(tmp_path / side), "d") for side in ("t", "j")]
    progs, finals = [], []
    for exp in exps:
        name = os.listdir(os.path.join(exp, "progressions"))[0]
        assert name.startswith("barrista_convStaticWithSigmoid_n2_f16_k3")
        with open(os.path.join(exp, "progressions", name)) as f:
            progs.append(json.load(f)["test"])
        snap = [s for s in os.listdir(os.path.join(exp, "snapshots"))
                if s.endswith("_16.npz")][0]
        finals.append(load_checkpoint(os.path.join(exp, "snapshots",
                                                   snap))[0])
    assert [e["NumIters"] for e in progs[0]] == [8, 16]
    assert [e["NumIters"] for e in progs[1]] == [8, 16]
    for a, b in zip(*progs):
        assert abs(a["WHDR"] - b["WHDR"]) / 100.0 <= 1e-3
    for layer in finals[1]:
        for part in finals[1][layer]:
            np.testing.assert_allclose(finals[0][layer][part],
                                       finals[1][layer][part], rtol=0,
                                       atol=1e-5)


def test_resume_matches_uninterrupted(dataset, tmp_path):
    common = ["--batch_size=4", "--checkpoint_interval=8"]
    full = _run(dataset, str(tmp_path / "a"), "full", "--stage=fit",
                "--iterations=16", *common)
    root_b = str(tmp_path / "b")
    _run(dataset, root_b, "res", "--stage=fit", "--iterations=8", *common)
    res = _run(dataset, root_b, "res", "--stage=fit", "--iterations=16",
               "--startOver=0", *common)

    def final(exp):
        snapdir = os.path.join(exp, "snapshots")
        snap = [s for s in os.listdir(snapdir) if s.endswith("_16.npz")][0]
        return load_checkpoint(os.path.join(snapdir, snap))[0]

    pa, pb = final(full), final(res)
    for layer in pa:
        for part in pa[layer]:
            np.testing.assert_allclose(pa[layer][part], pb[layer][part],
                                       rtol=0, atol=1e-6)


def test_resume_skips_when_complete_and_predict_scores(dataset, tmp_path,
                                                       capsys):
    root = str(tmp_path / "r")
    common = ["--batch_size=4", "--checkpoint_interval=8"]
    exp = _run(dataset, root, "done", "--stage=fit", "--iterations=8",
               *common)
    _run(dataset, root, "done", "--stage=fit", "--iterations=8",
         "--startOver=0", *common)
    assert "skipping training" in capsys.readouterr().out
    snap = [s for s in os.listdir(os.path.join(exp, "snapshots"))
            if s.endswith("_8.npz")][0]
    # predict with no size flags: the sizes come from the checkpoint name
    main(["--stage=predict", "--predictCaffemodel",
          os.path.join(exp, "snapshots", snap), "--experiment=pred",
          "--data_root", dataset, "--results_root", root, "--device", "cpu"])
    scores = os.listdir(os.path.join(root, "pred", "scores"))
    assert any(snap.replace(".npz", "") in s for s in scores)


def test_checkpoint_interval_rounds_to_batch_multiple(dataset, tmp_path):
    exp = _run(dataset, str(tmp_path), "ck", "--stage=fit", "--iterations=8",
               "--batch_size=4", "--checkpoint_interval=6")
    snaps = os.listdir(os.path.join(exp, "snapshots"))
    assert sorted(int(s.rsplit("_", 1)[1].split(".")[0])
                  for s in snaps) == [4, 8]


@pytest.mark.parametrize("extra,error,match", [
    (["--stage=fit", "--iterations=2", "--batch_size=4"], ValueError,
     "batch_size"),
    (["--stage=predict"], ValueError, "predictCaffemodel"),
    (["--stage=fit", "--iterations=8", "--batch_size=4", "--dataset=sintel"],
     NotImplementedError, "albedo"),
    (["--stage=predict", "--decompose=."], ValueError, "predictCaffemodel"),
    (["--stage=deploy", "--iterations=8"], ValueError, "not implemented")])
def test_cli_refuses_loudly(dataset, tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        _run(dataset, str(tmp_path), "bad", *extra)


def test_cli_fits_unet(dataset, tmp_path):
    """--networkType=uNet trains and scores (the flags after FLAGS win)."""
    exp = _run(dataset, str(tmp_path), "unet", "--stage=fit",
               "--iterations=8", "--batch_size=4", "--checkpoint_interval=4",
               "--networkType=uNet", "--numLayers=1", "--kernel_pad=1",
               "--RS_est_mode=rRelMax")
    snaps = sorted(os.listdir(os.path.join(exp, "snapshots")))
    assert len(snaps) == 2 and all(s.startswith("uNet_") for s in snaps)
    params = load_checkpoint(os.path.join(exp, "snapshots", snaps[-1]))[0]
    assert "Conv5" in params and "up1" in params
    with open(os.path.join(exp, "progressions", os.listdir(
            os.path.join(exp, "progressions"))[0])) as f:
        scores = [e["WHDR"] for e in json.load(f)["test"]]
    assert len(scores) == 2 and all(0 <= s < 100 for s in scores)


def test_cuda_without_gpu_asks_for_cpu(dataset, tmp_path, capsys,
                                       monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        _run(dataset, str(tmp_path), "gpu", "--stage=fit", "--iterations=8",
             device="cuda")
    assert "--device cpu" in capsys.readouterr().err
