"""The port's train CLI in its decompose and profiling modes, on the CPU:
``--stage=predict --decompose`` from a checkpoint with no dataset on disk,
against the JAX package's CLI on the same checkpoint and files (every PNG
within 1 uint8 level, the npz arrays within 1e-5, the same movie files, the
``0command.txt`` audit log in both decomposition folders); ``--profile_dir``
writing a trace of the fit stage; ``utils.profiling``'s span, trace and
rate file (the reference's framerates/*.txt contract)."""
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
from reflectance_filtering_tpu_torch.utils import profiling

FLAGS = ["--networkType=convStaticSkipLayers", "--numLayers=2",
         "--num_filters_log=3", "--kernel_pad=0", "--RS_est_mode=rRelMax"]
SUBS = ("decompositions_linear", "decompositions_sRGB")


def _inputs(folder, seed=0):
    """Three PNGs in two sizes, an npz stack, a short mp4 and a file of an
    unknown type."""
    import cv2
    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate([(24, 32), (24, 32), (17, 23)]):
        cv2.imwrite(os.path.join(folder, "photo{}.png".format(i)),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
    np.savez(os.path.join(folder, "stack.npz"),
             images=(rng.rand(2, 12, 16, 3) * 255).astype(np.uint8))
    wr = cv2.VideoWriter(os.path.join(folder, "clip.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (32, 24),
                         True)
    assert wr.isOpened()
    for _ in range(4):
        wr.write((rng.rand(24, 32, 3) * 255).astype(np.uint8))
    wr.release()
    with open(os.path.join(folder, "notes.xyz"), "w") as f:
        f.write("not an image")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params = j_init(jax.random.PRNGKey(4), JConfig(
        network_type="convStaticSkipLayers", num_layers=2, num_filters_log=3,
        kernel_pad=0, rs_est_mode="rRelMax"))
    path = str(tmp_path_factory.mktemp("ckpt") / "warm.npz")
    j_save(path, params)
    return path


def test_decompose_without_dataset_matches_jax_cli(checkpoint, tmp_path,
                                                   capsys):
    import cv2
    runs = {}
    for who, entry in (("port", main), ("jax", j_main)):
        folder = str(tmp_path / who / "in")
        _inputs(folder)
        argv = ["--stage=predict", "--predictCaffemodel", checkpoint,
                "--decompose", folder, "--experiment=dec", "--data_root",
                str(tmp_path / "no_dataset"), "--results_root",
                str(tmp_path / who / "res")] + FLAGS
        entry(argv + (["--device", "cpu"] if who == "port" else []))
        runs[who] = (folder, os.path.join(str(tmp_path / who / "res"),
                                          "dec"), argv)
    assert not os.path.exists(str(tmp_path / "no_dataset"))
    out = capsys.readouterr().out
    assert "notes.xyz neither recognized" in out.replace("\n", "")

    (p_in, p_res, p_argv), (j_in, j_res, _) = runs["port"], runs["jax"]
    for sub in SUBS:
        with open(os.path.join(p_res, sub, "0command.txt")) as f:
            assert f.read() == " ".join(p_argv + ["--device", "cpu"]) + " \n"
        names = sorted(os.listdir(os.path.join(p_res, sub)))
        assert names == sorted(os.listdir(os.path.join(j_res, sub)))
        for name in names:
            if name.endswith(".png"):
                a = cv2.imread(os.path.join(p_res, sub, name)).astype(int)
                b = cv2.imread(os.path.join(j_res, sub, name))
                assert np.abs(a - b).max() <= 1, (sub, name)
    pngs = [n for n in os.listdir(os.path.join(p_res, SUBS[0]))
            if n.endswith(".png")]
    assert len(pngs) == 9                      # 3 photos x -r, -s, -RS_est
    movies = [n for n in os.listdir(os.path.join(p_res, SUBS[1]))
              if n.endswith(".mp4")]
    assert len(movies) == 5
    with np.load(os.path.join(p_in, "stack_decomposed.npz")) as g, \
            np.load(os.path.join(j_in, "stack_decomposed.npz")) as w:
        assert sorted(g.files) == sorted(w.files) and len(g.files) == 7
        for key in g.files:
            assert np.abs(g[key].astype(np.float64) - w[key]).max() <= 1e-5
    nets = os.listdir(os.path.join(p_res, "networks"))
    assert any(n.endswith(".png") for n in nets)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import cv2
    raw = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(6)
    for fid in range(200, 220):
        cv2.imwrite(str(raw / "{}.png".format(fid)),
                    (rng.rand(32, 32, 3) * 255).astype(np.uint8))
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
    train, val, test = B.narihira_split_three(B.sorted_file_list(str(raw)))
    for split, stem in ((train, "trainValTest_train"),
                        (val, "trainValTest_val"),
                        (test, "trainValTest_test")):
        B.build_dataset(str(raw), split, str(lmdbs / "iiw" / stem),
                        height=32, width=32, verbose=False)
    return str(lmdbs)


def test_fit_profile_dir_writes_a_trace(dataset, tmp_path):
    trace_dir = str(tmp_path / "trace")
    main(["--stage=fit", "--iterations=8", "--batch_size=4",
          "--checkpoint_interval=8", "--height=32", "--width=32",
          "--random_seed=0", "--experiment=prof", "--data_root", dataset,
          "--results_root", str(tmp_path), "--profile_dir", trace_dir,
          "--device", "cpu"] + FLAGS)
    traces = sorted(os.listdir(trace_dir))
    assert len(traces) == 2 and traces[1].startswith("trace_")
    assert traces[0] == "idle_" + traces[1][len("trace_"):]
    with open(os.path.join(trace_dir, traces[1])) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
    assert {"fit.dispatch", "fit.wait"} <= {
        e["name"] for e in events if e.get("cat") == "program_span"}
    assert os.listdir(os.path.join(str(tmp_path), "prof", "snapshots"))


def test_profiling_helpers(tmp_path):
    import torch
    with profiling.span("work") as s:
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert s.name == "work" and s.seconds >= 0.0 and x[0, 0] == 64
    with profiling.device_trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    _, name = sorted(os.listdir(str(tmp_path / "t")))
    with open(str(tmp_path / "t" / name)) as f:
        assert "traceEvents" in json.load(f)
    rate = str(tmp_path / "framerates" / "r.txt")
    profiling.write_rate_artifact(rate, 10, 4.0)
    with open(rate) as f:
        assert float(f.read()) == 2.5
