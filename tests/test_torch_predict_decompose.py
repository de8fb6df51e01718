"""The port's decompose family (reflectance_filtering_tpu_torch/train/
predict.py) against the JAX package's, on the CPU, from the same
parameters (the JAX init carried across with ``params_to_torch``) and the
same seeded photos, movies and npz stacks.

Tolerances: a written PNG within 1 uint8 level of the JAX function's (the
two forwards differ in float32 rounding, and a value on a .5 boundary of
img * 255 may round either way); an npz array within 1e-5 (the network
tests' float32 gate, tests/test_torch_networks.py); a movie by its files
and frame sizes (mp4v is lossy)."""
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

import jax

from reflectance_filtering_tpu.models import networks as jn
from reflectance_filtering_tpu.train import predict as jp
from reflectance_filtering_tpu.utils import image as jimage
from reflectance_filtering_tpu_torch.models import networks as tn
from reflectance_filtering_tpu_torch.train import predict as tp
from reflectance_filtering_tpu_torch.utils import image as timage

SUBS = ("decompositions_linear", "decompositions_sRGB")
SUFFIXES = ("-r", "-s", "-RS_est")
NPZ_KEYS = {"images", "R_back_to_sRGB", "S_back_to_sRGB", "r_back_to_sRGB",
            "R_from_input", "S_from_input", "r_from_input"}


def _cfg_kw(mode):
    return dict(network_type="convStaticSkipLayers", num_layers=2,
                num_filters_log=3, kernel_pad=0, rs_est_mode=mode)


def _net(mode, seed=0):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    kw = _cfg_kw(mode)
    jparams = jax.tree_util.tree_map(np.asarray, jn.init_network(
        jax.random.PRNGKey(seed), jn.NetworkConfig(**kw)))
    return (jn.NetworkConfig(**kw), jparams, tn.NetworkConfig(**kw),
            tn.params_to_torch(jparams))


def _photo(path, h, w, seed):
    import cv2
    rng = np.random.RandomState(seed)
    img = np.clip(rng.rand(h, w, 3) * 200 + 30, 0, 255).astype(np.uint8)
    cv2.imwrite(str(path), img)
    return str(path)


def _levels(dir_a, dir_b, stem):
    """Largest uint8 difference over the six PNGs of ``stem``."""
    import cv2
    worst = 0
    for sub in SUBS:
        for suffix in SUFFIXES:
            name = stem + suffix + ".png"
            a = cv2.imread(os.path.join(dir_a, sub, name))
            b = cv2.imread(os.path.join(dir_b, sub, name))
            assert a is not None and b is not None, (sub, name)
            assert a.shape == b.shape, (sub, name)
            worst = max(worst, int(np.abs(a.astype(int) - b).max()))
    return worst


def test_file_type_dispatch():
    names = ["a.PNG", "b.jpg", "c.tiff", "d.ppm", "e.mp4", "f.AVI",
             "g.npz", "h.xyz", "noext"]
    for fn in ("is_image", "is_movie", "is_numpy"):
        assert ([getattr(tp, fn)(n) for n in names]
                == [getattr(jp, fn)(n) for n in names]), fn


def test_rgb_uint8_to_linear_matches_jax():
    rgb = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    got = timage.rgb_uint8_to_linear(rgb)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jimage.rgb_uint8_to_linear(rgb))


@pytest.mark.parametrize("mode", ["rDirectly", "rRelMax"])
def test_single_image_six_outputs_match_jax(tmp_path, mode):
    jcfg, jparams, tcfg, tparams = _net(mode)
    photo = _photo(tmp_path / "photo.png", 40, 48, seed=1)
    tp.decompose_single_image_in_full_size(photo, tparams, tcfg,
                                           str(tmp_path / "port"),
                                           device="cpu")
    jp.decompose_single_image_in_full_size(photo, jparams, jcfg,
                                           str(tmp_path / "jax"))
    assert _levels(str(tmp_path / "port"), str(tmp_path / "jax"),
                   "photo") <= 1


def test_numpy_roundtrip_matches_jax(tmp_path):
    jcfg, jparams, tcfg, tparams = _net("rRelMax", seed=3)
    rng = np.random.RandomState(3)
    images = (rng.rand(3, 16, 20, 3) * 255).astype(np.uint8)
    paths = {}
    for who in ("port", "jax"):
        os.makedirs(str(tmp_path / who))
        paths[who] = str(tmp_path / who / "stack.npz")
        np.savez(paths[who], images=images)
    got = tp.decompose_numpy(paths["port"], tparams, tcfg, batch_size=2,
                             device="cpu")
    want = jp.decompose_numpy(paths["jax"], jparams, jcfg, batch_size=2)
    assert os.path.basename(got) == "stack_decomposed.npz"
    with np.load(got) as g, np.load(want) as w:
        assert set(g.files) == set(w.files) == NPZ_KEYS
        np.testing.assert_array_equal(g["images"], images)
        for key in NPZ_KEYS - {"images"}:
            assert g[key].shape == w[key].shape, key
            assert np.abs(g[key] - w[key]).max() <= 1e-5, key


def test_movie_roundtrip(tmp_path):
    """The five videos of decompose_movie, the triptych 3x as wide, each
    with every frame; the JAX function writes the same names."""
    import cv2
    jcfg, jparams, tcfg, tparams = _net("rDirectly", seed=4)
    rng = np.random.RandomState(4)
    movie = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(movie, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                         (32, 24), True)
    assert wr.isOpened()
    for _ in range(5):
        wr.write((rng.rand(24, 32, 3) * 255).astype(np.uint8))
    wr.release()
    out = tp.decompose_movie(movie, tparams, tcfg, str(tmp_path / "port"),
                             batch_size=2, device="cpu")
    jp.decompose_movie(movie, jparams, jcfg, str(tmp_path / "jax"),
                       batch_size=2)
    port_dir = str(tmp_path / "port" / "decompositions_sRGB")
    assert out == os.path.join(port_dir, "clip.mp4")
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(str(tmp_path / "jax" /
                                          "decompositions_sRGB")))
    assert names == sorted(["clip-combined.mp4", "clip-r.mp4", "clip-s.mp4",
                            "clip-baseline_rgbMean-combined.mp4",
                            "clip-baseline_rgbNorm-combined.mp4"])
    for name in names:
        cap = cv2.VideoCapture(os.path.join(port_dir, name))
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        assert width == (96 if "combined" in name else 32), name
        assert frames == 5, name


def test_batched_equals_single_and_jax(tmp_path):
    """Shape-grouped batches (two sizes, a ragged batch, a file nothing can
    read) write the per-image path's bytes, and within 1 level of the JAX
    batched path's."""
    jcfg, jparams, tcfg, tparams = _net("rRelMax", seed=5)
    paths = [_photo(tmp_path / "img{}.png".format(i), h, w, seed=10 + i)
             for i, (h, w) in enumerate([(24, 32), (24, 32), (24, 32),
                                         (16, 40)])]
    paths.append(str(tmp_path / "missing.png"))
    batched = str(tmp_path / "batched")
    done = tp.decompose_images_batched(paths, tparams, tcfg, batched,
                                       batch_size=2, device="cpu")
    assert sorted(done) == sorted(paths[:4])
    seconds = tp.decompose_images_batched.last_seconds
    assert set(seconds) == {"decode", "device", "write"}
    single = str(tmp_path / "single")
    for p in paths[:4]:
        tp.decompose_single_image_in_full_size(p, tparams, tcfg, single,
                                               device="cpu")
    jdir = str(tmp_path / "jax")
    jp.decompose_images_batched(paths, jparams, jcfg, jdir, batch_size=2)
    for i in range(4):
        stem = "img{}".format(i)
        assert _levels(batched, single, stem) == 0
        assert _levels(batched, jdir, stem) <= 1


def test_failing_file_and_chunk_are_contained(tmp_path, capsys):
    """A missing file, an unknown type and a chunk whose prediction fails
    are reported; the other group and the npz file are still written."""
    _, _, tcfg, tparams = _net("rDirectly", seed=6)
    ok = _photo(tmp_path / "ok.png", 16, 20, seed=6)
    boom = _photo(tmp_path / "boom.png", 24, 28, seed=7)
    npz = str(tmp_path / "blob.npz")
    np.savez(npz, images=(np.random.RandomState(6).rand(2, 12, 16, 3)
                          * 255).astype(np.float32))
    real = tp.make_predict_fn(tcfg)

    def exploding(params_, batch):
        if batch.shape[1] == 24:      # the boom.png group
            raise RuntimeError("synthetic predict failure")
        return real(params_, batch)

    res = tmp_path / "res"
    with mock.patch.object(tp, "make_predict_fn", lambda cfg_: exploding):
        tp.decompose_files([boom, ok, npz, str(tmp_path / "missing.png"),
                            str(tmp_path / "junk.xyz")], tparams, tcfg,
                           str(res), device="cpu")
    out = capsys.readouterr().out
    assert "was not possible" in out and "neither recognized" in out
    assert "missing.png" in out
    lin = os.listdir(str(res / "decompositions_linear"))
    assert any(f.startswith("ok-") for f in lin)
    assert not any(f.startswith("boom-") for f in lin)
    assert os.path.exists(str(tmp_path / "blob_decomposed.npz"))


def test_predict_runs_on_the_device_it_is_given(tmp_path):
    """The family's device argument reaches the tensors: on the CPU the
    batch the network sees lies on the CPU."""
    _, _, tcfg, tparams = _net("rDirectly", seed=8)
    photo = _photo(tmp_path / "p.png", 12, 16, seed=8)
    real = tp.make_predict_fn(tcfg)
    seen = []

    def spy(params_, batch):
        seen.append(batch.device)
        return real(params_, batch)

    tp.decompose_single_image_in_full_size(photo, tparams, tcfg,
                                           str(tmp_path), predict_fn=spy,
                                           device="cpu")
    assert seen == [torch.device("cpu")]
