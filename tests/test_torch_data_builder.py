"""The port's dataset builder (reflectance_filtering_tpu_torch/data/builder.py
and cli/build_dataset.py) against the JAX package's, on a synthetic
IIW-style folder (PNG + JSON judgments, written as tests/test_data.py
writes it): every .npz array bitwise equal in every mode (plain, augmented,
resized or not, one worker or several, the three splits and every CLI
mode), and the port's loader reads the result.  The augmentation helpers
(unify, consolidate, warshall, augment) equal the JAX package's exactly."""
import os

import numpy as np
import pytest
import torch

from reflectance_filtering_tpu.cli import build_dataset as j_cli
from reflectance_filtering_tpu.data import builder as JB
from reflectance_filtering_tpu_torch.cli import build_dataset as t_cli
from reflectance_filtering_tpu_torch.data import builder as TB
from reflectance_filtering_tpu_torch.data.loader import get_data
from tests.test_data import _random_relation_matrix, _write_iiw_file

KEYS = ("images", "comparisons", "augmented")


@pytest.fixture(scope="module")
def iiw_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("iiw"))
    rng = np.random.RandomState(11)
    for fid in range(100, 112):
        _write_iiw_file(d, str(fid), rng)
    # a judgment with a null and one with a non-positive confidence: both
    # builders drop them
    import json
    path = os.path.join(d, "100.json")
    with open(path) as f:
        data = json.load(f)
    data["intrinsic_comparisons"][0]["darker_score"] = None
    data["intrinsic_comparisons"][1]["darker_score"] = 0.0
    with open(path, "w") as f:
        json.dump(data, f)
    return d


def _assert_npz_equal(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(KEYS)
        for key in KEYS:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("height,width,augment,workers", [
    (16, 20, False, 1),       # resized, plain
    (32, 40, False, 1),       # the images' own size
    (16, 20, True, 1),        # augmented (the transitive closure)
    (24, 24, False, 3),       # a pool of workers
    (16, 20, True, 2),        # augmented on a pool: per-file seeds
])
def test_build_dataset_bitwise_equal_to_jax(iiw_dir, tmp_path, height,
                                            width, augment, workers):
    names = TB.sorted_file_list(iiw_dir)
    assert names == JB.sorted_file_list(iiw_dir)
    files = names[:5]
    kw = dict(height=height, width=width, augment_data=augment, seed=3,
              verbose=False, workers=workers)
    got = TB.build_dataset(iiw_dir, files, str(tmp_path / "t"), **kw)
    want = JB.build_dataset(iiw_dir, files, str(tmp_path / "j"), **kw)
    assert sorted(got) == sorted(want) == ["linear", "sRGB"]
    for variant in ("sRGB", "linear"):
        assert os.path.basename(got[variant])[1:] == \
            os.path.basename(want[variant])[1:]
        _assert_npz_equal(got[variant], want[variant])
    with np.load(got["sRGB"]) as npz:
        assert npz["images"].shape == (5, 3, height, width)
        assert npz["images"].min() >= TB.FLOOR
        assert npz["comparisons"].shape == (5, TB.MAX_NUM_COMPARISONS + 1,
                                            1, 6)
        assert npz["augmented"].shape == (
            (5, TB.MAX_NUM_AUGMENTED + 1, 1, 6) if augment else (5, 1, 1, 6))
        if augment:
            assert np.isfinite(npz["augmented"][:, :, 0, 4]).sum() > 0


def test_parallel_build_matches_sequential(iiw_dir, tmp_path):
    """A comparisons-only build consumes no random numbers, so any worker
    count gives the sequential build's bytes."""
    names = TB.sorted_file_list(iiw_dir)
    a = TB.build_dataset(iiw_dir, names, str(tmp_path / "seq"), 16, 20,
                         seed=3, verbose=False)
    b = TB.build_dataset(iiw_dir, names, str(tmp_path / "par"), 16, 20,
                         seed=3, verbose=False, workers=2)
    for variant in ("sRGB", "linear"):
        _assert_npz_equal(a[variant], b[variant])


@pytest.mark.parametrize("mode", ["one", "dummy", "trainTest",
                                  "trainValTest", "bigTrainMiniValTest",
                                  "all", "allShuffled"])
def test_cli_modes_bitwise_equal_to_jax(iiw_dir, tmp_path, mode):
    """Each of the seven modes through main(argv): the same files, each
    bitwise equal to the JAX CLI's."""
    argv = ["--data_folder", iiw_dir, "--mode", mode, "--height", "16",
            "--width", "16", "--seed", "1"]
    t_cli.main(argv + ["--save_to", str(tmp_path / "t")])
    j_cli.main(argv + ["--save_to", str(tmp_path / "j")])
    files = sorted(os.listdir(str(tmp_path / "t")))
    assert files == sorted(os.listdir(str(tmp_path / "j")))
    assert files and all(f.endswith(".npz") for f in files)
    for name in files:
        _assert_npz_equal(str(tmp_path / "t" / name),
                          str(tmp_path / "j" / name))


def test_cli_splits_and_loader(iiw_dir, tmp_path):
    """The three splits of trainValTest are the Narihira split of the sorted
    ids, each readable by the port's loader in the NHWC layout."""
    root = tmp_path / "lmdbs"
    t_cli.main(["--data_folder", iiw_dir, "--save_to", str(root / "iiw"),
                "--mode", "trainValTest", "--height", "16", "--width", "16",
                "--augment", "1"])
    names = TB.sorted_file_list(iiw_dir)
    splits = dict(zip(("train", "val", "test"),
                      TB.narihira_split_three(names)))
    assert splits == dict(zip(("train", "val", "test"),
                              JB.narihira_split_three(names)))
    for split, ids in splits.items():
        data = get_data("iiw", "trainValTest_{}_16_16_linear".format(split),
                        comparisons_type="augmented", root=str(root))
        assert data["images"].shape == (len(ids), 16, 16, 3)
        assert data["images"].dtype == np.float32
        assert data["comparisons"].shape == (len(ids),
                                             TB.MAX_NUM_COMPARISONS + 1, 6)
        assert data["augmented"].shape == (len(ids),
                                           TB.MAX_NUM_AUGMENTED + 1, 6)
        # the metadata rows carry the file ids
        np.testing.assert_array_equal(data["comparisons"][:, -1, 1],
                                      [float(i) for i in ids])


def test_cli_rejects_an_empty_folder(tmp_path):
    with pytest.raises(IOError):
        t_cli.main(["--data_folder", str(tmp_path), "--save_to",
                    str(tmp_path / "out")])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentation_helpers_match_jax(seed):
    """unify, consolidate, warshall and augment equal the JAX package's
    exactly on seeded inputs (the same RandomState for the pruning
    draws)."""
    rng = np.random.RandomState(seed)
    a = _random_relation_matrix(rng, n=7)
    np.testing.assert_array_equal(
        TB.warshall(a.copy(), rng=np.random.RandomState(99)),
        JB.warshall(a.copy(), rng=np.random.RandomState(99)))
    comps = [(int(p1), int(p2), int(d), float(w)) for p1, p2, d, w in zip(
        rng.randint(0, 6, 12), rng.randint(6, 12, 12), rng.randint(0, 3, 12),
        rng.rand(12))]
    for weights in ("actual", "thresholded"):
        assert TB.unify(comps, weights) == JB.unify(comps, weights)
    for method in ("min", "arithmeticMean", "geometricMean"):
        for wik, wkj in ((0.3, 0.8), (np.nan, 0.5), (0.9, 0.9)):
            np.testing.assert_array_equal(TB.consolidate(wik, wkj, method),
                                          JB.consolidate(wik, wkj, method))
    assert (TB.augment(comps, rng=np.random.RandomState(seed))
            == JB.augment(comps, rng=np.random.RandomState(seed)))


def test_builder_stands_alone():
    """The port's builder converts to linear with the port's own
    srgb_to_rgb, and its blobs feed the port's WHDR."""
    from reflectance_filtering_tpu_torch.losses.whdr import whdr
    from reflectance_filtering_tpu_torch.utils.image import srgb_to_rgb
    assert TB.srgb_to_rgb is srgb_to_rgb
    points = {1: [0.25, 0.5, True], 2: [0.75, 0.1, True]}
    blob = TB.comparisons_to_matrix([(1, 2, 2, 0.9)], "118495", points, 10)
    refl = torch.full((4, 4, 3), 0.5)
    assert float(whdr(refl, torch.from_numpy(blob.astype(np.float32)))) == \
        1.0
