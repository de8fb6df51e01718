"""IIW dataset builder: PNG + JSON judgments -> packed .npz shards (a numpy
copy of reflectance_filtering_tpu/data/builder.py, host code with no kernel).

Rebuild of the reference's createNumpyArrayWithComparisonsForIIW.py with the
same on-disk contract, so .npz files are interchangeable between the two
packages and the reference:

  * images      [N, 3, H, W] float (NCHW file layout like the reference;
                 the loader converts to NHWC), floored at 1e-5
                 (createNumpy...:294-298), sRGB and linear variants
                 (:240-262).
  * comparisons [N, MAX_NUM_COMPARISONS+1, 1, 6] rows
                 [x1,y1,x2,y2,darker,weight] in normalized coords, NaN
                 padded, last row metadata [num, float(file_name), 0]
                 (:616-649).
  * augmented   [N, MAX_NUM_AUGMENTED+1, 1, 6] transitive closure
                 (:461-508), or [N, 1, 1, 6] zeros when not augmenting.

Splits: Narihira-style deterministic index splits over the *sorted* file
list (:701-728, :739-746).

Deviations from the reference, kept from the JAX package:
  * Floyd-Warshall inner loops vectorized per-k with numpy — equivalent to
    the reference's sequential triple loop because the diagonal stays NaN,
    so row/column k never change during iteration k (:536-567).
  * No multiprocessing race: the builder is deterministic and race-free by
    construction (the reference documents its parallel path as corrupting
    output, README.md:104).
  * Judgments with a null or non-positive confidence are dropped.
"""
from __future__ import annotations

import json
import os
import sys
import timeit
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.image import srgb_to_rgb

MAX_NUM_COMPARISONS = 1181      # createNumpy...:83
MAX_NUM_AUGMENTED = 60049       # createNumpy...:85
IMAGE_EXTENSION = ".png"
FLOOR = 1e-5                    # createNumpy...:294-298


def _imread_rgb(path: str) -> np.ndarray:
    """Read image as RGB uint8 HWC (the reference used scipy.misc.imread)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError("Could not read image: {}".format(path))
    return img[:, :, ::-1]


def _imresize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize uint8 HWC with bilinear interpolation.

    The reference used scipy.misc.imresize (PIL bilinear on uint8,
    createNumpy...:284); PIL reproduces that exactly.
    """
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((width, height),
                                                  Image.BILINEAR))


def comparisons_to_matrix(comparisons, file_name, points, max_size: int
                          ) -> np.ndarray:
    """Pack a comparison list into the padded matrix + metadata row
    (createNumpy...:616-649)."""
    blob = np.full((max_size + 1, 6), np.nan)
    for c, (point1, point2, darker, weight) in enumerate(comparisons):
        x1, y1, _op1 = points[point1]
        x2, y2, _op2 = points[point2]
        blob[c, 0] = x1
        blob[c, 1] = y1
        blob[c, 2] = x2
        blob[c, 3] = y2
        blob[c, 4] = darker
        blob[c, 5] = weight
    blob[max_size, 0] = len(comparisons)
    blob[max_size, 1] = float(file_name)
    blob[max_size, 2] = 0
    return blob


def parse_iiw_json(json_path: str) -> Tuple[List, Dict]:
    """Parse an IIW judgment file into (comparisons, points)
    (createNumpy...:318-349)."""
    with open(json_path) as f:
        data = json.load(f)
    points = {}
    for point in data["intrinsic_points"]:
        points[point["id"]] = [point["x"], point["y"], point["opaque"]]
    switch = {"1": 1, "2": 2, "E": 0}
    comparisons = []
    dropped = 0
    for comparison in data["intrinsic_comparisons"]:
        score = comparison["darker_score"]
        # Bell's official scorer skips judgments with a null or
        # non-positive confidence (iiw whdr.py / losses/bell.py:48); the
        # reference builder packs the raw value, so a null would become
        # a NaN weight that poisons the whole image's hinge loss and
        # blob-path WHDR.  Guard here: documented deviation, the blob
        # only drops rows the referee metric ignores anyway.
        if score is None or score <= 0:
            dropped += 1
            continue
        comparisons.append([comparison["point1"],
                            comparison["point2"],
                            switch[comparison["darker"]],
                            score])
    if dropped:
        # make blob row-count mismatches vs reference-built data
        # diagnosable (the reference packs these rows; we drop them)
        print("parse_iiw_json: {} dropped {} null/non-positive-confidence "
              "judgment(s) ({} kept)".format(
                  os.path.basename(json_path), dropped, len(comparisons)),
              file=sys.stderr)
    return comparisons, points


# ---------------------------------------------------------------------------
# Transitive-closure augmentation (createNumpy...:412-613)
# ---------------------------------------------------------------------------

def unify(comparisons, weights: str = "actual", threshold: float = 0.5):
    """Normalize judgments to directed edges, vectorized like
    :func:`warshall`.  Semantics per createNumpy...:412-458: relation 0 is
    '=' (emitted in both directions), 1/'first darker' flips into the
    canonical 2/'second darker' form.  weights='thresholded' keeps only
    rows with weight > threshold and pins their weight to 1."""
    if weights not in ("actual", "thresholded"):
        raise ValueError("weights method {} not known".format(weights))
    arr = np.asarray(list(comparisons), np.float64).reshape(-1, 4)
    bad = ~np.isin(arr[:, 2], (0.0, 1.0, 2.0))
    if bad.any():
        raise ValueError("Expecting 0,1,2 as comparison, got {}".format(
            arr[bad, 2][0]))
    if weights == "thresholded":
        arr = arr[arr[:, 3] > threshold]
        arr[:, 3] = 1.0

    # '=' rows expand to two directed edges, kept adjacent (downstream
    # node numbering follows first-appearance order)
    d = arr[:, 2]
    row = np.repeat(np.arange(arr.shape[0]), np.where(d == 0, 2, 1))
    is_mirror = np.r_[False, row[1:] == row[:-1]]
    p1, p2, dd, w = arr[row].T
    swap = (dd == 1.0) ^ is_mirror
    out = np.stack([np.where(swap, p2, p1), np.where(swap, p1, p2),
                    np.where(dd == 0.0, 0.0, 2.0), w], axis=1)
    return [tuple(r) for r in out]


def consolidate(wik, wkj, method: str = "min"):
    """Mix two path weights along a transitive chain; NaN-propagating
    (createNumpy...:511-533).  Scalar view of :func:`_consolidate_vec`."""
    return float(_consolidate_vec(np.float64(wik), np.float64(wkj), method))


def _consolidate_vec(wik, wkj, method: str):
    if method == "min":
        return np.minimum(wik, wkj)  # NaN propagates
    if method == "arithmeticMean":
        return (wik + wkj) / 2
    if method == "geometricMean":
        return (wik * wkj) ** 0.5
    raise ValueError("Method {} is not known.".format(method))


def warshall(a: np.ndarray, consolidation_method: str = "min",
             rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Transitive closure + consistency pruning (createNumpy...:536-613).

    a: [2, n, n] — a[0] relations (0 '=' / 2 '<' / NaN), a[1] weights.
    Vectorized per-k; equivalent to the reference's sequential loops since
    the diagonal stays NaN (see module docstring).
    """
    if rng is None:
        rng = np.random.RandomState()
    n = a.shape[1]
    off_diag = ~np.eye(n, dtype=bool)
    for k in range(n):
        wik = a[1, :, k][:, None]           # [n,1]
        wkj = a[1, k, :][None, :]           # [1,n]
        wij_new = _consolidate_vec(wik, wkj, consolidation_method)
        wij = a[1]
        update = (np.isfinite(wij_new) &
                  (np.isnan(wij) | (wij < wij_new)) & off_diag)
        rik = a[0, :, k][:, None]
        rkj = a[0, k, :][None, :]
        rel_new = np.where(rik == rkj, rik, 2.0)
        a[0][update] = np.broadcast_to(rel_new, (n, n))[update]
        a[1][update] = wij_new[update]

    # consistency pruning (createNumpy...:569-609)
    failed = 0
    biggest = 0.0
    rel = a[0]
    for i in range(n):
        for j in range(n):
            if ((rel[i, j] == 2 and rel[j, i] == 2) or
                    (rel[i, j] == 2 and rel[j, i] == 0) or
                    (rel[i, j] == 0 and rel[j, i] == 2)):
                failed += 1
                if a[1, i, j] > a[1, j, i]:
                    biggest = max(biggest, a[1, j, i])
                    a[:, j, i] = np.nan
                else:
                    biggest = max(biggest, a[1, i, j])
                    a[:, i, j] = np.nan
            if rel[i, j] == 0 and rel[j, i] == 0:
                if rng.rand() > 0.5:
                    a[:, j, i] = np.nan
                else:
                    a[:, i, j] = np.nan
    if failed:
        print("Removed", failed, "comparisons (failed consistency check), "
              "highest removed certainty {:4.2f}".format(biggest))
    return a


def augment(comparisons, weights: str = "actual",
            consolidation_method: str = "min",
            rng: Optional[np.random.RandomState] = None):
    """Add the transitive hull to the comparisons (createNumpy...:461-508)."""
    unified = unify(comparisons, weights)

    point_to_node: Dict = {}
    node_to_point: List = []
    for x, y, _r, _w in unified:
        if x not in point_to_node:
            point_to_node[x] = len(node_to_point)
            node_to_point.append(x)
        if y not in point_to_node:
            point_to_node[y] = len(node_to_point)
            node_to_point.append(y)

    n = len(node_to_point)
    matrix = np.full((2, n, n), np.nan)
    for x, y, r, w in unified:
        matrix[0, point_to_node[x], point_to_node[y]] = r
        matrix[1, point_to_node[x], point_to_node[y]] = w

    matrix = warshall(matrix, consolidation_method, rng)

    augmented = []
    for i in range(n):
        for j in range(n):
            if np.isfinite(matrix[0, i, j]):
                augmented.append([node_to_point[i], node_to_point[j],
                                  matrix[0, i, j], matrix[1, i, j]])
    return augmented


# ---------------------------------------------------------------------------
# Per-file and whole-set building
# ---------------------------------------------------------------------------

def get_data_for_single_file(data_folder: str, file_name: str,
                             augment_data: bool = False,
                             rng: Optional[np.random.RandomState] = None):
    """(image RGB u8, comparisons blob, augmented blob, h, w, n_comp, n_aug)
    for one IIW id (createNumpy...:301-409)."""
    image = _imread_rgb(os.path.join(data_folder,
                                     file_name + IMAGE_EXTENSION))
    height, width = image.shape[:2]
    comparisons, points = parse_iiw_json(
        os.path.join(data_folder, file_name + ".json"))

    comp_blob = comparisons_to_matrix(comparisons, file_name, points,
                                      MAX_NUM_COMPARISONS)
    if augment_data:
        augmented = augment(comparisons, rng=rng)
        aug_blob = comparisons_to_matrix(augmented, file_name, points,
                                         MAX_NUM_AUGMENTED)
        n_aug = len(augmented)
    else:
        aug_blob = np.zeros((1, 6))
        n_aug = 0
    return (image, comp_blob, aug_blob, height, width,
            len(comparisons), n_aug)


def _build_one(args):
    """Process-pool worker: one file, its own derived RNG.  Module-level
    for pickling; returns only what build_dataset packs."""
    data_folder, fn, augment_data, seed_i = args
    rng = np.random.RandomState(seed_i)
    img, cb, ab, _h, _w, _nc, _na = get_data_for_single_file(
        data_folder, fn, augment_data, rng)
    return img, cb, ab


def build_dataset(data_folder: str, file_list: Sequence[str],
                  file_to_save: str, height: int = 256, width: int = 256,
                  augment_data: bool = False,
                  seed: Optional[int] = None, verbose: bool = True,
                  workers: int = 1):
    """Build one .npz shard pair (sRGB + linear) for a file list
    (createNumpy...:92-265).

    workers > 1 builds files on a process pool — RACE-FREE, unlike the
    reference's multiprocessing path which it documents as corrupting
    output (README.md:104): results come back via ``Executor.map`` in
    input order and each lands at its own blob row, so scheduling can
    never interleave rows.  Determinism: per-file RNG seeds are
    pre-drawn from the master stream, so any worker count (and any
    scheduling) gives bit-identical output for a given ``seed``.
    Comparisons-only builds (augment_data=False) consume no RNG at all
    and are additionally bit-identical to the workers=1 sequential
    build; augmented builds with workers>1 use the per-file streams
    (same within-file pruning semantics, different draws than the
    single-stream sequential build — a documented deviation)."""
    rng = np.random.RandomState(seed)
    n = len(file_list)
    images_list = []
    comparisons_blob = np.full((n, MAX_NUM_COMPARISONS + 1, 1, 6), np.nan)
    if augment_data:
        augmented_blob = np.full((n, MAX_NUM_AUGMENTED + 1, 1, 6), np.nan)
    else:
        augmented_blob = np.zeros((n, 1, 1, 6))

    start = timeit.default_timer()
    if workers and workers > 1 and n > 0:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        seeds = rng.randint(0, 2 ** 31 - 1, size=n)
        jobs = [(data_folder, fn, augment_data, int(seeds[i]))
                for i, fn in enumerate(file_list)]
        # spawned workers: forking a process that runs threads (torch's
        # among them) is unsafe
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            for fc, (img, cb, ab) in enumerate(ex.map(_build_one, jobs)):
                images_list.append(img)
                comparisons_blob[fc, :, 0, :] = cb
                augmented_blob[fc, :, 0, :] = ab
    else:
        for fc, fn in enumerate(file_list):
            img, cb, ab, _h, _w, _nc, _na = get_data_for_single_file(
                data_folder, fn, augment_data, rng)
            images_list.append(img)
            comparisons_blob[fc, :, 0, :] = cb
            augmented_blob[fc, :, 0, :] = ab

    images_blob = np.empty((n, 3, height, width))
    for i, image in enumerate(images_list):
        resized = _imresize(image, height, width)
        images_blob[i] = np.transpose(resized / 255.0, (2, 0, 1))

    outputs = {}
    srgb_path = file_to_save + "_{}_{}_sRGB.npz".format(height, width)
    np.savez_compressed(srgb_path,
                        images=np.maximum(images_blob, FLOOR),
                        comparisons=comparisons_blob,
                        augmented=augmented_blob)
    outputs["sRGB"] = srgb_path
    linear_path = file_to_save + "_{}_{}_linear.npz".format(height, width)
    np.savez_compressed(linear_path,
                        images=np.maximum(srgb_to_rgb(images_blob), FLOOR),
                        comparisons=comparisons_blob,
                        augmented=augmented_blob)
    outputs["linear"] = linear_path
    if verbose:
        print("Built {} files -> {} in {:.1f}s".format(
            n, outputs, timeit.default_timer() - start))
    return outputs


# ---------------------------------------------------------------------------
# Splits (createNumpy...:672-728): deterministic over the sorted file list
# ---------------------------------------------------------------------------

def narihira_split_two(file_names):
    """80/20 split (createNumpy...:689-698)."""
    train, test = [], []
    for ind, fn in enumerate(file_names):
        (train if ind % 5 else test).append(fn)
    return train, test


def narihira_split_three(file_names):
    """70/10/20 split (createNumpy...:701-713)."""
    train, val, test = [], [], []
    for ind, fn in enumerate(file_names):
        if ind % 5 == 0:
            test.append(fn)
        elif ind % 10 == 6:
            val.append(fn)
        else:
            train.append(fn)
    return train, val, test


def big_train_mini_val_split(file_names):
    """79/1/20 split (createNumpy...:716-728)."""
    train, val, test = [], [], []
    for ind, fn in enumerate(file_names):
        if ind % 5 == 0:
            test.append(fn)
        elif ind % 100 == 6:
            val.append(fn)
        else:
            train.append(fn)
    return train, val, test


def sorted_file_list(data_folder: str) -> List[str]:
    """Deterministic sorted id list (createNumpy...:739-746)."""
    names = [os.path.splitext(f)[0] for f in os.listdir(data_folder)
             if f.endswith(IMAGE_EXTENSION)]
    names.sort()
    return names
