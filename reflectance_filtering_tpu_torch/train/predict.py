"""Prediction, scoring and the decompose family (port of
reflectance_filtering_tpu/train/predict.py).

  * ``predict_and_score`` keeps the reference's artifact contract
    (train_with_barrista_helper.py:490-583): score cache file
    ``scores/{description}_imgs{N}.txt`` (a value < 100 is returned
    without recompute), frame rate written to ``framerates/...txt``,
    sentinel score 100 when prediction fails.
  * ``decompose_single_image_in_full_size`` (helper:753-805): one image at
    full size, six outputs (linear and sRGB of -r, -s, -RS_est), written
    as float * 255 (helper:665-686).
  * ``decompose_images_batched``: many images grouped by (H, W), read by
    the native thread-pool decoder (``data/native_loader.py``), predicted
    in batches, each chunk's failure contained.
  * ``decompose_numpy`` (helper:711-750): an .npz decomposed twice (input
    as linear and as sRGB) into ``*_decomposed.npz``.
  * ``decompose_movie`` (helper:1027-1060) and its baselines
    (helper:998-1024): frames linearized from sRGB, decomposed in
    batches, written as a combined triptych and separate -r/-s mp4s, and
    rgbMean/rgbNorm baseline videos.

Every prediction runs on an explicit ``device`` (default the card) through
``make_predict_fn`` / ``predict_batched``: a flagship skip trunk on a CUDA
tensor runs the fused trunk kernel K7's forward.  Batches run on one
device, or split over a data-parallel mesh (``mesh=``, parallel/mesh.py).
"""
from __future__ import annotations

import os
import timeit
import traceback
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..losses.whdr import whdr_per_image
from ..models.networks import NetworkConfig, apply_network
from ..models.recover import recover_reflectance_shading
from ..utils.image import rgb_to_srgb, rgb_uint8_to_linear, srgb_to_rgb
from ..utils.profiling import span, write_rate_artifact

EPS = np.float32(np.finfo(np.float32).eps)


def percent(num) -> str:
    """helper:442-444."""
    return "{:.2f}%".format(num * 100)


def make_predict_fn(net_cfg: NetworkConfig) -> Callable:
    """(params, images NHWC tensor) -> {RS_est, reflectance, shading}, plus
    the cascade's ``reflectance_level0`` when the network makes it (JAX
    ``train/predict.py:67-68``), with no autograd graph."""

    def predict(params, images):
        with torch.no_grad():
            blobs = apply_network(params, images, net_cfg, train=False)
            if net_cfg.rs_est_mode.split("-")[0] == "rDirectly":
                refl = torch.relu(blobs["RS_est"])
                shad = refl
            else:
                refl, shad = recover_reflectance_shading(
                    blobs["RS_est"], images, net_cfg.rs_est_mode)
        out = {"RS_est": blobs["RS_est"], "reflectance": refl,
               "shading": shad}
        if "reflectance_level0" in blobs:
            out["reflectance_level0"] = blobs["reflectance_level0"]
        return out

    return predict


def predict_batched(predict_fn: Callable, params, images: np.ndarray,
                    batch_size: int = 32, device="cuda", mesh=None
                    ) -> Dict[str, np.ndarray]:
    """Run prediction over [N,H,W,3] in batches of ``batch_size`` on
    ``device``; the outputs come back as numpy.  With a ``mesh``
    (parallel/mesh.py) each batch is split over its ranks, each predicting
    its rows on the mesh's device (``params`` must be there), and the rows
    are gathered, so every rank returns the whole result: batch_size is
    rounded up to a multiple of the mesh size and a ragged batch is padded
    (with copies of its last image) to one."""
    if mesh is not None:
        from ..parallel.mesh import pad_to_multiple, shard_batch
        batch_size = -(-batch_size // mesh.size) * mesh.size
    outs: Dict[str, List[np.ndarray]] = {}
    for start in range(0, images.shape[0], batch_size):
        chunk = np.ascontiguousarray(images[start:start + batch_size],
                                     np.float32)
        if mesh is None:
            res = predict_fn(params, torch.from_numpy(chunk).to(device))
            take = chunk.shape[0]
        else:
            padded, take = pad_to_multiple(chunk, mesh.size)
            res = {k: mesh.gather(v) for k, v in predict_fn(
                params, shard_batch(padded, mesh)).items()}
        for k, v in res.items():
            outs.setdefault(k, []).append(v[:take].cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def score_whdr_per_image(reflectances: np.ndarray, comps: np.ndarray,
                         delta: float = 0.1, device="cuda",
                         mesh=None) -> np.ndarray:
    """Per-image WHDR over a whole prediction set in one call on
    ``device``; with a ``mesh`` each rank scores its rows on the mesh's
    device and every rank returns all of them."""
    r = np.asarray(reflectances, np.float32)
    c = np.asarray(comps, np.float32)
    if mesh is None:
        return whdr_per_image(torch.from_numpy(r).to(device),
                              torch.from_numpy(c).to(device),
                              delta).cpu().numpy()
    from ..parallel.mesh import pad_to_multiple, shard_batch
    r_p, n = pad_to_multiple(r, mesh.size)
    c_p, _ = pad_to_multiple(c, mesh.size)
    per_image = whdr_per_image(shard_batch(r_p, mesh), shard_batch(c_p, mesh),
                               delta)
    return mesh.gather(per_image).cpu().numpy()[:n]


def predict_and_score(X_val: Dict, params, net_cfg: NetworkConfig,
                      results_dir: str, description: str,
                      delta: float = 0.1, batch_size: int = 32,
                      predict_fn=None, device="cuda") -> float:
    """Score a checkpoint on a validation set; returns WHDR in percent,
    with the score cache, the frame-rate file and the sentinel 100 of the
    reference (helper:498-583)."""
    num_images = X_val["images"].shape[0]
    description = description + "_imgs{}".format(num_images)
    score_filename = os.path.join(results_dir, "scores",
                                  description + ".txt")
    if os.path.isfile(score_filename):
        try:
            with open(score_filename) as f:
                result = float(f.readline())
        except ValueError:
            # an interrupted eval can leave an empty or garbled cache file
            result = 100.0
        if result < 100:
            return result

    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)

    start = timeit.default_timer()
    try:
        results = predict_batched(predict_fn, params,
                                  np.asarray(X_val["images"], np.float32),
                                  batch_size, device)
    except Exception:  # noqa: BLE001 — the reference's sentinel contract
        traceback.print_exc()
        print("Prediction was not possible, returning 100 as default!")
        return 100
    prediction_time = timeit.default_timer() - start
    rate = num_images / prediction_time
    print("Predicting", num_images, "images took", prediction_time,
          "seconds, i.e.,", prediction_time / num_images, "per image and",
          rate, "images per second.")

    write_rate_artifact(os.path.join(results_dir, "framerates",
                                     description + ".txt"),
                        num_images, prediction_time)

    whdrs = score_whdr_per_image(results["reflectance"],
                                 np.asarray(X_val["comparisons"], np.float32),
                                 delta, device)
    mean_whdr = float(np.mean(whdrs))
    score = mean_whdr * 100

    print("WHDR on learned reflectance for:", description)
    print("WHDRs:",
          "\t min", percent(float(np.min(whdrs))),
          "\t max", percent(float(np.max(whdrs))),
          "\t median", percent(float(np.median(whdrs))),
          "\t mean", percent(mean_whdr))

    os.makedirs(os.path.join(results_dir, "scores"), exist_ok=True)
    tmp = score_filename + ".tmp"     # atomic publish
    with open(tmp, "w") as f:
        f.write(str(score))
    os.replace(tmp, score_filename)
    return score


# ---------------------------------------------------------------------------
# decompose family
# ---------------------------------------------------------------------------

def is_image(filename):
    """helper:586-589."""
    ext = os.path.splitext(filename)[1][1:].strip().lower()
    return ext in ["jpg", "png", "ppm", "tiff"]


def is_movie(filename):
    """helper:592-595."""
    ext = os.path.splitext(filename)[1][1:].strip().lower()
    return ext in ["mp4", "avi"]


def is_numpy(filename):
    """helper:598-601."""
    ext = os.path.splitext(filename)[1][1:].strip().lower()
    return ext in ["npz"]


def _read_img_linear_hwc(full_path: str) -> np.ndarray:
    """helper:653-662 (minus the NCHW transpose: NHWC on the device)."""
    import cv2

    img = cv2.imread(full_path)
    if img is None:
        raise IOError("Could not read {}".format(full_path))
    return rgb_uint8_to_linear(img[:, :, ::-1])


def _save_img(full_path: str, img_hwc: np.ndarray,
              scale2Max: bool = False, convert2sRGB: bool = False):
    """helper:665-686: RGB->BGR, optional max-scale / sRGB encode, write
    img*255 as float (OpenCV rounds and saturates)."""
    import cv2

    img = np.array(img_hwc, copy=True)
    img = img[:, :, ::-1] if img.ndim == 3 else img
    if scale2Max:
        img = img / np.max(img)
    if convert2sRGB:
        img = rgb_to_srgb(img)
    cv2.imwrite(full_path, img * 255)


def _write_decomposition(results_dir: str, orig: str, reflectance,
                         shading, rs_est):
    """helper:776-805: 6 outputs (linear + sRGB) under results_dir."""
    fmt = ".png"
    for sub, srgb in (("decompositions_linear", False),
                      ("decompositions_sRGB", True)):
        os.makedirs(os.path.join(results_dir, sub), exist_ok=True)
        _save_img(os.path.join(results_dir, sub, orig + "-r" + fmt),
                  reflectance, convert2sRGB=srgb)
        _save_img(os.path.join(results_dir, sub, orig + "-s" + fmt),
                  shading, convert2sRGB=srgb)
        _save_img(os.path.join(results_dir, sub, orig + "-RS_est" + fmt),
                  rs_est, convert2sRGB=srgb)


def _predict_numpy(predict_fn, params, images: np.ndarray, device):
    """One batch [N, H, W, 3] through ``predict_fn`` on ``device``; the
    three outputs back as numpy."""
    res = predict_fn(params, torch.from_numpy(
        np.ascontiguousarray(images, np.float32)).to(device))
    return tuple(res[key].cpu().numpy()
                 for key in ("reflectance", "shading", "RS_est"))


def decompose_single_image_in_full_size(img_path: str, params,
                                        net_cfg: NetworkConfig,
                                        results_dir: str,
                                        predict_fn=None, device="cuda"):
    """helper:753-805: full-size decompose of one image on ``device``, 6
    outputs (linear + sRGB)."""
    img = _read_img_linear_hwc(img_path)
    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)
    refl, shad, rs = _predict_numpy(predict_fn, params, img[None], device)
    # splitext, not [:-4]: is_image accepts .tiff, which the reference's
    # 4-char strip (helper:766) would mangle to 'name.-r.png'
    _write_decomposition(results_dir,
                         os.path.splitext(os.path.basename(img_path))[0],
                         refl[0], shad[0], rs[0])


def decompose_images_batched(paths: Sequence[str], params,
                             net_cfg: NetworkConfig, results_dir: str,
                             predict_fn=None, batch_size: int = 16,
                             device="cuda"):
    """Batched multi-image decompose, replacing the reference's per-file
    loop that rebuilt the whole net per image (helper:757-760).  Images
    are read by the native thread-pool decoder (bit-exact PNG parity with
    cv2, ``data/native_loader.read_images_rgb``), grouped by (H, W) and
    predicted on ``device`` in batches of ``batch_size``; a file nothing
    can read and a chunk that fails are reported and skipped.  Returns the
    decomposed paths.  ``decompose_images_batched.last_seconds`` holds the
    last call's wall seconds by part: decode, device (the prediction and
    its copies), write."""
    from ..data.native_loader import read_images_rgb

    seconds = {"decode": 0.0, "device": 0.0, "write": 0.0}
    with span("predict.decode") as s:
        raw, failed = read_images_rgb(paths)
        for p in failed:
            print("Decomposing file", p, "was not possible")
        groups: Dict = {}
        for p, rgb in raw:
            # helper:653-662 linearization, minus cv2's BGR round trip
            img = rgb_uint8_to_linear(rgb)
            groups.setdefault(img.shape[:2], []).append((p, img))
    seconds["decode"] += s.seconds
    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)
    done = []
    for items in groups.values():
        for start in range(0, len(items), batch_size):
            chunk = items[start:start + batch_size]
            # per-chunk containment, like the reference's per-file loop
            # (helper:410-435): one group the device cannot run (out of
            # memory on a large frame) must not abort the others
            try:
                with span("predict.device") as s:
                    refl, shad, rs = _predict_numpy(
                        predict_fn, params,
                        np.stack([im for _, im in chunk]), device)
                seconds["device"] += s.seconds
            except Exception:  # noqa: BLE001 — reported, the rest goes on
                print("Decomposing files", [p for p, _ in chunk],
                      "was not possible")
                traceback.print_exc()
                continue
            with span("predict.write") as s:
                for i, (p, _) in enumerate(chunk):
                    _write_decomposition(
                        results_dir,
                        os.path.splitext(os.path.basename(p))[0],
                        refl[i], shad[i], rs[i])
                    done.append(p)
            seconds["write"] += s.seconds
    decompose_images_batched.last_seconds = seconds
    return done


decompose_images_batched.last_seconds = None


def decompose_numpy(npz_path: str, params, net_cfg: NetworkConfig,
                    predict_fn=None, batch_size: int = 16, device="cuda"):
    """helper:711-750: decompose an npz twice (as-linear and as-sRGB) on
    ``device``; returns the path of ``*_decomposed.npz``."""
    with np.load(npz_path) as npz:
        images = npz["images"]  # [N, H, W, C] uint8-style 0-255

    input_as_is = (images / 255.0).astype(np.float32)
    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)

    res1 = predict_batched(predict_fn, params, input_as_is, batch_size,
                           device)
    linear = srgb_to_rgb(input_as_is).astype(np.float32)
    res2 = predict_batched(predict_fn, params, linear, batch_size, device)

    np.savez_compressed(
        npz_path[:-4] + "_decomposed.npz",
        images=images,
        R_back_to_sRGB=rgb_to_srgb(res2["reflectance"]),
        S_back_to_sRGB=rgb_to_srgb(res2["shading"]),
        r_back_to_sRGB=rgb_to_srgb(res2["RS_est"]),
        R_from_input=res1["reflectance"],
        S_from_input=res1["shading"],
        r_from_input=res1["RS_est"],
    )
    return npz_path[:-4] + "_decomposed.npz"


# ---- movies (helper:870-1060) --------------------------------------------

def load_movie(filename: str):
    """helper:870-904: frames as [N,H,W,3] linear float32 + (w, h, fps)."""
    import cv2

    cap = cv2.VideoCapture(filename)
    if not cap.isOpened():
        raise IOError("Could not open movie {}".format(filename))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            srgb = frame[:, :, ::-1] / 255.0
            frames.append(srgb_to_rgb(srgb).astype(np.float32))
    finally:
        cap.release()
    return np.asarray(frames), [width, height, fps]


def _frame_to_bgr_u8(frame_hwc: np.ndarray) -> np.ndarray:
    """helper:621-632: linear -> sRGB, clip 0-1, *255, uint8, RGB->BGR.

    Grayscale (1-channel, e.g. rDirectly reflectance) is replicated to RGB
    (the reference's _color helper, helper:649-650)."""
    if frame_hwc.shape[-1] == 1:
        frame_hwc = np.repeat(frame_hwc, 3, axis=-1)
    srgb = rgb_to_srgb(frame_hwc)
    u8 = (np.clip(srgb, 0, 1) * 255).astype("u1")
    return u8[:, :, ::-1]


def _open_writer(name: str, width: int, height: int, fps: float):
    import cv2

    writer = cv2.VideoWriter(name, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps if fps and fps > 0 else 25.0,
                             (width, height), True)
    if not writer.isOpened():
        raise IOError("Could not open video writer for {}".format(name))
    return writer


def save_movie_combined(filename: str, image, reflectance, shading, stats):
    """helper:920-951: [img | R | S] triptych video."""
    width, height, fps = stats
    name = filename[:-4] + "-combined" + filename[-4:]
    writer = _open_writer(name, 3 * width, height, fps)
    try:
        for i in range(image.shape[0]):
            writer.write(np.concatenate([_frame_to_bgr_u8(image[i]),
                                         _frame_to_bgr_u8(reflectance[i]),
                                         _frame_to_bgr_u8(shading[i])],
                                        axis=1))
    finally:
        writer.release()
    return name


def save_movie_separate(filename: str, image, reflectance, shading, stats):
    """helper:954-995: separate -r and -s videos."""
    width, height, fps = stats
    names = []
    for suffix, blob in (("-r", reflectance), ("-s", shading)):
        name = filename[:-4] + suffix + filename[-4:]
        writer = _open_writer(name, width, height, fps)
        try:
            for i in range(blob.shape[0]):
                writer.write(_frame_to_bgr_u8(blob[i]))
        finally:
            writer.release()
        names.append(name)
    return names


def save_movie_baseline(filename: str, image, stats):
    """helper:998-1024: rgbMean and rgbNorm baseline decompositions."""
    outputs = []
    for tag, norm in (("rgbMean",
                       lambda f: np.maximum(f.sum(-1, keepdims=True) / 3,
                                            EPS)),
                      ("rgbNorm",
                       lambda f: np.maximum(
                           np.linalg.norm(f, axis=-1, keepdims=True), EPS))):
        refl = []
        shad = []
        for i in range(image.shape[0]):
            inten = norm(image[i])
            refl.append(image[i] / inten)
            shad.append(np.broadcast_to(inten, image[i].shape))
        base = filename[:-4] + "-baseline_" + tag + filename[-4:]
        outputs.append(save_movie_combined(base, image,
                                           np.asarray(refl),
                                           np.asarray(shad), stats))
    return outputs


def decompose_movie(movie_path: str, params, net_cfg: NetworkConfig,
                    results_dir: str, predict_fn=None,
                    batch_size: int = 8, device="cuda"):
    """helper:1027-1060: baselines + CNN decomposition videos, the frames
    predicted on ``device``."""
    images, stats = load_movie(movie_path)
    orig = os.path.basename(movie_path)[:-4]
    out_dir = os.path.join(results_dir, "decompositions_sRGB")
    os.makedirs(out_dir, exist_ok=True)
    full_path = os.path.join(out_dir, orig + ".mp4")

    save_movie_baseline(full_path, images, stats)

    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)
    start = timeit.default_timer()
    res = predict_batched(predict_fn, params, images, batch_size, device)
    dt = timeit.default_timer() - start
    n = images.shape[0]
    print("Predicting", n, "frames took", dt, "seconds, i.e.,",
          dt / n, "per frame and", n / dt, "fps.")

    refl, shad = res["reflectance"], res["shading"]
    save_movie_combined(full_path, images, refl, shad, stats)
    save_movie_separate(full_path, images, refl, shad, stats)
    return full_path


def decompose_files(files: Sequence[str], params, net_cfg: NetworkConfig,
                    results_dir: str, batch_size: int = 16, device="cuda"):
    """File dispatch with per-file error containment (helper:410-435), all
    prediction on ``device``.

    Images go through the shape-grouped batched path; movies and npz
    archives are handled per file."""
    predict_fn = make_predict_fn(net_cfg)
    images = [f for f in files if is_image(f)]
    if images:
        try:
            decompose_images_batched(images, params, net_cfg, results_dir,
                                     predict_fn, batch_size, device)
        except Exception:  # noqa: BLE001 — reported, the rest goes on
            print("Decomposing the image batch was not possible")
            traceback.print_exc()
    for f in files:
        try:
            if is_image(f):
                pass  # handled by the batched path above
            elif is_movie(f):
                decompose_movie(f, params, net_cfg, results_dir, predict_fn,
                                batch_size, device)
            elif is_numpy(f):
                decompose_numpy(f, params, net_cfg, predict_fn, batch_size,
                                device)
            else:
                print("\nFile", f, "neither recognized as image, nor movie")
        except Exception:  # noqa: BLE001 — reported, the rest goes on
            print("Decomposing file", f, "was not possible")
            traceback.print_exc()
