"""ctypes binding for the native IO runtime (native/reflectance_io.cc), the
port's own copy of reflectance_filtering_tpu/data/native_loader.py.

The shared library is built from ``native/`` by its Makefile on first use
if it is missing (g++, libpng and libjpeg), into the port's own
``native/build/torch/``: the build holds a file lock, so processes that
start at once build it once, and it is compiled in a directory of its own
and renamed into place, so no process loads a half-written library.  When
the build or the load fails, the calls decode with cv2 instead, so the
port never depends on the native path.  Nothing is built or loaded at
import time.

The batch loader decodes and resizes PNG/JPEG files with a C++ thread
pool into one preallocated [N, H, W, 3] uint8 RGB array: the feeding side
of the batched decompose paths (``train/predict.py::
decompose_images_batched``, ``cli/decompose.py::decompose_images``).  PNG
decoding is bit-exact against cv2.  The native decoder applies no EXIF
orientation and cv2 does, so ``read_images_rgb`` sends JPEG files to cv2:
what a photo decodes to does not depend on which decoder a machine has.

Which decoder served the last call is kept on the functions:
``read_images_rgb.last_decoders`` counts its files by decoder
(``{"native": n, "cv2": m}``), and ``load_batch_rgb.last_decoder`` names
the one that decoded its batch.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_NAME = "libreflectance_io.so"      # the Makefile's target
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "torch", _LIB_NAME)

_lib = None
_lib_lock = threading.Lock()
_attempted = False     # one build-and-load attempt a process, one message


def _build(so_path: str) -> bool:
    """Build the library at ``so_path`` unless it is there; one process
    at a time (a lock file beside it), compiled into a directory of this
    process's own and renamed into place."""
    out_dir = os.path.dirname(so_path)
    tmp = os.path.join(out_dir, "tmp-{}".format(os.getpid()))
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(so_path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.isfile(so_path):      # another process built it
                return True
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR,
                                "BUILD=" + tmp], check=True,
                               capture_output=True)
                os.replace(os.path.join(tmp, _LIB_NAME), so_path)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        return True
    except (subprocess.CalledProcessError, OSError) as err:
        print("native IO build failed ({}); decoding with cv2".format(err))
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _attempted
    with _lib_lock:
        if _lib is not None or _attempted:
            return _lib
        _attempted = True
        if not os.path.isfile(_SO_PATH) and not _build(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as err:
            print("native IO load failed ({}); decoding with cv2".format(err))
            return None
        lib.rio_version.restype = ctypes.c_char_p
        lib.rio_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int]
        lib.rio_image_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.rio_load_batch_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library is built and loads (building it now if
    it is missing)."""
    return _load() is not None


def image_size(path: str):
    """(h, w) of an image (a header probe when the library is there);
    raises IOError on failure."""
    lib = _load()
    if lib is None:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise IOError("cannot read {}".format(path))
        return img.shape[0], img.shape[1]
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.rio_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc:
        raise IOError("cannot read {} (rc={})".format(path, rc))
    return h.value, w.value


def _is_jpeg(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(3) == b"\xff\xd8\xff"
    except OSError:
        return False


def _cv2_rgb(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise IOError("cannot read {}".format(path))
    return img[:, :, ::-1]


def read_images_rgb(paths: Sequence[str]):
    """Decode many images at their own size to uint8 RGB.

    Same-(H, W) files are decoded by ONE ``load_batch_rgb`` call each (a
    same-size resize is a copy).  Returns (items, failed): items is
    [(path, rgb_u8 [H, W, 3]), ...], failed the paths nothing could read.
    JPEG files (cv2 applies their EXIF orientation, the native decoder
    does not) and files the native probe rejects (formats beyond
    PNG/JPEG) are read by cv2, and a failed batch is read file by file by
    cv2, so one bad file never takes down its group.
    ``read_images_rgb.last_decoders`` counts the files each decoder
    served."""
    size_groups = {}
    items, failed = [], []
    served = {"native": 0, "cv2": 0}
    for p in paths:
        if not _is_jpeg(p):
            try:
                size_groups.setdefault(image_size(p), []).append(p)
                continue
            except Exception:  # noqa: BLE001 — any probe failure: try cv2
                pass
        try:
            items.append((p, _cv2_rgb(p)))
            served["cv2"] += 1
        except Exception:  # noqa: BLE001 — reported as failed
            failed.append(p)
    for (h, w), group in size_groups.items():
        try:
            rgb = load_batch_rgb(group, h, w)
            items.extend(zip(group, rgb))
            served[load_batch_rgb.last_decoder] += len(group)
        except Exception:  # noqa: BLE001 — per-file containment below
            for p in group:
                try:
                    items.append((p, _cv2_rgb(p)))
                    served["cv2"] += 1
                except Exception:  # noqa: BLE001 — reported as failed
                    failed.append(p)
    read_images_rgb.last_decoders = served
    return items, failed


read_images_rgb.last_decoders = {"native": 0, "cv2": 0}


def load_batch_rgb(paths: Sequence[str], height: int, width: int,
                   nthreads: int = 0) -> np.ndarray:
    """Decode and resize a list of image files to [N, H, W, 3] uint8 RGB.

    Uses the C++ thread pool when the library is there, cv2 one file after
    another otherwise (``load_batch_rgb.last_decoder`` says which).
    Raises IOError naming the first failing file."""
    n = len(paths)
    if height <= 0 or width <= 0:
        raise ValueError(
            "height/width must be positive, got {}x{}".format(height, width))
    out = np.empty((n, height, width, 3), np.uint8)
    if n == 0:
        return out
    lib = _load()
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = lib.rio_load_batch_rgb(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            height, width, nthreads)
        if rc:
            if rc <= -1000:     # per-file decode failure: -1000 - index
                raise IOError(
                    "failed to decode {}".format(paths[-rc - 1000]))
            raise IOError(
                "native loader rejected the call (rc={})".format(rc))
        load_batch_rgb.last_decoder = "native"
        return out
    import cv2
    for i, p in enumerate(paths):
        img = cv2.imread(p)
        if img is None:
            raise IOError("failed to decode {}".format(p))
        img = cv2.resize(img, (width, height),
                         interpolation=cv2.INTER_LINEAR)
        out[i] = img[:, :, ::-1]
    load_batch_rgb.last_decoder = "cv2"
    return out


load_batch_rgb.last_decoder = None
