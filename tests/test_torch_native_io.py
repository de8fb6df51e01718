"""The port's binding of the native IO runtime
(reflectance_filtering_tpu_torch/data/native_loader.py) against cv2 and the
JAX package's binding of the same library, on the same seeded files: PNG
decode is bitwise equal to both; the record of which decoder served a call;
cv2 for JPEG, for what the native probe rejects and for a whole call when
the library is missing; the build, once for processes that start at
once."""
import os

import numpy as np
import pytest

from reflectance_filtering_tpu.data import native_loader as jl
from reflectance_filtering_tpu_torch.data import native_loader as tl


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths, arrays = [], []
    for i, (h, w) in enumerate([(50, 70)] * 4 + [(33, 21)] * 2):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        p = str(d / "{}.png".format(i))
        cv2.imwrite(p, img[:, :, ::-1])  # the file holds BGR; RGB comes back
        paths.append(p)
        arrays.append(img)
    bmp = str(d / "x.bmp")               # a format the native probe rejects
    cv2.imwrite(bmp, arrays[0][:, :, ::-1])
    return paths, arrays, bmp


def test_native_builds_and_sizes(images):
    paths, _, _ = images
    assert tl.native_available(), "native IO library failed to build"
    assert tl.image_size(paths[0]) == (50, 70)
    assert tl.image_size(paths[5]) == (33, 21)


def test_png_decode_bitwise_equal_to_cv2_and_jax(images):
    import cv2
    paths, arrays, _ = images
    got = tl.load_batch_rgb(paths[:4], 50, 70)
    assert tl.load_batch_rgb.last_decoder == "native"
    np.testing.assert_array_equal(got, jl.load_batch_rgb(paths[:4], 50, 70))
    for i in range(4):
        np.testing.assert_array_equal(got[i], arrays[i])
        np.testing.assert_array_equal(got[i], cv2.imread(paths[i])[:, :, ::-1])


def test_resize_equals_jax_binding(images):
    paths, _, _ = images
    np.testing.assert_array_equal(tl.load_batch_rgb(paths[:2], 32, 48),
                                  jl.load_batch_rgb(paths[:2], 32, 48))


def test_read_images_rgb_records_its_decoders(images, tmp_path):
    """Two size groups through the native batch decoder, a BMP through
    cv2, a missing file reported: items and failures as the JAX binding's,
    and the record counts each decoder's files."""
    paths, arrays, bmp = images
    query = paths + [bmp, str(tmp_path / "missing.png")]
    items, failed = tl.read_images_rgb(query)
    j_items, j_failed = jl.read_images_rgb(query)
    assert failed == j_failed == [query[-1]]
    assert [p for p, _ in items] == [p for p, _ in j_items]
    for (p, got), (_, want) in zip(items, j_items):
        np.testing.assert_array_equal(got, want)
    got = dict(items)
    for p, a in zip(paths, arrays):
        np.testing.assert_array_equal(got[p], a)
    np.testing.assert_array_equal(got[bmp], arrays[0])
    assert tl.read_images_rgb.last_decoders == {"native": 6, "cv2": 1}


def test_without_the_library_cv2_decodes(images, monkeypatch):
    """A machine where the library cannot be built: every call decodes
    with cv2, to the same bytes, and the record says so."""
    paths, arrays, _ = images
    monkeypatch.setattr(tl, "_load", lambda: None)
    assert not tl.native_available()
    items, failed = tl.read_images_rgb(paths)
    assert failed == []
    for (p, got), a in zip(items, arrays):
        np.testing.assert_array_equal(got, a)
    assert tl.read_images_rgb.last_decoders == {"native": 0, "cv2": 6}
    tl.load_batch_rgb(paths[:1], 50, 70)
    assert tl.load_batch_rgb.last_decoder == "cv2"


def test_bad_calls_raise(images, tmp_path):
    paths, _, _ = images
    with pytest.raises(IOError):
        tl.load_batch_rgb([str(tmp_path / "nope.png")], 8, 8)
    with pytest.raises(ValueError):
        tl.load_batch_rgb(paths[:1], 0, 64)
    out = tl.load_batch_rgb([], 8, 8)
    assert out.shape == (0, 8, 8, 3) and out.dtype == np.uint8


def _jpeg_turned(path, img_rgb):
    """A JPEG of ``img_rgb`` whose EXIF orientation tag (6) says: turn it a
    quarter clockwise to show it."""
    import cv2
    ok, buf = cv2.imencode(".jpg", img_rgb[:, :, ::-1])
    assert ok
    tiff = (b"MM\x00\x2a\x00\x00\x00\x08" + b"\x00\x01"
            + b"\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06\x00\x00"
            + b"\x00\x00\x00\x00")
    app1 = b"Exif\x00\x00" + tiff
    data = bytes(buf)
    with open(path, "wb") as f:
        f.write(data[:2] + b"\xff\xe1" + (len(app1) + 2).to_bytes(2, "big")
                + app1 + data[2:])


def test_jpeg_reads_through_cv2_with_its_orientation(images, tmp_path):
    """A JPEG decodes as cv2 decodes it, its EXIF orientation applied, on
    every machine: ``read_images_rgb`` sends it to cv2 and counts it so,
    while PNGs beside it stay on the native decoder."""
    import cv2
    paths, arrays, _ = images
    jpg = str(tmp_path / "turned.jpg")
    _jpeg_turned(jpg, arrays[0])
    want = cv2.imread(jpg)[:, :, ::-1]
    assert want.shape[:2] == (70, 50)           # turned: cv2 applies it
    items, failed = tl.read_images_rgb(paths[:2] + [jpg])
    assert failed == []
    got = dict(items)
    np.testing.assert_array_equal(got[jpg], want)
    assert tl.read_images_rgb.last_decoders == {"native": 2, "cv2": 1}


def test_processes_building_at_once_build_once(tmp_path):
    """Four processes that find no library and build it at once: each
    returns a library that loads, built by one of them under the lock,
    and no build directory is left behind."""
    import subprocess
    import sys
    so = str(tmp_path / "lib" / "libreflectance_io.so")
    code = ("import ctypes, sys; from reflectance_filtering_tpu_torch.data "
            "import native_loader as tl; assert tl._build(sys.argv[1]); "
            "ctypes.CDLL(sys.argv[1])")
    procs = [subprocess.Popen([sys.executable, "-c", code, so])
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    assert sorted(os.listdir(tmp_path / "lib")) == [
        "libreflectance_io.so", "libreflectance_io.so.lock"]


def test_decode_measurement_script(capsys):
    """scripts/measure_decode.py at a small size: both decoders timed on
    the same seeded PNGs (it raises if they differ), one JSON line."""
    import json
    from reflectance_filtering_tpu_torch.scripts import measure_decode
    assert measure_decode.main(["--count", "3", "--height", "24",
                                "--width", "40"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pngs"] == 3 and sorted(out["seconds"]) == ["cv2", "native"]
    assert all(s > 0 for s in out["seconds"].values())
