"""The BF(CNN,CNN) slice end to end: the port's serving pipeline and CLIs
against the same composition in the JAX package, on seeded weights (the
trained model is not in the repository) and seeded photos, on the CPU.

The JAX side mirrors ``utils/serving._pipeline_fn("bf", use_pallas=False)``
without its caffemodel load: reflectance_net_apply, floor(r*255), the
vmapped joint_bilateral_filter at c20 s22, rint/clip, whdr_batch.
Gate: uint8 within 1 level, |dWHDR| <= 0.001.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu.cli import decompose as jdec
from reflectance_filtering_tpu.cli import filter as jfilt
from reflectance_filtering_tpu.losses.whdr import (
    whdr_batch as j_whdr_batch)
from reflectance_filtering_tpu.models.networks import (
    reference_params_from_caffe, reflectance_net_apply)
from reflectance_filtering_tpu.ops.bilateral import joint_bilateral_filter
from reflectance_filtering_tpu.utils.image import srgb_to_rgb_jnp
from reflectance_filtering_tpu_torch.cli import decompose as tdec
from reflectance_filtering_tpu_torch.cli import filter as tfilt
from reflectance_filtering_tpu_torch.losses.whdr import whdr_batch
from reflectance_filtering_tpu_torch.models import caffe_io as tcio
from reflectance_filtering_tpu_torch.models.networks import (
    ReflectanceNet, params_from_numpy, seeded_reference_params)
from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn
from reflectance_filtering_tpu_torch.utils.testimages import (
    make_synthetic_comps, pink_noise)

from test_torch_caffe_io import caffemodel_bytes

SEED = 5
BF_FILES = ("-r.png", "-r_colorized.png", "-s_colorized.png",
            "-r_bilateral_c20.0s22.0.png")


def _photos(seed, n, h, w):
    """uint8 BGR planar [n, 3, h, w]: 1/f noise with a shared luminance."""
    rng = np.random.RandomState(seed)
    out = np.empty((n, 3, h, w), np.uint8)
    for i in range(n):
        lum = pink_noise(rng, h, w)
        for c in range(3):
            out[i, c] = np.clip(0.6 * lum + 0.4 * pink_noise(rng, h, w),
                                0, 255)
    return out


def _jax_bf(params, img):
    p = reference_params_from_caffe(params)
    x = jnp.asarray(img)[:, ::-1].astype(jnp.float32) / 255.0
    refl = reflectance_net_apply(p, srgb_to_rgb_jnp(jnp.moveaxis(x, 1, -1)))
    r_u8 = jnp.floor(refl[..., 0] * 255.0)
    rep = jnp.repeat(r_u8[..., None], 3, axis=-1)
    q = jax.vmap(lambda j: joint_bilateral_filter(j, j, -1, 20.0, 22.0))(
        rep)[..., 0]
    return refl[..., 0], jnp.clip(jnp.round(q), 0.0, 255.0)


@pytest.fixture(scope="module")
def net_params():
    params = seeded_reference_params(SEED)
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(params))
    return net, params


def test_bf_slice_matches_jax(net_params):
    net, params = net_params
    img = _photos(SEED, 2, 48, 64)
    comps = make_synthetic_comps(SEED, 300, batch=2)
    with torch.no_grad():
        q = pipeline_fn("bf", net, "cpu")(torch.from_numpy(img))
        score = whdr_batch(q / 255.0, torch.from_numpy(comps)).item()
        refl = pipeline_fn("cnn", net, "cpu")(torch.from_numpy(img))
    j_refl, j_q = _jax_bf(params, img)
    j_score = float(j_whdr_batch((j_q / 255.0)[..., None],
                                 jnp.asarray(comps)))

    np.testing.assert_allclose(refl.numpy(), np.asarray(j_refl), rtol=0,
                               atol=1e-5)
    q, j_q = q.numpy(), np.asarray(j_q)
    assert q.shape == j_q.shape == (2, 48, 64)
    assert np.all(q == np.round(q)) and q.min() >= 0 and q.max() <= 255
    assert np.unique(q).size > 20               # the filter had real work
    assert np.abs(q - j_q).max() <= 1
    assert abs(score - j_score) <= 1e-3


def test_pipeline_kinds():
    """cnn, bf and gf are served; the bilateral grid (ROADMAP module item
    9) is an approximate CLI mode, never a serving pipeline."""
    net = ReflectanceNet()
    for kind in ("cnn", "bf", "gf"):
        assert callable(pipeline_fn(kind, net, "cpu"))
    with pytest.raises(ValueError, match="bilateral_grid"):
        pipeline_fn("bilateral_grid", net, "cpu")
    with pytest.raises(ValueError):
        pipeline_fn("nope", net, "cpu")


@pytest.fixture(scope="module")
def photo_png(tmp_path_factory):
    d = tmp_path_factory.mktemp("photo")
    path = str(d / "photo.png")
    cv2.imwrite(path, np.moveaxis(_photos(SEED + 1, 1, 40, 52)[0], 0, -1))
    return path


def _run_port_clis(photo, out, model_path, monkeypatch):
    monkeypatch.setattr(tcio, "REFERENCE_CAFFEMODEL", model_path)
    tdec.main(["--filename_in", photo, "--path_out", out, "--device", "cpu"])
    r_png = os.path.join(out, "photo-r.png")
    tfilt.main(["--filter_type=bilateral", "--sigma_color=20",
                "--sigma_spatial=22", "--filename_in", r_png,
                "--guidance_in", r_png, "--path_out", out,
                "--device", "cpu"])


def test_clis_match_jax_clis(net_params, photo_png, tmp_path, monkeypatch):
    """The four files of decompose + filter bilateral c20 s22, written by
    the port's CLIs and by the JAX package's, within 1 level."""
    _, params = net_params
    model = tmp_path / "seeded.caffemodel"
    model.write_bytes(caffemodel_bytes(params))
    tout, jout = tmp_path / "port", tmp_path / "jax"
    tout.mkdir()
    jout.mkdir()
    _run_port_clis(photo_png, str(tout), str(model), monkeypatch)

    jnet = jdec.ReflectanceCNN.__new__(jdec.ReflectanceCNN)
    jnet.params = reference_params_from_caffe(params)
    jnet._packed = None
    jdec.decompose_image(photo_png, str(jout), net=jnet)
    j_r = str(jout / "photo-r.png")
    jfilt.read_filter_write("bilateral", j_r, j_r, 20.0, 22.0, str(jout))

    for suffix in BF_FILES:
        got = cv2.imread(str(tout / ("photo" + suffix)))
        exp = cv2.imread(str(jout / ("photo" + suffix)))
        assert got is not None and exp is not None, suffix
        assert got.shape == exp.shape
        assert np.abs(got.astype(int) - exp.astype(int)).max() <= 1, suffix


def test_decompose_images_batches_like_single(net_params, photo_png,
                                              tmp_path, capsys):
    _, params = net_params
    cnn = tdec.ReflectanceCNN(params=params, device="cpu")
    single = tdec.decompose_image(photo_png, str(tmp_path), net=cnn)
    out = tdec.decompose_images([photo_png, str(tmp_path / "none.png")],
                                str(tmp_path), net=cnn, batch_size=4)
    assert "was not possible" in capsys.readouterr().out
    np.testing.assert_array_equal(out[photo_png], single)


def test_cli_errors_and_help(capsys, tmp_path, photo_png):
    tfilt.main([])
    printed = capsys.readouterr().out
    assert "--filter_type=bilateral --sigma_color=20 --sigma_spatial=22" \
        in printed
    with pytest.raises(ValueError, match="expected to be positive"):
        tfilt.main(["--filter_type=bilateral", "--sigma_color=0",
                    "--sigma_spatial=22", "--filename_in", photo_png,
                    "--guidance_in", photo_png, "--path_out", str(tmp_path),
                    "--device", "cpu"])
    # the approximate grid runs now: its own output name and its caveat
    tfilt.main(["--filter_type=bilateral_grid", "--sigma_color=3",
                "--sigma_spatial=45", "--filename_in", photo_png,
                "--guidance_in", photo_png, "--path_out", str(tmp_path),
                "--device", "cpu"])
    assert "APPROXIMATE" in capsys.readouterr().err
    stem = os.path.splitext(os.path.basename(photo_png))[0]
    assert os.path.isfile(os.path.join(
        str(tmp_path), stem + "_bilateral_grid_c3.0s45.0.png"))
    if not torch.cuda.is_available():
        # --device defaults to cuda: without a card the CLIs stop and say
        # how to run on the CPU, never falling back quietly
        dec_args = ["--filename_in", photo_png, "--path_out", str(tmp_path)]
        filt_args = dec_args + ["--guidance_in", photo_png,
                                "--filter_type=bilateral",
                                "--sigma_color=20", "--sigma_spatial=22"]
        for main, args in ((tdec.main, dec_args), (tfilt.main, filt_args)):
            with pytest.raises(SystemExit):
                main(args)
            assert "--device cpu" in capsys.readouterr().err
