"""Port caffemodel converter (reflectance_filtering_tpu_torch/models/
caffe_io.py) against the JAX package's, on caffemodel bytes written here:
the new (NetParameter.layer) and the V1 (NetParameter.layers) format."""
import numpy as np
import pytest

from reflectance_filtering_tpu.models import caffe_io as jcio
from reflectance_filtering_tpu_torch.models import caffe_io as tcio
from reflectance_filtering_tpu_torch.models.networks import (
    seeded_reference_params)


def _pb_key(fnum, wtype):
    return _pb_varint((fnum << 3) | wtype)


def _pb_varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _pb_len(fnum, payload):
    return _pb_key(fnum, 2) + _pb_varint(len(payload)) + payload


def _blob(arr, legacy_shape=False):
    """BlobProto: shape as BlobShape (field 7) or as the legacy
    num/channels/height/width fields 1-4, data packed (field 5)."""
    arr = np.asarray(arr, "<f4")
    if legacy_shape:
        shape = b"".join(_pb_key(f, 0) + _pb_varint(d)
                         for f, d in zip((1, 2, 3, 4), arr.shape))
    else:
        shape = _pb_len(7, b"".join(_pb_key(1, 0) + _pb_varint(d)
                                    for d in arr.shape))
    return shape + _pb_len(5, arr.tobytes())


def caffemodel_bytes(params, v1=False, drop=()):
    """A NetParameter holding ``params`` (converter layout: HWIO kernels)
    as OIHW blobs, one layer per entry, in the new or the V1 format."""
    layers = b""
    for i, (name, p) in enumerate(params.items()):
        if name in drop:
            continue
        oihw = np.transpose(p["kernel"], (3, 2, 0, 1))
        bias = np.asarray(p["bias"]).reshape(1, 1, 1, -1)
        blobs = [_blob(oihw, legacy_shape=(i == 1)),
                 _blob(bias, legacy_shape=True)]
        if v1:
            # field 1 is the embedded V0LayerParameter, not the name
            body = (_pb_len(1, b"legacy-v0") + _pb_len(4, name.encode())
                    + b"".join(_pb_len(6, b) for b in blobs))
            layers += _pb_len(2, body)
        else:
            body = (_pb_len(1, name.encode()) + _pb_len(2, b"Convolution")
                    + b"".join(_pb_len(7, b) for b in blobs))
            layers += _pb_len(100, body)
    return _pb_len(1, b"seeded-net") + layers


@pytest.fixture(params=["new", "v1"])
def model_path(request, tmp_path):
    path = tmp_path / "seeded_{}.caffemodel".format(request.param)
    path.write_bytes(caffemodel_bytes(seeded_reference_params(11),
                                      v1=request.param == "v1"))
    return str(path)


def test_parse_bitwise_equal(model_path):
    got = tcio.parse_caffemodel(model_path)
    exp = jcio.parse_caffemodel(model_path)
    assert list(got) == list(exp) == [
        "conv0", "conv1", "conv2", "conv3", "conv4", "fuse_skip_layers"]
    for name in exp:
        assert len(got[name]) == len(exp[name]) == 2
        for g, e in zip(got[name], exp[name]):
            assert g.dtype == e.dtype and g.shape == e.shape
            np.testing.assert_array_equal(g, e)


def test_reference_weights_bitwise_and_round_trip(model_path):
    params = seeded_reference_params(11)
    got = tcio.load_reference_weights(model_path)
    exp = jcio.load_reference_weights(model_path)
    for name in params:
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][key], exp[name][key])
            np.testing.assert_array_equal(got[name][key], params[name][key])


def test_v1_name_is_field_4(model_path):
    # the V0 sub-message in field 1 must never be read as the name
    assert "legacy-v0" not in tcio.parse_caffemodel(model_path)


@pytest.mark.parametrize("broken", ["missing_layer", "wrong_width"])
def test_inventory_check_fires(broken, tmp_path):
    params = seeded_reference_params(2)
    drop = ()
    if broken == "missing_layer":
        drop = ("conv3",)
    else:
        params["conv4"] = {"kernel": params["conv4"]["kernel"][..., :16],
                           "bias": params["conv4"]["bias"][:16]}
    path = tmp_path / "broken.caffemodel"
    path.write_bytes(caffemodel_bytes(params, drop=drop))
    for mod in (tcio, jcio):
        with pytest.raises(ValueError, match="missing expected layers"
                           if drop else "4,513"):
            mod.load_reference_weights(str(path))
