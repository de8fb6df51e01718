"""The port's serving export (reflectance_filtering_tpu_torch/utils/
serving.py: export_flagship, load_flagship, main) and the three operators
it records (rf::cnn_fwd, rf::bilateral_gray_self, rf::guided_filter), on
the CPU, on seeded weights (the trained model is not in the repository).

Gates: an artifact is bitwise its direct call (``pipeline_fn`` on the same
batch); against the JAX package's own ``jax.export`` artifacts of the same
seeded caffemodel, bf and gf within 1 uint8 level, cnn as the JAX test's
gate (tests/test_serving.py): ``floor(r*255)`` within 1 level on < 0.1% of
pixels.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu.models import caffe_io as jcio
from reflectance_filtering_tpu.utils import serving as jserving
from reflectance_filtering_tpu_torch.cli.decompose import decompose_planar
from reflectance_filtering_tpu_torch.models.networks import (
    ReflectanceNet, params_from_numpy, seeded_reference_params)
from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
    NUM_WEIGHTS, pack_weights)
from reflectance_filtering_tpu_torch.utils import serving
from reflectance_filtering_tpu_torch.utils.testimages import pink_noise

from test_torch_caffe_io import caffemodel_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
KINDS = ("cnn", "bf", "gf")
BATCH, HEIGHT, WIDTH = 2, 72, 80
SYMBOLIC_SHAPES = ((1, 3, 24, 32), (2, 3, 40, 56))
# the operator each pipeline records, besides K1's
OPS = {"cnn": {"rf.cnn_fwd"},
       "bf": {"rf.cnn_fwd", "rf.bilateral_gray_self"},
       "gf": {"rf.cnn_fwd", "rf.guided_filter"}}


def _photos(seed, shape):
    """uint8 BGR planar photos: 1/f noise with a shared luminance."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape
    out = np.empty(shape, np.uint8)
    for i in range(n):
        lum = pink_noise(rng, h, w)
        for k in range(c):
            out[i, k] = np.clip(0.6 * lum + 0.4 * pink_noise(rng, h, w),
                                0, 255)
    return out


def _rf_ops(path):
    """The rf:: operators an artifact's graph calls; checks on the way that
    the artifact holds no example batch."""
    program = torch.export.load(path)
    assert program.example_inputs is None
    return {"{}.{}".format(node.target.namespace,
                           node.target._opname)
            for node in program.graph.nodes if node.op == "call_function"
            and getattr(node.target, "namespace", None) == "rf"}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(seeded caffemodel path, the same weights as a ReflectanceNet)."""
    params = seeded_reference_params(SEED)
    path = tmp_path_factory.mktemp("model") / "seeded.caffemodel"
    path.write_bytes(caffemodel_bytes(params))
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(params))
    return str(path), net


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """kind -> (path, byte size) of the port's CPU artifacts, the symbolic
    cnn one under "symbolic"."""
    folder = tmp_path_factory.mktemp("artifacts")
    out = {}
    for kind in KINDS:
        path = str(folder / "{}.pt2".format(kind))
        out[kind] = (path, serving.export_flagship(
            path, BATCH, HEIGHT, WIDTH, device="cpu", pipeline=kind,
            weights_path=model[0]))
    path = str(folder / "any.pt2")
    out["symbolic"] = (path, serving.export_flagship(
        path, 0, 0, 0, device="cpu", symbolic=True, weights_path=model[0]))
    return out


@pytest.fixture(scope="module")
def batch():
    return torch.from_numpy(_photos(SEED, (BATCH, 3, HEIGHT, WIDTH)))


def _op_cases():
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.rand(2, 3, 57).astype(np.float32))
    w = torch.from_numpy(rng.randn(NUM_WEIGHTS).astype(np.float32) * 0.2)
    levels = torch.from_numpy((rng.rand(2, 19, 23) * 255).astype(np.uint8))
    guide = torch.from_numpy((rng.rand(2, 3, 17, 21) * 255).astype(
        np.float32))
    src = torch.from_numpy((rng.rand(2, 4, 17, 21) * 255).astype(np.float32))
    return {
        "cnn_srgb": ("cnn_fwd", (x, w, True)),
        "cnn_linear": ("cnn_fwd", (x, w, False)),
        "bilateral_u8": ("bilateral_gray_self", (levels, -1, 20.0, 3.0, 3)),
        "bilateral_f32": ("bilateral_gray_self",
                          (levels.to(torch.float32), 5, 20.0, 3.0, 1)),
        "guided_c1": ("guided_filter", (guide, src[:, :1].contiguous(), 4,
                                        3.0, "auto", 0)),
        "guided_c4": ("guided_filter", (guide, src, 9, 7.0, "fused", 16)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_ops_pass_opcheck(case):
    """Each operator's schema, fake (meta) implementation and dispatch
    under fake tensors and symbolic shapes (torch.library.opcheck)."""
    name, args = _op_cases()[case]
    results = torch.library.opcheck(getattr(torch.ops.rf, name).default,
                                    args)
    assert set(results.values()) == {"SUCCESS"}, results


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_artifact_is_bitwise_the_direct_call(kind, model, artifacts,
                                                 batch):
    path, size = artifacts[kind]
    assert size == os.path.getsize(path) and size > 10_000
    assert _rf_ops(path) == OPS[kind]
    got = serving.load_flagship(path)(batch)
    with torch.no_grad():
        exp = serving.pipeline_fn(kind, model[1], "cpu")(batch)
    assert got.shape == (BATCH, HEIGHT, WIDTH) and got.dtype == torch.float32
    assert torch.equal(got, exp)
    if kind != "cnn":
        assert torch.equal(got, torch.round(got))
        assert got.min() >= 0 and got.max() <= 255
        assert torch.unique(got).numel() > 20     # the filter had real work


def _jax_artifact(monkeypatch, model_path, path, **kw):
    monkeypatch.setattr(jcio, "_REFERENCE_CAFFEMODEL", model_path)
    jserving.export_flagship(path, platforms=("cpu",), **kw)
    return jserving.load_flagship(path)


def _cnn_gate(got, exp):
    d = np.abs(np.floor(got * 255.0) - np.floor(exp * 255.0))
    assert d.max() <= 1 and (d > 0).mean() < 0.001, (d.max(),
                                                      (d > 0).mean())


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_artifact_matches_the_jax_artifact(kind, model, artifacts, batch,
                                               tmp_path, monkeypatch):
    fn = _jax_artifact(monkeypatch, model[0], str(tmp_path / "j.rfx"),
                       batch=BATCH, height=HEIGHT, width=WIDTH,
                       pipeline=kind)
    exp = np.asarray(fn(jnp.asarray(batch.numpy())))
    got = serving.load_flagship(artifacts[kind][0])(batch).numpy()
    assert got.shape == exp.shape == (BATCH, HEIGHT, WIDTH)
    if kind == "cnn":
        _cnn_gate(got, exp)
    else:
        assert np.abs(got - exp).max() <= 1


def test_symbolic_artifact_serves_any_shape(model, artifacts, tmp_path,
                                            monkeypatch):
    """One artifact at two shapes: bitwise the port's direct call, and
    within the cnn gate of the JAX package's symbolic artifact."""
    path, size = artifacts["symbolic"]
    assert size > 10_000 and _rf_ops(path) == OPS["cnn"]
    fn = serving.load_flagship(path)
    jfn = _jax_artifact(monkeypatch, model[0], str(tmp_path / "j.rfx"),
                        batch=0, height=0, width=0, pipeline="cnn",
                        symbolic=True)
    weights = pack_weights(model[1])
    for i, shape in enumerate(SYMBOLIC_SHAPES):
        x = torch.from_numpy(_photos(SEED + 1 + i, shape))
        got = fn(x)
        assert got.shape == (shape[0],) + shape[2:]
        assert torch.equal(got, decompose_planar(weights, x))
        _cnn_gate(got.numpy(), np.asarray(jfn(jnp.asarray(x.numpy()))))


def test_params_export_the_caffemodels_model(artifacts, batch, tmp_path):
    """``params`` (the converter's numpy layout) in place of a caffemodel
    gives the same artifact's outputs."""
    path = str(tmp_path / "params.pt2")
    serving.export_flagship(path, BATCH, HEIGHT, WIDTH, device="cpu",
                            params=seeded_reference_params(SEED))
    assert torch.equal(serving.load_flagship(path)(batch),
                       serving.load_flagship(artifacts["cnn"][0])(batch))


@pytest.mark.parametrize("kind", ["bf", "gf"])
def test_symbolic_export_takes_cnn_only(kind, model, tmp_path):
    with pytest.raises(ValueError, match="cnn"):
        serving.export_flagship(str(tmp_path / "nope.pt2"), 0, 0, 0,
                                device="cpu", pipeline=kind, symbolic=True,
                                weights_path=model[0])
    with pytest.raises(ValueError, match="unknown pipeline"):
        serving.export_flagship(str(tmp_path / "nope.pt2"), 1, 8, 8,
                                device="cpu", pipeline="bilateral_grid",
                                weights_path=model[0])


def test_fixed_artifact_refuses_other_shapes(artifacts):
    fn = serving.load_flagship(artifacts["bf"][0])
    with pytest.raises((AssertionError, RuntimeError)):
        fn(torch.zeros((BATCH + 1, 3, HEIGHT, WIDTH), dtype=torch.uint8))


def test_main_writes_an_artifact(model, tmp_path, capsys, monkeypatch):
    from reflectance_filtering_tpu_torch.models import caffe_io as tcio
    monkeypatch.setattr(tcio, "REFERENCE_CAFFEMODEL", model[0])
    out = str(tmp_path / "f.pt2")
    serving.main(["--out", out, "--batch", "1", "--height", "24",
                  "--width", "32", "--pipeline", "gf", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.startswith("wrote " + out) and "pipeline: gf" in printed
    assert "({} bytes".format(os.path.getsize(out)) in printed
    assert _rf_ops(out) == OPS["gf"]


def test_cuda_export_never_writes_a_cpu_artifact(model, tmp_path, capsys,
                                                monkeypatch):
    """The card is the default; without one, the function raises and the
    CLI exits asking for --device cpu, and no file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "f.pt2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.export_flagship(out, 1, 8, 8, weights_path=model[0])
    with pytest.raises(SystemExit):
        serving.main(["--out", out])
    assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists(out)


_CONSUMER = r"""
import json, sys
import torch
from reflectance_filtering_tpu_torch.utils.serving import load_flagship
fn = load_flagship(sys.argv[1])
torch.save(fn(torch.load(sys.argv[2])), sys.argv[3])
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "reflectance_filtering_tpu"))))
"""


def test_a_consumer_needs_no_jax(model, artifacts, batch, tmp_path):
    """A fresh process that imports only the serving module loads and runs
    an artifact, bitwise the direct call, with no JAX imported."""
    inp, out = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    torch.save(batch, inp)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CONSUMER, artifacts["bf"][0], inp, out],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with torch.no_grad():
        exp = serving.pipeline_fn("bf", model[1], "cpu")(batch)
    assert torch.equal(torch.load(out), exp)
