"""The plain reference against the port's CPU twins at small sizes, and
the comparison that decides ``correct``: sound runs pass it, the control
and every planted fault fail it (each cell cut to a CPU's size)."""
import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import filters, flagship, train, whdr
from benchmark.traffic import generate
from reflectance_filtering_tpu_torch.losses import whdr as port_whdr
from reflectance_filtering_tpu_torch.ops import guided as port_guided
from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
    bilateral_gray_self_plain)
from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
    reflectance_cnn_plain)
from reflectance_filtering_tpu_torch.ops.guided_chain_kernel import (
    guided_filter_chain_plain)

CPU = torch.device("cpu")


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(2 ** 31 + 77)


def test_flagship_matches_the_port(gen):
    layers = generate.flagship_weights(gen)
    photos = generate.device_photos(gen, 2, 24, 32)
    flat = torch.cat([t.reshape(-1) for pair in layers for t in pair])
    x = photos.flip(1).reshape(2, 3, -1) / 255.0
    want = reflectance_cnn_plain(x, flat, srgb_input=True).reshape(2, 24, 32)
    got = flagship.reflectance(layers, photos)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    low = flagship.reflectance(layers, photos, low=True)
    assert (low - want).abs().max() > 1e-5


def test_bilateral_matches_the_port(gen):
    levels = generate.device_photos(gen, 2, 30, 26)[:, 0]
    want = bilateral_gray_self_plain(levels.to(torch.uint8), -1, 20.0, 22.0,
                                     reps=3)
    got = filters.bilateral_gray(levels, 20.0, 22.0)
    # the port sums 3,409 taps in float32, the reference in float64
    assert (got - want.double()).abs().max() < 2e-3


@pytest.mark.parametrize("iterations", [1, 3])
def test_guided_matches_the_port(gen, iterations):
    guide = generate.device_photos(gen, 1, 50, 61)
    src = generate.pink_planes(gen, 1, 50, 61)
    if iterations == 1:
        want = port_guided.guided_filter_planar(guide, src, 45, 3.0)
    else:
        want = guided_filter_chain_plain(guide, src, 45, 3.0, iterations)
    got = filters.guided_chain(guide, src, 45, 3.0, iterations)
    assert (got - want.double()).abs().max() < 2e-3


def test_whdr_and_hinge_match_the_port(gen):
    plane = torch.rand((3, 20, 24), generator=gen)
    comps = generate.comparisons(gen, 3, 50)
    assert torch.allclose(whdr.whdr(plane, comps),
                          port_whdr.whdr_per_image(plane, comps),
                          rtol=0, atol=1e-7)
    assert torch.allclose(whdr.hinge(plane, comps),
                          port_whdr.whdr_hinge_batch(plane, comps,
                                                     0.1, 0.05),
                          rtol=1e-6, atol=1e-8)


def test_train_step_matches_its_autograd(gen):
    params = generate.training_weights(gen)
    images = torch.rand((2, 6, 8, 3), generator=gen)
    comps = generate.comparisons(gen, 2, 30)
    (value, first, after, state), = train.adam_steps(
        params, [(images, comps)], 1e-3)
    moved = after["conv1"]["kernel"] - params["conv1"]["kernel"]
    # Adam's first step moves each weight by lr against its gradient's sign
    g = first["conv1"]["kernel"]
    big = g.abs() > 1e-4
    assert big.any()
    assert torch.allclose(moved[big], -1e-3 * g.sign()[big], rtol=1e-3)
    assert value == pytest.approx(float(train.loss(params, images, comps)))
    assert state["count"] == 1
    assert torch.allclose(state["mu"]["conv1"]["kernel"], 0.1 * g)


CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _run(cell, name, seed):
    return harness.run_cell(name, seed, 0.3, False, CPU, 0.0, cell=cell)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_its_line_has_the_keys(small_cell, name):
    out = _run(small_cell(name), name, 2 ** 31 + 5)
    assert list(out) == ["attempted", "failed", "correct", "metrics",
                         "device", "checks"]
    assert out["correct"], out["checks"]
    e2e = {m["name"] for m in harness.cell_metrics(
        harness.manifest(), name, "end_to_end")}
    assert set(out["metrics"]) == e2e
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_cell, name):
    """The reference one precision step lower, in the program's place."""
    cell = small_cell(name)
    entry = cell.entry()
    session = entry.Session(cell.config, cell.traffic, 2 ** 31 + 9, CPU)
    session.window(0.2)
    got = session.release()
    control = entry.control_outputs(cell.config, cell.traffic,
                                    got["inputs"], got["outputs"], CPU)
    readings = entry.judge(cell.config, cell.traffic, got["inputs"],
                           control, CPU)
    assert any(readings[k] > v for k, v in cell.limits.items()), readings


def _entry(name):
    return harness.Cell.load(name).traffic["entry"]


FAULTS = [(name, fault) for name in CELLS
          for fault in harness.load_entry(_entry(name)).FAULTS]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_planted_fault_is_not_correct(small_cell, name, fault):
    cell = small_cell(name)
    with faults.plant(cell.traffic["entry"], fault):
        out = _run(cell, name, 2 ** 31 + 11)
    assert not out["correct"], out["checks"]


def _program_state():
    """The id of each attribute of the program's loaded modules and of
    their classes."""
    import sys
    state = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("reflectance_filtering_tpu_torch."):
            continue
        for key, value in list(vars(module).items()):
            state[name, key] = id(value)
            if isinstance(value, type):
                for attr, v in vars(value).items():
                    state[name, key, attr] = id(v)
    return state


@pytest.mark.parametrize("entry, fault", sorted(
    {(_entry(name), fault) for name, fault in FAULTS}))
def test_each_declared_fault_plants(entry, fault):
    """Each fault an entry declares patches the program while it is open
    and leaves it as it was after."""
    with faults.plant(entry, fault):
        pass                        # loads the modules it patches
    before = _program_state()
    with faults.plant(entry, fault):
        inside = _program_state()
    assert _program_state() == before
    assert inside != before, "the fault patched nothing"


def test_an_undeclared_fault_is_refused():
    with pytest.raises(ValueError, match="no fault 'no_such_fault'"):
        faults.plant(_entry(CELLS[0]), "no_such_fault")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_line_has_the_keys(cuda_device, name):
    out = harness.run_cell(name, 2 ** 31 + 13, 1.0, True, cuda_device, 0.0)
    assert list(out) == ["attempted", "failed", "breakdown", "correct",
                         "metrics", "device", "checks"]
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", ["serve_bf_b32", "serve_gf_b32"])
def test_few_bytes_far_off_are_not_correct(gen, name):
    """A garbled 4x4 patch is 2.4e-4 of a 256x256 image's bytes, under
    the share of bytes that may differ by a level: the mean gap counts
    each byte by how far it is off."""
    from unittest import mock

    cell = harness.Cell.load(name)
    serve = cell.entry()
    ref = torch.randint(0, 156, (2, 256, 256), generator=gen,
                        dtype=torch.uint8)
    comps = generate.comparisons(gen, 2, 50)
    bad = ref.clone()
    bad[:, 100:104, 60:64] += 100
    scores = whdr.whdr(bad.to(torch.float32) / 255.0, comps)
    with mock.patch.object(serve, "reference_outputs",
                           lambda *a, **k: (ref, None)):
        got = serve.judge(cell.config, cell.traffic, {"comps": [comps]},
                          [(0, bad, scores)], CPU)
    assert (bad != ref).float().mean() < cell.limits["level_mean_gap"]
    assert got["level_mean_gap"] > cell.limits["level_mean_gap"]
