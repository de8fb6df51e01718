"""The pix2pix cell (``train_p2p_b20``): its work counts against a FLOP
counter on the reference, its files and readers found by name, its seeded
weights, and what its comparison catches besides the planted faults.  Its
comparison on the CPU (a sound run passes it, the control and every
planted training fault fail it) is ``test_benchmark_reference``'s, for
every cell."""
import copy
import os
import re

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts_pix2pix, harness
from benchmark.entries import train_p2p
from benchmark.metrics import conv_roofline, norm_roofline
from benchmark.profiling import Call
from benchmark.reference import pix2pix as ref_p2p

CELL = "train_p2p_b20"
CPU = torch.device("cpu")


def _weights(config, seed=0):
    return train_p2p.p2p_weights(torch.Generator().manual_seed(seed), config)


@pytest.mark.parametrize("num_downs, ngf, frame", [(5, 4, 32), (6, 8, 64),
                                                   (8, 4, 256)])
def test_macs_match_a_flop_counter_on_the_reference(num_downs, ngf, frame):
    config = {"network": {"num_downs": num_downs, "ngf": ngf}}
    x = torch.rand(1, frame, frame, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref_p2p.forward(_weights(config), x)
    assert fc.get_total_flops() == 2 * counts_pix2pix.forward_macs(
        frame, frame, num_downs, ngf)


def test_counts_pinned():
    assert counts_pix2pix.forward_macs(256, 256) == 5_981_077_504
    macs = dict(counts_pix2pix.layer_macs(256, 256))
    total = sum(macs.values())
    ups = macs["up4"] + macs["up3"] + macs["up2"]
    assert ups / total == pytest.approx(0.5385, abs=1e-4)
    assert counts_pix2pix.train_step_flops(20, 256, 256) == pytest.approx(
        717.73e9, rel=1e-5)
    assert counts_pix2pix.conv_bound_s(20, 256, 256) * 1e3 == pytest.approx(
        1.4508, rel=1e-4)
    assert counts_pix2pix.norm_elements(256, 256) == 2_969_600
    assert counts_pix2pix.norm_bound_s(20, 256, 256) * 1e3 == pytest.approx(
        0.35458, rel=1e-4)


def test_norm_elements_are_the_reference_batch_norms(monkeypatch):
    """norm_elements counts what the reference's batch norms normalise."""
    config = {"network": {"num_downs": 6, "ngf": 4}}
    seen, norm = [], ref_p2p._batch_norm

    def counted(x, p):
        seen.append(x.numel())
        return norm(x, p)
    monkeypatch.setattr(ref_p2p, "_batch_norm", counted)
    with torch.no_grad():
        ref_p2p.forward(_weights(config), torch.rand(1, 64, 64, 3))
    assert len(seen) == 2 * 6 - 3
    assert sum(seen) == counts_pix2pix.norm_elements(64, 64, 6, 4)


def test_manifest_entries_resolve_to_files_and_readers():
    spec = harness.manifest()
    cell = harness.Cell.load(CELL)
    assert cell.workload["chips"] == 1
    config = harness.by_name(spec["configs"], "pix2pix_unet256", "config")
    assert cell.config["reduced"] == config["reduced"]
    assert len(config["source"]) <= 200
    net = cell.config["network"]
    assert (net["num_downs"], net["ngf"]) == (8, 64)
    assert net["macs_per_image"] == counts_pix2pix.forward_macs(256, 256)
    assert net["parameters"] == sum(
        torch.Size(s).numel() for q in ref_p2p.param_shapes(8, 64).values()
        for k, s in q.items() if k not in ref_p2p.RUNNING)
    assert cell.entry() is train_p2p
    assert (cell.traffic["batch"], cell.traffic["images"],
            cell.traffic["height"], cell.traffic["width"]) == (20, 120, 256,
                                                               256)
    limits = harness.load_json(os.path.join(
        harness.BENCH_DIR, "workloads", CELL + ".json"))
    assert set(limits["why"]) == set(limits["limits"]) == {
        "loss_gap", "grad_gap", "change_gap", "moment_gap", "count_gap",
        "bn_stats_gap"}
    e2e = {m["name"] for m in harness.cell_metrics(spec, CELL, "end_to_end")}
    assert e2e == {"train_images_per_s", "setup_s"}
    layer = {m["name"]: m for m in harness.cell_metrics(spec, CELL,
                                                        "per_layer")}
    assert set(layer) == {"conv_roofline.train_p2p", "mfu.train_p2p",
                          "idle_share.train_p2p", "glue_ms.train_p2p",
                          "norm_roofline.train_p2p"}
    for name, m in layer.items():
        assert harness.load_metric(name).LAYER == m["layer"]
        assert m["moves"] == "train_images_per_s"
        assert m["workloads"] == [CELL]


def test_seeded_weights_have_the_ports_shapes_and_init():
    from reflectance_filtering_tpu_torch.models import networks
    cell = harness.Cell.load(CELL)
    got = _weights(cell.config)
    port = networks.init_network(networks.NetworkConfig(
        network_type="pix2pixUnet", num_layers=8, num_filters_log=6,
        rs_est_mode="rRelMax"))
    assert {n: {k: v.shape for k, v in p.items()} for n, p in got.items()} \
        == {n: {k: v.shape for k, v in p.items()} for n, p in port.items()}
    kernels = torch.cat([q["kernel"].reshape(-1) for q in got.values()
                         if "kernel" in q])
    assert abs(float(kernels.std()) - 0.02) < 1e-4
    for name, q in got.items():
        if name.endswith("_bn"):
            assert abs(float(q["gamma"].mean()) - 1.0) < 1e-2
            assert float(q["beta"].abs().max()) == 0
            assert float(q["mean"].abs().max()) == 0
            assert float((q["var"] - 1).abs().max()) == 0
    assert float(got["up1"]["bias"].abs().max()) == 0


def _call(start, events, span):
    return Call([(n, start + s, start + e) for n, s, e in events], start,
                span)


def test_readers_on_a_made_up_trace():
    """The batch norms' kernels are ATen's, which no convolution pattern
    matches: conv_roofline and norm_roofline read disjoint kernels."""
    cell = harness.Cell.load(CELL)
    names = [("sm90_xmma_fprop_implicit_gemm_f32f32", 0, 30),
             ("void dgrad2d_alg1_1<float, 0, 6, 7, 5, 4, 5>", 30, 50),
             ("void at::native::batch_norm_collect_statistics_channels_last"
              "_kernel<at::native::Var, float, float, float, 4>", 50, 54),
             ("void at::native::batch_norm_transform_input_channels_last"
              "_kernel<float, float, float, 4>", 54, 56),
             ("void at::native::batch_norm_backward_reduce_channels_last"
              "_kernel<4, float, float, float>", 56, 60),
             ("void at::native::elementwise_kernel<add>", 60, 70),
             ("Memset (Unknown)", 70, 71)]
    assert not any(any(re.search(p, n)
                       for p in conv_roofline.KERNELS)
                   for n, _, _ in names[2:5])
    calls = [_call(t, names, 80) for t in (0, 100)]
    sizes = (20, 256, 256)
    window = {"wall_s": 1.0, "requests": 10,
              "model_flops": counts_pix2pix.train_step_flops(*sizes),
              "conv_bound_s": counts_pix2pix.conv_bound_s(*sizes),
              "norm_bound_s": counts_pix2pix.norm_bound_s(*sizes)}
    run = harness.Run(cell.config, cell.traffic, window, calls, 1)
    read = {m: harness.load_metric(m).read(run)
            for m in ("conv_roofline.train_p2p", "norm_roofline.train_p2p",
                      "glue_ms.train_p2p", "idle_share.train_p2p",
                      "mfu.train_p2p")}
    assert read["conv_roofline.train_p2p"] == pytest.approx(
        100 * counts_pix2pix.conv_bound_s(*sizes) / 50e-6)
    assert read["norm_roofline.train_p2p"] == pytest.approx(
        100 * counts_pix2pix.norm_bound_s(*sizes) / 10e-6)
    assert read["glue_ms.train_p2p"] == pytest.approx(21e-3)
    assert read["idle_share.train_p2p"] == pytest.approx(100 * 9 / 80)
    assert read["mfu.train_p2p"] == pytest.approx(
        100 * window["model_flops"] / (0.1 * 494.7e12))
    window["norms_per_step"] = 4
    with pytest.raises(RuntimeError, match="batch norms"):
        harness.load_metric("norm_roofline.train_p2p").read(run)
    window["norms_per_step"] = 3
    assert harness.load_metric("norm_roofline.train_p2p").read(run) \
        == read["norm_roofline.train_p2p"]
    del window["norm_bound_s"]
    assert harness.load_metric("norm_roofline.train_p2p").read(run) is None
    empty = harness.Run(cell.config, cell.traffic, window, None, 1)
    assert norm_roofline.read(empty) is None


def test_window_gives_its_bounds(small_cell):
    """The entry's window carries its convolutions' and batch norms' bounds
    at the cell's batch, frame and network."""
    cell = small_cell(CELL)
    session = train_p2p.Session(cell.config, cell.traffic, 2 ** 31 + 3, CPU)
    got = session.window(0.1)
    net, traffic = cell.config["network"], cell.traffic
    sizes = (traffic["batch"], traffic["height"], traffic["width"],
             net["num_downs"], net["ngf"])
    assert got["conv_bound_s"] == counts_pix2pix.conv_bound_s(*sizes)
    assert got["norm_bound_s"] == counts_pix2pix.norm_bound_s(*sizes)
    assert got["model_flops"] == counts_pix2pix.train_step_flops(*sizes)


def _sound(small_cell, seed):
    cell = small_cell(CELL)
    session = train_p2p.Session(cell.config, cell.traffic, seed, CPU)
    session.window(0.1)
    return cell, session.release()


@pytest.mark.parametrize("how", ["stale", "biased"])
def test_running_statistics_off_the_rule_are_not_correct(small_cell, how):
    """Running statistics left as they were, or moved with the batch's
    biased variance, fail ``bn_stats_gap`` alone."""
    cell, got = _sound(small_cell, 2 ** 31 + 17)
    readings = train_p2p.judge(cell.config, cell.traffic, got["inputs"],
                               got["outputs"], CPU)
    assert all(readings[k] <= v for k, v in cell.limits.items()), readings
    outputs = copy.deepcopy(got["outputs"])
    before = got["inputs"]["params0"]
    bs = cell.traffic["batch"]
    for t, (after, _) in enumerate(outputs["states"]):
        for name, q in after.items():
            if not name.endswith("_bn"):
                continue
            if how == "stale":
                prior = before if t == 0 else got["outputs"]["states"][
                    t - 1][0]
                q["mean"] = prior[name]["mean"].clone()
                q["var"] = prior[name]["var"].clone()
            else:
                # the move of the variance by the biased rule: the batch's
                # unbiased variance times (m - 1) / m, m its elements a
                # channel
                prior = before if t == 0 else got["outputs"]["states"][
                    t - 1][0]
                size = _map_elements(cell, name) * bs
                batch = (q["var"] - 0.9 * prior[name]["var"]) / 0.1
                q["var"] = 0.9 * prior[name]["var"] + 0.1 * batch * (
                    size - 1) / size
    bad = train_p2p.judge(cell.config, cell.traffic, got["inputs"], outputs,
                          CPU)
    failed = {k for k, v in cell.limits.items() if bad[k] > v}
    assert failed == {"bn_stats_gap"}, bad


def _map_elements(cell, name):
    """A batch norm's pixels an image at the cell's frame."""
    h = cell.traffic["height"]
    level = int(name[len("down"):-3]) if name.startswith("down") else int(
        name[len("up"):-3]) - 1
    return (h >> level) ** 2


def test_band_takes_out_a_flip_and_nothing_else(monkeypatch):
    """A ReLU input that float32 may put on either side of 0 adds or drops
    its gradient: ``undetermined`` gives that gradient as a row, and
    ``gradient_gaps`` discounts a move along it but not another move of
    the same size.  (A wide rounding makes inputs undetermined at this
    size.)"""
    from benchmark.reference import unet as ref_unet
    config = {"network": {"num_downs": 5, "ngf": 4}}
    gen = torch.Generator().manual_seed(7)
    params = _weights(config, 7)
    images = torch.rand(4, 32, 32, 3, generator=gen)
    comps = torch.zeros(4, 2, 6)
    monkeypatch.setattr(ref_p2p, "BAND_ROUNDING", 1e9)
    band = ref_p2p.undetermined(params, images, comps)
    assert len(band[0]) == ref_p2p.BAND_SITES
    _, want, _ = ref_p2p.gradient({a: {k: v.double() for k, v in q.items()}
                                   for a, q in params.items()},
                                  images.double(), comps.double())
    keys = ref_p2p.trainable(params)
    sizes = [want[a][k].numel() for a, k in keys]

    def moved(direction):
        parts = direction.split(sizes)
        out = {}
        for (a, k), part in zip(keys, parts):
            out.setdefault(a, {})[k] = want[a][k] + part.view_as(want[a][k])
        return out

    row = band[0][0]
    scale = max(float(v.norm()) for q in want.values() for v in q.values())
    step = row * (scale / float(row.norm()))
    assert max(ref_unet.gradient_gaps(moved(step), want, band).values()) \
        < 1e-9
    other = torch.randn(row.shape, generator=gen, dtype=torch.float64)
    other = other * (scale / float(other.norm()))
    assert max(ref_unet.gradient_gaps(moved(other), want, band).values()) \
        > 0.1
