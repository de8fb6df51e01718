"""The uNet cell (``train_unet_b20``): its work counts against a FLOP
counter on the reference, its files and readers found by name, its seeded
weights.  Its comparison on the CPU (a sound run passes it, the control
and every planted training fault fail it) is ``test_benchmark_reference``'s,
for every cell."""
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts_unet, harness
from benchmark.entries import train_unet
from benchmark.metrics import _shares, conv_roofline
from benchmark.profiling import Call
from benchmark.reference import unet as ref_unet

CELL = "train_unet_b20"


def _weights(seed=0):
    return train_unet.unet_weights(torch.Generator().manual_seed(seed),
                                   harness.Cell.load(CELL).config)


@pytest.mark.parametrize("frame", [(64, 64), (264, 272), (24, 32)])
def test_macs_match_a_flop_counter_on_the_reference(frame):
    """64x64 and 24x32 enlarge to the global stream's 256x256, 264x272
    shrinks to it: the global stream's count does not follow the frame."""
    x = torch.rand(1, *frame, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref_unet.estimate(_weights(), x, 2, 1)
    assert fc.get_total_flops() == 2 * counts_unet.forward_macs(*frame)


def test_counts_pinned():
    assert counts_unet.forward_macs(512, 512) == 4_373_176_320
    macs = dict(counts_unet.layer_macs(512, 512))
    assert macs["Conv4"] / sum(macs.values()) == pytest.approx(0.188,
                                                               abs=1e-3)
    assert counts_unet.train_step_flops(20, 512, 512) == pytest.approx(
        524.78e9, rel=1e-4)
    assert counts_unet.conv_bound_s(20, 512, 512) * 1e3 == pytest.approx(
        1.0608, rel=1e-4)


def test_manifest_entries_resolve_to_files_and_readers():
    spec = harness.manifest()
    cell = harness.Cell.load(CELL)
    assert cell.workload["chips"] == 1
    config = harness.by_name(spec["configs"], "unet_n2k3_512", "config")
    assert cell.config["reduced"] == config["reduced"]
    assert cell.config["network"]["macs_per_image"] == \
        counts_unet.forward_macs(512, 512)
    assert cell.entry() is train_unet
    limits = harness.load_json(os.path.join(
        harness.BENCH_DIR, "workloads", CELL + ".json"))
    assert set(limits["why"]) == set(limits["limits"]) == {
        "loss_gap", "grad_gap", "whdr_grad_gap", "change_gap", "moment_gap",
        "count_gap"}
    e2e = {m["name"] for m in harness.cell_metrics(spec, CELL, "end_to_end")}
    assert e2e == {"train_images_per_s", "setup_s"}
    layer = {m["name"]: m for m in harness.cell_metrics(spec, CELL,
                                                        "per_layer")}
    assert set(layer) == {"conv_roofline.train_unet", "mfu.train_unet",
                          "idle_share.train_unet", "glue_ms.train_unet"}
    for name, m in layer.items():
        assert harness.load_metric(name).LAYER == m["layer"]
        assert m["moves"] == "train_images_per_s"


def test_seeded_weights_have_the_ports_shapes():
    from reflectance_filtering_tpu_torch.models import networks
    cfg = networks.NetworkConfig(network_type="uNet", num_layers=2,
                                 kernel_pad=1, rs_est_mode="rRelMax")
    port = networks.init_network(cfg)
    got = _weights()
    assert {n: {k: v.shape for k, v in p.items()} for n, p in got.items()} \
        == {n: {k: v.shape for k, v in p.items()} for n, p in port.items()}
    assert all(float(p["bias"].abs().max()) == 0 for p in got.values())


def _call(start, events, span):
    return Call([(n, start + s, start + e) for n, s, e in events], start,
                span)


def test_readers_on_a_made_up_trace():
    cell = harness.Cell.load(CELL)
    names = [("sm80_xmma_fprop_implicit_gemm_f32f32", 0, 30),
             ("void wgrad_alg0_engine_NHWC<float>", 30, 50),
             ("void cudnn::engines_precompiled::nhwcToNchwKernel", 50, 55),
             ("void fft2d_r2c_32x32<float>", 55, 60),
             ("void at::native::elementwise_kernel<add>", 60, 70),
             ("Memset (Unknown)", 70, 71)]
    calls = [_call(t, names, 80) for t in (0, 100)]
    window = {"wall_s": 1.0, "requests": 10,
              "model_flops": counts_unet.train_step_flops(20, 512, 512),
              "conv_bound_s": counts_unet.conv_bound_s(20, 512, 512)}
    run = harness.Run(cell.config, cell.traffic, window, calls, 1)
    bound = counts_unet.conv_bound_s(20, 512, 512)
    read = {m: harness.load_metric(m).read(run)
            for m in ("conv_roofline.train_unet", "glue_ms.train_unet",
                      "idle_share.train_unet", "mfu.train_unet")}
    assert read["conv_roofline.train_unet"] == pytest.approx(
        100 * bound / 60e-6)
    # the bound the reader computed from the cell's files before the
    # entry gave it, bit for bit
    net, traffic = cell.config["network"], cell.traffic
    assert read["conv_roofline.train_unet"] == _shares.roofline(
        run, conv_roofline.KERNELS, counts_unet.conv_bound_s(
            traffic["batch"], traffic["height"], traffic["width"],
            net["num_layers"], 2 * net["kernel_pad"] + 1))
    assert read["glue_ms.train_unet"] == pytest.approx(11e-3)
    assert read["idle_share.train_unet"] == pytest.approx(100 * 9 / 80)
    assert read["mfu.train_unet"] == pytest.approx(
        100 * window["model_flops"] / (0.1 * 494.7e12))
    window["convs_per_step"] = 5
    with pytest.raises(RuntimeError, match="convolutions"):
        harness.load_metric("conv_roofline.train_unet").read(run)
    del window["conv_bound_s"]
    assert harness.load_metric("conv_roofline.train_unet").read(run) is None
    empty = harness.Run(cell.config, cell.traffic, window, None, 1)
    assert harness.load_metric("conv_roofline.train_unet").read(empty) \
        is None
    assert harness.load_metric("glue_ms.train_unet").read(empty) is None


def test_window_gives_the_conv_bound_of_its_sizes(small_cell):
    """The entry's window carries its convolutions' bound at the cell's
    batch, frame and network (``conv_roofline`` reads it)."""
    cell = small_cell(CELL)
    session = train_unet.Session(cell.config, cell.traffic, 2 ** 31 + 3,
                                 torch.device("cpu"))
    got = session.window(0.1)
    net, traffic = cell.config["network"], cell.traffic
    assert got["conv_bound_s"] == counts_unet.conv_bound_s(
        traffic["batch"], traffic["height"], traffic["width"],
        net["num_layers"], 2 * net["kernel_pad"] + 1)
