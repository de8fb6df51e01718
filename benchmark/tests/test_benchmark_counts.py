"""The work counts against independent counts, and the readers'
arithmetic on a made-up trace."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness
from benchmark.profiling import Call, breakdown, kept
from benchmark.reference import flagship
from benchmark.traffic import generate

SERVED_PIXELS = 32 * 256 * 256
STEP_PIXELS = 20 * 256 * 256
FRAME_PIXELS = 2160 * 3840


def test_disk_taps_match_a_count_over_the_square():
    for radius in (1, 5, 33, 45):
        dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
        assert counts.disk_taps(radius) == int(
            (dy * dy + dx * dx <= radius * radius).sum())
    assert counts.disk_taps(counts.bilateral_radius(22.0)) == 3409


def test_flagship_macs_match_a_flop_counter_on_the_reference():
    layers = generate.flagship_weights(torch.Generator().manual_seed(0))
    x = torch.rand(7, 3)
    with FlopCounterMode(display=False) as fc:
        flagship.trunk(layers, x)
    assert fc.get_total_flops() == 7 * 2 * counts.flagship_macs_per_pixel()
    assert counts.flagship_macs_per_pixel() == 4352


@pytest.mark.parametrize("name, got, want_ms", [
    ("k1", lambda: counts.k1_bound_s(SERVED_PIXELS), 0.036898),
    ("k2", lambda: counts.k2_bound_s(SERVED_PIXELS, 22.0), 0.427467),
    ("k5", lambda: counts.k5_bound_s(SERVED_PIXELS), 0.003542),
    ("k7_bwd", lambda: counts.k7_bwd_bound_s(STEP_PIXELS), 0.046124),
    ("k9", lambda: counts.k9_bound_s(FRAME_PIXELS, 3), 0.049519),
])
def test_bounds_pinned(name, got, want_ms):
    assert got() * 1e3 == pytest.approx(want_ms, rel=1e-4), name


def test_model_flops_pinned():
    assert counts.forward_flops(SERVED_PIXELS) == pytest.approx(18.254e9,
                                                                rel=1e-4)
    assert counts.train_step_flops(STEP_PIXELS) == pytest.approx(
        34.226e9, rel=1e-4)


def _call(start, events, span):
    return Call([(n, start + s, start + e) for n, s, e in events], start,
                span)


def test_trace_arithmetic_and_readers():
    calls = [_call(t, [("memcpy HtoD", 1, 3), ("cnn_fwd_kernel", 4, 8),
                       ("bilateral_gray_self_kernel<uchar>", 8, 18),
                       ("copy DtoH", 17, 19)], 20) for t in (0, 100)]
    assert calls[0].busy_us() == 17
    assert calls[0].gaps() == [("before memcpy HtoD", 1),
                               ("before cnn_fwd_kernel", 1),
                               ("after the last operation", 1)]
    assert kept(calls, 2) == calls
    assert kept(calls + [_call(200, [], 5)], 2) is None
    b = breakdown(calls)
    assert b["device_ops"][0] == ["bilateral_gray_self_kernel<uchar>",
                                  pytest.approx(20e-6)]
    cell = harness.Cell.load("serve_bf_b32")
    window = {"wall_s": 2.0, "requests": 1000, "issue_s": [1e-3, 3e-3],
              "pixels": SERVED_PIXELS,
              "model_flops": counts.forward_flops(SERVED_PIXELS)}
    run = harness.Run(cell.config, cell.traffic, window, calls, 1)
    read = {m: harness.load_metric(m).read(run)
            for m in ("idle_share.serve_bf", "k1_roofline.serve_bf",
                      "k2_roofline", "k5_roofline", "mfu.serve_bf",
                      "host_issue_ms.serve_bf")}
    assert read["idle_share.serve_bf"] == pytest.approx(100 * (1 - 17 / 20))
    assert read["k1_roofline.serve_bf"] == pytest.approx(
        100 * counts.k1_bound_s(SERVED_PIXELS) / 4e-6)
    assert read["k2_roofline"] == pytest.approx(
        100 * counts.k2_bound_s(SERVED_PIXELS, 22.0) / 10e-6)
    assert read["k5_roofline"] is None       # no K5 in the trace
    assert read["mfu.serve_bf"] == pytest.approx(
        100 * counts.forward_flops(SERVED_PIXELS) / 2e-3
        / counts.TF32_FLOP_S)
    assert read["host_issue_ms.serve_bf"] == pytest.approx(2.0)
    nothing = harness.Run(cell.config, cell.traffic, window)
    assert harness.load_metric("idle_share.serve_bf").read(nothing) is None
    assert harness.load_metric("k1_roofline.serve_bf").read(nothing) is None
    # a step's model FLOPs are the entry's count: the chain has none
    train = dict(window, model_flops=counts.train_step_flops(SERVED_PIXELS))
    assert harness.load_metric("mfu.train").read(harness.Run(
        cell.config, cell.traffic, train)) == pytest.approx(
            3 * read["mfu.serve_bf"])
    chain = {k: v for k, v in window.items() if k != "model_flops"}
    assert harness.load_metric("mfu.serve_bf").read(harness.Run(
        cell.config, cell.traffic, chain)) is None
