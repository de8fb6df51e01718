"""K7's backward split by phase (TPU kernel 19): the port's plain variants
(ops/cnn_train_kernel.py::trunk_backward_variant_plain) against the JAX
timing script's ``_bwd_variant`` (scripts/measure_train_bwd_split.py), whose
Pallas kernel runs in TPU-interpret mode, on the CPU.

The JAX kernel accumulates over 8192-pixel grid steps; P = 16384 takes two,
so the accumulation across steps is exercised.  Tolerance: each leaf within
2e-4 of its largest value (the JAX package's gate for its fused trunk, set
by its bf16x3 products).  The floor variant touches one pixel per tile, and
the two tiles differ (8192 against the port's 64 pixels), so the port's
floor is held against numpy on its own tiles."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
from reflectance_filtering_tpu_torch.scripts import (
    measure_train_bwd_split as split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (5, 3, 32, 1)
P = 16384


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_measure_train_bwd_split",
        os.path.join(REPO, "scripts", "measure_train_bwd_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    """The JAX script's main() recipe: kernels and biases as [in, out]
    matrices and [out] vectors, x as [ci, P] and g as [cout, P]."""
    n, ci, f, cout = SHAPE
    rng = np.random.RandomState(0)
    kernels, biases = [], []
    for i in range(n):
        kernels.append((rng.randn(ci if i == 0 else f, f) * .1)
                       .astype(np.float32))
        biases.append((rng.randn(f) * .01).astype(np.float32))
    kernels.append((rng.randn(n * f, cout) * .1).astype(np.float32))
    biases.append((rng.randn(cout) * .01).astype(np.float32))
    # g positive, as main() makes it: a cotangent of mixed signs cancels in
    # the pixel sums and lifts the bf16x3 products' error to ~1e-2 of a leaf
    x = rng.rand(ci, P).astype(np.float32)
    g = rng.rand(cout, P).astype(np.float32)
    flat = k7.pack([torch.from_numpy(k) for k in kernels],
                   [torch.from_numpy(b) for b in biases])
    return kernels, biases, x, g, flat


def _from_jax(outs):
    """The JAX variant's four refs -> the port's flat vector."""
    n, ci, f, cout = SHAPE
    dw0, dwm, dwft, dbf = (np.asarray(o) for o in outs)
    ws = [dw0[:, :ci].T] + [dwm[i - 1, :, :f].T for i in range(1, n)]
    bs = [dw0[:, ci]] + [dwm[i - 1, :, f] for i in range(1, n)]
    ws.append(dwft[:, :cout])
    bs.append(dbf[:cout, 0])
    return k7.pack([torch.tensor(w) for w in ws], [torch.tensor(b) for b in bs])


def _assert_leaves(got, want, tol=2e-4):
    for part in (0, 1):
        for i, (a, b) in enumerate(zip(k7.unpack(got, SHAPE)[part],
                                       k7.unpack(want, SHAPE)[part])):
            err = (a - b).abs().max().item()
            assert err <= tol * b.abs().max().item(), (part, i, err)


@pytest.mark.parametrize("variant,flags", [
    (0, dict(do_dw=True, do_chain=True, do_head=True, do_remat=True)),
    (1, dict(do_dw=False, do_chain=True, do_head=True, do_remat=True)),
    (2, dict(do_dw=False, do_chain=False, do_head=True, do_remat=True)),
    (3, dict(do_dw=False, do_chain=False, do_head=False, do_remat=True))])
def test_plain_variant_matches_jax_bwd_variant(jax_script, inputs, variant,
                                               flags):
    kernels, biases, x, g, flat = inputs
    with pltpu.force_tpu_interpret_mode():
        outs = jax_script.make_runner(**flags)(
            tuple(map(jnp.asarray, kernels)), tuple(map(jnp.asarray, biases)),
            jnp.asarray(x), jnp.asarray(g))
    want = _from_jax(outs)
    got = k7.trunk_backward_variant_plain(
        torch.from_numpy(np.ascontiguousarray(x.T)),
        torch.from_numpy(np.ascontiguousarray(g.T)), flat, SHAPE, variant)
    _assert_leaves(got, want)
    ws, _ = k7.unpack(got, SHAPE)
    if variant >= 1:
        assert all(float(w.abs().max()) == 0 for w in ws[:-1])  # no dW_l
    if variant == 3:
        assert float(ws[-1].abs().max()) == 0                   # no dW_fuse


def test_full_variant_is_the_gradient(inputs):
    """Variant 0's terms, written out, against autograd of the trunk."""
    _, _, x, g, flat = inputs
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    gt = torch.from_numpy(np.ascontiguousarray(g.T))
    want, _ = k7.trunk_backward_plain(xt, gt, flat, SHAPE, False)
    _assert_leaves(k7.trunk_backward_variant_plain(xt, gt, flat, SHAPE, 0),
                   want, tol=1e-5)


def test_floor_variant_on_the_ports_tiles(rng):
    """empty: db_fuse = the sum over 64-pixel tiles of x[first, 0] +
    g[first, 0] (a ragged last tile too), every other entry zero."""
    shape = (2, 3, 8, 3)
    p = 64 * 5 + 17
    x = rng.rand(p, 3).astype(np.float32)
    g = rng.randn(p, 3).astype(np.float32)
    flat = torch.from_numpy(rng.randn(k7.num_params(shape))
                            .astype(np.float32))
    got = k7.trunk_backward_variant_plain(torch.from_numpy(x),
                                          torch.from_numpy(g), flat, shape, 4)
    want = sum(float(x[t, 0]) + float(g[t, 0]) for t in range(0, p, 64))
    ws, bs = k7.unpack(got, shape)
    np.testing.assert_allclose(bs[-1].numpy(), np.full(3, want), rtol=1e-6)
    assert all(float(w.abs().max()) == 0 for w in ws)
    assert all(float(b.abs().max()) == 0 for b in bs[:-1])


def test_block_sum_plain_adds_the_rows_in_block_order(rng):
    shape = (2, 3, 8, 1)
    stride = k7.row_stride(shape)
    assert stride % 4 == 0 and stride >= k7.num_params(shape)
    work = torch.from_numpy(rng.randn(7, stride + 12).astype(np.float32))
    got = k7.trunk_backward_variant_plain(None, None, None, shape, 5, work)
    rows = work.reshape(-1)[:7 * stride].view(7, stride).numpy()
    want = np.zeros(k7.num_params(shape), np.float32)
    for b in range(7):
        want = want + rows[b, :k7.num_params(shape)]
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="work"):
        k7.trunk_backward_variant_plain(None, None, None, shape, 5)


@pytest.mark.parametrize("variant", range(6))
def test_variant_wrapper_on_cpu_takes_the_plain_version(rng, variant):
    shape = (2, 3, 16, 2)
    x = torch.from_numpy(rng.rand(200, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(200, 2).astype(np.float32))
    flat = torch.from_numpy(rng.randn(k7.num_params(shape))
                            .astype(np.float32))
    work = torch.from_numpy(rng.randn(3, k7.row_stride(shape))
                            .astype(np.float32))
    before = k7.trunk_backward_variant.launches
    got = k7.trunk_backward_variant(x, g, flat, shape, variant, work)
    want = k7.trunk_backward_variant_plain(x, g, flat, shape, variant, work)
    assert torch.equal(got, want)
    assert k7.trunk_backward_variant.launches == before
    with pytest.raises(ValueError, match="variant"):
        k7.trunk_backward_variant(x, g, flat, shape, 6, work)


def _plain_fmas_per_pixel(variant, x, g, flat):
    """The float32 FMAs per pixel of the plain version of a variant, counted
    by torch's FLOP counter (2 per FMA)."""
    with FlopCounterMode(display=False) as counter:
        k7.trunk_backward_variant_plain(x, g, flat, SHAPE, variant)
    return counter.get_total_flops() // (2 * x.shape[0])


@pytest.mark.parametrize("stage", ["dW", "chain", "head",
                                   "rematerialisation"])
def test_phase_count_is_what_its_variant_drops(inputs, stage):
    """A phase's FMA count is the difference between the plain versions of
    the variant that keeps it and the next, which drops it (the plain
    versions run the phases of the kernel's masks, BWD_MASKS)."""
    _, _, x, g, flat = inputs
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    gt = torch.from_numpy(np.ascontiguousarray(g.T))
    i = split.STAGES.index(stage)
    dropped = (_plain_fmas_per_pixel(i - 1, xt, gt, flat)
               - _plain_fmas_per_pixel(i, xt, gt, flat))
    assert dropped == split.phase_fmas()[stage]


def test_phase_counts_sum_to_the_backward():
    """The phases add up to the full variant's count: 12,800 FMAs per
    pixel, the head dW_fuse's 160 alone; 0.5015 ms at 20 x 256x256 on the
    FP32 pipe, 0.1984 ms with the matrix products as 3xTF32."""
    fmas = split.phase_fmas()
    assert fmas == {"rematerialisation": 4352, "chain": 4096, "dW": 4192,
                    "head": 160}
    x, g, flat = (t[:256] if t.dim() == 2 else t
                  for t in split.make_inputs("cpu"))
    assert _plain_fmas_per_pixel(0, x, g, flat) == sum(fmas.values()) == 12800
    assert _plain_fmas_per_pixel(4, x, g, flat) == 0
    f32 = split.phase_bounds_ms(tensor_cores=False)
    assert round(f32["rematerialisation"], 4) == 0.1705
    assert round(f32["head"], 5) == 0.00627
    assert round(f32["total"], 4) == 0.5015
    bounds = split.phase_bounds_ms()
    assert round(bounds["rematerialisation"], 4) == 0.0666
    assert round(bounds["chain"], 4) == 0.0651
    assert bounds["head"] == f32["head"]          # matrix-vector: FP32
    assert round(bounds["total"], 4) == 0.1984


def test_bound_rates():
    """The tensor-core term: 494.7 TFLOP/s dense TF32, three products per
    float32 MAC (82.45 T MAC/s, 2.47x the FP32 pipe's 33.45 T FMA/s); the
    float64-add term: 132 SMs x 64 lanes x 1.98 GHz = 16.7 T/s."""
    assert split.TF32X3_MAC_S == pytest.approx(494.7e12 / 6)
    assert split.TF32X3_MAC_S / (split.F32_FLOP_S / 2) == pytest.approx(
        2.4646, abs=1e-4)
    assert split.F64_ADD_S == pytest.approx(16.72704e12)
    # K1 at 32 x 256x256: 4,192 matrix MACs a pixel as 3xTF32 beside the
    # 160 fuse FMAs on the FP32 pipe; all 4,352 on the FP32 pipe before
    px = 32 * 256 * 256
    assert round(split.matmul_ms(4192, 160, px), 4) == 0.1066
    assert round(split.matmul_ms(4192, 160, px, tensor_cores=False),
                 4) == 0.2728
    # the fuse alone can bind: then the FP32 pipe's term is the bound
    assert split.matmul_ms(1, 10 ** 6, px) == pytest.approx(
        2e6 * px / split.F32_FLOP_S * 1e3)


def test_make_inputs_is_seeded():
    a = split.make_inputs("cpu", seed=3)
    b = split.make_inputs("cpu", seed=3)
    c = split.make_inputs("cpu", seed=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (split.PIXELS, 3) and a[1].shape == (split.PIXELS, 1)
    assert a[2].numel() == k7.num_params(SHAPE)


def test_script_without_cuda_exits_nonzero_and_builds_nothing(tmp_path):
    from reflectance_filtering_tpu_torch.ops import _build
    before = (sorted(os.listdir(_build.BUILD_ROOT))
              if os.path.isdir(_build.BUILD_ROOT) else None)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m",
         "reflectance_filtering_tpu_torch.scripts.measure_train_bwd_split"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr
    after = (sorted(os.listdir(_build.BUILD_ROOT))
             if os.path.isdir(_build.BUILD_ROOT) else None)
    assert after == before
