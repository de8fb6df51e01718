#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reflectance_filtering_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds and serves.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits nonzero before the result line):
  1. device   the card's name and power limit (nvidia-smi), TF32 pinned off;
  2. build    nvcc builds every kernel from reflectance_filtering_tpu_torch/
              csrc/, one process per source (build seconds, the compiler's
              register report), and the machine code is read (cuobjdump):
              K2's uint8 instantiation issues no MUFU.EX2, the float one
              some, and so do K6's five uint8 and four float ones; K1 issues
              HMMA .TF32 (3xTF32 on the tensor cores) and no FFMA on a
              constant-bank weight (its instruction count is printed), and
              K7's backward HMMA .TF32 (each instantiation's HMMA count
              printed); the F2F.F64.F32 conversions of K5's and K9's row
              passes are counted per kernel;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 32 x 256x256, K = 1181; the box
              also on one 2160x3840 plane and on the guided CLI's
              --subsample=4 planes; the joint bilateral K6 at the JAX
              bench's 8 x 256x256, c20 s22: color-self, BF(reflectance,
              photo), both in cv2's table form, float with a 3-plane joint),
              plus degenerate shapes,
              gated (K2 on each input as uint8 levels, cv2's table form,
              and as float32, the exp form; K5 also at C=3 with r=300 and
              r=1300, whose row blocks narrow to fit their staging, against
              its plain version in float64); the iterated guided chain K9
              (3 iterations, r=45, eps=3) on a 2160x3840 frame, C=1, with its guide statistics
              and one application held alone, on 2 x 480x512 with C=3, and
              on a 12x40 frame narrower than the window;
  3t. train   the training kernels against their plain versions on the
              card: the fused skip-layer trunk K7 (forward against the plain
              trunk, backward against plain autograd) at the flagship's
              20 x 256x256 and four other configs on a 37x53 frame, and
              the WHDR scatter-add K8 against index_put_(accumulate=True)
              with forced collisions; each backward launched twice and held
              bitwise equal; K7's backward split by phase (TPU kernel 19) at
              20 x 256x256: the full variant bitwise equal to the product
              backward, the four with phases removed within 2e-4 of each
              leaf's max of their plain versions, the block sum alone
              bitwise equal to the workspace rows summed in order;
  3b. parity  the guided filter on cuda against the golden fixtures
              (tests/fixtures/guided_golden.npz), every r in {3, 45, 52} x
              eps in {3, 7} x color/colorsrc/gray, each <= 1 uint8 level;
              the color self-guided bilateral on cuda against
              cv2.bilateralFilter at 256x256 and 512x768, c20 s22 and c30
              s8 (<= 1 level, < 2% differing, |dWHDR| < 0.001); the chain
              at 2 iterations against K5 applied twice on 1 x 480x512 and
              1 x 512x512 (both floored, <= 1 level: the JAX bench's
              on-chip tiling gate);
  4. serving  3 requests of 32 uint8 BGR 256x256 photos through
              utils.serving.pipeline_fn("bf") and whdr_batch, then 3 through
              pipeline_fn("gf") and whdr_batch; every launch counter is reset
              before each path and checked after it, and each result is held
              against the same pipeline through the plain versions;
  4c. chain   ops.guided.guided_filter_iterated(planar=True), the 3x chain
              of the JAX bench's config 4, on one 2160x3840 and one
              4320x7680 frame (C=1), counters reset before each: K9 counted,
              K5 not; the 4K result held against the plain chain;
  4t. train  train.loop.fit for 20 steps of batch 20 x 256x256, K = 1181,
              on a seeded synthetic set of 40 images resident on the card,
              once through the kernels (K7 forward and backward, K3, K8:
              each counted) and once through the plain versions on the card
              (no kernel counted): every step's loss_total within 1e-3
              relative; then 10 steps, a checkpoint, a resume for 10 more,
              against the 20 uninterrupted steps (params within 1e-6);
  4n. nets    the seven networkTypes (batch norm on and off for the
              skip-layer trunk and the cascade; the train CLI's default
              widths) through train.loop.compute_losses at batch 4 x 64x64
              (uNet's global path at its fixed 256x256), kernels on and off
              on the card: loss within 1e-3 relative, every gradient within
              2e-4 of its leaf's max; K7 counted on the skip trunk (1
              forward, 1 backward) and the cascade (2 and 2, one backward
              with the input cotangent); then one training step each;
  5. CLIs     the train CLI's fit stage on cuda with the flagship flags
              (--iterations=40 --batch_size=20 --checkpoint_interval=20) on
              a synthetic 256x256 .npz tree, warm-started from a seeded
              .npz, its results tree checked, and the same run with
              --device cpu: final val WHDR within 0.001, final params within
              1e-3; then the same with the CLI's default network flags
              (convStaticWithSigmoid, 2 layers of 16 3x3 filters, rRelMax)
              on the same set;
              the decompose and filter CLIs' functions on a synthetic PNG
              on cuda (seeded weights: the trained model is not shipped):
              bilateral c20 s22 on the -r.png by itself, on the -r.png
              guided by the photo and on the photo by itself (the last two
              held against the same call on the CPU), guided c3 s45, and
              guided with --subsample=4 (the box kernel's path, held
              against the same filter on the CPU); and
              joint_bilateral_filter_fast, the float filter's entry point
              (the width-sharded filter's, not ported yet), called
              directly and held against the CPU;
  6. times    CUDA-event times of each kernel and its plain version (and of
              the one PyTorch call computing the same function, where there
              is one, K3's and K8's in turns with the kernel's wrapper,
              medians of 7; K2 on uint8 levels and on float32, and its range
              table in the product's layout against two others,
              reflectance_filtering_tpu_torch/scripts/
              measure_k2_table.py; K6's uint8 range table likewise,
              measure_k6_table.py), both slices' images/s, the MP/s of the color-self and
              BF(reflectance, photo) bilateral, and the training step's ms
              and images/s on the kernels and on the plain versions, the
              3x chain's ms and MP/s at 4K and 8K on K9 and as three K5
              calls, each K9 launch's ms, K9's six passes timed apart at 4K
              and 8K with the column passes at the product's segments and
              at 32, 64, 128 and 256 rows
              (reflectance_filtering_tpu_torch/scripts/
              measure_k9_passes.py), and K7's backward split by phase
              (reflectance_filtering_tpu_torch/scripts/
              measure_train_bwd_split.py: each variant's median ms, each
              phase's delta beside its bound, the product backward's time
              and each instantiation's registers) (not gated);
  7. profile  each slice's, the training step's and the 4K chain's device
              busy time and per-kernel device times (torch.profiler), and
              the idle share against phase 6's time in the same run; K3's
              device time at 32 x 1181 beside indexing's, and the host's
              microseconds per K3 call split into checks, allocation and
              launch (host clock around 1,000 calls) (not gated).

Each phase's header shows the seconds since the script started; the line
before the kernels line, the whole run's.

The second-to-last line is {"kernels": [...]} with each kernel's launches in
the run of its path (K1-K3: bf serving; K5: gf serving; K4: the guided CLI;
K6's three wrappers: the bilateral CLI's BF(reflectance, photo) and
color-self runs, and the direct joint_bilateral_filter_fast call; K7's
forward and backward and K8: the 20 training steps; K9's two wrappers: the
4K chain; K7's split: its run in phase 6), its measured error and
times, and its bound: the larger of the bytes it must move over 3.35 TB/s
and its operations, each kind over its rate: float32 operations over 66.9
TFLOP/s (132 SMs x 128 lanes x 2 x 1.98 GHz), float32 MACs of matrix
products (K1, K7) as 3xTF32 over 494.7 / 6 T/s (three TF32 products a MAC
on the tensor cores), float64 adds (the box sums of K4, K5, K9) over 16.7
T/s (64 per SM per clock), expf over the SFU's 4.18 T/s (16 per SM per
clock), shared-memory table loads over 8.36 T/s (32 four-byte words per SM
per clock); the last line is {"ok": true, "device": {...}}.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, H, W, K = 32, 256, 256, 1181       # the main path's shapes
SIGMA_C, SIGMA_S = 20.0, 22.0
K2_SUBSET = 4                         # images for the slow plain bilateral
BF_N = 8                              # K6 batch: the JAX bench's (bench.py:458)
K6_SUBSET = 2                         # images for K6's plain versions
# K6's instantiations: (joint planes, src planes, self-guided, u8 tile)
K6_INSTANCES = [(3, 3, True, True)] + [
    (cj, cs, False, u8) for u8 in (True, False) for cj in (1, 3)
    for cs in (1, 3)]
# the instantiation each of K6's wrappers runs on its main path
K6_MAIN = {"bilateral_color_self": (3, 3, True, True),
           "bilateral_packed_joint": (3, 1, False, True),
           "bilateral_joint": (3, 1, False, False)}
GF_R, GF_EPS = 45, 3.0                # GF(CNN, image): README c3 s45
BIG_PLANE = (1, 2160, 3840)           # one 4K plane for the box kernel
# the 3x iterated guided chain (BASELINE.json config 4, bench.py:532-575)
CHAIN_ITERS = 3
CHAIN_FRAMES = {"4K": (2160, 3840), "8K": (4320, 7680)}
PROFILE_BATCHES = 5
# the training slice: the JAX bench's training shape (bench.py:596-634)
TB, TRAIN_N, TRAIN_VAL_N, TRAIN_STEPS = 20, 40, 20, 20
TRAIN_FLAGS = ["--networkType=convStaticSkipLayers", "--numLayers=5",
               "--num_filters_log=5", "--kernel_pad=0",
               "--RS_est_mode=rDirectly"]
# K7 off the flagship: (n, ci, f, cout) on a 37x53 frame
K7_OTHER = [(2, 3, 16, 1), (1, 3, 32, 1), (2, 3, 128, 1), (3, 3, 16, 6)]
# phase 4n: (networkType, batch norm) at batch NET_B of NET_HW x NET_HW
NET_B, NET_HW = 4, 64
NET_CASES = ([(t, False) for t in ("convStatic", "convStaticWithSigmoid",
                                   "simpleConvolutionsRelu", "convIncreasing",
                                   "uNet")]
             + [(t, bn) for t in ("convStaticSkipLayers", "cascadeSkipLayers")
                for bn in (False, True)])
# the card's peak rates for the bounds (H100 SXM); the float32 and memory
# rates are the split script's (F32_FLOP_S, HBM_BYTES_S)
SFU_S = 132 * 16 * 1.98e9                 # 4.18 T expf/s
SMEM_LOADS_S = 132 * 32 * 1.98e9          # 8.36 T shared-memory loads/s


def bound(flops=0.0, sfu=0.0, loads=0.0, nbytes=0.0, tf32_macs=0.0,
          f64_adds=0.0):
    """(least ms the card could take, "operations" or "bytes")."""
    from reflectance_filtering_tpu_torch.scripts.measure_train_bwd_split \
        import F32_FLOP_S, F64_ADD_S, HBM_BYTES_S, TF32X3_MAC_S
    ops = max(flops / F32_FLOP_S, sfu / SFU_S, loads / SMEM_LOADS_S,
              tf32_macs / TF32X3_MAC_S, f64_adds / F64_ADD_S)
    mem = nbytes / HBM_BYTES_S
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


def trunk_fmas(shape):
    """(matrix-product MACs, fuse FMAs) per pixel of K7's forward and K1
    (the backward's are the split script's phase_fmas)."""
    n, ci, f, cout = shape
    return ci * f + (n - 1) * f * f, n * f * cout


def training_set(seed, n, k, h=H, w=W):
    """A seeded synthetic training set in the loader's NHWC layout: 1/f
    photos as linear RGB in [0, 1], and K synthetic comparisons each."""
    from reflectance_filtering_tpu_torch.utils.image import srgb_to_rgb
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    bgr = photos(np.random.RandomState(seed), n, h, w)
    rgb = np.ascontiguousarray(bgr[:, ::-1].transpose(0, 2, 3, 1)) / 255.0
    return {"images": srgb_to_rgb(rgb).astype(np.float32),
            "comparisons": make_synthetic_comps(seed + 1, k, batch=n)}


_START = time.perf_counter()


def phase(title):
    """Print a phase's header with the seconds since the script started."""
    print("== {} ({:.1f} s)".format(title, time.perf_counter() - _START))


def check(ok, msg):
    if not ok:
        sys.exit("chip_smoke: FAIL: " + msg)
    print("  ok:", msg)


def photos(rng, n, h, w):
    """Seeded uint8 BGR planar photos [n, 3, h, w]: 1/f noise per channel
    (a natural-image spectrum) with a shared luminance component."""
    from reflectance_filtering_tpu_torch.utils.testimages import pink_noise
    out = np.empty((n, 3, h, w), np.uint8)
    for i in range(n):
        lum = pink_noise(rng, h, w)
        for c in range(3):
            out[i, c] = np.clip(0.6 * lum + 0.4 * pink_noise(rng, h, w),
                                0, 255).astype(np.uint8)
    return out


def device_photos(gen, n, h, w):
    """Seeded uint8-valued float32 photos [n, 3, h, w] made on the card by
    the recipe of :func:`photos` (1/f noise per channel with a shared
    luminance component), so that 4K and 8K frames cost no host time."""
    dev = gen.device
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.fftfreq(w, device=dev)[None, :]
    amp = 1.0 / torch.sqrt(fy * fy + fx * fx).clamp_min(1e-30)
    amp[0, 0] = 1.0

    def pink():
        phase = 2 * np.pi * torch.rand((h, w), device=dev, generator=gen)
        img = torch.fft.ifft2(torch.polar(amp, phase)).real
        return torch.floor((img - img.min()) / (img.max() - img.min() + 1e-12)
                           * 255.0)

    out = torch.empty((n, 3, h, w), device=dev)
    for i in range(n):
        lum = pink()
        for c in range(3):
            out[i, c] = torch.floor(torch.clamp(0.6 * lum + 0.4 * pink(), 0,
                                                255))
    return out


def chain_gate(got, exp):
    """(max |d|, max uint8 levels after rint, allclose at rtol 1e-3 / atol
    0.05): the JAX package's gate between its 3x chains
    (tests/test_pallas_ops.py)."""
    err = (got - exp).abs().max().item()
    levels = (torch.round(got) - torch.round(exp)).abs().max().item()
    return err, levels, torch.allclose(got, exp, rtol=1e-3, atol=0.05)


def stats_gate(got, exp):
    """The worst plane's max |d| over that plane's largest magnitude (the
    d planes cross zero, so no relative gate per element applies)."""
    return max(((got[:, k] - exp[:, k].to(got.dtype)).abs().max()
                / exp[:, k].abs().max()).item() for k in range(exp.shape[1]))


def time_ms(fn, iters, warmup=1):
    """Mean device time of fn() in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(fn_a, fn_b, iters, rounds=7):
    """(median ms of fn_a, of fn_b) by :func:`time_ms` over ``rounds``
    turns, the first of each pair alternating (a b, b a, a b, ...)."""
    times_a, times_b = [], []
    for r in range(rounds):
        pair = [(fn_a, times_a), (fn_b, times_b)]
        for fn, out in (pair if r % 2 == 0 else pair[::-1]):
            out.append(time_ms(fn, iters))
    return statistics.median(times_a), statistics.median(times_b)


def device_profile(fn, batches):
    """Device time of fn() per call in ms, from torch.profiler over
    ``batches`` calls after one warm-up: the busy time (the union of every
    kernel's and copy's interval on the card) and each kernel's total."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
    # user annotations (e.g. "Optimizer.step#Adam.step") are ranges on the
    # device timeline that span kernels already counted: left out
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, last, per_kernel = 0.0, float("-inf"), {}
    for start, end, name in spans:
        per_kernel[name] = per_kernel.get(name, 0.0) + end - start
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    return (busy / batches / 1e3,
            {k: v / batches / 1e3 for k, v in per_kernel.items()})


def launch_before(name, device, *args):
    """The kernel launch as ops/_build.py made it before its entry points
    were resolved once (the yardstick of phase 7's host split)."""
    from reflectance_filtering_tpu_torch.ops import _build
    handle = _build.lib()
    with torch.cuda.device(device):
        rc = getattr(handle, name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError("{} failed: CUDA error {}".format(name, rc))


def u8(t):
    """The product's uint8 write path, as uint8-valued float."""
    return torch.clamp(torch.round(t), 0, 255)


def box_tol(shape, radius):
    """K4's gate against its plain version: the plain float32 block sums'
    partials reach L * w * 255 (L the padded length, at most the block of
    512); 8 float32 ulps of that, normalized by the window's area."""
    w = 2 * radius + 1
    return 8 * 2.0 ** -24 * min(max(shape[1:]) + 2 * radius, 512) * 255 / w


def check_training_kernels(dev, seed):
    """Phase 3t: K7 and K8 against their plain versions on the card.
    Returns the flagship's errors and its inputs, kept for phase 6."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        scatter_pairs, scatter_pairs_plain)
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs, keep = {}, {}
    cases = [("flagship {}x{}x{}".format(TB, H, W), (5, 3, 32, 1),
              TB * H * W)] + [("37x53 (n, ci, f, cout)={}".format(shape),
                               shape, 37 * 53) for shape in K7_OTHER]
    for name, shape, p in cases:
        n, ci, f, cout = shape
        cfg = NetworkConfig(num_layers=n, num_filters_log=f.bit_length() - 1,
                            rs_est_mode="RS" if cout == 6 else "rDirectly")
        params = init_network(cfg, torch.Generator().manual_seed(seed), dev)
        flat = k7.pack(*k7._matrices(params, n, ""))
        flat += 0.05 * torch.randn(flat.shape, device=dev, generator=gen)
        x = torch.rand(p, ci, device=dev, generator=gen)
        g = torch.randn(p, cout, device=dev, generator=gen)
        pre = k7.trunk_forward(x, flat, shape)
        pre_p = k7.trunk_forward_plain(x, flat, shape)
        grad, dx = k7.trunk_backward(x, g, flat, shape, True)
        grad_p, dx_p = k7.trunk_backward_plain(x, g, flat, shape, True)
        grad2, dx2 = k7.trunk_backward(x, g, flat, shape, True)
        grad3, _ = k7.trunk_backward(x, g, flat, shape, False)
        torch.cuda.synchronize()
        fwd_err = (pre - pre_p).abs().max().item()
        fwd_rel = fwd_err / pre_p.abs().max().item()
        leaf_rel = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for part in (0, 1) for a, b in zip(k7.unpack(grad, shape)[part],
                                               k7.unpack(grad_p, shape)[part]))
        dx_rel = ((dx - dx_p).abs().max() / dx_p.abs().max()).item()
        print("K7 {}: forward max|d|={:.3e} ({:.2e} of max); backward worst "
              "leaf {:.2e} of its max, dx {:.2e}".format(
                  name, fwd_err, fwd_rel, leaf_rel, dx_rel))
        check(fwd_rel <= 1e-5, "K7 {} forward within 1e-5 of the plain "
              "trunk".format(name))
        check(leaf_rel <= 2e-4 and dx_rel <= 5e-5,
              "K7 {} backward: each parameter gradient within 2e-4 of its "
              "leaf's max, dx within 5e-5".format(name))
        check(torch.equal(grad, grad2) and torch.equal(dx, dx2)
              and torch.equal(grad, grad3),
              "K7 {} backward bitwise equal on a second launch and without "
              "dx".format(name))
        if not keep:
            errs["cnn_train_fwd"] = fwd_err
            errs["cnn_train_bwd"] = (grad - grad_p).abs().max().item()
            keep = {"x": x, "g": g, "flat": flat, "shape": shape}

    # kernel 19: the backward's timing variants at the flagship's shapes
    x, g, flat, shape = (keep[key] for key in ("x", "g", "flat", "shape"))
    work = k7.backward_workspace(x, shape)
    product, _ = k7.trunk_backward(x, g, flat, shape, False)
    worst = 0.0
    for variant, name in enumerate(k7.BWD_VARIANTS[:5]):
        got = k7.trunk_backward_variant(x, g, flat, shape, variant, work)
        want = k7.trunk_backward_variant_plain(x, g, flat, shape, variant)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        leaf_rel = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for part in (0, 1) for a, b in zip(k7.unpack(got, shape)[part],
                                               k7.unpack(want, shape)[part]))
        print("K7 split {} ({}): max|d|={:.3e}, worst leaf {:.2e} of its "
              "max".format(variant, name, err, leaf_rel))
        if variant == 0:
            check(torch.equal(got, product), "K7 split: the full variant "
                  "bitwise equal to the product backward")
        check(leaf_rel <= 2e-4, "K7 split {}: each leaf within 2e-4 of its "
              "max of the plain version".format(name))
    summed = k7.trunk_backward_variant(x, g, flat, shape, 5, work)
    check(torch.equal(summed, k7.block_sum_plain(work, shape))
          and torch.equal(summed, got), "K7 split: the block sum alone "
          "bitwise equal to the workspace rows summed in block order")
    errs["cnn_train_bwd_split"] = worst

    # K8 at the training step's shapes, half of the points inside a 12x12
    # corner so that many pixels are read by several points
    b, k = TB, K
    idx = []
    for n_ in (H, W, H, W):
        t = torch.randint(0, n_, (b, k), device=dev, dtype=torch.int32,
                          generator=gen)
        t[:, : k // 2] %= 12
        idx.append(t)
    g1, g2 = (torch.randn(b, k, device=dev, generator=gen) for _ in range(2))
    got = scatter_pairs((b, H, W), *idx, g1, g2)
    want = scatter_pairs_plain((b, H, W), *idx, g1, g2)
    again = scatter_pairs((b, H, W), *idx, g1, g2)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    collided = (torch.stack([want != 0]).sum().item(), 2 * b * k)
    print("K8 {}x{}x{}, K={}: max|d|={:.3e} ({:.2e} of max); {} pixels for "
          "{} points".format(b, H, W, k, err, rel, *collided))
    check(rel <= 1e-6, "K8 within 1e-6 of index_put_(accumulate=True)")
    check(torch.equal(got, again), "K8 bitwise equal on a second launch")
    errs["whdr_scatter"] = err
    keep["scatter"] = (idx, g1, g2)
    return errs, keep


def check_network_families(dev, seed):
    """Phase 4n: each of NET_CASES through compute_losses on the card, with
    the kernels and with the plain versions (kernels=False): the loss
    within 1e-3 relative and every gradient within 2e-4 of its leaf's max;
    K7's launches counted on the skip-layer trunk and the cascade, and
    which of its backwards computed the input cotangent; then one training
    step of each."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.train.loop import (
        LossConfig, compute_losses, make_optimizer, make_train_step,
        trainable)
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(NET_B, NET_HW, NET_HW, 3, device=dev,
                        generator=gen) * 0.8 + 0.1
    comps = torch.from_numpy(make_synthetic_comps(seed, K,
                                                  batch=NET_B)).to(dev)
    for kind, bn in NET_CASES:
        skip = kind in ("convStaticSkipLayers", "cascadeSkipLayers")
        cfg = NetworkConfig(network_type=kind, num_layers=2,
                            num_filters_log=4, kernel_pad=0 if skip else 1,
                            use_batch_normalization=bn, rs_est_mode="rRelMax")
        init = init_network(cfg, torch.Generator().manual_seed(seed), dev)
        name = "{} bn{}".format(kind, int(bn))
        runs = {}
        for kernels in (True, False):
            params = trainable(init, dev)
            leaves = [t for layer in params.values() for t in layer.values()]
            counters = (k7.trunk_forward.launches, k7.trunk_backward.launches,
                        k7.trunk_backward.dx_launches)
            total, _ = compute_losses(params, images, comps, cfg,
                                      LossConfig(), kernels=kernels)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            torch.cuda.synchronize()
            runs[kernels] = (total.item(), grads, (
                k7.trunk_forward.launches - counters[0],
                k7.trunk_backward.launches - counters[1]),
                k7.trunk_backward.dx_launches - counters[2])
        (loss_k, grads_k, k7_k, dx_k), (loss_p, grads_p, k7_p, _) = (
            runs[True], runs[False])
        names = [(layer, part) for layer in init for part in init[layer]]
        scale = max(g_.abs().max().item() for g_ in grads_p if g_ is not None)
        worst, noise, unused = 0.0, 0.0, True
        for (layer, part), a, b in zip(names, grads_k, grads_p):
            if b is None:           # batch norm's running statistics
                unused = unused and a is None
            elif part == "bias" and "bn" + layer[4:] in init:
                # the bias of a conv before batch norm: a zero gradient
                noise = max(noise, a.abs().max().item(),
                            b.abs().max().item())
            else:
                worst = max(worst, ((a - b).abs().max()
                                    / b.abs().max().clamp_min(1e-30)).item())
        want = ((1, 1) if kind == "convStaticSkipLayers" and not bn
                else (2, 2) if kind == "cascadeSkipLayers" and not bn
                else (0, 0))
        print("4n {}: loss kernels {:.6f} plain {:.6f}; worst leaf {:.2e} of "
              "its max; K7 forward/backward {} (with dx: {})".format(
                  name, loss_k, loss_p, worst, k7_k, dx_k))
        check(abs(loss_k - loss_p) <= 1e-3 * abs(loss_p) and worst <= 2e-4
              and noise <= 1e-5 * scale and unused, "4n {}: loss within 1e-3 "
              "relative, gradients within 2e-4 of each leaf's max".format(
                  name))
        check(k7_k == want and k7_p == (0, 0)
              and dx_k == (1 if want == (2, 2) else 0),
              "4n {}: K7 launched {} times each way, {} backward with the "
              "input cotangent (none with kernels=False)".format(
                  name, want[0], 1 if want == (2, 2) else 0))
        params = trainable(init, dev)
        step = make_train_step(cfg, LossConfig(), params,
                               make_optimizer("ADAM", 1e-3, params))
        loss = step(images, comps)["loss_total"].item()
        bn_moved = all(params[layer]["mean"].abs().max().item() > 0
                       for layer in params if layer.startswith("bn"))
        check(np.isfinite(loss) and bn_moved, "4n {}: one training step "
              "(loss {:.6f}{})".format(name, loss, ", running means folded"
                                       if bn else ""))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: FAIL: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from reflectance_filtering_tpu_torch.cli import decompose as dec_cli
    from reflectance_filtering_tpu_torch.cli import filter as filt_cli
    from reflectance_filtering_tpu_torch.losses.whdr import whdr, whdr_batch
    from reflectance_filtering_tpu_torch.models.networks import (
        ReflectanceNet, params_from_numpy, seeded_reference_params)
    from reflectance_filtering_tpu_torch.ops import _build
    from reflectance_filtering_tpu_torch.ops.bilateral import (
        joint_bilateral_filter_u8, opencv_bilateral_params)
    from reflectance_filtering_tpu_torch.ops.bilateral_joint_kernel import (
        bilateral_color_self_batched, bilateral_joint_plain,
        bilateral_packed_joint_batched, joint_bilateral_filter_fast,
        joint_bilateral_planar_batched)
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self, bilateral_gray_self_plain)
    from reflectance_filtering_tpu_torch.ops.box_kernel import (
        box_filter_planar, box_filter_planar_plain)
    from reflectance_filtering_tpu_torch.ops.guided import (
        fast_guided_filter_u8, guided_filter_iterated, guided_filter_u8)
    from reflectance_filtering_tpu_torch.ops.guided_chain_kernel import (
        guide_stats, guide_stats_plain, guided_apply_cached,
        guided_apply_cached_plain, guided_filter_chain,
        guided_filter_chain_plain)
    from reflectance_filtering_tpu_torch.ops.guided_kernel import (
        guided_filter_fused, guided_filter_fused_plain)
    from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
        pack_weights, reflectance_cnn, reflectance_cnn_plain)
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        gather_pairs, gather_pairs_plain)
    from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn
    from reflectance_filtering_tpu_torch.cli import train as train_cli
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        scatter_pairs, scatter_pairs_plain)
    from reflectance_filtering_tpu_torch.train.checkpoint import (
        Checkpointer, load_checkpoint, save_checkpoint)
    from reflectance_filtering_tpu_torch.train.loop import (
        LossConfig, fit, make_optimizer, make_train_step, trainable)
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    from reflectance_filtering_tpu_torch.scripts import (
        measure_k2_table as k2_table, measure_k6_table as k6_table,
        measure_k9_passes as k9_passes,
        measure_train_bwd_split as split)
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        _check_indices)
    dev = torch.device("cuda", 0)

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "| allow_tf32 matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)

    phase("2. build")
    t0 = time.perf_counter()
    _build.lib()
    print("kernel library ready in {:.2f} s (nvcc: {})".format(
        time.perf_counter() - t0,
        "{:.2f} s".format(_build.build_seconds)
        if _build.build_seconds is not None else "cached"))
    with open(os.path.join(_build.build_dir(), "build.log")) as f:
        for line in f:
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print("  ptxas:", line.strip())
    # K2's uint8 form computes no exp: its instantiation's machine code has
    # no MUFU.EX2 (the float form's has one per pixel-tap)
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         os.path.join(_build.build_dir(), "librf_kernels.so")],
        capture_output=True, text=True, check=True).stdout
    ex2 = {("uint8" if "_kernelIh" in fn else "float32"):
           fn.count("MUFU.EX2") for fn in sass.split("Function : ")[1:]
           if fn.startswith("_ZN2k226bilateral_gray_self_kernel")}
    print("K2 MUFU.EX2 instructions per instantiation:", ex2)
    check(ex2.get("uint8") == 0 and ex2.get("float32", 0) > 0,
          "K2's uint8 instantiation issues no MUFU.EX2 (no exp)")
    # K6's uint8 form is cv2's table form too: none in any of its five
    # instantiations; its float form (TPU kernel 7) pays one per tap
    k6_ex2 = {fn.split("\n", 1)[0].strip(): fn.count("MUFU.EX2")
              for fn in sass.split("Function : ")[1:]
              if "bilateral_joint_u8_kernel" in fn.split("\n", 1)[0]
              or "bilateral_joint_float_kernel" in fn.split("\n", 1)[0]}
    k6_u8_ex2 = [n for name, n in k6_ex2.items() if "u8_kernel" in name]
    k6_f_ex2 = [n for name, n in k6_ex2.items() if "float_kernel" in name]
    print("K6 MUFU.EX2 per instantiation: uint8 form {}, float form "
          "{}".format(k6_u8_ex2, k6_f_ex2))
    check(len(k6_u8_ex2) == 5 and not any(k6_u8_ex2)
          and len(k6_f_ex2) == 4 and all(k6_f_ex2),
          "K6's five uint8 instantiations issue no MUFU.EX2 (no exp), its "
          "four float ones some")
    # K1 runs its layers on the tensor cores (HMMA .TF32) and takes no
    # weight as a constant-bank operand (c[0x3], the __constant__ bank)
    k1 = [fn for fn in sass.split("Function : ")[1:]
          if "cnn_fwd_kernel" in fn.split("\n", 1)[0]]
    k1_lines = [line for fn in k1 for line in fn.splitlines()
                if re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line)]
    hmma = [line for line in k1_lines if "HMMA" in line]
    const_fma = [line for line in k1_lines
                 if "FFMA" in line and "c[0x3]" in line]
    print("K1 cnn_fwd_kernel: {} instructions, {} HMMA ({}), {} FFMA on "
          "c[0x3]".format(len(k1_lines), len(hmma), sorted({
              line.split("HMMA", 1)[1].split()[0] for line in hmma}),
                          len(const_fma)))
    check(len(k1) == 1 and hmma and all("TF32" in line for line in hmma)
          and not const_fma, "K1 issues HMMA .TF32 and no constant-bank "
          "weight FFMA")
    # K7's backward runs its matrix products on the tensor cores too: every
    # instantiation of its product mask (dW in registers and in the row)
    # issues HMMA .TF32; its forward, not yet redesigned, issues none
    k7_hmma = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        m = re.search(r"trunk_(bwd|fwd)_kernel(?:ILi(\d+)ELb([01])E)?", name)
        if m:
            lines = [line for line in fn.splitlines()
                     if re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line)]
            tag = m.group(1) + ("" if m.group(2) is None else "<{}, {}>".format(
                m.group(2), "registers" if m.group(3) == "1" else "row"))
            k7_hmma[tag] = (len(lines), [line for line in lines
                                         if "HMMA" in line])
    print("K7 HMMA per instantiation (instructions, HMMA): {}".format(
        {tag: (n, len(h)) for tag, (n, h) in sorted(k7_hmma.items())}))
    product = [h for tag, (_, h) in k7_hmma.items()
               if tag.startswith("bwd<15,")]
    check(len(product) == 2 and all(product)
          and all("TF32" in line for h in product for line in h)
          and not k7_hmma.get("fwd", (0, []))[1],
          "K7's backward issues HMMA .TF32 (3xTF32 on the tensor cores)")
    # the row passes of K5 and K9 convert each staged value to float64
    # once: their F2F.F64.F32 per kernel (the staging's and the first
    # window's, none per tap)
    f2f = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        for kernel in ("gc_stats_rows", "gc_solve_cached_rows",
                       "gf_apply_rows", "gf_solve_rows"):
            if kernel in name:
                tag = kernel + ("<{}>".format(name.split("ILi")[1][0])
                                if "ILi" in name else "")
                tag += " (K5)" if "guided_cu" in name else " (K9)"
                f2f[tag] = fn.count("F2F.F64.F32")
    print("F2F.F64.F32 per row-pass kernel:", f2f)

    phase("3. kernels vs plain on the card")
    rng = np.random.RandomState(args.seed)
    grng = np.random.RandomState(args.seed + 1)   # the gf slice's inputs
    brng = np.random.RandomState(args.seed + 2)   # K6's inputs
    params = seeded_reference_params(args.seed)
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(params))
    net.to(dev)
    weights = pack_weights(net)
    imgs = torch.from_numpy(photos(rng, B, H, W)).to(dev)
    x = (imgs.flip(1).to(torch.float32) / 255.0).reshape(B, 3, H * W)
    errs = {}

    with torch.no_grad():
        for srgb in (True, False):
            rk = reflectance_cnn(x, weights, srgb_input=srgb)
            rp = reflectance_cnn_plain(x, weights, srgb_input=srgb)
            torch.cuda.synchronize()
            err = (rk - rp).abs().max().item()
            bk, bp = torch.floor(rk * 255), torch.floor(rp * 255)
            off = (bk != bp).float().mean().item()
            print("K1 srgb_input={}: max|d|={:.3e}  floor(r*255) differ on "
                  "{:.5%} (max {:.0f} level)".format(
                      srgb, err, off, (bk - bp).abs().max().item()))
            check(err <= 1e-5, "K1 f32 max abs err <= 1e-5")
            check((bk - bp).abs().max().item() <= 1 and off <= 1e-3,
                  "K1 bytes differ by <= 1 on <= 0.1% of pixels")
            if srgb:
                errs["cnn_fwd"] = err
                refl = rk
        print("reflectance range [{:.3f}, {:.3f}], {} byte levels".format(
            refl.min().item(), refl.max().item(),
            torch.unique(torch.floor(refl * 255)).numel()))

        r_u8 = torch.floor(refl * 255.0).reshape(B, H, W)
        r_levels = r_u8.to(torch.uint8)      # what the bf pipeline passes
        cases = [("main path subset", r_u8[:K2_SUBSET].contiguous())]
        for shape in ((1, 20, 27), (1, 1, 40), (2, 7, 1), (2, 37, 70)):
            # smaller than the radius (33): repeated reflection; 1-wide;
            # ragged tiles
            cases.append(("{}x{}x{}".format(*shape), torch.from_numpy(
                np.floor(rng.rand(*shape) * 256).astype(np.float32)).to(dev)))
        # each case twice: as uint8 levels (cv2's table form, the product's
        # input) and as float32 (the exp form) on the same planes
        worst = 0.0
        for name, planes in cases:
            for form in (torch.uint8, torch.float32):
                x_in = planes.to(form)
                qk = bilateral_gray_self(x_in, -1, SIGMA_C, SIGMA_S, reps=3)
                qp = bilateral_gray_self_plain(x_in, -1, SIGMA_C, SIGMA_S,
                                               reps=3)
                torch.cuda.synchronize()
                err = (qk - qp).abs().max().item()
                worst = max(worst, err)
                dl = (u8(qk) - u8(qp)).abs()
                eq = (dl == 0).float().mean().item()
                print("K2 {} {}: max|d|={:.3e}  uint8 max {:.0f} level, "
                      "{:.4%} equal".format(name, form, err, dl.max().item(),
                                            eq))
                check(err <= 1e-3 and dl.max().item() <= 1 and eq >= 0.999,
                      "K2 {} {}: <= 1e-3, <= 1 uint8 level, >= 99.9% "
                      "equal".format(name, form))
        errs["bilateral_gray_self"] = worst

        plane = (u8(bilateral_gray_self(r_levels, -1, SIGMA_C, SIGMA_S))
                 / 255.0).contiguous()
        idx = [torch.randint(0, n, (B, K), device=dev, dtype=torch.int32)
               for n in (H, W, H, W)]
        l1k, l2k = gather_pairs(plane, *idx)
        l1p, l2p = gather_pairs_plain(plane, *idx)
        torch.cuda.synchronize()
        errs["whdr_gather"] = max((l1k - l1p).abs().max().item(),
                                  (l2k - l2p).abs().max().item())
        check(torch.equal(l1k, l1p) and torch.equal(l2k, l2p),
              "K3 bitwise equal to indexing")

        # K4: the main paths' stack of planes, one 4K plane, the guided
        # CLI's --subsample=4 moment planes (13 at 64x64, radius
        # round(45 / 4) = 11), and a plane narrower than the window
        # (reflection repeats)
        def seeded(*shape):
            return torch.from_numpy(
                (grng.rand(*shape) * 255).astype(np.float32)).to(dev)
        box_in = {"32x256x256": (imgs.to(torch.float32)[:, 0].contiguous(),
                                 GF_R),
                  "1x2160x3840": (seeded(*BIG_PLANE), GF_R),
                  "13x64x64": (seeded(13, H // 4, W // 4), 11),
                  "1x20x27": (seeded(1, 20, 27), GF_R)}
        worst = 0.0
        for name, (planes, radius) in box_in.items():
            for border in ("reflect", "reflect101"):
                bk = box_filter_planar(planes, radius, border)
                bp = box_filter_planar_plain(planes, radius, border)
                torch.cuda.synchronize()
                err = (bk - bp).abs().max().item()
                tol = box_tol(planes.shape, radius)
                if name == "32x256x256":
                    worst = max(worst, err)
                print("K4 {} r={} {}: max|d|={:.3e} (gate {:.3e})".format(
                    name, radius, border, err, tol))
                check(err <= tol, "K4 {} {} within 8 float32 ulps of the "
                      "plain block partials".format(name, border))
        errs["box_filter"] = worst

        # K5: the gf path's shapes, C=1 (the served reflectance) and C=3,
        # strips narrower than the window, and C=3 at radii whose row
        # blocks narrow to fit their staging in shared memory
        guide = imgs.flip(1).to(torch.float32).contiguous()
        gf_in = {"C=1": (guide, r_u8[:, None].contiguous(), GF_R),
                 "C=3": (guide, torch.from_numpy(photos(
                     grng, B, H, W)).to(dev).to(torch.float32), GF_R)}
        for shape, c, radius in (((40, 512), 1, GF_R), ((12, 40), 1, GF_R),
                                 ((12, 40), 3, 300), ((6, 1100), 3, 1300)):
            gf_in["{}x{} C={}".format(*shape, c)] = tuple(
                torch.from_numpy(np.floor(grng.rand(1, k, *shape) * 256)
                                 .astype(np.float32)).to(dev)
                for k in (3, c)) + (radius,)
        worst = 0.0
        for name, (g_in, s_in, radius) in gf_in.items():
            qk = guided_filter_fused(g_in, s_in, radius, GF_EPS)
            if name in ("C=1", "C=3"):
                qp = guided_filter_fused_plain(g_in, s_in, radius, GF_EPS)
            else:   # float32's box partials would swamp a wide window
                qp = guided_filter_fused_plain(
                    g_in.double(), s_in.double(), radius, GF_EPS).float()
            torch.cuda.synchronize()
            err = (qk - qp).abs().max().item()
            if name in ("C=1", "C=3"):
                worst = max(worst, err)
            dl = (u8(qk) - u8(qp)).abs()
            eq = (dl == 0).float().mean().item()
            print("K5 {} r={} eps={}: max|d|={:.3e}  uint8 max {:.0f} level, "
                  "{:.4%} equal".format(name, radius, GF_EPS, err,
                                        dl.max().item(), eq))
            check(err <= 0.05, "K5 {}: max|d| <= 0.05".format(name))
            check(dl.max().item() <= 1 and eq >= 0.999,
                  "K5 {}: <= 1 uint8 level, >= 99.9% equal".format(name))
        errs["guided_filter"] = worst

        # K9: the 3x chain on the JAX bench's 4K frame (a photo guiding
        # another photo's first plane), C=3 on two 480x512 frames, and a
        # frame narrower than the window (reflection repeats)
        cgen = torch.Generator(device=dev).manual_seed(args.seed + 3)
        frame = CHAIN_FRAMES["4K"]
        chain_in = {
            "1x2160x3840 C=1": (device_photos(cgen, 1, *frame),
                                device_photos(cgen, 1, *frame)[:, :1]
                                .contiguous()),
            "2x480x512 C=3": (device_photos(cgen, 2, 480, 512),
                              device_photos(cgen, 2, 480, 512)),
            "1x12x40 C=1": tuple(torch.floor(torch.rand(
                (1, c, 12, 40), device=dev, generator=cgen) * 256)
                for c in (3, 1))}
        for name, (g_in, s_in) in chain_in.items():
            qk = guided_filter_chain(g_in, s_in, GF_R, GF_EPS, CHAIN_ITERS)
            qp = guided_filter_chain_plain(g_in, s_in, GF_R, GF_EPS,
                                           CHAIN_ITERS)
            torch.cuda.synchronize()
            err, levels, close = chain_gate(qk, qp)
            print("K9 {} chain x{} r={} eps={}: max|d|={:.3e}, uint8 max "
                  "{:.0f} level".format(name, CHAIN_ITERS, GF_R, GF_EPS, err,
                                        levels))
            check(close and levels <= 1, "K9 {}: rtol 1e-3 / atol 0.05, <= 1 "
                  "uint8 level".format(name))
        g4, s4 = chain_in["1x2160x3840 C=1"]
        st_k = guide_stats(g4, GF_R, GF_EPS)
        st_p = guide_stats_plain(g4, GF_R, GF_EPS)
        torch.cuda.synchronize()
        errs["guide_stats"] = (st_k - st_p).abs().max().item()
        rel = stats_gate(st_k, st_p)
        # the same plain version in float64: how far each float32 version
        # is from the exact statistics of these inputs
        st_x = guide_stats_plain(g4.double(), GF_R, GF_EPS)
        rel_x = stats_gate(st_k, st_x)
        print("K9 guide_stats 1x2160x3840: max|d|={:.3e}, worst plane {:.2e} "
              "of its max; against float64: kernel {:.2e}, plain "
              "{:.2e}".format(errs["guide_stats"], rel, rel_x,
                              stats_gate(st_p, st_x)))
        del st_x
        # the plain box's float32 block partials (up to 512 x 91 x 255^2)
        # round V's entries by ~0.01, against eps = 3 where the guide is
        # flat: ~1e-3 of 1/eps in its d planes; the kernel's float64 sums
        # keep it near the exact statistics
        check(rel <= 5e-3 and rel_x <= 1e-3, "K9 guide_stats: each plane "
              "within 5e-3 of the plain version's largest magnitude, 1e-3 "
              "in float64")
        # one application from the kernel's statistics, against its plain
        # version on the same statistics
        err, levels, close = chain_gate(
            guided_apply_cached(st_k, g4, s4, GF_R),
            guided_apply_cached_plain(st_k, g4, s4, GF_R))
        errs["guided_apply_cached"] = err
        print("K9 guided_apply_cached 1x2160x3840: max|d|={:.3e}, uint8 max "
              "{:.0f} level".format(err, levels))
        check(close and levels <= 1, "K9 guided_apply_cached: rtol 1e-3 / "
              "atol 0.05, <= 1 uint8 level")

        # K6 at the JAX bench's shapes (bench.py:458-486): the photos by
        # themselves, BF(reflectance, photo) with the photo as the 3-plane
        # joint, and the float filter (3-plane joint, one src plane) on
        # non-integer values; the kernel on all 8 images, its plain
        # version on the first K6_SUBSET; then a frame smaller than the
        # radius (reflection repeats)
        # bf_radius, not radius: the guided parity loop below reuses that
        bf_radius, gcc, gsc, _ = opencv_bilateral_params(-1, SIGMA_C,
                                                         SIGMA_S)

        def floats(*shape):
            return torch.from_numpy(
                (brng.rand(*shape) * 255).astype(np.float32)).to(dev)

        def u8s(*shape):
            return torch.floor(floats(*shape) * (256 / 255))

        def k6_run(instance, planes):
            """The K6 wrapper of ``instance`` on planes {(u8 tile, count):
            tensor}: (its output, its joint, its src)."""
            cj, cs, self_guided, u8_tile = instance
            j = planes[(u8_tile, cj)]
            if self_guided:
                return bilateral_color_self_batched(j, -1, SIGMA_C,
                                                    SIGMA_S), j, j
            s = planes[(u8_tile, cs)]
            fn = (bilateral_packed_joint_batched if u8_tile
                  else joint_bilateral_planar_batched)
            return fn(j, s, -1, SIGMA_C, SIGMA_S), j, s

        k6_planes = {(True, 3): imgs[:BF_N].to(torch.float32).contiguous(),
                     (True, 1): r_u8[:BF_N, None].contiguous(),
                     (False, 3): floats(BF_N, 3, H, W),
                     (False, 1): floats(BF_N, 1, H, W)}
        small = u8s(1, 3, 20, 27)
        small_planes = {(u8_tile, c): small[:, :c].contiguous()
                        for u8_tile in (True, False) for c in (1, 3)}
        for name, instance in K6_MAIN.items():
            for shape, planes in (("{}x{}x{}".format(BF_N, H, W), k6_planes),
                                  ("1x20x27", small_planes)):
                qk, j, s = k6_run(instance, planes)
                jj = j[:K6_SUBSET]
                qp = bilateral_joint_plain(
                    jj, jj if s is j else s[:K6_SUBSET], bf_radius, gcc, gsc,
                    u8=instance[3])
                qk = qk[:K6_SUBSET]
                torch.cuda.synchronize()
                err = (qk - qp).abs().max().item()
                if planes is k6_planes:
                    errs[name] = err
                dl = (u8(qk) - u8(qp)).abs()
                eq = (dl == 0).float().mean().item()
                print("K6 {} {}: max|d|={:.3e}  uint8 max {:.0f} level, "
                      "{:.4%} equal".format(name, shape, err,
                                            dl.max().item(), eq))
                check(dl.max().item() <= 1 and eq >= 0.999,
                      "K6 {} {}: <= 1 uint8 level, >= 99.9% equal".format(
                          name, shape))

    phase("3t. training kernels vs plain on the card")
    train_errs, train_in = check_training_kernels(dev, args.seed)
    errs.update(train_errs)

    phase("3b. guided parity on cuda vs tests/fixtures/guided_golden.npz")
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "guided_golden.npz")
    with np.load(fixture) as z:
        golden = {k: z[k] for k in z.files}
    for radius in (3, 45, 52):
        key = "small" if radius == 3 else "big"
        for eps in (3.0, 7.0):
            tag = "r{}_e{}".format(radius, int(eps))
            worst = {}
            for kind in ("color", "colorsrc", "gray"):
                g_u8 = golden["img_{}_guide_{}".format(
                    key, "gray" if kind == "gray" else "color")]
                s_u8 = (g_u8 if kind == "colorsrc"
                        else golden["img_{}_src".format(key)])
                got = guided_filter_u8(g_u8, s_u8, radius, eps, device=dev)
                exp = golden["out_{}_{}".format(tag, kind)]
                worst[kind] = int(np.abs(got.astype(np.int32)
                                         - exp.astype(np.int32)).max())
            check(max(worst.values()) <= 1,
                  "guided {} within 1 uint8 level of the fixtures {}".format(
                      tag, worst))

    phase("3b. color self-guided bilateral on cuda vs cv2.bilateralFilter")
    import cv2
    judg = torch.from_numpy(make_synthetic_comps(args.seed, K))
    for shape in ((256, 256), (512, 768)):
        photo = np.ascontiguousarray(np.moveaxis(
            photos(brng, 1, *shape)[0], 0, -1))
        for sc, ss in ((20.0, 22.0), (30.0, 8.0)):
            got = joint_bilateral_filter_u8(photo, photo, -1, sc, ss,
                                            device=dev)
            ref = cv2.bilateralFilter(photo, -1, sc, ss)
            d = np.abs(got.astype(int) - ref.astype(int))
            dw = abs(whdr(torch.from_numpy(got[..., ::-1] / 255.0), judg)
                     - whdr(torch.from_numpy(ref[..., ::-1] / 255.0), judg))
            print("color-self {}x{} c{} s{}: max {} level, {:.4%} differ, "
                  "|dWHDR|={:.2e}".format(*shape, sc, ss, d.max(),
                                          (d > 0).mean(), dw.item()))
            check(d.max() <= 1 and (d > 0).mean() < 0.02
                  and dw.item() < 1e-3,
                  "color-self {}x{} c{} s{} matches cv2.bilateralFilter"
                  .format(*shape, sc, ss))

    phase("3b. the chain at 2 iterations against K5 applied twice")
    with torch.no_grad():
        for rows in (480, 512):
            g_in = device_photos(cgen, 1, rows, 512)
            s_in = device_photos(cgen, 1, rows, 512)[:, :1].contiguous()
            chained = guided_filter_chain(g_in, s_in, GF_R, GF_EPS, 2)
            twice = guided_filter_fused(g_in, guided_filter_fused(
                g_in, s_in, GF_R, GF_EPS), GF_R, GF_EPS)
            d = (torch.floor(chained) - torch.floor(twice)).abs()
            print("1x{}x512: floor levels max {:.0f}, {:.4%} differ".format(
                rows, d.max().item(), (d > 0).float().mean().item()))
            check(d.max().item() <= 1, "chain x2 within 1 floored level of K5 "
                  "twice at 1x{}x512".format(rows))

    phase("4. serving: 3 requests through pipeline_fn('bf') + whdr_batch")
    requests = [torch.from_numpy(photos(rng, B, H, W)).to(dev)
                for _ in range(3)]
    comps = [torch.from_numpy(make_synthetic_comps(args.seed + i, K,
                                                   batch=B)).to(dev)
             for i in range(3)]
    bf = pipeline_fn("bf", net, dev)
    wrappers = {"cnn_fwd": reflectance_cnn,
                "bilateral_gray_self": bilateral_gray_self,
                "whdr_gather": gather_pairs,
                "box_filter": box_filter_planar,
                "guided_filter": guided_filter_fused,
                "bilateral_joint": joint_bilateral_planar_batched,
                "bilateral_color_self": bilateral_color_self_batched,
                "bilateral_packed_joint": bilateral_packed_joint_batched,
                "cnn_train_fwd": k7.trunk_forward,
                "cnn_train_bwd": k7.trunk_backward,
                "whdr_scatter": scatter_pairs,
                "guide_stats": guide_stats,
                "guided_apply_cached": guided_apply_cached,
                "cnn_train_bwd_split": k7.trunk_backward_variant}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def read_launches(run, names):
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        print("launches in the {} run: {}".format(run, counts))
        for name in names:
            check(counts[name] > 0, "{} launched by the {} run".format(
                name, run))
        return counts

    with torch.no_grad():
        reset_launches()
        served = []
        for img, cmp in zip(requests, comps):
            q = bf(img)
            served.append((q, whdr_batch(q / 255.0, cmp)))
        launches = read_launches("bf serving", (
            "cnn_fwd", "bilateral_gray_self", "whdr_gather"))
        for (q, score), img, cmp in zip(served, requests, comps):
            check(q.shape == (B, H, W) and bool(torch.isfinite(q).all())
                  and q.min().item() >= 0 and q.max().item() <= 255,
                  "output [{}, {}, {}], finite, in [0, 255]".format(B, H, W))
            # the same pipeline through the plain versions, on the card
            # (WHDR's plain gather runs on the CPU copy)
            xr = (img.flip(1).to(torch.float32) / 255.0).reshape(B, 3, H * W)
            rp = reflectance_cnn_plain(xr, weights, srgb_input=True)
            qp = u8(bilateral_gray_self_plain(
                torch.floor(rp * 255.0).reshape(B, H, W).to(torch.uint8), -1,
                SIGMA_C, SIGMA_S))
            score_p = whdr_batch(qp.cpu() / 255.0, cmp.cpu())
            dl = (q - qp).abs()
            dw = abs(score.item() - score_p.item())
            print("WHDR {:.6f} (plain {:.6f}, |d|={:.2e}); uint8 max {:.0f} "
                  "level, {:.4%} equal".format(
                      score.item(), score_p.item(), dw, dl.max().item(),
                      (dl == 0).float().mean().item()))
            check(dw <= 1e-3, "|dWHDR| <= 0.001 against the plain pipeline")
            check(dl.max().item() <= 1, "<= 1 uint8 level against plain")

    phase("4. serving: 3 requests through pipeline_fn('gf') + whdr_batch")
    gf_requests = [torch.from_numpy(photos(grng, B, H, W)).to(dev)
                   for _ in range(3)]
    gf = pipeline_fn("gf", net, dev)
    with torch.no_grad():
        reset_launches()
        gf_served = []
        for img, cmp in zip(gf_requests, comps):
            q = gf(img)
            gf_served.append((q, whdr_batch(q / 255.0, cmp)))
        gf_launches = read_launches("gf serving", (
            "cnn_fwd", "guided_filter", "whdr_gather"))
        for (q, score), img, cmp in zip(gf_served, gf_requests, comps):
            check(q.shape == (B, H, W) and bool(torch.isfinite(q).all())
                  and q.min().item() >= 0 and q.max().item() <= 255,
                  "output [{}, {}, {}], finite, in [0, 255]".format(B, H, W))
            check(torch.unique(q).numel() > 20, "the filter had real work")
            # the same pipeline through the plain versions, on the card
            guide = img.flip(1).to(torch.float32)
            xr = (guide / 255.0).reshape(B, 3, H * W)
            rp = reflectance_cnn_plain(xr, weights, srgb_input=True)
            qp = u8(guided_filter_fused_plain(
                guide, torch.floor(rp * 255.0).reshape(B, 1, H, W), GF_R,
                GF_EPS)[:, 0])
            score_p = whdr_batch(qp.cpu() / 255.0, cmp.cpu())
            dl = (q - qp).abs()
            dw = abs(score.item() - score_p.item())
            print("WHDR {:.6f} (plain {:.6f}, |d|={:.2e}); uint8 max {:.0f} "
                  "level, {:.4%} equal".format(
                      score.item(), score_p.item(), dw, dl.max().item(),
                      (dl == 0).float().mean().item()))
            check(dw <= 1e-3, "|dWHDR| <= 0.001 against the plain pipeline")
            check(dl.max().item() <= 1, "<= 1 uint8 level against plain")

    phase("4c. the iterated chain: guided_filter_iterated(planar=True), "
          "{} iterations".format(CHAIN_ITERS))
    chain_data, chain_launches = {}, {}
    with torch.no_grad():
        for name, (fh, fw) in CHAIN_FRAMES.items():
            g_in = device_photos(cgen, 1, fh, fw)
            s_in = device_photos(cgen, 1, fh, fw)[:, :1].contiguous()
            reset_launches()
            q = guided_filter_iterated(g_in, s_in, GF_R, GF_EPS, CHAIN_ITERS,
                                       planar=True)
            chain_launches[name] = read_launches(
                "{} chain".format(name),
                ("guide_stats", "guided_apply_cached"))
            check(chain_launches[name]["guided_filter"] == 0,
                  "K5 not launched by the {} chain".format(name))
            check(q.shape == (1, 1, fh, fw) and bool(torch.isfinite(q).all())
                  and torch.unique(torch.round(q)).numel() > 20,
                  "{} chain output [1, 1, {}, {}], finite, real work".format(
                      name, fh, fw))
            if name == "4K":
                err, levels, close = chain_gate(
                    q, guided_filter_chain_plain(g_in, s_in, GF_R, GF_EPS,
                                                 CHAIN_ITERS))
                print("4K chain against the plain chain on the card: "
                      "max|d|={:.3e}, uint8 max {:.0f} level".format(err,
                                                                    levels))
                check(close and levels <= 1, "4K chain: rtol 1e-3 / atol "
                      "0.05, <= 1 uint8 level against the plain chain")
            chain_data[name] = (g_in, s_in)

    phase("4t. training: {} steps of fit at batch {} x {}x{}, K={}, {} "
          "images on the card".format(TRAIN_STEPS, TB, H, W, K, TRAIN_N))
    train_data = training_set(args.seed + 7, TRAIN_N, K)
    flagship = NetworkConfig()
    train_kernels = ("cnn_train_fwd", "cnn_train_bwd", "whdr_gather",
                     "whdr_scatter")

    def train_run(steps, **kw):
        losses = []
        state = fit(flagship, LossConfig(), train_data, steps * TB, TB,
                    random_seed=args.seed, device=dev,
                    progress=lambda s, n, m: losses.append(m["loss_total"]),
                    **kw)
        return state, losses

    reset_launches()
    state_k, loss_k = train_run(TRAIN_STEPS)
    train_launches = read_launches("training", train_kernels)
    reset_launches()
    state_p, loss_p = train_run(TRAIN_STEPS, kernels=False)
    plain_counts = read_launches("plain training", ())
    check(all(plain_counts[name] == 0 for name in train_kernels),
          "no training kernel launched by the plain run")
    rel = [abs(a - b) / abs(b) for a, b in zip(loss_k, loss_p)]
    print("loss_total kernels {:.6f} -> {:.6f}, plain {:.6f} -> {:.6f}; worst "
          "step {:.2e} relative".format(loss_k[0], loss_k[-1], loss_p[0],
                                        loss_p[-1], max(rel)))
    check(len(loss_k) == len(loss_p) == TRAIN_STEPS
          and all(np.isfinite(loss_k)) and max(rel) <= 1e-3,
          "every step's loss_total within 1e-3 of the plain run")
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp, "smoke", interval=10 * TB)
        train_run(10, checkpointer=ck)
        p10, o10, _ = load_checkpoint(ck.path(10 * TB))
        t0 = time.perf_counter()
        resumed, _ = train_run(TRAIN_STEPS, init_params=p10,
                               init_opt_state=o10, base_samples=10 * TB)
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) / (TRAIN_STEPS - 10) * 1e3
    print("fit, resumed for 10 steps: {:.3f} ms per step on the host's clock "
          "(the set's upload included; not gated)".format(fit_ms))
    diff = max((resumed.params[layer][part] - state_k.params[layer][part])
               .abs().max().item() for layer in state_k.params
               for part in state_k.params[layer])
    print("resume at step 10 against 20 uninterrupted steps: params max|d|="
          "{:.3e}".format(diff))
    check(resumed.samples == state_k.samples and diff <= 1e-6,
          "10 steps + checkpoint + resume to 20 equals 20 steps (1e-6)")

    phase("4n. the network families: compute_losses at batch {} x {}x{}, "
          "kernels on and off".format(NET_B, NET_HW, NET_HW))
    check_network_families(dev, args.seed)

    phase("5. the train CLI's fit stage on cuda and on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "lmdbs")
        os.makedirs(os.path.join(root, "iiw"))
        for stem, data in (
                ("trainValTest_train", train_data),
                ("trainValTest_val",
                 training_set(args.seed + 9, TRAIN_VAL_N, K))):
            np.savez(os.path.join(root, "iiw", "{}_{}_{}_linear.npz".format(
                stem, H, W)), images=data["images"].transpose(0, 3, 1, 2),
                comparisons=data["comparisons"][:, :, None, :])
        # the flagship's flags, then the CLI's default network flags
        # (convStaticWithSigmoid, 2 layers of 16 3x3 filters, rRelMax: no
        # K7), each from a seeded warm start of its config
        default_cfg = train_cli.net_config_from_args(
            train_cli.build_parser().parse_args([]))
        runs = [("flagship flags", TRAIN_FLAGS, flagship, train_kernels),
                ("default flags", [], default_cfg,
                 ("whdr_gather", "whdr_scatter"))]
        for run, flags, cfg, kernel_names in runs:
            print("train CLI, {}: {}".format(run, cfg))
            warm = os.path.join(tmp, "warm.npz")
            save_checkpoint(warm, init_network(
                cfg, torch.Generator().manual_seed(args.seed)))
            cli_args = ["--stage=fit"] + flags + [
                "--iterations=40", "--batch_size={}".format(TB),
                "--checkpoint_interval=20", "--height={}".format(H),
                "--width={}".format(W), "--random_seed=0",
                "--predictCaffemodel", warm, "--data_root", root,
                "--experiment=smoke"]
            cli_out = {}
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, run.split()[0], device)
                reset_launches()
                t0 = time.perf_counter()
                train_cli.main(cli_args + ["--results_root", out,
                                           "--device", device])
                print("train CLI, {}, on {}: {:.2f} s".format(
                    run, device, time.perf_counter() - t0))
                if device == "cuda":
                    read_launches("train CLI on cuda, " + run, kernel_names)
                exp = os.path.join(out, "smoke")
                snaps = sorted(os.listdir(os.path.join(exp, "snapshots")))
                check([s_.rsplit("_", 1)[1] for s_ in snaps]
                      == ["20.npz", "40.npz"] and all(
                          s_.startswith(cfg.network_type + "_")
                          for s_ in snaps),
                      "{}, {}: {} snapshots _iter_20 and _iter_40".format(
                          run, device, cfg.network_type))
                progs = os.listdir(os.path.join(exp, "progressions"))
                check(len(progs) == 1
                      and os.listdir(os.path.join(exp, "scores"))
                      and os.listdir(os.path.join(exp, "framerates")),
                      "{}, {}: progressions/*.json, scores/, "
                      "framerates/".format(run, device))
                with open(os.path.join(exp, "progressions", progs[0])) as f:
                    prog = json.load(f)["test"]
                cli_out[device] = (prog, load_checkpoint(os.path.join(
                    exp, "snapshots", snaps[-1]))[0])
            (prog_c, par_c), (prog_p, par_p) = (cli_out["cuda"],
                                                cli_out["cpu"])
            dw = abs(prog_c[-1]["WHDR"] - prog_p[-1]["WHDR"]) / 100.0
            dp = max(np.abs(par_c[layer][part] - par_p[layer][part]).max()
                     for layer in par_p for part in par_p[layer])
            print("train CLI, {}: val WHDR cuda {} cpu {}: |d|={:.2e}; final "
                  "params max|d|={:.3e}".format(
                      run, [e["WHDR"] for e in prog_c],
                      [e["WHDR"] for e in prog_p], dw, dp))
            check(dw <= 1e-3 and dp <= 1e-3, "train CLI, {}, on cuda against "
                  "the CPU: final val WHDR within 0.001, params within "
                  "1e-3".format(run))

    phase("5. CLIs on cuda")
    with tempfile.TemporaryDirectory() as tmp:
        photo = np.moveaxis(photos(rng, 1, H, W)[0], 0, -1)
        png = os.path.join(tmp, "smoke.png")
        cv2.imwrite(png, photo)
        cnn = dec_cli.ReflectanceCNN(params=params, device=dev)
        dec_cli.decompose_image(png, tmp, net=cnn)
        r_png = os.path.join(tmp, "smoke-r.png")
        filt_cli.main(["--filter_type=bilateral", "--sigma_color=20",
                       "--sigma_spatial=22", "--filename_in", r_png,
                       "--guidance_in", r_png, "--path_out", tmp,
                       "--device", "cuda"])
        names = ["smoke-r.png", "smoke-r_colorized.png",
                 "smoke-s_colorized.png", "smoke-r_bilateral_c20.0s22.0.png"]
        for name in names:
            check(os.path.isfile(os.path.join(tmp, name)), "wrote " + name)
        got = cv2.imread(os.path.join(tmp, names[3]))[..., 0].astype(int)
        with torch.no_grad():
            want = bf(torch.from_numpy(
                np.ascontiguousarray(np.moveaxis(photo, -1, 0))[None]))
        d = np.abs(got - want[0].cpu().numpy().astype(int)).max()
        check(d <= 1, "CLI output within 1 level of pipeline_fn('bf') "
              "(max {})".format(d))

        # guided c3 s45: the -r.png filtered with the photo as its guide,
        # exact (K5) and with --subsample=4 (the Fast Guided Filter: K4)
        guided_args = ["--filter_type=guided", "--sigma_color=3",
                       "--sigma_spatial=45", "--filename_in", r_png,
                       "--guidance_in", png, "--path_out", tmp,
                       "--device", "cuda"]
        reset_launches()
        filt_cli.main(guided_args)
        filt_cli.main(guided_args + ["--subsample=4"])
        cli_launches = read_launches("guided CLI", ("box_filter",
                                                    "guided_filter"))
        gf_names = ["smoke-r_guided_c3.0s45.0.png",
                    "smoke-r_guided_sub4_c3.0s45.0.png"]
        for name in gf_names:
            check(os.path.isfile(os.path.join(tmp, name)), "wrote " + name)
        got = cv2.imread(os.path.join(tmp, gf_names[0]))[..., 0].astype(int)
        with torch.no_grad():
            want = gf(torch.from_numpy(
                np.ascontiguousarray(np.moveaxis(photo, -1, 0))[None]))
        d = np.abs(got - want[0].cpu().numpy().astype(int)).max()
        check(d <= 1, "guided CLI output within 1 level of "
              "pipeline_fn('gf') (max {})".format(d))
        fast = cv2.imread(os.path.join(tmp, gf_names[1]))[..., 0].astype(int)
        print("--subsample=4 against the exact file: mean {:.3f}, max {} "
              "uint8 levels (an approximation; not gated)".format(
                  np.abs(fast - got).mean(), np.abs(fast - got).max()))
        # the same Fast Guided Filter on the CPU: the plain box and resizes
        want = fast_guided_filter_u8(cv2.imread(png), cv2.imread(r_png),
                                     GF_R, GF_EPS, 4, device="cpu")
        d = np.abs(fast - want[..., 0].astype(int)).max()
        check(d <= 1, "guided CLI --subsample=4 within 1 level of "
              "fast_guided_filter_u8 on the CPU (max {})".format(d))

        # bilateral c20 s22 on K6: the -r.png guided by the photo, and the
        # photo by itself; each file against the same call on the CPU
        joint_dir = os.path.join(tmp, "joint")
        os.mkdir(joint_dir)
        for case, (src_png, counter) in {
                "BF(reflectance, photo)": (r_png, "bilateral_packed_joint"),
                "color-self": (png, "bilateral_color_self")}.items():
            reset_launches()
            filt_cli.main(["--filter_type=bilateral", "--sigma_color=20",
                           "--sigma_spatial=22", "--filename_in", src_png,
                           "--guidance_in", png, "--path_out", joint_dir,
                           "--device", "cuda"])
            launches[counter] = read_launches(
                "bilateral CLI " + case, (counter,))[counter]
            name = os.path.basename(src_png)[:-4] + "_bilateral_c20.0s22.0.png"
            got = cv2.imread(os.path.join(joint_dir, name)).astype(int)
            want = filt_cli.apply_filter(
                "bilateral", cv2.imread(src_png), cv2.imread(png), 20.0, 22.0,
                device="cpu")
            d = np.abs(got - want.astype(int)).max()
            check(d <= 1, "bilateral CLI {} within 1 level of the same call "
                  "on the CPU (max {})".format(case, d))

        # the float filter's entry point (the width-sharded filter calls
        # it in the JAX package), called directly: photo joint, gray src
        reset_launches()
        r_gray = cv2.imread(r_png)[..., 0].astype(np.float32)
        fast = joint_bilateral_filter_fast(
            torch.from_numpy(photo).to(dev), torch.from_numpy(r_gray).to(dev),
            -1, SIGMA_C, SIGMA_S)
        launches["bilateral_joint"] = read_launches(
            "joint_bilateral_filter_fast", ("bilateral_joint",))[
                "bilateral_joint"]
        want = joint_bilateral_filter_fast(photo, r_gray, -1, SIGMA_C,
                                           SIGMA_S)
        err = (fast.cpu() - want).abs().max().item()
        check(fast.shape == (H, W) and err <= 1e-3,
              "joint_bilateral_filter_fast on cuda within 1e-3 of the CPU "
              "(max {:.2e})".format(err))

    phase("6. times (CUDA events; inputs resident on the card)")
    times = {}
    with torch.no_grad():
        times["cnn_fwd"] = (
            time_ms(lambda: reflectance_cnn(x, weights,
                                                   srgb_input=True), 20),
            time_ms(lambda: reflectance_cnn_plain(
                x, weights, srgb_input=True), 20))
        # K2 on the bf path's uint8 levels (its row), then the float form
        # on the same planes
        times["bilateral_gray_self"] = (
            time_ms(lambda: bilateral_gray_self(
                r_levels, -1, SIGMA_C, SIGMA_S), 10),
            time_ms(lambda: bilateral_gray_self_plain(
                r_levels, -1, SIGMA_C, SIGMA_S), 2))
        k2_float_times = (
            time_ms(lambda: bilateral_gray_self(
                r_u8, -1, SIGMA_C, SIGMA_S), 10),
            time_ms(lambda: bilateral_gray_self_plain(
                r_u8, -1, SIGMA_C, SIGMA_S), 1, warmup=0))
        # the range table's three layouts in turns, on the served levels
        # and the script's own planes
        k2_tables = k2_table.measure(dict(
            {"served levels": r_levels},
            **k2_table.make_inputs(dev, args.seed)))
        # K6's range table in three layouts, on phase 3's photos by
        # themselves and guiding the reflectance levels
        k6_tables = k6_table.measure({
            "color-self": (k6_planes[(True, 3)], None),
            "BF(reflectance, photo)": (k6_planes[(True, 3)],
                                       k6_planes[(True, 1)])})
        slice_ms = time_ms(
            lambda: whdr_batch(bf(requests[0]) / 255.0, comps[0]), 10)
        planes = box_in["32x256x256"][0]
        times["box_filter"] = (
            time_ms(lambda: box_filter_planar(planes, GF_R), 20),
            time_ms(lambda: box_filter_planar_plain(planes, GF_R), 5))
        big = box_in["1x2160x3840"][0]
        big_times = (time_ms(lambda: box_filter_planar(big, GF_R), 20),
                     time_ms(lambda: box_filter_planar_plain(big, GF_R), 5))
        # gf_in's entries are (guide, src, radius); C=1 and C=3 at GF_R
        times["guided_filter"] = (
            time_ms(lambda: guided_filter_fused(*gf_in["C=1"], GF_EPS), 20),
            time_ms(lambda: guided_filter_fused_plain(*gf_in["C=1"], GF_EPS),
                    5))
        c3_times = (
            time_ms(lambda: guided_filter_fused(*gf_in["C=3"], GF_EPS), 10),
            time_ms(lambda: guided_filter_fused_plain(*gf_in["C=3"], GF_EPS),
                    3))
        gf_ms = time_ms(
            lambda: whdr_batch(gf(gf_requests[0]) / 255.0, comps[0]), 10)
        # every instantiation of K6 at phase 3's 8 x 256x256 planes, the
        # kernels back to back so that no plain loop idles the card between
        # them; then the plain versions, host-bound loops of 3,421 taps,
        # once each without a warm-up
        k6_ms = {instance: time_ms(lambda: k6_run(instance, k6_planes), 20)
                 for instance in K6_INSTANCES}
        k6_times = {}
        for instance in K6_INSTANCES:
            _, j, s = k6_run(instance, k6_planes)
            k6_times[instance] = (
                k6_ms[instance],
                time_ms(lambda: bilateral_joint_plain(
                    j, s, bf_radius, gcc, gsc, u8=instance[3]), 1,
                    warmup=0))
        for name, instance in K6_MAIN.items():
            times[name] = k6_times[instance]
        # the training kernels at the flagship's 20 x 256x256; the backward
        # as the training step runs it (no input cotangent)
        tx, tg, tflat, tshape = (train_in[key] for key in
                                 ("x", "g", "flat", "shape"))
        times["cnn_train_fwd"] = (
            time_ms(lambda: k7.trunk_forward(tx, tflat, tshape), 20),
            time_ms(lambda: k7.trunk_forward_plain(tx, tflat, tshape), 10))
        times["cnn_train_bwd"] = (
            time_ms(lambda: k7.trunk_backward(tx, tg, tflat, tshape, False),
                    20),
            time_ms(lambda: k7.trunk_backward_plain(tx, tg, tflat, tshape,
                                                    False), 5))
        sidx, sg1, sg2 = train_in["scatter"]
        # K3 and K8 beside the one PyTorch call computing the same function
        # (indices joined beforehand): advanced indexing for K3, a zeroed
        # plane's index_put_(accumulate=True) for K8; each call is bound by
        # the host, whose speed drifts, so kernel and library in turns
        bi = torch.arange(B, device=dev)[:, None].expand(B, 2 * K)
        yi, xi = (torch.cat([idx[i], idx[i + 2]], 1).long() for i in (0, 1))
        sb = torch.arange(TB, device=dev)[:, None].expand(TB, 2 * K)
        sy, sx = (torch.cat([sidx[i], sidx[i + 2]], 1).long() for i in (0, 1))
        sg = torch.cat([sg1, sg2], 1)
        library = {}
        ms_k, library["whdr_gather"] = time_turns(
            lambda: gather_pairs(plane, *idx), lambda: plane[bi, yi, xi], 100)
        times["whdr_gather"] = (
            ms_k, time_ms(lambda: gather_pairs_plain(plane, *idx), 100))
        ms_k, library["whdr_scatter"] = time_turns(
            lambda: scatter_pairs((TB, H, W), *sidx, sg1, sg2),
            lambda: torch.zeros((TB, H, W), device=dev).index_put_(
                (sb, sy, sx), sg, accumulate=True), 100)
        times["whdr_scatter"] = (
            ms_k, time_ms(lambda: scatter_pairs_plain((TB, H, W), *sidx, sg1,
                                                      sg2), 100))
        # the 3x chain on K9 and as three K5 calls, each frame; K9's two
        # launches and their plain versions on the 4K frame
        chain_ms, k5x3_ms = {}, {}
        for name, (g_in, s_in) in chain_data.items():
            iters = 10 if name == "4K" else 4
            chain_ms[name] = time_ms(lambda: guided_filter_iterated(
                g_in, s_in, GF_R, GF_EPS, CHAIN_ITERS, planar=True), iters)

            def k5_chain():
                q = s_in
                for _ in range(CHAIN_ITERS):
                    q = guided_filter_fused(g_in, q, GF_R, GF_EPS)
                return q
            k5x3_ms[name] = time_ms(k5_chain, iters)
        g4, s4 = chain_data["4K"]
        st4 = guide_stats(g4, GF_R, GF_EPS)
        times["guide_stats"] = (
            time_ms(lambda: guide_stats(g4, GF_R, GF_EPS), 20),
            time_ms(lambda: guide_stats_plain(g4, GF_R, GF_EPS), 3))
        times["guided_apply_cached"] = (
            time_ms(lambda: guided_apply_cached(st4, g4, s4, GF_R), 20),
            time_ms(lambda: guided_apply_cached_plain(st4, g4, s4, GF_R), 3))
        chain_plain_ms = time_ms(lambda: guided_filter_chain_plain(
            g4, s4, GF_R, GF_EPS, CHAIN_ITERS), 2)
    # the training step as fit runs it, from the seeded flagship init on the
    # resident set's first batch; kernels, then the plain versions
    step_params = trainable(init_network(
        flagship, torch.Generator().manual_seed(args.seed)), dev)
    step, plain_step = (
        make_train_step(flagship, LossConfig(), step_params,
                        make_optimizer("ADAM", 1e-3, step_params),
                        kernels=kernels) for kernels in (True, False))
    step_in = tuple(torch.from_numpy(train_data[key][:TB]).to(dev)
                    for key in ("images", "comparisons"))
    step_ms = time_ms(lambda: step(*step_in), 20)
    plain_step_ms = time_ms(lambda: plain_step(*step_in), 10)
    for name, (ms, plain_ms) in times.items():
        print("{}: kernel {:.4f} ms, plain {:.4f} ms at the main path's "
              "shapes".format(name, ms, plain_ms))
    print("bilateral_gray_self float32 {}x{}x{}: kernel {:.4f} ms, plain "
          "{:.4f} ms (the row above: uint8 levels)".format(B, H, W,
                                                          *k2_float_times))
    k2_table.print_table(k2_tables)
    k6_table.print_table(k6_tables)
    print("box_filter 1x2160x3840 r={}: kernel {:.4f} ms, plain {:.4f} "
          "ms".format(GF_R, *big_times))
    print("guided_filter C=3 32x256x256 r={}: kernel {:.4f} ms, plain "
          "{:.4f} ms".format(GF_R, *c3_times))
    print("bf slice + WHDR: {:.3f} ms per batch of {} = {:.1f} images/s "
          "({:.2f} MP/s)".format(slice_ms, B, B / slice_ms * 1e3,
                                 B * H * W / slice_ms / 1e3))
    print("gf slice + WHDR: {:.3f} ms per batch of {} = {:.1f} images/s "
          "({:.2f} MP/s)".format(gf_ms, B, B / gf_ms * 1e3,
                                 B * H * W / gf_ms / 1e3))
    for (cj, cs, self_guided, u8_tile), (ms, plain_ms) in k6_times.items():
        print("K6 {} cj={} cs={}{} {}x{}x{}: kernel {:.4f} ms, plain {:.4f} "
              "ms".format("u8" if u8_tile else "float", cj, cs,
                          " self" if self_guided else "", BF_N, H, W, ms,
                          plain_ms))
    for name, what in (("bilateral_color_self", "color-self"),
                       ("bilateral_packed_joint", "BF(reflectance, photo)")):
        print("{} bilateral c20 s22, {} x {}x{}: {:.2f} MP/s".format(
            what, BF_N, H, W, BF_N * H * W / times[name][0] / 1e3))
    for name, ms in library.items():
        print("{}: one PyTorch call {:.4f} ms".format(name, ms))
    print("training step, batch {} x {}x{}, K={}: kernels {:.3f} ms = {:.1f} "
          "images/s; plain {:.3f} ms = {:.1f} images/s".format(
              TB, H, W, K, step_ms, TB / step_ms * 1e3, plain_step_ms,
              TB / plain_step_ms * 1e3))
    for name, (fh, fw) in CHAIN_FRAMES.items():
        mp = fh * fw / 1e6
        print("{}x chain r={} eps={}, {} 1x{}x{} C=1: K9 {:.4f} ms = {:.2f} "
              "MP/s; three K5 calls {:.4f} ms = {:.2f} MP/s".format(
                  CHAIN_ITERS, GF_R, GF_EPS, name, fh, fw, chain_ms[name],
                  mp / chain_ms[name] * 1e3, k5x3_ms[name],
                  mp / k5x3_ms[name] * 1e3))
    print("4K chain on the plain versions: {:.4f} ms".format(chain_plain_ms))

    phase("6. K9's passes apart, the column passes at each segment length")
    k9_passes.print_table(k9_passes.measure(dev, args.seed))

    phase("6. K7's backward split by phase (TPU kernel 19), inputs made "
          "with numpy from --seed")
    sx, sg, sflat = split.make_inputs(dev, args.seed)
    reset_launches()
    split_run = split.measure(sx, sg, sflat)
    split_launches = read_launches("K7 backward split", (
        "cnn_train_bwd_split",))
    split.print_table(split_run, registers=split.register_report())
    times["cnn_train_bwd_split"] = (
        split_run["ms"]["full"],
        time_ms(lambda: k7.trunk_backward_variant_plain(
            sx, sg, sflat, split.SHAPE, 0), 5))
    print("K7 backward in the times above: {:.4f} ms; in the split's turns: "
          "{:.4f} ms".format(times["cnn_train_bwd"][0],
                             split_run["product_ms"]))

    phase("7. profile: device time per batch (torch.profiler, {} "
          "batches each)".format(PROFILE_BATCHES))
    slices = {
        "bf": (lambda: whdr_batch(bf(requests[0]) / 255.0, comps[0]),
               slice_ms),
        "gf": (lambda: whdr_batch(gf(gf_requests[0]) / 255.0, comps[0]),
               gf_ms),
        "4K 3x chain": (lambda: guided_filter_iterated(
            g4, s4, GF_R, GF_EPS, CHAIN_ITERS, planar=True), chain_ms["4K"])}
    with torch.no_grad():
        for name, (run, wall_ms) in slices.items():
            busy, per_kernel = device_profile(run, PROFILE_BATCHES)
            if not per_kernel:
                print("{} slice: the profiler saw no device time".format(
                    name))
                continue
            print("{} slice: device busy {:.4f} ms of {:.4f} ms per "
                  "batch (phase 6's CUDA events): idle share {:.2%}"
                  .format(name, busy, wall_ms, 1 - busy / wall_ms))
            for kernel, ms in sorted(per_kernel.items(),
                                     key=lambda kv: -kv[1])[:12]:
                print("  {:9.4f} ms  {}".format(ms, kernel[:90]))
    busy, per_kernel = device_profile(lambda: step(*step_in),
                                      PROFILE_BATCHES)
    if per_kernel:
        parts = {"K7 forward": ("trunk_fwd",),
                 "K7 backward + block sum": ("trunk_bwd", "sum_partials"),
                 "K3 gather": ("whdr_gather_kernel",),
                 "K8 scatter + its memset": ("whdr_scatter", "Memset"),
                 "Adam": ("multi_tensor_apply", "adam", "Adam")}
        part_ms = {part: 0.0 for part in parts}
        part_ms["loss glue (everything else)"] = 0.0
        for kernel, ms in per_kernel.items():
            part = next((p_ for p_, keys in parts.items()
                         if any(key in kernel for key in keys)),
                        "loss glue (everything else)")
            part_ms[part] += ms
        print("training step: device busy {:.4f} ms of {:.4f} ms per step "
              "(phase 6's CUDA events): idle share {:.2%}".format(
                  busy, step_ms, 1 - busy / step_ms))
        for part, ms in part_ms.items():
            print("  {:9.4f} ms  {:5.1%}  {}".format(ms, ms / busy, part))
        for kernel, ms in sorted(per_kernel.items(),
                                 key=lambda kv: -kv[1])[:12]:
            print("  {:9.4f} ms  {}".format(ms, kernel[:90]))
    else:
        print("training step: the profiler saw no device time")

    # K3 at the serving shape: its device time, and the host's time per
    # wrapper call split into checks, allocation and launch, beside the
    # one indexing call (host clock around 1,000 calls and one synchronize)
    with torch.no_grad():
        # one profile of both, a call each per round
        _, per_kernel = device_profile(
            lambda: (gather_pairs(plane, *idx), plane[bi, yi, xi]), 50)
        print("K3 gather_pairs and indexing {}x{}: device ms per call: "
              "{}".format(B, K, "; ".join(
                  "{:.5f} {}".format(ms, kernel[:60])
                  for kernel, ms in per_kernel.items()) or "not seen"))
        g_out = torch.empty((2, B, K), dtype=torch.float32, device=dev)
        g_ptrs = [t.data_ptr() for t in idx]
        host = {
            "checks": lambda: (_build.check_tensor(plane, "plane",
                                                   torch.float32, 3),
                               _check_indices(plane.shape, plane.device,
                                              idx)),
            "allocation": lambda: plane.new_empty((2, B, K)).unbind(0),
            "launch": lambda: _build.launch(
                "rf_whdr_gather", plane.device, plane.data_ptr(), *g_ptrs,
                g_out.data_ptr(), g_out.data_ptr() + 4 * B * K, B, H, W, K),
            # the launch as every wrapper made it before: a device context,
            # a Stream object and the entry point looked up by name
            "launch, previous path": lambda: launch_before(
                "rf_whdr_gather", plane.device, plane.data_ptr(), *g_ptrs,
                g_out.data_ptr(), g_out.data_ptr() + 4 * B * K, B, H, W, K),
            "whole gather_pairs": lambda: gather_pairs(plane, *idx),
            "indexing (library)": lambda: plane[bi, yi, xi]}
        for part, run in host.items():
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                run()
            torch.cuda.synchronize()
            print("K3 host {}: {:.2f} us per call".format(
                part, (time.perf_counter() - t0) * 1e3))

    sources = {
        "cnn_fwd": ("reflectance_filtering_tpu_torch/csrc/cnn_fwd.cu",
                    "reflectance_filtering_tpu/ops/cnn_pallas.py:170"),
        "bilateral_gray_self": (
            "reflectance_filtering_tpu_torch/csrc/bilateral_gray_self.cu",
            "reflectance_filtering_tpu/ops/bilateral_pallas.py:207"),
        "whdr_gather": ("reflectance_filtering_tpu_torch/csrc/whdr_gather.cu",
                        "reflectance_filtering_tpu/ops/"
                        "whdr_gather_pallas.py:53"),
        "box_filter": ("reflectance_filtering_tpu_torch/csrc/box_filter.cu",
                       "reflectance_filtering_tpu/ops/box_pallas.py:86"),
        "guided_filter": ("reflectance_filtering_tpu_torch/csrc/guided.cu",
                          "reflectance_filtering_tpu/ops/guided_mxu.py:82"),
        "bilateral_joint": (
            "reflectance_filtering_tpu_torch/csrc/bilateral_joint.cu",
            "reflectance_filtering_tpu/ops/bilateral_pallas.py:90"),
        "bilateral_color_self": (
            "reflectance_filtering_tpu_torch/csrc/bilateral_joint.cu",
            "reflectance_filtering_tpu/ops/bilateral_pallas.py:431"),
        "bilateral_packed_joint": (
            "reflectance_filtering_tpu_torch/csrc/bilateral_joint.cu",
            "reflectance_filtering_tpu/ops/bilateral_pallas.py:661"),
        "cnn_train_fwd": ("reflectance_filtering_tpu_torch/csrc/cnn_train.cu",
                          "reflectance_filtering_tpu/ops/"
                          "cnn_train_pallas.py:107"),
        "cnn_train_bwd": ("reflectance_filtering_tpu_torch/csrc/cnn_train.cu",
                          "reflectance_filtering_tpu/ops/"
                          "cnn_train_pallas.py:136"),
        "whdr_scatter": ("reflectance_filtering_tpu_torch/csrc/whdr_gather.cu",
                         "reflectance_filtering_tpu/ops/"
                         "whdr_gather_pallas.py:80"),
        "guide_stats": ("reflectance_filtering_tpu_torch/csrc/guided_chain.cu",
                        "reflectance_filtering_tpu/ops/guided_pallas.py:717"),
        "guided_apply_cached": (
            "reflectance_filtering_tpu_torch/csrc/guided_chain.cu",
            "reflectance_filtering_tpu/ops/guided_pallas.py:648"),
        "cnn_train_bwd_split": (
            "reflectance_filtering_tpu_torch/csrc/cnn_train.cu",
            "scripts/measure_train_bwd_split.py:128"),
    }
    # each kernel's launches in the run of its own path
    launches["box_filter"] = cli_launches["box_filter"]
    launches["guided_filter"] = gf_launches["guided_filter"]
    for name in ("cnn_train_fwd", "cnn_train_bwd", "whdr_scatter"):
        launches[name] = train_launches[name]
    for name in ("guide_stats", "guided_apply_cached"):
        launches[name] = chain_launches["4K"][name]
    launches["cnn_train_bwd_split"] = split_launches["cnn_train_bwd_split"]
    # each kernel's bound at the shapes timed in phase 6; float32 FMAs count
    # 2 operations.  A bilateral tap on uint8 levels needs no expf: as in
    # cv2.bilateralFilter its weight is a range table entry (indexed by the
    # integer |d|, or by the sum of |d| over the joint planes) times the
    # tap's spatial weight, so one table load, 1 multiply, an FMA per src
    # plane and 1 add.  The float joint filter pays an expf per tap and 2 per
    # joint plane + 2 + 2 per (src plane + 1) float32 operations.
    taps = sum(1 for dy in range(-bf_radius, bf_radius + 1)
               for dx in range(-bf_radius, bf_radius + 1)
               if dy * dy + dx * dx <= bf_radius * bf_radius)
    print("bilateral disk at r={}: {} taps".format(bf_radius, taps))
    px, bf_px, t_px = B * H * W, BF_N * H * W, TB * H * W
    check(tshape == split.SHAPE == (5, 3, 32, 1) and t_px == split.PIXELS,
          "the training kernels were timed at the split's shapes, K1's "
          "network")
    c4_px = CHAIN_FRAMES["4K"][0] * CHAIN_FRAMES["4K"][1]
    nparams = k7.num_params(tshape)
    # K1 and K7: the matrix products' MACs as 3xTF32, the fuse on the FP32
    # pipe (split.matmul_ms); the FP32 pipe alone is printed beside
    macs, fuse = trunk_fmas(split.SHAPE)
    bwd_fuse = sum(split.phase_fuse_fmas().values())
    bwd_macs = sum(split.phase_fmas().values()) - bwd_fuse
    # box sums: 2 float64 adds per output and plane pass (a sliding window)
    bounds = {
        "cnn_fwd": bound(tf32_macs=macs * px, flops=2 * fuse * px,
                         nbytes=16 * px),
        # uint8 levels in (1 B), float32 out (4 B)
        "bilateral_gray_self": bound(flops=4 * taps * px, loads=taps * px,
                                     nbytes=5 * px),
        "whdr_gather": bound(nbytes=32 * B * K),
        "box_filter": bound(nbytes=8 * px, f64_adds=2 * 2 * px),
        # K5 at C = 1: 13 moment planes and 4 of (a, b), each a column and
        # a row pass
        "guided_filter": bound(nbytes=20 * px, f64_adds=2 * 34 * px),
        "bilateral_joint": bound(flops=12 * taps * bf_px, sfu=taps * bf_px,
                                 nbytes=20 * bf_px),
        "bilateral_color_self": bound(flops=8 * taps * bf_px,
                                      loads=taps * bf_px, nbytes=24 * bf_px),
        "bilateral_packed_joint": bound(flops=4 * taps * bf_px,
                                        loads=taps * bf_px, nbytes=20 * bf_px),
        "cnn_train_fwd": bound(tf32_macs=macs * t_px, flops=2 * fuse * t_px,
                               nbytes=16 * t_px + 4 * nparams),
        # the backward's FMAs per pixel: the split's phases summed
        "cnn_train_bwd": bound(tf32_macs=bwd_macs * t_px,
                               flops=2 * bwd_fuse * t_px,
                               nbytes=16 * t_px + 8 * nparams),
        "whdr_scatter": bound(nbytes=4 * t_px + 24 * TB * K),
        # K9 on the 4K frame: the guide in (12 B/px) and 9 stat planes
        # out, 2 x 9 plane passes; an application reads the stats, the
        # guide and one src plane and writes one plane, 2 x 4 + 2 x 4
        # plane passes (66 in a 3x chain)
        "guide_stats": bound(nbytes=(12 + 36) * c4_px,
                             f64_adds=2 * 18 * c4_px),
        "guided_apply_cached": bound(nbytes=(36 + 12 + 4 + 4) * c4_px,
                                     f64_adds=2 * 16 * c4_px),
    }
    f32_bounds = {
        "cnn_fwd": split.matmul_ms(macs, fuse, px, tensor_cores=False),
        "cnn_train_fwd": split.matmul_ms(macs, fuse, t_px,
                                         tensor_cores=False),
        "cnn_train_bwd": split.matmul_ms(bwd_macs, bwd_fuse, t_px,
                                         tensor_cores=False)}
    f32_bounds["cnn_train_bwd_split"] = f32_bounds["cnn_train_bwd"]
    # the split's full variant is the product backward: row 18's bound
    bounds["cnn_train_bwd_split"] = bounds["cnn_train_bwd"]
    for name, ms in f32_bounds.items():
        print("{}: bound {:.4f} ms with 3xTF32 tensor cores ({:.1%} of its "
              "rate), {:.4f} ms on the FP32 pipe alone ({:.1%})".format(
                  name, bounds[name][0], bounds[name][0] / times[name][0],
                  ms, ms / times[name][0]))
    chain_bound = bound(nbytes=(12 + 4 + 4) * c4_px)
    print("{}x chain 4K bound {:.4f} ms ({}: guide and src in, q out; K9 "
          "{:.1%} of its rate)".format(CHAIN_ITERS, chain_bound[0],
                                       chain_bound[1],
                                       chain_bound[0] / chain_ms["4K"]))
    print("chip_smoke: {:.1f} s in all".format(time.perf_counter() - _START))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
