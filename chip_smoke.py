#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reflectance_filtering_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds and serves.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits nonzero before the result line):
  1. device   the card's name and power limit (nvidia-smi), TF32 pinned off;
  2. build    nvcc builds every kernel from reflectance_filtering_tpu_torch/
              csrc/, one process per source (build seconds, the compiler's
              register report);
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 32 x 256x256, K = 1181; the box
              also on one 2160x3840 plane and on the guided CLI's
              --subsample=4 planes; the joint bilateral K6 at the JAX
              bench's 8 x 256x256, c20 s22: color-self, BF(reflectance,
              photo), float with a 3-plane joint), plus degenerate shapes,
              gated;
  3t. train   the training kernels against their plain versions on the
              card: the fused skip-layer trunk K7 (forward against the plain
              trunk, backward against plain autograd) at the flagship's
              20 x 256x256 and four other configs on a 37x53 frame, and
              the WHDR scatter-add K8 against index_put_(accumulate=True)
              with forced collisions; each backward launched twice and held
              bitwise equal;
  3b. parity  the guided filter on cuda against the golden fixtures
              (tests/fixtures/guided_golden.npz), every r in {3, 45, 52} x
              eps in {3, 7} x color/colorsrc/gray, each <= 1 uint8 level;
              the color self-guided bilateral on cuda against
              cv2.bilateralFilter at 256x256 and 512x768, c20 s22 and c30
              s8 (<= 1 level, < 2% differing, |dWHDR| < 0.001);
  4. serving  3 requests of 32 uint8 BGR 256x256 photos through
              utils.serving.pipeline_fn("bf") and whdr_batch, then 3 through
              pipeline_fn("gf") and whdr_batch; every launch counter is reset
              before each path and checked after it, and each result is held
              against the same pipeline through the plain versions;
  4t. train   train.loop.fit for 20 steps of batch 20 x 256x256, K = 1181,
              on a seeded synthetic set of 40 images resident on the card,
              once through the kernels (K7 forward and backward, K3, K8:
              each counted) and once through the plain versions on the card
              (no kernel counted): every step's loss_total within 1e-3
              relative; then 10 steps, a checkpoint, a resume for 10 more,
              against the 20 uninterrupted steps (params within 1e-6);
  5. CLIs     the train CLI's fit stage on cuda with the flagship flags
              (--iterations=40 --batch_size=20 --checkpoint_interval=20) on
              a synthetic 256x256 .npz tree, warm-started from a seeded
              .npz, its results tree checked, and the same run with
              --device cpu: final val WHDR within 0.001, final params within
              1e-3;
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
              is one), both slices' images/s, the MP/s of the color-self and
              BF(reflectance, photo) bilateral, and the training step's ms
              and images/s on the kernels and on the plain versions (not
              gated);
  7. profile  each slice's and the training step's device busy time and
              per-kernel device times (torch.profiler), and the idle share
              against phase 6's time in the same run (not gated).

The second-to-last line is {"kernels": [...]} with each kernel's launches in
the run of its path (K1-K3: bf serving; K5: gf serving; K4: the guided CLI;
K6's three wrappers: the bilateral CLI's BF(reflectance, photo) and
color-self runs, and the direct joint_bilateral_filter_fast call; K7's
forward and backward and K8: the 20 training steps), its measured error and
times, and its bound: the larger of the bytes it must move over 3.35 TB/s
and its operations, each kind over its rate: float32 operations over 66.9
TFLOP/s (132 SMs x 128 lanes x 2 x 1.98 GHz), expf over the SFU's 4.18 T/s
(16 per SM per clock), shared-memory table loads over 8.36 T/s (32 four-byte
words per SM per clock); the last line is {"ok": true, "device": {...}}.
"""
import argparse
import json
import os
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
PROFILE_BATCHES = 5
# the training slice: the JAX bench's training shape (bench.py:596-634)
TB, TRAIN_N, TRAIN_VAL_N, TRAIN_STEPS = 20, 40, 20, 20
TRAIN_FLAGS = ["--networkType=convStaticSkipLayers", "--numLayers=5",
               "--num_filters_log=5", "--kernel_pad=0",
               "--RS_est_mode=rDirectly"]
# K7 off the flagship: (n, ci, f, cout) on a 37x53 frame
K7_OTHER = [(2, 3, 16, 1), (1, 3, 32, 1), (2, 3, 128, 1), (3, 3, 16, 6)]
# the card's peak rates for the bounds (H100 SXM)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 132 * 128 * 2 * 1.98e9       # 66.9 TFLOP/s, FMA = 2
SFU_S = 132 * 16 * 1.98e9                 # 4.18 T expf/s
SMEM_LOADS_S = 132 * 32 * 1.98e9          # 8.36 T shared-memory loads/s


def bound(flops=0.0, sfu=0.0, loads=0.0, nbytes=0.0):
    """(least ms the card could take, "operations" or "bytes")."""
    ops = max(flops / F32_FLOP_S, sfu / SFU_S, loads / SMEM_LOADS_S)
    mem = nbytes / HBM_BYTES_S
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


def trunk_fmas(shape, backward=False, input_grad=False):
    """FMAs per pixel of K7 (forward; backward: rematerialisation, the fuse
    head, the chain and the weight gradients)."""
    n, ci, f, cout = shape
    fwd = ci * f + (n - 1) * f * f + n * f * cout
    if not backward:
        return fwd
    return (fwd + 2 * n * f * cout + (n - 1) * f * f + ci * f
            + (n - 1) * f * f + (ci * f if input_grad else 0))


def training_set(seed, n, k):
    """A seeded synthetic training set in the loader's NHWC layout: 1/f
    photos as linear RGB in [0, 1], and K synthetic comparisons each."""
    from reflectance_filtering_tpu_torch.utils.image import srgb_to_rgb
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    bgr = photos(np.random.RandomState(seed), n, H, W)
    rgb = np.ascontiguousarray(bgr[:, ::-1].transpose(0, 2, 3, 1)) / 255.0
    return {"images": srgb_to_rgb(rgb).astype(np.float32),
            "comparisons": make_synthetic_comps(seed + 1, k, batch=n)}


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
        fast_guided_filter_u8, guided_filter_u8)
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
    dev = torch.device("cuda", 0)

    print("== 1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "| allow_tf32 matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)

    print("== 2. build")
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

    print("== 3. kernels vs plain on the card")
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
        cases = [("main path subset", r_u8[:K2_SUBSET].contiguous())]
        for shape in ((1, 20, 27), (1, 1, 40), (2, 7, 1)):
            # smaller than the radius (33): repeated reflection; 1-wide
            cases.append(("{}x{}x{}".format(*shape), torch.from_numpy(
                np.floor(rng.rand(*shape) * 256).astype(np.float32)).to(dev)))
        worst = 0.0
        for name, planes in cases:
            qk = bilateral_gray_self(planes, -1, SIGMA_C, SIGMA_S, reps=3)
            qp = bilateral_gray_self_plain(planes, -1, SIGMA_C, SIGMA_S,
                                           reps=3)
            torch.cuda.synchronize()
            err = (qk - qp).abs().max().item()
            worst = max(worst, err)
            dl = (u8(qk) - u8(qp)).abs()
            eq = (dl == 0).float().mean().item()
            print("K2 {}: max|d|={:.3e}  uint8 max {:.0f} level, {:.4%} "
                  "equal".format(name, err, dl.max().item(), eq))
            check(dl.max().item() <= 1 and eq >= 0.999,
                  "K2 {}: <= 1 uint8 level, >= 99.9% equal".format(name))
        errs["bilateral_gray_self"] = worst

        plane = (u8(bilateral_gray_self(r_u8, -1, SIGMA_C, SIGMA_S))
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
        # and strips narrower than the window
        guide = imgs.flip(1).to(torch.float32).contiguous()
        gf_in = {"C=1": (guide, r_u8[:, None].contiguous()),
                 "C=3": (guide, torch.from_numpy(photos(
                     grng, B, H, W)).to(dev).to(torch.float32))}
        for shape in ((40, 512), (12, 40)):
            gf_in["{}x{}".format(*shape)] = tuple(
                torch.from_numpy(np.floor(grng.rand(1, c, *shape) * 256)
                                 .astype(np.float32)).to(dev) for c in (3, 1))
        worst = 0.0
        for name, (g_in, s_in) in gf_in.items():
            qk = guided_filter_fused(g_in, s_in, GF_R, GF_EPS)
            qp = guided_filter_fused_plain(g_in, s_in, GF_R, GF_EPS)
            torch.cuda.synchronize()
            err = (qk - qp).abs().max().item()
            if name in ("C=1", "C=3"):
                worst = max(worst, err)
            dl = (u8(qk) - u8(qp)).abs()
            eq = (dl == 0).float().mean().item()
            print("K5 {} r={} eps={}: max|d|={:.3e}  uint8 max {:.0f} level, "
                  "{:.4%} equal".format(name, GF_R, GF_EPS, err,
                                        dl.max().item(), eq))
            check(err <= 0.05, "K5 {}: max|d| <= 0.05".format(name))
            check(dl.max().item() <= 1 and eq >= 0.999,
                  "K5 {}: <= 1 uint8 level, >= 99.9% equal".format(name))
        errs["guided_filter"] = worst

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
                    jj, jj if s is j else s[:K6_SUBSET], bf_radius, gcc, gsc)
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

    print("== 3t. training kernels vs plain on the card")
    train_errs, train_in = check_training_kernels(dev, args.seed)
    errs.update(train_errs)

    print("== 3b. guided parity on cuda vs tests/fixtures/guided_golden.npz")
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

    print("== 3b. color self-guided bilateral on cuda vs cv2.bilateralFilter")
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

    print("== 4. serving: 3 requests through pipeline_fn('bf') + whdr_batch")
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
                "whdr_scatter": scatter_pairs}

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
                torch.floor(rp * 255.0).reshape(B, H, W), -1, SIGMA_C,
                SIGMA_S))
            score_p = whdr_batch(qp.cpu() / 255.0, cmp.cpu())
            dl = (q - qp).abs()
            dw = abs(score.item() - score_p.item())
            print("WHDR {:.6f} (plain {:.6f}, |d|={:.2e}); uint8 max {:.0f} "
                  "level, {:.4%} equal".format(
                      score.item(), score_p.item(), dw, dl.max().item(),
                      (dl == 0).float().mean().item()))
            check(dw <= 1e-3, "|dWHDR| <= 0.001 against the plain pipeline")
            check(dl.max().item() <= 1, "<= 1 uint8 level against plain")

    print("== 4. serving: 3 requests through pipeline_fn('gf') + whdr_batch")
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

    print("== 4t. training: {} steps of fit at batch {} x {}x{}, K={}, {} "
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

    print("== 5. the train CLI's fit stage on cuda and on the CPU")
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
        warm = os.path.join(tmp, "warm.npz")
        save_checkpoint(warm, init_network(
            flagship, torch.Generator().manual_seed(args.seed)))
        cli_args = ["--stage=fit"] + TRAIN_FLAGS + [
            "--iterations=40", "--batch_size={}".format(TB),
            "--checkpoint_interval=20", "--height={}".format(H),
            "--width={}".format(W), "--random_seed=0",
            "--predictCaffemodel", warm, "--data_root", root,
            "--experiment=smoke"]
        cli_out = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, device)
            reset_launches()
            train_cli.main(cli_args + ["--results_root", out,
                                       "--device", device])
            if device == "cuda":
                read_launches("train CLI on cuda", train_kernels)
            exp = os.path.join(out, "smoke")
            snaps = sorted(os.listdir(os.path.join(exp, "snapshots")))
            check([s.rsplit("_", 1)[1] for s in snaps] == ["20.npz", "40.npz"],
                  "{}: snapshots _iter_20 and _iter_40".format(device))
            progs = os.listdir(os.path.join(exp, "progressions"))
            check(len(progs) == 1 and os.listdir(os.path.join(exp, "scores"))
                  and os.listdir(os.path.join(exp, "framerates")),
                  "{}: progressions/*.json, scores/, framerates/".format(
                      device))
            with open(os.path.join(exp, "progressions", progs[0])) as f:
                prog = json.load(f)["test"]
            cli_out[device] = (prog, load_checkpoint(os.path.join(
                exp, "snapshots", snaps[-1]))[0])
        (prog_c, par_c), (prog_p, par_p) = cli_out["cuda"], cli_out["cpu"]
        dw = abs(prog_c[-1]["WHDR"] - prog_p[-1]["WHDR"]) / 100.0
        dp = max(np.abs(par_c[layer][part] - par_p[layer][part]).max()
                 for layer in par_p for part in par_p[layer])
        print("train CLI val WHDR cuda {} cpu {}: |d|={:.2e}; final params "
              "max|d|={:.3e}".format([e["WHDR"] for e in prog_c],
                                     [e["WHDR"] for e in prog_p], dw, dp))
        check(dw <= 1e-3 and dp <= 1e-3, "train CLI on cuda against the CPU: "
              "final val WHDR within 0.001, params within 1e-3")

    print("== 5. CLIs on cuda")
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

    print("== 6. times (CUDA events; inputs resident on the card)")
    times = {}
    with torch.no_grad():
        times["cnn_fwd"] = (
            time_ms(lambda: reflectance_cnn(x, weights,
                                                   srgb_input=True), 20),
            time_ms(lambda: reflectance_cnn_plain(
                x, weights, srgb_input=True), 20))
        times["bilateral_gray_self"] = (
            time_ms(lambda: bilateral_gray_self(
                r_u8, -1, SIGMA_C, SIGMA_S), 10),
            time_ms(lambda: bilateral_gray_self_plain(
                r_u8, -1, SIGMA_C, SIGMA_S), 2))
        times["whdr_gather"] = (
            time_ms(lambda: gather_pairs(plane, *idx), 100),
            time_ms(lambda: gather_pairs_plain(plane, *idx), 100))
        slice_ms = time_ms(
            lambda: whdr_batch(bf(requests[0]) / 255.0, comps[0]), 10)
        planes = box_in["32x256x256"][0]
        times["box_filter"] = (
            time_ms(lambda: box_filter_planar(planes, GF_R), 20),
            time_ms(lambda: box_filter_planar_plain(planes, GF_R), 5))
        big = box_in["1x2160x3840"][0]
        big_times = (time_ms(lambda: box_filter_planar(big, GF_R), 20),
                     time_ms(lambda: box_filter_planar_plain(big, GF_R), 5))
        times["guided_filter"] = (
            time_ms(lambda: guided_filter_fused(*gf_in["C=1"], GF_R,
                                                GF_EPS), 20),
            time_ms(lambda: guided_filter_fused_plain(*gf_in["C=1"], GF_R,
                                                      GF_EPS), 5))
        c3_times = (
            time_ms(lambda: guided_filter_fused(*gf_in["C=3"], GF_R,
                                                GF_EPS), 10),
            time_ms(lambda: guided_filter_fused_plain(*gf_in["C=3"], GF_R,
                                                      GF_EPS), 3))
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
                time_ms(lambda: bilateral_joint_plain(j, s, bf_radius, gcc,
                                                      gsc), 1, warmup=0))
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
        times["whdr_scatter"] = (
            time_ms(lambda: scatter_pairs((TB, H, W), *sidx, sg1, sg2), 100),
            time_ms(lambda: scatter_pairs_plain((TB, H, W), *sidx, sg1, sg2),
                    100))
        # the one PyTorch call computing the same function, where there is
        # one (indices joined beforehand): advanced indexing for K3, a zeroed
        # plane's index_put_(accumulate=True) for K8
        bi = torch.arange(B, device=dev)[:, None].expand(B, 2 * K)
        yi, xi = (torch.cat([idx[i], idx[i + 2]], 1).long() for i in (0, 1))
        sb = torch.arange(TB, device=dev)[:, None].expand(TB, 2 * K)
        sy, sx = (torch.cat([sidx[i], sidx[i + 2]], 1).long() for i in (0, 1))
        sg = torch.cat([sg1, sg2], 1)
        library = {
            "whdr_gather": time_ms(lambda: plane[bi, yi, xi], 100),
            "whdr_scatter": time_ms(lambda: torch.zeros(
                (TB, H, W), device=dev).index_put_((sb, sy, sx), sg,
                                                   accumulate=True), 100)}
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

    print("== 7. profile: device time per batch (torch.profiler, {} "
          "batches each)".format(PROFILE_BATCHES))
    slices = {
        "bf": (lambda: whdr_batch(bf(requests[0]) / 255.0, comps[0]),
               slice_ms),
        "gf": (lambda: whdr_batch(gf(gf_requests[0]) / 255.0, comps[0]),
               gf_ms)}
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
        split = {part: 0.0 for part in parts}
        split["loss glue (everything else)"] = 0.0
        for kernel, ms in per_kernel.items():
            part = next((p_ for p_, keys in parts.items()
                         if any(key in kernel for key in keys)),
                        "loss glue (everything else)")
            split[part] += ms
        print("training step: device busy {:.4f} ms of {:.4f} ms per step "
              "(phase 6's CUDA events): idle share {:.2%}".format(
                  busy, step_ms, 1 - busy / step_ms))
        for part, ms in split.items():
            print("  {:9.4f} ms  {:5.1%}  {}".format(ms, ms / busy, part))
        for kernel, ms in sorted(per_kernel.items(),
                                 key=lambda kv: -kv[1])[:12]:
            print("  {:9.4f} ms  {}".format(ms, kernel[:90]))
    else:
        print("training step: the profiler saw no device time")

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
    }
    # each kernel's launches in the run of its own path
    launches["box_filter"] = cli_launches["box_filter"]
    launches["guided_filter"] = gf_launches["guided_filter"]
    for name in ("cnn_train_fwd", "cnn_train_bwd", "whdr_scatter"):
        launches[name] = train_launches[name]
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
    nparams = k7.num_params(tshape)
    bounds = {
        "cnn_fwd": bound(flops=2 * 4352 * px, nbytes=16 * px),
        "bilateral_gray_self": bound(flops=4 * taps * px, loads=taps * px,
                                     nbytes=8 * px),
        "whdr_gather": bound(nbytes=32 * B * K),
        "box_filter": bound(nbytes=8 * px),
        "guided_filter": bound(nbytes=20 * px),
        "bilateral_joint": bound(flops=12 * taps * bf_px, sfu=taps * bf_px,
                                 nbytes=20 * bf_px),
        "bilateral_color_self": bound(flops=8 * taps * bf_px,
                                      loads=taps * bf_px, nbytes=24 * bf_px),
        "bilateral_packed_joint": bound(flops=4 * taps * bf_px,
                                        loads=taps * bf_px, nbytes=20 * bf_px),
        "cnn_train_fwd": bound(flops=2 * trunk_fmas(tshape) * t_px,
                               nbytes=16 * t_px + 4 * nparams),
        "cnn_train_bwd": bound(flops=2 * trunk_fmas(tshape, True) * t_px,
                               nbytes=16 * t_px + 8 * nparams),
        "whdr_scatter": bound(nbytes=4 * t_px + 24 * TB * K),
    }
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
