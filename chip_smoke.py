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
  5. CLIs     the decompose and filter CLIs' functions on a synthetic PNG
              on cuda (seeded weights: the trained model is not shipped):
              bilateral c20 s22 on the -r.png by itself, on the -r.png
              guided by the photo and on the photo by itself (the last two
              held against the same call on the CPU), guided c3 s45, and
              guided with --subsample=4 (the box kernel's path, held
              against the same filter on the CPU); and
              joint_bilateral_filter_fast, the float filter's entry point
              (the width-sharded filter's, not ported yet), called
              directly and held against the CPU;
  6. times    CUDA-event times of each kernel and its plain version, both
              slices' images/s, and the MP/s of the color-self and
              BF(reflectance, photo) bilateral (not gated);
  7. profile  each slice's device busy time per batch and per-kernel
              device times (torch.profiler), and its idle share against
              phase 6's time in the same run (not gated).

The second-to-last line is {"kernels": [...]} with each kernel's launches in
the run of its path (K1-K3: bf serving; K5: gf serving; K4: the guided CLI;
K6's three wrappers: the bilateral CLI's BF(reflectance, photo) and
color-self runs, and the direct joint_bilateral_filter_fast call) and its
measured error and times; the last line is
{"ok": true, "device": {...}}.
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
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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
        radius, gcc, gsc, _ = opencv_bilateral_params(-1, SIGMA_C, SIGMA_S)

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
                    jj, jj if s is j else s[:K6_SUBSET], radius, gcc, gsc)
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
                "bilateral_packed_joint": bilateral_packed_joint_batched}

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
                time_ms(lambda: bilateral_joint_plain(j, s, radius, gcc,
                                                      gsc), 1, warmup=0))
        for name, instance in K6_MAIN.items():
            times[name] = k6_times[instance]
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
    }
    # each kernel's launches in the run of its own path
    launches["box_filter"] = cli_launches["box_filter"]
    launches["guided_filter"] = gf_launches["guided_filter"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
