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
              some, and so do K6's five uint8 and four float ones;
              K1 issues HMMA .TF32 (3xTF32 on the tensor cores) and no FFMA
              on a constant-bank weight (its instruction count is printed),
              and so do K7's backward and every instantiation of its
              tensor-core forward, its FP32 forward none (each
              instantiation's HMMA count printed); the F2F.F64.F32
              conversions of K4's, K5's and K9's row passes (K4's and K5's
              fused forms among them) are counted per kernel, and each of
              the ten column-pass instantiations (col_sum_kernel,
              gf_moment_cols) streams its rows by asynchronous copies
              (LDGSTS, counted per kernel);
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 32 x 256x256, K = 1181; the box
              also on one 2160x3840 plane and on the guided CLI's
              --subsample=4 planes; the joint bilateral K6 at the JAX
              bench's 8 x 256x256, c20 s22: color-self, BF(reflectance,
              photo), both in cv2's table form, float with a 3-plane joint;
              each float pairing at its largest one-band radius, one past
              it (the banded kernel) and at sigma_s = 3), plus degenerate
              shapes; K2 in both forms and all nine K6 instantiations at
              sigma_s = 80 (radius 120: the disk's rows in bands) on
              1 x 192x256; K4 by both forms and K5 by both paths (the
              fused ones where they take the width),
              gated (K2 on each input as uint8 levels, cv2's table form,
              and as float32, the exp form; K5 also at C=3 with r=300 and
              r=1300, whose row blocks narrow to fit their staging, against
              its plain version in float64); the iterated guided chain K9
              (3 iterations, r=45, eps=3) on a 2160x3840 frame, C=1, with its guide statistics
              and one application held alone, on 2 x 480x512 with C=3, and
              on a 12x40 frame narrower than the window; WHDR's scores in
              one launch (whdr_scores) against the composition around K3
              (kernels=False) within 1e-6;
  3t. train   the training kernels against their plain versions on the
              card: the fused skip-layer trunk K7 (forward against the plain
              trunk, backward against plain autograd) at the flagship's
              20 x 256x256 and four other configs on a 37x53 frame, its
              forward counted through the kernel its shape takes (the
              tensor cores' for all but the 128-wide trunk), and
              the WHDR scatter-add K8 against index_put_(accumulate=True)
              with forced collisions, its sort path bitwise equal to its
              quadratic search, the same two at 1024x1024, K = 2048 (64-bit
              keys, the most shared memory a 4,096-key block takes), and the
              quadratic search alone at K = 9000 (above the sort path's
              limit) against index_put_; each
              backward launched twice and held
              bitwise equal; K7's backward split by phase (TPU kernel 19) at
              20 x 256x256: the full variant bitwise equal to the product
              backward, the four with phases removed within 2e-4 of each
              leaf's max of their plain versions, the block sum alone
              bitwise equal to the workspace rows summed in order, its 6
              launches counted (the kernels line's launches of kernel 19:
              this phase, at measure_train_bwd_split's SHAPE and PIXELS,
              is its run);
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
              before each path and checked after it (WHDR scored by
              whdr_scores once a batch, K3 not launched), and each result is
              held against the same pipeline through the plain versions;
  4e. export  utils.serving.export_flagship on the card: cnn, bf and gf
              artifacts of 32 x 256x256 and one symbolic cnn, saved
              (torch.export), loaded (load_flagship) and run on phase 4's
              requests: each bitwise pipeline_fn's output, K1 and K2 (bf)
              or K5 (gf) launched once a call through the rf:: operators
              and no other kernel; the symbolic artifact at 1 x 341x512 and
              4 x 256x256 bitwise decompose_planar; export and load seconds
              and byte sizes printed;
  4c. chain   ops.guided.guided_filter_iterated(planar=True), the 3x chain
              of the JAX bench's config 4, on one 2160x3840 and one
              4320x7680 frame (C=1), counters reset before each: K9 counted
              and its fused kernels taken (.fused), K5 not; the 4K result
              held against the plain chain, and one traced 4K chain issues
              7 K9 launches (1 + 2 an iteration), all fused pairs;
  4t. train  train.loop.fit for 20 steps of batch 20 x 256x256, K = 1181,
              on a seeded synthetic set of 40 images resident on the card
              (fit's chunked trainer: an eager warm-up step, one capture of
              the step as a CUDA graph, then replays), once through the
              kernels (K7 forward and backward, K3 and K8 for the hinge,
              whdr_scores for the whdr_original metric: each counted
              by its wrapper in the warm-up step and, recorded in the
              capture, in every replay: exactly its count a step times 20)
              and once through the plain versions on the card, also
              captured (no kernel counted): every step's loss_total within
              1e-3 relative; then 10 steps, a checkpoint, a resume for 10
              more, against the 20 uninterrupted steps (params within
              1e-6); then 70 steps with a checkpoint every 33 (chunks of
              32, 1, 32, 1 and 4) against the per-step trainer
              (DEVICE_FEED_BUDGET_BYTES = 0): the same snapshots, params
              within 1e-6; the resume from step 33 against the 70
              uninterrupted steps (1e-6); one chunk of 32 replays under
              torch.profiler: K7's forward, backward and block sum, K3,
              K8 and whdr_scores each ran in every replayed step on the card,
              as many times as the wrappers' counters say, one graph
              launch a step;
  4n. nets    the seven networkTypes (batch norm on and off for the
              skip-layer trunk and the cascade; the train CLI's default
              widths) through train.loop.compute_losses at batch 4 x 64x64
              (uNet's global path at its fixed 256x256), kernels on and off
              on the card: loss within 1e-3 relative, every gradient within
              2e-4 of its leaf's max; K7 counted on the skip trunk (1
              forward, 1 backward) and the cascade (2 and 2, one backward
              with the input cotangent); then one training step each;
  4p. multi   the multi-GPU paths (reflectance_filtering_tpu_torch/
              parallel/) on spawned ranks sharing the one card, the
              kernels built in this process first: gloo at world size 2
              (a backend the script names), the flagship's sharded train
              step at 20 x 256x256 against the single-process step (SGD;
              params within rtol 1e-5 / atol 1e-7, the hinge within 1e-6,
              every rank's params equal; K7, K3 and K8 counted on each
              rank), then the sharded filters on a 2160x3840 photo
              against the single-device kernels: K2 gray-self and K6
              color-self and BF(gray, photo) at c20 s22 bitwise, K5 at
              r=45 eps=3, K4 at r=45 and the 3x chain K9 within the JAX
              package's sharded gates, each rank's launches printed; gloo at
              world size 4, the 3x chain on 4320x7680 (1,920 columns a
              rank); NCCL at world size 1, one sharded step and one
              sharded filter (K2 bitwise);
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
              against the same filter on the CPU); bilateral at
              --sigma_spatial 80 (radius 120: K6 in bands) on a 96x128
              photo by itself and guided by another photo, each held
              against the same call on the CPU; and
              joint_bilateral_filter_fast, the float filter's entry point
              (the JAX package's width-sharded filter's), called
              directly and held against the CPU;
  5b. build   a synthetic IIW folder (24 photos of 96x128, JSON judgments)
              through the port's build_dataset CLI (trainValTest, resized
              to 64x64, augmented, 2 workers; whether PIL is importable
              printed), then the train CLI's fit for 16 samples on cuda
              from that dataset (augmented comparisons, K7 counted);
  5g. grid    the filter CLI's bilateral_grid on cuda against --device cpu
              (-r.png by itself, guided by the photo, the photo by itself:
              <= 1 level, its own output name and stderr caveat), and the
              quality point (ss=8, sr=6) against K2 (p99 <= 1 and max <= 4
              levels on the JAX grid tests' 6 classes; |dWHDR| <= 0.001 on
              bench.py's two images and 47,240-comparison blob);
  5d. decompose  the train CLI's --stage=predict --decompose from phase 5's
              flagship snapshot, no dataset on disk, on a folder of seven
              PNGs (256x256, 341x512, 97x131), an npz of 4 x 64x64, an mp4v
              movie of 12 frames at 240x320 and a file no decoder reads, on
              cuda (K7's forward counted) and with --device cpu: every PNG
              within 1 uint8 level, every npz array within 1e-4, the five
              movie files (the triptych 3x as wide), both 0command.txt,
              the unreadable file reported; the image decoder printed;
              then, from the same snapshot, predict_batched of 16 frames of
              1080x1920 in batches of 8 (finite, K7's forward once a batch,
              frame 0 within 1e-4 of the plain per-layer path on the card)
              and decompose_images_batched on 32 PNGs of 768x1024 (every
              PNG written).

Each phase's header shows the seconds since the script started; the line
before the kernels line, the whole run's.  This script times no kernel:
the benchmark (BENCHMARK.json, benchmark/) measures, and each
reflectance_filtering_tpu_torch/scripts/measure_*.py times one kernel's
alternatives when run alone with python -m.

The second-to-last line is {"kernels": [...]} with each kernel's launches in
the run of its path (K1-K3: bf serving; K5: gf serving; K4: the guided CLI;
K6's three wrappers: the bilateral CLI's BF(reflectance, photo) and
color-self runs, and the direct joint_bilateral_filter_fast call; K7's
forward and backward and K8: the 20 training steps, the warm-up step's
launches and the replays' as the capture recorded them; K9's two wrappers:
the 4K chain; K7's split: phase 3t) and its measured error; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import collections
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, H, W, K = 32, 256, 256, 1181       # the main path's shapes
SIGMA_C, SIGMA_S = 20.0, 22.0
BAND_SIGMA_S = 80.0                   # radius 120: the bilateral kernels' bands
BAND_SHAPE = (1, 192, 256)            # ... on planes of this shape
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
# phase 4e: the exported artifacts, the kernels each one's call launches
# (chip_smoke's counter names), the symbolic artifact's two shapes
EXPORT_KINDS = ("cnn", "bf", "gf", "symbolic")
EXPORT_KERNELS = {"cnn": ("cnn_fwd",),
                  "bf": ("cnn_fwd", "bilateral_gray_self"),
                  "gf": ("cnn_fwd", "guided_filter")}
SYMBOLIC_SHAPES = ((1, 3, 341, 512), (4, 3, 256, 256))
# the 3x iterated guided chain (BASELINE.json config 4, bench.py:532-575)
CHAIN_ITERS = 3
CHAIN_FRAMES = {"4K": (2160, 3840), "8K": (4320, 7680)}
# K9's kernel names (csrc/guided_chain.cu): the six passes and the fused
# pairs (gc_stats_rows_fused, gc_solve_cached_rows_fused,
# gf_apply_rows_fused) each contain one
K9_KERNEL_NAMES = ("gf_moment_cols", "gc_stats_rows", "gc_solve_cached_rows",
                   "col_sum_kernel", "gf_apply_rows")
# the training slice: the JAX bench's training shape (bench.py:596-634)
TB, TRAIN_N, TRAIN_VAL_N, TRAIN_STEPS = 20, 40, 20, 20
TRAIN_FLAGS = ["--networkType=convStaticSkipLayers", "--numLayers=5",
               "--num_filters_log=5", "--kernel_pad=0",
               "--RS_est_mode=rDirectly"]
# phase 4t's chunked trainer: 70 steps with a checkpoint every 33, so the
# chunks run 32, 1 | 32, 1 | 4 (two full chunks, each checkpoint off a
# chunk boundary, a remainder)
CHUNK_RUN_STEPS, CHUNK_CKPT_STEPS = 70, 33
# the training kernels' device names (substrings), launches a step (the
# hinge's gather and scatter, the whdr_original metric's scores) and the
# counter of the wrapper that launches each (K7's backward launches its
# block sum)
TRAIN_STEP_KERNELS = {"K7 forward": ("trunk_fwd", 1, "cnn_train_fwd"),
                      "K7 backward": ("trunk_bwd_kernel", 1, "cnn_train_bwd"),
                      "K7 block sum": ("sum_partials", 1, "cnn_train_bwd"),
                      "K3 gather": ("whdr_gather_kernel", 1, "whdr_gather"),
                      "K8 scatter": ("whdr_scatter", 1, "whdr_scatter"),
                      "WHDR scores": ("whdr_scores_kernel", 1,
                                      "whdr_scores")}
# K7 off the flagship: (n, ci, f, cout) on a 37x53 frame
K7_OTHER = [(2, 3, 16, 1), (1, 3, 32, 1), (2, 3, 128, 1), (3, 3, 16, 6)]
# phase 4n: (networkType, batch norm) at batch NET_B of NET_HW x NET_HW
NET_B, NET_HW = 4, 64
NET_CASES = ([(t, False) for t in ("convStatic", "convStaticWithSigmoid",
                                   "simpleConvolutionsRelu", "convIncreasing",
                                   "uNet")]
             + [(t, bn) for t in ("convStaticSkipLayers", "cascadeSkipLayers")
                for bn in (False, True)])
# K8's quadratic search: a K above the sort path's limit of 8,192
K8_QUADRATIC_K = 9000
# K8's sort path with 64-bit keys at 4,096 keys a block: (images, side, K)
K8_WIDE = (1, 1024, 2048)
# phase 5d's folder: PNGs (count, h, w), an npz stack, a movie
DEC_PNGS = [(4, 256, 256), (2, 341, 512), (1, 97, 131)]
DEC_NPZ = (4, 64, 64)
DEC_MOVIE = (12, 240, 320)
# phase 5d's full sizes: frames through predict_batched, PNGs through
# decompose_images_batched
FRAMES, FRAME_HW, FRAME_BATCH = 16, (1080, 1920), 8
PNG_N, PNG_HW = 32, (768, 1024)


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


def sass_lines(fn):
    """The instruction lines of one function in cuobjdump -sass output."""
    return [line for line in fn.splitlines()
            if re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line)]


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
    Returns the flagship's errors and the launches of K7's backward split
    (TPU kernel 19): this phase, at the split's own shape
    (measure_train_bwd_split.SHAPE on its PIXELS), is that kernel's run."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        _scatter_quadratic, scatter_pairs, scatter_pairs_plain, sort_path)
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs, keep, tc_cases = {}, {}, []
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
        tc_before = k7.trunk_forward.tensor_core_launches
        pre = k7.trunk_forward(x, flat, shape)
        on_tc = k7.trunk_forward.tensor_core_launches - tc_before
        tc_cases.append(on_tc)
        check(on_tc == int(k7.forward_on_tensor_cores(shape)),
              "K7 {} forward counted through the {} kernel".format(
                  name, "tensor cores'" if on_tc else "FP32"))
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

    check(tc_cases[0] == 1 and 0 in tc_cases, "K7's forward went through "
          "both of its kernels (the flagship on the tensor cores)")

    # kernel 19: the backward's timing variants at the flagship's shapes
    x, g, flat, shape = (keep[key] for key in ("x", "g", "flat", "shape"))
    work = k7.backward_workspace(x, shape)
    product, _ = k7.trunk_backward(x, g, flat, shape, False)
    worst = 0.0
    k7.trunk_backward_variant.launches = 0
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
    split_launches = k7.trunk_backward_variant.launches
    check(split_launches == 6, "K7 split: 6 launches counted (5 variants "
          "and the block sum), {} seen".format(split_launches))
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
    quad = _scatter_quadratic((b, H, W), *idx, g1, g2)
    check(sort_path(k) and torch.equal(got, quad), "K8's sort path (taken "
          "at K={}) bitwise equal to its quadratic search".format(k))
    # 64-bit keys at the most shared memory of a 4,096-key block
    wb, wh, wk = K8_WIDE
    widx = [torch.randint(0, n_, (wb, wk), device=dev, dtype=torch.int32,
                          generator=gen) for n_ in (wh, wh, wh, wh)]
    wg1, wg2 = (torch.randn(wb, wk, device=dev, generator=gen)
                for _ in range(2))
    wgot = scatter_pairs((wb, wh, wh), *widx, wg1, wg2)
    wwant = scatter_pairs_plain((wb, wh, wh), *widx, wg1, wg2)
    wquad = _scatter_quadratic((wb, wh, wh), *widx, wg1, wg2)
    torch.cuda.synchronize()
    wrel = (wgot - wwant).abs().max().item() / wwant.abs().max().item()
    print("K8 {}x{}x{}, K={} (64-bit keys): {:.2e} of max".format(
        wb, wh, wh, wk, wrel))
    check(sort_path(wk) and wrel <= 1e-6 and torch.equal(wgot, wquad),
          "K8 at {}x{}, K={} within 1e-6 of index_put_ and bitwise equal "
          "to its quadratic search".format(wh, wh, wk))
    # the quadratic search where the sort path cannot take K
    qb, qk = 2, K8_QUADRATIC_K
    qidx = [torch.randint(0, n_, (qb, qk), device=dev, dtype=torch.int32,
                          generator=gen) for n_ in (H, W, H, W)]
    qg1, qg2 = (torch.randn(qb, qk, device=dev, generator=gen)
                for _ in range(2))
    qgot = scatter_pairs((qb, H, W), *qidx, qg1, qg2)
    qwant = scatter_pairs_plain((qb, H, W), *qidx, qg1, qg2)
    torch.cuda.synchronize()
    qrel = (qgot - qwant).abs().max().item() / qwant.abs().max().item()
    print("K8 {}x{}x{}, K={} (quadratic search): {:.2e} of max".format(
        qb, H, W, qk, qrel))
    check(not sort_path(qk) and qrel <= 1e-6, "K8 at K={}, above the sort "
          "path's limit, within 1e-6 of index_put_(accumulate=True)".format(
              qk))
    errs["whdr_scatter"] = err
    return errs, split_launches


def decompose_inputs(folder, seed):
    """Phase 5d's folder: DEC_PNGS photos, an npz stack, an mp4v movie
    and a file no decoder reads.  Returns (the PNG names the decompose
    writes in each folder, the movie names).  Fails if the card's machine
    cannot write mp4v."""
    import cv2
    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    pngs = []
    for n, h, w in DEC_PNGS:
        for img in photos(rng, n, h, w):
            stem = "photo{}x{}_{}".format(h, w, len(pngs))
            cv2.imwrite(os.path.join(folder, stem + ".png"),
                        np.moveaxis(img, 0, -1))
            pngs += [stem + suffix + ".png" for suffix in ("-r", "-s",
                                                           "-RS_est")]
    stack = np.moveaxis(photos(rng, *DEC_NPZ), 1, -1)[..., ::-1]
    np.savez(os.path.join(folder, "stack.npz"), images=stack)
    n, h, w = DEC_MOVIE
    writer = cv2.VideoWriter(os.path.join(folder, "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (w, h),
                             True)
    check(writer.isOpened(), "cv2.VideoWriter opens mp4v on this machine")
    for img in photos(rng, n, h, w):
        writer.write(np.ascontiguousarray(np.moveaxis(img, 0, -1)))
    writer.release()
    with open(os.path.join(folder, "broken.png"), "wb") as f:
        f.write(b"not a png")
    movies = ["clip" + m + ".mp4" for m in (
        "-combined", "-r", "-s", "-baseline_rgbMean-combined",
        "-baseline_rgbNorm-combined")]
    return pngs, movies


def max_param_diff(a, b):
    """The largest |a - b| over two param trees of tensors."""
    return max((a[layer][part] - b[layer][part]).abs().max().item()
               for layer in b for part in b[layer])


def trace_replayed_chunk(dev, seed, data):
    """A chunk of TRAIN_CHUNK_STEPS steps of the flagship at TB x 256x256
    (the warm-up step, the capture, the replays), then chunks of replays
    only: one counted by the wrappers, then those of profile_calls.
    Returns the graph launches in each of the profile's two kept chunks,
    and each training kernel's launches on the card (the last of them) and
    on its wrapper's counter in a chunk."""
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        gather_pairs, scatter_pairs, whdr_scores)
    from reflectance_filtering_tpu_torch.train import loop
    from reflectance_filtering_tpu_torch.utils.profiling import (
        profile_calls)
    flagship = NetworkConfig()
    params = loop.trainable(init_network(
        flagship, torch.Generator().manual_seed(seed)), dev)
    resident = [torch.from_numpy(np.concatenate([a, a[:TB - 1]])).to(dev)
                for a in (data["images"], data["comparisons"])]
    chunk = loop.make_train_chunk(
        flagship, loop.LossConfig(), params,
        loop.make_optimizer("ADAM", 1e-3, params), resident[0], resident[1],
        resident[1], TB)
    k = loop.TRAIN_CHUNK_STEPS
    chunk(0, 0, k)
    torch.cuda.synchronize()
    wrappers = {"cnn_train_fwd": k7.trunk_forward,
                "cnn_train_bwd": k7.trunk_backward,
                "whdr_gather": gather_pairs, "whdr_scatter": scatter_pairs,
                "whdr_scores": whdr_scores}
    before = {name: fn.launches for name, fn in wrappers.items()}
    chunk(k, 0, k)
    counted = {part: wrappers[counter].launches - before[counter]
               for part, (_, _, counter) in TRAIN_STEP_KERNELS.items()}
    per_call, events = profile_calls(lambda: chunk(k, 0, k), 2)
    kernels = collections.Counter(name for name, _, _ in per_call[-1])
    # the graph launches in each kept chunk's profiler step (host clock)
    steps = sorted({(e.time_range.start, e.time_range.end) for e in events
                    if e.name.startswith("ProfilerStep")
                    and e.device_type != torch.autograd.DeviceType.CUDA})
    launches = [sum(1 for e in events if e.name.startswith("cudaGraphLaunch")
                    and start <= e.time_range.start <= end)
                for start, end in steps[-3:-1]]
    return {"graph launches": launches,
            "on the card": {part: sum(c for name, c in kernels.items()
                                      if key in name)
                            for part, (key, _, _) in
                            TRAIN_STEP_KERNELS.items()},
            "counted": counted}


def check_chunked_fit(dev, seed, data):
    """Phase 4t's chunked-trainer gates on the flagship at TB x 256x256:
    fit's chunked trainer (the set resident) against its per-step trainer
    (DEVICE_FEED_BUDGET_BYTES = 0) over CHUNK_RUN_STEPS steps with a
    checkpoint every CHUNK_CKPT_STEPS (the same snapshots, params within
    1e-6); a resume from the chunked run's first checkpoint against the
    uninterrupted run (1e-6); then one chunk of TRAIN_CHUNK_STEPS replays
    traced (trace_replayed_chunk): every training kernel ran on the card its per-step count of times in each replayed
    step, one graph launch a step, and its wrapper's counter, which the
    replays advance, says the same."""
    from reflectance_filtering_tpu_torch.models.networks import NetworkConfig
    from reflectance_filtering_tpu_torch.train import loop
    from reflectance_filtering_tpu_torch.train.checkpoint import (
        Checkpointer, load_checkpoint)
    flagship = NetworkConfig()

    def run(steps, **kw):
        return loop.fit(flagship, loop.LossConfig(), data, steps * TB, TB,
                        random_seed=seed, device=dev, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        states, snaps, cks = {}, {}, {}
        budget = loop.DEVICE_FEED_BUDGET_BYTES
        for label, feed in (("chunked", budget), ("per-step", 0)):
            ck = cks[label] = Checkpointer(os.path.join(tmp, label), "smoke",
                                           interval=CHUNK_CKPT_STEPS * TB)
            os.makedirs(ck.snapshot_dir)
            loop.DEVICE_FEED_BUDGET_BYTES = feed
            try:
                states[label] = run(CHUNK_RUN_STEPS, checkpointer=ck)
            finally:
                loop.DEVICE_FEED_BUDGET_BYTES = budget
            snaps[label] = sorted(os.listdir(ck.snapshot_dir))
        diff = max_param_diff(states["chunked"].params,
                              states["per-step"].params)
        print("fit, {} steps, a checkpoint every {}, chunked against "
              "per-step (host-fed): params max|d|={:.3e}; snapshots "
              "{}".format(CHUNK_RUN_STEPS, CHUNK_CKPT_STEPS, diff,
                          snaps["chunked"]))
        check(snaps["chunked"] == snaps["per-step"] == sorted(
            "smoke_barrista_iter_{}.npz".format(s_ * TB)
            for s_ in (CHUNK_CKPT_STEPS, 2 * CHUNK_CKPT_STEPS,
                       CHUNK_RUN_STEPS)),
              "the chunked and per-step fits save the same snapshots")
        check(diff <= 1e-6, "the chunked fit equals the per-step fit (params "
              "within 1e-6)")
        p0, o0, _ = load_checkpoint(cks["chunked"].path(
            CHUNK_CKPT_STEPS * TB))
        resumed = run(CHUNK_RUN_STEPS, init_params=p0, init_opt_state=o0,
                      base_samples=CHUNK_CKPT_STEPS * TB)
    rdiff = max_param_diff(resumed.params, states["chunked"].params)
    print("chunked: resume at step {} against {} uninterrupted steps: params "
          "max|d|={:.3e}".format(CHUNK_CKPT_STEPS, CHUNK_RUN_STEPS, rdiff))
    check(resumed.samples == CHUNK_RUN_STEPS * TB and rdiff <= 1e-6,
          "chunked: checkpoint + resume equals the uninterrupted run (1e-6)")

    traced = trace_replayed_chunk(dev, seed, data)
    k = loop.TRAIN_CHUNK_STEPS
    print("one chunk of {} replayed steps under torch.profiler: {} graph "
          "launches; kernels on the card {}; counted by the wrappers "
          "{}".format(k, traced["graph launches"], traced["on the card"],
                      traced["counted"]))
    for part, (_, per_step, _) in TRAIN_STEP_KERNELS.items():
        check(traced["on the card"][part] == traced["counted"][part]
              == per_step * k, "{} ran {} times a replayed step (device "
              "trace), as its wrapper's count says".format(part, per_step))
    check(traced["graph launches"] == [k] * 2, "one graph launch a "
          "replayed step")


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


# phase 4p: the data-parallel step and the width-sharded filters on spawned
# ranks sharing the one card (gloo named by the caller; NCCL at world size 1)
SHARD_FRAME = (2160, 3840)            # the 4K frame, 1,920 columns a rank
SHARD_CHAIN_8K = (4320, 7680)         # 1,920 columns a rank at world size 4
# (rtol, atol) of the JAX package's sharded gates (tests/test_parallel.py);
# K2 and K6 are held bitwise
SHARD_GATES = {"K4": (1e-5, 1e-3), "K5": (1e-4, 5e-3), "K9": (1e-4, 0.05)}


def _sharded_wrappers():
    """The launch counters of the kernels the sharded paths run."""
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.ops.bilateral_joint_kernel import (
        bilateral_color_self_batched, bilateral_packed_joint_batched)
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self)
    from reflectance_filtering_tpu_torch.ops.box_kernel import (
        box_filter_planar)
    from reflectance_filtering_tpu_torch.ops.guided_chain_kernel import (
        guide_stats, guided_apply_cached)
    from reflectance_filtering_tpu_torch.ops.guided_kernel import (
        guided_filter_fused)
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        gather_pairs, scatter_pairs)
    return {"K2 bilateral_gray_self": bilateral_gray_self,
            "K3 whdr_gather": gather_pairs,
            "K4 box_filter": box_filter_planar,
            "K5 guided_filter": guided_filter_fused,
            "K6 bilateral_color_self": bilateral_color_self_batched,
            "K6 bilateral_packed_joint": bilateral_packed_joint_batched,
            "K7 cnn_train_fwd": k7.trunk_forward,
            "K7 cnn_train_bwd": k7.trunk_backward,
            "K8 whdr_scatter": scatter_pairs,
            "K9 guide_stats": guide_stats,
            "K9 guided_apply_cached": guided_apply_cached}


def _count_launches(run):
    """(run()'s result, the launches each counted kernel made in it)."""
    wrappers = _sharded_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in wrappers.items()
                 if fn.launches}


def _rank_train_step(mesh, seed, n_images, hw):
    """One data-parallel step of the flagship trunk on this rank's rows of
    a seeded batch (K7, K3, K8), and on rank 0 the single-process step on
    the whole batch from the same params (SGD: the params differ by the
    learning rate times the gradients' difference)."""
    import torch.distributed as dist
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.parallel.mesh import (
        make_sharded_train_step, shard_batch)
    from reflectance_filtering_tpu_torch.train.loop import (
        LossConfig, make_optimizer, make_train_step, param_leaves,
        trainable)
    cfg = NetworkConfig()                 # the flagship: 5 x 32, rDirectly
    data = training_set(seed, n_images, K, hw, hw)
    init = init_network(cfg, torch.Generator().manual_seed(seed))
    params = trainable(init, mesh.device)
    step = make_sharded_train_step(cfg, LossConfig(), params,
                                   make_optimizer("SGD", 1e-3, params), mesh)
    metrics, launches = _count_launches(lambda: step(
        shard_batch(data["images"], mesh),
        shard_batch(data["comparisons"], mesh)))
    res = {"backend": dist.get_backend(mesh.group), "launches": launches,
           "hinge": float(metrics["loss_whdr_hinge"]),
           "params": [p.detach().cpu().numpy() for p in param_leaves(params)]}
    if mesh.rank == 0:
        single = trainable(init, mesh.device)
        m1 = make_train_step(cfg, LossConfig(), single, make_optimizer(
            "SGD", 1e-3, single))(
                torch.from_numpy(data["images"]).to(mesh.device),
                torch.from_numpy(data["comparisons"]).to(mesh.device))
        res["single_hinge"] = float(m1["loss_whdr_hinge"])
        res["single_params"] = [p.detach().cpu().numpy()
                                for p in param_leaves(single)]
    return res


def _rank_filters(mesh, seed):
    """The width-sharded filters on a 4K photo (uint8 levels, c20 s22 for
    the bilateral, r=45 eps=3 for the guided filter, the 3x chain and the
    box) against the single-device kernels on rank 0."""
    from reflectance_filtering_tpu_torch.ops.bilateral_joint_kernel import (
        bilateral_color_self_batched, bilateral_packed_joint_batched)
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self)
    from reflectance_filtering_tpu_torch.ops.box_kernel import (
        box_filter_planar)
    from reflectance_filtering_tpu_torch.ops.guided import (
        guided_filter_iterated, guided_filter_planar)
    from reflectance_filtering_tpu_torch.parallel import spatial as ps
    dev = mesh.device
    h, w = SHARD_FRAME
    photo = device_photos(torch.Generator(dev).manual_seed(seed), 1, h, w)
    u8 = photo[0].permute(1, 2, 0).to(torch.uint8).contiguous()  # [H, W, 3]
    gray = u8[..., 0].contiguous()
    f = u8.to(torch.float32)
    runs = {
        "K2 gray-self c20 s22": lambda: ps.sharded_bilateral_gray_self(
            gray, mesh, -1, SIGMA_C, SIGMA_S, reps=3),
        "K6 color-self c20 s22": lambda: ps.sharded_bilateral_color_self(
            u8, mesh, -1, SIGMA_C, SIGMA_S),
        "K6 BF(gray, photo) c20 s22": lambda: ps.sharded_joint_bilateral(
            u8, gray[..., None], mesh, -1, SIGMA_C, SIGMA_S),
        "K5 guided r45 eps3": lambda: ps.sharded_guided_filter(
            f, f[..., 0], GF_R, GF_EPS, mesh),
        "K9 3x chain r45": lambda: ps.sharded_guided_filter_iterated(
            f, f[..., 0], GF_R, GF_EPS, CHAIN_ITERS, mesh),
        "K4 box r45": lambda: ps.sharded_box_filter(f, GF_R, mesh),
    }
    got, launches = {}, {}
    for name, run in runs.items():
        got[name], launches[name] = _count_launches(run)
    res = {"launches": launches, "errors": {}}
    if mesh.rank == 0:
        planes = f.permute(2, 0, 1)[None].contiguous()
        exp = {
            "K2 gray-self c20 s22": bilateral_gray_self(
                gray[None], -1, SIGMA_C, SIGMA_S, reps=3)[0],
            "K6 color-self c20 s22": bilateral_color_self_batched(
                planes, -1, SIGMA_C, SIGMA_S)[0].permute(1, 2, 0),
            "K6 BF(gray, photo) c20 s22": bilateral_packed_joint_batched(
                planes, planes[:, :1].contiguous(), -1, SIGMA_C,
                SIGMA_S)[0].permute(1, 2, 0),
            "K5 guided r45 eps3": guided_filter_planar(
                planes, planes[:, :1], GF_R, GF_EPS)[0, 0],
            "K9 3x chain r45": guided_filter_iterated(
                planes, planes[:, :1], GF_R, GF_EPS, CHAIN_ITERS,
                planar=True)[0, 0],
            "K4 box r45": box_filter_planar(
                planes[0], GF_R, "reflect101").permute(1, 2, 0),
        }
        for name, e in exp.items():
            g = got[name]
            tol = SHARD_GATES.get(name[:2])
            lv = (torch.round(g.clamp(0, 255)) - torch.round(e.clamp(0, 255))
                  ).abs()
            res["errors"][name] = {
                "bitwise": bool(torch.equal(g, e)),
                "max_abs": float((g - e).abs().max()),
                "rel_ok": tol is None or bool(torch.allclose(g, e, *tol)),
                "levels": float(lv.max()),
                "levels_share": float((lv > 0).float().mean())}
    return res


def _rank_chain_8k(mesh, seed):
    """The 3x chain at r=45 on a 4320x7680 frame (1,920 columns a rank at
    world size 4, above its 270-column halo) against K9 on rank 0."""
    from reflectance_filtering_tpu_torch.ops.guided import (
        guided_filter_iterated)
    from reflectance_filtering_tpu_torch.parallel import spatial as ps
    dev = mesh.device
    h, w = SHARD_CHAIN_8K
    planes = device_photos(torch.Generator(dev).manual_seed(seed), 1, h, w)
    f = planes[0].permute(1, 2, 0).contiguous()
    got, launches = _count_launches(lambda: ps.sharded_guided_filter_iterated(
        f, f[..., 0], GF_R, GF_EPS, CHAIN_ITERS, mesh))
    res = {"launches": launches}
    if mesh.rank == 0:
        exp = guided_filter_iterated(planes, planes[:, :1].contiguous(), GF_R,
                                     GF_EPS, CHAIN_ITERS, planar=True)[0, 0]
        lv = (torch.round(got) - torch.round(exp)).abs()
        res["error"] = {"max_abs": float((got - exp).abs().max()),
                        "rel_ok": bool(torch.allclose(got, exp, 1e-4, 0.05)),
                        "levels": float(lv.max()),
                        "levels_share": float((lv > 0).float().mean())}
    return res


def _rank_nccl(mesh, seed):
    """World size 1 over NCCL: one sharded train step and one sharded
    filter (K2 on a 512x768 frame against the kernel, bitwise)."""
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self)
    from reflectance_filtering_tpu_torch.parallel import spatial as ps
    res = _rank_train_step(mesh, seed, 4, 64)
    gray = torch.from_numpy(photos(np.random.RandomState(seed), 1, 512,
                                   768)[0, 0]).to(mesh.device)
    got = ps.sharded_bilateral_gray_self(gray, mesh, -1, SIGMA_C, SIGMA_S,
                                         reps=3)
    res["filter_bitwise"] = bool(torch.equal(got, bilateral_gray_self(
        gray[None], -1, SIGMA_C, SIGMA_S, reps=3)[0]))
    return res


def _check_train_ranks(label, results):
    r0 = results[0]
    same = all(np.array_equal(a, b) for r in results[1:]
               for a, b in zip(r["params"], r0["params"]))
    err = max(float(np.abs(a - b).max()) for a, b in zip(
        r0["params"], r0["single_params"]))
    close = all(np.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(
        r0["params"], r0["single_params"]))
    dh = abs(r0["hinge"] - r0["single_hinge"])
    for r in results:
        print("  {} rank launches: {}".format(label, r["launches"]))
    print("  {}: params max|d| {:.3e} against the single-process step, "
          "hinge |d| {:.3e}, backend {}".format(label, err, dh,
                                                r0["backend"]))
    check(same, "{}: every rank holds the same params".format(label))
    check(close and dh <= 1e-6 * max(1.0, abs(r0["single_hinge"])),
          "{}: params within rtol 1e-5 / atol 1e-7 and the hinge within "
          "1e-6 of the single-process step".format(label))
    for r in results:
        check(all(r["launches"].get(k, 0) > 0 for k in (
            "K7 cnn_train_fwd", "K7 cnn_train_bwd", "K3 whdr_gather",
            "K8 whdr_scatter")), "{}: K7, K3 and K8 launched on every "
              "rank".format(label))


def check_multi_gpu(dev, seed):
    """Phase 4p."""
    from reflectance_filtering_tpu_torch.parallel import dryrun
    card = "cuda:{}".format(dev.index)
    t0 = time.perf_counter()
    train2 = dryrun.spawn(2, _rank_train_step, seed, TB, H, backend="gloo",
                          device=card)
    _check_train_ranks("world size 2 (gloo), {} x {}x{}".format(TB, H, W),
                       train2)
    filt2 = dryrun.spawn(2, _rank_filters, seed, backend="gloo", device=card)
    for name, e in filt2[0]["errors"].items():
        print("  {}: {}".format(name, e))
        if name[:2] in ("K2", "K6"):
            check(e["bitwise"], "{} sharded over 2 ranks is bitwise the "
                  "single-device kernel's".format(name))
        elif name[:2] == "K9":
            check(e["rel_ok"] and e["levels"] <= 1
                  and e["levels_share"] < 1e-4,
                  "{} sharded: rtol 1e-4 / atol 0.05, <= 1 level on < 1e-4 "
                  "of the pixels".format(name))
        else:
            check(e["rel_ok"], "{} sharded within the JAX package's "
                  "gate".format(name))
    for rank, r in enumerate(filt2):
        print("  rank {} launches by filter: {}".format(rank, r["launches"]))
        counted = {k: n for run in r["launches"].values()
                   for k, n in run.items()}
        check(all(counted.get(k, 0) > 0 for k in (
            "K2 bilateral_gray_self", "K6 bilateral_color_self",
            "K6 bilateral_packed_joint", "K5 guided_filter",
            "K9 guide_stats", "K9 guided_apply_cached", "K4 box_filter")),
            "rank {}: K2, K4, K5, K6 and K9 launched".format(rank))
    chain4 = dryrun.spawn(4, _rank_chain_8k, seed, backend="gloo",
                          device=card)
    e = chain4[0]["error"]
    print("  8K 3x chain over 4 ranks: {}; launches by rank {}".format(
        e, [r["launches"] for r in chain4]))
    check(e["rel_ok"] and e["levels"] <= 1 and e["levels_share"] < 1e-4
          and all(r["launches"].get("K9 guide_stats", 0) > 0
                  for r in chain4),
          "the 4320x7680 chain over 4 ranks (1,920 columns each): K9 on "
          "every rank, within the chain's gate")
    nccl = dryrun.spawn(1, _rank_nccl, seed, backend="nccl", device=card)
    _check_train_ranks("world size 1 (NCCL), 4 x 64x64", nccl)
    check(nccl[0]["backend"] == "nccl" and nccl[0]["filter_bitwise"],
          "the NCCL group initialises and runs a sharded step and a sharded "
          "filter (K2 bitwise)")
    print("phase 4p: {:.1f} s".format(time.perf_counter() - t0))


# phase 5b: a synthetic IIW folder through the port's dataset builder, then
# the train CLI from that dataset
IIW_N, IIW_HW, BUILT_HW = 24, (96, 128), 64


def write_iiw_folder(folder, seed):
    """IIW_N seeded photos as <id>.png with <id>.json judgments (6 points,
    12 comparisons each, as the IIW dataset lays them out)."""
    rng = np.random.RandomState(seed)
    imgs = photos(rng, IIW_N, *IIW_HW)
    for i in range(IIW_N):
        fid = str(100000 + i)
        cv2_write(os.path.join(folder, fid + ".png"),
                  np.ascontiguousarray(np.moveaxis(imgs[i], 0, -1)))
        points = [{"id": p_, "x": float(rng.rand()), "y": float(rng.rand()),
                   "opaque": True} for p_ in range(6)]
        comps = []
        for _ in range(12):
            a, b = rng.choice(6, 2, replace=False)
            comps.append({"point1": int(a), "point2": int(b),
                          "darker": str(rng.choice(["1", "2", "E"])),
                          "darker_score": float(rng.rand())})
        with open(os.path.join(folder, fid + ".json"), "w") as f:
            json.dump({"intrinsic_points": points,
                       "intrinsic_comparisons": comps}, f)


def cv2_write(path, bgr):
    import cv2
    if not cv2.imwrite(path, bgr):
        raise IOError("could not write " + path)


def check_builder(seed):
    """Phase 5b."""
    from reflectance_filtering_tpu_torch.cli import build_dataset as build_cli
    from reflectance_filtering_tpu_torch.cli import train as train_cli
    from reflectance_filtering_tpu_torch.data.builder import (
        MAX_NUM_AUGMENTED, narihira_split_three)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    try:
        import PIL
        print("PIL importable: {} (the builder's resize)".format(
            PIL.__version__))
    except ImportError as e:
        print("PIL importable: no ({})".format(e))
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        os.makedirs(raw)
        write_iiw_folder(raw, seed)
        root = os.path.join(tmp, "lmdbs")
        t0 = time.perf_counter()
        build_cli.main(["--data_folder", raw, "--save_to",
                        os.path.join(root, "iiw"), "--mode", "trainValTest",
                        "--height", str(BUILT_HW), "--width", str(BUILT_HW),
                        "--augment", "1", "--workers", "2",
                        "--seed", str(seed)])
        print("build_dataset CLI: {} photos of {}x{} -> {}x{}, augmented, 2 "
              "workers: {:.2f} s".format(IIW_N, *IIW_HW, BUILT_HW, BUILT_HW,
                                         time.perf_counter() - t0))
        sizes = [len(s_) for s_ in narihira_split_three(
            [str(100000 + i) for i in range(IIW_N)])]
        for split, n in zip(("train", "val", "test"), sizes):
            for variant in ("sRGB", "linear"):
                path = os.path.join(root, "iiw", "trainValTest_{}_{}_{}_{}"
                                    ".npz".format(split, BUILT_HW, BUILT_HW,
                                                  variant))
                with np.load(path) as z:
                    ok = (z["images"].shape == (n, 3, BUILT_HW, BUILT_HW)
                          and z["augmented"].shape == (
                              n, MAX_NUM_AUGMENTED + 1, 1, 6)
                          and np.isfinite(z["augmented"][:, :, 0, 4]).sum()
                          > 0 and z["images"].min() >= 1e-5)
                check(ok, "{}: {} images, the augmented blob".format(
                    os.path.basename(path), n))
        res = os.path.join(tmp, "results")
        for fn in (k7.trunk_forward, k7.trunk_backward):
            fn.launches = 0
        t0 = time.perf_counter()
        train_cli.main(["--stage=fit"] + TRAIN_FLAGS + [
            "--iterations=16", "--batch_size=4", "--checkpoint_interval=8",
            "--height={}".format(BUILT_HW), "--width={}".format(BUILT_HW),
            "--random_seed=0", "--data_root", root, "--results_root", res,
            "--experiment=built", "--comparisonsType=augmented",
            "--device", "cuda"])
        torch.cuda.synchronize()
        exp = os.path.join(res, "built")
        snaps = sorted(os.listdir(os.path.join(exp, "snapshots")))
        progs = os.listdir(os.path.join(exp, "progressions"))
        with open(os.path.join(exp, "progressions", progs[0])) as f:
            prog = json.load(f)["test"]
        print("train CLI from the built dataset on cuda: {:.2f} s, val WHDR "
              "{}, K7 launches forward {} backward {}".format(
                  time.perf_counter() - t0, [e["WHDR"] for e in prog],
                  k7.trunk_forward.launches, k7.trunk_backward.launches))
        check([s_.rsplit("_", 1)[1] for s_ in snaps] == ["16.npz", "8.npz"]
              and all(np.isfinite(e["WHDR"]) for e in prog)
              and k7.trunk_forward.launches > 0
              and k7.trunk_backward.launches > 0,
              "the train CLI fits on cuda from the port's own dataset "
              "(augmented comparisons): snapshots _iter_8 and _iter_16, "
              "finite val WHDR, K7 launched")


def grid_quality_set(rng, h=256, w=256):
    """The JAX grid tests' 6-class quality set (tests/test_bilateral_grid.py:
    hard edge, noise, binary, low contrast, wedges, 1/f noise)."""
    from reflectance_filtering_tpu_torch.utils.testimages import pink_noise
    yy, xx = np.mgrid[0:h, 0:w]
    study = np.clip(120 + 80 * np.sin(xx / 60.0) * np.cos(yy / 45.0)
                    + 30 * np.sin((xx + yy) / 15.0) + 20 * rng.rand(h, w),
                    0, 255)
    study[60:120, 60:120] = 220
    return np.floor(np.stack([
        study, rng.rand(h, w) * 255, (rng.rand(h, w) > 0.5) * 255.0,
        np.clip(128 + 25 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
                + 8 * rng.rand(h, w), 0, 255),
        (np.floor(xx / 32) * 36.0) % 256, pink_noise(rng, h, w)])).astype(
            np.float32)


def check_grid(dev, seed):
    """Phase 5g: the filter CLI's bilateral_grid on cuda against --device
    cpu, and the quality point against K2 (the exact filter)."""
    import cv2
    from reflectance_filtering_tpu_torch.cli import filter as filt_cli
    from reflectance_filtering_tpu_torch.losses.whdr import whdr
    from reflectance_filtering_tpu_torch.ops.bilateral_grid import (
        bilateral_grid_gray, bilateral_grid_u8)
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self)
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps, pink_noise)
    rng = np.random.RandomState(seed)
    with tempfile.TemporaryDirectory() as tmp:
        photo = np.ascontiguousarray(np.moveaxis(photos(rng, 1, H, W)[0], 0,
                                                 -1))
        png = os.path.join(tmp, "grid.png")
        cv2.imwrite(png, np.repeat(photo[..., :1], 3, -1))
        cpng = os.path.join(tmp, "photo.png")
        cv2.imwrite(cpng, photo)
        for inp, guide in ((png, png), (png, cpng), (cpng, cpng)):
            outs = {}
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, device)
                os.makedirs(out, exist_ok=True)
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    outs[device] = filt_cli.read_filter_write(
                        "bilateral_grid", inp, guide, SIGMA_C, SIGMA_S, out,
                        device=device)
                check("APPROXIMATE" in err.getvalue() and os.path.isfile(
                    os.path.join(out, os.path.splitext(os.path.basename(
                        inp))[0] + "_bilateral_grid_c20.0s22.0.png")),
                    "grid CLI on {}: its own output name and its stderr "
                    "caveat".format(device))
            d = np.abs(outs["cuda"].astype(np.int32) - outs["cpu"]).max()
            check(d <= 1, "grid CLI ({} guided by {}) on cuda within 1 level "
                  "of --device cpu ({})".format(os.path.basename(inp),
                                                os.path.basename(guide), d))
    # the quality point (ss=8, sr=6) against K2 on each class: p99 <= 1,
    # max <= 4 levels
    imgs = torch.from_numpy(grid_quality_set(rng)).to(dev)
    approx = torch.clamp(torch.round(bilateral_grid_gray(
        imgs, imgs[:, None], SIGMA_C / 3, SIGMA_S, ss=8, sr=6)[:, 0]), 0, 255)
    exact = torch.clamp(torch.round(bilateral_gray_self(
        imgs.to(torch.uint8), -1, SIGMA_C, SIGMA_S, reps=3)), 0, 255)
    d = (approx - exact).abs().reshape(len(imgs), -1)
    p99 = torch.quantile(d, 0.99, dim=1)
    print("grid quality point against K2, per class: p99 {} max {}".format(
        p99.tolist(), d.max(dim=1).values.tolist()))
    check(bool((p99 <= 1).all() and (d.max() <= 4)),
          "grid at ss=8, sr=6 against K2: p99 <= 1 and max <= 4 levels on "
          "each of the 6 classes")
    # |dWHDR| <= 0.001 against K2 on bench.py's two images and blob
    rngg = np.random.RandomState(7)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    gray = np.clip(120 + 70 * np.sin(xx / 14.0) * np.cos(yy / 10.0)
                   + 12 * rngg.rand(96, 128), 0, 255).astype(np.uint8)
    pink = pink_noise(rngg, 96, 128).astype(np.uint8)
    comps = torch.from_numpy(make_synthetic_comps(11, 40 * K)).to(dev)
    for name, img in (("smooth", gray), ("pink", pink)):
        rep3 = np.repeat(img[..., None], 3, -1)
        got = bilateral_grid_u8(rep3, rep3, SIGMA_C, SIGMA_S, ss=8, sr=6,
                                device=dev)
        exp = torch.clamp(torch.round(bilateral_gray_self(
            torch.from_numpy(img).to(dev)[None], -1, SIGMA_C, SIGMA_S,
            reps=3)[0]), 0, 255)
        dw = abs(float(whdr(torch.from_numpy(got[..., :1]).to(dev).float()
                            / 255.0, comps))
                 - float(whdr(exp[..., None] / 255.0, comps)))
        check(dw <= 1e-3, "grid ({}) at ss=8, sr=6: |dWHDR| {:.2e} <= 0.001 "
              "against K2".format(name, dw))


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
    from reflectance_filtering_tpu_torch.losses.whdr import (
        whdr, whdr_batch, whdr_per_image)
    from reflectance_filtering_tpu_torch.models.networks import (
        ReflectanceNet, params_from_numpy, seeded_reference_params)
    from reflectance_filtering_tpu_torch.ops import _build
    from reflectance_filtering_tpu_torch.ops.bilateral import (
        joint_bilateral_filter_u8, opencv_bilateral_params)
    from reflectance_filtering_tpu_torch.ops.bilateral_joint_kernel import (
        bilateral_color_self_batched, bilateral_joint_plain,
        bilateral_packed_joint_batched, joint_bilateral_filter_fast,
        joint_bilateral_planar_batched, one_band_radius,
        opencv_bilateral_coeffs)
    from reflectance_filtering_tpu_torch.ops.bilateral_kernel import (
        bilateral_gray_self, bilateral_gray_self_plain)
    from reflectance_filtering_tpu_torch.ops.box_kernel import (
        FUSED_WIDEST as BOX_WIDEST, box_filter_planar,
        box_filter_planar_plain)
    from reflectance_filtering_tpu_torch.ops.guided import (
        fast_guided_filter_u8, guided_filter_iterated, guided_filter_u8)
    from reflectance_filtering_tpu_torch.ops.guided_chain_kernel import (
        guide_stats, guide_stats_plain, guided_apply_cached,
        guided_apply_cached_plain, guided_filter_chain,
        guided_filter_chain_plain)
    from reflectance_filtering_tpu_torch.ops.guided_kernel import (
        fused_fits, guided_filter_fused, guided_filter_fused_plain)
    from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
        pack_weights, reflectance_cnn, reflectance_cnn_plain)
    from reflectance_filtering_tpu_torch.ops.whdr_gather import (
        gather_pairs, gather_pairs_plain, whdr_scores)
    from reflectance_filtering_tpu_torch.utils import serving
    from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn
    from reflectance_filtering_tpu_torch.cli import train as train_cli
    from reflectance_filtering_tpu_torch.models.networks import (
        NetworkConfig, init_network)
    from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7
    from reflectance_filtering_tpu_torch.ops.whdr_gather import scatter_pairs
    from reflectance_filtering_tpu_torch.train.checkpoint import (
        Checkpointer, load_checkpoint, save_checkpoint)
    from reflectance_filtering_tpu_torch.train.loop import LossConfig, fit
    from reflectance_filtering_tpu_torch.utils.testimages import (
        make_synthetic_comps)
    from reflectance_filtering_tpu_torch.data import native_loader
    from reflectance_filtering_tpu_torch.models.networks import (
        apply_network, params_to_torch)
    from reflectance_filtering_tpu_torch.train.predict import (
        decompose_images_batched, make_predict_fn, predict_batched)
    from reflectance_filtering_tpu_torch.utils.image import srgb_to_rgb_t
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
    k1_lines = [line for fn in k1 for line in sass_lines(fn)]
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
    # issues HMMA .TF32, and so does every instantiation of its forward on
    # the tensor cores (n tiles, m tiles, output channels); its FP32
    # forward, kept for the wide trunks, issues none
    k7_hmma = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        m = re.search(r"trunk_(bwd|fwd|fwd_mma)_kernel(?:ILi(\d+)E"
                      r"(?:Lb([01])E|Li(\d+)ELi(\d+)E))?", name)
        if m:
            lines = sass_lines(fn)
            if m.group(1) == "bwd":
                tag = "bwd<{}, {}>".format(
                    m.group(2), "registers" if m.group(3) == "1" else "row")
            elif m.group(1) == "fwd_mma":
                tag = "fwd_mma<{}, {}, {}>".format(m.group(2), m.group(4),
                                                   m.group(5))
            else:
                tag = "fwd"
            k7_hmma[tag] = (len(lines), [line for line in lines
                                         if "HMMA" in line])
    print("K7 HMMA per instantiation (instructions, HMMA): {}".format(
        {tag: (n, len(h)) for tag, (n, h) in sorted(k7_hmma.items())}))
    product = [h for tag, (_, h) in k7_hmma.items()
               if tag.startswith("bwd<15,")]
    check(len(product) == 2 and all(product)
          and all("TF32" in line for h in product for line in h),
          "K7's backward issues HMMA .TF32 (3xTF32 on the tensor cores)")
    fwd_mma = [h for tag, (_, h) in k7_hmma.items()
               if tag.startswith("fwd_mma<")]
    check(len(fwd_mma) == 16 and all(fwd_mma)
          and all("TF32" in line for h in fwd_mma for line in h)
          and "fwd" in k7_hmma and not k7_hmma["fwd"][1],
          "K7's forward issues HMMA .TF32 in each of its 16 tensor-core "
          "instantiations and none in its FP32 kernel")
    # the row passes of K4, K5 and K9 convert each value to float64 once:
    # their F2F.F64.F32 per kernel (the staging's and the first window's,
    # none per tap); K5's fused pair converts each raw value it reads (the
    # products are formed in float64) and K4's fused form each value read
    f2f = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        for kernel in ("gc_stats_rows", "gc_solve_cached_rows",
                       "gf_apply_rows", "gf_solve_rows", "gf_fused_kernel",
                       "box_row_kernel", "box_fused_kernel"):
            if kernel in name:
                targs = re.findall(r"(?:Li|Lb)(\d+)E",
                                   name.split(kernel)[1])
                tag = kernel + ("<{}>".format(", ".join(targs)) if targs
                                else "")
                tag += (" (K4)" if "box_" in kernel else
                        " (K5)" if "guided_cu" in name else " (K9)")
                f2f[tag] = fn.count("F2F.F64.F32")
    print("F2F.F64.F32 per row-pass kernel:", dict(sorted(f2f.items())))
    check(any("box_row_kernel" in t for t in f2f)
          and any("box_fused_kernel" in t for t in f2f)
          and sum("gf_fused_kernel" in t for t in f2f) == 12,
          "the F2F count covers K4's row kernels and K5's 12 fused "
          "instantiations")

    # the column passes of K4, K5 and K9 stream each item's rows into a
    # ring in shared memory by asynchronous copies: LDGSTS in every
    # instantiation (box_common.cuh, col_stream)
    ldgsts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        for kernel in ("col_sum_kernel", "gf_moment_cols"):
            if kernel in name:
                targs = re.findall(r"(?:Li|Lb)(\d+)E", name.split(kernel)[1])
                tag = kernel + ("<{}>".format(", ".join(targs)) if targs
                                else "")
                tag += (" (K4)" if "box_filter_cu" in name else
                        " (K5)" if "guided_cu" in name else " (K9)")
                ldgsts[tag] = fn.count("LDGSTS")
    print("LDGSTS per column-pass kernel:", dict(sorted(ldgsts.items())))
    check(len(ldgsts) == 10 and all(ldgsts.values()),
          "the ten column-pass instantiations copy their rows by cp.async "
          "(LDGSTS)")

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
        # K2 at sigma_s 80 (radius 120): past its one-band kernel's shared
        # memory in both forms, the disk's rows in bands
        band_rng = np.random.RandomState(args.seed + 5)
        band_planes = torch.from_numpy(np.floor(
            band_rng.rand(*BAND_SHAPE) * 256).astype(np.float32)).to(dev)
        for form in (torch.uint8, torch.float32):
            x_in = band_planes.to(form)
            qk = bilateral_gray_self(x_in, -1, SIGMA_C, BAND_SIGMA_S)
            qp = bilateral_gray_self_plain(x_in, -1, SIGMA_C, BAND_SIGMA_S)
            torch.cuda.synchronize()
            err = (qk - qp).abs().max().item()
            dl = (u8(qk) - u8(qp)).abs()
            eq = (dl == 0).float().mean().item()
            print("K2 {} r=120 (in bands) {}: max|d|={:.3e}  uint8 max {:.0f} "
                  "level, {:.4%} equal".format("x".join(map(str, BAND_SHAPE)),
                                               form, err, dl.max().item(), eq))
            check(err <= 1e-3 and dl.max().item() <= 1 and eq >= 0.999,
                  "K2 r=120 {}: <= 1e-3, <= 1 uint8 level, >= 99.9% "
                  "equal".format(form))

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
        # WHDR's scores in one launch beside K3, against the composition
        # on the card (kernels=False), on the same plane
        score_comps = torch.from_numpy(make_synthetic_comps(
            args.seed + 3, K, batch=B)).to(dev)
        scores_k = whdr_scores(plane, score_comps, 0.1)
        scores_p = whdr_per_image(plane, score_comps, kernels=False)
        torch.cuda.synchronize()
        errs["whdr_scores"] = (scores_k - scores_p).abs().max().item()
        check(errs["whdr_scores"] <= 1e-6, "WHDR scores within 1e-6 of the "
              "composition (max {:.2e})".format(errs["whdr_scores"]))

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
        # each shape by both forms where the fused one takes its rows
        worst = 0.0
        for name, (planes, radius) in box_in.items():
            forms = (("fused", "two-pass") if planes.shape[2] <= BOX_WIDEST
                     else ("two-pass",))
            for border, form in ((b_, f_) for b_ in ("reflect", "reflect101")
                                 for f_ in forms):
                bk = box_filter_planar(planes, radius, border, path=form)
                bp = box_filter_planar_plain(planes, radius, border)
                torch.cuda.synchronize()
                err = (bk - bp).abs().max().item()
                tol = box_tol(planes.shape, radius)
                if name == "32x256x256":
                    worst = max(worst, err)
                print("K4 {} r={} {} {}: max|d|={:.3e} (gate {:.3e})".format(
                    name, radius, border, form, err, tol))
                check(err <= tol, "K4 {} {} {} within 8 float32 ulps of the "
                      "plain block partials".format(name, border, form))
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
        # each case by both paths where the fused pair takes its width
        worst = 0.0
        for (name, (g_in, s_in, radius)), path in (
                (case, path) for case in gf_in.items()
                for path in (("fused", "four-pass") if fused_fits(
                    min(case[1][1].shape[1], 3), case[1][1].shape[3])
                    else ("four-pass",))):
            qk = guided_filter_fused(g_in, s_in, radius, GF_EPS, path=path)
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
            print("K5 {} {} r={} eps={}: max|d|={:.3e}  uint8 max {:.0f} "
                  "level, {:.4%} equal".format(name, path, radius, GF_EPS,
                                               err, dl.max().item(), eq))
            check(err <= 0.05, "K5 {} {}: max|d| <= 0.05".format(name, path))
            check(dl.max().item() <= 1 and eq >= 0.999,
                  "K5 {} {}: <= 1 uint8 level, >= 99.9% equal".format(
                      name, path))
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
        # every float pairing at its largest radius (a frame smaller than
        # the radius: reflection repeats; against the plain version in
        # float64, whose float32 running sums over the disk drift by ~1e-3
        # at radius 73, printed beside) and at sigma_s = 3 on ragged tiles,
        # radius 4
        for cj, cs in ((1, 1), (1, 3), (3, 1), (3, 3)):
            r_max = one_band_radius(cj, cs, False, False)
            for (n_, h_, w_), d, sigma_s in (
                    ((1, 40, 52), 2 * r_max + 1, SIGMA_S),
                    ((1, 40, 52), 2 * r_max + 3, SIGMA_S),
                    ((2, 37, 70), -1, 3.0)):
                j, s_ = floats(n_, cj, h_, w_), floats(n_, cs, h_, w_)
                qk = joint_bilateral_planar_batched(j, s_, d, SIGMA_C,
                                                    sigma_s)
                coeffs = opencv_bilateral_coeffs(d, SIGMA_C, sigma_s)
                qp = bilateral_joint_plain(j, s_, *coeffs)
                if d > 0:
                    print("  against the float32 plain version: max|d|="
                          "{:.3e}".format((qk - qp).abs().max().item()))
                    qp = bilateral_joint_plain(j.double(), s_.double(),
                                               *coeffs).float()
                torch.cuda.synchronize()
                err = (qk - qp).abs().max().item()
                dl = (u8(qk) - u8(qp)).abs()
                eq = (dl == 0).float().mean().item()
                what = "K6 float cj={} cs={} r={} {}x{}x{}{}".format(
                    cj, cs, coeffs[0], n_, h_, w_,
                    " (float64 plain)" if d > 0 else "")
                print("{}: max|d|={:.3e}  uint8 max {:.0f} level, {:.4%} "
                      "equal".format(what, err, dl.max().item(), eq))
                check(err <= 1e-3 and dl.max().item() <= 1 and eq >= 0.999,
                      "{}: <= 1e-3, <= 1 uint8 level, >= 99.9% equal".format(
                          what))
        # every instantiation of K6 at sigma_s 80 (radius 120, past every
        # one-band kernel: the disk's rows in bands); the uint8 form against
        # its float32 plain version (the same tap order), the float form
        # against the plain version in float64
        for instance in K6_INSTANCES:
            cj, cs, self_guided, u8_tile = instance
            planes_ = {(u8_tile, c): (torch.floor(torch.from_numpy(
                band_rng.rand(BAND_SHAPE[0], c, *BAND_SHAPE[1:]) * 256))
                if u8_tile else torch.from_numpy(band_rng.rand(
                    BAND_SHAPE[0], c, *BAND_SHAPE[1:]) * 255)).float().to(dev)
                for c in (1, 3)}
            j, s_ = planes_[(u8_tile, cj)], planes_[(u8_tile, cs)]
            if self_guided:
                qk = bilateral_color_self_batched(j, -1, SIGMA_C,
                                                  BAND_SIGMA_S)
                s_ = j
            elif u8_tile:
                qk = bilateral_packed_joint_batched(j, s_, -1, SIGMA_C,
                                                    BAND_SIGMA_S)
            else:
                qk = joint_bilateral_planar_batched(j, s_, -1, SIGMA_C,
                                                    BAND_SIGMA_S)
            coeffs = opencv_bilateral_coeffs(-1, SIGMA_C, BAND_SIGMA_S)
            if u8_tile:
                qp = bilateral_joint_plain(j, s_, *coeffs, u8=True)
            else:
                qp = bilateral_joint_plain(j.double(), s_.double(),
                                           *coeffs).float()
            torch.cuda.synchronize()
            err = (qk - qp).abs().max().item()
            dl = (u8(qk) - u8(qp)).abs()
            eq = (dl == 0).float().mean().item()
            what = "K6 {} cj={} cs={}{} r={} {} (in bands)".format(
                "u8" if u8_tile else "float", cj, cs,
                " self" if self_guided else "", coeffs[0],
                "x".join(map(str, BAND_SHAPE)))
            print("{}: max|d|={:.3e}  uint8 max {:.0f} level, {:.4%} "
                  "equal".format(what, err, dl.max().item(), eq))
            check(err <= 1e-3 and dl.max().item() <= 1 and eq >= 0.999,
                  "{}: <= 1e-3, <= 1 uint8 level, >= 99.9% equal".format(
                      what))

    phase("3t. training kernels vs plain on the card")
    train_errs, split_launches = check_training_kernels(dev, args.seed)
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
                "whdr_scores": whdr_scores,
                "guide_stats": guide_stats,
                "guided_apply_cached": guided_apply_cached,
                "cnn_train_bwd_split": k7.trunk_backward_variant}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0
        # the fused forms' launches, counted apart (K4, K5, K9)
        box_filter_planar.fused_launches = 0
        guided_filter_fused.fused_launches = 0
        guide_stats.fused = 0
        guided_apply_cached.fused = 0

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
            "cnn_fwd", "bilateral_gray_self", "whdr_scores"))
        check(launches["whdr_scores"] == len(requests)
              and launches["whdr_gather"] == 0,
              "bf serving scores WHDR in one launch a batch, no K3")
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
            "cnn_fwd", "guided_filter", "whdr_scores"))
        check(gf_launches["whdr_scores"] == len(gf_requests)
              and gf_launches["whdr_gather"] == 0,
              "gf serving scores WHDR in one launch a batch, no K3")
        print("K5's fused launches in the gf serving run: {}".format(
            guided_filter_fused.fused_launches))
        check(guided_filter_fused.fused_launches
              == gf_launches["guided_filter"],
              "every K5 launch of the gf serving run took the fused pair")
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

    phase("4e. serving export: cnn, bf and gf artifacts of {} x {}x{} and "
          "a symbolic cnn, exported on the card, saved, loaded, served phase "
          "4's requests".format(B, H, W))
    artifacts, export_s, load_s, sizes = {}, {}, {}, {}
    export_dir = tempfile.mkdtemp(prefix="rf_export_")
    try:
        for kind in EXPORT_KINDS:
            path = os.path.join(export_dir, kind + ".pt2")
            t0 = time.perf_counter()
            sizes[kind] = serving.export_flagship(
                path, B, H, W, device=dev,
                pipeline="cnn" if kind == "symbolic" else kind,
                symbolic=kind == "symbolic", params=params)
            export_s[kind] = time.perf_counter() - t0
            t0 = time.perf_counter()
            artifacts[kind] = serving.load_flagship(path)
            load_s[kind] = time.perf_counter() - t0
            print("{}: export {:.3f} s, load {:.3f} s, {} bytes".format(
                kind, export_s[kind], load_s[kind], sizes[kind]))
    finally:
        shutil.rmtree(export_dir)
    direct = {"cnn": pipeline_fn("cnn", net, dev), "bf": bf, "gf": gf}
    served_by = {"cnn": requests, "bf": requests, "gf": gf_requests}
    with torch.no_grad():
        for kind, run in direct.items():
            for img in served_by[kind]:
                exp = run(img)
                reset_launches()
                got = artifacts[kind](img)
                torch.cuda.synchronize()
                counts = {name: fn.launches for name, fn in wrappers.items()}
                want = {name: int(name in EXPORT_KERNELS[kind])
                        for name in wrappers}
                check(counts == want, "the {} artifact launched {} once a "
                      "call and no other kernel".format(
                          kind, ", ".join(EXPORT_KERNELS[kind])))
                check(got.shape == (B, H, W) and torch.equal(got, exp),
                      "the {} artifact bitwise pipeline_fn('{}')".format(
                          kind, kind))
        srng = np.random.RandomState(args.seed + 14)
        for shape in SYMBOLIC_SHAPES:
            img = torch.from_numpy(photos(srng, shape[0], *shape[2:])).to(dev)
            reset_launches()
            got = artifacts["symbolic"](img)
            torch.cuda.synchronize()
            check(reflectance_cnn.launches == 1, "the symbolic artifact "
                  "launched K1 once at {}".format(shape))
            check(torch.equal(got, dec_cli.decompose_planar(weights, img)),
                  "the symbolic artifact at {} bitwise decompose_planar"
                  .format(shape))

    phase("4c. the iterated chain: guided_filter_iterated(planar=True), "
          "{} iterations".format(CHAIN_ITERS))
    chain_launches = {}
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
            print("{} chain: K9's fused launches: statistics {}, "
                  "applications {}".format(name, guide_stats.fused,
                                           guided_apply_cached.fused))
            check(guide_stats.fused == 1
                  and guided_apply_cached.fused == CHAIN_ITERS,
                  "the {} chain took K9's fused kernels (.fused counted "
                  "for the statistics and each application)".format(name))
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
                # one traced 4K chain: K9's kernels are the fused pairs, one
                # for the statistics and two an application, so no column
                # sum plane reaches device memory
                from reflectance_filtering_tpu_torch.utils.profiling import (
                    profile_calls)
                traced = profile_calls(lambda: guided_filter_iterated(
                    g_in, s_in, GF_R, GF_EPS, CHAIN_ITERS, planar=True), 3)[0]
                k9_names = [n for n, _, _ in traced[-1]
                            if any(k in n for k in K9_KERNEL_NAMES)]
                print("4K chain, one traced call: {} K9 launches: {}".format(
                    len(k9_names), sorted({n[:60] for n in k9_names})))
                check(len(k9_names) == 1 + 2 * CHAIN_ITERS
                      and all("fused" in n for n in k9_names),
                      "the 4K 3x chain issues {} K9 launches, each a fused "
                      "pair".format(1 + 2 * CHAIN_ITERS))

    phase("4t. training: {} steps of fit at batch {} x {}x{}, K={}, {} "
          "images on the card".format(TRAIN_STEPS, TB, H, W, K, TRAIN_N))
    train_data = training_set(args.seed + 7, TRAIN_N, K)
    flagship = NetworkConfig()
    train_kernels = ("cnn_train_fwd", "cnn_train_bwd", "whdr_gather",
                     "whdr_scatter", "whdr_scores")

    def train_run(steps, **kw):
        losses = []
        state = fit(flagship, LossConfig(), train_data, steps * TB, TB,
                    random_seed=args.seed, device=dev,
                    progress=lambda s, n, m: losses.append(m["loss_total"]),
                    **kw)
        return state, losses

    reset_launches()
    k7.trunk_forward.tensor_core_launches = 0
    state_k, loss_k = train_run(TRAIN_STEPS)
    train_launches = read_launches("training", train_kernels)
    per_step = {counter: n for _, n, counter in TRAIN_STEP_KERNELS.values()}
    check(all(train_launches[counter] == n * TRAIN_STEPS
              for counter, n in per_step.items()),
          "fit's chunks (a warm-up step, then replays of the captured step) "
          "launched each training kernel its per-step count {} times {} "
          "steps, as counted by the wrappers and the replays".format(
              per_step, TRAIN_STEPS))
    check(k7.trunk_forward.tensor_core_launches
          == train_launches["cnn_train_fwd"],
          "every training step's K7 forward ran on the tensor cores")
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
        resumed, _ = train_run(TRAIN_STEPS, init_params=p10,
                               init_opt_state=o10, base_samples=10 * TB)
    diff = max_param_diff(resumed.params, state_k.params)
    print("resume at step 10 against 20 uninterrupted steps: params max|d|="
          "{:.3e}".format(diff))
    check(resumed.samples == state_k.samples and diff <= 1e-6,
          "10 steps + checkpoint + resume to 20 equals 20 steps (1e-6)")
    check_chunked_fit(dev, args.seed, train_data)

    phase("4n. the network families: compute_losses at batch {} x {}x{}, "
          "kernels on and off".format(NET_B, NET_HW, NET_HW))
    check_network_families(dev, args.seed)

    phase("4p. multi-GPU paths on the one card: spawned ranks over gloo "
          "(world sizes 2 and 4) and NCCL (world size 1)")
    check_multi_gpu(dev, args.seed)

    phase("5. the train CLI's fit stage on cuda and on the CPU")
    ckpt_dir = tempfile.TemporaryDirectory()    # removed after phase 5d
    flagship_ckpt = None
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
                if device == "cuda" and cfg == flagship:
                    # the checkpoint of phase 5d's decompose runs
                    flagship_ckpt = shutil.copy(
                        os.path.join(exp, "snapshots", snaps[-1]),
                        ckpt_dir.name)
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

    phase("5b. the port's dataset builder, then the train CLI from its "
          "dataset on cuda")
    check_builder(args.seed)

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

        # the bilateral CLI at --sigma_spatial 80 (radius 120, past every
        # one-band kernel: K6 takes the disk's rows in bands) on 96x128
        # photos: a photo by itself, and a photo guided by another (color
        # on color); each file against the same call on the CPU
        band_dir = os.path.join(tmp, "bands")
        os.mkdir(band_dir)
        small = [np.moveaxis(p_, 0, -1) for p_ in photos(rng, 2, 96, 128)]
        small_png = [os.path.join(band_dir, "photo{}.png".format(i))
                     for i in range(2)]
        for path_, img_ in zip(small_png, small):
            cv2.imwrite(path_, img_)
        for case, (src_png, counter) in {
                "color-self": (small_png[0], "bilateral_color_self"),
                "color on color": (small_png[1],
                                   "bilateral_packed_joint")}.items():
            reset_launches()
            filt_cli.main(["--filter_type=bilateral", "--sigma_color=20",
                           "--sigma_spatial={}".format(BAND_SIGMA_S),
                           "--filename_in", src_png, "--guidance_in",
                           small_png[0], "--path_out", band_dir,
                           "--device", "cuda"])
            read_launches("bilateral CLI sigma_s 80 " + case, (counter,))
            name = os.path.basename(src_png)[:-4] + \
                "_bilateral_c20.0s{}.png".format(BAND_SIGMA_S)
            got = cv2.imread(os.path.join(band_dir, name)).astype(int)
            want = filt_cli.apply_filter(
                "bilateral", cv2.imread(src_png), cv2.imread(small_png[0]),
                20.0, BAND_SIGMA_S, device="cpu")
            d = np.abs(got - want.astype(int)).max()
            check(d <= 1, "bilateral CLI --sigma_spatial 80 {} on cuda within "
                  "1 level of the same call on the CPU (max {})".format(case,
                                                                        d))

        # the float filter's entry point (the JAX package's width-sharded
        # filter calls it), called directly: photo joint, gray src
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

    phase("5g. the bilateral grid: the filter CLI on cuda against the CPU, "
          "the quality point against K2")
    check_grid(dev, args.seed)

    phase("5d. the train CLI's --decompose from phase 5's flagship snapshot, "
          "on cuda and on the CPU; predict_batched and "
          "decompose_images_batched at full size")
    check(flagship_ckpt is not None, "phase 5 kept the flagship's snapshot "
          + os.path.basename(flagship_ckpt or ""))
    with tempfile.TemporaryDirectory() as tmp:
        dec = {}
        for device in ("cuda", "cpu"):
            folder = os.path.join(tmp, "in_" + device)
            expected = decompose_inputs(folder, args.seed + 11)
            out_root = os.path.join(tmp, "out_" + device)
            reset_launches()
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                train_cli.main(["--stage=predict", "--predictCaffemodel",
                                flagship_ckpt, "--decompose", folder,
                                "--experiment=dec", "--data_root",
                                os.path.join(tmp, "no_dataset"),
                                "--results_root", out_root, "--device",
                                device])
            print("train CLI --decompose on {}: {:.2f} s; the image "
                  "decoders served {}".format(
                      device, time.perf_counter() - t0,
                      native_loader.read_images_rgb.last_decoders))
            if device == "cuda":
                read_launches("train CLI --decompose on cuda",
                              ("cnn_train_fwd",))
            text = log.getvalue()
            check("broken.png" in text and "was not possible" in text,
                  "--decompose on {}: the unreadable file reported, the run "
                  "returned".format(device))
            dec[device] = (folder, os.path.join(out_root, "dec"), expected)
        (c_in, c_res, (pngs, movies)), (p_in, p_res, _) = (dec["cuda"],
                                                           dec["cpu"])
        worst, missing = 0, []
        for sub in ("decompositions_linear", "decompositions_sRGB"):
            check(all(os.path.isfile(os.path.join(res, sub, "0command.txt"))
                      for res in (c_res, p_res)),
                  "0command.txt in {} of both runs".format(sub))
            for name in pngs:
                a = cv2.imread(os.path.join(c_res, sub, name))
                b_ = cv2.imread(os.path.join(p_res, sub, name))
                if a is None or b_ is None or a.shape != b_.shape:
                    missing.append(os.path.join(sub, name))
                    continue
                worst = max(worst, int(np.abs(a.astype(int) - b_).max()))
        check(not missing and worst <= 1, "{} PNGs written on cuda and on the "
              "CPU, within 1 uint8 level (max {}; missing: {})".format(
                  2 * len(pngs), worst, missing or "none"))
        with np.load(os.path.join(c_in, "stack_decomposed.npz")) as g_, \
                np.load(os.path.join(p_in, "stack_decomposed.npz")) as w_:
            npz_err = max(float(np.abs(g_[key].astype(np.float64)
                                       - w_[key]).max()) for key in w_.files)
            check(len(w_.files) == 7 and npz_err <= 1e-4, "npz: 7 arrays on "
                  "cuda within 1e-4 of the CPU's (max {:.2e})".format(
                      npz_err))
        srgb = os.path.join(c_res, "decompositions_sRGB")
        check(all(os.path.isfile(os.path.join(srgb, m)) for m in movies),
              "the five movie files: " + ", ".join(movies))
        cap = cv2.VideoCapture(os.path.join(srgb, "clip-combined.mp4"))
        size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
        cap.release()
        check(size == (3 * DEC_MOVIE[2], DEC_MOVIE[1], DEC_MOVIE[0]),
              "the triptych is 3x as wide: {}x{}, {} frames".format(*size))

    # predict_batched and decompose_images_batched at full size, from the
    # same snapshot
    dec_params = params_to_torch(load_checkpoint(flagship_ckpt)[0], dev)
    predict = make_predict_fn(flagship)
    fgen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    fh, fw = FRAME_HW
    with torch.no_grad():
        frames = srgb_to_rgb_t(device_photos(fgen, FRAMES, fh, fw) / 255.0)
        frames = frames.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    before = k7.trunk_forward.launches
    refl = predict_batched(predict, dec_params, frames, FRAME_BATCH,
                           dev)["reflectance"]
    frame_launches = k7.trunk_forward.launches - before
    with torch.no_grad():
        first = torch.from_numpy(frames[:1]).to(dev)
        plain = torch.relu(apply_network(dec_params, first, flagship,
                                         kernels=False)["RS_est"])
        frame_err = np.abs(refl[:1] - plain.cpu().numpy()).max()
    check(refl.shape == (FRAMES, fh, fw, 1) and bool(np.isfinite(refl).all())
          and frame_launches == FRAMES // FRAME_BATCH and frame_err <= 1e-4,
          "predict_batched of {} {}x{} frames in batches of {}: finite, K7's "
          "forward once a batch, frame 0 within 1e-4 of the plain per-layer "
          "path on the card (max {:.2e})".format(FRAMES, fh, fw, FRAME_BATCH,
                                                frame_err))
    del frames, refl
    ph, pw = PNG_HW
    png_dir = os.path.join(ckpt_dir.name, "pngs")
    os.makedirs(png_dir)
    with torch.no_grad():
        pngs = device_photos(fgen, PNG_N, ph, pw).to(torch.uint8)
        pngs = pngs.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    png_paths = []
    for i, img in enumerate(pngs):
        png_paths.append(os.path.join(png_dir, "photo{:02d}.png".format(i)))
        cv2.imwrite(png_paths[-1], img)
    done = decompose_images_batched(png_paths, dec_params, flagship,
                                    os.path.join(ckpt_dir.name, "png_out"),
                                    batch_size=16, device=dev)
    check(sorted(done) == png_paths, "decompose_images_batched wrote all {} "
          "PNGs of {}x{}".format(PNG_N, ph, pw))
    ckpt_dir.cleanup()

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
        "whdr_scores": ("reflectance_filtering_tpu_torch/csrc/whdr_gather.cu",
                        "reflectance_filtering_tpu_torch/losses/whdr.py "
                        "_whdr_per_image (its composition around K3)"),
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
    for name in ("cnn_train_fwd", "cnn_train_bwd", "whdr_gather",
                 "whdr_scatter"):
        launches[name] = train_launches[name]
    for name in ("guide_stats", "guided_apply_cached"):
        launches[name] = chain_launches["4K"][name]
    launches["cnn_train_bwd_split"] = split_launches
    print("chip_smoke: {:.1f} s in all".format(time.perf_counter() - _START))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
