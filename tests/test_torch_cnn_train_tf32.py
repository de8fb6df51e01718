"""K7's arithmetic (csrc/cnn_train.cu), 3xTF32, emulated on the CPU: its
backward, and its forward on the tensor cores.

The kernel runs the backward's three matrix products on the tensor cores
(mma.sync m16n8k8, f32 += tf32 x tf32, each operand split into hi =
rna_tf32(x) and lo = rna_tf32(x - hi), hi.hi + hi.lo + lo.hi accumulated in
float32):
  * the rematerialisation, h_l = relu(h_{l-1} W_l + b_l) with pixels as M
    (the bias is the accumulator's start, ci padded to one k block of 8);
  * the chain, dz_l = (g W_f,l^T + dz_{l+1} W_{l+1}^T) * [h_l > 0], the
    fuse term first as one k block of the g tile padded to 8 rows;
  * the weight gradients dW_l^T = dz_l^T a_{l-1}, K = pixels in blocks of
    8, one float32 accumulator over a block's pixels.
The fuse head's dW_fuse, the bias sums and dx stay float32.  The forward
on the tensor cores (trunk_fwd_mma_kernel, the shapes that
``forward_on_tensor_cores`` admits) runs layer 0 as float32 FMAs (from
zero over the inputs, then the bias), layers 1..n-1 as one mma3 a k block
(lo.hi, hi.lo and hi.hi into a zeroed accumulator, then added to the
bias-started sum in float32), and the skip fuse in float32: each lane t
of a row group sums channels 8 nt + 2t and 8 nt + 2t + 1 of every layer
in order, and the 4 lanes' sums are added pairwise (t ^ 1, then t ^ 2).
Here that
arithmetic is emulated with numpy (tf32_rna from test_torch_cnn_tf32.py,
each k block's products summed in float64, where tf32 products are exact,
and added to the float32 accumulator in the kernel's order).  Gates: each
gradient leaf within 2e-4 of its max of the float64 backward (the card's
gate against the plain backward), and one TF32 product at least 10x further
from float64 than three; the forward within 1e-5 of the largest |pre| of
the float64 forward (the card's gate against the plain trunk) and within
5e-5 of the JAX package's ``_fwd_kernel`` in TPU-interpret mode (its own
bf16x3 error, test_torch_train_trunk.py's gate).  The kernels themselves
are held against the plain versions on the card (chip_smoke.py,
test_torch_kernels_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.ops.cnn_train_pallas import (
    skip_trunk_pre as j_trunk)
from reflectance_filtering_tpu_torch.ops import cnn_train_kernel as k7

from test_torch_cnn_tf32 import tf32_rna

P = 2048   # 32 tiles of 64 pixels


def mm_tf32(a, b, acc, products=3):
    """acc (float32 [M, N]) += a [M, K] @ b [K, N] as the kernel's mma's: per
    k block of 8, lo.hi, hi.lo and hi.hi (hi.hi alone with products=1),
    each summed in float64 and added to acc in float32."""
    for k0 in range(0, a.shape[1], 8):
        ab, bb = a[:, k0:k0 + 8], b[k0:k0 + 8]
        a_hi, b_hi = tf32_rna(ab), tf32_rna(bb)
        a_lo, b_lo = tf32_rna(ab - a_hi), tf32_rna(bb - b_hi)
        terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if products == 3
                 else [(a_hi, b_hi)])
        for x, y in terms:
            acc = (acc.astype(np.float64)
                   + x.astype(np.float64) @ y.astype(np.float64)).astype(
                       np.float32)
    return acc


def pad8(a):
    """a [rows, K] with K padded by zero columns to a multiple of 8."""
    return np.pad(a, ((0, 0), (0, -a.shape[1] % 8)))


def emulated_backward(x, g, flat, shape, products=3):
    """The flat parameter gradient of K7's backward on x [P, ci], g [P,
    cout] (float32), emulated as the kernel computes it."""
    n, ci, f, cout = shape
    ws, bs = [[t.numpy() for t in part] for part in k7.unpack(
        torch.from_numpy(flat), shape)]
    grad = np.zeros_like(flat)
    gws, gbs = [[t.numpy() for t in part] for part in k7.unpack(
        torch.from_numpy(grad), shape)]
    hs, a = [], pad8(x)
    for l in range(n):
        w = np.pad(ws[l], ((0, a.shape[1] - ws[l].shape[0]), (0, 0)))
        acc = np.broadcast_to(bs[l], (len(x), f)).astype(np.float32)
        a = np.maximum(mm_tf32(a, w, acc, products), 0)
        hs.append(a)
    gp = pad8(g)
    gbs[-1][:] = g.astype(np.float64).sum(0)
    gws[-1][:] = (np.concatenate(hs, 1).astype(np.float64).T @ g).astype(
        np.float32)
    dz = None
    for l in range(n - 1, -1, -1):
        wf = np.pad(ws[-1][l * f:(l + 1) * f].T, ((0, -cout % 8), (0, 0)))
        acc = mm_tf32(gp, wf, np.zeros((len(x), f), np.float32), products)
        if dz is not None:
            acc = mm_tf32(dz, ws[l + 1].T.copy(), acc, products)
        dz = np.where(hs[l] > 0, acc, np.float32(0))
        gbs[l][:] = dz.astype(np.float64).sum(0)
        a = pad8(x) if l == 0 else hs[l - 1]
        dwt = mm_tf32(dz.T.copy(), a, np.zeros((f, a.shape[1]), np.float32),
                      products)
        gws[l][:] = dwt.T[:ws[l].shape[0]]
    return grad


def _inputs(shape, seed):
    """The split script's recipe at P pixels: kernels N(0, 0.1), biases
    N(0, 0.01), x and g uniform, made with numpy."""
    n, ci, f, cout = shape
    rng = np.random.RandomState(seed)
    weights, biases = [], []
    for fin in [ci] + [f] * (n - 1):
        weights.append(rng.randn(fin, f) * .1)
        biases.append(rng.randn(f) * .01)
    weights.append(rng.randn(n * f, cout) * .1)
    biases.append(rng.randn(cout) * .01)
    flat = k7.pack([torch.tensor(w, dtype=torch.float32) for w in weights],
                   [torch.tensor(b, dtype=torch.float32)
                    for b in biases]).numpy()
    x = rng.rand(P, ci).astype(np.float32)
    g = (rng.rand(P, cout) - 0.5).astype(np.float32)
    return x, g, flat


def _worst_leaf(got, exact, shape):
    """The largest |got - exact| of a leaf over that leaf's largest |exact|."""
    worst = 0.0
    for part in (0, 1):
        for a, b in zip(k7.unpack(torch.from_numpy(got).double(), shape)[part],
                        k7.unpack(exact, shape)[part]):
            worst = max(worst, ((a - b).abs().max()
                                / b.abs().max().clamp_min(1e-30)).item())
    return worst


def _exact(x, g, flat, shape):
    return k7.trunk_backward_plain(torch.from_numpy(x).double(),
                                   torch.from_numpy(g).double(),
                                   torch.from_numpy(flat).double(), shape,
                                   False)[0]


@pytest.mark.parametrize("shape", [(5, 3, 32, 1), (2, 3, 16, 1),
                                   (3, 3, 16, 6), (2, 5, 40, 3)])
def test_three_products_keep_the_gradient_gate(shape):
    """Each leaf within 2e-4 of its max of the float64 backward, on the
    flagship, the JAX package's test trunk, RS's 6-wide head and a trunk
    whose width is no multiple of 16 (dW's m tiles read zero rows)."""
    x, g, flat = _inputs(shape, 3)
    got = emulated_backward(x, g, flat, shape)
    assert _worst_leaf(got, _exact(x, g, flat, shape), shape) <= 2e-4


def test_one_product_is_ten_times_less_accurate():
    """Why three: hi.hi alone keeps ~11 bits of each operand."""
    shape = (5, 3, 32, 1)
    x, g, flat = _inputs(shape, 4)
    exact = _exact(x, g, flat, shape)
    three = _worst_leaf(emulated_backward(x, g, flat, shape), exact, shape)
    one = _worst_leaf(emulated_backward(x, g, flat, shape, products=1),
                      exact, shape)
    assert one >= 10 * three, (one, three)


def _f32_fma(a, b, c):
    """float32 fma(a, b, c): the float64 product of two float32 values is
    exact, so one rounding of product + c."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulated_forward(x, flat, shape):
    """pre [P, cout] of K7's forward on the tensor cores on x [P, ci]
    (float32), emulated as the kernel computes it."""
    n, ci, f, cout = shape
    ws, bs = [[t.numpy() for t in part] for part in k7.unpack(
        torch.from_numpy(flat), shape)]
    a = np.zeros((len(x), f), np.float32)
    for c in range(ci):
        a = _f32_fma(x[:, c:c + 1], ws[0][c], a)
    hs = [np.maximum(a + bs[0], np.float32(0))]
    for l in range(1, n):
        acc = np.broadcast_to(bs[l], (len(x), f)).astype(np.float32)
        for k0 in range(0, f, 8):
            ab, bb = hs[-1][:, k0:k0 + 8], ws[l][k0:k0 + 8]
            a_hi, b_hi = tf32_rna(ab), tf32_rna(bb)
            a_lo, b_lo = tf32_rna(ab - a_hi), tf32_rna(bb - b_hi)
            d = np.zeros_like(acc)
            for u, v in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                d = (d.astype(np.float64) + u.astype(np.float64)
                     @ v.astype(np.float64)).astype(np.float32)
            acc = acc + d
        hs.append(np.maximum(acc, np.float32(0)))
    part = np.zeros((4, len(x), cout), np.float32)
    for l in range(n):
        wl = ws[-1][l * f:(l + 1) * f]
        for t in range(4):
            for nt in range(f // 8):
                for j in (0, 1):
                    o = 8 * nt + 2 * t + j
                    part[t] = _f32_fma(hs[l][:, o:o + 1], wl[o], part[t])
    return ((part[0] + part[1]) + (part[2] + part[3])) + bs[-1]


def _trunk_inputs(shape, seed):
    """x in [0, 1), weights N(0, 0.3): pre-activations of both signs in
    every layer."""
    rng = np.random.RandomState(seed)
    x = rng.rand(P, shape[1]).astype(np.float32)
    flat = (rng.randn(k7.num_params(shape)) * 0.3).astype(np.float32)
    return x, flat


def _jax_forward(x, flat, shape):
    """The JAX package's fused trunk (``_fwd_kernel``) in TPU-interpret
    mode on the same weights."""
    n = shape[0]
    ws, bs = k7.unpack(torch.from_numpy(flat), shape)
    names = k7.layer_names(n)
    params = {m: {"kernel": jnp.asarray(w.numpy()[None, None]),
                  "bias": jnp.asarray(b.numpy())}
              for m, w, b in zip(names, ws, bs)}
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(j_trunk(params, jnp.asarray(x), num_layers=n,
                                  tile=512))


@pytest.mark.parametrize("shape", [(5, 3, 32, 1), (3, 3, 16, 6),
                                   (2, 8, 24, 2), (2, 5, 40, 3)])
def test_tensor_core_forward_keeps_the_forward_gate(shape):
    """The flagship, RS's 6-wide head, the most input channels (ci = 8)
    and a width of 5 n tiles (one m tile a warp step): within 1e-5 of the
    largest |pre| of the float64 forward, and within 5e-5 of the JAX
    kernel's, whose bf16x3 products are themselves ~2e-5 from float64 on
    the flagship (test_torch_train_trunk.py's gate against it)."""
    assert k7.forward_on_tensor_cores(shape)
    x, flat = _trunk_inputs(shape, 5)
    got = emulated_forward(x, flat, shape)
    exact = k7.trunk_forward_plain(torch.from_numpy(x).double(),
                                   torch.from_numpy(flat).double(),
                                   shape).numpy()
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-5 * scale
    jax_pre = _jax_forward(x, flat, shape)
    assert np.abs(got - jax_pre).max() <= 5e-5 * scale


@pytest.mark.parametrize("shape,tensor_cores", [
    ((5, 3, 32, 1), True), ((1, 1, 8, 1), True), ((3, 8, 64, 8), True),
    ((5, 3, 64, 1), True), ((6, 3, 64, 1), False), ((2, 3, 72, 1), False),
    ((2, 3, 128, 1), False), ((3, 8, 256, 8), False),
    ((5, 3, 256, 1), False), ((257, 3, 8, 1), True),
    ((258, 3, 8, 1), False)])
def test_forward_shape_rule(shape, tensor_cores):
    """The forward's kernel by shape alone: f <= 64 and (n - 1) f^2 <=
    16,384; the flagship and the narrow trunks on the tensor cores, the
    wide ones on the FP32 pipe."""
    assert k7.forward_on_tensor_cores(shape) is tensor_cores
