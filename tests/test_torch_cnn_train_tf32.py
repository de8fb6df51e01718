"""K7's backward arithmetic (csrc/cnn_train.cu), 3xTF32, emulated on the CPU.

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
The fuse head's dW_fuse, the bias sums and dx stay float32.  Here that
arithmetic is emulated with numpy (tf32_rna from test_torch_cnn_tf32.py,
each k block's products summed in float64, where tf32 products are exact,
and added to the float32 accumulator in the kernel's order).  Gates: each
gradient leaf within 2e-4 of its max of the float64 backward (the card's
gate against the plain backward), and one TF32 product at least 10x further
from float64 than three.  The kernel itself is held against the plain
version on the card (chip_smoke.py, test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
import torch

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
