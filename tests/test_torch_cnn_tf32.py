"""K1's 3xTF32 arithmetic (csrc/cnn_fwd.cu), emulated on the CPU.

The kernel runs the flagship network's layers 1-4 on the tensor cores
(mma.sync m16n8k8, f32 += tf32 x tf32): each operand is split into hi =
rna_tf32(x) and lo = rna_tf32(x - hi), and hi.hi + hi.lo + lo.hi is
accumulated in float32.  Here that arithmetic is emulated with numpy:
``cvt.rna.tf32.f32`` on the bits, each mma's products summed in float64
(tf32 products are exact there) and added to the float32 accumulator, the
k blocks and the three products in the kernel's order.  One emulation
stages the weights as the kernel does (B fragments in the permuted row
order that lets the accumulator be the next A fragment) and reads A's
columns in that order.  Gates: 2e-6 of the float64 forward, <= 1 level of
floor(r * 255) from ``reflectance_cnn_plain`` (the card's K1 gate), and one
TF32 product >= 10x further from float64 than three.  The kernel itself is
held against the plain version on the card (chip_smoke.py,
test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
import torch

from reflectance_filtering_tpu_torch.models.networks import (
    ReflectanceNet, params_from_numpy, seeded_reference_params)
from reflectance_filtering_tpu_torch.ops.cnn_kernel import (
    _unpack, pack_weights, reflectance_cnn_plain)
from reflectance_filtering_tpu_torch.utils.image import srgb_to_rgb_t
from reflectance_filtering_tpu_torch.utils.testimages import pink_noise


def tf32_rna(x):
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, to nearest
    with ties away from zero (add half of the 13 dropped bits' range to
    the magnitude, then clear them); NaN stays NaN."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    out = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, out)


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("bits,want", [
    (0x00000000, 0x00000000),        # +0
    (0x80000000, 0x80000000),        # -0
    (0x3F800000, 0x3F800000),        # 1: already tf32
    (0x3F800FFF, 0x3F800000),        # below the tie: down
    (0x3F801000, 0x3F802000),        # 1 + 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),        # its negative: away from zero too
    (0x3F803000, 0x3F804000),        # a tie above an odd tf32: up as well
    (0x3FFFF000, 0x40000000),        # the carry reaches the exponent
    (0x7F7FF000, 0x7F800000),        # past the largest tf32: infinity
    (0x7F7FEFFF, 0x7F7FE000),        # the largest tf32 stays
    (0x7F800000, 0x7F800000),        # +inf
    (0xFF800000, 0xFF800000),        # -inf
    (0x00001000, 0x00002000),        # a subnormal tie
    (0x00000FFF, 0x00000000),        # the smallest subnormals: to zero
])
def test_tf32_rna_edge_values(bits, want):
    got = tf32_rna(_f32(bits))
    assert got.view(np.uint32) == want, hex(int(got.view(np.uint32)))


def test_tf32_rna_nan_and_split():
    assert np.isnan(tf32_rna(np.float32("nan")))
    assert np.isnan(tf32_rna(_f32(0x7F800001)))     # a payload below bit 13
    x = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.abs(hi - x).max() <= 2.0 ** -11 * np.abs(x).max()
    # hi + lo keeps ~21 of float32's 24 bits
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


# A's columns within a k block of 8: logical column t is input 2t, t + 4
# is input 2t + 1 (the accumulator layout of the previous layer)
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def stage_fragments(w_mid, perm=PERM):
    """The kernel's shared-memory staging (cnn_fwd.cu, stage): per mid
    layer, k block kb, n tile nt and lane (g = lane / 4, t = lane % 4) the
    four floats hi(W[i][o]), hi(W[i + 1][o]), lo(W[i][o]), lo(W[i + 1][o])
    with i = 8kb + perm[t], i + 1 -> 8kb + perm[t + 4], o = 8nt + g."""
    frag = np.zeros((len(w_mid), 16, 32, 4), np.float32)
    for l, w in enumerate(w_mid):
        for blk in range(16):
            kb, nt = divmod(blk, 4)
            for lane in range(32):
                g, t = divmod(lane, 4)
                o = 8 * nt + g
                v = np.array([w[8 * kb + perm[t], o],
                              w[8 * kb + perm[t + 4], o]], np.float32)
                hi = tf32_rna(v)
                frag[l, blk, lane] = np.concatenate([hi, tf32_rna(v - hi)])
    return frag


def _b_blocks(frag, l, kb, nt):
    """(hi, lo) of the 8 x 8 B operand of (k block, n tile) as the mma
    reads it: b0 = (row t, column g), b1 = (row t + 4, column g)."""
    hi, lo = np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        f = frag[l, kb * 4 + nt, lane]
        hi[t, g], hi[t + 4, g], lo[t, g], lo[t + 4, g] = f
    return hi, lo


def emulated_forward(x, flat, products=3, frag=None, a_perm=PERM):
    """K1 on linear RGB x [P, 3] float32 with the flat weights: layer 0
    and the fuse in float32 (summed in float64, rounded once), layers 1-4
    as mma's: per k block and n tile, lo.hi, hi.lo and hi.hi (or hi.hi
    alone with ``products=1``) each added to the float32 accumulator.
    ``frag`` stages B as the kernel does; without it B is W's rows in
    A's column order."""
    weights, biases, fuse_w, fuse_b = (
        [t.numpy() for t in part] if isinstance(part, list) else part.numpy()
        for part in _unpack(torch.from_numpy(flat)))
    h = np.maximum((x.astype(np.float64) @ weights[0]
                    + biases[0]).astype(np.float32), 0)
    skips = [h]
    for l in range(4):
        acc = np.broadcast_to(biases[l + 1], h.shape).astype(np.float32)
        for kb in range(4):
            a = h[:, 8 * kb + a_perm]
            a_hi = tf32_rna(a)
            a_lo = tf32_rna(a - a_hi)
            for nt in range(4):
                if frag is not None:
                    b_hi, b_lo = _b_blocks(frag, l, kb, nt)
                else:
                    b = weights[l + 1][8 * kb + PERM, 8 * nt:8 * nt + 8]
                    b_hi = tf32_rna(b)
                    b_lo = tf32_rna(b - b_hi)
                terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
                         if products == 3 else [(a_hi, b_hi)])
                cols = slice(8 * nt, 8 * nt + 8)
                for aa, bb in terms:
                    acc[:, cols] = (acc[:, cols].astype(np.float64)
                                    + aa.astype(np.float64) @ bb).astype(
                                        np.float32)
        h = np.maximum(acc, 0)
        skips.append(h)
    z = (np.concatenate(skips, 1).astype(np.float64) @ fuse_w
         + fuse_b[0]).astype(np.float32)
    return (1.0 / (1.0 + np.exp(-z.astype(np.float64)))).astype(np.float32)


@pytest.fixture(scope="module")
def flagship():
    """Seeded reference weights and 4 seeded 1/f photos of 64x64 (planar
    sRGB in [0, 1]): the flat weights, x [4, 3, 4096] and its linear RGB
    as [P, 3]."""
    net = ReflectanceNet()
    net.load_state_dict(params_from_numpy(seeded_reference_params(5)))
    flat = pack_weights(net).numpy()
    rng = np.random.RandomState(11)
    x = np.stack([[np.clip(pink_noise(rng, 64, 64), 0, 255) / 255.0
                   for _ in range(3)] for _ in range(4)]).astype(np.float32)
    x = torch.from_numpy(x.reshape(4, 3, 64 * 64))
    lin = srgb_to_rgb_t(x).transpose(1, 2).reshape(-1, 3).numpy()
    return flat, x, lin


def _exact(flat, x):
    """The plain forward in float64, [P]."""
    return reflectance_cnn_plain(x.double(), torch.from_numpy(flat).double(),
                                 srgb_input=True).reshape(-1).numpy()


def test_three_products_keep_float32_accuracy(flagship):
    flat, x, lin = flagship
    exact = _exact(flat, x)
    got = emulated_forward(lin, flat)
    assert np.abs(got - exact).max() <= 2e-6
    plain = reflectance_cnn_plain(x, torch.from_numpy(flat),
                                  srgb_input=True).reshape(-1).numpy()
    levels = np.abs(np.floor(got * 255.0) - np.floor(plain * 255.0))
    assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3


def test_one_product_is_ten_times_less_accurate(flagship):
    """Why three: hi.hi alone keeps ~11 bits of each operand."""
    flat, x, lin = flagship
    exact = _exact(flat, x)
    three = np.abs(emulated_forward(lin, flat) - exact).max()
    one = np.abs(emulated_forward(lin, flat, products=1) - exact).max()
    assert one >= 10 * three, (one, three)


def test_fragment_order_equals_plain(flagship):
    """B staged as the kernel stages it, A read in the accumulator's
    column order: the same forward, within the same gates; staged without
    the permutation, B no longer meets A's columns."""
    flat, x, lin = flagship
    weights, _, _, _ = _unpack(torch.from_numpy(flat))
    w_mid = [w.numpy() for w in weights[1:]]
    exact = _exact(flat, x)
    staged = emulated_forward(lin, flat, frag=stage_fragments(w_mid))
    np.testing.assert_array_equal(staged, emulated_forward(lin, flat))
    assert np.abs(staged - exact).max() <= 2e-6
    plain = reflectance_cnn_plain(x, torch.from_numpy(flat),
                                  srgb_input=True).reshape(-1).numpy()
    assert np.abs(np.floor(staged * 255.0)
                  - np.floor(plain * 255.0)).max() <= 1
    wrong = emulated_forward(lin, flat, frag=stage_fragments(
        w_mid, perm=np.arange(8)))
    assert np.abs(wrong - exact).max() > 1e-2
