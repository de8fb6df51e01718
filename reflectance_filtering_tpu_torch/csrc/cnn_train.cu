// K7 — fused skip-layer trunk for training: forward and backward.
//
// Replaces reflectance_filtering_tpu/ops/cnn_train_pallas.py::_fwd_kernel and
// ::_bwd_kernel (reached via skip_trunk_pre / _make_trunk, dispatched from
// models/networks.py::_apply_skip_layers).
//
// What it computes, per pixel p of x [P, ci] (channels last):
//   h_0 = relu(x W_0 + b_0), h_i = relu(h_{i-1} W_i + b_i)  (i < n, width f)
//   pre = [h_0 .. h_{n-1}] W_f + b_f                         [P, cout]
// and, given the cotangent g = dL/dpre [P, cout], every parameter gradient
// summed over all pixels plus (optionally) dx = dL/dx [P, ci].  Weights are
// dynamic (they change every training step), so they are read from a device
// buffer on every launch: one flat f32 vector in the order
//   W_0 [ci][f], b_0 [f], W_1 [f][f], b_1 [f], ..., W_f [n*f][cout], b_f [cout]
// (each W stored [in][out], the JAX kernels' [0, 0] slice); the gradient has
// the same layout (ops/cnn_train_kernel.py packs and unpacks it).
//
// What bounds it on an H100: arithmetic.  The flagship (n=5, ci=3, f=32,
// cout=1) costs 4,352 MACs per pixel forward and about 13 k backward
// (rematerialisation 4,352, the chain 4,256, the weight gradients 4,352)
// against 12-16 bytes of device memory per pixel, far on the compute side.
//
// The forward, by shape (fwd_on_tensor_cores; the skip fuse accumulated
// layer by layer in both, so no [P, n*f] concat exists anywhere):
//   * f <= 64 and (n - 1) f^2 <= 16,384 (the flagship and the train CLI's
//     default trunk): trunk_fwd_mma_kernel, K1's register-resident
//     3xTF32 scheme with K7's dynamic n, ci and cout (below): the flagship
//     at 20 x 256x256 in 0.23 ms on an H100, 29% of the 3xTF32 bound's
//     rate, where the first port, the FP32 kernel, took 0.92 ms (7.2%);
//   * wider or deeper trunks: trunk_fwd_kernel on the FP32 pipe, a block a
//     tile of 64 pixels whose activations live in shared memory as
//     [channel][68]; each layer a small f32 FMA product, a work item (8
//     output channels, 1 pixel) per thread, weight reads uniform across a
//     warp.
//
// The backward (trunk_bwd_kernel) runs its three matrix products on the
// tensor cores as 3xTF32, as K1 (cnn_fwd.cu) does: mma.sync.m16n8k8, f32 +=
// tf32 x tf32, each f32 operand split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) by K1's integer-op rounding, hi.hi + hi.lo + lo.hi into
// a zeroed accumulator per k block, added to the running sum in f32 (the
// tensor cores truncate as they accumulate).  That keeps about f32's
// accuracy; one TF32 product does not (tests/test_torch_cnn_train_tf32.py
// emulates both).
//   * A block of 16 warps walks tiles of 128 pixels (a persistent grid, one
//     block an SM).  It rematerialises the tile's activations (storing five
//     [P, 32] maps would be 839 MB at batch 20 x 256x256) layer by layer:
//     pixels are M, K the fan-in (ci padded to 8 by zero rows), N = f; an
//     item is an m tile of 16 pixels by a pair of n tiles, one a warp.
//     Each layer's output goes to its act slot, which the chain and the
//     weight gradients read.
//   * The masks [h_l > 0] must agree with the plain trunk's float32 ones:
//     at 20 x 256x256 a single mask that differs moves a gradient leaf by
//     1e-3 of its max.  So one more TF32 product, of |A| and |B|, bounds
//     each output's rounding error, and an output within (fan-in + 32)
//     2^-23 of that bound (about 1e-5 of them) is recomputed by its warp in
//     float32 FMAs in the forward kernel's order from x (exact_pre), which
//     gives the plain trunk's float32 value.
//   * The chain dz_l = (W_f,l g + W_{l+1} dz_{l+1}) * [h_l > 0]: pixels are M,
//     A = dz_{l+1}, B = W_{l+1}^T; the cout-wide fuse term W_f,l g is added
//     on the FP32 pipe in the epilogue.  dz alternates between two slots,
//     so the weight gradients of layer l and the chain's next step share
//     one phase.
//   * The weight gradients dW_l = a_{l-1}^T dz_l, computed as dW_l^T in
//     tiles of 16 of f (dz_l's rows) by 8 of the fan-in (a_{l-1}'s rows),
//     K = pixels, both operands read straight from the [channel][pixel]
//     arrays.  On the fast path (Plan::fast: n <= 6 and 2 x tiles <= 16 a
//     layer, the flagship's f = 32 and the narrower trunks) warp v owns
//     tile v / 2 over half v % 2 of every tile's pixels, its sums in
//     registers across all of the block's tiles, added to the block's row
//     at the end, first halves first; on the other shapes each tile is
//     summed per tile and added to the row.
//   * B operands that are weights are split once per launch in mma's
//     B-fragment order, one float4 {hi0, hi1, lo0, lo1} per lane (W_l for
//     the rematerialisation, W_l^T for the chain); activations, dz, x and g
//     are split as they are read.
//   * Tile arrays are [channel][136] (stride = 8 mod 32 banks), pixel p of
//     row r at r * 136 + (p ^ (r & 4)): pixel-M A fragments (rows t, t + 4,
//     pixels g) and the weight gradients' fragments (rows g, pixels t, t +
//     4) both fall on 32 distinct banks.
//   * The fuse head's dW_fuse and the bias sums (cout-wide products) stay
//     on the FP32 pipe, in shared memory beside the row, and so does dx.
//   * The sum over all pixels is the one part the TPU's sequential grid did
//     for free.  Here blocks run in no order, so there is no float atomic
//     anywhere: a persistent grid of a fixed number of blocks walks the tiles
//     in a fixed order, each block accumulates its tiles into its own row of
//     a [blocks, params] buffer, and a second kernel sums the rows in block
//     order.  The gradient is bitwise the same from run to run, which the
//     resume-equals-uninterrupted contract needs.
//   * The fast path keeps the tiles, dz, the activations and the fragments
//     in shared memory (204 KB for the flagship, and its 18 KB row beside
//     them), through pointers the compiler sees are shared; the other shapes keep dz and then the
//     activations there while they fit 227 KB, else in a per-block slice of
//     the workspace, and the fragments in the workspace (stage_frags_kernel
//     before the launch), through generic pointers.  The row is in shared
//     memory where it fits.
// Any configuration that fits_fused_trunk admits launches: n >= 1, ci <=
// 8, f a multiple of 8 in 8..256, cout <= 8.
//
// The backward is a template over a mask of its phases.  The product runs
// every phase; rf_cnn_train_bwd_variant runs the timing variants of
// scripts/measure_train_bwd_split.py::_bwd_variant (TPU kernel 19), each
// with phases removed in dependency order, at the product's block count and
// shared-memory layout, so that the differences of their times split the
// product's time by phase.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // the forward's and the small kernels'
constexpr int kTile = 64;             // pixels per tile of the forward
constexpr int kStride = kTile + 4;    // row stride of a forward tile array, floats
constexpr int kBThreads = 512;        // the backward: one block of 16 warps an SM
constexpr int kBWarps = kBThreads / 32;
constexpr int kBTile = 128;           // pixels per tile of the backward
constexpr int kBStride = kBTile + 8;  // row stride of a backward tile array
constexpr int kIn = 8;                // x and g tile rows (ci, cout <= 8)
constexpr int kRegLayers = 6;         // the fast path's most layers (dW in registers)
constexpr int kBudget = 227 * 1024;   // shared memory of one backward block

// Phases of the backward, bits of its template mask.  Without kRemat a tile
// is loaded and only its first x and g values are summed into db_fuse (the
// floor: the per-tile loop, the loads and the block sum); with it the tile
// is rematerialised and db_l, db_fuse and the masked chain dz_l are formed.
constexpr int kRemat = 1;
constexpr int kHead = 2;         // dW_fuse = sum_p h_l g
constexpr int kChain = 4;        // the chain's W_{l+1} dz_{l+1} term
constexpr int kWeightGrad = 8;   // dW_l = sum_p a_{l-1} dz_l
constexpr int kAllPhases = kRemat | kHead | kChain | kWeightGrad;

struct Shape {
  int n, ci, f, cout;
  int ci4;        // ci rounded up to 4 (zero rows)
  int64_t p;      // pixels
  int64_t tiles;  // the forward's tiles of kTile pixels
  int64_t btiles; // the backward's tiles of kBTile pixels
};

__host__ __device__ inline int64_t off_w(const Shape& s, int l) {
  // offset of W_l in the flat parameter vector (l == n: the fuse)
  if (l == 0) return 0;
  const int64_t first = static_cast<int64_t>(s.ci) * s.f + s.f;
  return first + static_cast<int64_t>(l - 1) * (static_cast<int64_t>(s.f) * s.f + s.f);
}

__host__ __device__ inline int fan_in(const Shape& s, int l) {
  return l == 0 ? s.ci : s.f;
}

__host__ __device__ inline int64_t num_params(const Shape& s) {
  return off_w(s, s.n) + static_cast<int64_t>(s.n) * s.f * s.cout + s.cout;
}

// row stride of the partial-gradient buffer: a multiple of 4 floats, so
// the slices that follow the rows stay 16-byte aligned
__host__ __device__ inline int64_t row_stride(const Shape& s) {
  return (num_params(s) + 3) / 4 * 4;
}

// The backward's B operands that are weights, split into hi and lo once
// per launch in mma's B-fragment order: W_0 ([kIn][f], one k block, rows
// past ci zero), W_l for l = 1..n-1 ([f/8 k blocks][f/8 n tiles] each),
// then W_l^T for l = 1..n-1; every (k block, n tile) is 32 lanes' float4s
// {hi(b0), hi(b1), lo(b0), lo(b1)}.
struct Frags {
  int nt;                            // f / 8
  int64_t fwd0, fwd, bwd, total;     // offsets and total, float4s
};

__host__ __device__ inline Frags frags(const Shape& s) {
  Frags q;
  q.nt = s.f / 8;
  const int64_t sq = static_cast<int64_t>(q.nt) * q.nt * 32;
  q.fwd0 = 0;
  q.fwd = q.nt * 32;
  q.bwd = q.fwd + (s.n - 1) * sq;
  q.total = q.bwd + (s.n - 1) * sq;
  return q;
}

__host__ __device__ inline int64_t align4(int64_t floats) { return (floats + 3) / 4 * 4; }

// The sums the block keeps in shared memory beside its row (floats): db_l
// at l f + o, then W_f's and b_f's gradients in the flat vector's order.
__host__ __device__ inline int64_t small_floats(const Shape& s) {
  return static_cast<int64_t>(s.n) * s.f * (1 + s.cout) + s.cout;
}

// Shared floats of every backward block: the x and g tiles, the small sums,
// W_f and each warp's exact_pre scratch (2 f floats).
__host__ __device__ inline int64_t core_floats(const Shape& s) {
  return 2LL * kIn * kBStride + align4(small_floats(s)) +
         align4(static_cast<int64_t>(s.n) * s.f * s.cout) + 2LL * kBWarps * s.f;
}

// Where the backward keeps things (in floats).  The fast path holds dz, the
// tile's activations and the fragments in shared memory and the dW units
// in registers; the other shapes keep dz and act in shared memory while
// they fit (in that order), else in a per-block workspace slice, and the
// fragments in the workspace.  The row is in shared memory if it fits.
struct Plan {
  int blocks;
  int64_t dz_floats;    // 2 * f * kBStride
  int64_t act_floats;   // n * f * kBStride
  bool fast, dz_shared, act_shared, acc_shared;
  int smem_bytes;
  int64_t slice_floats; // per block: dz and act where not shared
  int64_t frag_offset;  // the fragments in the workspace (not fast)
  int64_t work_floats;  // workspace: partial rows, slices, fragments
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Load a tile of x [P, ci] into xs [ci4][kStride] (zero rows above ci and
// zero columns past P), and g likewise when given.
__device__ void load_tile(const Shape& s, int64_t p0, const float* __restrict__ src,
                          int c, int rows, float* dst) {
  for (int i = threadIdx.x; i < rows * kTile; i += blockDim.x) {
    const int ch = i / kTile, p = i % kTile;
    const int64_t pix = p0 + p;
    dst[ch * kStride + p] = (ch < c && pix < s.p) ? src[pix * c + ch] : 0.0f;
  }
}

// One layer over the tile: out[o][p] = relu(sum_i in[i][p] W[i][o] + b[o]).
__device__ void layer_fwd(const Shape& s, const float* __restrict__ w, int l,
                          const float* in, float* out) {
  const int fin = fan_in(s, l);
  const float* W = w + off_w(s, l);
  const float* b = W + static_cast<int64_t>(fin) * s.f;
  const int groups = s.f / 8;
  for (int it = threadIdx.x; it < groups * kTile; it += blockDim.x) {
    const int og = it / kTile, p = it % kTile;
    float acc[8];
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + og * 8));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + og * 8 + 4));
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    for (int i = 0; i < fin; ++i) {
      const float a = in[i * kStride + p];
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(W + i * s.f + og * 8));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(W + i * s.f + og * 8 + 4));
      acc[0] = fmaf(a, w0.x, acc[0]);
      acc[1] = fmaf(a, w0.y, acc[1]);
      acc[2] = fmaf(a, w0.z, acc[2]);
      acc[3] = fmaf(a, w0.w, acc[3]);
      acc[4] = fmaf(a, w1.x, acc[4]);
      acc[5] = fmaf(a, w1.y, acc[5]);
      acc[6] = fmaf(a, w1.z, acc[6]);
      acc[7] = fmaf(a, w1.w, acc[7]);
    }
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      out[(og * 8 + k) * kStride + p] = fmaxf(acc[k] + bb[k], 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
trunk_fwd_kernel(Shape s, const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ pre) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);           // [ci4][kStride]
  float* act = xs + s.ci4 * kStride;                     // 2 slots [f][kStride]
  float* fuse = act + 2 * s.f * kStride;                 // [cout][kStride]
  const int64_t slot = static_cast<int64_t>(s.f) * kStride;
  const float* wf = w + off_w(s, s.n);
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;

  load_tile(s, p0, x, s.ci, s.ci4, xs);
  for (int i = threadIdx.x; i < s.cout * kTile; i += blockDim.x)
    fuse[(i / kTile) * kStride + i % kTile] = 0.0f;
  __syncthreads();
  const float* in = xs;
  for (int l = 0; l < s.n; ++l) {
    float* out = act + (l & 1) * slot;
    layer_fwd(s, w, l, in, out);
    __syncthreads();
    // skip fuse, layer by layer: fuse[c][p] += sum_ch h_l[ch][p] Wf[l*f+ch][c]
    for (int it = threadIdx.x; it < s.cout * kTile; it += blockDim.x) {
      const int c = it / kTile, p = it % kTile;
      float acc = fuse[c * kStride + p];
      const float* wl = wf + static_cast<int64_t>(l) * s.f * s.cout + c;
      for (int ch = 0; ch < s.f; ++ch)
        acc = fmaf(out[ch * kStride + p], __ldg(wl + ch * s.cout), acc);
      fuse[c * kStride + p] = acc;
    }
    __syncthreads();
    in = out;
  }
  const float* bf = wf + static_cast<int64_t>(s.n) * s.f * s.cout;
  for (int it = threadIdx.x; it < s.cout * kTile; it += blockDim.x) {
    const int c = it % s.cout, p = it / s.cout;   // coalesced [P, cout] store
    const int64_t pix = p0 + p;
    if (pix < s.p) pre[pix * s.cout + c] = fuse[c * kStride + p] + __ldg(bf + c);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// K1's split (cnn_fwd.cu): hi = cvt.rna.tf32.f32 (x) written as integer
// ops, lo = the same rounding of x - hi.
__host__ __device__ __forceinline__ uint32_t tf32_bits(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(x));
  lo = tf32_bits(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a (16 x 8, row) . b (8 x 8, col), f32 accumulate.  Not volatile:
// the instruction has no side effect, so the compiler may interleave
// independent products and loads.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out += one k block's product as 3xTF32: the three products into a zeroed
// accumulator, the small terms first, then added to out in f32 (round to
// nearest).  The tensor cores truncate as they accumulate, so a running
// sum kept in the accumulator would drift over many k blocks; a fresh one
// per k block also leaves the k blocks' products independent.
__device__ __forceinline__ void mma3(float* out, const uint32_t* ah, const uint32_t* al,
                                     const float4& b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(d, al, bh0, bh1);
  mma(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma(d, ah, bh0, bh1);
#pragma unroll
  for (int r = 0; r < 4; ++r) out[r] += d[r];
}

// ---------------------------------------------------------------------------
// forward on the tensor cores
// ---------------------------------------------------------------------------

// The forward runs on the tensor cores (trunk_fwd_mma_kernel) when a
// warp's activations fit its registers and the mid layers' split weights
// fit shared memory: f <= 64 (8 n tiles) and (n - 1) f^2 <= 16,384 (hi/lo
// fragments <= 128 KB).  That takes the flagship (n = 5, f = 32), the
// train CLI's default trunk and every narrower or shallower one; the rest
// (f = 72 .. 256, or deeper trunks) run trunk_fwd_kernel on the FP32 pipe.
// A rule of the shape alone (ops/cnn_train_kernel.py mirrors it).
constexpr int kMmaMaxTiles = 8;
constexpr int64_t kMmaMaxMidSquares = 16384;
constexpr int kFwdWarps = kThreads / 32;

__host__ __device__ inline bool fwd_on_tensor_cores(const Shape& s) {
  return s.f <= 8 * kMmaMaxTiles &&
         static_cast<int64_t>(s.n - 1) * s.f * s.f <= kMmaMaxMidSquares;
}

// Shared floats of trunk_fwd_mma_kernel: the mid layers' B fragments (2 f^2
// floats a layer), W_0 [ci][f], the biases [n][f], W_f [n f][cout], b_f.
__host__ __device__ inline int64_t fwd_mma_floats(const Shape& s) {
  const int64_t nf = static_cast<int64_t>(s.n) * s.f;
  return 2LL * (s.n - 1) * s.f * s.f + align4(static_cast<int64_t>(s.ci) * s.f) + align4(nf) +
         align4(nf * s.cout) + align4(s.cout);
}

// fz[m][half][c] += the fuse's terms of one layer from the lane's h (the
// accumulator layout), wl = that layer's rows of W_f [f][cout]
template <int NT, int MT, int CO>
__device__ __forceinline__ void fuse_layer(const float (&h)[MT][NT][4], float (&fz)[MT][2][CO],
                                           const float* wl, int cout, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* wo = wl + (8 * nt + 2 * t + (r & 1)) * cout;
#pragma unroll
        for (int c = 0; c < CO; ++c)
          if (c < cout) fz[m][r >> 1][c] = fmaf(h[m][nt][r], wo[c], fz[m][r >> 1][c]);
      }
}

// The forward as K1 (cnn_fwd.cu) computes its network, with K7's dynamic
// n, ci and cout: NT = f / 8 n tiles, MT m tiles of 16 pixels a warp step
// (two while NT <= 4, so that h and the accumulator stay within 128
// registers), CO = 1 for one output channel, else 8 with the channels past
// cout skipped.  Each block splits the mid layers' weights into hi/lo once
// per launch into shared memory in mma's B-fragment order, the rows of a k
// block permuted (2t, 2t + 1 for the A columns t, t + 4) so that a layer's
// accumulator is the next layer's A fragment without a shuffle; the grid
// is persistent.  A warp step: lane L loads pixel L's ci inputs
// (channels last, the ragged end read as zeros), shuffles give each lane
// its rows' inputs, layer 0 runs as float32 FMAs straight into the
// accumulator layout (from zero over the inputs, then the bias, as
// trunk_fwd_kernel); layers 1..n-1 as 3xTF32 (mma3: a zeroed accumulator a
// k block, added to the bias-started sum in float32).  The skip fuse is
// summed from the registers layer by layer: each lane its partial dot over
// its columns for each c < cout, a shuffle over the 4 lanes of a row group
// at the end, and lane t stores the channels c = t (mod 4) of its rows.
// No ReLU mask is made exact here: the forward's output is continuous in
// each pre-activation, so a mask flipped within 3xTF32's error of zero
// moves pre by about that error (the backward rematerialises its own exact
// masks from x).  No atomics: bitwise repeatable.
template <int NT, int MT, int CO>
__global__ void __launch_bounds__(kThreads, 2)
trunk_fwd_mma_kernel(Shape s, const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ pre) {
  constexpr int F = 8 * NT;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float4* frag = smem4;  // [(n - 1)][kb * NT + nt][lane]
  float* w0 = reinterpret_cast<float*>(frag + static_cast<int64_t>(s.n - 1) * NT * NT * 32);
  float* bias = w0 + align4(s.ci * F);         // [n][F]
  float* wf = bias + align4(s.n * F);          // [n F][cout]
  float* bfs = wf + align4(s.n * F * s.cout);  // [cout]
  const int cout = CO == 1 ? 1 : s.cout;

  const int64_t nfrag = static_cast<int64_t>(s.n - 1) * NT * NT * 32;
  for (int64_t e = threadIdx.x; e < nfrag; e += kThreads) {
    const int lane = static_cast<int>(e & 31), g = lane >> 2, t = lane & 3;
    const int blk = static_cast<int>((e >> 5) % (NT * NT));
    const int l = 1 + static_cast<int>((e >> 5) / (NT * NT));
    const float* W = w + off_w(s, l);
    const int i = 8 * (blk / NT) + 2 * t, o = 8 * (blk % NT) + g;
    uint32_t h0, l0, h1, l1;
    split(W[i * F + o], h0, l0);
    split(W[(i + 1) * F + o], h1, l1);
    frag[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                          __uint_as_float(l1));
  }
  for (int e = threadIdx.x; e < s.ci * F; e += kThreads) w0[e] = w[e];
  for (int e = threadIdx.x; e < s.n * F; e += kThreads) {
    const int l = e / F;
    bias[e] = w[off_w(s, l) + static_cast<int64_t>(fan_in(s, l)) * F + e % F];
  }
  const int64_t offf = off_w(s, s.n);
  for (int e = threadIdx.x; e < s.n * F * cout; e += kThreads) wf[e] = w[offf + e];
  if (threadIdx.x < cout) bfs[threadIdx.x] = w[offf + s.n * F * cout + threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kPix = 16 * MT;  // pixels a warp step
  const int64_t steps = (s.p + kPix - 1) / kPix;
  for (int64_t step = static_cast<int64_t>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
       step < steps; step += static_cast<int64_t>(gridDim.x) * kFwdWarps) {
    const int64_t p0 = step * kPix;
    // lane L (< kPix) loads pixel p0 + L's inputs
    float in[kIn];
#pragma unroll
    for (int c = 0; c < kIn; ++c)
      in[c] = (c < s.ci && lane < kPix && p0 + lane < s.p) ? x[(p0 + lane) * s.ci + c] : 0.0f;

    // h[m][nt][r]: pixel 16m + g (r < 2) or 16m + g + 8 (r >= 2), channel
    // 8nt + 2t + (r & 1): the m16n8 accumulator layout; fz[m][half][c]: the
    // fuse's partial dot of row g + 8 half of tile m for output c
    float h[MT][NT][4];
    float fz[MT][2][CO];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < CO; ++c) fz[m][half][c] = 0.0f;

    // layer 0 on the FP32 pipe, straight into the accumulator layout
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float xr[2][kIn];
#pragma unroll
      for (int c = 0; c < kIn; ++c) {
        if (c < s.ci) {
          xr[0][c] = __shfl_sync(kFull, in[c], 16 * m + g);
          xr[1][c] = __shfl_sync(kFull, in[c], 16 * m + g + 8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = 8 * nt + 2 * t + (r & 1);
          float a = 0.0f;
#pragma unroll
          for (int c = 0; c < kIn; ++c)
            if (c < s.ci) a = fmaf(xr[r >> 1][c], w0[c * F + o], a);
          h[m][nt][r] = fmaxf(a + bias[o], 0.0f);
        }
    }
    fuse_layer<NT, MT, CO>(h, fz, wf, cout, t);

    // layers 1..n-1 as 3xTF32 on the tensor cores
    for (int l = 1; l < s.n; ++l) {
      const float4* fl = frag + static_cast<int64_t>(l - 1) * NT * NT * 32 + lane;
      float acc[MT][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = bias[l * F + 8 * nt + 2 * t];
        const float b1 = bias[l * F + 8 * nt + 2 * t + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][nt][0] = b0;
          acc[m][nt][1] = b1;
          acc[m][nt][2] = b0;
          acc[m][nt][3] = b1;
        }
      }
#pragma unroll
      for (int kb = 0; kb < NT; ++kb) {
        // A fragment of k block kb from n tile kb of h: a0 (g, t) = c0,
        // a1 (g + 8, t) = c2, a2 (g, t + 4) = c1, a3 (g + 8, t + 4) = c3
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          split(h[m][kb][0], ah[m][0], al[m][0]);
          split(h[m][kb][2], ah[m][1], al[m][1]);
          split(h[m][kb][1], ah[m][2], al[m][2]);
          split(h[m][kb][3], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 b = fl[(kb * NT + nt) * 32];
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3(acc[m][nt], ah[m], al[m], b);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) h[m][nt][r] = fmaxf(acc[m][nt][r], 0.0f);
      fuse_layer<NT, MT, CO>(h, fz, wf + l * F * cout, cout, t);
    }

    // the fuse's dot over a row group's 4 lanes; lane t stores outputs
    // c = t (mod 4) of rows g and g + 8 of each tile
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int c = 0; c < CO; ++c) {
          if (c < cout) {
            float v = fz[m][half][c];
            v += __shfl_xor_sync(kFull, v, 1);
            v += __shfl_xor_sync(kFull, v, 2);
            fz[m][half][c] = v;
          }
        }
        const int64_t pix = p0 + 16 * m + g + 8 * half;
        if (pix < s.p) {
#pragma unroll
          for (int c = 0; c < CO; ++c)
            if (c < cout && (c & 3) == t) pre[pix * cout + c] = fz[m][half][c] + bfs[c];
        }
      }
  }
}

// Element (row r, pixel p) of a backward tile array.
__device__ __forceinline__ int at(int r, int p) { return r * kBStride + (p ^ (r & 4)); }

// Load a tile of v [P, c] into dst [kIn][kBStride] (zero rows at and above
// c, zero columns past P).
__device__ __forceinline__ void load_btile(const Shape& s, int64_t p0,
                                           const float* __restrict__ v, int c, float* dst) {
  for (int i = threadIdx.x; i < kIn * kBTile; i += kBThreads) {
    const int ch = i / kBTile, p = i % kBTile;
    const int64_t pix = p0 + p;
    dst[at(ch, p)] = (ch < c && pix < s.p) ? v[pix * c + ch] : 0.0f;
  }
}

// Entry e of the B fragments (Frags): lane e % 32's {hi(b0), hi(b1),
// lo(b0), lo(b1)} of its (k block, n tile), b0 = B[8 kb + t][8 nt + g], b1 =
// B[8 kb + t + 4][8 nt + g]; B = W_0 (rows past ci zero), W_l or W_l^T.
__device__ __forceinline__ float4 frag_entry(const Shape& s, const Frags& q,
                                             const float* __restrict__ w, int64_t e) {
  const int lane = static_cast<int>(e & 31), g = lane >> 2, t = lane & 3;
  const int64_t blk = e >> 5;
  const int64_t sq = static_cast<int64_t>(q.nt) * q.nt;
  float v[2];
  if (e < q.fwd) {  // W_0 [ci][f]
    const int o = 8 * static_cast<int>(blk) + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = t + 4 * h;
      v[h] = i < s.ci ? w[static_cast<int64_t>(i) * s.f + o] : 0.0f;
    }
  } else {  // W_l (e < q.bwd) or W_l^T, l = 1..n-1
    const bool trans = e >= q.bwd;
    const int64_t b = blk - ((trans ? q.bwd : q.fwd) >> 5);
    const int l = 1 + static_cast<int>(b / sq);
    const int kb = static_cast<int>((b % sq) / q.nt), nt = static_cast<int>(b % q.nt);
    const float* W = w + off_w(s, l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * kb + t + 4 * h, n = 8 * nt + g;
      v[h] = trans ? W[static_cast<int64_t>(n) * s.f + k] : W[static_cast<int64_t>(k) * s.f + n];
    }
  }
  uint32_t h0, l0, h1, l1;
  split(v[0], h0, l0);
  split(v[1], h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                     __uint_as_float(l1));
}

// The B fragments into the workspace, for shapes that do not take the
// fast path (which stages them in shared memory itself).
__global__ void __launch_bounds__(kThreads)
stage_frags_kernel(Shape s, const float* __restrict__ w, float4* __restrict__ frag) {
  const Frags q = frags(s);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < q.total) frag[e] = frag_entry(s, q, w, e);
}

// out[j][r] += sum over k blocks kb < nkb of A(kb) B(kb, nt0 + j), j < nj
// (<= 2), with pixels as M: A[m][k] = a[8 kb + k][m0 + m] (a [K][kBStride]),
// B the fragments bf[(kb * nt + n tile) * 32 + lane].  With bnd, also
// bnd[j][r] += the same product of |A| and |B| (their hi parts, one TF32
// product): the sum of the terms' magnitudes, which bounds the rounding
// error.
__device__ __forceinline__ void pm_product(const float* a, int nkb, int m0,
                                           const float4* bf, int nt, int nt0, int nj,
                                           float (*out)[4], float (*bnd)[4] = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr uint32_t kAbs = 0x7fffffffu;
  // k block kb's rows t and t + 4 are k block 0's moved by 8 kb rows (the
  // swizzle depends on the row's bit 2 only)
  const float* a0 = a + at(t, m0 + g);
  const float* a1 = a + at(t, m0 + g + 8);
  const float* a2 = a + at(t + 4, m0 + g);
  const float* a3 = a + at(t + 4, m0 + g + 8);
  const float4* b0 = bf + nt0 * 32 + lane;
#pragma unroll 4
  for (int kb = 0; kb < nkb; ++kb) {
    const int ka = kb * 8 * kBStride;
    uint32_t ah[4], al[4];
    split(a0[ka], ah[0], al[0]);
    split(a1[ka], ah[1], al[1]);
    split(a2[ka], ah[2], al[2]);
    split(a3[ka], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nj) break;
      const float4 b = b0[(kb * nt + j) * 32];
      mma3(out[j], ah, al, b);
      if (bnd != nullptr) {
        const uint32_t aa[4] = {ah[0] & kAbs, ah[1] & kAbs, ah[2] & kAbs, ah[3] & kAbs};
        mma(bnd[j], aa, __float_as_uint(b.x) & kAbs, __float_as_uint(b.y) & kAbs);
      }
    }
  }
}

// Layer l's pre-activation of output o at pixel p in float32 FMAs in the
// forward kernel's order (layer_fwd: the products summed over i ascending
// from zero, then the bias), every earlier layer of the pixel recomputed
// the same way from x: the float32 value the plain trunk's small products
// give.  The whole warp computes it (each lane some outputs of each
// earlier layer, through its scratch of 2 f floats); every lane returns it.
__device__ __noinline__ float exact_pre(const Shape& s, const float* __restrict__ w,
                                        const float* xs, float* scr, int p, int l, int o) {
  const int lane = threadIdx.x & 31;
  float* cur = scr;
  float* nxt = scr + s.f;
  for (int k = 0; k <= l; ++k) {
    const int fin = fan_in(s, k);
    const float* W = w + off_w(s, k);
    const float* b = W + static_cast<int64_t>(fin) * s.f;
    for (int oo = k == l ? o : lane; oo < (k == l ? o + 1 : s.f); oo += 32) {
      float t = 0.0f;
      for (int i = 0; i < fin; ++i)
        t = fmaf(k == 0 ? xs[at(i, p)] : cur[i], __ldg(W + static_cast<int64_t>(i) * s.f + oo),
                 t);
      t += __ldg(b + oo);
      if (k == l) return t;
      nxt[oo] = fmaxf(t, 0.0f);
    }
    __syncwarp();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return 0.0f;
}

// One layer of the rematerialisation: out[o][p] = relu(sum_i in[i][p]
// W_l[i][o] + b_l[o]), in with fin8 rows (fan-in padded to a multiple of 8
// by zero rows).  Work items (m tile of 16 pixels, pair of n tiles) by warp.
// The chain's masks [h_l > 0] are decided here and must agree with the
// plain trunk's float32 ones, so a pre-activation within (fan-in + 32)
// 2^-23 of the sum of its terms' magnitudes (wider than the error of
// 3xTF32 and of float32 in any order, fan-in x 2^-24) is recomputed by
// exact_pre (scr: the warp's scratch); elsewhere its sign is the exact one,
// and so the float32 one.
__device__ __forceinline__ void remat_layer(const Shape& s, const float* __restrict__ w,
                                            const float4* bf, int l, int fin8,
                                            const float* xs, const float* in, float* out,
                                            float* scr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = s.f / 8, pairs = (nt + 1) / 2;
  const float* b = w + off_w(s, l) + static_cast<int64_t>(fan_in(s, l)) * s.f;
  const float tau = static_cast<float>(fin8 + 32) * 0x1p-23f;
  for (int it = threadIdx.x >> 5; it < (kBTile / 16) * pairs; it += kBWarps) {
    const int m0 = 16 * (it % (kBTile / 16)), nt0 = 2 * (it / (kBTile / 16));
    const int nj = min(2, nt - nt0);
    float acc[2][4], bnd[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = 8 * (nt0 + j) + 2 * t;
      const float b0 = j < nj ? __ldg(b + o) : 0.0f;
      const float b1 = j < nj ? __ldg(b + o + 1) : 0.0f;
      acc[j][0] = acc[j][2] = b0;
      acc[j][1] = acc[j][3] = b1;
      bnd[j][0] = bnd[j][2] = fabsf(b0);
      bnd[j][1] = bnd[j][3] = fabsf(b1);
    }
    pm_product(in, fin8 / 8, m0, bf, nt, nt0, nj, acc, bnd);
    unsigned flags = 0;  // bit 4 j + r: that output needs exact_pre
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = 8 * (nt0 + j) + 2 * t + (r & 1), p = m0 + g + 8 * (r >> 1);
        out[at(o, p)] = fmaxf(acc[j][r], 0.0f);
        if (fabsf(acc[j][r]) <= tau * bnd[j][r]) flags |= 1u << (4 * j + r);
      }
    }
    // the warp recomputes its lanes' flagged outputs one by one
    for (unsigned lanes = __ballot_sync(0xffffffffu, flags != 0); lanes != 0;
         lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (unsigned m = __shfl_sync(0xffffffffu, flags, src); m != 0; m &= m - 1) {
        const int bit = __ffs(m) - 1, j = bit >> 2, r = bit & 3;
        const int o = 8 * (nt0 + j) + 2 * (src & 3) + (r & 1);
        const int p = m0 + (src >> 2) + 8 * (r >> 1);
        const float v = exact_pre(s, w, xs, scr, p, l, o);
        if (lane == src) out[at(o, p)] = fmaxf(v, 0.0f);
        __syncwarp();
      }
    }
  }
}

// One step of the chain: dz_l[o][p] = ((sum_j dz_{l+1}[j][p] W_{l+1}[o][j],
// when bt, the fragments of W_{l+1}^T, is given) + sum_c g[c][p]
// W_f,l[o][c]) * [h_l[o][p] > 0]; the cout-wide fuse term on the FP32 pipe
// (wf: W_f, staged in shared memory).
__device__ __forceinline__ void chain_step(const Shape& s, const float* wf, int l,
                                           const float* gs, const float* dnext,
                                           const float4* bt, const float* h, float* dz) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = s.f / 8, pairs = (nt + 1) / 2;
  for (int it = threadIdx.x >> 5; it < (kBTile / 16) * pairs; it += kBWarps) {
    const int m0 = 16 * (it % (kBTile / 16)), nt0 = 2 * (it / (kBTile / 16));
    const int nj = min(2, nt - nt0);
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    if (bt != nullptr) pm_product(dnext, nt, m0, bt, nt, nt0, nj, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = 8 * (nt0 + j) + 2 * t + (r & 1), p = m0 + g + 8 * (r >> 1);
        const float* wfo = wf + (l * s.f + o) * s.cout;
        float v = acc[j][r];
        for (int c = 0; c < s.cout; ++c) v = fmaf(gs[at(c, p)], wfo[c], v);
        const int e = at(o, p);
        dz[e] = h[e] > 0.0f ? v : 0.0f;
      }
    }
  }
}

// The weight gradients: layer l's dW_l^T [f][fin] in output tiles of 16 of
// its f rows (m tiles) by 8 of its fan-in columns (n tiles, fin8 in all),
// tile v at m tile v % dw_mtiles, n tile v / dw_mtiles.
__host__ __device__ __forceinline__ int dw_mtiles(const Shape& s) { return (s.f + 15) / 16; }
__host__ __device__ __forceinline__ int dw_tiles(const Shape& s, int l) {
  return dw_mtiles(s) * (l == 0 ? 1 : s.f / 8);
}

// Tile v's sums over k blocks kb0 .. kb0 + nkb - 1 of the tile's pixels:
// c[r] += sum_p dz[o][p] a[i][p], o = 16 mt + g (+ 8 for r >= 2), i = 8 nt +
// 2t + (r & 1); rows o >= f read as zero.
__device__ __forceinline__ void dw_tile(const Shape& s, int v, int kb0, int nkb,
                                        const float* a, const float* dz, float* c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = dw_mtiles(s);
  const int o0 = 16 * (v % mt), i = 8 * (v / mt) + g;
  const bool lo_rows = o0 + g < s.f, hi_rows = o0 + g + 8 < s.f;
  // pixel 8 kb + t of a row is pixel t's moved by 8 kb (the swizzle flips
  // bit 2 only); rows past f are pointed at row 0 and read as zero
  const float* d0 = dz + at(lo_rows ? o0 + g : 0, t);
  const float* d1 = dz + at(hi_rows ? o0 + g + 8 : 0, t);
  const float* d2 = dz + at(lo_rows ? o0 + g : 0, t + 4);
  const float* d3 = dz + at(hi_rows ? o0 + g + 8 : 0, t + 4);
  const float* e0 = a + at(i, t);
  const float* e1 = a + at(i, t + 4);
#pragma unroll 4
  for (int kb = kb0; kb < kb0 + nkb; ++kb) {
    const int k = 8 * kb;
    uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
    split(lo_rows ? d0[k] : 0.0f, ah[0], al[0]);
    split(hi_rows ? d1[k] : 0.0f, ah[1], al[1]);
    split(lo_rows ? d2[k] : 0.0f, ah[2], al[2]);
    split(hi_rows ? d3[k] : 0.0f, ah[3], al[3]);
    split(e0[k], bh0, bl0);
    split(e1[k], bh1, bl1);
    mma3(c, ah, al,
         make_float4(__uint_as_float(bh0), __uint_as_float(bh1), __uint_as_float(bl0),
                     __uint_as_float(bl1)));
  }
}

// acc[dW_l[i][o]] += tile v's sums (i < fan-in, o < f only)
__device__ __forceinline__ void dw_flush(const Shape& s, int l, int v, const float* c,
                                         float* acc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = dw_mtiles(s);
  const int o0 = 16 * (v % mt), i0 = 8 * (v / mt) + 2 * t;
  const int fin = fan_in(s, l);
  const int64_t off = off_w(s, l);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int o = o0 + g + 8 * (r >> 1), i = i0 + (r & 1);
    if (o < s.f && i < fin) acc[off + static_cast<int64_t>(i) * s.f + o] += c[r];
  }
}

// out[r] += sum_p u[ru][p] v[rv][p] over the tile's pixels for r < items,
// one thread an item (float4 runs, a fixed order), the arrays u, v and
// their rows ru, rv given per item by uv (v null: 1).
template <typename UV>
__device__ __forceinline__ void tile_sums(int items, UV uv, float* out) {
  for (int r = threadIdx.x; r < items; r += kBThreads) {
    const float* u;
    const float* v;
    int ru, rv;
    uv(r, u, ru, v, rv);
    float t = 0.0f;
    for (int p = 0; p < kBTile; p += 4) {
      const float4 a = *reinterpret_cast<const float4*>(u + at(ru, p));
      if (v == nullptr) {
        t += (a.x + a.y) + (a.z + a.w);
      } else {
        const float4 b = *reinterpret_cast<const float4*>(v + at(rv, p));
        t = fmaf(a.x, b.x, t);
        t = fmaf(a.y, b.y, t);
        t = fmaf(a.z, b.z, t);
        t = fmaf(a.w, b.w, t);
      }
    }
    out[r] += t;
  }
}

// kFast (Plan::fast): every tile array, the fragments and the row's small
// sums in shared memory, reached through pointers the compiler sees are
// shared, and the dW tiles in registers (a warp a tile half, kRegLayers
// layers); else the generic pointers of the plan, the fragments in the
// workspace and dW added to the row per tile.
template <int kMask, bool kFast>
__global__ void __launch_bounds__(kBThreads, 1)
trunk_bwd_kernel(Shape s, Plan plan, const float* __restrict__ x,
                 const float* __restrict__ g, const float* __restrict__ w,
                 float* __restrict__ dx, float* __restrict__ work) {
  extern __shared__ float4 smem4[];
  const Frags q = frags(s);
  float* xs = reinterpret_cast<float*>(smem4);            // [kIn][kBStride]
  float* gs = xs + kIn * kBStride;                        // [kIn][kBStride]
  float* sacc = gs + kIn * kBStride;                      // small_floats(s)
  float* wfs = sacc + align4(small_floats(s));            // W_f, n f cout
  float* scr = wfs + align4(static_cast<int64_t>(s.n) * s.f * s.cout) +
               2 * (threadIdx.x >> 5) * s.f;              // this warp's scratch
  float* tail = wfs + align4(static_cast<int64_t>(s.n) * s.f * s.cout) + 2 * kBWarps * s.f;
  const int64_t np = num_params(s);
  float* partial = work + blockIdx.x * row_stride(s);     // this block's row
  float* slice = work + plan.blocks * row_stride(s) + blockIdx.x * plan.slice_floats;
  float* dzb;                                             // 2 slots [f][kBStride]
  float* act;                                             // n slots [f][kBStride]
  const float4* frag;
  if constexpr (kFast) {
    dzb = tail;
    act = dzb + plan.dz_floats;
    float4* fs = reinterpret_cast<float4*>(act + plan.act_floats);
    for (int64_t e = threadIdx.x; e < q.total; e += kBThreads) fs[e] = frag_entry(s, q, w, e);
    frag = fs;
    tail = reinterpret_cast<float*>(fs + q.total);
  } else {
    dzb = plan.dz_shared ? tail : slice;
    if (plan.dz_shared) tail += plan.dz_floats; else slice += plan.dz_floats;
    act = plan.act_shared ? tail : slice;
    if (plan.act_shared) tail += plan.act_floats;
    frag = reinterpret_cast<const float4*>(work + plan.frag_offset);
  }
  float* acc = plan.acc_shared ? tail : partial;
  const int64_t slot = static_cast<int64_t>(s.f) * kBStride;
  const int64_t offf = off_w(s, s.n);
  const int64_t nf = static_cast<int64_t>(s.n) * s.f;
  const int warp = threadIdx.x >> 5;

  // the fast path's dW: warp v holds, for each layer l, the sums of tile v
  // / 2 over half v % 2 of every tile's pixels (kRegLayers layers at most)
  float racc[kFast ? kRegLayers : 1][4];
#pragma unroll
  for (int j = 0; j < (kFast ? kRegLayers : 1); ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) racc[j][r] = 0.0f;

  for (int64_t j = threadIdx.x; j < np; j += kBThreads) acc[j] = 0.0f;
  for (int64_t j = threadIdx.x; j < small_floats(s); j += kBThreads) sacc[j] = 0.0f;
  for (int64_t j = threadIdx.x; j < nf * s.cout; j += kBThreads) wfs[j] = w[offf + j];
  for (int64_t tl = blockIdx.x; tl < s.btiles; tl += gridDim.x) {
    const int64_t p0 = tl * kBTile;
    __syncthreads();
    load_btile(s, p0, x, s.ci, xs);
    load_btile(s, p0, g, s.cout, gs);
    __syncthreads();
    if constexpr ((kMask & kRemat) == 0) {
      // the floor: touch the tile's first x and g, nothing else
      if (threadIdx.x < s.cout) sacc[nf * (1 + s.cout) + threadIdx.x] += xs[0] + gs[0];
      continue;
    }
    // the rematerialisation, layer by layer
    for (int l = 0; l < s.n; ++l) {
      remat_layer(s, w, frag + (l == 0 ? q.fwd0 : q.fwd + (l - 1) * int64_t(q.nt) * q.nt * 32),
                  l, l == 0 ? kIn : s.f, xs, l == 0 ? xs : act + (l - 1) * slot,
                  act + l * slot, scr);
      __syncthreads();
    }

    // fuse head: dbf[c] = sum_p g[c][p]; dWf[l*f+ch][c] = sum_p h_l[ch][p] g[c][p];
    // the chain's first step beside it
    tile_sums(s.cout, [&](int r, const float*& u, int& ru, const float*& v, int& rv) {
      u = gs, ru = r, v = nullptr, rv = 0;
    }, sacc + nf * (1 + s.cout));
    if constexpr ((kMask & kHead) != 0) {
      tile_sums(static_cast<int>(nf) * s.cout,
                [&](int r, const float*& u, int& ru, const float*& v, int& rv) {
                  const int row = r / s.cout;                  // row = l*f + ch
                  u = act + (row / s.f) * slot, ru = row % s.f, v = gs, rv = r % s.cout;
                }, sacc + nf);
    }
    chain_step(s, wfs, s.n - 1, gs, nullptr, nullptr, act + (s.n - 1) * slot,
               dzb + ((s.n - 1) & 1) * slot);
    __syncthreads();

    // last layer first: dW_l and db_l from dz_l (and a_{l-1}: x for l = 0),
    // and the chain's next step dz_{l-1} into the other slot
    for (int l = s.n - 1; l >= 0; --l) {
      const float* dz = dzb + (l & 1) * slot;
      const float* a = l == 0 ? xs : act + (l - 1) * slot;
      if constexpr ((kMask & kWeightGrad) != 0) {
        if constexpr (kFast) {
#pragma unroll
          for (int j = 0; j < kRegLayers; ++j)
            if (j == l && warp < 2 * dw_tiles(s, l))
              dw_tile(s, warp >> 1, (warp & 1) * (kBTile / 16), kBTile / 16, a, dz, racc[j]);
        } else {
          for (int v = warp; v < dw_tiles(s, l); v += kBWarps) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            dw_tile(s, v, 0, kBTile / 8, a, dz, c);
            dw_flush(s, l, v, c, acc);
          }
        }
      }
      tile_sums(s.f, [&](int r, const float*& u, int& ru, const float*& v, int& rv) {
        u = dz, ru = r, v = nullptr, rv = 0;
      }, sacc + l * s.f);
      if (l == 0 && dx != nullptr) {
        // dx[p][c] = sum_o W_0[c][o] dz_0[o][p]
        for (int it = threadIdx.x; it < s.ci * kBTile; it += kBThreads) {
          const int c = it / kBTile, p = it % kBTile;
          const float* w0 = w + static_cast<int64_t>(c) * s.f;
          float t2 = 0.0f;
          for (int o = 0; o < s.f; o += 4) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(w0 + o));
            t2 = fmaf(wv.x, dz[at(o + 0, p)], t2);
            t2 = fmaf(wv.y, dz[at(o + 1, p)], t2);
            t2 = fmaf(wv.z, dz[at(o + 2, p)], t2);
            t2 = fmaf(wv.w, dz[at(o + 3, p)], t2);
          }
          const int64_t pix = p0 + p;
          if (pix < s.p) dx[pix * s.ci + c] = t2;
        }
      }
      if (l > 0)
        chain_step(s, wfs, l - 1, gs, dz,
                   (kMask & kChain) != 0 ? frag + q.bwd + (l - 1) * int64_t(q.nt) * q.nt * 32
                                         : nullptr,
                   act + (l - 1) * slot, dzb + ((l - 1) & 1) * slot);
      __syncthreads();
    }
  }
  __syncthreads();
  if constexpr (kFast && (kMask & kWeightGrad) != 0) {
    // the two halves of each tile into the row, first half first
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < kRegLayers; ++j)
        if (j < s.n && warp < 2 * dw_tiles(s, j) && (warp & 1) == half)
          dw_flush(s, j, warp >> 1, racc[j], acc);
      __syncthreads();
    }
  }
  // the shared sums into the row: db_l, then W_f's and b_f's gradients
  for (int64_t j = threadIdx.x; j < small_floats(s); j += kBThreads) {
    const int l = static_cast<int>(j / s.f);
    acc[j < nf ? off_w(s, l) + static_cast<int64_t>(fan_in(s, l)) * s.f + j % s.f
               : offf + j - nf] += sacc[j];
  }
  if (plan.acc_shared) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < np; j += kBThreads) partial[j] = acc[j];
  }
}

// grad[j] = sum over blocks b, in order, of partial[b][j]
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ grad,
                    int blocks, int64_t np, int64_t stride) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= np) return;
  float t = 0.0f;
  for (int b = 0; b < blocks; ++b) t += partial[b * stride + j];
  grad[j] = t;
}

Shape make_shape(int n, int ci, int f, int cout, int64_t p) {
  Shape s;
  s.n = n;
  s.ci = ci;
  s.f = f;
  s.cout = cout;
  s.ci4 = (ci + 3) / 4 * 4;
  s.p = p;
  s.tiles = (p + kTile - 1) / kTile;
  s.btiles = (p + kBTile - 1) / kBTile;
  return s;
}

bool valid(const Shape& s) {
  return s.n >= 1 && s.ci >= 1 && s.ci <= 8 && s.f % 8 == 0 && s.f >= 8 &&
         s.f <= 256 && s.cout >= 1 && s.cout <= 8 && s.p >= 1;
}

int fwd_smem(const Shape& s) {
  return static_cast<int>(sizeof(float) * (s.ci4 + 2 * s.f + s.cout) * kStride);
}

// One launch of trunk_fwd_mma_kernel: a persistent grid of as many blocks
// as are resident at once, at most one per 8 warp steps.  The shared-memory
// attribute and the resident count are set and queried once per device and
// shared-memory size (a training step launches the forward once, and the
// host's time per launch counts there).
template <int NT, int MT, int CO>
cudaError_t launch_fwd_mma(const Shape& s, const float* x, const float* w, float* pre,
                           cudaStream_t stream) {
  constexpr int kDevices = 64;
  static int known_smem[kDevices] = {0}, resident[kDevices] = {0};
  const auto kernel = trunk_fwd_mma_kernel<NT, MT, CO>;
  const int smem = static_cast<int>(sizeof(float) * fwd_mma_floats(s));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (known_smem[dev] != smem) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
    known_smem[dev] = smem;
  }
  const int64_t steps = (s.p + 16 * MT - 1) / (16 * MT);
  const int64_t want = (steps + kFwdWarps - 1) / kFwdWarps;
  kernel<<<static_cast<unsigned>(want < resident[dev] ? want : resident[dev]), kThreads, smem,
           stream>>>(s, x, w, pre);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_fwd_tiles(const Shape& s, const float* x, const float* w, float* pre,
                             cudaStream_t stream) {
  constexpr int MT = NT <= 4 ? 2 : 1;
  return s.cout == 1 ? launch_fwd_mma<NT, MT, 1>(s, x, w, pre, stream)
                     : launch_fwd_mma<NT, MT, 8>(s, x, w, pre, stream);
}

// The forward of a shape: on the tensor cores where fwd_on_tensor_cores
// admits it, else trunk_fwd_kernel.
cudaError_t launch_fwd(const Shape& s, const float* x, const float* w, float* pre,
                       cudaStream_t stream) {
  if (fwd_on_tensor_cores(s)) {
    switch (s.f / 8) {
      case 1: return launch_fwd_tiles<1>(s, x, w, pre, stream);
      case 2: return launch_fwd_tiles<2>(s, x, w, pre, stream);
      case 3: return launch_fwd_tiles<3>(s, x, w, pre, stream);
      case 4: return launch_fwd_tiles<4>(s, x, w, pre, stream);
      case 5: return launch_fwd_tiles<5>(s, x, w, pre, stream);
      case 6: return launch_fwd_tiles<6>(s, x, w, pre, stream);
      case 7: return launch_fwd_tiles<7>(s, x, w, pre, stream);
      case 8: return launch_fwd_tiles<8>(s, x, w, pre, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  const int smem = fwd_smem(s);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  trunk_fwd_kernel<<<static_cast<unsigned>(s.tiles), kThreads, smem, stream>>>(s, x, w, pre);
  return cudaGetLastError();
}

// The backward's memory layout for a grid of `blocks` blocks (no device
// query); every instantiation of the backward runs with it.  The fast
// path takes the shapes whose dW tiles fit the warps (two halves each, at
// most kRegLayers layers) and whose tile arrays and fragments fit shared
// memory: the flagship and the other narrow, shallow trunks.
Plan layout(const Shape& s, int blocks) {
  Plan pl;
  pl.blocks = blocks;
  pl.dz_floats = 2LL * s.f * kBStride;
  pl.act_floats = static_cast<int64_t>(s.n) * s.f * kBStride;
  const int64_t np = num_params(s);
  const int64_t frag_floats = 4 * frags(s).total;
  const int64_t budget = kBudget / sizeof(float);
  const int mt = (s.f + 15) / 16;
  int64_t used = core_floats(s);
  // dW in registers: every layer's tiles (2 halves each) within the warps
  pl.fast = s.n <= kRegLayers && 2 * mt * (s.f / 8) <= kBWarps &&
            used + pl.dz_floats + pl.act_floats + frag_floats <= budget;
  if (pl.fast) {
    pl.dz_shared = pl.act_shared = true;
    used += pl.dz_floats + pl.act_floats + frag_floats;
  } else {
    pl.dz_shared = used + pl.dz_floats <= budget;
    if (pl.dz_shared) used += pl.dz_floats;
    pl.act_shared = used + pl.act_floats <= budget;
    if (pl.act_shared) used += pl.act_floats;
  }
  pl.acc_shared = used + np <= budget;
  if (pl.acc_shared) used += np;
  pl.smem_bytes = static_cast<int>(used * sizeof(float));
  pl.slice_floats = (pl.dz_shared ? 0 : pl.dz_floats) + (pl.act_shared ? 0 : pl.act_floats);
  pl.frag_offset = blocks * (row_stride(s) + pl.slice_floats);
  const int64_t b = blocks > 0 ? blocks : 1;
  pl.work_floats = pl.frag_offset + (pl.fast ? 0 : (frag_floats + b - 1) / b * b);
  return pl;
}

// Each instantiation carries its own shared-memory attribute: set it for
// the one about to be launched or queried.
template <int kMask, bool kFast>
cudaError_t set_bwd_smem(const Plan& pl) {
  return cudaFuncSetAttribute(trunk_bwd_kernel<kMask, kFast>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              pl.smem_bytes);
}

template <bool kFast>
cudaError_t product_occupancy(const Plan& pl, int* per_sm) {
  cudaError_t err = set_bwd_smem<kAllPhases, kFast>(pl);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, trunk_bwd_kernel<kAllPhases, kFast>, kBThreads, pl.smem_bytes);
}

// The layout with the block count of a persistent grid of the product
// backward on the current device: as many blocks as are resident at once,
// at most one per tile.
cudaError_t make_plan(const Shape& s, Plan* plan) {
  Plan pl = layout(s, 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = pl.fast ? product_occupancy<true>(pl, &per_sm)
                            : product_occupancy<false>(pl, &per_sm);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = static_cast<int64_t>(sms) * per_sm;
  *plan = layout(s, static_cast<int>(want < s.btiles ? want : s.btiles));
  return cudaSuccess;
}

// One launch of the backward's instantiation kMask over `blocks` blocks
// (after the fragments where they live in the workspace); each block
// leaves its partial gradient row in work.
template <int kMask>
cudaError_t launch_bwd(const Shape& s, int blocks, const float* x, const float* g,
                       const float* w, float* dx, float* work, cudaStream_t stream) {
  const Plan pl = layout(s, blocks);
  cudaError_t err;
  if (pl.fast) {
    if ((err = set_bwd_smem<kMask, true>(pl)) != cudaSuccess) return err;
    trunk_bwd_kernel<kMask, true><<<pl.blocks, kBThreads, pl.smem_bytes, stream>>>(
        s, pl, x, g, w, dx, work);
  } else {
    const int64_t total = frags(s).total;
    stage_frags_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(s, w, reinterpret_cast<float4*>(work + pl.frag_offset));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = set_bwd_smem<kMask, false>(pl)) != cudaSuccess) return err;
    trunk_bwd_kernel<kMask, false><<<pl.blocks, kBThreads, pl.smem_bytes, stream>>>(
        s, pl, x, g, w, dx, work);
  }
  return cudaGetLastError();
}

// grad = the fixed-order sum of the blocks' partial rows in work
cudaError_t launch_sum(const Shape& s, int blocks, const float* work, float* grad,
                       cudaStream_t stream) {
  const int64_t np = num_params(s);
  sum_partials_kernel<<<static_cast<unsigned>((np + kThreads - 1) / kThreads), kThreads,
                        0, stream>>>(work, grad, blocks, np, row_stride(s));
  return cudaGetLastError();
}

cudaError_t finish(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();  // do not leak into a later launch
  return err;
}

}  // namespace

// The backward's launch plan on the current device: out[0] = blocks of the
// persistent grid, out[1] = workspace floats the caller must allocate.
extern "C" int rf_cnn_train_plan(int n, int ci, int f, int cout, int64_t p,
                                 int64_t* out) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const cudaError_t err = make_plan(s, &pl);
  if (err != cudaSuccess) return static_cast<int>(finish(err));
  out[0] = pl.blocks;
  out[1] = pl.work_floats;
  return static_cast<int>(cudaSuccess);
}

// x [p, ci], w (flat, see above), pre [p, cout]; all f32 on the device.
extern "C" int rf_cnn_train_fwd(const float* x, const float* w, float* pre, int n,
                                int ci, int f, int cout, int64_t p,
                                cudaStream_t stream) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(finish(launch_fwd(s, x, w, pre, stream)));
}

// x [p, ci], g [p, cout], w (flat) -> grad (flat, same layout as w) and,
// when dx is not null, dx [p, ci].  work holds rf_cnn_train_plan's
// workspace floats and blocks is its block count, both queried once per
// (device, shape) by the caller; the sums' order depends on blocks, so the
// same blocks gives the same bits.
extern "C" int rf_cnn_train_bwd(const float* x, const float* g, const float* w,
                                float* grad, float* dx, float* work, int n, int ci,
                                int f, int cout, int64_t p, int blocks,
                                cudaStream_t stream) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s) || blocks < 1 || blocks > s.btiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_bwd<kAllPhases>(s, blocks, x, g, w, dx, work, stream);
  if (err != cudaSuccess) return static_cast<int>(finish(err));
  return static_cast<int>(launch_sum(s, blocks, work, grad, stream));
}

// Timing variants of the backward (no dx), at the product's plan: the same
// arguments as rf_cnn_train_bwd less dx, then the instantiation's phase
// `mask`, followed by the block sum as in the product.  The masks of the
// split are instantiated: kAllPhases (the product's gradient, bitwise),
// without dW_l, also without the chain's W_{l+1} dz_{l+1} term (dz_l =
// [h_l > 0] W_f,l g), also without dW_fuse, and 0, the floor (db_fuse = the
// sum over tiles of x[t0][0] + g[t0][0], t0 the tile's first pixel, every
// other entry zero).  With `sum_only` set, `mask` is not read and
// sum_partials_kernel runs alone over the rows that the previous launch
// left in work.
extern "C" int rf_cnn_train_bwd_variant(const float* x, const float* g, const float* w,
                                        float* grad, float* work, int n, int ci, int f,
                                        int cout, int64_t p, int blocks, int mask,
                                        int sum_only, cudaStream_t stream) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s) || blocks < 1 || blocks > s.btiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (!sum_only) {
    switch (mask) {
      case kAllPhases:
        err = launch_bwd<kAllPhases>(s, blocks, x, g, w, nullptr, work, stream);
        break;
      case kRemat | kHead | kChain:
        err = launch_bwd<kRemat | kHead | kChain>(s, blocks, x, g, w, nullptr, work, stream);
        break;
      case kRemat | kHead:
        err = launch_bwd<kRemat | kHead>(s, blocks, x, g, w, nullptr, work, stream);
        break;
      case kRemat:
        err = launch_bwd<kRemat>(s, blocks, x, g, w, nullptr, work, stream);
        break;
      case 0:
        err = launch_bwd<0>(s, blocks, x, g, w, nullptr, work, stream);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(finish(err));
  return static_cast<int>(launch_sum(s, blocks, work, grad, stream));
}
