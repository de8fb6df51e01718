// K1 — fused forward of the flagship reflectance CNN.
//
// Replaces reflectance_filtering_tpu/ops/cnn_pallas.py::_kernel_planar
// (reached via reflectance_cnn_pallas_planar) and ::_kernel (the HWC entry,
// which the port serves with this kernel behind a permute).
//
// What it computes: per pixel, optional sRGB -> linear gamma, then the
// shipped per-pixel MLP 3 -> 32 -> 32 -> 32 -> 32 -> 32 (ReLU), the 160 -> 1
// skip fuse and a sigmoid.  Input planar f32 [B, 3, HW] (RGB, already
// flipped from BGR and scaled to [0, 1] by the caller), output f32 [B, HW].
//
// What bounds it on an H100: arithmetic.  Each pixel costs 4,192 MACs of
// matrix products (96 + 4 x 1024) and 160 of the fuse against 16 bytes of
// device memory traffic.  On the FP32 pipe alone (66.9 TFLOP/s) that is
// 0.27 ms for 32 x 256x256; the tensor cores do TF32 at 495 TFLOP/s.  One
// TF32 product keeps ~11 bits of each operand, too few for the u8 gate
// (floor(r * 255)), so layers 1-4 run as 3xTF32: each f32 operand is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and hi.hi + hi.lo +
// lo.hi (lo.lo dropped) is accumulated in f32, which keeps about f32's
// accuracy at a third of the TF32 rate, still 2.5x the FP32 FMA rate.
// This is the TPU kernel's scheme (bf16 pieces stacked along K for its
// matrix unit) with Hopper's TF32 pieces.
//
// Design.  Pixels are the M of mma.sync.m16n8k8 (f32 += tf32 x tf32): a
// warp takes 32 pixels (two m16 tiles) per step of a persistent grid.
//   * Layer 0 (3 -> 32, 96 FMAs a pixel) and the fuse are f32 FMAs.  Layer
//     0 is computed straight into the accumulator layout of an m16n8 tile
//     (rows g, g + 8, columns 2t, 2t + 1 of each 8-wide n tile; g = lane / 4,
//     t = lane % 4), so no lane computes another's values.
//   * The activations stay in registers across layers: the accumulator of
//     one layer is the A fragment of the next without a shuffle, because A's
//     columns t and t + 4 of k block kb are read as inputs 8kb + 2t and
//     8kb + 2t + 1.  The next layer's weight rows are staged in that same
//     permuted order (perm[t] = 2t, perm[t + 4] = 2t + 1 within each
//     8-block); the flat weight layout is unchanged.
//   * Weights: each block splits the 4 x 32 x 32 mid-layer weights into
//     hi/lo once and stores them in shared memory in B-fragment order (one
//     16-byte {hi0, hi1, lo0, lo1} per lane, k block and n tile: 32 KB,
//     conflict-free loads); biases, layer 0 and the fuse beside them.  The
//     grid is persistent (two blocks per SM), so that staging is paid once
//     per ~250 warp steps.
//   * The 160 -> 1 fuse is accumulated layer by layer in f32 (each lane its
//     partial dot over its 8 columns, then a shuffle across the 4 lanes of
//     a row group); the sigmoid and the sRGB gamma are computed once per
//     pixel by the lane that loads and stores it.
//   * The ragged end of HW is masked per image (inputs read as 0, outputs
//     not stored), never padded in device memory.
//
// Weight layout (flat f32 [4513], see ops/cnn_kernel.py::pack_weights):
//   layer 0: W [3][32] (in, out) at 0, bias [32] at 96
//   layer l = 1..4: W [32][32] at 128 + (l-1)*1056, bias [32] right after
//   fuse weights [160] at 4352 (layer-major), fuse bias at 4512.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFilters = 32;
constexpr int kMidLayers = 4;
constexpr int kLayer0W = 0;
constexpr int kLayer0B = 3 * kFilters;                      // 96
constexpr int kMidBase = kLayer0B + kFilters;               // 128
constexpr int kMidStride = kFilters * kFilters + kFilters;  // 1056
constexpr int kFuseW = kMidBase + kMidLayers * kMidStride;  // 4352
constexpr int kFuseB = kFuseW + 5 * kFilters;               // 4512
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 2;
constexpr int kStep = 32;      // pixels per warp step: two m16 tiles
constexpr int kTiles = 4;      // 8-wide n tiles (and 8-deep k blocks) of 32
constexpr unsigned kFull = 0xffffffffu;

struct Staged {
  // [layer][k block * 4 + n tile][lane] = {hi(W[8kb+2t][8nt+g]),
  // hi(W[8kb+2t+1][8nt+g]), lo(..), lo(..)}
  float4 frag[kMidLayers][kTiles * kTiles][32];
  float w0[3 * kFilters];
  float bias[1 + kMidLayers][kFilters];
  float fuse[(1 + kMidLayers) * kFilters];
  float fuse_b;
};

__device__ __forceinline__ float srgb_to_linear(float v) {
  // same branch and constants as srgb_to_rgb_jnp (utils/image.py)
  return v <= 0.04045f ? v / 12.92f
                       : powf(fmaxf((v + 0.055f) / 1.055f, 0.0f), 2.4f);
}

// hi = rna_tf32(x) and lo = rna_tf32(x - hi), where rna_tf32 is
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, on the 13
// low mantissa bits, which come back as zeros) written as integer ops: add
// half of the dropped bits' range to the magnitude's bits, then clear
// them.  ptxas expands cvt.rna.tf32.f32 with a NaN test and a select:
// this kernel had 3,576 machine instructions with it, 3,192 with the
// activations' split as integer ops (8% less time on an H100) and has
// 3,080 with the weights' too (chip_smoke.py phase 2 prints the count).
// The two differ only on a NaN whose payload lies in the dropped bits,
// which finite weights and activations never are.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) . b (8 x 8, col), f32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ void stage(const float* __restrict__ weights, Staged& s) {
  for (int e = threadIdx.x; e < kMidLayers * kTiles * kTiles * 32;
       e += kThreads) {
    const int lane = e & 31, blk = (e >> 5) & 15, l = e >> 9;
    const int kb = blk >> 2, nt = blk & 3, g = lane >> 2, t = lane & 3;
    const float* w = weights + kMidBase + l * kMidStride;
    const int i = 8 * kb + 2 * t, o = 8 * nt + g;
    uint32_t h0, l0, h1, l1;
    split(w[i * kFilters + o], h0, l0);
    split(w[(i + 1) * kFilters + o], h1, l1);
    s.frag[l][blk][lane] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                       __uint_as_float(l0), __uint_as_float(l1));
  }
  for (int e = threadIdx.x; e < 3 * kFilters; e += kThreads)
    s.w0[e] = weights[kLayer0W + e];
  for (int e = threadIdx.x; e < (1 + kMidLayers) * kFilters; e += kThreads) {
    const int l = e / kFilters, o = e % kFilters;
    s.bias[l][o] = weights[l == 0 ? kLayer0B + o
                                  : kMidBase + (l - 1) * kMidStride +
                                        kFilters * kFilters + o];
    s.fuse[e] = weights[kFuseW + e];
  }
  if (threadIdx.x == 0) s.fuse_b = weights[kFuseB];
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cnn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ weights,
               float* __restrict__ out, int64_t batch, int64_t hw,
               int srgb_input) {
  __shared__ Staged s;
  stage(weights, s);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t steps_per_image = (hw + kStep - 1) / kStep;
  const int64_t steps = batch * steps_per_image;
  for (int64_t step = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
       step < steps; step += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t b = step / steps_per_image;
    const int64_t p = (step - b * steps_per_image) * kStep + lane;
    const float* xb = x + b * 3 * hw + p;

    // lane L loads (and linearizes) pixel L of the step
    float in[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = p < hw ? xb[c * hw] : 0.0f;
      in[c] = srgb_input ? srgb_to_linear(v) : v;
    }

    // h[m][nt][r]: pixel 16m + g (r < 2) or 16m + g + 8 (r >= 2), channel
    // 8nt + 2t + (r & 1): the m16n8 accumulator layout
    float h[2][kTiles][4];
    float fz[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // fuse partial per row
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float xr[2][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xr[0][c] = __shfl_sync(kFull, in[c], 16 * m + g);
        xr[1][c] = __shfl_sync(kFull, in[c], 16 * m + g + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = 8 * nt + 2 * t + (r & 1);
          float acc = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc = fmaf(xr[r >> 1][c], s.w0[c * kFilters + o], acc);
          const float v = fmaxf(acc + s.bias[0][o], 0.0f);
          h[m][nt][r] = v;
          fz[m][r >> 1] = fmaf(v, s.fuse[o], fz[m][r >> 1]);
        }
    }

#pragma unroll
    for (int l = 0; l < kMidLayers; ++l) {
      float acc[2][kTiles][4];
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const float b0 = s.bias[l + 1][8 * nt + 2 * t];
        const float b1 = s.bias[l + 1][8 * nt + 2 * t + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          acc[m][nt][0] = b0;
          acc[m][nt][1] = b1;
          acc[m][nt][2] = b0;
          acc[m][nt][3] = b1;
        }
      }
#pragma unroll
      for (int kb = 0; kb < kTiles; ++kb) {
        // A fragment of k block kb from the accumulator of n tile kb:
        // a0 (g, t) = c0, a1 (g + 8, t) = c2, a2 (g, t + 4) = c1,
        // a3 (g + 8, t + 4) = c3
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          split(h[m][kb][0], ah[m][0], al[m][0]);
          split(h[m][kb][2], ah[m][1], al[m][1]);
          split(h[m][kb][1], ah[m][2], al[m][2]);
          split(h[m][kb][3], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
          const float4 f = s.frag[l][kb * kTiles + nt][lane];
          const uint32_t bh0 = __float_as_uint(f.x), bh1 = __float_as_uint(f.y);
          const uint32_t bl0 = __float_as_uint(f.z), bl1 = __float_as_uint(f.w);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // the small terms first, then hi . hi
            mma(acc[m][nt], al[m], bh0, bh1);
            mma(acc[m][nt], ah[m], bl0, bl1);
            mma(acc[m][nt], ah[m], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v = fmaxf(acc[m][nt][r], 0.0f);
            h[m][nt][r] = v;
            fz[m][r >> 1] = fmaf(
                v, s.fuse[(l + 1) * kFilters + 8 * nt + 2 * t + (r & 1)],
                fz[m][r >> 1]);
          }
    }

    // the fuse's dot over a row group's 4 lanes, then lane L takes pixel L
    // (row r = L % 16 of tile m = L / 16 sits in lane 4 (r % 8))
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        fz[m][half] += __shfl_xor_sync(kFull, fz[m][half], 1);
        fz[m][half] += __shfl_xor_sync(kFull, fz[m][half], 2);
      }
    const int src = 4 * (lane & 7);
    const float z00 = __shfl_sync(kFull, fz[0][0], src);
    const float z01 = __shfl_sync(kFull, fz[0][1], src);
    const float z10 = __shfl_sync(kFull, fz[1][0], src);
    const float z11 = __shfl_sync(kFull, fz[1][1], src);
    const bool upper = (lane & 8) != 0;
    const float z = (lane < 16 ? (upper ? z01 : z00) : (upper ? z11 : z10)) +
                    s.fuse_b;
    if (p < hw) out[b * hw + p] = 1.0f / (1.0f + expf(-z));
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

}  // namespace

// x [batch, 3, hw] f32, weights [4513] f32 (device), out [batch, hw] f32.
// Returns the cudaError_t of the launch.
extern "C" int rf_cnn_fwd(const float* x, const float* weights, float* out,
                          int64_t batch, int64_t hw, int srgb_input,
                          cudaStream_t stream) {
  const int64_t steps = batch * ((hw + kStep - 1) / kStep);
  const int64_t blocks = (steps + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSM;
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  cnn_fwd_kernel<<<grid, kThreads, 0, stream>>>(x, weights, out, batch, hw,
                                                srgb_input);
  return static_cast<int>(cudaGetLastError());
}
