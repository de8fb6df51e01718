// K6's float kernel template (bilateral_joint.cu holds the notes and the
// entry point): the joint bilateral on float values, the weight
// exp(D^2 gcc + s gsc) (s = dx^2 + dy^2) as one ex2.approx.ftz (MUFU.EX2)
// with the spatial term from a float64-built table, read at one address by
// a whole warp: no full expf and no int-to-float conversion a tap.  The
// joint values are scaled by k = sqrt(-gcc joint_reps^2 log2(e)) as the
// tile is filled, so k D is the sum of |differences| of the tile's values.
// Two forms of the spatial term (kLogTable):
//   * the product's: w = ex2(lsw[s] - (k D)^2), lsw[s] = f32(s gsc
//     log2(e)) (ops/bilateral_joint_kernel.py::space_log2_weights), one
//     FMA into the exponent;
//   * factored: w = sw[s] ex2(-(k D)^2), sw[s] = f32(exp(s gsc))
//     (ops/bilateral.py::space_weights), two multiplies (the square's and
//     sw's) where the product has one FMA.
// Its geometry is a parameter too: kPix adjacent pixels of a row a thread,
// the disk's rows split over kSplit groups of warps.  The product
// (bilateral_joint.cu) takes kPix = 4, kSplit = 4 and the log table;
// scripts/k6_float_geometries.cu builds others for
// scripts/measure_k6_float.py.
#pragma once

#include <cuda_runtime.h>

#include "bilateral_common.cuh"

namespace k6f {

constexpr int kTileW = 32;  // output columns of a block (every geometry)
constexpr int kTileH = 16;  // output rows of a block

// A block is kSplit groups of (32 / kPix) x 16 threads; group g walks the
// disk rows dy with dy + radius = g (mod kSplit) for the whole 16 x 32
// tile.  The sliding window holds 2 kPix - 1 tile columns and moves kPix
// columns a step.
template <int kPix, int kSplit>
struct Geometry {
  static_assert(kPix == 2 || kPix == 4 || kPix == 8, "kPix: 2, 4 or 8");
  static constexpr int kThreadsX = kTileW / kPix;
  static constexpr int kGroupWarps = kThreadsX * kTileH / 32;
  static constexpr int kThreads = kThreadsX * kTileH * kSplit;
  static constexpr int kWin = 2 * kPix - 1;
};

// A tile position: its joint values, then its src values, contiguous, so
// that one vector load (LDS.128 for four values) reads them all.
template <int N>
struct alignas(N % 4 == 0 ? 16 : 8) Vals {
  float v[N];
};

// A tile row of `cols` columns is stored as kPix runs, run j holding the
// columns c with c % kPix = j (lengths cols / kPix, one more for the first
// cols % kPix runs, no padding): the lanes of a row, kPix columns apart,
// then read consecutive positions, and a quarter warp's 16-byte loads
// (one row of 8 lanes at kPix = 4) fall on 32 distinct banks.
template <int kPix>
__device__ __forceinline__ int run_start(int j, int cols) {
  return j * (cols / kPix) + min(j, cols % kPix);
}

template <int kPix>
__device__ __forceinline__ int col_offset(int c, int cols) {
  return run_start<kPix>(c & (kPix - 1), cols) + static_cast<int>(static_cast<unsigned>(c) / kPix);
}

// Shared memory of a block, bytes: the tile (every plane's value at each
// position) or, when larger, the groups' partial sums kept for the final
// reduction ((kSplit - 1) (CS + 1) floats a pixel); the wrapper's
// ops/bilateral_joint_kernel.py::smem_bytes mirrors this.
template <int CJ, int CS, int kSplit>
__host__ __device__ inline int smem_bytes(int radius) {
  const int tile = (CJ + CS) * (kTileH + 2 * radius) * (kTileW + 2 * radius);
  const int red = (kSplit - 1) * (CS + 1) * kTileW * kTileH;
  return 4 * (tile > red ? tile : red);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kSteps taps (dx .. dx + kSteps - 1 of one disk row) for the thread's
// kPix pixels; win holds the window from column dx of pixel 0, sw is the
// spatial table (lsw or sw).  d = k D = sum_c |k J_c(q) - k J_c(p)| (k J(q)
// - k J(p) itself for one joint plane: it is squared).
template <int CJ, int CS, int kPix, bool kLogTable, int kSteps>
__device__ __forceinline__ void taps(const Vals<CJ + CS>* win, const float* __restrict__ sw,
                                     int dy2, int dx, float (*cen)[CJ],
                                     float (*acc)[CS], float* wsum) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    // one address in the warp; one unsigned index, so a multiply-add forms
    // it and one wide multiply-add the address
    const float sp = __ldg(sw + static_cast<unsigned>((dx + j) * (dx + j) + dy2));
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const Vals<CJ + CS>& q = win[j + k];
      float d;
      if constexpr (CJ == 1) {
        d = q.v[0] - cen[k][0];
      } else {
        d = fabsf(q.v[0] - cen[k][0]);
#pragma unroll
        for (int c = 1; c < CJ; ++c) d += fabsf(q.v[c] - cen[k][c]);
      }
      const float wgt = kLogTable ? ex2(fmaf(-d, d, sp)) : ex2(-d * d) * sp;
#pragma unroll
      for (int c = 0; c < CS; ++c) acc[k][c] = fmaf(wgt, q.v[CJ + c], acc[k][c]);
      wsum[k] += wgt;
    }
  }
}

// One disk row dy (its taps dx ascending) for the thread's kPix pixels,
// added to acc and wsum; row points at the row's position of the thread's
// first tile column.  The row's sums are kept apart and added after the
// row: a float32 running sum over the whole disk (16,757 taps at radius
// 73) drifts by ~1e-5 of its value.  Along the row the window slides kPix
// columns a step, so a position read from shared memory serves all kPix
// pixels, and so does a spatial weight.
template <int CJ, int CS, int kPix, bool kLogTable>
__device__ __forceinline__ void disk_row(const Vals<CJ + CS>* row, int cols, int dy, int r2,
                                         int radius, const float* __restrict__ sw,
                                         float (*cen)[CJ], float (*acc)[CS], float* wsum) {
  using V = Vals<CJ + CS>;
  constexpr int kWin = 2 * kPix - 1;
  float racc[kPix][CS], rsum[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
#pragma unroll
    for (int c = 0; c < CS; ++c) racc[k][c] = 0.0f;
    rsum[k] = 0.0f;
  }
  const int dy2 = dy * dy;
  const int dxm = disk_half_width(r2 - dy2);
  const int m0 = radius - dxm;  // the first tap's column for pixel 0
  // the window's loaded slots kPix - 1 + u at step 0; step s reads each
  // run one position further
  const V* at[kPix];
#pragma unroll
  for (int u = 0; u < kPix; ++u) at[u] = row + col_offset<kPix>(m0 + kPix - 1 + u, cols);
  V win[kWin];
#pragma unroll
  for (int j = 0; j < kPix - 1; ++j) win[j] = at[j + 1][-1];
  const int taps_n = 2 * dxm + 1;
  const int steps = taps_n / kPix;
  int dx = -dxm;
  for (int s = 0; s < steps; ++s, dx += kPix) {
#pragma unroll
    for (int u = 0; u < kPix; ++u) win[kPix - 1 + u] = at[u][s];
    taps<CJ, CS, kPix, kLogTable, kPix>(win, sw, dy2, dx, cen, racc, rsum);
#pragma unroll
    for (int j = 0; j < kPix - 1; ++j) win[j] = win[j + kPix];
  }
  // the row's last taps_n % kPix taps, one at a time
#pragma unroll
  for (int e = 0; e < kPix - 1; ++e) {
    if (e >= taps_n - steps * kPix) break;
    win[kPix - 1] = at[e][steps];
    taps<CJ, CS, kPix, kLogTable, 1>(win, sw, dy2, dx + e, cen, racc, rsum);
#pragma unroll
    for (int j = 0; j < kPix - 1; ++j) win[j] = win[j + 1];
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
#pragma unroll
    for (int c = 0; c < CS; ++c) acc[k][c] += racc[k][c];
    wsum[k] += rsum[k];
  }
}

// The end of a block: the groups' partial sums added into group 0's, in
// group order (in shared memory, over the tile), then the outputs of the
// thread's pixels (column kPix tx + k, row ty of the block's tile) written.
template <int CJ, int CS, int kPix, int kSplit>
__device__ __forceinline__ void finish(unsigned char* smem, int group, int tx, int ty, int h,
                                       int w, float* __restrict__ out, float (*acc)[CS],
                                       float* wsum) {
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  if constexpr (kSplit > 1) {
    // the groups' partial sums into group 0, in group order
    constexpr int kPixels = kTileW * kTileH;
    float* red = reinterpret_cast<float*>(smem);
    const int pix0 = ty * kTileW + tx * kPix;
    __syncthreads();  // every group is done with the tile
    if (group > 0) {
      float* r = red + (group - 1) * (CS + 1) * kPixels + pix0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
#pragma unroll
        for (int c = 0; c < CS; ++c) r[c * kPixels + k] = acc[k][c];
        r[CS * kPixels + k] = wsum[k];
      }
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 0; g < kSplit - 1; ++g) {
      const float* r = red + g * (CS + 1) * kPixels + pix0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
#pragma unroll
        for (int c = 0; c < CS; ++c) acc[k][c] += r[c * kPixels + k];
        wsum[k] += r[CS * kPixels + k];
      }
    }
  }
  const int ox = x0 + tx * kPix;
  const int oy = y0 + ty;
  if (oy >= h) return;  // ragged tile: write nothing outside the frame
  float* o = out + blockIdx.z * CS * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (ox + k >= w) break;
#pragma unroll
    for (int c = 0; c < CS; ++c) o[c * plane + k] = acc[k][c] / wsum[k];
  }
}

// joint f32 [n, CJ, h, w], src f32 [n, CS, h, w], out f32 [n, CS, h, w];
// sw f32 [radius^2 + 1] on the device, lsw (kLogTable) or sw by s; k =
// sqrt(-gcc joint_reps^2 log2(e)), the scale of the joint values.
template <int CJ, int CS, int kPix, int kSplit, bool kLogTable>
__global__ void __launch_bounds__(Geometry<kPix, kSplit>::kThreads, 1)
bilateral_joint_float_kernel(const float* __restrict__ joint, const float* __restrict__ src,
                             float* __restrict__ out, const float* __restrict__ sw, int h,
                             int w, int radius, float k) {
  using G = Geometry<kPix, kSplit>;
  using V = Vals<CJ + CS>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* tile = reinterpret_cast<V*>(smem);
  const int cols = kTileW + 2 * radius, rows = kTileH + 2 * radius;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* jimg = joint + blockIdx.z * CJ * plane;
  const float* simg = src + blockIdx.z * CS * plane;

  const int tid = threadIdx.x;
  for (int i = tid; i < rows * cols; i += G::kThreads) {
    const int ty = i / cols;
    const int tx = i - ty * cols;
    int gy = y0 - radius + ty;
    int gx = x0 - radius + tx;
    if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
    if (static_cast<unsigned>(gx) >= static_cast<unsigned>(w)) gx = reflect101(gx, w);
    const size_t at = static_cast<size_t>(gy) * w + gx;
    V v;
#pragma unroll
    for (int c = 0; c < CJ; ++c) v.v[c] = jimg[c * plane + at] * k;
#pragma unroll
    for (int c = 0; c < CS; ++c) v.v[CJ + c] = simg[c * plane + at];
    tile[ty * cols + col_offset<kPix>(tx, cols)] = v;
  }
  __syncthreads();

  // lane -> (column group tx, row k of the warp's kPix adjacent rows)
  const int warp = tid >> 5, lane = tid & 31;
  const int group = warp / G::kGroupWarps;
  const int tx = lane % G::kThreadsX;
  const int ty = (warp % G::kGroupWarps) * kPix + lane / G::kThreadsX;
  // pixel k of the thread is tile column kPix tx + radius + k of row ty +
  // radius; the column kPix tx + m sits at run_start(m % kPix) + tx + m /
  // kPix of its row
  const V* crow = tile + (ty + radius) * cols + tx;
  float cen[kPix][CJ];
  float acc[kPix][CS], wsum[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const V c = crow[col_offset<kPix>(radius + k, cols)];
#pragma unroll
    for (int j = 0; j < CJ; ++j) cen[k][j] = c.v[j];
#pragma unroll
    for (int j = 0; j < CS; ++j) acc[k][j] = 0.0f;
    wsum[k] = 0.0f;
  }

  // the group's disk rows, dx ascending, alike in every thread of the
  // group; along a row the window slides kPix columns a step, so a
  // position read from shared memory serves all kPix pixels, and so does a
  // spatial weight (disk_row and finish written out: calling them measured
  // 1-2% slower at radius 33 on an H100, scripts/measure_box_guided.py
  // --compare)
  const int r2 = radius * radius;
  for (int dy = -radius + group; dy <= radius; dy += kSplit) {
    // the row's sums apart, added to the group's after the row: a float32
    // running sum over the whole disk (16,757 taps at radius 73) drifts by
    // ~1e-5 of its value
    float racc[kPix][CS], rsum[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
#pragma unroll
      for (int c = 0; c < CS; ++c) racc[k][c] = 0.0f;
      rsum[k] = 0.0f;
    }
    const int dy2 = dy * dy;
    const int dxm = disk_half_width(r2 - dy2);
    const V* row = crow + dy * cols;
    const int m0 = radius - dxm;  // the first tap's column for pixel 0
    // the window's loaded slots kPix - 1 + u at step 0; step s reads each
    // run one position further
    const V* at[kPix];
#pragma unroll
    for (int u = 0; u < kPix; ++u) at[u] = row + col_offset<kPix>(m0 + kPix - 1 + u, cols);
    V win[G::kWin];
#pragma unroll
    for (int j = 0; j < kPix - 1; ++j) win[j] = at[j + 1][-1];
    const int taps_n = 2 * dxm + 1;
    const int steps = taps_n / kPix;
    int dx = -dxm;
    for (int s = 0; s < steps; ++s, dx += kPix) {
#pragma unroll
      for (int u = 0; u < kPix; ++u) win[kPix - 1 + u] = at[u][s];
      taps<CJ, CS, kPix, kLogTable, kPix>(win, sw, dy2, dx, cen, racc, rsum);
#pragma unroll
      for (int j = 0; j < kPix - 1; ++j) win[j] = win[j + kPix];
    }
    // the row's last taps_n % kPix taps, one at a time
#pragma unroll
    for (int e = 0; e < kPix - 1; ++e) {
      if (e >= taps_n - steps * kPix) break;
      win[kPix - 1] = at[e][steps];
      taps<CJ, CS, kPix, kLogTable, 1>(win, sw, dy2, dx + e, cen, racc, rsum);
#pragma unroll
      for (int j = 0; j < kPix - 1; ++j) win[j] = win[j + 1];
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
#pragma unroll
      for (int c = 0; c < CS; ++c) acc[k][c] += racc[k][c];
      wsum[k] += rsum[k];
    }
  }

  if constexpr (kSplit > 1) {
    // the groups' partial sums into group 0, in group order
    constexpr int kPixels = kTileW * kTileH;
    float* red = reinterpret_cast<float*>(smem);
    const int pix0 = ty * kTileW + tx * kPix;
    __syncthreads();  // every group is done with the tile
    if (group > 0) {
      float* r = red + (group - 1) * (CS + 1) * kPixels + pix0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
#pragma unroll
        for (int c = 0; c < CS; ++c) r[c * kPixels + k] = acc[k][c];
        r[CS * kPixels + k] = wsum[k];
      }
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 0; g < kSplit - 1; ++g) {
      const float* r = red + g * (CS + 1) * kPixels + pix0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
#pragma unroll
        for (int c = 0; c < CS; ++c) acc[k][c] += r[c * kPixels + k];
        wsum[k] += r[CS * kPixels + k];
      }
    }
  }
  const int ox = x0 + tx * kPix;
  const int oy = y0 + ty;
  if (oy >= h) return;  // ragged tile: write nothing outside the frame
  float* o = out + blockIdx.z * CS * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (ox + k >= w) break;
#pragma unroll
    for (int c = 0; c < CS; ++c) o[c * plane + k] = acc[k][c] / wsum[k];
  }
}

template <int CJ, int CS, int kPix, int kSplit, bool kLogTable>
int launch(const float* joint, const float* src, float* out, const float* sw, int n, int h,
           int w, int radius, float k, cudaStream_t stream) {
  const auto kernel = bilateral_joint_float_kernel<CJ, CS, kPix, kSplit, kLogTable>;
  const int smem = smem_bytes<CJ, CS, kSplit>(radius);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  kernel<<<grid, Geometry<kPix, kSplit>::kThreads, smem, stream>>>(joint, src, out, sw, h, w,
                                                                   radius, k);
  return static_cast<int>(cudaGetLastError());
}

// The banded kernel's shared memory for bands of `band` disk rows: the
// band's tile rows (band + kTileH - 1) or, when larger, the reduction area.
template <int CJ, int CS, int kSplit>
__host__ __device__ inline int banded_smem_bytes(int radius, int band) {
  const int tile = (CJ + CS) * (band + kTileH - 1) * (kTileW + 2 * radius);
  const int red = (kSplit - 1) * (CS + 1) * kTileW * kTileH;
  return 4 * (tile > red ? tile : red);
}

// Disk rows per band: the whole disk (2r + 1) where smem_bytes fits
// kSmemLimit (the one-band kernel runs), else, for the banded kernel, the
// most rows whose banded_smem_bytes fits it, a multiple of kSplit (every
// group of warps a row each step), evened out over the bands; 0 where not
// one row fits.
// ops/bilateral_joint_kernel.py::band_rows mirrors it.
template <int CJ, int CS, int kSplit>
__host__ __device__ inline int band_rows(int radius) {
  const int disk = 2 * radius + 1;
  if (smem_bytes<CJ, CS, kSplit>(radius) <= kSmemLimit) return disk;
  const int most = kSmemLimit / (4 * (CJ + CS) * (kTileW + 2 * radius)) - (kTileH - 1);
  return even_band(disk, most, kSplit);
}

// The kernel for a disk whose rows do not all fit one block with the tile:
// the rows in bands of `band`, each staging only the tile rows it reads;
// within a band group g takes the rows dy with dy + radius = g (mod
// kSplit), as across the whole disk, so each group sums the one-band
// kernel's rows in its order and the outputs are that kernel's.
template <int CJ, int CS, int kPix, int kSplit, bool kLogTable>
__global__ void __launch_bounds__(Geometry<kPix, kSplit>::kThreads, 1)
bilateral_joint_float_banded_kernel(const float* __restrict__ joint,
                                    const float* __restrict__ src, float* __restrict__ out,
                                    const float* __restrict__ sw, int h, int w, int radius,
                                    int band, float k) {
  using G = Geometry<kPix, kSplit>;
  using V = Vals<CJ + CS>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* tile = reinterpret_cast<V*>(smem);
  const int cols = kTileW + 2 * radius;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* jimg = joint + blockIdx.z * CJ * plane;
  const float* simg = src + blockIdx.z * CS * plane;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int group = warp / G::kGroupWarps;
  const int tx = lane % G::kThreadsX;
  const int ty = (warp % G::kGroupWarps) * kPix + lane / G::kThreadsX;

  // the pixels' own joint values, scaled, from device memory (reflected
  // past the frame, as the tile would hold them)
  const int oy = y0 + ty;
  const size_t crow = static_cast<size_t>(oy < h ? oy : reflect101(oy, h)) * w;
  float cen[kPix][CJ];
  float acc[kPix][CS], wsum[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int ox = x0 + tx * kPix + p;
    const size_t at = crow + (ox < w ? ox : reflect101(ox, w));
#pragma unroll
    for (int j = 0; j < CJ; ++j) cen[p][j] = jimg[j * plane + at] * k;
#pragma unroll
    for (int j = 0; j < CS; ++j) acc[p][j] = 0.0f;
    wsum[p] = 0.0f;
  }

  const int r2 = radius * radius;
  for (int b0 = -radius; b0 <= radius; b0 += band) {
    const int b1 = min(radius + 1, b0 + band);
    const int rows = b1 - b0 + kTileH - 1;
    __syncthreads();  // the previous band read
    for (int i = tid; i < rows * cols; i += G::kThreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      int gy = y0 + b0 + r;
      int gx = x0 - radius + c;
      if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
      if (static_cast<unsigned>(gx) >= static_cast<unsigned>(w)) gx = reflect101(gx, w);
      const size_t at = static_cast<size_t>(gy) * w + gx;
      V v;
#pragma unroll
      for (int j = 0; j < CJ; ++j) v.v[j] = jimg[j * plane + at] * k;
#pragma unroll
      for (int j = 0; j < CS; ++j) v.v[CJ + j] = simg[j * plane + at];
      tile[r * cols + col_offset<kPix>(c, cols)] = v;
    }
    __syncthreads();
    // the group's first row of the band; the tile row of disk row dy is
    // ty + dy - b0
    const int first = b0 + ((group - (b0 + radius)) % kSplit + kSplit) % kSplit;
    for (int dy = first; dy < b1; dy += kSplit)
      disk_row<CJ, CS, kPix, kLogTable>(tile + (ty + dy - b0) * cols + tx, cols, dy, r2, radius,
                                        sw, cen, acc, wsum);
  }

  finish<CJ, CS, kPix, kSplit>(smem, group, tx, ty, h, w, out, acc, wsum);
}

// One pairing at any radius: the one-band kernel where its disk fits,
// else the banded one (cudaErrorInvalidValue where not one disk row fits).
template <int CJ, int CS, int kPix, int kSplit, bool kLogTable>
int launch_radius(const float* joint, const float* src, float* out, const float* sw, int n,
                  int h, int w, int radius, float k, cudaStream_t stream) {
  if (smem_bytes<CJ, CS, kSplit>(radius) <= kSmemLimit)
    return launch<CJ, CS, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius, k,
                                                   stream);
  const int band = band_rows<CJ, CS, kSplit>(radius);
  if (band < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = bilateral_joint_float_banded_kernel<CJ, CS, kPix, kSplit, kLogTable>;
  const int smem = banded_smem_bytes<CJ, CS, kSplit>(radius, band);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  kernel<<<grid, Geometry<kPix, kSplit>::kThreads, smem, stream>>>(joint, src, out, sw, h, w,
                                                                   radius, band, k);
  return static_cast<int>(cudaGetLastError());
}

// Every float pairing at any radius on one geometry and form (the
// product's entry).
template <int kPix, int kSplit, bool kLogTable>
int launch_any_radius(int cj, int cs, const float* joint, const float* src, float* out,
                      const float* sw, int n, int h, int w, int radius, float k,
                      cudaStream_t stream) {
  if (cj == 1 && cs == 1)
    return launch_radius<1, 1, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius,
                                                        k, stream);
  if (cj == 1 && cs == 3)
    return launch_radius<1, 3, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius,
                                                        k, stream);
  if (cj == 3 && cs == 1)
    return launch_radius<3, 1, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius,
                                                        k, stream);
  if (cj == 3 && cs == 3)
    return launch_radius<3, 3, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius,
                                                        k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Every float pairing on one geometry and form: cj, cs in {1, 3}.
template <int kPix, int kSplit, bool kLogTable>
int launch_any(int cj, int cs, const float* joint, const float* src, float* out,
               const float* sw, int n, int h, int w, int radius, float k,
               cudaStream_t stream) {
  if (cj == 1 && cs == 1)
    return launch<1, 1, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius, k, stream);
  if (cj == 1 && cs == 3)
    return launch<1, 3, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius, k, stream);
  if (cj == 3 && cs == 1)
    return launch<3, 1, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius, k, stream);
  if (cj == 3 && cs == 3)
    return launch<3, 3, kPix, kSplit, kLogTable>(joint, src, out, sw, n, h, w, radius, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace k6f
