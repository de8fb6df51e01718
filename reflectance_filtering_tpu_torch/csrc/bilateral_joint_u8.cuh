// K6's uint8 kernel template (bilateral_joint.cu holds the notes and the
// entry point): the joint bilateral in cv2's table form over tiles of
// 32-bit words, one word per pixel holding its joint bytes, with the range
// table's shared-memory layout as a parameter (kShift: the product's 16
// copies are 4; scripts/k6_table_layouts.cu builds 5, a copy per bank, and
// 0, one table).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_common.cuh"

namespace k6u8 {

constexpr int kPix = 8;        // adjacent pixels of a row per thread
constexpr int kThreadsY = 32;
constexpr int kWin = kPix + 3;  // the sliding window, in tile columns

// The block's geometry for a pairing.  The joint bytes of a pixel fill
// the low bytes of its word; src bytes go above them where they fit (the
// self-guided filter reads its src from the joint bytes), else (cj = cs =
// 3, joint != src) into a second word array.  That split pairing takes 8
// x 32 threads (a 64 x 32 tile) so that its two arrays and the table fit
// a block at r = 33; the others 16 x 32 (128 x 32).
template <int CJ, int CS, bool SELF>
struct Geometry {
  static constexpr bool kSplit = !SELF && CJ + CS > 4;
  static constexpr bool kPackSrc = !SELF && !kSplit;
  static constexpr int kThreadsX = kSplit ? 8 : 16;
  static constexpr int kThreads = kThreadsX * kThreadsY;
  static constexpr int kTileW = kThreadsX * kPix;
  static constexpr int kEntries = 255 * CJ + 1;  // sum_c |delta| = 0 .. 255 cj
  static constexpr int kArrays = kSplit ? 2 : 1;
  static constexpr int kJointBytes = CJ;
  static constexpr uint32_t kJointMask = CJ == 3 ? 0x00ffffffu : 0xffu;
};

// A tile row of `cols` columns is stored as eight runs of `seg` words,
// run j holding the columns c with c % 8 = j: the lanes of a warp, kPix =
// 8 columns apart, then read consecutive words.  The row pitch is
// congruent to kThreadsX modulo 32 words, so the 32 / kThreadsX rows a
// warp reads start in distinct groups of banks: every window load is one
// conflict-free wavefront.
__host__ __device__ __forceinline__ int tile_seg(int cols) { return (cols + 7) / 8; }
__host__ __device__ __forceinline__ int tile_pitch(int seg, int threads_x) {
  return 8 * seg + ((threads_x - 8 * seg) % 32 + 32) % 32;
}
__device__ __forceinline__ int col_offset(int c, int seg) { return (c & 7) * seg + (c >> 3); }

__host__ __device__ __forceinline__ int align4(int floats) { return (floats + 3) / 4 * 4; }

// Shared memory of a block, bytes: the range table (kEntries << kShift
// floats), the spatial weights (radius^2 + 1), the word tile(s).
template <int CJ, int CS, bool SELF, int kShift>
int smem_bytes(int radius) {
  using G = Geometry<CJ, CS, SELF>;
  const int cols = G::kTileW + 2 * radius, rows = kThreadsY + 2 * radius;
  const int pitch = tile_pitch(tile_seg(cols), G::kThreadsX);
  return 4 * (align4(G::kEntries << kShift) + align4(radius * radius + 1) +
              G::kArrays * rows * pitch);
}

// A byte of a word as float: 2^23 + b, less 2^23 (exact; no conversion pipe).
__device__ __forceinline__ float byte_f(uint32_t word, int c) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + c)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t level(float v) { return __float2uint_rn(v); }

// One window column m (from the thread's first tile column) of a tile row:
// its joint bytes (src bytes masked off) and its src levels as floats.
template <typename G, int CS, bool SELF>
__device__ __forceinline__ void load(const uint32_t* row, int split_ofs, int m, int seg,
                                     uint32_t& q, float* sv) {
  const int off = col_offset(m, seg);
  const uint32_t word = row[off];
  if constexpr (G::kPackSrc) {
    q = word & G::kJointMask;
#pragma unroll
    for (int c = 0; c < CS; ++c) sv[c] = byte_f(word, G::kJointBytes + c);
  } else if constexpr (G::kSplit) {
    q = word;
    const uint32_t sword = row[off + split_ofs];
#pragma unroll
    for (int c = 0; c < CS; ++c) sv[c] = byte_f(sword, c);
  } else {
    q = word;
#pragma unroll
    for (int c = 0; c < CS; ++c) sv[c] = byte_f(word, c);
  }
}

// The taps dx .. dx + kSteps - 1 of one disk row for the thread's kPix
// pixels; q, sv hold the window from column dx of pixel 0; sw is offset
// by dy^2.  w = sw[dx^2 + dy^2] * cw[sum_c |delta|], sum_c |delta| one
// __vsadu4 of the packed joint bytes.
template <int CS, int kShift, int kSteps>
__device__ __forceinline__ void taps(const uint32_t* q, float (*sv)[CS], const float* sw,
                                     int dx, const float* base, const uint32_t* cen,
                                     float (*acc)[CS], float* wsum) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const float sp = sw[(dx + j) * (dx + j)];  // the same address in every thread
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float wgt = sp * base[__vsadu4(q[j + k], cen[k]) << kShift];
#pragma unroll
      for (int c = 0; c < CS; ++c) acc[k][c] = fmaf(wgt, sv[j + k][c], acc[k][c]);
      wsum[k] += wgt;
    }
  }
}

// joint f32 [n, CJ, h, w], src f32 [n, CS, h, w] (unread when SELF), both
// holding integers 0-255; out f32 [n, CS, h, w]; tables = [cw (kEntries) |
// sw (radius^2 + 1)] f32, cw by sum_c |delta| (joint_reps folded in), sw
// by dx^2 + dy^2.  Range table copy j of entry i at word (i << kShift) + j;
// lane l reads copy l % 2^kShift.
template <int CJ, int CS, bool SELF, int kShift>
__global__ void __launch_bounds__(Geometry<CJ, CS, SELF>::kThreads, 1)
bilateral_joint_u8_kernel(const float* __restrict__ joint, const float* __restrict__ src,
                          float* __restrict__ out, const float* __restrict__ tables, int h,
                          int w, int radius) {
  static_assert(!SELF || CS == CJ, "a self-guided filter has src == joint");
  using G = Geometry<CJ, CS, SELF>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r2 = radius * radius;
  const int cols = G::kTileW + 2 * radius, rows = kThreadsY + 2 * radius;
  const int seg = tile_seg(cols);
  const int pitch = tile_pitch(seg, G::kThreadsX);
  float* tab = reinterpret_cast<float*>(smem);
  float* sw = tab + align4(G::kEntries << kShift);
  uint32_t* tile = reinterpret_cast<uint32_t*>(sw + align4(r2 + 1));
  uint32_t* stile = tile + rows * pitch;  // the split pairing's src words
  const int x0 = blockIdx.x * G::kTileW;
  const int y0 = blockIdx.y * kThreadsY;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* jimg = joint + blockIdx.z * CJ * plane;
  const float* simg = src + blockIdx.z * CS * plane;

  const int tid = threadIdx.y * G::kThreadsX + threadIdx.x;
  for (int i = tid; i < rows * cols; i += G::kThreads) {
    const int ty = i / cols;
    const int tx = i - ty * cols;
    int gy = y0 - radius + ty;
    int gx = x0 - radius + tx;
    if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
    if (static_cast<unsigned>(gx) >= static_cast<unsigned>(w)) gx = reflect101(gx, w);
    const size_t at = static_cast<size_t>(gy) * w + gx;
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < CJ; ++c) word |= level(jimg[c * plane + at]) << (8 * c);
    if constexpr (G::kPackSrc) {
#pragma unroll
      for (int c = 0; c < CS; ++c) word |= level(simg[c * plane + at]) << (8 * (CJ + c));
    }
    const int slot = ty * pitch + col_offset(tx, seg);
    tile[slot] = word;
    if constexpr (G::kSplit) {
      uint32_t sword = 0;
#pragma unroll
      for (int c = 0; c < CS; ++c) sword |= level(simg[c * plane + at]) << (8 * c);
      stile[slot] = sword;
    }
  }
  for (int i = tid; i < (G::kEntries << kShift); i += G::kThreads) tab[i] = tables[i >> kShift];
  for (int i = tid; i <= r2; i += G::kThreads) sw[i] = tables[G::kEntries + i];
  __syncthreads();

  const int ox = x0 + threadIdx.x * kPix;
  const int oy = y0 + threadIdx.y;
  if (ox >= w || oy >= h) return;  // ragged tile: compute nothing, write nothing

  // pixel k of the thread is tile column kPix tx + radius + k of row ty +
  // radius; with kPix = 8 the column kPix tx + m sits at col_offset(m) +
  // tx of its row
  const uint32_t* crow = tile + (threadIdx.y + radius) * pitch + threadIdx.x;
  const float* base = tab + (tid & 31 & ((1 << kShift) - 1));
  uint32_t cen[kPix];
  float acc[kPix][CS], wsum[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    cen[k] = crow[col_offset(radius + k, seg)] & G::kJointMask;
#pragma unroll
    for (int c = 0; c < CS; ++c) acc[k][c] = 0.0f;
    wsum[k] = 0.0f;
  }

  // the disk row by row, dx ascending, in every thread alike (the plain
  // version's order); along a row a window of kWin columns slides 4 at a
  // time, so a word read from shared memory and its src levels serve all
  // kPix pixels, and so does a spatial weight (one address in the whole
  // warp: a broadcast)
  for (int dy = -radius; dy <= radius; ++dy) {
    const int dy2 = dy * dy;
    const int dxm = disk_half_width(r2 - dy2);
    const uint32_t* row = crow + dy * pitch;
    uint32_t q[kWin];
    float sv[kWin][CS];
    int dx = -dxm;
#pragma unroll
    for (int j = 0; j < kPix - 1; ++j) load<G, CS, SELF>(row, rows * pitch, radius + dx + j, seg, q[j], sv[j]);
    for (; dx + 3 <= dxm; dx += 4) {
#pragma unroll
      for (int j = kPix - 1; j < kWin; ++j)
        load<G, CS, SELF>(row, rows * pitch, radius + dx + j, seg, q[j], sv[j]);
      taps<CS, kShift, 4>(q, sv, sw + dy2, dx, base, cen, acc, wsum);
#pragma unroll
      for (int j = 0; j < kPix - 1; ++j) {
        q[j] = q[j + 4];
#pragma unroll
        for (int c = 0; c < CS; ++c) sv[j][c] = sv[j + 4][c];
      }
    }
    for (; dx <= dxm; ++dx) {
      load<G, CS, SELF>(row, rows * pitch, radius + dx + kPix - 1, seg, q[kPix - 1], sv[kPix - 1]);
      taps<CS, kShift, 1>(q, sv, sw + dy2, dx, base, cen, acc, wsum);
#pragma unroll
      for (int j = 0; j < kPix - 1; ++j) {
        q[j] = q[j + 1];
#pragma unroll
        for (int c = 0; c < CS; ++c) sv[j][c] = sv[j + 1][c];
      }
    }
  }
  float* o = out + blockIdx.z * CS * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (ox + k >= w) break;
#pragma unroll
    for (int c = 0; c < CS; ++c) o[c * plane + k] = acc[k][c] / wsum[k];
  }
}

template <int CJ, int CS, bool SELF, int kShift>
int launch(const float* joint, const float* src, float* out, const float* tables, int n,
           int h, int w, int radius, cudaStream_t stream) {
  using G = Geometry<CJ, CS, SELF>;
  const auto kernel = bilateral_joint_u8_kernel<CJ, CS, SELF, kShift>;
  const int smem = smem_bytes<CJ, CS, SELF, kShift>(radius);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + G::kTileW - 1) / G::kTileW, (h + kThreadsY - 1) / kThreadsY, n);
  const dim3 block(G::kThreadsX, kThreadsY);
  kernel<<<grid, block, smem, stream>>>(joint, src, out, tables, h, w, radius);
  return static_cast<int>(cudaGetLastError());
}

// Every pairing of the uint8 form on one table layout: cj, cs in {1, 3};
// self_guided takes cj = cs = 3.
template <int kShift>
int launch_any(int cj, int cs, int self_guided, const float* joint, const float* src,
               float* out, const float* tables, int n, int h, int w, int radius,
               cudaStream_t stream) {
  if (self_guided)
    return cj == 3 && cs == 3
               ? launch<3, 3, true, kShift>(joint, joint, out, tables, n, h, w, radius, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  if (cj == 1 && cs == 1)
    return launch<1, 1, false, kShift>(joint, src, out, tables, n, h, w, radius, stream);
  if (cj == 1 && cs == 3)
    return launch<1, 3, false, kShift>(joint, src, out, tables, n, h, w, radius, stream);
  if (cj == 3 && cs == 1)
    return launch<3, 1, false, kShift>(joint, src, out, tables, n, h, w, radius, stream);
  if (cj == 3 && cs == 3)
    return launch<3, 3, false, kShift>(joint, src, out, tables, n, h, w, radius, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace k6u8
