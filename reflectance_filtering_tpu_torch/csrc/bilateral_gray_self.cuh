// K2's kernel template (bilateral_gray_self.cu holds the notes and the
// entry point): the self-guided gray bilateral over a tile of T levels,
// T = uint8_t (cv2's table form) or float (the expf form), with the range
// table's shared-memory layout and the block's geometry as parameters
// (RangeTable below is the layout the entry point launches).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bilateral_common.cuh"

namespace k2 {

constexpr int kThreadsX = 16;
constexpr int kLevels = 256;
constexpr int kDiffs = 2 * kLevels - 1;  // signed differences x(q) - x(p)

// The row pitch of the tile, in elements.  Uint8: 64 (mod 128) bytes, so
// that the two tile rows a warp reads (16 threads each) start 16 banks
// apart; float: odd, so that they start on different banks.
template <typename T, int kTileW>
__host__ __device__ __forceinline__ int tile_pitch(int radius) {
  if (std::is_same<T, uint8_t>::value)
    return (kTileW + 2 * radius - 64 + 127) / 128 * 128 + 64;
  return kTileW + 2 * radius + 1;
}

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// The range table replicated per bank: lane l of a warp finds cw[|d|] for
// the signed difference d at word 32 (d + 255) + l, always in bank l, so a
// warp's 32 lookups are one conflict-free shared-memory wavefront whatever
// the levels, and a lookup is one shift-and-add from a per-pixel base (511
// x 32 x 4 B = 64 KB per block).
struct RangeTable {
  static constexpr int kFloats = kDiffs * 32;
  __device__ static void fill(float* tab, const float* cw, int tid, int nthreads) {
    for (int i = tid; i < kFloats; i += nthreads) tab[i] = cw[abs((i >> 5) - (kLevels - 1))];
  }
  struct Cursor {
    const float* base;
    __device__ Cursor() {}
    __device__ Cursor(const float* tab, int center)
        : base(tab + ((threadIdx.y * kThreadsX + threadIdx.x) & 31) +
               ((kLevels - 1) - center) * 32) {}
    // one tap of value v (vf as float) at spatial weight sp
    __device__ void tap(int v, float vf, float sp, float& acc, float& wsum) const {
      const float wgt = sp * base[v << 5];
      acc = fmaf(wgt, vf, acc);
      wsum += wgt;
    }
  };
};

// The taps of one disk row dy at dx .. dx + kSteps - 1 for the thread's kPix
// pixels; vi, vf hold the tile values at columns dx .. dx + kSteps + kPix -
// 2 from the first pixel's own column.
template <typename T, typename Table, int kSteps, int kPix, bool kGlobalSw>
__device__ __forceinline__ void taps(const int* vi, const float* vf, int dx, int dy2,
                                     const float* sw, const typename Table::Cursor* cur,
                                     const float* cen, float g2, float gsc, float* acc,
                                     float* wsum) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int s = dy2 + (dx + j) * (dx + j);
    if constexpr (std::is_same<T, uint8_t>::value) {
      // the same address in every thread: a broadcast
      const float sp = spatial<kGlobalSw>(sw, s);
#pragma unroll
      for (int k = 0; k < kPix; ++k) cur[k].tap(vi[j + k], vf[j + k], sp, acc[k], wsum[k]);
    } else {
      const float sp = static_cast<float>(s) * gsc;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float d = vf[j + k] - cen[k];
        const float wgt = expf(d * d * g2 + sp);
        acc[k] = fmaf(wgt, vf[j + k], acc[k]);
        wsum[k] += wgt;
      }
    }
  }
}

// One disk row dy (its taps dx ascending) for the thread's kPix pixels; row
// points at the tile element of the row at pixel 0's own column.  Along the
// row a window of kPix + 3 tile values slides 4 columns at a time, so each
// value read from shared memory serves kPix pixels.
template <typename T, typename Table, int kPix, bool kGlobalSw>
__device__ __forceinline__ void disk_row(const T* row, int dy, int r2, const float* sw,
                                         const typename Table::Cursor* cur, const float* cen,
                                         float g2, float gsc, float* acc, float* wsum) {
  constexpr int kWin = kPix + 3;
  const int dy2 = dy * dy;
  const int dxm = disk_half_width(r2 - dy2);
  int vi[kWin];
  float vf[kWin];
  int dx = -dxm;
#pragma unroll
  for (int k = 0; k < kPix - 1; ++k) {
    vi[k] = static_cast<int>(row[dx + k]);
    vf[k] = get(row[dx + k]);
  }
  for (; dx + 3 <= dxm; dx += 4) {
#pragma unroll
    for (int k = kPix - 1; k < kWin; ++k) {
      vi[k] = static_cast<int>(row[dx + k]);
      vf[k] = get(row[dx + k]);
    }
    taps<T, Table, 4, kPix, kGlobalSw>(vi, vf, dx, dy2, sw, cur, cen, g2, gsc, acc, wsum);
#pragma unroll
    for (int k = 0; k < kPix - 1; ++k) {
      vi[k] = vi[k + 4];
      vf[k] = vf[k + 4];
    }
  }
  for (; dx <= dxm; ++dx) {
    vi[kPix - 1] = static_cast<int>(row[dx + kPix - 1]);
    vf[kPix - 1] = get(row[dx + kPix - 1]);
    taps<T, Table, 1, kPix, kGlobalSw>(vi, vf, dx, dy2, sw, cur, cen, g2, gsc, acc, wsum);
#pragma unroll
    for (int k = 0; k < kPix - 1; ++k) {
      vi[k] = vi[k + 1];
      vf[k] = vf[k + 1];
    }
  }
}

// x, out [n, h, w]; tables (T = uint8_t only) = [cw[0..255] | sw[0..r^2]]
// f32, cw indexed by |d|, sw by dx^2 + dy^2.  Block (kThreadsX, kThreadsY)
// computes a kThreadsY x (kThreadsX kPix) tile of plane blockIdx.z, each
// thread kPix adjacent pixels of a row.  Table is the uint8 form's range
// table layout (the float form reads none).
template <typename T, typename Table, int kPix, int kThreadsY>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
bilateral_gray_self_kernel(const T* __restrict__ x, float* __restrict__ out,
                           const float* __restrict__ tables, int h, int w, int radius,
                           float g2, float gsc) {
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  constexpr int kTileW = kThreadsX * kPix;
  constexpr int kTileH = kThreadsY;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = tile_pitch<T, kTileW>(radius);
  const int cols = kTileW + 2 * radius;
  const int rows = kTileH + 2 * radius;
  const int r2 = radius * radius;
  T* tile = reinterpret_cast<T*>(smem);
  float* sw = reinterpret_cast<float*>(smem + align16(rows * pitch * static_cast<int>(sizeof(T))));
  float* tab = sw + align16((r2 + 1) * 4) / 4;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const T* img = x + blockIdx.z * plane;

  const int nthreads = kThreadsX * kThreadsY;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < rows * cols; i += nthreads) {
    const int ty = i / cols;
    const int tx = i - ty * cols;
    int gy = y0 - radius + ty;
    int gx = x0 - radius + tx;
    if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
    if (static_cast<unsigned>(gx) >= static_cast<unsigned>(w)) gx = reflect101(gx, w);
    tile[ty * pitch + tx] = img[static_cast<size_t>(gy) * w + gx];
  }
  if constexpr (kU8) {
    for (int i = tid; i <= r2; i += nthreads) sw[i] = tables[kLevels + i];
    Table::fill(tab, tables, tid, nthreads);
  }
  __syncthreads();

  const int ox = x0 + threadIdx.x * kPix;
  const int oy = y0 + threadIdx.y;
  if (ox >= w || oy >= h) return;  // ragged tile: compute nothing, write nothing

  // c[k] is pixel k's tile element (at dx = dy = 0)
  const T* c = tile + (threadIdx.y + radius) * pitch + threadIdx.x * kPix + radius;
  float cen[kPix], acc[kPix], wsum[kPix];
  typename Table::Cursor cur[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    cen[k] = get(c[k]);
    if constexpr (kU8) cur[k] = typename Table::Cursor(tab, c[k]);
    acc[k] = 0.0f;
    wsum[k] = 0.0f;
  }

  // the disk row by row, dx ascending, in every thread alike
  for (int dy = -radius; dy <= radius; ++dy)
    disk_row<T, Table, kPix, false>(c + dy * pitch, dy, r2, sw, cur, cen, g2, gsc, acc, wsum);
  float* o = out + blockIdx.z * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    if (ox + k < w) o[k] = acc[k] / wsum[k];
}

// The kernel for a disk whose rows do not all fit one block with the tile:
// the rows are taken in bands of `band` disk rows, each staging only the
// tile rows it reads (band + kThreadsY - 1), the spatial weights read from
// device memory; a pixel's taps keep the order above (dy, then dx
// ascending), so its sums are the one-band kernel's.
template <typename T, typename Table, int kPix, int kThreadsY>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
bilateral_gray_self_banded_kernel(const T* __restrict__ x, float* __restrict__ out,
                                  const float* __restrict__ tables, int h, int w, int radius,
                                  int band, float g2, float gsc) {
  constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  constexpr int kTileW = kThreadsX * kPix;
  constexpr int kTileH = kThreadsY;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = tile_pitch<T, kTileW>(radius);
  const int cols = kTileW + 2 * radius;
  const int r2 = radius * radius;
  T* tile = reinterpret_cast<T*>(smem);
  float* tab = reinterpret_cast<float*>(
      smem + align16((band + kTileH - 1) * pitch * static_cast<int>(sizeof(T))));
  const float* sw = kU8 ? tables + kLevels : nullptr;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const T* img = x + blockIdx.z * plane;
  const int nthreads = kThreadsX * kThreadsY;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if constexpr (kU8) Table::fill(tab, tables, tid, nthreads);

  const int ox = x0 + threadIdx.x * kPix;
  const int oy = y0 + threadIdx.y;
  const bool active = ox < w && oy < h;  // a ragged tile's other threads stage only
  // the pixels' own values, from device memory (reflected past the frame)
  const size_t crow = static_cast<size_t>(oy < h ? oy : reflect101(oy, h)) * w;
  float cen[kPix], acc[kPix], wsum[kPix];
  typename Table::Cursor cur[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int gx = ox + k < w ? ox + k : reflect101(ox + k, w);
    const T v = img[crow + gx];
    cen[k] = get(v);
    if constexpr (kU8) cur[k] = typename Table::Cursor(tab, v);
    acc[k] = 0.0f;
    wsum[k] = 0.0f;
  }

  for (int b0 = -radius; b0 <= radius; b0 += band) {
    const int b1 = min(radius + 1, b0 + band);
    const int rows = b1 - b0 + kTileH - 1;
    __syncthreads();  // the previous band read (and the range table filled)
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int ty = i / cols;
      const int tx = i - ty * cols;
      int gy = y0 + b0 + ty;
      int gx = x0 - radius + tx;
      if (static_cast<unsigned>(gy) >= static_cast<unsigned>(h)) gy = reflect101(gy, h);
      if (static_cast<unsigned>(gx) >= static_cast<unsigned>(w)) gx = reflect101(gx, w);
      tile[ty * pitch + tx] = img[static_cast<size_t>(gy) * w + gx];
    }
    __syncthreads();
    if (active) {
      // the tile row of disk row dy is threadIdx.y + dy - b0
      const T* c = tile + threadIdx.x * kPix + radius;
      for (int dy = b0; dy < b1; ++dy)
        disk_row<T, Table, kPix, true>(c + (threadIdx.y + dy - b0) * pitch, dy, r2, sw, cur,
                                       cen, g2, gsc, acc, wsum);
    }
  }
  if (!active) return;
  float* o = out + blockIdx.z * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    if (ox + k < w) o[k] = acc[k] / wsum[k];
}

// The dynamic shared memory of a block: the tile, and for uint8 levels
// the spatial weights and the range table.
template <typename T, typename Table, int kPix, int kThreadsY>
int smem_bytes(int radius) {
  const int tile = (kThreadsY + 2 * radius) * tile_pitch<T, kThreadsX * kPix>(radius) *
                   static_cast<int>(sizeof(T));
  if (!std::is_same<T, uint8_t>::value) return tile;
  return align16(tile) + align16((radius * radius + 1) * 4) + Table::kFloats * 4;
}

template <typename T, typename Table, int kPix, int kThreadsY>
int launch(const void* x, float* out, const float* tables, int n, int h, int w, int radius,
           float g2, float gsc, cudaStream_t stream) {
  const auto kernel = bilateral_gray_self_kernel<T, Table, kPix, kThreadsY>;
  const int smem = smem_bytes<T, Table, kPix, kThreadsY>(radius);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return static_cast<int>(err);
    }
  }
  constexpr int kTileW = kThreadsX * kPix;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kThreadsY - 1) / kThreadsY, n);
  const dim3 block(kThreadsX, kThreadsY);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(x), out, tables, h, w, radius,
                                        g2, gsc);
  return static_cast<int>(cudaGetLastError());
}

// The banded kernel's shared memory for bands of `band` disk rows: the
// band's tile rows, and for uint8 levels the range table (the spatial
// weights stay in device memory).
template <typename T, typename Table, int kPix, int kThreadsY>
int banded_smem_bytes(int radius, int band) {
  const int tile = (band + kThreadsY - 1) * tile_pitch<T, kThreadsX * kPix>(radius) *
                   static_cast<int>(sizeof(T));
  if (!std::is_same<T, uint8_t>::value) return tile;
  return align16(tile) + Table::kFloats * 4;
}

// Disk rows per band: the whole disk (2r + 1) where smem_bytes fits
// kSmemLimit (the one-band kernel runs), else, for the banded kernel, the
// most rows whose banded_smem_bytes fits it, evened out over the bands
// (even_band); 0 where not one row fits.  ops/bilateral_kernel.py::
// band_rows mirrors it.
template <typename T, typename Table, int kPix, int kThreadsY>
int band_rows(int radius) {
  const int disk = 2 * radius + 1;
  if (smem_bytes<T, Table, kPix, kThreadsY>(radius) <= kSmemLimit) return disk;
  const int row = tile_pitch<T, kThreadsX * kPix>(radius) * static_cast<int>(sizeof(T));
  int most = kSmemLimit / row - (kThreadsY - 1);
  while (most > 0 && banded_smem_bytes<T, Table, kPix, kThreadsY>(radius, most) > kSmemLimit)
    --most;
  return even_band(disk, most, 1);
}

// Any radius: the one-band kernel where its disk fits, else the banded one
// (cudaErrorInvalidValue where not even one disk row fits a block).
template <typename T, typename Table, int kPix, int kThreadsY>
int launch_any_radius(const void* x, float* out, const float* tables, int n, int h, int w,
                      int radius, float g2, float gsc, cudaStream_t stream) {
  if (smem_bytes<T, Table, kPix, kThreadsY>(radius) <= kSmemLimit)
    return launch<T, Table, kPix, kThreadsY>(x, out, tables, n, h, w, radius, g2, gsc, stream);
  const int band = band_rows<T, Table, kPix, kThreadsY>(radius);
  if (band < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = bilateral_gray_self_banded_kernel<T, Table, kPix, kThreadsY>;
  const int smem = banded_smem_bytes<T, Table, kPix, kThreadsY>(radius, band);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  constexpr int kTileW = kThreadsX * kPix;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kThreadsY - 1) / kThreadsY, n);
  const dim3 block(kThreadsX, kThreadsY);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(x), out, tables, h, w, radius,
                                        band, g2, gsc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k2
