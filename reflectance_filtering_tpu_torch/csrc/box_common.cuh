// Shared pieces of the separable box-sum kernels (K4 box_filter.cu, K5
// guided.cu, K9 guided_chain.cu): border maps by index, the generic column
// pass and K4's row staging.
//
// A window sum of length w = 2r + 1 is taken in two passes, each in
// float64 registers:
//   * the column pass gives one thread to each (plane, column, segment of
//     `seg` rows, col_seg below): it sums the first window in full, then
//     slides it down
//     the segment, adding the row that enters and subtracting the row that
//     leaves.  Neighbouring threads own neighbouring columns, so every load
//     of a warp is one coalesced row segment.  The window restarts at each
//     segment and the running sum is float64, so no drift builds up along
//     a column (every partial stays bounded by w * max|x|, the property the
//     TPU's doubling chain had);
//   * K4's row pass gives a block to each (plane, row, tile of kRowTile
//     output columns): the block stages the tile's row span and its
//     radius-wide halo in shared memory, and each thread sums its w taps
//     from there, so a warp reads 32 consecutive floats (no bank conflict).
//     The guided filters' row passes slide their windows instead
//     (guided_common.cuh, row_tile_means).
// Both passes map borders by index, so a radius as wide as the image or
// wider needs no padded copy.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Each source that includes this file gets its own copy (internal linkage),
// so the sources link into one library without clashing symbols.
namespace rf {
namespace {

constexpr int kColThreads = 128;  // columns per block of a column pass
constexpr int kColSeg = 128;      // rows per thread of a column pass, at most
constexpr int kColSegMin = 32;    // ... and at least
constexpr int kColBlocksPerSM = 4;
constexpr int kRowTile = 256;     // output columns (= threads) per row block

// Attribute A of the current device, read once per device; `fallback` (an
// H100's value) where it cannot be read.
template <cudaDeviceAttr A>
inline int device_attr(int fallback) {
  static int value[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();  // do not let it surface at a later launch
    return fallback;
  }
  if (value[dev] == 0 &&
      cudaDeviceGetAttribute(&value[dev], A, dev) != cudaSuccess) {
    cudaGetLastError();
    value[dev] = 0;
    return fallback;
  }
  return value[dev];
}

// Rows per thread of a column pass over `planes` planes of h x w: kColSeg,
// halved (to kColSegMin at least) while the grid would have fewer than
// kColBlocksPerSM blocks per SM.  A longer segment reads fewer rows per
// output (~(2r + 1) / seg + 2), a shorter one keeps the card full: on an
// H100 the 4K chain's moment passes (one plane group) take 64 rows, its 8K
// passes and the (a, b) sums 128, a served batch's 256x256 planes 32 or
// 64 (chip_smoke.py phase 6, scripts/measure_k9_passes.py).
inline int col_seg(int planes, int h, int w) {
  const long long cols = (w + kColThreads - 1) / kColThreads;
  const long long blocks =
      static_cast<long long>(kColBlocksPerSM) *
      device_attr<cudaDevAttrMultiProcessorCount>(132);
  int seg = kColSeg;
  while (seg > kColSegMin && cols * ((h + seg - 1) / seg) * planes < blocks)
    seg /= 2;
  return seg;
}

// BORDER_REFLECT (numpy's "symmetric"): period 2n, reflecting again and
// again when the radius exceeds n; n == 1 maps every index to 0.
__device__ __forceinline__ int reflect(int i, int n) {
  const int period = 2 * n;
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - 1 - i;
}

// BORDER_REFLECT_101 (numpy's "reflect"): period 2(n - 1); n == 1 -> 0.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__device__ __forceinline__ int border(int i, int n, bool r101) {
  return r101 ? reflect101(i, n) : reflect(i, n);
}

// Column pass over independent planes: out[p, y, x] = sum over t in
// [-r, r] of in[p, border(y + t), x], as float32 (the sum is float64 until
// the store).  Grid (ceil(w / kColThreads), ceil(h / seg), planes).
__global__ void __launch_bounds__(kColThreads)
col_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
               int w, int radius, bool r101, int seg) {
  const int x = blockIdx.x * kColThreads + threadIdx.x;
  const int y0 = blockIdx.y * seg;
  if (x >= w) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = in + blockIdx.z * plane + x;
  float* dst = out + blockIdx.z * plane + x;
  const int y1 = min(h, y0 + seg);
  double acc = 0.0;
  for (int t = y0 - radius; t <= y0 + radius; ++t)
    acc += static_cast<double>(src[static_cast<size_t>(border(t, h, r101)) * w]);
  for (int y = y0;;) {
    dst[static_cast<size_t>(y) * w] = static_cast<float>(acc);
    if (++y >= y1) break;
    acc += static_cast<double>(
        src[static_cast<size_t>(border(y + radius, h, r101)) * w]);
    acc -= static_cast<double>(
        src[static_cast<size_t>(border(y - radius - 1, h, r101)) * w]);
  }
}

// Stage `planes` planes (at stride `plane` floats from `row`, a row of
// width w) of the tile starting at column x0 into shared memory, with a
// radius-wide halo on each side: s[q * pitch + i] = row[q * plane +
// border(x0 - radius + i)].  All threads of the block take part; the
// caller synchronizes.
__device__ __forceinline__ void stage_rows(const float* __restrict__ row,
                                           size_t plane, int planes, int w,
                                           int x0, int radius, bool r101,
                                           float* s, int pitch) {
  const int span = min(kRowTile, w - x0) + 2 * radius;
  for (int q = 0; q < planes; ++q)
    for (int i = threadIdx.x; i < span; i += blockDim.x)
      s[q * pitch + i] = row[q * plane + border(x0 - radius + i, w, r101)];
}

// Sets the kernel's dynamic shared-memory limit to `bytes` where that
// exceeds the default 48 KB.  Returns the cudaError_t of that call (a tile
// too wide for the 227 KB a block may use on an H100 fails there).
template <typename Kernel>
inline cudaError_t smem_limit(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();  // do not let it surface later
  return err;
}

}  // namespace
}  // namespace rf
