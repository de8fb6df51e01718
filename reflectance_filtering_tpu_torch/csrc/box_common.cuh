// Shared pieces of the separable box-sum kernels (K4 box_filter.cu, K5
// guided.cu, K9 guided_chain.cu): border maps by index, the generic column
// pass and the row window by prefix sums.
//
// A window sum of length w = 2r + 1 is taken in two passes, each in
// float64:
//   * the column pass gives one thread to each (plane, column, segment of
//     `seg` rows, col_seg below): it sums the first window in full, then
//     slides it down the segment, adding the row that enters and
//     subtracting the row that leaves.  Neighbouring threads own
//     neighbouring columns, so every load of a warp is one coalesced row
//     segment.  The window restarts at each segment and the running sum is
//     float64, so no drift builds up along a column (every partial stays
//     bounded by w * max|x|, the property the TPU's doubling chain had);
//   * K4's row pass and K5's fused kernels give a warp to each row (a
//     plane's row, for K5) and take every output's window as the
//     difference of two prefix sums of the row (warp_prefix, window_sum
//     below).  K5's four passes and K9 slide their row windows instead
//     (guided_common.cuh, row_tile_means).
// Both passes map borders by index, so a radius as wide as the image or
// wider needs no padded copy.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "device_attr.cuh"

// Each source that includes this file gets its own copy (internal linkage),
// so the sources link into one library without clashing symbols.
namespace rf {
namespace {

constexpr int kColThreads = 128;  // columns per block of a column pass
constexpr int kColSeg = 128;      // rows per thread of a column pass, at most
constexpr int kColSegMin = 32;    // ... and at least
constexpr int kColBlocksPerSM = 4;

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

// border(), with the modulo only for indices outside the frame (the fused
// kernels' row indices, nearly all inside).
__device__ __forceinline__ int border_in(int i, int n, bool r101) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n) ? i : border(i, n, r101);
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

// The row window by prefix sums (K4's row pass and K5's fused kernels).
// A warp turns one row of w float64 values c into its prefix sums P(0) =
// 0, P(j) = c(0) + .. + c(j - 1) (w + 1 doubles), lane l taking the
// row_seg(w) values from l row_seg(w) on: it sums them, a scan across the
// warp gives each lane the sum before its segment, and it writes its
// prefixes.  row_seg is odd, so the 32 lanes' loads, a segment apart,
// fall on distinct banks.  Every output's window sum is then a difference
// of two prefixes (window_sum), whatever the radius: the row extended by
// its border has period p = 2w (BORDER_REFLECT) or 2(w - 1)
// (BORDER_REFLECT_101), so a sum of its first a values is a whole number
// of periods' sums plus a prefix of one period, and the second half of a
// period runs over c backwards, a difference of two prefixes of c.
// Every term is a window or period sum, at most (2r + 1 + p) max|c|, so
// float64 keeps it exact to far below the means' float32 rounding.
__host__ __device__ __forceinline__ int row_seg(int w) { return ((w + 31) / 32) | 1; }

// P of one row (see above); all 32 lanes of the warp call it.  c may be
// pre + 1 (in place: each lane reads its own segment's values before it
// writes their prefixes), else the two may not overlap.
__device__ __forceinline__ void warp_prefix(const double* c, double* pre, int w, int seg,
                                            int lane) {
  const int x0 = lane * seg;
  const int x1 = min(w, x0 + seg);
  double sum = 0.0;
  for (int x = x0; x < x1; ++x) sum += c[x];
  double inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  double run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) {
    run = 0.0;
    pre[0] = 0.0;
  }
  for (int x = x0; x < x1; ++x) {
    run += c[x];
    pre[x + 1] = run;
  }
}

// The prefixes of one row of one or two planes (c0 -> p0 and, if `two`,
// c1 -> p1; element j of a row at j kStride), as warp_prefix computes
// them, each lane's segment (at most kSeg values) loaded into registers at
// once and the two planes' chains interleaved.  All 32 lanes call it.
template <int kSeg, int kStride = 1>
__device__ __forceinline__ void prefix_pair(const double* c0, double* p0, const double* c1,
                                            double* p1, bool two, int w, int seg, int lane) {
  const int x0 = lane * seg;
  const int n = min(seg, w - x0);  // <= 0 for lanes past the row
  double v0[kSeg], v1[kSeg];
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    v0[k] = k < n ? c0[(x0 + k) * kStride] : 0.0;
    v1[k] = two && k < n ? c1[(x0 + k) * kStride] : 0.0;
  }
  double s0 = 0.0, s1 = 0.0;  // adding the zeros past n is exact
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    s0 += v0[k];
    s1 += v1[k];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u0 = __shfl_up_sync(0xffffffffu, s0, d);
    const double u1 = __shfl_up_sync(0xffffffffu, s1, d);
    if (lane >= d) {
      s0 += u0;
      s1 += u1;
    }
  }
  double e0 = __shfl_up_sync(0xffffffffu, s0, 1);
  double e1 = __shfl_up_sync(0xffffffffu, s1, 1);
  if (lane == 0) {
    e0 = 0.0;
    e1 = 0.0;
    p0[0] = 0.0;
    if (two) p1[0] = 0.0;
  }
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    if (k < n) {
      e0 += v0[k];
      p0[(x0 + k + 1) * kStride] = e0;
      if (two) {
        e1 += v1[k];
        p1[(x0 + k + 1) * kStride] = e1;
      }
    }
  }
}

// Where the sum of the first a values of the extended row (a of any sign:
// for a < 0, minus the sum of values a .. -1) falls: `periods` whole
// periods, then P(j) (sign 1) or U - P(j) (sign 0), U = P(w) + P(w - o),
// o = 1 for BORDER_REFLECT_101.
struct PrefixAt {
  int periods, j;
  bool up;
};

__device__ __forceinline__ PrefixAt prefix_at(int a, int w, bool r101) {
  const int o = r101 ? 1 : 0;
  const int p = 2 * (w - o);
  PrefixAt at;
  if (p == 0) {  // one column under BORDER_REFLECT_101: every value is c(0)
    at.periods = 0;
    at.j = a;  // read as a * c(0) by window_sum
    at.up = true;
    return at;
  }
  const int m = a >= 0 ? a / p : -((p - 1 - a) / p);
  const int b = a - m * p;
  at.periods = m;
  at.up = b <= w;
  at.j = at.up ? b : 2 * w - o - b;
  return at;
}

// The window sum c(x - r) + .. + c(x + r) over the extended row, from its
// prefixes (P(j) at pre[j kStride]): lo = prefix_at(x - r), hi =
// prefix_at(x + r + 1).
template <int kStride = 1>
__device__ __forceinline__ double window_sum(const double* pre, int w, bool r101,
                                             const PrefixAt& lo, const PrefixAt& hi) {
  const int o = r101 ? 1 : 0;
  if (2 * (w - o) == 0) return static_cast<double>(hi.j - lo.j) * pre[kStride];
  double s = (hi.up ? pre[hi.j * kStride] : -pre[hi.j * kStride]) -
             (lo.up ? pre[lo.j * kStride] : -pre[lo.j * kStride]);
  const int turns = (hi.up ? 0 : 1) - (lo.up ? 0 : 1);  // the U terms
  const int periods = hi.periods - lo.periods;
  if (turns != 0 || periods != 0) {
    const double total = pre[w * kStride];
    const double u = total + pre[(w - o) * kStride];
    // a period's sum: U - P(o)
    s += turns * u + periods * (u - pre[o * kStride]);
  }
  return s;
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
