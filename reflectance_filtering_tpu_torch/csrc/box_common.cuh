// Shared pieces of the separable box-sum kernels (K4 box_filter.cu, K5
// guided.cu, K9 guided_chain.cu): border maps by index, the streamed
// column pass and the row window by prefix sums.
//
// A window sum of length 2r + 1 is taken in two passes, each in float64:
//   * the column pass (col_stream below) gives a warp to each item, a
//     strip of kStrip = 32 columns (a lane a column, so each input plane's
//     row of the strip is one coalesced 128 B line) over a segment of `seg`
//     rows, and streams the item's input rows through a ring in shared
//     memory; it sums the segment's first window in full, then slides it
//     down the segment, adding the row that enters and subtracting the row
//     that leaves.  The window restarts at each segment and the running
//     sum is float64, so no drift builds up along a column (every partial
//     stays bounded by (2r + 1) max|x|, the property the TPU's doubling
//     chain had);
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

// The streamed column pass.  The lane of column x in an item of rows y0 ..
// y0 + rows - 1 streams n = rows + 2r rows of its kIn input planes, image
// rows border(y0 - r + m) for m = 0 .. n - 1, and at step m adds row m's
// terms to its P float64 sums, subtracts row m - 2r - 1's (m > 2r) and
// stores output row y0 + m - 2r (m >= 2r).  Rows reach shared memory by
// cp.async, kAhead rows ahead of the step that reads them; each lane
// copies its own column's values, so it waits only for its own copies
// (cp.async.wait_group) and no barrier is needed.  The ring holds `depth`
// slots of a row's kIn x kStrip values:
//   * depth = 2r + 1 + kAhead where that fits kHoldBytes: the leaving row
//     is still in the ring (the slot the step then refills), so each
//     input row crosses device memory once a segment;
//   * else depth = kAhead, and a second ring of kAhead slots streams the
//     leaving rows again (past r = 47 on four input planes, 66 on three,
//     215 on one).
// Both dependencies of the sums' chain are then loads from shared memory
// of rows that arrived long before.  The sums are taken in the order the
// one-thread-a-column pass took them (the window's rows in order, then
// each step's entering row, then its leaving row).
constexpr int kStrip = 32;       // columns of an item: one warp, a lane each
constexpr int kAhead = 16;       // rows in flight per item
constexpr int kStep = 4;         // rows a wait covers, where they fill one
constexpr int kColSegMin = 32;   // rows an item, at least (by default)
// a ring that holds its window, at most: four an SM at r = 45 on four
// input planes (the 4K chain's moment pass)
constexpr int kHoldBytes = 56 * 1024;

// Launch shape of a column pass: grid (ceil(w / kStrip), ceil(h / seg),
// groups), kStrip threads, `smem` bytes of ring, `depth` slots.
struct ColLaunch {
  dim3 grid;
  int seg, depth, smem;
};

// The launch shape of a column pass whose items read `in_planes` input
// planes, over `groups` independent groups (the grid's z: images, or
// planes), each h x w.  seg > 0 fixes the rows an item; seg == 0 takes
// the product's: items as long as the card, filled once, allows (the
// rows over as many segments as the items that fit the SMs by shared
// memory leave to each strip), at least kColSegMin rows.  A longer
// segment re-reads fewer rows for its first window ((seg + 2r) / seg
// rows read an output row), and one wave leaves no tail.
inline ColLaunch col_launch(int in_planes, int groups, int h, int w,
                            int radius, int seg) {
  ColLaunch launch;
  const long long row = static_cast<long long>(in_planes) * kStrip * sizeof(float);
  const long long window = 2LL * radius + 1 + kAhead;
  const bool hold = window * row <= kHoldBytes;
  launch.depth = hold ? static_cast<int>(window) : kAhead;
  launch.smem = static_cast<int>((hold ? window : 2LL * kAhead) * row);
  const long long strips = (w + kStrip - 1) / kStrip;
  if (seg <= 0) {
    const long long per_sm_smem =
        device_attr<cudaDevAttrMaxSharedMemoryPerMultiprocessor>(233472) /
        (launch.smem + device_attr<cudaDevAttrReservedSharedMemoryPerBlock>(1024));
    const long long per_sm_blocks =
        device_attr<cudaDevAttrMaxBlocksPerMultiprocessor>(32);
    const long long items =
        device_attr<cudaDevAttrMultiProcessorCount>(132) *
        (per_sm_smem < per_sm_blocks ? per_sm_smem : per_sm_blocks);
    long long segs = items / (strips * groups);
    if (segs < 1) segs = 1;
    const long long rows = (h + segs - 1) / segs;
    seg = static_cast<int>(rows < kColSegMin ? kColSegMin : rows);
  }
  launch.seg = seg;
  launch.grid = dim3(static_cast<unsigned>(strips), (h + seg - 1) / seg, groups);
  return launch;
}

// Launches the column pass Kernel(args..., seg, depth) in col_launch's
// shape.  Its shared-memory limit is raised (smem_limit) once per device
// and larger size: the host launches a column pass several times a frame,
// at sizes the radius fixes.  Returns the cudaError_t of the attribute
// call or the launch.
template <auto Kernel, typename... Args>
inline cudaError_t launch_cols(int in_planes, int groups, int h, int w, int radius,
                               int seg, cudaStream_t stream, Args... args) {
  static int limit[64] = {0};  // bytes set so far, per device
  const ColLaunch c = col_launch(in_planes, groups, h, w, radius, seg);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();
    dev = -1;
  }
  if (dev < 0 || c.smem > limit[dev]) {
    const cudaError_t err = smem_limit(Kernel, c.smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0) limit[dev] = c.smem;
  }
  Kernel<<<c.grid, kStrip, c.smem, stream>>>(args..., c.seg, c.depth);
  return cudaGetLastError();
}

__device__ __forceinline__ void ring_copy(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src)
               : "memory");
}

__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of the calling thread's groups of copies
// are in flight.
template <int kPending>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One item of a column pass (see above) for the calling lane, launched as
// col_launch says: in[q] is input plane q of the item's group, out its
// first output plane (P planes `plane` floats apart), terms(v, t) the P
// values a row adds from its kIn input values v.  Each row's copies are
// one group: before rows m .. m + k - 1 are read, kAhead + m groups have
// been committed, so at most kAhead - k may still be in flight.
template <int kIn, int P, typename Terms>
__device__ __forceinline__ void col_stream(const float* const (&in)[kIn],
                                           float* __restrict__ out, size_t plane,
                                           int h, int w, int radius, bool r101,
                                           int seg, int depth, Terms terms) {
  extern __shared__ double ring_words[];
  const int x = blockIdx.x * kStrip + threadIdx.x;
  if (x >= w) return;
  const int y0 = blockIdx.y * seg;
  const int n = min(seg, h - y0) + 2 * radius;
  const bool hold = depth > kAhead;
  // this lane's column of the ring's slots (slot s, plane q at (s kIn + q)
  // kStrip), and of the leaving rows' (the ring itself where it holds the
  // window)
  float* ring = reinterpret_cast<float*>(ring_words) + threadIdx.x;
  float* leave = hold ? ring : ring + depth * kIn * kStrip;
  // copies stream row m into `slot` (and, without hold, the row leaving at
  // step m into the same slot of the leaving rows' ring): one group
  auto fetch = [&](int m, int slot) {
    if (m < n) {
      const size_t at = static_cast<size_t>(border_in(y0 - radius + m, h, r101)) * w + x;
#pragma unroll
      for (int q = 0; q < kIn; ++q)
        ring_copy(ring + (slot * kIn + q) * kStrip, in[q] + at);
      if (!hold && m > 2 * radius) {
        const size_t from =
            static_cast<size_t>(border_in(y0 - 3 * radius - 1 + m, h, r101)) * w + x;
#pragma unroll
        for (int q = 0; q < kIn; ++q)
          ring_copy(leave + (slot * kIn + q) * kStrip, in[q] + from);
      }
    }
    ring_commit();
  };
  auto load = [&](const float* from, int slot, double (&v)[kIn]) {
#pragma unroll
    for (int q = 0; q < kIn; ++q) v[q] = from[(slot * kIn + q) * kStrip];
  };
  // the slot after s, and the slot of the row kAhead rows after s's (where,
  // holding the window, the row 2r + 1 rows before s's is)
  auto next = [&](int s) { return s + 1 < depth ? s + 1 : 0; };
  auto ahead = [&](int s) { return s + kAhead < depth ? s + kAhead : s + kAhead - depth; };
  double acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0;
  auto add = [&](const double (&v)[kIn]) {
    double t[P];
    terms(v, t);
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] += t[q];
  };
  // row m enters and row m - 2r - 1 leaves; output row y0 + m - 2r
  auto slide = [&](int m, const double (&e)[kIn], const double (&l)[kIn]) {
    double te[P], tl[P];
    terms(e, te);
    terms(l, tl);
    float* o = out + static_cast<size_t>(y0 + m - 2 * radius) * w + x;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      acc[q] += te[q];
      acc[q] -= tl[q];
      o[q * plane] = static_cast<float>(acc[q]);
    }
  };
  for (int m = 0; m < kAhead; ++m) fetch(m, m);
  int m = 0, at = 0;  // the row read next, and its slot
  // the first window, rows 0 .. 2r, kStep rows a wait where they fill one
  for (; m + kStep <= 2 * radius + 1; m += kStep) {
    ring_wait<kAhead - kStep>();
    double v[kStep][kIn];
    int slot[kStep];
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      slot[i] = at;
      load(ring, at, v[i]);
      at = next(at);
    }
#pragma unroll
    for (int i = 0; i < kStep; ++i) add(v[i]);
#pragma unroll
    for (int i = 0; i < kStep; ++i) fetch(m + kAhead + i, ahead(slot[i]));
  }
  for (; m <= 2 * radius; ++m) {
    ring_wait<kAhead - 1>();
    double v[kIn];
    load(ring, at, v);
    add(v);
    fetch(m + kAhead, ahead(at));
    at = next(at);
  }
  {
    float* o = out + static_cast<size_t>(y0) * w + x;
#pragma unroll
    for (int q = 0; q < P; ++q) o[q * plane] = static_cast<float>(acc[q]);
  }
  // the slide, kStep rows a wait while they fill one, then row by row
  for (; m + kStep <= n; m += kStep) {
    ring_wait<kAhead - kStep>();
    double e[kStep][kIn], l[kStep][kIn];
    int fill[kStep];
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      fill[i] = ahead(at);
      load(ring, at, e[i]);
      load(leave, fill[i], l[i]);
      at = next(at);
    }
#pragma unroll
    for (int i = 0; i < kStep; ++i) slide(m + i, e[i], l[i]);
#pragma unroll
    for (int i = 0; i < kStep; ++i) fetch(m + kAhead + i, fill[i]);
  }
  for (; m < n; ++m) {
    ring_wait<kAhead - 1>();
    double e[kIn], l[kIn];
    const int fill = ahead(at);
    load(ring, at, e);
    load(leave, fill, l);
    slide(m, e, l);
    fetch(m + kAhead, fill);
    at = next(at);
  }
}

// Column pass over independent planes: out[p, y, x] = sum over t in
// [-r, r] of in[p, border(y + t), x], as float32 (the sum is float64 until
// the store).  Launch shape: col_launch(1, planes, h, w, radius, seg).
__global__ void __launch_bounds__(kStrip)
col_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
               int w, int radius, bool r101, int seg, int depth) {
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src[1] = {in + blockIdx.z * plane};
  col_stream<1, 1>(src, out + blockIdx.z * plane, plane, h, w, radius, r101, seg,
                   depth, [](const double (&v)[1], double (&t)[1]) { t[0] = v[0]; });
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

}  // namespace
}  // namespace rf
