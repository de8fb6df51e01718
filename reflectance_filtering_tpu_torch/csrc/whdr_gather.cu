// K3 — WHDR point-pair gather (forward), and K8 — its backward scatter-add.
//
// Replaces reflectance_filtering_tpu/ops/whdr_gather_pallas.py::_fwd_kernel
// (via lightness_pairs_mxu / gather_pairs, dispatched from
// losses/whdr.py::_batch_lightness_pairs).
//
// What it computes: for each image b and comparison k,
//   l1[b, k] = plane[b, y1[b, k], x1[b, k]],  l2[b, k] = plane[b, y2[b, k], x2[b, k]]
// from f32 plane [B, H, W] and i32 indices [B, K] that the caller has
// already clipped into range.  The result is bitwise equal to plain
// indexing: it is a copy.
//
// What bounds it on an H100: launch latency.  At the main path's B = 32,
// K = 1,181 it moves ~0.9 MB (indices in, two values out, ~76k scattered
// 4-byte reads), a few microseconds of memory time.  The design is one
// thread per comparison reading its four indices coalesced and its two
// values through the read-only cache.  The TPU kernel's one-hot matrix
// products existed only because the TPU's gather scalarizes; a GPU gathers
// natively.  Indices are clamped into the plane once more in the kernel,
// which changes nothing for in-range input and keeps a caller's bad index
// from reading outside the plane.
//
// K8 replaces reflectance_filtering_tpu/ops/whdr_gather_pallas.py::_bwd_kernel
// (lightness_pairs_mxu's _bwd_rule): the scatter-add of the cotangents
// (g1, g2) [B, K] of (l1, l2) into dplane [B, H, W]; pixels that several
// points read get the sum of their cotangents.  The points are numbered
// j = 2k + point (comparison order, point 1 first), and each pixel's sum
// runs over its points in j order from 0.0f, with no float atomic, so the
// result is bitwise repeatable.  Its byte bound is small: writing the
// zeroed [20, 256, 256] plane of the training step is 5.2 MB (~1.6 us at
// 3.35 TB/s), the points ~0.6 MB.
//
// Design, chosen by shape (``sort_path``):
//   * up to kSortMax points an image (2K <= 16,384): each image's pixels
//     are cut into bands, as many blocks as fill the SMs once (6 at the
//     training step's 20 images, at most 8); a block gathers the points
//     of its band and sorts them by the key (pixel, j), a bitonic network
//     over the next power of two (32-bit keys while H*W << jbits < 2^32,
//     else 64-bit) with 8 keys a thread in registers (16 at 16,384); the
//     head of each run of one pixel sums the run's cotangents, which the
//     sort left in j order, and writes the pixel once.  At K = 1,181 with
//     the points spread over the image a band holds ~400 points, a
//     network of 45 steps over 512 keys (24 within a thread's registers,
//     20 warp shuffles, 1 through shared memory), instead of a compare of
//     every point with all 2,362 points of its image.  What bounds it:
//     the network's chain of dependent steps in two warps, and each
//     band's loads of every point; points crowded into one band cost that
//     band up to the whole image's network (78 steps over 4,096 keys, 10
//     of them through shared memory);
//   * above that: the first port's quadratic search, which needs no
//     shared memory that grows with K: one point a thread, 128 a block,
//     each compares its pixel with all 2K points of its image, four at a
//     time from shared memory staged in chunks; the first j that reads a
//     pixel sums every point that reads it, in j order.
// Both sum the same cotangents in the same order, so they agree bitwise.
//
// Beside K3: a batch's WHDR scores in one kernel, where no gradient is
// wanted (served batches, the training step's whdr_original metric).  It
// replaces no TPU kernel: it replaces the composition that
// losses/whdr.py::_whdr_per_image builds around K3 (the indices, the valid
// mask, the eps floor, the classification and the two sums, ~35 ATen
// launches on [B, K] arrays), which the host issued slower than the card
// ran it.  What it computes, row by row as the composition does:
//   num = (int) comparisons[b, K, 0]; row k is valid iff k < num;
//   a coordinate is clamp((int)(v * n), 0, n - 1), truncated as
//   .to(torch.int32) truncates (cvt.rzi, saturating, NaN -> 0), darker
//   likewise; l1, l2 the plane's values floored at float32 eps, NaN kept
//   (torch.maximum); the class is 1 if l2 / l1 > t, else 2 if l1 / l2 > t,
//   else 0, t the float32 threshold 1 + delta; err sums the weights of the
//   valid rows whose class differs from darker, wsum those of the valid
//   rows; the score is err / wsum (float32) when wsum > 0, else 0.
// What bounds it: nothing on the card; at B = 32, K = 1,181 it reads
// ~0.9 MB (the rows and ~76k scattered values), and one launch is its
// cost.  Design: a block an image, its threads striding over the rows with
// the sums in float64 registers, then a fixed tree (warp shuffles, then
// the warps' partials in shared memory), so the bits repeat from run to run
// and in a captured graph.  The float32 division and multiply are written
// as __fdiv_rn and __fmul_rn, so no compiler setting can change them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "device_attr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;          // points staged in shared memory
constexpr int kScatterThreads = 128;  // points per block, one per thread
constexpr int kSortMax = 16384;       // points an image that one block sorts
constexpr int kSortThreads = 1024;
constexpr int kMaxBands = 8;          // blocks an image on the sort path
constexpr int kScoreThreads = 512;    // threads of a WHDR-scores block

__global__ void __launch_bounds__(kThreads)
whdr_gather_kernel(const float* __restrict__ plane, const int* __restrict__ y1,
                   const int* __restrict__ x1, const int* __restrict__ y2,
                   const int* __restrict__ x2, float* __restrict__ l1,
                   float* __restrict__ l2, int h, int w, int k, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const float* img = plane + (i / k) * static_cast<int64_t>(h) * w;
  const int ya = min(max(y1[i], 0), h - 1);
  const int xa = min(max(x1[i], 0), w - 1);
  const int yb = min(max(y2[i], 0), h - 1);
  const int xb = min(max(x2[i], 0), w - 1);
  l1[i] = __ldg(img + static_cast<int64_t>(ya) * w + xa);
  l2[i] = __ldg(img + static_cast<int64_t>(yb) * w + xb);
}

// a normalized coordinate as the composition's pixel index: v * n in
// float32, truncated toward zero (saturating, NaN -> 0), clamped to the plane
__device__ __forceinline__ int score_coord(float v, int n) {
  return min(max(__float2int_rz(__fmul_rn(v, static_cast<float>(n))), 0), n - 1);
}

// a gathered lightness floored at float32 eps; NaN stays NaN (torch.maximum)
__device__ __forceinline__ float floor_eps(float l) {
  constexpr float kEps = 1.1920928955078125e-07f;
  return isnan(l) ? l : fmaxf(l, kEps);
}

// block b scores image b: out[b] = err / wsum over its valid rows, or 0
__global__ void __launch_bounds__(kScoreThreads)
whdr_scores_kernel(const float* __restrict__ plane, const float* __restrict__ comps,
                   float* __restrict__ out, int h, int w, int k, float threshold) {
  __shared__ double s_part[2][kScoreThreads / 32];
  const int64_t b = blockIdx.x;
  const float* img = plane + b * h * static_cast<int64_t>(w);
  const float* rows = comps + b * (k + 1) * 6;
  const int num = __float2int_rz(__ldg(rows + static_cast<int64_t>(k) * 6));
  const int valid = min(max(num, 0), k);
  double err = 0.0, wsum = 0.0;
  for (int i = threadIdx.x; i < valid; i += kScoreThreads) {
    const float* row = rows + static_cast<int64_t>(i) * 6;
    const int x1 = score_coord(__ldg(row), w);
    const int y1 = score_coord(__ldg(row + 1), h);
    const int x2 = score_coord(__ldg(row + 2), w);
    const int y2 = score_coord(__ldg(row + 3), h);
    const int darker = __float2int_rz(__ldg(row + 4));
    const float weight = __ldg(row + 5);
    const float l1 = floor_eps(__ldg(img + static_cast<int64_t>(y1) * w + x1));
    const float l2 = floor_eps(__ldg(img + static_cast<int64_t>(y2) * w + x2));
    const int alg = __fdiv_rn(l2, l1) > threshold ? 1 : (__fdiv_rn(l1, l2) > threshold ? 2 : 0);
    wsum += weight;
    if (alg != darker) err += weight;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    err += __shfl_down_sync(0xffffffffu, err, off);
    wsum += __shfl_down_sync(0xffffffffu, wsum, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_part[0][warp] = err;
    s_part[1][warp] = wsum;
  }
  __syncthreads();
  if (warp != 0) return;
  constexpr int kWarps = kScoreThreads / 32;
  err = lane < kWarps ? s_part[0][lane] : 0.0;
  wsum = lane < kWarps ? s_part[1][lane] : 0.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    err += __shfl_down_sync(0xffffffffu, err, off);
    wsum += __shfl_down_sync(0xffffffffu, wsum, off);
  }
  if (lane == 0) {
    const float e = static_cast<float>(err), s = static_cast<float>(wsum);
    out[b] = s > 0.0f ? __fdiv_rn(e, s) : 0.0f;
  }
}

// the pixel (y * w + x, clamped as the gather clamps) of point j of image
// row base, and that point's cotangent
__device__ __forceinline__ int point_pixel(const int* y1, const int* x1, const int* y2,
                                           const int* x2, int64_t base, int j, int h,
                                           int w) {
  const int64_t kk = base + (j >> 1);
  const int y = min(max((j & 1) ? y2[kk] : y1[kk], 0), h - 1);
  const int x = min(max((j & 1) ? x2[kk] : x1[kk], 0), w - 1);
  return y * w + x;
}

__device__ __forceinline__ float point_grad(const float* g1, const float* g2,
                                            int64_t base, int j) {
  return (j & 1) ? g2[base + (j >> 1)] : g1[base + (j >> 1)];
}

// the quadratic path: block (b, s) owns points [s * kScatterThreads,
// (s + 1) * kScatterThreads) of image b, one per thread; dplane was zeroed
// before the launch
__global__ void __launch_bounds__(kScatterThreads)
whdr_scatter_kernel(const int* __restrict__ y1, const int* __restrict__ x1,
                    const int* __restrict__ y2, const int* __restrict__ x2,
                    const float* __restrict__ g1, const float* __restrict__ g2,
                    float* __restrict__ dplane, int h, int w, int k) {
  extern __shared__ float4 smem4[];
  int* s_pix = reinterpret_cast<int*>(smem4);               // [kChunk]
  float* s_g = reinterpret_cast<float*>(s_pix + kChunk);    // [kChunk]
  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int npts = 2 * k;
  const int j = blockIdx.y * kScatterThreads + threadIdx.x;
  const int pix = j < npts ? point_pixel(y1, x1, y2, x2, base, j, h, w) : -1;
  bool first = j < npts;   // no earlier point reads pix (so far)
  float sum = 0.0f;
  for (int c0 = 0; c0 < npts; c0 += kChunk) {
    const int cn = min(kChunk, npts - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < cn; t += blockDim.x) {
      s_pix[t] = point_pixel(y1, x1, y2, x2, base, c0 + t, h, w);
      s_g[t] = point_grad(g1, g2, base, c0 + t);
    }
    for (int t = cn + threadIdx.x; t < (cn + 3) / 4 * 4; t += blockDim.x)
      s_pix[t] = -1;     // pad the last run of 4: matches no pixel
    __syncthreads();
    // four points per shared-memory read; a match is rare (the point
    // itself and its duplicates), so the common path is 4 compares
    for (int t = 0; first && t < cn; t += 4) {
      const int4 q = *reinterpret_cast<const int4*>(s_pix + t);
      const int hit = (q.x == pix) | ((q.y == pix) << 1) | ((q.z == pix) << 2) |
                      ((q.w == pix) << 3);
      for (int b = 0; hit != 0 && b < 4; ++b) {
        if (!((hit >> b) & 1)) continue;
        if (c0 + t + b < j) {
          first = false;
          break;
        }
        sum += s_g[t + b];
      }
    }
  }
  if (first) dplane[static_cast<int64_t>(blockIdx.x) * h * w + pix] = sum;
}

// min (keep_min) or max of two keys
template <typename Key>
__device__ __forceinline__ Key ordered(Key mine, Key other, bool keep_min) {
  return keep_min ? min(mine, other) : max(mine, other);
}

// the sort path: block (b, band) sorts the points of image b whose pixel
// lies in its band of pixels [band * HW / bands, (band + 1) * HW / bands)
// by the key (pixel << jbits) | j; dplane was zeroed before the launch.
// The band's c points are gathered into shared memory in any order (the
// sort restores one), padded with all ones (above every point's key) to
// pb, a power of two >= c and >= 32 E; threads t < pb / E (whole warps)
// hold keys [t E, (t + 1) E) in registers through a bitonic network: a
// stride below E pairs a thread's own registers, one below 32 E lanes of
// a warp (shuffles), a larger one threads of other warps (shared memory,
// striped: key e of thread t at e * pb / E + t, no bank conflict).  Where
// stride and size are >= E, which of a pair keeps the min depends on t
// alone (index bits >= E), so it is decided once a step, not per key.
// Shared memory, all of it dynamic (the launch opts in past 48 KB by the
// dynamic size alone, which is right only with no static shared memory):
// p keys (p >= 2K, so a band may hold every point), the 2K cotangents by
// j, then the band's count of points.
template <typename Key, int E>
__global__ void __launch_bounds__(kSortThreads)
whdr_scatter_sort_kernel(const int* __restrict__ y1, const int* __restrict__ x1,
                         const int* __restrict__ y2, const int* __restrict__ x2,
                         const float* __restrict__ g1, const float* __restrict__ g2,
                         float* __restrict__ dplane, int h, int w, int k, int jbits,
                         int p) {
  extern __shared__ float4 smem4[];
  Key* s_key = reinterpret_cast<Key*>(smem4);               // [p]
  float* s_g = reinterpret_cast<float*>(s_key + p);         // [2K]
  int& s_count = *reinterpret_cast<int*>(s_g + 2 * k);
  const int t = threadIdx.x;
  const int nt = blockDim.x;                                // p / E
  const int tE = t * E;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int npts = 2 * k;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int lo = static_cast<int>(hw * blockIdx.y / gridDim.y);
  const int hi = static_cast<int>(hw * (blockIdx.y + 1) / gridDim.y);
  if (t == 0) s_count = 0;
  __syncthreads();
  for (int j = t; j < npts; j += nt) {
    const int pix = point_pixel(y1, x1, y2, x2, base, j, h, w);
    if (pix < lo || pix >= hi) continue;
    s_key[atomicAdd(&s_count, 1)] = (static_cast<Key>(pix) << jbits) | static_cast<Key>(j);
    s_g[j] = point_grad(g1, g2, base, j);
  }
  __syncthreads();
  const int c = s_count;
  int pb = 32 * E;
  while (pb < c) pb <<= 1;
  for (int i = c + t; i < pb; i += nt) s_key[i] = ~Key(0);
  __syncthreads();
  const int na = pb / E;                                    // threads that sort
  const bool active = t < na;
  Key key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) key[e] = active ? s_key[tE + e] : Key(0);
  // ascending: in a run of `size` keys ordered up where bit `size` of the
  // index is 0, down elsewhere, the lower of a pair keeps the min going up
  for (int size = 2; size <= pb; size <<= 1) {
    const bool up = (tE & size) == 0;                       // for size >= E
    int stride = size >> 1;
    for (; stride >= 32 * E; stride >>= 1) {
      const int other = t ^ (stride / E);
      const bool keep_min = ((tE & stride) == 0) == up;
      __syncthreads();
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) s_key[e * na + t] = key[e];
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) key[e] = ordered(key[e], s_key[e * na + other], keep_min);
      }
    }
    if (!active) continue;
    for (; stride >= E; stride >>= 1) {
      const int lanes = stride / E;
      const bool keep_min = ((tE & stride) == 0) == up;
#pragma unroll
      for (int e = 0; e < E; ++e)
        key[e] = ordered(key[e], __shfl_xor_sync(0xffffffffu, key[e], lanes), keep_min);
    }
#pragma unroll
    for (int s = E / 2; s > 0; s >>= 1) {
      if (s >= size) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & s) continue;
        const bool lo_min = size < E ? (e & size) == 0 : up;
        const Key a = key[e];
        const Key b = key[e + s];
        key[e] = ordered(a, b, lo_min);
        key[e + s] = ordered(a, b, !lo_min);
      }
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_key[tE + e] = key[e];
  }
  __syncthreads();
  // each run's head sums the run in j order and writes its pixel once
  float* img = dplane + static_cast<int64_t>(blockIdx.x) * hw;
  const Key jmask = (Key(1) << jbits) - 1;
  for (int i = t; i < c; i += nt) {
    const Key pix = s_key[i] >> jbits;
    if (i > 0 && (s_key[i - 1] >> jbits) == pix) continue;
    float sum = 0.0f;
    for (int r = i; r < c && (s_key[r] >> jbits) == pix; ++r)
      sum += s_g[static_cast<int>(s_key[r] & jmask)];
    img[pix] = sum;
  }
}

// whether the sort path takes K comparisons an image: by shape only (the
// wrapper's ``sort_path`` mirrors it)
inline bool sort_path(int k) { return 2 * static_cast<int64_t>(k) <= kSortMax; }

template <typename Key, int E>
cudaError_t launch_sort_kernel(const int* y1, const int* x1, const int* y2, const int* x2,
                               const float* g1, const float* g2, float* dplane, int b,
                               int h, int w, int k, int jbits, int p, int bands,
                               cudaStream_t stream) {
  const int smem =
      static_cast<int>(p * sizeof(Key) + 2 * k * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(whdr_scatter_sort_kernel<Key, E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return err;
    }
  }
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>(bands));
  whdr_scatter_sort_kernel<Key, E><<<grid, p / E, smem, stream>>>(
      y1, x1, y2, x2, g1, g2, dplane, h, w, k, jbits, p);
  return cudaGetLastError();
}

// the sort path's launch: room for p keys a block (at least 32 E, so a
// warp is whole), 8 a thread up to 8,192 keys, 16 at 16,384; 32-bit keys
// while the pixel and j fit in them; each image's pixels in as many bands
// (blocks) as fill the SMs once, at most kMaxBands
template <typename Key>
cudaError_t launch_sort(const int* y1, const int* x1, const int* y2, const int* x2,
                        const float* g1, const float* g2, float* dplane, int b, int h,
                        int w, int k, int jbits, cudaStream_t stream) {
  int p = 256;
  while (p < 2 * k) p <<= 1;
  const int sms = rf::device_attr<cudaDevAttrMultiProcessorCount>(132);
  const int bands = std::max(1, std::min(kMaxBands, sms / std::max(b, 1)));
  return p <= 8 * kSortThreads
             ? launch_sort_kernel<Key, 8>(y1, x1, y2, x2, g1, g2, dplane, b, h, w, k,
                                          jbits, p, bands, stream)
             : launch_sort_kernel<Key, 16>(y1, x1, y2, x2, g1, g2, dplane, b, h, w, k,
                                           jbits, p, bands, stream);
}

}  // namespace

// plane [b, h, w] f32; y1, x1, y2, x2 [b, k] i32; l1, l2 [b, k] f32 (device).
// Returns the cudaError_t of the launch.
extern "C" int rf_whdr_gather(const float* plane, const int* y1, const int* x1,
                              const int* y2, const int* x2, float* l1, float* l2,
                              int b, int h, int w, int k, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(b) * k;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  whdr_gather_kernel<<<blocks, kThreads, 0, stream>>>(plane, y1, x1, y2, x2, l1,
                                                      l2, h, w, k, total);
  return static_cast<int>(cudaGetLastError());
}

// plane [b, h, w] f32 (h, w >= 1); comps [b, k + 1, 6] f32, the packed
// comparisons; out [b] f32 (device): each image's WHDR, its classes taken
// against the float32 threshold 1 + delta.  Returns the cudaError_t of the
// launch.
extern "C" int rf_whdr_scores(const float* plane, const float* comps, float* out, int b,
                              int h, int w, int k, float threshold, cudaStream_t stream) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  whdr_scores_kernel<<<static_cast<unsigned>(b), kScoreThreads, 0, stream>>>(
      plane, comps, out, h, w, k, threshold);
  return static_cast<int>(cudaGetLastError());
}

// y1, x1, y2, x2 [b, k] i32 (the gather's indices); g1, g2 [b, k] f32, the
// cotangents of l1, l2; dplane [b, h, w] f32 (device), zeroed here, then
// every pixel read by some point gets the sum of those points' cotangents.
// The path is taken by shape (``sort_path``); rf_whdr_scatter_quadratic
// below takes the quadratic search at any K, for tests and timings.
// Returns the cudaError_t of the memset or of the launch.
static int whdr_scatter(const int* y1, const int* x1, const int* y2, const int* x2,
                        const float* g1, const float* g2, float* dplane, int b, int h,
                        int w, int k, bool quadratic, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      dplane, 0, sizeof(float) * static_cast<int64_t>(b) * h * w, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset, so the error does not surface at a later launch
    return static_cast<int>(err);
  }
  if (static_cast<int64_t>(b) * k == 0) return static_cast<int>(cudaSuccess);
  if (!quadratic && sort_path(k)) {
    int jbits = 1;
    while ((1 << jbits) < 2 * k) ++jbits;
    const bool narrow = (static_cast<int64_t>(h) * w << jbits) < (int64_t(1) << 32);
    return static_cast<int>(
        narrow ? launch_sort<uint32_t>(y1, x1, y2, x2, g1, g2, dplane, b, h, w, k, jbits,
                                       stream)
               : launch_sort<unsigned long long>(y1, x1, y2, x2, g1, g2, dplane, b, h, w,
                                                 k, jbits, stream));
  }
  const dim3 grid(static_cast<unsigned>(b),
                  static_cast<unsigned>((2 * k + kScatterThreads - 1) / kScatterThreads));
  whdr_scatter_kernel<<<grid, kScatterThreads, kChunk * 8, stream>>>(
      y1, x1, y2, x2, g1, g2, dplane, h, w, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_whdr_scatter(const int* y1, const int* x1, const int* y2,
                               const int* x2, const float* g1, const float* g2,
                               float* dplane, int b, int h, int w, int k,
                               cudaStream_t stream) {
  return whdr_scatter(y1, x1, y2, x2, g1, g2, dplane, b, h, w, k, false, stream);
}

extern "C" int rf_whdr_scatter_quadratic(const int* y1, const int* x1, const int* y2,
                                         const int* x2, const float* g1,
                                         const float* g2, float* dplane, int b, int h,
                                         int w, int k, cudaStream_t stream) {
  return whdr_scatter(y1, x1, y2, x2, g1, g2, dplane, b, h, w, k, true, stream);
}
