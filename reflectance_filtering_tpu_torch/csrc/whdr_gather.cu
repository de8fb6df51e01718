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
// points read get the sum of their cotangents.  What bounds it: launch
// latency and a small quadratic search.  Writing the zeroed [20, 256, 256]
// plane of the training step is 5.2 MB (~1.6 us at 3.35 TB/s).  The sum is
// deterministic, with no float atomic: the points are numbered j = 2k + point
// (comparison order, point 1 first); the first j that reads a pixel sums the
// cotangents of every point that reads it, in j order, and writes the pixel
// once; every other point writes nothing.  Finding the duplicates compares
// each point with all 2K points of its image (2,362 at K = 1,181: 5.6 M
// compares per image), four at a time from shared memory, staged in chunks,
// one point per thread and 19 blocks per image at K = 1,181.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;          // points staged in shared memory
constexpr int kScatterThreads = 128;  // points per block, one per thread

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

// block (s, b) owns points [s * kScatterThreads, (s + 1) * kScatterThreads)
// of image b, one per thread; dplane was zeroed before the launch
__global__ void __launch_bounds__(kScatterThreads)
whdr_scatter_kernel(const int* __restrict__ y1, const int* __restrict__ x1,
                    const int* __restrict__ y2, const int* __restrict__ x2,
                    const float* __restrict__ g1, const float* __restrict__ g2,
                    float* __restrict__ dplane, int h, int w, int k) {
  extern __shared__ float4 smem4[];
  int* s_pix = reinterpret_cast<int*>(smem4);               // [kChunk]
  float* s_g = reinterpret_cast<float*>(s_pix + kChunk);    // [kChunk]
  const int64_t base = static_cast<int64_t>(blockIdx.y) * k;
  const int npts = 2 * k;
  const int j = blockIdx.x * kScatterThreads + threadIdx.x;
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
  if (first) dplane[static_cast<int64_t>(blockIdx.y) * h * w + pix] = sum;
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

// y1, x1, y2, x2 [b, k] i32 (the gather's indices); g1, g2 [b, k] f32, the
// cotangents of l1, l2; dplane [b, h, w] f32 (device), zeroed here, then
// every pixel read by some point gets the sum of those points' cotangents.
// Returns the cudaError_t of the memset or of the launch.
extern "C" int rf_whdr_scatter(const int* y1, const int* x1, const int* y2,
                               const int* x2, const float* g1, const float* g2,
                               float* dplane, int b, int h, int w, int k,
                               cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      dplane, 0, sizeof(float) * static_cast<int64_t>(b) * h * w, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset, so the error does not surface at a later launch
    return static_cast<int>(err);
  }
  if (static_cast<int64_t>(b) * k == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((2 * k + kScatterThreads - 1) / kScatterThreads),
                  static_cast<unsigned>(b));
  whdr_scatter_kernel<<<grid, kScatterThreads, kChunk * 8, stream>>>(
      y1, x1, y2, x2, g1, g2, dplane, h, w, k);
  return static_cast<int>(cudaGetLastError());
}
