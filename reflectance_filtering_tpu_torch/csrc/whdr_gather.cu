// K3 — WHDR point-pair gather (forward).
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
// from reading outside the plane.  Forward only: the backward scatter-add
// (_bwd_kernel) belongs to the training slice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
