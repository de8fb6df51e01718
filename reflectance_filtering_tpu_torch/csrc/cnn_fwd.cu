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
// What bounds it on an H100: arithmetic.  Each pixel costs ~4.4k FMAs
// (96 + 4 * 1024 + 160) against 16 bytes of device memory traffic, so it is
// far on the compute side of the roofline.  The design keeps every FMA's
// weight operand free: the 4,513 weights sit in constant memory and every
// thread of a warp reads the same weight at the same time (a broadcast);
// with the loops fully unrolled each weight is a compile-time constant-bank
// operand of the FMA, so no load instruction is spent on it.  The 32-wide
// activations stay in registers, and the skip fuse is accumulated as the
// layers go (as _tile_math does), so no [., 160] concat exists anywhere.
// Plain f32 FMAs throughout: this is the precise=True scheme of the TPU
// kernel; its bf16 splits existed only for the TPU's matrix unit.
//
// Weight layout (flat f32 [4513], see ops/cnn_kernel.py::pack_weights):
//   layer 0: W [3][32] (in, out) at 0, bias [32] at 96
//   layer l = 1..4: W [32][32] at 128 + (l-1)*1056, bias [32] right after
//   fuse weights [160] at 4352 (layer-major), fuse bias at 4512.
// The weights are copied into constant memory on the launch stream before
// each launch, so launches on one stream may use different weights.
// Launches on different streams that run concurrently must share weights.
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
constexpr int kNumWeights = kFuseB + 1;                     // 4513
constexpr int kThreads = 256;

__constant__ float c_w[kNumWeights];

__device__ __forceinline__ float srgb_to_linear(float v) {
  // same branch and constants as srgb_to_rgb_jnp (utils/image.py)
  return v <= 0.04045f ? v / 12.92f
                       : powf(fmaxf((v + 0.055f) / 1.055f, 0.0f), 2.4f);
}

__global__ void __launch_bounds__(kThreads)
cnn_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
               int64_t hw, int srgb_input) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;  // ragged end of HW: masked, never padded
  const int64_t b = blockIdx.y;
  const float* xb = x + b * 3 * hw + p;

  float in[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = xb[c * hw];
    in[c] = srgb_input ? srgb_to_linear(v) : v;
  }

  float h[kFilters];
  float fuse = 0.0f;
#pragma unroll
  for (int o = 0; o < kFilters; ++o) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) s = fmaf(in[i], c_w[kLayer0W + i * kFilters + o], s);
    h[o] = fmaxf(s + c_w[kLayer0B + o], 0.0f);
    fuse = fmaf(h[o], c_w[kFuseW + o], fuse);
  }

#pragma unroll
  for (int l = 0; l < kMidLayers; ++l) {
    const int base = kMidBase + l * kMidStride;
    float g[kFilters];
#pragma unroll
    for (int o = 0; o < kFilters; ++o) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kFilters; ++i) s = fmaf(h[i], c_w[base + i * kFilters + o], s);
      g[o] = fmaxf(s + c_w[base + kFilters * kFilters + o], 0.0f);
    }
#pragma unroll
    for (int o = 0; o < kFilters; ++o) {
      h[o] = g[o];
      fuse = fmaf(g[o], c_w[kFuseW + (l + 1) * kFilters + o], fuse);
    }
  }

  const float z = fuse + c_w[kFuseB];
  out[b * hw + p] = 1.0f / (1.0f + expf(-z));
}

}  // namespace

// x [batch, 3, hw] f32, weights [4513] f32 (device), out [batch, hw] f32.
// Returns the cudaError_t of the weight copy or of the launch.
extern "C" int rf_cnn_fwd(const float* x, const float* weights, float* out,
                          int64_t batch, int64_t hw, int srgb_input,
                          cudaStream_t stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_w, weights, sizeof(float) * kNumWeights, 0, cudaMemcpyDeviceToDevice,
      stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset, so the error does not surface at a later launch
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  cnn_fwd_kernel<<<grid, kThreads, 0, stream>>>(x, out, hw, srgb_input);
  return static_cast<int>(cudaGetLastError());
}
