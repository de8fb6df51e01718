// K6 — joint bilateral filter with OpenCV semantics, for every (joint, src)
// pairing the bilateral CLI and the width-sharded filter meet.
//
// Replaces, in reflectance_filtering_tpu/ops/bilateral_pallas.py:
//   * _kernel (joint_bilateral_planar_batched): float values, joint and src
//     distinct (float storage);
//   * _kernel_color_self (bilateral_color_self_batched) and its lane-packed
//     twin _kernel_color_self_packed: joint == src, three u8-valued planes
//     (cv2.bilateralFilter on a color image; SELF, u8 storage);
//   * _kernel_packed_joint (bilateral_packed_joint_batched) and its
//     lane-packed twin _kernel_packed_joint_lanes: u8-valued joint != src
//     (u8 storage).
// The TPU kernels pack two u8 streams into one f32 mantissa, and three
// images along the lanes, to cut the XLU rolls that bound them; Hopper
// reads shared memory by address and has no rolls, so neither carries over.
// What they compute is one function, which this template computes.
//
// For each output pixel p, over the disk of taps q with dx^2 + dy^2 <=
// radius^2 (an exact integer test, as K2):
//   w(q)     = exp((sum_c |J_c(q) - J_c(p)|)^2 * gcc + (dx^2 + dy^2) * gsc)
//   out_c(p) = sum_q w(q) S_c(q) / sum_q w(q)        (one divide at the end)
// with BORDER_REFLECT_101 borders (reflect101, bilateral_common.cuh).  gcc
// already holds joint_reps^2, so a joint plane that stands for k identical
// channels weighs k |delta|.  joint f32 [N, CJ, H, W], src f32 [N, CS, H, W]
// (unused when SELF: the src planes are the joint planes), out f32
// [N, CS, H, W].
//
// What bounds it on an H100: as K2, the per-tap expf and arithmetic; at
// sigma_s = 22 a pixel walks 3,409 taps over CJ (+ CS) planes from shared
// memory, and device memory sees each input value once per block.  One
// block per 16 x 32 output tile holds the tile and its radius-wide halo of
// every plane in shared memory; all threads walk the disk row by row in the
// same order, so no warp diverges, and a warp's reads of a row are
// consecutive.  The u8 wrappers' inputs hold integers 0-255, so their tiles
// are stored as bytes (exact, 4x less shared memory: 24 KB for the color
// self case at r = 33, against 94 KB as floats) and widened back with an
// integer OR and one float subtract, off the conversion pipe.  expf, not
// __expf, as K2.  On those integer inputs the function needs no expf: the
// range weight is a 766-entry table indexed by sum_c |delta| (cv2's form),
// so the u8 instantiations' bound counts a table load per tap instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(__float2uint_rn(v));
}
__device__ __forceinline__ float get(float v) { return v; }
// 2^23 + b has b in its low mantissa bits: exact for any byte
__device__ __forceinline__ float get(uint8_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

template <int CJ, int CS, bool SELF, typename T>
__global__ void __launch_bounds__(kTileW * kTileH)
bilateral_joint_kernel(const float* __restrict__ joint,
                       const float* __restrict__ src, float* __restrict__ out,
                       int h, int w, int radius, float gcc, float gsc) {
  static_assert(!SELF || CS == CJ, "a self-guided filter has src == joint");
  constexpr int kSrc = SELF ? 0 : CJ;  // the first src plane in the tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int sw = kTileW + 2 * radius;
  const int area = (kTileH + 2 * radius) * sw;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* jimg = joint + blockIdx.z * CJ * plane;
  const float* simg = src + blockIdx.z * CS * plane;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < area; i += kTileW * kTileH) {
    const int ty = i / sw;
    const int tx = i - ty * sw;
    const size_t at = static_cast<size_t>(reflect101(y0 - radius + ty, h)) * w +
                      reflect101(x0 - radius + tx, w);
#pragma unroll
    for (int c = 0; c < CJ; ++c) put(tile + c * area + i, jimg[c * plane + at]);
    if constexpr (!SELF) {
#pragma unroll
      for (int c = 0; c < CS; ++c)
        put(tile + (CJ + c) * area + i, simg[c * plane + at]);
    }
  }
  __syncthreads();

  const int ox = x0 + threadIdx.x;
  const int oy = y0 + threadIdx.y;
  if (ox >= w || oy >= h) return;  // ragged tile: compute nothing, write nothing

  const int center = (threadIdx.y + radius) * sw + threadIdx.x + radius;
  float cen[CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) cen[c] = get(tile[c * area + center]);
  float acc[CS];
#pragma unroll
  for (int c = 0; c < CS; ++c) acc[c] = 0.0f;
  float wsum = 0.0f;
  const int r2 = radius * radius;
  for (int dy = -radius; dy <= radius; ++dy) {
    const int dxmax = disk_half_width(r2 - dy * dy);
    const int row = center + dy * sw;
    const float fy2 = static_cast<float>(dy * dy);
    for (int dx = -dxmax; dx <= dxmax; ++dx) {
      const int q = row + dx;
      float jv[CJ];
      float diff = 0.0f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        jv[c] = get(tile[c * area + q]);
        diff += fabsf(jv[c] - cen[c]);
      }
      const float wgt =
          expf(diff * diff * gcc + (fy2 + static_cast<float>(dx * dx)) * gsc);
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        if constexpr (SELF) {
          acc[c] = fmaf(wgt, jv[c], acc[c]);
        } else {
          acc[c] = fmaf(wgt, get(tile[(kSrc + c) * area + q]), acc[c]);
        }
      }
      wsum += wgt;
    }
  }
  float* o = out + blockIdx.z * CS * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int c = 0; c < CS; ++c) o[c * plane] = acc[c] / wsum;
}

template <int CJ, int CS, bool SELF, typename T>
int launch(const float* joint, const float* src, float* out, int n, int h,
           int w, int radius, float gcc, float gsc, cudaStream_t stream) {
  constexpr int kPlanes = SELF ? CJ : CJ + CS;
  const int smem = kPlanes * (kTileH + 2 * radius) * (kTileW + 2 * radius) *
                   static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bilateral_joint_kernel<CJ, CS, SELF, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  const dim3 block(kTileW, kTileH);
  bilateral_joint_kernel<CJ, CS, SELF, T><<<grid, block, smem, stream>>>(
      joint, src, out, h, w, radius, gcc, gsc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pair(int cj, int cs, const float* joint, const float* src,
                float* out, int n, int h, int w, int radius, float gcc,
                float gsc, cudaStream_t stream) {
  if (cj == 1 && cs == 1)
    return launch<1, 1, false, T>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  if (cj == 1 && cs == 3)
    return launch<1, 3, false, T>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  if (cj == 3 && cs == 1)
    return launch<3, 1, false, T>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  if (cj == 3 && cs == 3)
    return launch<3, 3, false, T>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// joint [n, cj, h, w], src [n, cs, h, w] (ignored when self_guided), out
// [n, cs, h, w], all f32 on the device; cj, cs in {1, 3}.  self_guided
// takes only cj = cs = 3 with u8 = 1 (the color self-guided filter);
// u8 = 1 stores the tile as bytes, exact for inputs that hold integers
// 0-255.  gcc includes joint_reps^2.  Returns the cudaError_t of the
// attribute call or of the launch (cudaErrorInvalidValue for a pairing
// that has no instantiation); the wrapper keeps the shared memory within
// the 227 KB a block can take.
extern "C" int rf_bilateral_joint(const float* joint, const float* src,
                                  float* out, int n, int cj, int cs, int h,
                                  int w, int self_guided, int u8, int radius,
                                  float gcc, float gsc, cudaStream_t stream) {
  if (self_guided) {
    if (u8 && cj == 3 && cs == 3)
      return launch<3, 3, true, uint8_t>(joint, joint, out, n, h, w, radius,
                                         gcc, gsc, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (u8)
    return launch_pair<uint8_t>(cj, cs, joint, src, out, n, h, w, radius, gcc,
                                gsc, stream);
  return launch_pair<float>(cj, cs, joint, src, out, n, h, w, radius, gcc,
                            gsc, stream);
}
