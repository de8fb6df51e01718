// K6 — joint bilateral filter with OpenCV semantics, for every (joint, src)
// pairing the bilateral CLI and the width-sharded filter meet.
//
// Replaces, in reflectance_filtering_tpu/ops/bilateral_pallas.py:
//   * _kernel (joint_bilateral_planar_batched): float values, joint and src
//     distinct (the float form);
//   * _kernel_color_self (bilateral_color_self_batched) and its lane-packed
//     twin _kernel_color_self_packed: joint == src, three u8-valued planes
//     (cv2.bilateralFilter on a color image; the uint8 form, SELF);
//   * _kernel_packed_joint (bilateral_packed_joint_batched) and its
//     lane-packed twin _kernel_packed_joint_lanes: u8-valued joint != src
//     (the uint8 form).
// The TPU kernels pack two u8 streams into one f32 mantissa, and three
// images along the lanes, to cut the XLU rolls that bound them; Hopper
// reads shared memory by address and has no rolls, so neither carries over.
//
// For each output pixel p, over the disk of taps q with dx^2 + dy^2 <=
// radius^2 (an exact integer test, as K2), with BORDER_REFLECT_101 borders
// (reflect101, bilateral_common.cuh) and one divide at the end:
//   out_c(p) = sum_q w(q) S_c(q) / sum_q w(q),  D = sum_c |J_c(q) - J_c(p)|
// and, by the wrapper:
//   * the float form (values need not be integers):
//       w(q) = expf(D^2 gcc + (dx^2 + dy^2) gsc), gcc holding joint_reps^2;
//   * the uint8 form (inputs hold integers 0-255): cv2's table form,
//       w(q) = sw[dx^2 + dy^2] * cw[D],
//     cw[i] = f32(exp((joint_reps i)^2 gcc)) for i = 0 .. 255 cj (cv2's
//     color_weight, 766 entries at cj = 3) and sw[s] = f32(exp(s gsc)),
//     both computed in float64 on the host; no exp on the card.
// joint f32 [N, CJ, H, W], src f32 [N, CS, H, W] (unused when SELF: the
// src planes are the joint planes), out f32 [N, CS, H, W].
//
// What bounds it on an H100: the work per tap.  At sigma_s = 22 a pixel
// walks 3,409 taps; a call at 8 x 256x256 walks 1.79 G, and device memory
// sees each input value once per block.
//   * The float form (bilateral_joint_float_kernel): one block per 16 x 32
//     output tile holds the tile and its radius-wide halo of every plane as
//     floats in shared memory; all threads walk the disk row by row in the
//     same order, so no warp diverges; an expf (not __expf, as K2) per tap.
//   * The uint8 form (bilateral_joint_u8.cuh), K2's design with several
//     joint planes: a tap is one range-table load from shared memory (the
//     bound counts 32 such loads per SM per clock), a multiply, an FMA per
//     src plane and an add.  A pixel's joint bytes share one 32-bit tile
//     word, so D is one __vsadu4 of two words; its src bytes sit above them
//     (or, for cj = cs = 3 with joint != src, in a second word array).
//     Each thread computes 8 adjacent pixels of a row, sliding a window of
//     11 words 4 columns at a time, so one word read and its src bytes
//     widened to floats (a byte permute and a subtract) serve 8 pixels,
//     and the spatial weight is read at one address by the whole warp; a
//     tile row is stored as 8 runs of every 8th column, so that the lanes'
//     window loads, 8 columns apart, fall on consecutive words.  The range
//     table is held in 16 copies (cw[D] for lane l at word 16 D + l % 16, 49
//     KB at cj = 3): lanes l and l + 16 meet in a bank only when their sums
//     differ with the same parity.  scripts/measure_k6_table.py times it
//     against a copy per bank (98 KB, conflict-free) and one table; on 1/f
//     photos at 8 x 256x256 it was 1.2-1.5% faster than the copy per bank
//     in both main cases, twice; one table won the color-self case by 4-5%
//     and lost BF(reflectance, photo) by 15-16% (PERF.md).  With the 128 x
//     32 tile (76 KB of words at r = 33) one block of 16 warps fills an
//     SM, and 8 x 256x256 is 128 blocks: one wave on 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_common.cuh"
#include "bilateral_joint_u8.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;

template <int CJ, int CS>
__global__ void __launch_bounds__(kTileW * kTileH)
bilateral_joint_float_kernel(const float* __restrict__ joint,
                             const float* __restrict__ src, float* __restrict__ out,
                             int h, int w, int radius, float gcc, float gsc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
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
    for (int c = 0; c < CJ; ++c) tile[c * area + i] = jimg[c * plane + at];
#pragma unroll
    for (int c = 0; c < CS; ++c) tile[(CJ + c) * area + i] = simg[c * plane + at];
  }
  __syncthreads();

  const int ox = x0 + threadIdx.x;
  const int oy = y0 + threadIdx.y;
  if (ox >= w || oy >= h) return;  // ragged tile: compute nothing, write nothing

  const int center = (threadIdx.y + radius) * sw + threadIdx.x + radius;
  float cen[CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) cen[c] = tile[c * area + center];
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
      float diff = 0.0f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) diff += fabsf(tile[c * area + q] - cen[c]);
      const float wgt =
          expf(diff * diff * gcc + (fy2 + static_cast<float>(dx * dx)) * gsc);
#pragma unroll
      for (int c = 0; c < CS; ++c) acc[c] = fmaf(wgt, tile[(CJ + c) * area + q], acc[c]);
      wsum += wgt;
    }
  }
  float* o = out + blockIdx.z * CS * plane + static_cast<size_t>(oy) * w + ox;
#pragma unroll
  for (int c = 0; c < CS; ++c) o[c * plane] = acc[c] / wsum;
}

template <int CJ, int CS>
int launch_float(const float* joint, const float* src, float* out, int n, int h,
                 int w, int radius, float gcc, float gsc, cudaStream_t stream) {
  const int smem = (CJ + CS) * (kTileH + 2 * radius) * (kTileW + 2 * radius) *
                   static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bilateral_joint_float_kernel<CJ, CS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  const dim3 block(kTileW, kTileH);
  bilateral_joint_float_kernel<CJ, CS><<<grid, block, smem, stream>>>(
      joint, src, out, h, w, radius, gcc, gsc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// joint [n, cj, h, w], src [n, cs, h, w] (ignored when self_guided), out
// [n, cs, h, w], all f32 on the device; cj, cs in {1, 3}.  u8 = 1: the
// uint8 form (inputs holding integers 0-255), with tables = [cw (255 cj +
// 1) | sw (radius^2 + 1)] f32 on the device, joint_reps folded into cw;
// self_guided takes only cj = cs = 3 with u8 = 1 (the color self-guided
// filter).  u8 = 0: the float form, gcc including joint_reps^2 (tables
// unread).  Returns the cudaError_t of the attribute call or of the launch
// (cudaErrorInvalidValue for a pairing that has no instantiation); the
// wrapper keeps the shared memory within the 227 KB a block can take.
extern "C" int rf_bilateral_joint(const float* joint, const float* src,
                                  float* out, const float* tables, int n, int cj,
                                  int cs, int h, int w, int self_guided, int u8,
                                  int radius, float gcc, float gsc,
                                  cudaStream_t stream) {
  if (u8)
    return k6u8::launch_any<4>(cj, cs, self_guided, joint, src, out, tables, n, h, w,
                               radius, stream);
  if (self_guided) return static_cast<int>(cudaErrorInvalidValue);
  if (cj == 1 && cs == 1)
    return launch_float<1, 1>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  if (cj == 1 && cs == 3)
    return launch_float<1, 3>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  if (cj == 3 && cs == 1)
    return launch_float<3, 1>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  if (cj == 3 && cs == 3)
    return launch_float<3, 3>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
