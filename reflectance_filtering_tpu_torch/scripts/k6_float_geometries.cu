// K6's float form in other geometries and forms and as its first port,
// for scripts/measure_k6_float.py only (the product library does not build
// them: _build compiles csrc/*.cu).  Variants 1-4 run the product's kernel
// template (csrc/bilateral_joint_float.cuh), whose product is 4 pixels a
// thread and 4 groups splitting the disk's rows (512 threads) with the
// spatial term's log table in the exponent:
//   1: 4 pixels a thread, no split (128 threads);
//   2: 8 pixels a thread, 4 groups (256 threads);
//   3: 2 pixels a thread, 2 groups (512 threads);
//   4: the product's geometry with the factored weight, sw[s] times the
//      range factor's ex2 (a table of weights, not of exponents).
// Geometry 0 is the form's first port, kept here to time beside the
// product in one run: one pixel a thread (512 threads on the same 16 x 32
// tile), planes apart in shared memory, an expf of the unfactored
// exponent per tap.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/bilateral_common.cuh"
#include "../csrc/bilateral_joint_float.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;

template <int CJ, int CS>
__global__ void __launch_bounds__(kTileW * kTileH)
bilateral_joint_float_first_port_kernel(const float* __restrict__ joint,
                                        const float* __restrict__ src,
                                        float* __restrict__ out, int h, int w, int radius,
                                        float gcc, float gsc) {
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
int launch_first_port(const float* joint, const float* src, float* out, int n, int h, int w,
                      int radius, float gcc, float gsc, cudaStream_t stream) {
  const auto kernel = bilateral_joint_float_first_port_kernel<CJ, CS>;
  const int smem = (CJ + CS) * (kTileH + 2 * radius) * (kTileW + 2 * radius) *
                   static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  kernel<<<grid, dim3(kTileW, kTileH), smem, stream>>>(joint, src, out, h, w, radius, gcc,
                                                       gsc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As rf_bilateral_joint's float form (u8 = 0) on variant `geometry`
// (above): sw the spatial table (lsw for 1-3, sw for 4) and k the joint
// values' scale; gcc (times joint_reps^2) and gsc for the first port,
// which reads no table.
extern "C" int rf_k6_float_geometry(int geometry, const float* joint, const float* src,
                                    float* out, const float* sw, int n, int cj, int cs,
                                    int h, int w, int radius, float k, float gcc, float gsc,
                                    cudaStream_t stream) {
  switch (geometry) {
    case 0:
      if (cj == 1 && cs == 1)
        return launch_first_port<1, 1>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
      if (cj == 1 && cs == 3)
        return launch_first_port<1, 3>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
      if (cj == 3 && cs == 1)
        return launch_first_port<3, 1>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
      if (cj == 3 && cs == 3)
        return launch_first_port<3, 3>(joint, src, out, n, h, w, radius, gcc, gsc, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    case 1:
      return k6f::launch_any<4, 1, true>(cj, cs, joint, src, out, sw, n, h, w, radius, k, stream);
    case 2:
      return k6f::launch_any<8, 4, true>(cj, cs, joint, src, out, sw, n, h, w, radius, k, stream);
    case 3:
      return k6f::launch_any<2, 2, true>(cj, cs, joint, src, out, sw, n, h, w, radius, k, stream);
    case 4:
      return k6f::launch_any<4, 4, false>(cj, cs, joint, src, out, sw, n, h, w, radius, k,
                                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
