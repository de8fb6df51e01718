// K2 — self-guided gray bilateral filter with OpenCV semantics.
//
// Replaces reflectance_filtering_tpu/ops/bilateral_pallas.py::
// _kernel_gray_self (via bilateral_gray_self_batched) and its lane-packed
// twin ::_kernel_gray_self_packed, which computes the same function.
//
// What it computes: cv2's bilateral filter with joint == src for a gray
// plane that stands for `reps` identical channels (the BF(CNN,CNN) case:
// the CNN's -r.png reads back as three equal channels).  For each pixel p,
// over the disk of taps q with dx^2 + dy^2 <= radius^2 (OpenCV's
// sqrt(...) > radius exclusion, as an exact integer test):
//   w(q) = exp(reps^2 * (x(q) - x(p))^2 * gcc + (dx^2 + dy^2) * gsc)
//   out(p) = sum_q w(q) x(q) / sum_q w(q)          (one divide at the end)
// with BORDER_REFLECT_101 borders.  Input f32 [N, H, W] in 0-255 units,
// output f32 [N, H, W].
//
// What bounds this kernel on an H100: the exp per tap.  At sigma_s = 22 the
// disk has 3,409 taps, so a pixel costs 3,409 expf calls plus ~5 FLOPs each,
// and device memory sees only 8 bytes per pixel.  The function needs less:
// its inputs are integer levels, so the weight is a 256-entry range table
// indexed by |x(q) - x(p)| times the tap's spatial weight, as in
// cv2.bilateralFilter (one table load, a multiply, an FMA and an add per
// tap); that form is a later change.  The design keeps everything
// else off that path: one block per 16 x 32 output tile loads the tile and
// its radius-wide halo into shared memory once (at r = 33, 82 x 98 x 4 B
// = 32 KB), so every tap is a conflict-free shared-memory read (a warp
// reads 32 consecutive floats of one row); the loop visits only the disk,
// row by row, so no weight is computed for the 24% of the square outside
// it; all threads of a block walk the taps in the same order, so no warp
// diverges.  expf, not the __expf intrinsic: the fast one is a later
// change, once it is shown to hold the uint8 gate.
//
// Borders are reflected by index, in the kernel (reflect101, shared with K6
// in bilateral_common.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;

__global__ void __launch_bounds__(kTileW * kTileH)
bilateral_gray_self_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int h, int w, int radius, float g2, float gsc) {
  extern __shared__ float tile[];
  const int sw = kTileW + 2 * radius;
  const int sh = kTileH + 2 * radius;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* img = x + blockIdx.z * plane;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < sw * sh; i += kTileW * kTileH) {
    const int ty = i / sw;
    const int tx = i - ty * sw;
    const int gy = reflect101(y0 - radius + ty, h);
    const int gx = reflect101(x0 - radius + tx, w);
    tile[i] = img[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  const int ox = x0 + threadIdx.x;
  const int oy = y0 + threadIdx.y;
  if (ox >= w || oy >= h) return;  // ragged tile: compute nothing, write nothing

  const float* c = tile + (threadIdx.y + radius) * sw + threadIdx.x + radius;
  const float center = *c;
  const int r2 = radius * radius;
  float acc = 0.0f;
  float wsum = 0.0f;
  for (int dy = -radius; dy <= radius; ++dy) {
    const int dxmax = disk_half_width(r2 - dy * dy);
    const float* row = c + dy * sw;
    const float fy2 = static_cast<float>(dy * dy);
    for (int dx = -dxmax; dx <= dxmax; ++dx) {
      const float v = row[dx];
      const float d = v - center;
      const float wgt = expf(d * d * g2 + (fy2 + static_cast<float>(dx * dx)) * gsc);
      acc = fmaf(wgt, v, acc);
      wsum += wgt;
    }
  }
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] = acc / wsum;
}

}  // namespace

// x, out [n, h, w] f32 (device); g2 = reps^2 * gcc.  Returns the
// cudaError_t of the attribute call or of the launch: a radius whose tile
// does not fit in a block's shared memory (227 KB on an H100, r > 108)
// fails there with cudaErrorInvalidValue.
extern "C" int rf_bilateral_gray_self(const float* x, float* out, int n, int h,
                                      int w, int radius, float g2, float gsc,
                                      cudaStream_t stream) {
  const int smem = (kTileH + 2 * radius) * (kTileW + 2 * radius) *
                   static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bilateral_gray_self_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error does not surface at a later launch
      return static_cast<int>(err);
    }
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  const dim3 block(kTileW, kTileH);
  bilateral_gray_self_kernel<<<grid, block, smem, stream>>>(x, out, h, w, radius,
                                                            g2, gsc);
  return static_cast<int>(cudaGetLastError());
}
