// Shared device code of the color-guide guided filters (K5 guided.cu, K9
// guided_chain.cu): the moment column pass, the row means, the 3x3
// cofactor solve and the final row pass q = mean(a) . I + mean(b).
//
// Per image n and src channel c, with mean() the normalized (2r+1)^2 box
// under BORDER_REFLECT:
//   mI_k = mean(I_k), V = mean(I I^T) - mI mI^T + eps Id, cov_k =
//   mean(I_k p) - mI_k mean(p), a = V^-1 cov, b = mean(p) - a . mI,
//   q = mean(a) . I + mean(b).
// Sums are float64 until the means; the products, the solve and the
// apply are float32.
#pragma once

#include "box_common.cuh"

namespace rf {
namespace {

constexpr int kGuidePlanes = 9;  // I0 I1 I2 and the 6 unique I_i I_j

// Column sums of the moment planes, laid out per image as
// [I0 I1 I2 | I0I0 I0I1 I0I2 I1I1 I1I2 I2I2 (GUIDE only) | p_0..p_{C-1} |
//  I0p_0 I1p_0 I2p_0 .. I0p_{C-1} I1p_{C-1} I2p_{C-1}].
// The products are formed in registers as the window slides and only
// their column sums are stored.  Grid (ceil(w / kColThreads),
// ceil(h / kColSeg), n).
template <int C, bool GUIDE>
__global__ void __launch_bounds__(kColThreads)
gf_moment_cols(const float* __restrict__ guide, const float* __restrict__ src,
               float* __restrict__ mom, int h, int w, int radius) {
  constexpr int G = GUIDE ? kGuidePlanes : 0;
  constexpr int P = G + 4 * C;
  const int x = blockIdx.x * kColThreads + threadIdx.x;
  const int y0 = blockIdx.y * kColSeg;
  if (x >= w) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* I = guide + blockIdx.z * 3 * plane + x;
  const float* p = src + blockIdx.z * C * plane + x;
  float* out = mom + blockIdx.z * P * plane + x;

  double acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0;
  // add (sign = 1) or remove (sign = -1) the products of image row y
  auto add_row = [&](int y, double sign) {
    const size_t o = static_cast<size_t>(reflect(y, h)) * w;
    const float i0 = I[o], i1 = I[plane + o], i2 = I[2 * plane + o];
    float v[P];
    if constexpr (GUIDE) {
      v[0] = i0; v[1] = i1; v[2] = i2;
      v[3] = i0 * i0; v[4] = i0 * i1; v[5] = i0 * i2;
      v[6] = i1 * i1; v[7] = i1 * i2; v[8] = i2 * i2;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float pc = p[c * plane + o];
      v[G + c] = pc;
      v[G + C + 3 * c] = i0 * pc;
      v[G + C + 3 * c + 1] = i1 * pc;
      v[G + C + 3 * c + 2] = i2 * pc;
    }
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] += sign * static_cast<double>(v[q]);
  };
  const int y1 = min(h, y0 + kColSeg);
  for (int t = y0 - radius; t <= y0 + radius; ++t) add_row(t, 1.0);
  for (int y = y0;;) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      out[q * plane + static_cast<size_t>(y) * w] = static_cast<float>(acc[q]);
    if (++y >= y1) break;
    add_row(y + radius, 1.0);
    add_row(y - radius - 1, -1.0);
  }
}

// Row sums of `planes` staged planes at this thread's column, as float32
// means (float64 sum times 1 / (2r + 1)^2).
template <int PLANES>
__device__ __forceinline__ void row_means(const float* s, int pitch,
                                          int radius, double inv_area,
                                          float* m) {
  double acc[PLANES];
#pragma unroll
  for (int q = 0; q < PLANES; ++q) acc[q] = 0.0;
  const float* v = s + threadIdx.x;
  for (int k = 0; k <= 2 * radius; ++k) {
#pragma unroll
    for (int q = 0; q < PLANES; ++q)
      acc[q] += static_cast<double>(v[q * pitch + k]);
  }
#pragma unroll
  for (int q = 0; q < PLANES; ++q) m[q] = static_cast<float>(acc[q] * inv_area);
}

// The cofactors c00 c01 c02 c11 c12 c22 of V (into cof) and 1 / det(V),
// from the guide's window means m = [mI0 mI1 mI2 | mean(I_i I_j), the six
// pairs in gf_moment_cols' order].
__device__ __forceinline__ float guide_cofactors(const float* m, float eps,
                                                 float* cof) {
  const float mi0 = m[0], mi1 = m[1], mi2 = m[2];
  const float rr = m[3] - mi0 * mi0 + eps;
  const float rg = m[4] - mi0 * mi1;
  const float rb = m[5] - mi0 * mi2;
  const float gg = m[6] - mi1 * mi1 + eps;
  const float gb = m[7] - mi1 * mi2;
  const float bb = m[8] - mi2 * mi2 + eps;
  cof[0] = gg * bb - gb * gb;
  cof[1] = gb * rb - rg * bb;
  cof[2] = rg * gb - gg * rb;
  cof[3] = rr * bb - rb * rb;
  cof[4] = rb * rg - rr * gb;
  cof[5] = rr * gg - rg * rg;
  return 1.0f / (rr * cof[0] + rg * cof[1] + rb * cof[2]);
}

// Last pass: q = mean(a) . I + mean(b) from the column sums of ab
// [N, 4C, H, W] = [a0 (C) | a1 (C) | a2 (C) | b (C)] (`abcol`).
// Grid (ceil(w / kRowTile), h, n), kRowTile threads.
template <int C>
__global__ void __launch_bounds__(kRowTile)
gf_apply_rows(const float* __restrict__ abcol, const float* __restrict__ guide,
              float* __restrict__ out, int h, int w, int radius,
              double inv_area) {
  extern __shared__ float s[];
  const int pitch = kRowTile + 2 * radius;
  const int x0 = blockIdx.x * kRowTile;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t row = static_cast<size_t>(blockIdx.y) * w;
  stage_rows(abcol + blockIdx.z * 4 * C * plane + row, plane, 4 * C, w, x0,
             radius, false, s, pitch);
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= w) return;
  float m[4 * C];
  row_means<4 * C>(s, pitch, radius, inv_area, m);
  const float* I = guide + blockIdx.z * 3 * plane + row + x;
  const float i0 = I[0], i1 = I[plane], i2 = I[2 * plane];
  float* o = out + blockIdx.z * C * plane + row + x;
#pragma unroll
  for (int c = 0; c < C; ++c)
    o[c * plane] = m[c] * i0 + m[C + c] * i1 + m[2 * C + c] * i2 + m[3 * C + c];
}

// 1 / (2r + 1)^2
inline double inv_area(int radius) {
  const double wd = 2.0 * radius + 1.0;
  return 1.0 / (wd * wd);
}

}  // namespace
}  // namespace rf
