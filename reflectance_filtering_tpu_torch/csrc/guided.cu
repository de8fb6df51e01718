// K5 — guided filter with a color guide (He et al. 2013, OpenCV ximgproc
// semantics: BORDER_REFLECT box means, eps in guide units, the symmetric
// 3x3 system solved by its cofactors).
//
// Replaces reflectance_filtering_tpu/ops/guided_mxu.py::_kernel
// (guided_filter_mxu, any src channel count) and ops/guided_pallas.py::
// _stage1_kernel + ::_stage2_kernel (guided_filter_fused, one src channel):
// the same function, which the TPU runs one way or the other by frame size.
//
// What it computes, per image n and src channel c, with mean() the
// normalized (2r+1)^2 box:
//   mI_k = mean(I_k), mp = mean(p), V = mean(I I^T) - mI mI^T + eps Id,
//   cov_k = mean(I_k p) - mI_k mp, a = V^-1 cov, b = mp - a . mI,
//   q = mean(a) . I + mean(b).
// guide f32 [N, 3, H, W], src f32 [N, C, H, W] -> out f32 [N, C, H, W].
//
// What bounds it on an H100: at r = 45 the window sums.  Each pixel takes
// 2 x (9 + 4C) column sums (sliding: a few loads each) and (9 + 4C) + 4C
// row sums of 91 taps from shared memory, against ~60 flops of solve and
// ~200 bytes of device traffic.  The design keeps device traffic to the
// four passes' inputs and outputs and never writes a product plane:
//   A. column pass: the 9 + 4C moment products (I_k, p_c, I_k p_c and the
//      6 unique I_i I_j) are formed in registers as the window slides and
//      only their column sums are stored (scratch `mom`);
//   B. row pass + solve: the row sums of those planes give the means, and
//      the cofactor solve runs in the same thread, which stores a0, a1,
//      a2, b (scratch `ab`);
//   C. column pass over the 4C planes of `ab` (into `mom`, free by then);
//   D. row pass + apply: q = mean(a) . I + mean(b), written to `out`.
// A 2-D tile with a 45-pixel halo does not fit: four planes of a 32 x 32
// tile need ~238 KB against the 227 KB a block may use; hence the
// separable passes.  Sums are float64 until the means; the products, the
// solve and the apply are float32 (the TPU's bf16 hi/lo split does not
// carry over).  C is a template parameter (1, 2 or 3); the wrapper runs
// wider srcs in groups of at most three channels.
#include "box_common.cuh"

namespace {

// Stage A: column sums of the moment planes, laid out per image as
// [I0 I1 I2 | I0I0 I0I1 I0I2 I1I1 I1I2 I2I2 | p_0..p_{C-1} |
//  I0p_0 I1p_0 I2p_0 .. I0p_{C-1} I1p_{C-1} I2p_{C-1}].
template <int C>
__global__ void __launch_bounds__(rf::kColThreads)
gf_moment_cols(const float* __restrict__ guide, const float* __restrict__ src,
               float* __restrict__ mom, int h, int w, int radius) {
  constexpr int P = 9 + 4 * C;
  const int x = blockIdx.x * rf::kColThreads + threadIdx.x;
  const int y0 = blockIdx.y * rf::kColSeg;
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
    const size_t o = static_cast<size_t>(rf::reflect(y, h)) * w;
    const float i0 = I[o], i1 = I[plane + o], i2 = I[2 * plane + o];
    float v[P];
    v[0] = i0; v[1] = i1; v[2] = i2;
    v[3] = i0 * i0; v[4] = i0 * i1; v[5] = i0 * i2;
    v[6] = i1 * i1; v[7] = i1 * i2; v[8] = i2 * i2;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float pc = p[c * plane + o];
      v[9 + c] = pc;
      v[9 + C + 3 * c] = i0 * pc;
      v[9 + C + 3 * c + 1] = i1 * pc;
      v[9 + C + 3 * c + 2] = i2 * pc;
    }
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] += sign * static_cast<double>(v[q]);
  };
  const int y1 = min(h, y0 + rf::kColSeg);
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

// Stage B: the means of the moments, the cofactor solve, and a0, a1, a2,
// b per src channel into ab [N, 4C, H, W] as [a0 (C) | a1 (C) | a2 (C) |
// b (C)].  Grid (ceil(w / kRowTile), h, n), kRowTile threads.
template <int C>
__global__ void __launch_bounds__(rf::kRowTile)
gf_solve_rows(const float* __restrict__ mom, float* __restrict__ ab, int h,
              int w, int radius, double inv_area, float eps) {
  constexpr int P = 9 + 4 * C;
  extern __shared__ float s[];
  const int pitch = rf::kRowTile + 2 * radius;
  const int x0 = blockIdx.x * rf::kRowTile;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t row = static_cast<size_t>(blockIdx.y) * w;
  rf::stage_rows(mom + blockIdx.z * P * plane + row, plane, P, w, x0, radius,
                 false, s, pitch);
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= w) return;
  float m[P];
  row_means<P>(s, pitch, radius, inv_area, m);

  const float mi0 = m[0], mi1 = m[1], mi2 = m[2];
  const float rr = m[3] - mi0 * mi0 + eps;
  const float rg = m[4] - mi0 * mi1;
  const float rb = m[5] - mi0 * mi2;
  const float gg = m[6] - mi1 * mi1 + eps;
  const float gb = m[7] - mi1 * mi2;
  const float bb = m[8] - mi2 * mi2 + eps;
  const float c00 = gg * bb - gb * gb;
  const float c01 = gb * rb - rg * bb;
  const float c02 = rg * gb - gg * rb;
  const float c11 = rr * bb - rb * rb;
  const float c12 = rb * rg - rr * gb;
  const float c22 = rr * gg - rg * rg;
  const float inv_det = 1.0f / (rr * c00 + rg * c01 + rb * c02);

  float* o = ab + blockIdx.z * 4 * C * plane + row + x;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mp = m[9 + c];
    const float cov0 = m[9 + C + 3 * c] - mi0 * mp;
    const float cov1 = m[9 + C + 3 * c + 1] - mi1 * mp;
    const float cov2 = m[9 + C + 3 * c + 2] - mi2 * mp;
    const float a0 = (c00 * cov0 + c01 * cov1 + c02 * cov2) * inv_det;
    const float a1 = (c01 * cov0 + c11 * cov1 + c12 * cov2) * inv_det;
    const float a2 = (c02 * cov0 + c12 * cov1 + c22 * cov2) * inv_det;
    o[c * plane] = a0;
    o[(C + c) * plane] = a1;
    o[(2 * C + c) * plane] = a2;
    o[(3 * C + c) * plane] = mp - (a0 * mi0 + a1 * mi1 + a2 * mi2);
  }
}

// Stage D: q = mean(a) . I + mean(b) from the column sums of ab (`abcol`).
// Grid (ceil(w / kRowTile), h, n), kRowTile threads.
template <int C>
__global__ void __launch_bounds__(rf::kRowTile)
gf_apply_rows(const float* __restrict__ abcol, const float* __restrict__ guide,
              float* __restrict__ out, int h, int w, int radius,
              double inv_area) {
  extern __shared__ float s[];
  const int pitch = rf::kRowTile + 2 * radius;
  const int x0 = blockIdx.x * rf::kRowTile;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t row = static_cast<size_t>(blockIdx.y) * w;
  rf::stage_rows(abcol + blockIdx.z * 4 * C * plane + row, plane, 4 * C, w,
                 x0, radius, false, s, pitch);
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

template <int C>
cudaError_t guided(const float* guide, const float* src, float* out,
                   float* mom, float* ab, int n, int h, int w, int radius,
                   float eps, cudaStream_t stream) {
  int smem_solve = 0, smem_apply = 0;
  cudaError_t err = rf::row_smem(gf_solve_rows<C>, 9 + 4 * C, radius,
                                 &smem_solve);
  if (err != cudaSuccess) return err;
  err = rf::row_smem(gf_apply_rows<C>, 4 * C, radius, &smem_apply);
  if (err != cudaSuccess) return err;
  const double wd = 2.0 * radius + 1.0;
  const double inv_area = 1.0 / (wd * wd);
  const dim3 col_grid((w + rf::kColThreads - 1) / rf::kColThreads,
                      (h + rf::kColSeg - 1) / rf::kColSeg, n);
  const dim3 row_grid((w + rf::kRowTile - 1) / rf::kRowTile, h, n);
  const dim3 ab_col_grid(col_grid.x, col_grid.y, n * 4 * C);

  gf_moment_cols<C><<<col_grid, rf::kColThreads, 0, stream>>>(guide, src, mom,
                                                              h, w, radius);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gf_solve_rows<C><<<row_grid, rf::kRowTile, smem_solve, stream>>>(
      mom, ab, h, w, radius, inv_area, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::col_sum_kernel<<<ab_col_grid, rf::kColThreads, 0, stream>>>(
      ab, mom, h, w, radius, false);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gf_apply_rows<C><<<row_grid, rf::kRowTile, smem_apply, stream>>>(
      mom, guide, out, h, w, radius, inv_area);
  return cudaGetLastError();
}

}  // namespace

// guide [n, 3, h, w], src and out [n, c, h, w] f32 (device); scratch mom
// [n, 9 + 4c, h, w] and ab [n, 4c, h, w].  c must be 1, 2 or 3 (else
// cudaErrorInvalidValue); the wrapper keeps n * 4c and h within the grid's
// 65,535.  Returns the cudaError_t of the attribute calls or the launches.
extern "C" int rf_guided_filter(const float* guide, const float* src,
                                float* out, float* mom, float* ab, int n,
                                int c, int h, int w, int radius, float eps,
                                cudaStream_t stream) {
  switch (c) {
    case 1:
      return static_cast<int>(
          guided<1>(guide, src, out, mom, ab, n, h, w, radius, eps, stream));
    case 2:
      return static_cast<int>(
          guided<2>(guide, src, out, mom, ab, n, h, w, radius, eps, stream));
    case 3:
      return static_cast<int>(
          guided<3>(guide, src, out, mom, ab, n, h, w, radius, eps, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
