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
// wider srcs in groups of at most three channels.  Stages A and D, the row
// means and the solve live in guided_common.cuh, shared with K9
// (guided_chain.cu).
#include "guided_common.cuh"

namespace {

// Stage B: the means of the moments, the cofactor solve, and a0, a1, a2,
// b per src channel into ab [N, 4C, H, W] as [a0 (C) | a1 (C) | a2 (C) |
// b (C)].  Grid (ceil(w / kRowTile), h, n), kRowTile threads.
template <int C>
__global__ void __launch_bounds__(rf::kRowTile)
gf_solve_rows(const float* __restrict__ mom, float* __restrict__ ab, int h,
              int w, int radius, double inv_area, float eps) {
  constexpr int P = rf::kGuidePlanes + 4 * C;
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
  rf::row_means<P>(s, pitch, radius, inv_area, m);

  const float mi0 = m[0], mi1 = m[1], mi2 = m[2];
  float cof[6];
  const float inv_det = rf::guide_cofactors(m, eps, cof);
  const float c00 = cof[0], c01 = cof[1], c02 = cof[2];
  const float c11 = cof[3], c12 = cof[4], c22 = cof[5];

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

template <int C>
cudaError_t guided(const float* guide, const float* src, float* out,
                   float* mom, float* ab, int n, int h, int w, int radius,
                   float eps, cudaStream_t stream) {
  int smem_solve = 0, smem_apply = 0;
  cudaError_t err = rf::row_smem(gf_solve_rows<C>, 9 + 4 * C, radius,
                                 &smem_solve);
  if (err != cudaSuccess) return err;
  err = rf::row_smem(rf::gf_apply_rows<C>, 4 * C, radius, &smem_apply);
  if (err != cudaSuccess) return err;
  const double inv_area = rf::inv_area(radius);
  const dim3 col_grid((w + rf::kColThreads - 1) / rf::kColThreads,
                      (h + rf::kColSeg - 1) / rf::kColSeg, n);
  const dim3 row_grid((w + rf::kRowTile - 1) / rf::kRowTile, h, n);
  const dim3 ab_col_grid(col_grid.x, col_grid.y, n * 4 * C);

  rf::gf_moment_cols<C, true><<<col_grid, rf::kColThreads, 0, stream>>>(
      guide, src, mom, h, w, radius);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gf_solve_rows<C><<<row_grid, rf::kRowTile, smem_solve, stream>>>(
      mom, ab, h, w, radius, inv_area, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::col_sum_kernel<<<ab_col_grid, rf::kColThreads, 0, stream>>>(
      ab, mom, h, w, radius, false);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::gf_apply_rows<C><<<row_grid, rf::kRowTile, smem_apply, stream>>>(
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
