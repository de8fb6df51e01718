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
// 2 x (9 + 4C) column sums and as many row sums, each sliding (a few
// staged taps each; guided_common.cuh), against ~60 flops of solve and
// ~200 bytes of device traffic.  The design keeps device traffic to the
// four passes' inputs and outputs and never writes a product plane:
//   A. column pass: the 9 + 4C moment products (I_k, p_c, I_k p_c and the
//      6 unique I_i I_j) are formed in registers as the window slides and
//      only their column sums are stored (scratch `mom`);
//   B. row pass + solve: the row sums of those planes give the means, and
//      the cofactor solve runs in the same block, which stores a0, a1,
//      a2, b (scratch `ab`);
//   C. column pass over the 4C planes of `ab` (into `mom`, free by then);
//   D. row pass + apply: q = mean(a) . I + mean(b), written to `out`.
// A 2-D tile with a 45-pixel halo does not fit: four planes of a 32 x 32
// tile need ~238 KB against the 227 KB a block may use; hence the
// separable passes.  Sums are float64 until the means; the products, the
// solve and the apply are float32 (the TPU's bf16 hi/lo split does not
// carry over).  C is a template parameter (1, 2 or 3); the wrapper runs
// wider srcs in groups of at most three channels.  Stages A and D, the row
// pass and the solve live in guided_common.cuh, shared with K9
// (guided_chain.cu); a row block of stage B stages 9 + 4C planes in
// float64, at most 2 x 1056 doubles each, over fewer output columns where
// that would not fit a block's shared memory, so any radius runs.
#include "guided_common.cuh"

namespace {

// Stage B: the means of the moments, the cofactor solve, and a0, a1, a2,
// b per src channel into ab [N, 4C, H, W] as [a0 (C) | a1 (C) | a2 (C) |
// b (C)].  Launch shape: rf::row_launch with 9 + 4C planes.
template <int C>
__global__ void __launch_bounds__(32 * (rf::kGuidePlanes + 4 * C))
gf_solve_rows(const float* __restrict__ mom, float* __restrict__ ab, int h,
              int w, int span, int radius, double inv_area, float eps) {
  constexpr int P = rf::kGuidePlanes + 4 * C;
  extern __shared__ double s[];
  const int pitch = rf::row_pitch(span, radius);
  const int x0 = blockIdx.x * span;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t row = static_cast<size_t>(blockIdx.y) * w;
  rf::row_tile_means<P>(mom + blockIdx.z * P * plane + row, plane, w, x0,
                        span, radius, inv_area, s);
  const int n = min(span, w - x0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float m[P];
#pragma unroll
    for (int q = 0; q < P; ++q) m[q] = rf::tile_means(s, pitch, q)[i];
    const float mi0 = m[0], mi1 = m[1], mi2 = m[2];
    float cof[6];
    const float inv_det = rf::guide_cofactors(m, eps, cof);
    const float c00 = cof[0], c01 = cof[1], c02 = cof[2];
    const float c11 = cof[3], c12 = cof[4], c22 = cof[5];

    float* o = ab + blockIdx.z * 4 * C * plane + row + x0 + i;
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
}

template <int C>
cudaError_t guided(const float* guide, const float* src, float* out,
                   float* mom, float* ab, int n, int h, int w, int radius,
                   float eps, cudaStream_t stream) {
  int span_solve = 0, span_apply = 0, smem_solve = 0, smem_apply = 0;
  dim3 solve_grid, solve_block, apply_grid, apply_block;
  cudaError_t err = rf::row_launch(gf_solve_rows<C>, rf::kGuidePlanes + 4 * C,
                                   n, h, w, radius, &span_solve, &smem_solve,
                                   &solve_grid, &solve_block);
  if (err != cudaSuccess) return err;
  err = rf::row_launch(rf::gf_apply_rows<C>, 4 * C, n, h, w, radius,
                       &span_apply, &smem_apply, &apply_grid, &apply_block);
  if (err != cudaSuccess) return err;
  const double inv_area = rf::inv_area(radius);
  const int cols = (w + rf::kColThreads - 1) / rf::kColThreads;
  const int seg = rf::col_seg(n, h, w), ab_seg = rf::col_seg(n * 4 * C, h, w);

  rf::gf_moment_cols<C, true><<<dim3(cols, (h + seg - 1) / seg, n),
                                rf::kColThreads, 0, stream>>>(
      guide, src, mom, h, w, radius, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gf_solve_rows<C><<<solve_grid, solve_block, smem_solve, stream>>>(
      mom, ab, h, w, span_solve, radius, inv_area, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::col_sum_kernel<<<dim3(cols, (h + ab_seg - 1) / ab_seg, n * 4 * C),
                       rf::kColThreads, 0, stream>>>(ab, mom, h, w, radius,
                                                     false, ab_seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::gf_apply_rows<C><<<apply_grid, apply_block, smem_apply, stream>>>(
      mom, guide, out, h, w, span_apply, radius, inv_area);
  return cudaGetLastError();
}

}  // namespace

// guide [n, 3, h, w], src and out [n, c, h, w] f32 (device); scratch mom
// [n, 9 + 4c, h, w] and ab [n, 4c, h, w].  c must be 1, 2 or 3 (else
// cudaErrorInvalidValue); the wrapper keeps the grids within their limits
// (ops/guided_kernel.py::check_grid).  Returns the cudaError_t of the
// attribute calls or the launches.
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
