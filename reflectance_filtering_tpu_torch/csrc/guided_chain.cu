// K9 — the iterated guided-filter chain with a color guide, its guide
// statistics computed once (the Zoran-style "3x iterated GF" of the JAX
// bench's config 4).
//
// Replaces reflectance_filtering_tpu/ops/guided_pallas.py::
// _fused_gf_iter1_kernel + ::_fused_gf_kernel (guided_filter_fused_iterated,
// the band-dot branch the TPU takes at 8 <= r <= 64, H >= 256) and
// ::_stats_kernel + ::_apply_kernel + ::_stage2_banded_kernel (its banded
// branch): one function, which the TPU computes one way or the other by
// frame size and radius.  K9 follows the fused branch's numerics: the
// statistics are stored premultiplied, d = cofactor * (1 / det).
//
// Two entry points, each a sequence of separable passes (K5's, csrc/
// guided.cu, with the guide-only work split off):
//   rf_guide_stats, once per chain: a column pass over the 9 guide-moment
//     planes (I_k and the 6 unique I_i I_j, formed in registers), then a
//     row pass that takes their means and solves, writing 9 stat planes
//     [mI0 mI1 mI2 | d00 d01 d02 d11 d12 d22];
//   rf_guided_apply_cached, once per application and group of at most 3
//     src channels: a column pass over p and I_k p only (4 planes per
//     channel), a row pass that reads the cached statistics and writes
//     a = d . cov and b = mean(p) - a . mI, then K5's last two passes
//     (column sums of a, b; row sums and q = mean(a) . I + mean(b)).
// A 3x chain with C = 1 takes 2 x 9 + 3 x 16 = 66 plane passes against
// 3 x (13 + 4) x 2 = 102 for three K5 calls.
//
// What bounds it on an H100: as K5, the window sums (r = 45: 91 taps per
// plane and pixel in the row passes, from shared memory); device traffic
// is each pass's input and output planes, no product plane is written.
// Borders are mapped by index (box_common.cuh), so an application reads
// the previous one's plain output plane, at any radius, even one wider
// than the frame.  Offsets are size_t: one 4320 x 7680 image has 9 stat
// planes of 33.2 M floats.
#include "guided_common.cuh"

namespace {

// Row pass of the statistics: the means of the 9 column-summed guide
// moments (`mom`), the cofactor solve, and the 9 stat planes.
// Grid (ceil(w / kRowTile), h, n), kRowTile threads.
__global__ void __launch_bounds__(rf::kRowTile)
gc_stats_rows(const float* __restrict__ mom, float* __restrict__ stats, int h,
              int w, int radius, double inv_area, float eps) {
  constexpr int P = rf::kGuidePlanes;
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
  float cof[6];
  const float inv_det = rf::guide_cofactors(m, eps, cof);
  float* o = stats + blockIdx.z * P * plane + row + x;
  o[0] = m[0];
  o[plane] = m[1];
  o[2 * plane] = m[2];
#pragma unroll
  for (int k = 0; k < 6; ++k) o[(3 + k) * plane] = cof[k] * inv_det;
}

// Row pass of one application: the means of p and I_k p (column sums in
// `mom`, [p (C) | I0p_0 I1p_0 I2p_0 ..]), the cached statistics, and
// a0, a1, a2, b into ab [N, 4C, H, W] as [a0 (C) | a1 (C) | a2 (C) |
// b (C)].  Grid (ceil(w / kRowTile), h, n), kRowTile threads.
template <int C>
__global__ void __launch_bounds__(rf::kRowTile)
gc_solve_cached_rows(const float* __restrict__ mom,
                     const float* __restrict__ stats, float* __restrict__ ab,
                     int h, int w, int radius, double inv_area) {
  constexpr int P = 4 * C;
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
  const float* st = stats + blockIdx.z * rf::kGuidePlanes * plane + row + x;
  const float mi0 = st[0], mi1 = st[plane], mi2 = st[2 * plane];
  const float d00 = st[3 * plane], d01 = st[4 * plane], d02 = st[5 * plane];
  const float d11 = st[6 * plane], d12 = st[7 * plane], d22 = st[8 * plane];
  float* o = ab + blockIdx.z * P * plane + row + x;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mp = m[c];
    const float cov0 = m[C + 3 * c] - mi0 * mp;
    const float cov1 = m[C + 3 * c + 1] - mi1 * mp;
    const float cov2 = m[C + 3 * c + 2] - mi2 * mp;
    const float a0 = d00 * cov0 + d01 * cov1 + d02 * cov2;
    const float a1 = d01 * cov0 + d11 * cov1 + d12 * cov2;
    const float a2 = d02 * cov0 + d12 * cov1 + d22 * cov2;
    o[c * plane] = a0;
    o[(C + c) * plane] = a1;
    o[(2 * C + c) * plane] = a2;
    o[(3 * C + c) * plane] = mp - a0 * mi0 - a1 * mi1 - a2 * mi2;
  }
}

dim3 col_grid(int n, int h, int w) {
  return dim3((w + rf::kColThreads - 1) / rf::kColThreads,
              (h + rf::kColSeg - 1) / rf::kColSeg, n);
}

dim3 row_grid(int n, int h, int w) {
  return dim3((w + rf::kRowTile - 1) / rf::kRowTile, h, n);
}

template <int C>
cudaError_t apply_cached(const float* stats, const float* guide,
                         const float* src, float* out, float* mom, float* ab,
                         int n, int h, int w, int radius,
                         cudaStream_t stream) {
  int smem_solve = 0, smem_apply = 0;
  cudaError_t err = rf::row_smem(gc_solve_cached_rows<C>, 4 * C, radius,
                                 &smem_solve);
  if (err != cudaSuccess) return err;
  err = rf::row_smem(rf::gf_apply_rows<C>, 4 * C, radius, &smem_apply);
  if (err != cudaSuccess) return err;
  const double inv_area = rf::inv_area(radius);
  const dim3 cols = col_grid(n, h, w);
  const dim3 rows = row_grid(n, h, w);
  const dim3 ab_cols(cols.x, cols.y, n * 4 * C);

  rf::gf_moment_cols<C, false><<<cols, rf::kColThreads, 0, stream>>>(
      guide, src, mom, h, w, radius);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gc_solve_cached_rows<C><<<rows, rf::kRowTile, smem_solve, stream>>>(
      mom, stats, ab, h, w, radius, inv_area);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::col_sum_kernel<<<ab_cols, rf::kColThreads, 0, stream>>>(
      ab, mom, h, w, radius, false);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rf::gf_apply_rows<C><<<rows, rf::kRowTile, smem_apply, stream>>>(
      mom, guide, out, h, w, radius, inv_area);
  return cudaGetLastError();
}

}  // namespace

// guide [n, 3, h, w] f32 (device) -> stats [n, 9, h, w]; scratch mom
// [n, 9, h, w].  The wrapper keeps n and h within the grid's 65,535.
// Returns the cudaError_t of the attribute call or the launches.
extern "C" int rf_guide_stats(const float* guide, float* stats, float* mom,
                              int n, int h, int w, int radius, float eps,
                              cudaStream_t stream) {
  int smem = 0;
  cudaError_t err = rf::row_smem(gc_stats_rows, rf::kGuidePlanes, radius,
                                 &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // C = 0: the guide's 9 planes only (src is not read)
  rf::gf_moment_cols<0, true><<<col_grid(n, h, w), rf::kColThreads, 0,
                                stream>>>(guide, guide, mom, h, w, radius);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gc_stats_rows<<<row_grid(n, h, w), rf::kRowTile, smem, stream>>>(
      mom, stats, h, w, radius, rf::inv_area(radius), eps);
  return static_cast<int>(cudaGetLastError());
}

// stats [n, 9, h, w] (from rf_guide_stats with the same guide and radius),
// guide [n, 3, h, w], src and out [n, c, h, w] f32 (device); scratch mom
// and ab [n, 4c, h, w].  c must be 1, 2 or 3 (else cudaErrorInvalidValue);
// the wrapper keeps n * 4c and h within the grid's 65,535.  Returns the
// cudaError_t of the attribute calls or the launches.
extern "C" int rf_guided_apply_cached(const float* stats, const float* guide,
                                      const float* src, float* out,
                                      float* mom, float* ab, int n, int c,
                                      int h, int w, int radius,
                                      cudaStream_t stream) {
  switch (c) {
    case 1:
      return static_cast<int>(apply_cached<1>(stats, guide, src, out, mom, ab,
                                              n, h, w, radius, stream));
    case 2:
      return static_cast<int>(apply_cached<2>(stats, guide, src, out, mom, ab,
                                              n, h, w, radius, stream));
    case 3:
      return static_cast<int>(apply_cached<3>(stats, guide, src, out, mom, ab,
                                              n, h, w, radius, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
