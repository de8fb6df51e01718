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
// 3 x (13 + 4) x 2 = 102 for three K5 calls.  rf_guided_chain_pass runs
// any one of the six passes alone (for timing them apart).
//
// What bounds it on an H100: device traffic, once the window sums cost
// O(1) per output.  The row passes slide a float64 window per lane along a
// run of outputs (guided_common.cuh, row_tile_means: 4 staged taps per
// output and plane at any radius, each converted to float64 once when
// staged, against 91 taps at r = 45 before), and the column passes slide one
// down each column of a strip of 32, its rows streamed through a ring in
// shared memory by asynchronous copies (box_common.cuh, col_stream; at
// r = 45 each input row crosses device memory once a segment, and a
// segment is as long as one wave of items over the card allows, rf::
// col_launch).  Device traffic is each pass's input and output planes; no
// product plane is written.  Borders are mapped by index (box_common.cuh),
// so an application reads the previous one's plain output plane, at any
// radius, even one wider than the frame.  Offsets are size_t: one 4320 x 7680 image has 9 stat planes
// of 33.2 M floats.
#include "guided_common.cuh"

namespace {

// Row pass of the statistics: the means of the 9 column-summed guide
// moments (`mom`), the cofactor solve, and the 9 stat planes.  Launch
// shape: rf::row_launch with 9 planes.
__global__ void __launch_bounds__(32 * rf::kGuidePlanes)
gc_stats_rows(const float* __restrict__ mom, float* __restrict__ stats, int h,
              int w, int span, int radius, double inv_area, float eps) {
  constexpr int P = rf::kGuidePlanes;
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
    float cof[6];
    const float inv_det = rf::guide_cofactors(m, eps, cof);
    float* o = stats + blockIdx.z * P * plane + row + x0 + i;
    o[0] = m[0];
    o[plane] = m[1];
    o[2 * plane] = m[2];
#pragma unroll
    for (int k = 0; k < 6; ++k) o[(3 + k) * plane] = cof[k] * inv_det;
  }
}

// Row pass of one application: the means of p and I_k p (column sums in
// `mom`, [p (C) | I0p_0 I1p_0 I2p_0 ..]), the cached statistics, and
// a0, a1, a2, b into ab [N, 4C, H, W] as [a0 (C) | a1 (C) | a2 (C) |
// b (C)].  Launch shape: rf::row_launch with 4C planes.
template <int C>
__global__ void __launch_bounds__(32 * 4 * C)
gc_solve_cached_rows(const float* __restrict__ mom,
                     const float* __restrict__ stats, float* __restrict__ ab,
                     int h, int w, int span, int radius, double inv_area) {
  constexpr int P = 4 * C;
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
    const float* st =
        stats + blockIdx.z * rf::kGuidePlanes * plane + row + x0 + i;
    const float mi0 = st[0], mi1 = st[plane], mi2 = st[2 * plane];
    const float d00 = st[3 * plane], d01 = st[4 * plane], d02 = st[5 * plane];
    const float d11 = st[6 * plane], d12 = st[7 * plane], d22 = st[8 * plane];
    float* o = ab + blockIdx.z * P * plane + row + x0 + i;
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
}

// One pass of the chain (the passes of rf_guide_stats, then those of
// rf_guided_apply_cached, in order):
//   0 the guide's moment columns (guide -> mom, 9 planes),
//   1 the statistics' rows (mom -> stats),
//   2 the moment columns of p and I_k p (guide, src -> mom, 4C planes),
//   3 the solve's rows (mom, stats -> ab),
//   4 the column sums of ab (ab -> mom),
//   5 the apply's rows (mom, guide -> out),
// the column passes (0, 2, 4) with items of `seg` rows (rf::col_launch's
// if 0).
template <int C>
cudaError_t chain_pass(int pass, int seg, float* stats, const float* guide,
                       const float* src, float* out, float* mom, float* ab,
                       int n, int h, int w, int radius, float eps,
                       cudaStream_t stream) {
  const double inv_area = rf::inv_area(radius);
  int span = 0, smem = 0;
  dim3 grid, block;
  cudaError_t err = cudaSuccess;
  switch (pass) {
    case 0:
      // C = 0: the guide's 9 planes only (src is not read)
      return rf::launch_cols<rf::gf_moment_cols<0, true>>(
          3, n, h, w, radius, seg, stream, guide, guide, mom, h, w, radius);
    case 1:
      err = rf::row_launch(gc_stats_rows, rf::kGuidePlanes, n, h, w, radius,
                           &span, &smem, &grid, &block);
      if (err != cudaSuccess) return err;
      gc_stats_rows<<<grid, block, smem, stream>>>(mom, stats, h, w, span,
                                                   radius, inv_area, eps);
      break;
    case 2:
      return rf::launch_cols<rf::gf_moment_cols<C, false>>(
          3 + C, n, h, w, radius, seg, stream, guide, src, mom, h, w, radius);
    case 3:
      err = rf::row_launch(gc_solve_cached_rows<C>, 4 * C, n, h, w, radius,
                           &span, &smem, &grid, &block);
      if (err != cudaSuccess) return err;
      gc_solve_cached_rows<C><<<grid, block, smem, stream>>>(
          mom, stats, ab, h, w, span, radius, inv_area);
      break;
    case 4:
      return rf::launch_cols<rf::col_sum_kernel>(
          1, n * 4 * C, h, w, radius, seg, stream, ab, mom, h, w, radius, false);
    case 5:
      err = rf::row_launch(rf::gf_apply_rows<C>, 4 * C, n, h, w, radius,
                           &span, &smem, &grid, &block);
      if (err != cudaSuccess) return err;
      rf::gf_apply_rows<C><<<grid, block, smem, stream>>>(
          mom, guide, out, h, w, span, radius, inv_area);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int C>
cudaError_t passes(int first, int last, int seg, float* stats,
                   const float* guide, const float* src, float* out,
                   float* mom, float* ab, int n, int h, int w, int radius,
                   float eps, cudaStream_t stream) {
  for (int pass = first; pass <= last; ++pass) {
    const cudaError_t err = chain_pass<C>(pass, seg, stats, guide, src, out,
                                          mom, ab, n, h, w, radius, eps,
                                          stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t by_channels(int c, int first, int last, int seg, float* stats,
                        const float* guide, const float* src, float* out,
                        float* mom, float* ab, int n, int h, int w,
                        int radius, float eps, cudaStream_t stream) {
  switch (c) {
    case 1:
      return passes<1>(first, last, seg, stats, guide, src, out, mom, ab, n,
                       h, w, radius, eps, stream);
    case 2:
      return passes<2>(first, last, seg, stats, guide, src, out, mom, ab, n,
                       h, w, radius, eps, stream);
    case 3:
      return passes<3>(first, last, seg, stats, guide, src, out, mom, ab, n,
                       h, w, radius, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// guide [n, 3, h, w] f32 (device) -> stats [n, 9, h, w]; scratch mom
// [n, 9, h, w].  The wrapper keeps the grids within their limits
// (ops/guided_kernel.py::check_grid).  Returns the cudaError_t of the
// attribute call or the launches.
extern "C" int rf_guide_stats(const float* guide, float* stats, float* mom,
                              int n, int h, int w, int radius, float eps,
                              cudaStream_t stream) {
  return static_cast<int>(by_channels(1, 0, 1, 0, stats, guide,
                                      nullptr, nullptr, mom, nullptr, n, h, w,
                                      radius, eps, stream));
}

// stats [n, 9, h, w] (from rf_guide_stats with the same guide and radius),
// guide [n, 3, h, w], src and out [n, c, h, w] f32 (device); scratch mom
// and ab [n, 4c, h, w].  c must be 1, 2 or 3 (else cudaErrorInvalidValue);
// the wrapper keeps the grids within their limits.  Returns the
// cudaError_t of the attribute calls or the launches.
extern "C" int rf_guided_apply_cached(const float* stats, const float* guide,
                                      const float* src, float* out,
                                      float* mom, float* ab, int n, int c,
                                      int h, int w, int radius,
                                      cudaStream_t stream) {
  return static_cast<int>(by_channels(c, 2, 5, 0,
                                      const_cast<float*>(stats), guide, src,
                                      out, mom, ab, n, h, w, radius, 0.0f,
                                      stream));
}

// The chain's passes one at a time, for timing them apart: pass 0..5 as
// chain_pass numbers them, the column passes with items of `seg` rows
// (0: the product's, rf::col_launch).  Arguments as the two entry points
// above (stats written by pass 1, read by pass 3; eps read by pass 1
// only).  Returns the cudaError_t of the attribute call or the launch,
// cudaErrorInvalidValue for another pass, seg or c.
extern "C" int rf_guided_chain_pass(int pass, int seg, float* stats,
                                    const float* guide, const float* src,
                                    float* out, float* mom, float* ab, int n,
                                    int c, int h, int w, int radius,
                                    float eps, cudaStream_t stream) {
  if (pass < 0 || pass > 5 || seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_channels(c, pass, pass, seg, stats, guide, src,
                                      out, mom, ab, n, h, w, radius, eps,
                                      stream));
}
