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
// What bounds it on an H100: device memory at the kernel's bound (guide
// and src in, q out: 20 bytes a pixel at C = 1), but the window sums and
// their float64 staging bind the kernels.  Two paths compute it, chosen by
// shape (guided_any):
//   * the fused pair (gf_fused_kernel, frames up to 512 columns, fewer at
//     C = 2, 3 where its shared memory would not fit): stats and solve,
//     then apply, each a block per band of rows of one image that keeps
//     the column window sums of its planes in registers and shared memory
//     and takes the row windows as differences of prefix sums
//     (box_common.cuh), so the 13 moment planes never reach device memory:
//     guide and src in, a0, a1, a2, b out and back in, the guide again, q
//     out, ~64 bytes a pixel plus the bands' first windows, mostly from
//     L2.  At 32 x 256x256, r = 45, C = 1 it takes 0.19 ms on an H100
//     where the four passes take 0.43 (PERF.md);
//   * the four passes, for wider frames (the guided CLI on large photos):
//     A. column pass: the 9 + 4C moment products (I_k, p_c, I_k p_c and
//        the 6 unique I_i I_j) are formed in registers as the window
//        slides and only their column sums are stored (scratch `mom`);
//     B. row pass + solve: the row sums of those planes give the means,
//        and the cofactor solve runs in the same block, which stores a0,
//        a1, a2, b (scratch `ab`);
//     C. column pass over the 4C planes of `ab` (into `mom`, free by
//        then);
//     D. row pass + apply: q = mean(a) . I + mean(b), written to `out`.
//     Stages A and D, the row pass and the solve live in
//     guided_common.cuh, shared with K9 (guided_chain.cu); a row block of
//     stage B stages 9 + 4C planes in float64, at most 2 x 1056 doubles
//     each, over fewer output columns where that would not fit a block's
//     shared memory, so any radius runs.
// A 2-D tile with a 45-pixel halo does not fit: four planes of a 32 x 32
// tile need ~238 KB against the 227 KB a block may use; hence the
// separable sums.  Sums are float64 until the means; the solve and the
// apply are float32 (the TPU's bf16 hi/lo split does not carry over).  C
// is a template parameter (1, 2 or 3); the wrapper runs wider srcs in
// groups of at most three channels.
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

// The fused kernels: a block owns image n and a band of `band` output
// rows, all w columns, a thread per column (fused_threads).  For each row
// it stores the column window sums of its P planes in shared memory in
// float64 (col, double buffered, a column's planes side by side), turns
// them into row prefixes (pre, double buffered; row_seg and the prefix
// scheme of box_common.cuh) and
// takes each pixel's P window means from two prefixes a plane
// (window_sum).  Iteration i of the band does three things between two
// barriers: (a) the column sums of row i from row i - 1's (each thread
// keeps its column's in registers, adds the entering row's planes and
// subtracts the leaving one's, as col_sum_kernel does, and stores them;
// the two rows' values were loaded during the iteration before; the
// moment products are formed exactly in float64), (b) the prefixes of row
// i - 1 (a warp per two planes, each lane's segment held in registers),
// (c) the per-pixel work of row i - 2.  Stage SOLVE: the 9 + 4C moment
// products of the guide and src (gf_moment_cols' planes) in, the cofactor
// solve per pixel, a0, a1, a2, b out ([N, 4C, H, W] as gf_solve_rows
// writes them).  Stage APPLY: those 4C planes in, q = mean(a) . I +
// mean(b) out.  Device memory sees each input row about (band + 2r + 1) /
// band times (the band's first window reads 2r + 1 rows, then each row
// enters and leaves once), mostly from L2.
constexpr int kFusedWidest = 512;  // a thread per column, at most

__host__ __device__ __forceinline__ int fused_planes(int c, bool solve) {
  return solve ? rf::kGuidePlanes + 4 * c : 4 * c;
}

// Threads of a fused block: a warp per 32 columns, at least 4 warps.
__host__ __device__ __forceinline__ int fused_threads(int w) {
  const int t = (w + 31) / 32 * 32;
  return t < 128 ? 128 : t;
}

// Doubles between a column's values in a fused block's shared memory:
// its P planes, padded to an odd count.
__host__ __device__ constexpr int fused_stride(int planes) { return planes | 1; }

// Shared memory of a fused block over P planes of rows of w: col and pre,
// two of each.
__host__ __device__ __forceinline__ long long fused_smem(int planes, int w) {
  return 2LL * fused_stride(planes) * (2LL * w + 1) *
         static_cast<long long>(sizeof(double));
}

// Whether the fused kernels take a frame w wide: a thread per column
// (kFusedWidest) and the stats-and-solve block's shared memory within the
// device's limit (C = 1, 13 planes: w <= 512; C = 2: w <= 426; C = 3, 21
// planes: w <= 345).  By shape, every call that they take runs them: on
// an H100 they beat the four passes at every shape measured, from single
// 256- to 1024-row frames to the served batch, up to 512 columns
// (scripts/measure_box_guided.py, PERF.md).
inline bool fused_fits(int c, int w) {
  const long long limit =
      rf::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(227 * 1024);
  return w <= kFusedWidest && fused_smem(fused_planes(c, true), w) <= limit;
}

// Output rows per fused block: 32 where the grid (n images x ceil(h /
// band) bands) fills at least 90% of the slots that the solve kernel's
// shared memory leaves resident on the card's SMs, else 16 where that
// does, else 8.  A taller band reads fewer halo rows per output ((band +
// 2r + 1) / band), a shorter one keeps more blocks in flight; on the
// served batch (32 x 256x256, r = 45) 32 rows beat 8, 16 and 64 at C = 1
// and C = 3 (scripts/measure_box_guided.py).  ops/guided_kernel.py::
// fused_band mirrors it.
inline int fused_band(int n, int c, int h, int w) {
  const long long sms = rf::device_attr<cudaDevAttrMultiProcessorCount>(132);
  const long long per_sm = (228LL * 1024) / (fused_smem(fused_planes(c, true), w) + 1024);
  const long long slots = sms * (per_sm < 1 ? 1 : per_sm > 8 ? 8 : per_sm);
  for (int band = 32; band > 8; band /= 2)
    if (10LL * n * ((h + band - 1) / band) >= 9 * slots) return band;
  return 8;
}

// The values of one row at column x that a stage reads (kRaw of them):
// SOLVE the guide's 3 and src's C, APPLY the 4C planes of (a, b).
template <int C, bool SOLVE>
__device__ __forceinline__ void load_row(const float* __restrict__ guide,
                                         const float* __restrict__ in, size_t plane, int y,
                                         int w, int x, float* raw) {
  const size_t o = static_cast<size_t>(y) * w + x;
  if constexpr (SOLVE) {
    raw[0] = guide[o];
    raw[1] = guide[plane + o];
    raw[2] = guide[2 * plane + o];
#pragma unroll
    for (int c = 0; c < C; ++c) raw[3 + c] = in[c * plane + o];
  } else {
#pragma unroll
    for (int q = 0; q < 4 * C; ++q) raw[q] = in[q * plane + o];
  }
}

// Adds (sign 1) or subtracts (sign -1) a row's P planes, from its raw
// values, to the column sums acc: the planes themselves (APPLY) or the
// moment products (SOLVE), each raw value converted to float64 once and
// each product taken exactly in a fused multiply-add, so a column sum is
// exact to float64 rounding.
template <int C, bool SOLVE>
__device__ __forceinline__ void accumulate(double* acc, const float* raw, double sign) {
  constexpr int kRaw = SOLVE ? 3 + C : 4 * C;
  double v[kRaw];
#pragma unroll
  for (int k = 0; k < kRaw; ++k) v[k] = static_cast<double>(raw[k]);
  if constexpr (SOLVE) {
    const double i0 = v[0], i1 = v[1], i2 = v[2];
    const double s0 = sign * i0, s1 = sign * i1, s2 = sign * i2;
    acc[0] += s0; acc[1] += s1; acc[2] += s2;
    acc[3] = fma(s0, i0, acc[3]); acc[4] = fma(s0, i1, acc[4]);
    acc[5] = fma(s0, i2, acc[5]); acc[6] = fma(s1, i1, acc[6]);
    acc[7] = fma(s1, i2, acc[7]); acc[8] = fma(s2, i2, acc[8]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double pc = v[3 + c];
      acc[rf::kGuidePlanes + c] += sign * pc;
      acc[rf::kGuidePlanes + C + 3 * c] = fma(s0, pc, acc[rf::kGuidePlanes + C + 3 * c]);
      acc[rf::kGuidePlanes + C + 3 * c + 1] =
          fma(s1, pc, acc[rf::kGuidePlanes + C + 3 * c + 1]);
      acc[rf::kGuidePlanes + C + 3 * c + 2] =
          fma(s2, pc, acc[rf::kGuidePlanes + C + 3 * c + 2]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4 * C; ++q) acc[q] += sign * v[q];
  }
}

// guide [N, 3, H, W]; SOLVE: in = src [N, C, H, W], out = ab [N, 4C, H,
// W]; APPLY: in = ab, out = q [N, C, H, W].  Grid (ceil(h / band), n),
// fused_threads(w) threads, fused_smem(P, w) bytes; row_seg(w) <= kSeg.
template <int C, bool SOLVE, int kSeg>
__global__ void __launch_bounds__(kFusedWidest)
gf_fused_kernel(const float* __restrict__ guide, const float* __restrict__ in,
                float* __restrict__ out, int h, int w, int radius, int band, double inv_area,
                float eps) {
  constexpr int P = SOLVE ? rf::kGuidePlanes + 4 * C : 4 * C;
  constexpr int kIn = SOLVE ? C : 4 * C;
  constexpr int kOut = SOLVE ? 4 * C : C;
  constexpr int kRaw = SOLVE ? 3 + C : 4 * C;
  // planes innermost, at an odd stride, so that every plane's address is
  // a constant offset from its column's and a warp's loads at consecutive
  // columns (or lane segments) fall on distinct banks
  constexpr int kS = fused_stride(P);
  extern __shared__ double s[];
  double* col = s;                                    // [2][w][kS]
  double* pre = s + 2 * kS * static_cast<size_t>(w);  // [2][w + 1][kS]
  const size_t col_buf = static_cast<size_t>(kS) * w;
  const size_t pre_buf = static_cast<size_t>(kS) * (w + 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int y0 = blockIdx.x * band;
  const int rows = min(band, h - y0);
  const size_t plane = static_cast<size_t>(h) * w;
  const float* I = guide + blockIdx.y * 3 * plane;
  const float* src = in + blockIdx.y * kIn * plane;
  float* dst = out + blockIdx.y * kOut * plane;
  const int seg = rf::row_seg(w);
  const int x = tid;
  const bool own = x < w;  // the thread's column

  // the band's first row: its column windows summed in full; the thread
  // keeps its column's sums in registers and stores each row's
  double acc[P];
  float enter[kRaw], leave[kRaw];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0;
  if (own) {
#pragma unroll 8
    for (int t = y0 - radius; t <= y0 + radius; ++t) {
      float raw[kRaw];
      load_row<C, SOLVE>(I, src, plane, rf::border_in(t, h, false), w, x, raw);
      accumulate<C, SOLVE>(acc, raw, 1.0);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) col[x * kS + q] = acc[q];
    // row 1's entering and leaving rows, loaded ahead
    if (rows > 1) {
      load_row<C, SOLVE>(I, src, plane, rf::border_in(y0 + 1 + radius, h, false), w, x,
                         enter);
      load_row<C, SOLVE>(I, src, plane, rf::border_in(y0 - radius, h, false), w, x, leave);
    }
  }
  // where the thread's window starts and ends in its row's prefixes
  const rf::PrefixAt lo = rf::prefix_at(x - radius, w, false);
  const rf::PrefixAt hi = rf::prefix_at(x + radius + 1, w, false);
  __syncthreads();

  // (a) row i's column sums from row i - 1's, then the next rows' values
  auto columns = [&](int i) {
    if (!own) return;
    accumulate<C, SOLVE>(acc, enter, 1.0);
    accumulate<C, SOLVE>(acc, leave, -1.0);
    double* to = col + (i & 1) * col_buf + x * kS;
#pragma unroll
    for (int q = 0; q < P; ++q) to[q] = acc[q];
    // the next rows, clamped to the band's last (loaded, not used, there)
    const int next = min(i + 1, rows - 1);
    load_row<C, SOLVE>(I, src, plane, rf::border_in(y0 + next + radius, h, false), w, x,
                       enter);
    load_row<C, SOLVE>(I, src, plane, rf::border_in(y0 + next - radius - 1, h, false), w, x,
                       leave);
  };
  // (b) row i's prefixes, a warp per two planes
  auto prefixes = [&](int i) {
    const double* c = col + (i & 1) * col_buf;
    double* p = pre + (i & 1) * pre_buf;
    for (int q = warp; q < P; q += 2 * warps) {
      const int q2 = q + warps;
      const bool two = q2 < P;
      rf::prefix_pair<kSeg, kS>(c + q, p + q, c + (two ? q2 : q), p + (two ? q2 : q), two,
                                w, seg, lane);
    }
  };
  // (c) row i's pixels
  auto pixels = [&](int i) {
    if (!own) return;
    const size_t o = static_cast<size_t>(y0 + i) * w + x;
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if constexpr (!SOLVE) {
      g0 = I[o];
      g1 = I[plane + o];
      g2 = I[2 * plane + o];
    }
    const double* p = pre + (i & 1) * pre_buf;
    float m[P];
#pragma unroll
    for (int q = 0; q < P; ++q)
      m[q] = static_cast<float>(rf::window_sum<kS>(p + q, w, false, lo, hi) * inv_area);
    if constexpr (SOLVE) {
      const float mi0 = m[0], mi1 = m[1], mi2 = m[2];
      float cof[6];
      const float inv_det = rf::guide_cofactors(m, eps, cof);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float mp = m[rf::kGuidePlanes + c];
        const float cov0 = m[rf::kGuidePlanes + C + 3 * c] - mi0 * mp;
        const float cov1 = m[rf::kGuidePlanes + C + 3 * c + 1] - mi1 * mp;
        const float cov2 = m[rf::kGuidePlanes + C + 3 * c + 2] - mi2 * mp;
        const float a0 = (cof[0] * cov0 + cof[1] * cov1 + cof[2] * cov2) * inv_det;
        const float a1 = (cof[1] * cov0 + cof[3] * cov1 + cof[4] * cov2) * inv_det;
        const float a2 = (cof[2] * cov0 + cof[4] * cov1 + cof[5] * cov2) * inv_det;
        dst[c * plane + o] = a0;
        dst[(C + c) * plane + o] = a1;
        dst[(2 * C + c) * plane + o] = a2;
        dst[(3 * C + c) * plane + o] = mp - (a0 * mi0 + a1 * mi1 + a2 * mi2);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[c * plane + o] = m[c] * g0 + m[C + c] * g1 + m[2 * C + c] * g2 + m[3 * C + c];
    }
  };

  // the pipeline: row i's column sums, row i - 1's prefixes and row i -
  // 2's pixels between two barriers; the steady loop tests no row bound,
  // so the three phases' independent work can interleave
  if (rows > 1) columns(1);
  prefixes(0);
  __syncthreads();
  for (int i = 2; i < rows; ++i) {
    columns(i);
    prefixes(i - 1);
    pixels(i - 2);
    __syncthreads();
  }
  if (rows > 1) {
    prefixes(rows - 1);
    pixels(rows - 2);
    __syncthreads();
  }
  pixels(rows - 1);
}

template <int C, int kSeg>
cudaError_t guided_fused_seg(const float* guide, const float* src, float* out, float* ab,
                             int n, int h, int w, int radius, float eps, int band,
                             cudaStream_t stream) {
  const auto solve = gf_fused_kernel<C, true, kSeg>;
  const auto apply = gf_fused_kernel<C, false, kSeg>;
  const int smem_solve = static_cast<int>(fused_smem(fused_planes(C, true), w));
  const int smem_apply = static_cast<int>(fused_smem(fused_planes(C, false), w));
  cudaError_t err = rf::smem_limit(solve, smem_solve);
  if (err != cudaSuccess) return err;
  if ((err = rf::smem_limit(apply, smem_apply)) != cudaSuccess) return err;
  if (band <= 0) band = fused_band(n, C, h, w);
  const dim3 grid((h + band - 1) / band, n);
  const int threads = fused_threads(w);
  const double inv_area = rf::inv_area(radius);
  solve<<<grid, threads, smem_solve, stream>>>(guide, src, ab, h, w, radius, band, inv_area,
                                               eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply<<<grid, threads, smem_apply, stream>>>(guide, ab, out, h, w, radius, band, inv_area,
                                               eps);
  return cudaGetLastError();
}

// The fused pair, its lanes' segment held in 9 registers where w <= 288,
// else 17 (w <= kFusedWidest).
template <int C>
cudaError_t guided_fused(const float* guide, const float* src, float* out, float* ab, int n,
                         int h, int w, int radius, float eps, int band, cudaStream_t stream) {
  if (rf::row_seg(w) <= 9)
    return guided_fused_seg<C, 9>(guide, src, out, ab, n, h, w, radius, eps, band, stream);
  return guided_fused_seg<C, 17>(guide, src, out, ab, n, h, w, radius, eps, band, stream);
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
  err = rf::launch_cols<rf::gf_moment_cols<C, true>>(3 + C, n, h, w, radius, 0,
                                                     stream, guide, src, mom, h,
                                                     w, radius);
  if (err != cudaSuccess) return err;
  gf_solve_rows<C><<<solve_grid, solve_block, smem_solve, stream>>>(
      mom, ab, h, w, span_solve, radius, inv_area, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = rf::launch_cols<rf::col_sum_kernel>(1, n * 4 * C, h, w, radius, 0,
                                            stream, ab, mom, h, w, radius,
                                            false);
  if (err != cudaSuccess) return err;
  rf::gf_apply_rows<C><<<apply_grid, apply_block, smem_apply, stream>>>(
      mom, guide, out, h, w, span_apply, radius, inv_area);
  return cudaGetLastError();
}

// The path a call takes: mode 0 by shape (the fused kernels wherever
// fused_fits, else the four passes), 1 the four passes, 2 the fused
// kernels (cudaErrorInvalidValue where they do not fit).
// ops/guided_kernel.py::fused_path mirrors it.
template <int C>
cudaError_t guided_any(const float* guide, const float* src, float* out, float* mom,
                       float* ab, int n, int h, int w, int radius, float eps, int mode,
                       int band, cudaStream_t stream) {
  if (mode == 1 || (mode == 0 && !fused_fits(C, w)))
    return guided<C>(guide, src, out, mom, ab, n, h, w, radius, eps, stream);
  if (!fused_fits(C, w)) return cudaErrorInvalidValue;
  return guided_fused<C>(guide, src, out, ab, n, h, w, radius, eps, band, stream);
}

}  // namespace

// guide [n, 3, h, w], src and out [n, c, h, w] f32 (device); scratch ab
// [n, 4c, h, w], and mom [n, 9 + 4c, h, w] for the four passes (unread by
// the fused kernels).  c must be 1, 2 or 3 (else cudaErrorInvalidValue).
// mode: 0 the path by shape (guided_any), 1 the four passes, 2 the fused
// kernels; band: the fused blocks' output rows, 0 for fused_band's.  The
// wrapper keeps the grids within their limits
// (ops/guided_kernel.py::check_grid).  Returns the cudaError_t of the
// attribute calls or the launches.
extern "C" int rf_guided_filter(const float* guide, const float* src,
                                float* out, float* mom, float* ab, int n,
                                int c, int h, int w, int radius, float eps,
                                int mode, int band, cudaStream_t stream) {
  switch (c) {
    case 1:
      return static_cast<int>(guided_any<1>(guide, src, out, mom, ab, n, h, w, radius, eps,
                                            mode, band, stream));
    case 2:
      return static_cast<int>(guided_any<2>(guide, src, out, mom, ab, n, h, w, radius, eps,
                                            mode, band, stream));
    case 3:
      return static_cast<int>(guided_any<3>(guide, src, out, mom, ab, n, h, w, radius, eps,
                                            mode, band, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
