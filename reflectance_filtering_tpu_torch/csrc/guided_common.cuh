// Shared device code of the color-guide guided filters (K5 guided.cu, K9
// guided_chain.cu): the moment column pass, the sliding row pass, the 3x3
// cofactor solve and the final row pass q = mean(a) . I + mean(b).
//
// Per image n and src channel c, with mean() the normalized (2r+1)^2 box
// under BORDER_REFLECT:
//   mI_k = mean(I_k), V = mean(I I^T) - mI mI^T + eps Id, cov_k =
//   mean(I_k p) - mI_k mean(p), a = V^-1 cov, b = mean(p) - a . mI,
//   q = mean(a) . I + mean(b).
// Sums are float64 until the means, and the moment products they sum are
// formed in float64 (exact); the solve and the apply are float32.
//
// The row passes.  A row block owns `span` output columns x0 .. x0 + span
// - 1 of one row (32 runs of kRun, 1056 columns, or fewer where a wide
// radius would not fit the block's shared memory: row_launch picks it) and
// all P planes of its pass; it has one warp per plane and 32P threads.
// The window sum S(i) of output i steps to S(i + 1) by adding the tap that
// enters, x[i + 1 + r], and subtracting the one that leaves, x[i - r].  So
// warp q stages, for plane q, only those taps, converted to float64 once:
// the leaving ones from x[x0 - r - 1] and the entering ones from x[x0 + r],
// span of each, as one run of span + 2r + 1 where they overlap and two of
// span where they do not (2r + 1 > span).  A block's shared memory is then
// at most 2 span doubles a plane at any radius.  The warp sums S(x0) from
// device memory (2r + 1 taps across its lanes); lane j owns the run of
// kRun outputs from x0 + j kRun, sums its run's steps (2 taps an output),
// a scan of those sums across the warp gives each lane S at its run's
// first output, and the lane slides its window along the run (2 taps an
// output).  Every partial is a window sum or the difference of two, so it
// stays bounded by 2 (2r + 1) max|x|, as the column pass's restart at each
// segment bounds its own.  kRun is odd: the 32 lanes read at a stride of
// kRun doubles, one bank pair each per half-warp, so no load conflicts.
// The means go back to shared memory (as float32, over the staged
// values), and then every thread of the block takes outputs in turn for
// the pass's own per-pixel work (the solve, or the apply), reading the P
// means of its column from there.
#pragma once

#include "box_common.cuh"

namespace rf {
namespace {

constexpr int kGuidePlanes = 9;  // I0 I1 I2 and the 6 unique I_i I_j
constexpr int kRun = 33;         // outputs per lane of a row pass (odd)
constexpr int kRowRuns = 32;     // runs per row block, at most (one a lane)

// Column sums of the moment planes, laid out per image as
// [I0 I1 I2 | I0I0 I0I1 I0I2 I1I1 I1I2 I2I2 (GUIDE only) | p_0..p_{C-1} |
//  I0p_0 I1p_0 I2p_0 .. I0p_{C-1} I1p_{C-1} I2p_{C-1}]: rf::col_stream
// over the 3 + C input planes (guide, then src), the products formed in
// registers as each row enters and leaves (in float64, so exactly: a
// product of two float32 values fits a double's mantissa) and only their
// column sums stored.  Launch shape: col_launch(3 + C, n, h, w, radius, seg).
template <int C, bool GUIDE>
__global__ void __launch_bounds__(kStrip)
gf_moment_cols(const float* __restrict__ guide, const float* __restrict__ src,
               float* __restrict__ mom, int h, int w, int radius, int seg,
               int depth) {
  constexpr int G = GUIDE ? kGuidePlanes : 0;
  constexpr int P = G + 4 * C;
  constexpr int kIn = 3 + C;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* in[kIn];
#pragma unroll
  for (int q = 0; q < 3; ++q) in[q] = guide + (blockIdx.z * 3 + q) * plane;
#pragma unroll
  for (int c = 0; c < C; ++c) in[3 + c] = src + (blockIdx.z * C + c) * plane;
  col_stream<kIn, P>(
      in, mom + blockIdx.z * P * plane, plane, h, w, radius, false, seg, depth,
      [](const double (&v)[kIn], double (&t)[P]) {
        const double i0 = v[0], i1 = v[1], i2 = v[2];
        if constexpr (GUIDE) {
          t[0] = i0; t[1] = i1; t[2] = i2;
          t[3] = i0 * i0; t[4] = i0 * i1; t[5] = i0 * i2;
          t[6] = i1 * i1; t[7] = i1 * i2; t[8] = i2 * i2;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const double pc = v[3 + c];
          t[G + c] = pc;
          t[G + C + 3 * c] = i0 * pc;
          t[G + C + 3 * c + 1] = i1 * pc;
          t[G + C + 3 * c + 2] = i2 * pc;
        }
      });
}

// Doubles of shared memory a row block of `span` output columns stages per
// plane (its pitch): the leaving and the entering taps.
__host__ __device__ __forceinline__ int row_pitch(int span, int radius) {
  return span + (2 * radius + 1 < span ? 2 * radius + 1 : span);
}

// The means of plane q of a row block, as float32, one per output column
// of the block (written by row_tile_means over that plane's staging).
__device__ __forceinline__ float* tile_means(double* s, int pitch, int q) {
  return reinterpret_cast<float*>(s + static_cast<size_t>(q) * pitch);
}

// The row block's window means of P planes (at stride `plane` floats from
// `row`, a row of width w), for output columns x0 .. x0 + n - 1 with n =
// min(span, w - x0); span is a multiple of kRun, at most kRowRuns kRun,
// and blockDim.x must be 32 P.  On return (all threads synchronized),
// tile_means(s, row_pitch(span, radius), q)[i] is the mean of plane q at
// column x0 + i.
template <int P>
__device__ __forceinline__ void row_tile_means(const float* __restrict__ row,
                                               size_t plane, int w, int x0,
                                               int span, int radius,
                                               double inv_area, double* s) {
  constexpr int kBatch = 8;  // loads in flight per thread while staging
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(span, w - x0);
  const int pitch = row_pitch(span, radius);
  // staged: leave[k] = x[x0 + k - r - 1] and enter[k] = x[x0 + k + r] for
  // k < n, the 2r + 1 - entering taps between them (gap) left out
  const int entering = min(2 * radius + 1, n);
  const int gap = 2 * radius + 1 - entering;
  const int staged = n + entering;
  const float* src = row + static_cast<size_t>(q) * plane;
  double* dst = s + static_cast<size_t>(q) * pitch;
  auto tap = [&](int c) {
    return src[static_cast<unsigned>(c) < static_cast<unsigned>(w)
                   ? c
                   : reflect(c, w)];
  };
  // warp q stages plane q: one float64 conversion per staged value
  for (int i0 = lane; i0 < staged; i0 += 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 32 * u;
      v[u] = i < staged ? tap(x0 - radius - 1 + i + (i < n ? 0 : gap)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + 32 * u < staged) dst[i0 + 32 * u] = static_cast<double>(v[u]);
  }
  // S(x0): the first output's window, across the lanes (a butterfly, so
  // every lane holds the same sum)
  double window = 0.0;
  for (int t = lane; t <= 2 * radius; t += 32)
    window += static_cast<double>(tap(x0 - radius + t));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    window += __shfl_xor_sync(0xffffffffu, window, d);
  __syncwarp();  // plane q is staged (only warp q reads it)

  const double* leave = dst;
  const double* enter = dst + entering;
  // lane `lane`: outputs first .. first + kRun - 1; its run's steps,
  // S(x0 + first + kRun) - S(x0 + first), within the tile
  const int first = lane * kRun;
  double steps = 0.0;
  if (first < n) {
#pragma unroll
    for (int k = 1; k <= kRun; ++k)
      if (first + k < n) {
        steps += enter[first + k];
        steps -= leave[first + k];
      }
  }
  // inclusive scan of the runs' steps, then S at this run's first output
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, steps, d);
    if (lane >= d) steps += v;
  }
  const double before = __shfl_up_sync(0xffffffffu, steps, 1);
  float mean[kRun];
  if (first < n) {
    double acc = lane > 0 ? window + before : window;
    mean[0] = static_cast<float>(acc * inv_area);
#pragma unroll
    for (int k = 1; k < kRun; ++k) {
      if (first + k < n) {
        acc += enter[first + k];
        acc -= leave[first + k];
      }
      mean[k] = static_cast<float>(acc * inv_area);
    }
  }
  __syncwarp();  // every tap of plane q read before a mean overwrites it
  if (first < n) {
    float* m = tile_means(s, pitch, q) + first;
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (first + k < n) m[k] = mean[k];
  }
  __syncthreads();
}

// Launch shape of a row pass over `planes` planes: output columns per block
// (span: kRowRuns runs of kRun, fewer where w is narrower or where
// `planes` staged pitches would exceed the shared memory a block may use,
// at least one run), dynamic shared memory in bytes (and the kernel's limit
// set where it exceeds 48 KB), grid (ceil(w / span), h, n) and 32 planes
// threads.  A single run's pitch, 2 kRun doubles, fits any pass.
template <typename Kernel>
inline cudaError_t row_launch(Kernel kernel, int planes, int n, int h, int w,
                              int radius, int* span, int* smem, dim3* grid,
                              dim3* block) {
  const long long limit =
      device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(227 * 1024);
  int runs = (w + kRun - 1) / kRun;
  runs = runs < 1 ? 1 : runs > kRowRuns ? kRowRuns : runs;
  auto bytes = [&](int r) {
    return static_cast<long long>(planes) * row_pitch(r * kRun, radius) *
           static_cast<long long>(sizeof(double));
  };
  while (runs > 1 && bytes(runs) > limit) --runs;
  *span = runs * kRun;
  *smem = static_cast<int>(bytes(runs));
  *grid = dim3((w + *span - 1) / *span, h, n);
  *block = dim3(32 * planes);
  return smem_limit(kernel, *smem);
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
// Launch shape: row_launch with 4C planes.
template <int C>
__global__ void __launch_bounds__(32 * 4 * C)
gf_apply_rows(const float* __restrict__ abcol, const float* __restrict__ guide,
              float* __restrict__ out, int h, int w, int span, int radius,
              double inv_area) {
  constexpr int P = 4 * C;
  extern __shared__ double s[];
  const int pitch = row_pitch(span, radius);
  const int x0 = blockIdx.x * span;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t row = static_cast<size_t>(blockIdx.y) * w;
  row_tile_means<P>(abcol + blockIdx.z * P * plane + row, plane, w, x0, span,
                    radius, inv_area, s);
  const int n = min(span, w - x0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float m[P];
#pragma unroll
    for (int q = 0; q < P; ++q) m[q] = tile_means(s, pitch, q)[i];
    const float* I = guide + blockIdx.z * 3 * plane + row + x0 + i;
    const float i0 = I[0], i1 = I[plane], i2 = I[2 * plane];
    float* o = out + blockIdx.z * C * plane + row + x0 + i;
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[c * plane] =
          m[c] * i0 + m[C + c] * i1 + m[2 * C + c] * i2 + m[3 * C + c];
  }
}

// 1 / (2r + 1)^2
inline double inv_area(int radius) {
  const double wd = 2.0 * radius + 1.0;
  return 1.0 / (wd * wd);
}

}  // namespace
}  // namespace rf
