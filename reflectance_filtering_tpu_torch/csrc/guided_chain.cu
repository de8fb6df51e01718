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
// Two entry points, each a sequence of separable column-then-row pairs
// (K5's, csrc/guided.cu, with the guide-only work split off):
//   rf_guide_stats, once per chain: the column sums of the 9 guide-moment
//     planes (I_k and the 6 unique I_i I_j, formed in registers), then
//     their row means and the solve, writing 9 stat planes [mI0 mI1 mI2 |
//     d00 d01 d02 d11 d12 d22];
//   rf_guided_apply_cached, once per application and group of at most 3
//     src channels: the column sums of p and I_k p only (4 planes per
//     channel), their row means with the cached statistics, writing a =
//     d . cov and b = mean(p) - a . mI, then K5's last pair (column sums
//     of a, b; row means and q = mean(a) . I + mean(b)).
//
// What bounds it on an H100: device traffic, once the window sums cost
// O(1) per output.  Each pair runs one of two ways, chosen by shape
// (fused_plan):
//   * fused (gc_stats_rows_fused, gc_solve_cached_rows_fused,
//     gf_apply_rows_fused): one kernel a pair, whose column sums never
//     reach device memory.  A thread-block cluster of up to 16 blocks owns
//     a tile of output columns and a segment of rows; block k walks the
//     columns k sb .. (k + 1) sb - 1 of the tile and its 2r halo columns
//     down the segment (a lane a column, its rows through a ring in shared
//     memory by asynchronous copies, as col_stream), and every band of
//     `rows` output rows stores their column sums, rounded to float32 as
//     the column pass stores them, into shared memory: its own and, for
//     the r columns at each side, its neighbour's (distributed shared
//     memory).  Other warps of the block then take the row windows of its
//     output columns from its own shared memory, in float64, and the
//     pair's per-pixel work, and write only the pair's output planes.
//     Only the tiles' halo columns (2r of a tile) are summed twice.  A 3x
//     chain is 1 + 3 x 2 = 7 launches and, at 4K and C = 1, reads and
//     writes 87 planes, plus the halos and each segment's first window;
//     the time goes to the SMs' work (the walks, the row windows), not to
//     device memory (PERF.md);
//   * six passes (the shapes whose ring and bands do not fit a block's
//     shared memory: radii past about 100 for the statistics, 200 for an
//     application at C = 1; fused_plan says which): the column passes
//     write the column sums (scratch `mom`) and the row passes read them
//     back.  The row passes slide a float64 window per lane along a run of
//     outputs (guided_common.cuh, row_tile_means: 4 staged taps per
//     output and plane at any radius), and the column passes slide one
//     down each column of a strip of 32, its rows streamed through a ring
//     in shared memory (box_common.cuh, col_stream), each input row
//     crossing device memory once a segment.  A 3x chain is 14 launches
//     and 153 planes at 4K, C = 1.
// Both routes sum the columns in float64 from each segment's first window,
// round them to float32, and slide the row windows in float64; they agree
// to that rounding, not bitwise (their segments and rows' first windows
// differ).  rf_guided_chain_pass runs any one pass of either route alone
// (for timing them apart).  Borders are mapped by index (box_common.cuh),
// so an application reads the previous one's plain output plane, at any
// radius, even one wider than the frame.  Offsets are size_t: one 4320 x
// 7680 image has 9 stat planes of 33.2 M floats.
#include <cooperative_groups.h>

#include <algorithm>

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

// ---------------------------------------------------------------------------
// The fused pairs (the header's first route).

constexpr int kFusedWalkers = 256;    // column walkers: a block's columns, at most
constexpr int kFusedConsumers = 256;  // row and per-pixel threads
constexpr int kFusedThreads = kFusedWalkers + kFusedConsumers;
constexpr int kFusedCluster = 16;     // blocks of a cluster, at most (H100)
constexpr int kFusedBandMax = 16;     // output rows of a band, at most
constexpr int kFusedAhead = 8;        // rows a walker has in flight
constexpr int kFusedPix = 8;          // a consumer's pixels a band, at most
constexpr int kFusedRound = 4;        // pixels a consumer reads at once

// What a fused kernel reads and writes, and its geometry (fused_plan):
// `sb` column sums a block, `rows` output rows a band, `tile` output
// columns a cluster, `seg` output rows a block, `depth` slots of the ring
// (2r + 1 + kAhead where it holds the window, else kAhead).
struct FusedArgs {
  const float* guide;  // [n, 3, h, w]
  const float* in;     // solve: src [n, C, h, w]; apply: ab [n, 4C, h, w]
  const float* stats;  // solve: [n, 9, h, w]
  float* out;          // statistics: stats; solve: ab; apply: out
  int h, w, radius, sb, rows, tile, seg, depth;
  double inv_area;
  float eps;
};

// The statistics (passes 0 and 1): the guide's 9 moment planes in
// (gf_moment_cols<0, true>'s terms), gc_stats_rows' per-pixel work.  A
// pair's per-pixel work (finish) reads kLoads values of the pixel, at
// source(pixel) + k plane, which the consumers read ahead.
struct StatsPair {
  static constexpr int kIn = 3, P = rf::kGuidePlanes, kLoads = 0;
  __device__ static void inputs(const FusedArgs& a, int z, size_t plane,
                                const float* (&in)[kIn]) {
#pragma unroll
    for (int q = 0; q < 3; ++q) in[q] = a.guide + (z * 3 + q) * plane;
  }
  __device__ static void terms(const double (&v)[kIn], double (&t)[P]) {
    const double i0 = v[0], i1 = v[1], i2 = v[2];
    t[0] = i0; t[1] = i1; t[2] = i2;
    t[3] = i0 * i0; t[4] = i0 * i1; t[5] = i0 * i2;
    t[6] = i1 * i1; t[7] = i1 * i2; t[8] = i2 * i2;
  }
  __device__ static const float* source(const FusedArgs&, int, size_t,
                                       size_t) {
    return nullptr;
  }
  __device__ static void finish(const FusedArgs& a, int z, size_t plane,
                                size_t at, const float (&m)[P], const float*) {
    float cof[6];
    const float inv_det = rf::guide_cofactors(m, a.eps, cof);
    float* o = a.out + z * P * plane + at;
    o[0] = m[0];
    o[plane] = m[1];
    o[2 * plane] = m[2];
#pragma unroll
    for (int k = 0; k < 6; ++k) o[(3 + k) * plane] = cof[k] * inv_det;
  }
};

// The solve (passes 2 and 3): the guide and src in (gf_moment_cols<C,
// false>'s terms), gc_solve_cached_rows' per-pixel work on the pixel's 9
// statistics.
template <int C>
struct SolvePair {
  static constexpr int kIn = 3 + C, P = 4 * C, kLoads = rf::kGuidePlanes;
  __device__ static void inputs(const FusedArgs& a, int z, size_t plane,
                                const float* (&in)[kIn]) {
#pragma unroll
    for (int q = 0; q < 3; ++q) in[q] = a.guide + (z * 3 + q) * plane;
#pragma unroll
    for (int c = 0; c < C; ++c) in[3 + c] = a.in + (z * C + c) * plane;
  }
  __device__ static void terms(const double (&v)[kIn], double (&t)[P]) {
    const double i0 = v[0], i1 = v[1], i2 = v[2];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double pc = v[3 + c];
      t[c] = pc;
      t[C + 3 * c] = i0 * pc;
      t[C + 3 * c + 1] = i1 * pc;
      t[C + 3 * c + 2] = i2 * pc;
    }
  }
  __device__ static const float* source(const FusedArgs& a, int z,
                                       size_t plane, size_t at) {
    return a.stats + z * rf::kGuidePlanes * plane + at;
  }
  __device__ static void finish(const FusedArgs& a, int z, size_t plane,
                                size_t at, const float (&m)[P],
                                const float* st) {
    const float mi0 = st[0], mi1 = st[1], mi2 = st[2];
    const float d00 = st[3], d01 = st[4], d02 = st[5];
    const float d11 = st[6], d12 = st[7], d22 = st[8];
    float* o = a.out + z * P * plane + at;
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
};

// The apply (passes 4 and 5): the 4C planes of (a, b) in, gf_apply_rows'
// per-pixel work on the pixel's guide.
template <int C>
struct ApplyPair {
  static constexpr int kIn = 4 * C, P = 4 * C, kLoads = 3;
  __device__ static void inputs(const FusedArgs& a, int z, size_t plane,
                                const float* (&in)[kIn]) {
#pragma unroll
    for (int q = 0; q < P; ++q) in[q] = a.in + (z * P + q) * plane;
  }
  __device__ static void terms(const double (&v)[kIn], double (&t)[P]) {
#pragma unroll
    for (int q = 0; q < P; ++q) t[q] = v[q];
  }
  __device__ static const float* source(const FusedArgs& a, int z,
                                       size_t plane, size_t at) {
    return a.guide + z * 3 * plane + at;
  }
  __device__ static void finish(const FusedArgs& a, int z, size_t plane,
                                size_t at, const float (&m)[P],
                                const float* I) {
    const float i0 = I[0], i1 = I[1], i2 = I[2];
    float* o = a.out + z * C * plane + at;
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[c * plane] =
          m[c] * i0 + m[C + c] * i1 + m[2 * C + c] * i2 + m[3 * C + c];
  }
};

// The floats of a block's band of column sums a plane row: its sb columns
// and r halo columns each side, padded to an odd count.
__host__ __device__ __forceinline__ int ext_pitch(int sb, int radius) {
  return (sb + 2 * radius) | 1;
}

// Slots of a fused block's ring: the window and the rows in flight where
// they fit (hold: each input row read once a segment), else kAhead
// entering and kAhead leaving rows (the leaving ones read again, mostly
// from L2), as col_stream.
__host__ __device__ __forceinline__ int ring_slots(int depth) {
  return depth > kFusedAhead ? depth : 2 * kFusedAhead;
}

// Bytes of a fused block's shared memory: the ring of kin values a column,
// two bands of column sums of `rows` rows of P planes with their halos,
// and one band of row means.
inline long long fused_smem(int kin, int planes, int radius, int sb,
                            int rows, int depth) {
  return 4 * (static_cast<long long>(ring_slots(depth)) * kin * sb +
              static_cast<long long>(rows) * planes *
                  (2LL * ext_pitch(sb, radius) + (sb | 1)));
}

// The shared::cluster address of `local` (this block's shared memory) in
// block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_address(const float* local,
                                                    int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(out)
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))),
        "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_store(unsigned address, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(address), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The consumer warps' own barrier (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFusedConsumers) : "memory");
}

// One fused block (see the header).  Cluster-local column j of tile t is
// image column border(t tile - r + j).  Block k (the cluster's rank) sums
// the columns j of k sb .. (k + 1) sb - 1 below the tile's ncols (sb >=
// r), and owns the outputs among them at r <= j < r + (the tile's
// outputs).  Its bands hold the columns k sb - r .. (k + 1) sb + r - 1
// (index e = j - k sb + r).
//
// Its first kFusedWalkers threads (walkers) walk a column each down the
// segment, col_stream's way, and store each band of `rows` output rows'
// column sums, rounded to float32, into the band of every block of the
// cluster that holds them: their own and, through distributed shared
// memory, a neighbour's halo.  The other kFusedConsumers threads
// (consumers) take each band's row windows from their own block's band
// (a thread a plane row and part of the outputs: its first window, then
// row_tile_means' steps, in float64), then the pair's per-pixel work, its
// inputs read before the band is ready.  One cluster barrier a band
// (split arrive and wait) keeps the two a band apart over two bands:
// phase b completes once every walker has stored band b and every
// consumer has read band b - 1, so walkers store band b + 1 while
// consumers read band b.  The walkers and the consumers took about the
// same time a band at 4K (the consumers' row windows the larger part).
template <class Pair>
__device__ __forceinline__ void fused_pair(const FusedArgs& a) {
  namespace cg = cooperative_groups;
  constexpr int kIn = Pair::kIn, P = Pair::P, kLoads = Pair::kLoads;
  constexpr int kAhead = kFusedAhead, kStep = rf::kStep;
  constexpr int kPix = kFusedPix, kRound = kFusedRound;
  cg::cluster_group cluster = cg::this_cluster();
  const int clusters = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = a.h, w = a.w, r = a.radius, sb = a.sb, R = a.rows;
  const int depth = a.depth;
  const int pitch = sb | 1, epitch = ext_pitch(sb, r);
  const int z = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const int x_tile = static_cast<int>(blockIdx.x) / clusters * a.tile;
  const int out_t = min(a.tile, w - x_tile);
  const int j0 = rank * sb;
  const int ja = max(j0, r);
  const int nout = max(0, min(j0 + sb, r + out_t) - ja);
  const int y0 = blockIdx.y * a.seg;
  const int rows = min(a.seg, h - y0);
  const int bands = (rows + R - 1) / R;
  extern __shared__ double fused_words[];
  float* ring = reinterpret_cast<float*>(fused_words);
  float* band = ring + static_cast<size_t>(ring_slots(depth)) * kIn * sb;
  float* means = band + 2 * R * P * epitch;
  const int tid = threadIdx.x;

  if (tid < kFusedWalkers) {
    // The walk of column j0 + tid: col_stream's ring (hold, or entering
    // and leaving rows), its first window, then one slide an output row.
    const bool walks = tid < sb && j0 + tid < out_t + 2 * r;
    const bool hold = depth > kAhead;
    const float* in[kIn];
    Pair::inputs(a, z, plane, in);
    if (walks) {
      const int x = rf::reflect(x_tile - r + j0 + tid, w);
#pragma unroll
      for (int q = 0; q < kIn; ++q) in[q] += x;
    }
    float* lane = ring + tid;  // slot s, plane q at (s kIn + q) sb
    float* leave = hold ? lane : lane + depth * kIn * sb;
    const int n = rows + 2 * r;
    int m = 0, at = 0;  // the row read next, and its slot
    double acc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] = 0.0;
    auto fetch = [&](int row, int slot) {
      if (row < n) {
        const size_t off =
            static_cast<size_t>(rf::border_in(y0 - r + row, h, false)) * w;
#pragma unroll
        for (int q = 0; q < kIn; ++q)
          rf::ring_copy(lane + (slot * kIn + q) * sb, in[q] + off);
        if (!hold && row > 2 * r) {
          const size_t from = static_cast<size_t>(rf::border_in(
                                  y0 - 3 * r - 1 + row, h, false)) * w;
#pragma unroll
          for (int q = 0; q < kIn; ++q)
            rf::ring_copy(leave + (slot * kIn + q) * sb, in[q] + from);
        }
      }
      rf::ring_commit();
    };
    auto load = [&](const float* from, int slot, double (&v)[kIn]) {
#pragma unroll
      for (int q = 0; q < kIn; ++q) v[q] = from[(slot * kIn + q) * sb];
    };
    auto loadf = [&](const float* from, int slot, float (&v)[kIn]) {
#pragma unroll
      for (int q = 0; q < kIn; ++q) v[q] = from[(slot * kIn + q) * sb];
    };
    auto next = [&](int s) { return s + 1 < depth ? s + 1 : 0; };
    auto ahead = [&](int s) {
      return s + kAhead < depth ? s + kAhead : s + kAhead - depth;
    };
    auto add = [&](const double (&v)[kIn]) {
      double t[P];
      Pair::terms(v, t);
#pragma unroll
      for (int q = 0; q < P; ++q) acc[q] += t[q];
    };
    // this column's places in a band: its own block's and, for the first
    // and last r columns, the left and right neighbours' halos
    const bool to_left = rank > 0 && tid < r;
    const bool to_right = rank + 1 < clusters && tid >= sb - r;
    float* self = nullptr;
    unsigned left = 0, right = 0;  // shared::cluster addresses
    auto store = [&](int i) {
      const int off = i * P * epitch;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float v = static_cast<float>(acc[q]);
        self[off + q * epitch] = v;
        if (to_left) cluster_store(left + 4 * (off + q * epitch), v);
        if (to_right) cluster_store(right + 4 * (off + q * epitch), v);
      }
    };
    auto slide = [&](int i, const float (&ef)[kIn], const float (&lf)[kIn]) {
      double e[kIn], l[kIn], te[P], tl[P];
#pragma unroll
      for (int q = 0; q < kIn; ++q) {
        e[q] = ef[q];
        l[q] = lf[q];
      }
      Pair::terms(e, te);
      Pair::terms(l, tl);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        acc[q] += te[q];
        acc[q] -= tl[q];
      }
      store(i);
    };
    if (walks) {
      for (int k = 0; k < kAhead; ++k) fetch(k, k);
      for (; m + kStep <= 2 * r + 1; m += kStep) {
        rf::ring_wait<kAhead - kStep>();
        double v[kStep][kIn];
        int slot[kStep];
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          slot[i] = at;
          load(lane, at, v[i]);
          at = next(at);
        }
#pragma unroll
        for (int i = 0; i < kStep; ++i) add(v[i]);
#pragma unroll
        for (int i = 0; i < kStep; ++i) fetch(m + kAhead + i, ahead(slot[i]));
      }
      for (; m <= 2 * r; ++m) {
        rf::ring_wait<kAhead - 1>();
        double v[kIn];
        load(lane, at, v);
        add(v);
        fetch(m + kAhead, ahead(at));
        at = next(at);
      }
    }
    for (int b = 0; b < bands; ++b) {
      const int nr = min(R, rows - b * R);
      float* bb = band + (b & 1) * R * P * epitch;
      if (walks) {
        self = bb + tid + r;
        if (to_left) left = cluster_address(bb + tid + sb + r, rank - 1);
        if (to_right) right = cluster_address(bb + tid - sb + r, rank + 1);
        int i = 0;
        if (b == 0) store(i++);
        // band rows i ..: row m enters, row m - 2r - 1 leaves
        for (; i + kStep <= nr; i += kStep, m += kStep) {
          rf::ring_wait<kAhead - kStep>();
          float e[kStep][kIn], l[kStep][kIn];
          int fill[kStep];
#pragma unroll
          for (int k = 0; k < kStep; ++k) {
            fill[k] = ahead(at);
            loadf(lane, at, e[k]);
            loadf(leave, fill[k], l[k]);
            at = next(at);
          }
#pragma unroll
          for (int k = 0; k < kStep; ++k) slide(i + k, e[k], l[k]);
#pragma unroll
          for (int k = 0; k < kStep; ++k) fetch(m + kAhead + k, fill[k]);
        }
        for (; i < nr; ++i, ++m) {
          rf::ring_wait<kAhead - 1>();
          float e[kIn], l[kIn];
          const int fill = ahead(at);
          loadf(lane, at, e);
          loadf(leave, fill, l);
          slide(i, e, l);
          fetch(m + kAhead, fill);
          at = next(at);
        }
      }
      __syncwarp();
      cluster_arrive();  // band b stored
      cluster_wait();    // ... everywhere, and band b - 1 read everywhere
    }
    return;
  }

  // The consumers.  Consumer thread ct takes the band's pixels ct + e
  // kFusedConsumers, e < kPix: their rows i and outputs o are the same in
  // every band.
  const int ct = tid - kFusedWalkers;
  const int u = ja - j0;  // band index of output 0's first tap
  int pix_i[kPix], pix_o[kPix];
#pragma unroll
  for (int e = 0; e < kPix; ++e) {
    const int p = ct + e * kFusedConsumers;
    pix_i[e] = nout > 0 ? p / nout : R;
    pix_o[e] = p - pix_i[e] * nout;
  }
  cluster_arrive();  // phase 0: no band read yet
  for (int b = 0; b < bands; ++b) {
    const int r0 = b * R, nr = min(R, rows - r0);
    // the per-pixel inputs of a round of the band's pixels, the first
    // read while its column sums arrive (both rounds where a pixel reads
    // few values: the registers hold them)
    constexpr bool kBoth = kLoads <= 3;
    float v[kBoth ? kPix : kRound][kLoads > 0 ? kLoads : 1];
    const size_t row0 = static_cast<size_t>(y0 + r0) * w + x_tile + (ja - r);
    auto pixel = [&](int e) {
      return row0 + static_cast<size_t>(pix_i[e]) * w + pix_o[e];
    };
    auto read = [&](int e0, int count) {
#pragma unroll
      for (int e = 0; e < count; ++e) {
        if (pix_i[e0 + e] >= nr) continue;
        const float* src = Pair::source(a, z, plane, pixel(e0 + e));
#pragma unroll
        for (int k = 0; k < kLoads; ++k) v[(kBoth ? e0 : 0) + e][k] = src[k * plane];
      }
    };
    read(0, kBoth ? kPix : kRound);
    cluster_wait();  // band b stored everywhere
    const float* bb = band + (b & 1) * R * P * epitch;
    // the row means: a thread a plane row and a part of the block's
    // outputs (as many parts as the consumers allow), its first window in
    // four partial sums, then slid (row_tile_means' steps), in float64
    const int pairs = nr * P, parts = max(1, kFusedConsumers / pairs);
    const int len = (nout + parts - 1) / parts;
    for (int t = ct; t < pairs * parts; t += kFusedConsumers) {
      const int pr = t % pairs, o0 = t / pairs * len;
      const int count = min(nout - o0, len);
      if (count <= 0) continue;
      const float* x = bb + pr * epitch + u + o0;  // x[k]: tap k of o0's window
      double part[4] = {0.0, 0.0, 0.0, 0.0};
      int k = 0;
      for (; k + 8 <= 2 * r + 1; k += 8) {
        float tap[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) tap[g] = x[k + g];
#pragma unroll
        for (int g = 0; g < 8; ++g) part[g & 3] += static_cast<double>(tap[g]);
      }
      for (; k <= 2 * r; ++k) part[0] += static_cast<double>(x[k]);
      double acc = (part[0] + part[1]) + (part[2] + part[3]);
      float* mo = means + pr * pitch + o0;
      mo[0] = static_cast<float>(acc * a.inv_area);
      // kSlide outputs at a time: their taps read before any mean is
      // stored (`means` and the band share the address space, so a store
      // would hold back the next loads)
      constexpr int kSlide = 8;
      for (int o = 1; o < count; o += kSlide) {
        float ent[kSlide], lea[kSlide], mean[kSlide];
#pragma unroll
        for (int g = 0; g < kSlide; ++g) {
          ent[g] = o + g < count ? x[o + g + 2 * r] : 0.0f;
          lea[g] = o + g < count ? x[o + g - 1] : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < kSlide; ++g) {
          acc += static_cast<double>(ent[g]);
          acc -= static_cast<double>(lea[g]);
          mean[g] = static_cast<float>(acc * a.inv_area);
        }
#pragma unroll
        for (int g = 0; g < kSlide; ++g)
          if (o + g < count) mo[o + g] = mean[g];
      }
    }
    consumers_sync();  // the band's means are in `means`
    if (b + 1 < bands) cluster_arrive();  // band b read
#pragma unroll
    for (int e0 = 0; e0 < kPix; e0 += kRound) {
      if (pix_i[e0] >= nr) break;  // later rounds' pixels lie further on
      if (!kBoth && e0 > 0) read(e0, kRound);
#pragma unroll
      for (int e = 0; e < kRound; ++e) {
        const int i = pix_i[e0 + e], o = pix_o[e0 + e];
        if (i >= nr) continue;
        float mv[P];
#pragma unroll
        for (int q = 0; q < P; ++q) mv[q] = means[(i * P + q) * pitch + o];
        Pair::finish(a, z, plane, pixel(e0 + e), mv, v[(kBoth ? e0 : 0) + e]);
      }
    }
    consumers_sync();  // `means` read before the next band writes it
  }
}

__global__ void __launch_bounds__(kFusedThreads, 1)
gc_stats_rows_fused(FusedArgs a) {
  fused_pair<StatsPair>(a);
}

template <int C>
__global__ void __launch_bounds__(kFusedThreads, 1)
gc_solve_cached_rows_fused(FusedArgs a) {
  fused_pair<SolvePair<C>>(a);
}

template <int C>
__global__ void __launch_bounds__(kFusedThreads, 1)
gf_apply_rows_fused(FusedArgs a) {
  fused_pair<ApplyPair<C>>(a);
}

// A fused launch's geometry (see FusedArgs), its cluster size, shared
// memory and grid (tiles x cluster, segments, images); ok false where the
// fused kernel does not take the shape.
struct FusedPlan {
  bool ok;
  int cluster, sb, rows, tile, seg, depth, smem;
  dim3 grid;
};

inline cudaLaunchConfig_t fused_config(int cluster, dim3 grid, int smem,
                                       cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kFusedThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's shared-memory limit raised to the device's, once per device.
template <auto Kernel>
inline cudaError_t fused_limit() {
  static bool set[64] = {false};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();
    dev = -1;
  }
  if (dev >= 0 && set[dev]) return cudaSuccess;
  cudaError_t err = rf::smem_limit(
      Kernel,
      rf::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(227 * 1024));
  // clusters past 8 blocks (the portable size) where the device has them
  if (err == cudaSuccess &&
      cudaFuncSetAttribute(Kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    cudaGetLastError();
  if (err == cudaSuccess && dev >= 0) set[dev] = true;
  return err;
}

// Clusters of `cluster` blocks of `smem` bytes the device holds at once.
template <auto Kernel>
inline int fused_clusters(int cluster, int smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fused_config(
      cluster, dim3(cluster, 1, 1), smem, nullptr, &attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, Kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// The fused plan of a pair with kin input and `planes` summed planes over n
// images of h x w at `radius`.  For each band height (16 or 8 rows) and
// ring (holding the window, or re-reading the leaving rows), the widest
// block strip whose ring and bands fit a block's shared memory (at most
// kFusedWalkers columns, at least r and 32, and at most kFusedPix pixels
// a consumer a band), then the tiles and segments (seg > 0 fixes the rows
// a block) that minimize a block's time: the waves of clusters the device
// holds, times the rows a block walks (15% more where the leaving rows
// are read again) and two rows' worth a band, times its columns and half
// the walkers (a band's row windows grow with the columns, a walk's step
// hardly).  Not ok where nothing fits, or where every tile would need
// more than kFusedCluster blocks: the six passes run.
template <auto Kernel>
FusedPlan fused_plan(int kin, int planes, int n, int h, int w, int radius,
                     int seg) {
  FusedPlan best = {};
  best.ok = false;
  if (n <= 0 || h <= 0 || w <= 0 || radius < 0 ||
      fused_limit<Kernel>() != cudaSuccess)
    return best;
  const long long limit =
      rf::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(227 * 1024);
  const int narrowest = std::max(radius, 32);
  double best_cost = 0.0;
  for (int rows = kFusedBandMax; rows >= 8; rows /= 2) {
    for (const bool hold : {true, false}) {
      const int depth = hold ? 2 * radius + 1 + kFusedAhead : kFusedAhead;
      int widest = 0;
      for (int sb = kFusedWalkers; sb >= narrowest && !widest; --sb)
        if (fused_smem(kin, planes, radius, sb, rows, depth) <= limit)
          widest = sb;
      if (!widest) continue;
      int last_tile = 0;
      for (int nx = 1; nx <= w; ++nx) {
        const int tile = (w + nx - 1) / nx;
        if (tile == last_tile) continue;
        last_tile = tile;
        const long long tiles = (w + tile - 1) / tile;
        const int need = tile + 2 * radius;
        const int cluster = (need + widest - 1) / widest;
        if (cluster > kFusedCluster) continue;
        const int sb = std::max((need + cluster - 1) / cluster, narrowest);
        if (rows * sb > kFusedConsumers * kFusedPix) continue;
        const int smem = static_cast<int>(
            fused_smem(kin, planes, radius, sb, rows, depth));
        const int fit = fused_clusters<Kernel>(cluster, smem);
        if (fit <= 0) continue;
        const long long per_row = tiles * n;  // clusters a segment row
        const long long most =
            seg > 0 ? 1
                    : std::min<long long>(h, std::max(1LL, fit / per_row));
        for (long long ns = 1; ns <= most; ++ns) {
          const int rows_a =
              seg > 0 ? seg : static_cast<int>((h + ns - 1) / ns);
          const int walked = std::min(rows_a, h);
          const long long segs = (h + rows_a - 1) / rows_a;
          const long long waves = (per_row * segs + fit - 1) / fit;
          const double cost =
              static_cast<double>(waves) * (kFusedWalkers / 2 + sb) *
              ((walked + 2.0 * radius) * (hold ? 1.0 : 1.15) +
               2.0 * ((walked + rows - 1) / rows));
          if (!best.ok || cost < best_cost) {
            best.ok = true;
            best_cost = cost;
            best.cluster = cluster;
            best.sb = sb;
            best.rows = rows;
            best.tile = tile;
            best.seg = rows_a;
            best.depth = depth;
            best.smem = smem;
            best.grid = dim3(static_cast<unsigned>(tiles * cluster),
                             static_cast<unsigned>(segs), n);
          }
        }
        if (per_row > 4LL * fit) break;  // more tiles only add waves
      }
    }
  }
  return best;
}

// fused_plan, kept for the last 16 shapes per kernel and device.
template <auto Kernel>
FusedPlan cached_plan(int kin, int planes, int n, int h, int w, int radius,
                      int seg) {
  struct Entry {
    bool used;
    int key[6];
    FusedPlan plan;
  };
  static Entry cache[16] = {};
  static int next = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    dev = -1;
  }
  const int key[6] = {dev, n, h, w, radius, seg};
  for (const Entry& e : cache)
    if (e.used && std::equal(key, key + 6, e.key)) return e.plan;
  Entry& e = cache[next];
  next = (next + 1) % 16;
  e.plan = fused_plan<Kernel>(kin, planes, n, h, w, radius, seg);
  std::copy(key, key + 6, e.key);
  e.used = true;
  return e.plan;
}

template <auto Kernel>
cudaError_t launch_fused(const FusedPlan& p, FusedArgs a,
                         cudaStream_t stream) {
  a.sb = p.sb;
  a.rows = p.rows;
  a.tile = p.tile;
  a.seg = p.seg;
  a.depth = p.depth;
  a.inv_area = rf::inv_area(a.radius);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      fused_config(p.cluster, p.grid, p.smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The fused plan of pass 6 (the statistics), 7 (the solve) or 8 (the
// apply) at C channels.
template <int C>
FusedPlan plan_of(int pass, int n, int h, int w, int radius, int seg) {
  switch (pass) {
    case 6:
      return cached_plan<gc_stats_rows_fused>(StatsPair::kIn, StatsPair::P,
                                              n, h, w, radius, seg);
    case 7:
      return cached_plan<gc_solve_cached_rows_fused<C>>(
          SolvePair<C>::kIn, SolvePair<C>::P, n, h, w, radius, seg);
    default:
      return cached_plan<gf_apply_rows_fused<C>>(
          ApplyPair<C>::kIn, ApplyPair<C>::P, n, h, w, radius, seg);
  }
}

// Whether the fused kernels take stage 0 (the statistics) or 1 (an
// application: both its pairs) at C channels and this shape.
template <int C>
bool fused_route(int stage, int n, int h, int w, int radius) {
  if (stage == 0) return plan_of<C>(6, n, h, w, radius, 0).ok;
  return plan_of<C>(7, n, h, w, radius, 0).ok &&
         plan_of<C>(8, n, h, w, radius, 0).ok;
}

// One pass of the chain (the passes of rf_guide_stats, then those of
// rf_guided_apply_cached, in order):
//   0 the guide's moment columns (guide -> mom, 9 planes),
//   1 the statistics' rows (mom -> stats),
//   2 the moment columns of p and I_k p (guide, src -> mom, 4C planes),
//   3 the solve's rows (mom, stats -> ab),
//   4 the column sums of ab (ab -> mom),
//   5 the apply's rows (mom, guide -> out);
// or one of the fused pairs that take their place:
//   6 the statistics (guide -> stats: passes 0 and 1),
//   7 the solve (guide, src, stats -> ab: passes 2 and 3),
//   8 the apply (ab, guide -> out: passes 4 and 5);
// the column passes (0, 2, 4) with items of `seg` rows (rf::col_launch's
// if 0), the fused pairs with blocks of `seg` rows (fused_plan's if 0;
// cudaErrorInvalidValue where the shape has no fused plan).
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
    case 6:
    case 7:
    case 8: {
      const FusedPlan plan = plan_of<C>(pass, n, h, w, radius, seg);
      if (!plan.ok) return cudaErrorInvalidValue;
      FusedArgs a = {};
      a.guide = guide;
      a.in = pass == 8 ? ab : src;
      a.stats = stats;
      a.out = pass == 6 ? stats : pass == 7 ? ab : out;
      a.h = h;
      a.w = w;
      a.radius = radius;
      a.eps = eps;
      if (pass == 6) return launch_fused<gc_stats_rows_fused>(plan, a, stream);
      if (pass == 7)
        return launch_fused<gc_solve_cached_rows_fused<C>>(plan, a, stream);
      return launch_fused<gf_apply_rows_fused<C>>(plan, a, stream);
    }
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

// fused_route at c channels (false for another c).
bool route(int c, int stage, int n, int h, int w, int radius) {
  switch (c) {
    case 1:
      return fused_route<1>(stage, n, h, w, radius);
    case 2:
      return fused_route<2>(stage, n, h, w, radius);
    case 3:
      return fused_route<3>(stage, n, h, w, radius);
    default:
      return false;
  }
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

// guide [n, 3, h, w] f32 (device) -> stats [n, 9, h, w]: the fused
// statistics where the shape has a fused plan, else passes 0 and 1 with
// the scratch mom [n, 9, h, w] (cudaErrorInvalidValue if mom is null
// there; rf_guided_chain_plan says which).  The wrapper keeps the grids
// within their limits (ops/guided_kernel.py::check_grid).  Returns the
// cudaError_t of the attribute call or the launches.
extern "C" int rf_guide_stats(const float* guide, float* stats, float* mom,
                              int n, int h, int w, int radius, float eps,
                              cudaStream_t stream) {
  const bool fused = route(1, 0, n, h, w, radius);
  if (!fused && mom == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_channels(1, fused ? 6 : 0, fused ? 6 : 1, 0,
                                      stats, guide, nullptr, nullptr, mom,
                                      nullptr, n, h, w, radius, eps, stream));
}

// stats [n, 9, h, w] (from rf_guide_stats with the same guide and radius),
// guide [n, 3, h, w], src and out [n, c, h, w] f32 (device); scratch ab
// [n, 4c, h, w], and mom [n, 4c, h, w] where the six passes run (as
// rf_guide_stats).  c must be 1, 2 or 3 (else cudaErrorInvalidValue); the
// wrapper keeps the grids within their limits.  Returns the cudaError_t of
// the attribute calls or the launches.
extern "C" int rf_guided_apply_cached(const float* stats, const float* guide,
                                      const float* src, float* out,
                                      float* mom, float* ab, int n, int c,
                                      int h, int w, int radius,
                                      cudaStream_t stream) {
  const bool fused = route(c, 1, n, h, w, radius);
  if (!fused && mom == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_channels(c, fused ? 7 : 2, fused ? 8 : 5, 0,
                                      const_cast<float*>(stats), guide, src,
                                      out, mom, ab, n, h, w, radius, 0.0f,
                                      stream));
}

// The fused plan of pass 6, 7 or 8 (chain_pass) at c channels on n images
// of h x w at `radius`, blocks of `seg` rows (0: the plan's), into
// plan[0..7]: ok (1: the fused kernel takes the shape; rf_guide_stats
// runs pass 6 where it does, rf_guided_apply_cached passes 7 and 8 where
// both do), the cluster's blocks, a block's columns, a band's rows, a
// tile's outputs, a block's rows, the ring's slots (2r + 1 + 16 where it
// holds the window) and a block's shared memory in bytes.  A
// host-side query (no stream).  Returns cudaErrorInvalidValue for another
// pass or c.
extern "C" int rf_guided_chain_plan(int pass, int c, int n, int h, int w,
                                    int radius, int seg, int* plan) {
  if (pass < 6 || pass > 8 || c < 1 || c > 3 || seg < 0 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedPlan p = c == 1   ? plan_of<1>(pass, n, h, w, radius, seg)
                      : c == 2 ? plan_of<2>(pass, n, h, w, radius, seg)
                               : plan_of<3>(pass, n, h, w, radius, seg);
  const int values[8] = {p.ok ? 1 : 0, p.cluster, p.sb,    p.rows,
                         p.tile,       p.seg,     p.depth, p.smem};
  std::copy(values, values + 8, plan);
  return static_cast<int>(cudaSuccess);
}

// The chain's passes one at a time, for timing them apart: pass 0..8 as
// chain_pass numbers them, the column passes with items of `seg` rows
// (0: the product's, rf::col_launch) and the fused pairs with blocks of
// `seg` rows (0: fused_plan's).  Arguments as the two entry points above
// (stats written by pass 1 or 6, read by pass 3 or 7; ab written by 3 or
// 7; eps read by passes 1 and 6 only).  Returns the cudaError_t of the
// attribute call or the launch, cudaErrorInvalidValue for another pass,
// seg or c, or a fused pass the shape has no plan for.
extern "C" int rf_guided_chain_pass(int pass, int seg, float* stats,
                                    const float* guide, const float* src,
                                    float* out, float* mom, float* ab, int n,
                                    int c, int h, int w, int radius,
                                    float eps, cudaStream_t stream) {
  if (pass < 0 || pass > 8 || seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_channels(c, pass, pass, seg, stats, guide, src,
                                      out, mom, ab, n, h, w, radius, eps,
                                      stream));
}
