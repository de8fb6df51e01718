// Two other shared-memory layouts of K2's uint8 range table, for
// scripts/measure_k2_table.py only (the product library does not build
// them: _build compiles csrc/*.cu).  Both run K2's kernel template at the
// product's geometry; only the table differs from the product's
// RangeTable (replicated per bank, one entry per signed difference,
// 64 KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/bilateral_gray_self.cuh"

namespace {

// One entry per signed difference, stored once (2 KB): a lookup is one
// add from a per-pixel base; a warp's lookups conflict when its
// differences fall 32 words apart.
struct SignedTable {
  static constexpr int kFloats = k2::kDiffs;
  __device__ static void fill(float* tab, const float* cw, int tid, int nthreads) {
    for (int i = tid; i < kFloats; i += nthreads) tab[i] = cw[abs(i - (k2::kLevels - 1))];
  }
  struct Cursor {
    const float* base;
    __device__ Cursor() {}
    __device__ Cursor(const float* tab, int c) : base(tab + (k2::kLevels - 1) - c) {}
    __device__ void tap(int v, float vf, float sp, float& acc, float& wsum) const {
      const float wgt = sp * base[v];
      acc = fmaf(wgt, vf, acc);
      wsum += wgt;
    }
  };
};

// cw[|d|] replicated per bank (256 x 32 x 4 B = 32 KB): conflict-free like
// the product's, at half its size, for an abs and one more add a lookup.
struct AbsReplicatedTable {
  static constexpr int kFloats = k2::kLevels * 32;
  __device__ static void fill(float* tab, const float* cw, int tid, int nthreads) {
    for (int i = tid; i < kFloats; i += nthreads) tab[i] = cw[i >> 5];
  }
  struct Cursor {
    const float* lane_tab;
    int center;
    __device__ Cursor() {}
    __device__ Cursor(const float* tab, int c)
        : lane_tab(tab + ((threadIdx.y * k2::kThreadsX + threadIdx.x) & 31)), center(c) {}
    __device__ void tap(int v, float vf, float sp, float& acc, float& wsum) const {
      const float wgt = sp * lane_tab[abs(v - center) << 5];
      acc = fmaf(wgt, vf, acc);
      wsum += wgt;
    }
  };
};

}  // namespace

// As rf_bilateral_gray_self with u8 = 1 (x uint8 [n, h, w], tables [256 +
// radius^2 + 1]) on layout 0 (SignedTable) or 1 (AbsReplicatedTable).
extern "C" int rf_k2_table_layout(int layout, const void* x, float* out, const float* tables,
                                  int n, int h, int w, int radius, float g2, float gsc,
                                  cudaStream_t stream) {
  if (layout == 0)
    return k2::launch<uint8_t, SignedTable, 8, 32>(x, out, tables, n, h, w, radius, g2, gsc,
                                                   stream);
  if (layout == 1)
    return k2::launch<uint8_t, AbsReplicatedTable, 8, 32>(x, out, tables, n, h, w, radius,
                                                          g2, gsc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
