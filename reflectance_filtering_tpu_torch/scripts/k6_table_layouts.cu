// Two other shared-memory layouts of K6's uint8 range table, for
// scripts/measure_k6_table.py only (the product library does not build
// them: _build compiles csrc/*.cu).  Both run K6's uint8 kernel template
// (csrc/bilateral_joint_u8.cuh) at the product's geometry; only the table
// differs from the product's 16 copies (kShift = 4, 49 KB at cj = 3, where
// lanes l and l + 16 share copy l % 16 and conflict when their sums differ
// with the same parity):
//   * kShift = 5: a copy per bank (98 KB), conflict-free;
//   * kShift = 0: one table (3 KB), a warp's lookups conflict when their
//     sums fall 32 words apart.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/bilateral_joint_u8.cuh"

// As rf_bilateral_joint with u8 = 1 (tables [255 cj + 1 + radius^2 + 1])
// on layout 0 (a copy per bank) or 1 (one table).
extern "C" int rf_k6_table_layout(int layout, const float* joint, const float* src,
                                  float* out, const float* tables, int n, int cj, int cs,
                                  int h, int w, int self_guided, int radius,
                                  cudaStream_t stream) {
  if (layout == 0)
    return k6u8::launch_any<5>(cj, cs, self_guided, joint, src, out, tables, n, h, w,
                               radius, stream);
  if (layout == 1)
    return k6u8::launch_any<0>(cj, cs, self_guided, joint, src, out, tables, n, h, w,
                               radius, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
