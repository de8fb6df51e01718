// K2 — self-guided gray bilateral filter with OpenCV semantics.
//
// Replaces reflectance_filtering_tpu/ops/bilateral_pallas.py::
// _kernel_gray_self (via bilateral_gray_self_batched) and its lane-packed
// twin ::_kernel_gray_self_packed, which computes the same function.
//
// What it computes: cv2's bilateral filter with joint == src for a gray
// plane that stands for `reps` identical channels (the BF(CNN,CNN) case:
// the CNN's -r.png reads back as three equal channels).  For each pixel p,
// over the disk of taps q with dx^2 + dy^2 <= radius^2 (OpenCV's
// sqrt(...) > radius exclusion, as an exact integer test):
//   out(p) = sum_q w(q) x(q) / sum_q w(q)          (one divide at the end)
// with BORDER_REFLECT_101 borders and, by the input's type:
//   * uint8 levels (both product callers): cv2's table form,
//       w(q) = sw[dx^2 + dy^2] * cw[|x(q) - x(p)|],
//     with cw[i] = f32(exp((reps i)^2 gcc)) (cv2's color_weight) and
//     sw[s] = f32(exp(s gsc)) (its space_weight), both computed in float64
//     on the host; no exp on the card;
//   * float32 values (the JAX function's float domain):
//       w(q) = expf(reps^2 (x(q) - x(p))^2 gcc + (dx^2 + dy^2) gsc).
// Output f32 [N, H, W] either way.
//
// What bounds it on an H100: the work per tap.  At sigma_s = 22 the disk
// has 3,409 taps, so a call at 32 x 256x256 walks 7.15 G taps, and device
// memory sees 5 bytes per pixel (uint8 in, f32 out).  On uint8 levels a
// tap is one range-table load from shared memory (the bound counts 32
// such loads per SM per clock), a multiply, an FMA and an add; the float
// form pays an expf on the SFU.  The design keeps everything else off that
// path:
//   * one block per tile loads the tile and its radius-wide halo into
//     shared memory once, as bytes for uint8 input (at r = 33, a 32 x 128
//     tile and its halo are 98 rows of 320 B = 31 KB, a quarter of their
//     floats), widened with an integer OR and a float subtract (get(),
//     bilateral_common.cuh), so no conversion pipe is used;
//   * each thread computes several adjacent pixels of a row (8 for uint8,
//     4 for float): along a disk row a window of tile values slides 4
//     columns at a time, so one value read from shared memory serves every
//     pixel of the thread, and so does one spatial weight;
//   * every thread walks the same taps in the same order (the disk row by
//     row, dx ascending), so no warp diverges, the spatial weight is read
//     at one address by the whole warp (a broadcast), and a pixel's sums
//     run in the plain version's tap order;
//   * the range table lives in shared memory, replicated per bank with one
//     entry per signed difference (RangeTable, 64 KB): a warp's 32
//     lookups are one conflict-free wavefront and a lookup is one
//     shift-and-add.  scripts/measure_k2_table.py times it against one
//     signed table (2 KB, bank conflicts when a warp's differences spread)
//     and a replicated table of |d| (32 KB, two more integer operations a
//     lookup), built from this template;
//   * the uint8 blocks are 16 x 32 threads, so that one 64 KB table serves
//     16 warps, two blocks per SM; the float blocks, which hold no table,
//     16 x 16 threads over a 16 x 64 tile (their floats fit up to r = 100);
//   * borders are reflected by index while the tile loads, only for
//     indices outside the plane (reflect101, shared with K6);
//   * a radius whose tile, halo and tables pass a block's shared memory
//     takes the disk's rows in bands (bilateral_gray_self_banded_kernel):
//     each band stages only the tile rows its disk rows read, and the
//     spatial weights are read from device memory; the taps keep their
//     order, so the sums are the one-band kernel's.  The product's radii
//     (33 and below) run in one band.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_gray_self.cuh"

// x [n, h, w] uint8 (u8 = 1) or f32 (u8 = 0), out [n, h, w] f32, tables
// [256 + radius^2 + 1] f32 (uint8 input only: cw by |d|, then sw by
// dx^2 + dy^2), all on the device; g2 = reps^2 * gcc (the float form's).
// Returns the cudaError_t of the attribute call or of the launch.  Any
// radius runs: where the tile and its halo (and, for uint8, the tables)
// pass a block's 227 KB (float input: r > 100; uint8: r > 113), the disk's
// rows are taken in bands (k2::band_rows; cudaErrorInvalidValue only where
// not one disk row fits: float radii past
// about 1,780, uint8 past about 2,500).
extern "C" int rf_bilateral_gray_self(const void* x, float* out, const float* tables,
                                      int n, int h, int w, int u8, int radius, float g2,
                                      float gsc, cudaStream_t stream) {
  if (u8)
    return k2::launch_any_radius<uint8_t, k2::RangeTable, 8, 32>(x, out, tables, n, h, w,
                                                                 radius, g2, gsc, stream);
  return k2::launch_any_radius<float, k2::RangeTable, 4, 16>(x, out, tables, n, h, w, radius,
                                                             g2, gsc, stream);
}
