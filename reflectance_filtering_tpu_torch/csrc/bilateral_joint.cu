// K6 — joint bilateral filter with OpenCV semantics, for every (joint, src)
// pairing the bilateral CLI and the width-sharded filter meet.
//
// Replaces, in reflectance_filtering_tpu/ops/bilateral_pallas.py:
//   * _kernel (joint_bilateral_planar_batched): float values, joint and src
//     distinct (the float form);
//   * _kernel_color_self (bilateral_color_self_batched) and its lane-packed
//     twin _kernel_color_self_packed: joint == src, three u8-valued planes
//     (cv2.bilateralFilter on a color image; the uint8 form, SELF);
//   * _kernel_packed_joint (bilateral_packed_joint_batched) and its
//     lane-packed twin _kernel_packed_joint_lanes: u8-valued joint != src
//     (the uint8 form).
// The TPU kernels pack two u8 streams into one f32 mantissa, and three
// images along the lanes, to cut the XLU rolls that bound them; Hopper
// reads shared memory by address and has no rolls, so neither carries over.
//
// For each output pixel p, over the disk of taps q with dx^2 + dy^2 <=
// radius^2 (an exact integer test, as K2), with BORDER_REFLECT_101 borders
// (reflect101, bilateral_common.cuh) and one divide at the end:
//   out_c(p) = sum_q w(q) S_c(q) / sum_q w(q),  D = sum_c |J_c(q) - J_c(p)|
// and, by the wrapper:
//   * the float form (values need not be integers): the TPU kernel's
//       w(q) = exp(D^2 gcc + (dx^2 + dy^2) gsc), gcc holding joint_reps^2,
//     as 2^(lsw[dx^2 + dy^2] - (k D)^2), k^2 = -gcc log2 e: lsw[s] =
//     f32(s gsc log2 e) a float64-built table, the power one ex2.approx
//     (MUFU.EX2) of one float32 FMA, k computed on the host and applied to
//     the joint values as the tile is filled;
//   * the uint8 form (inputs hold integers 0-255): cv2's table form,
//       w(q) = sw[dx^2 + dy^2] * cw[D],
//     cw[i] = f32(exp((joint_reps i)^2 gcc)) for i = 0 .. 255 cj (cv2's
//     color_weight, 766 entries at cj = 3) and sw[s] = f32(exp(s gsc)),
//     both computed in float64 on the host; no exp on the card.
// joint f32 [N, CJ, H, W], src f32 [N, CS, H, W] (unused when SELF: the
// src planes are the joint planes), out f32 [N, CS, H, W].
//
// What bounds it on an H100: the work per tap.  At sigma_s = 22 a pixel
// walks 3,409 taps; a call at 8 x 256x256 walks 1.79 G, and device memory
// sees each input value once per block.
//   * The float form (bilateral_joint_float.cuh): one block per 16 x 32
//     output tile holds the tile and its radius-wide halo in shared memory,
//     a position's joint and src values side by side (one 16-byte load for
//     cj + cs = 4).  Its first port gave each thread one pixel and paid an
//     expf, an int-to-float conversion and four loads a tap, ~28 issued
//     instructions (1.89 ms at 8 x 256x256, cj = 3, cs = 1, against 0.43
//     ms for its expf alone).  Now a thread takes 4 adjacent pixels of a
//     row and slides a window of 7 positions 4 at a time, so one load and
//     one spatial term serve 4 pixels; a tap costs D's subtractions and
//     adds, the exponent's FMA, MUFU.EX2, an FMA per src plane and an add
//     (9 for cj = 3, cs = 1; the compiled loop issues 11.4 a pixel-tap, the
//     first port's 29, and the call takes 0.87 ms on an H100).  A tile row
//     is stored as 4 runs of every 4th column, so a quarter warp's 16-byte
//     loads (8 lanes of a row) hit 32 banks.  128 threads cover the tile;
//     four such groups of 4 warps split the disk's rows (dy mod 4), each
//     row's sums kept apart and added to its group's, the groups' added in
//     order at the end, so the SM, which holds one block at r = 33 and
//     cj + cs = 4 (128 KB), keeps 16 warps.  The footprint, and so each
//     pairing's largest one-band radius, is the first port's.
//     scripts/measure_k6_float.py times other geometries, the factored
//     weight sw[s] * 2^(-(k D)^2) and the first port (PERF.md).
//   * The uint8 form (bilateral_joint_u8.cuh), K2's design with several
//     joint planes: a tap is one range-table load from shared memory (the
//     bound counts 32 such loads per SM per clock), a multiply, an FMA per
//     src plane and an add.  A pixel's joint bytes share one 32-bit tile
//     word, so D is one __vsadu4 of two words; its src bytes sit above them
//     (or, for cj = cs = 3 with joint != src, in a second word array).
//     Each thread computes 8 adjacent pixels of a row, sliding a window of
//     11 words 4 columns at a time, so one word read and its src bytes
//     widened to floats (a byte permute and a subtract) serve 8 pixels,
//     and the spatial weight is read at one address by the whole warp; a
//     tile row is stored as 8 runs of every 8th column, so that the lanes'
//     window loads, 8 columns apart, fall on consecutive words.  The range
//     table is held in 16 copies (cw[D] for lane l at word 16 D + l % 16, 49
//     KB at cj = 3): lanes l and l + 16 meet in a bank only when their sums
//     differ with the same parity.  scripts/measure_k6_table.py times it
//     against a copy per bank (98 KB, conflict-free) and one table; on 1/f
//     photos at 8 x 256x256 it was 1.2-1.5% faster than the copy per bank
//     in both main cases, twice; one table won the color-self case by 4-5%
//     and lost BF(reflectance, photo) by 15-16% (PERF.md).  With the 128 x
//     32 tile (76 KB of words at r = 33) one block of 16 warps fills an
//     SM, and 8 x 256x256 is 128 blocks: one wave on 132 SMs.
//   * Both forms take any radius.  Where a pairing's tile and halo (and,
//     in the uint8 form, its tables) would pass a block's 227 KB, the
//     disk's rows are taken in bands (each form's banded kernel): a band
//     stages only the tile rows its disk rows read, the uint8 form reads
//     its spatial weights from device memory, and a pixel's taps keep
//     their order, so the sums are the one-band kernel's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_common.cuh"
#include "bilateral_joint_float.cuh"
#include "bilateral_joint_u8.cuh"


// joint [n, cj, h, w], src [n, cs, h, w] (ignored when self_guided), out
// [n, cs, h, w], all f32 on the device; cj, cs in {1, 3}.  u8 = 1: the
// uint8 form (inputs holding integers 0-255), with tables = [cw (255 cj +
// 1) | sw (radius^2 + 1)] f32 on the device, joint_reps folded into cw;
// self_guided takes only cj = cs = 3 with u8 = 1 (the color self-guided
// filter).  u8 = 0: the float form, tables = lsw (radius^2 + 1) f32 on
// the device and gcc = k = sqrt(-(range coefficient) joint_reps^2
// log2(e)), the scale of the joint values (gsc unread).  Returns the
// cudaError_t of the attribute call or of the launch
// (cudaErrorInvalidValue for a pairing that has no instantiation).  Any
// radius runs: where a pairing's tile and halo (and tables) pass the 227
// KB a block can take, the disk's rows are taken in bands (band_rows in
// each form's header; the product's radius, 33, is one band in every
// pairing).
extern "C" int rf_bilateral_joint(const float* joint, const float* src,
                                  float* out, const float* tables, int n, int cj,
                                  int cs, int h, int w, int self_guided, int u8,
                                  int radius, float gcc, float gsc,
                                  cudaStream_t stream) {
  if (u8)
    return k6u8::launch_any_radius<4>(cj, cs, self_guided, joint, src, out, tables, n, h, w,
                                      radius, stream);
  if (self_guided) return static_cast<int>(cudaErrorInvalidValue);
  return k6f::launch_any_radius<4, 4, true>(cj, cs, joint, src, out, tables, n, h, w, radius,
                                            gcc, stream);
}
