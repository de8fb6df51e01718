// Shared by the bilateral kernels K2 (bilateral_gray_self.cu) and K6
// (bilateral_joint.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Shared memory one block can take on an H100 (227 KB); the wrappers'
// SMEM_LIMIT mirrors it.
constexpr int kSmemLimit = 232448;

// The disk rows each band of a banded bilateral kernel stages: where the
// whole disk (2r + 1 rows) does not fit one block, its rows are taken in
// bands of at most `most` rows (a multiple of `multiple` where `most` is
// at least that), as even as that allows.  0 where not one row fits.
// ops/bilateral_kernel.py and ops/bilateral_joint_kernel.py mirror it.
__host__ __device__ inline int even_band(int disk, int most, int multiple) {
  if (most < 1) return 0;
  if (most >= multiple) most -= most % multiple;
  const int bands = (disk + most - 1) / most;
  int band = (disk + bands - 1) / bands;
  band = (band + multiple - 1) / multiple * multiple;
  return band < most ? band : most;
}

// A spatial weight of a banded kernel, read from device memory (the table
// stays out of shared memory, which holds the band's rows): the same
// address in every thread, through the read-only cache.
template <bool kGlobal>
__device__ __forceinline__ float spatial(const float* sw, int s) {
  if constexpr (kGlobal) return __ldg(sw + s);
  return sw[s];
}

// A tile value as float.  2^23 + b has b in its low mantissa bits: exact
// for any byte, with an integer OR and one float subtract (no conversion
// pipe).
__device__ __forceinline__ float get(float v) { return v; }
__device__ __forceinline__ float get(uint8_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

// BORDER_REFLECT_101 by index, with period 2(n-1): reflection repeats when
// the radius exceeds the image (as OpenCV's borderInterpolate and numpy's
// "reflect" pad do), and a 1-pixel-wide dimension maps every index to 0.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// The largest dx with dx^2 <= rem (rem >= 0): the half-width of the disk's
// row at dy, rem = radius^2 - dy^2, as an exact integer test (OpenCV's
// sqrt(dx^2 + dy^2) > radius exclusion).
__device__ __forceinline__ int disk_half_width(int rem) {
  int dxmax = static_cast<int>(sqrtf(static_cast<float>(rem)));
  while (dxmax * dxmax > rem) --dxmax;
  while ((dxmax + 1) * (dxmax + 1) <= rem) ++dxmax;
  return dxmax;
}
