// Shared by the bilateral kernels K2 (bilateral_gray_self.cu) and K6
// (bilateral_joint.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
