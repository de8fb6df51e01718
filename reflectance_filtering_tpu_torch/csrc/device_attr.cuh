// A device attribute read once per device, for the launchers that size
// their grids by the card (box_common.cuh's column pass, K8's bands).
#pragma once

#include <cuda_runtime.h>

// Each source that includes this file gets its own copy (internal linkage),
// so the sources link into one library without clashing symbols.
namespace rf {
namespace {

// Attribute A of the current device, read once per device; `fallback` (an
// H100's value) where it cannot be read.
template <cudaDeviceAttr A>
inline int device_attr(int fallback) {
  static int value[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();  // do not let it surface at a later launch
    return fallback;
  }
  if (value[dev] == 0 &&
      cudaDeviceGetAttribute(&value[dev], A, dev) != cudaSuccess) {
    cudaGetLastError();
    value[dev] = 0;
    return fallback;
  }
  return value[dev];
}

}  // namespace
}  // namespace rf
