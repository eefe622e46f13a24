// What the kernels' host code reads of the current device.
#pragma once

#include <cuda_runtime.h>

// The current device's SM count (read once a device).
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = counts[dev % 64];
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}
