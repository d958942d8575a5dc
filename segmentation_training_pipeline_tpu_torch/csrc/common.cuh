// Helpers shared by the port's kernels (warp_xy.cu, elastic.cu, shear.cu).
// Each source is its own library, so these are defined inline in each.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// a in [0, 2n) -> a mod n: exact for the sum of two indices in [0, n)
__device__ __forceinline__ int wrap_once(int a, int n) {
  return a >= n ? a - n : a;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
