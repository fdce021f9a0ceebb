// Shared device helpers of the hand-written Hopper kernels.
//
// Every distance in the port is "smaller = closer": squared L2 as
// (||q||^2 + ||x||^2) - 2<x, q>, in that association, or -<x, q> for inner
// product.  `warp_dot` fixes one reduction order (lane-strided fmaf
// partials, then an xor butterfly), so the gather kernel and the fused hop
// kernel produce the same bits for the same (query, row) pair.  The
// butterfly leaves the identical sum in every lane because float addition
// is commutative.  The combine uses explicit round-to-nearest intrinsics so
// nvcc cannot contract it into an fma.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// <a, b> over D floats, computed by one full warp; every lane gets the sum.
__device__ __forceinline__ float warp_dot(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int D, int lane) {
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(a[d], b[d], acc);
  return warp_sum(acc);
}

__device__ __forceinline__ float l2_combine(float q2, float x2, float prod) {
  return __fsub_rn(__fadd_rn(q2, x2), __fmul_rn(2.0f, prod));
}
