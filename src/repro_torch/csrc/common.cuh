// Shared device helpers of the hand-written Hopper kernels.
//
// Every distance in the port is "smaller = closer": squared L2 as
// (||q||^2 + ||x||^2) - 2<x, q>, in that association, or -<x, q> for inner
// product.  `warp_dot` fixes one reduction order (lane-strided fmaf
// partials, `lane_dot`, then an xor butterfly), so the gather kernels and
// the fused hop kernel produce the same bits for the same (query, row)
// pair, whether a warp sums one row or two at once.  The
// butterfly leaves the identical sum in every lane because float addition
// is commutative.  `warp_dot_i8` does the same for the int8 code table.
// The combine uses explicit round-to-nearest intrinsics so nvcc cannot
// contract it into an fma.
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

// One lane's partial of <a, b> over D floats (lane-strided fmaf chain).
__device__ __forceinline__ float lane_dot(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int D, int lane) {
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// <a, b> over D floats, computed by one full warp; every lane gets the sum.
__device__ __forceinline__ float warp_dot(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int D, int lane) {
  return warp_sum(lane_dot(a, b, D, lane));
}

// One lane's partial of <codes, q> over D int8 codes and D floats,
// accumulated in f32 (the raw dot of the quantized tier; the caller applies
// the row's scale to the sum).  When D is a multiple of 4 each lane loads a
// char4 (a D = 128 row is one 128-byte transaction), else one byte per
// step.
__device__ __forceinline__ float lane_dot_i8(const signed char* __restrict__ x,
                                             const float* __restrict__ q,
                                             int D, int lane) {
  float acc = 0.0f;
  if ((D & 3) == 0) {
    const char4* x4 = reinterpret_cast<const char4*>(x);
    for (int c = lane; c < (D >> 2); c += 32) {
      const char4 v = x4[c];
      const float* qc = q + 4 * c;
      acc = fmaf((float)v.x, qc[0], acc);
      acc = fmaf((float)v.y, qc[1], acc);
      acc = fmaf((float)v.z, qc[2], acc);
      acc = fmaf((float)v.w, qc[3], acc);
    }
  } else {
    for (int d = lane; d < D; d += 32) acc = fmaf((float)x[d], q[d], acc);
  }
  return acc;
}

// <codes, q> by one full warp.  The quantized gather kernel and the
// quantized fused hop kernel share it, so the two engines give the same
// bits.
__device__ __forceinline__ float warp_dot_i8(const signed char* __restrict__ x,
                                             const float* __restrict__ q,
                                             int D, int lane) {
  return warp_sum(lane_dot_i8(x, q, D, lane));
}

__device__ __forceinline__ float l2_combine(float q2, float x2, float prod) {
  return __fsub_rn(__fadd_rn(q2, x2), __fmul_rn(2.0f, prod));
}
