// Fused gather + distance over the int8 code table (the quantized tier).
//
// Replaces the TPU kernel repro/kernels/quant_gather.py::
// gather_distance_batched_q (body _kernel_batched_q): for a (B, K) id tile,
// gather int8 rows of `codes` and score each against queries[b]:
//   prod = (codes[id] . q) * scale[id]   (raw dot in f32, then the scale)
//   l2:  (||q||^2 + qnorm[id]) - 2 prod,   ip: -prod;
// INVALID (< 0) ids give +inf.  That op order is the quantized tier's
// contract (repro/core/quant.py); the product is rounded explicitly so nvcc
// cannot contract it into the combine.
//
// Bound on the H100: bytes.  Each output reads one random D-byte row plus
// its id, scale and qnorm (about B*K*(D + 12) bytes) and does 2D flops.
// The TPU version issues one blocking row DMA after another and gathers the
// scales and qnorms outside the kernel; here one warp owns one (b, k)
// output, a D = 128 row is one 128-byte transaction (a char4 per lane), the
// scale and qnorm are read in-kernel, and thousands of rows are in flight
// across the grid.
#include "common.cuh"

template <bool L2>
__global__ void __launch_bounds__(256)
quant_gather_kernel(const int* __restrict__ ids,
                    const float* __restrict__ queries,
                    const signed char* __restrict__ codes,
                    const float* __restrict__ scales,
                    const float* __restrict__ qnorms,
                    float* __restrict__ out, long long n_out, int K, int N,
                    int D) {
  const long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_out) return;
  const int id = ids[w];
  if (id < 0) {
    if (lane == 0) out[w] = CUDART_INF_F;
    return;
  }
  const int sid = id < N ? id : N - 1;
  const float* q = queries + (w / K) * (long long)D;
  const float raw = warp_dot_i8(codes + (long long)sid * D, q, D, lane);
  const float prod = __fmul_rn(raw, scales[sid]);
  float d;
  if (L2) {
    const float q2 = warp_dot(q, q, D, lane);
    d = l2_combine(q2, qnorms[sid], prod);
  } else {
    d = -prod;
  }
  if (lane == 0) out[w] = d;
}

extern "C" int quant_gather_launch(const int* ids, const float* queries,
                                   const signed char* codes,
                                   const float* scales, const float* qnorms,
                                   float* out, int B, int K, int N, int D,
                                   int l2, void* stream) {
  const long long n_out = (long long)B * K;
  if (n_out == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_out * 32 + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (l2) {
    quant_gather_kernel<true><<<blocks, threads, 0, s>>>(
        ids, queries, codes, scales, qnorms, out, n_out, K, N, D);
  } else {
    quant_gather_kernel<false><<<blocks, threads, 0, s>>>(
        ids, queries, codes, scales, qnorms, out, n_out, K, N, D);
  }
  return (int)cudaGetLastError();
}
