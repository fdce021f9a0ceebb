// Fused gather + distance for the beam-search loop.
//
// Replaces the TPU kernels repro/kernels/gather_distance.py::
// gather_distance_batched (body _kernel_batched) and ::gather_distance
// (body _kernel): for a (B, K) id tile, gather rows of `vectors` and score
// each against queries[b]; INVALID (< 0) ids give +inf.  The single-query
// kernel is the B = 1 launch, plus the path that recomputes ||x||^2 when no
// norms are given.
//
// Bound on the H100: bytes.  Each output reads one random D-float row plus
// its id and norm (about B*K*(4D + 8) bytes) and does 2D flops on it, far
// below the card's flop/byte balance.  The TPU version issues one blocking
// row DMA after another; here one warp owns one (b, k) output, so a row is
// read by 32 lanes in D/32 coalesced 128-byte transactions, the norm is
// loaded in-kernel, and thousands of rows are in flight across the grid.
#include "common.cuh"

template <bool L2, bool HAS_NORMS>
__global__ void __launch_bounds__(256)
gather_distance_kernel(const int* __restrict__ ids,
                       const float* __restrict__ queries,
                       const float* __restrict__ vectors,
                       const float* __restrict__ norms,
                       float* __restrict__ out, long long n_out, int K,
                       int N, int D) {
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
  const float* x = vectors + (long long)sid * D;
  const float prod = warp_dot(x, q, D, lane);
  float d;
  if (L2) {
    const float q2 = warp_dot(q, q, D, lane);
    const float x2 = HAS_NORMS ? norms[sid] : warp_dot(x, x, D, lane);
    d = l2_combine(q2, x2, prod);
  } else {
    d = -prod;
  }
  if (lane == 0) out[w] = d;
}

extern "C" int gather_distance_launch(const int* ids, const float* queries,
                                      const float* vectors,
                                      const float* norms, float* out, int B,
                                      int K, int N, int D, int l2,
                                      void* stream) {
  const long long n_out = (long long)B * K;
  if (n_out == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_out * 32 + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (!l2) {
    gather_distance_kernel<false, false><<<blocks, threads, 0, s>>>(
        ids, queries, vectors, norms, out, n_out, K, N, D);
  } else if (norms != nullptr) {
    gather_distance_kernel<true, true><<<blocks, threads, 0, s>>>(
        ids, queries, vectors, norms, out, n_out, K, N, D);
  } else {
    gather_distance_kernel<true, false><<<blocks, threads, 0, s>>>(
        ids, queries, vectors, norms, out, n_out, K, N, D);
  }
  return (int)cudaGetLastError();
}
