// Fused gather + distance for the beam-search loop.
//
// Replaces the TPU kernels repro/kernels/gather_distance.py::
// gather_distance_batched (body _kernel_batched) and ::gather_distance
// (body _kernel): for a (B, K) id tile, gather rows of `vectors` and score
// each against queries[b]; INVALID (< 0) ids give +inf; ||x||^2 comes from
// `norms`, or from the row itself when no norms are given.
//
// Bound on the H100: bytes.  Each output reads one random D-float row plus
// its id and norm (about B*K*(4D + 8) bytes) and does 2D flops on it, far
// below the card's flop/byte balance.  The TPU version issues one blocking
// row DMA after another; here one warp owns one (b, k) output, so a row is
// read by 32 lanes in D/32 coalesced 128-byte transactions, the norm is
// loaded in-kernel, and thousands of rows are in flight across the grid.
//
// The single-query launch (one query, K = 64 ids, once per hop of the
// serial search) moves about 33 KB: it is set by launch latency and by the
// host's cost of issuing it, not by bytes.  Its kernel gives one block to a
// query: the block stages q in shared memory once (16-byte loads when
// D % 4 == 0 and q is aligned), computes ||q||^2 once, and its warps share
// the K ids.  Every row is still scored with warp_dot, and the no-norms path
// with warp_dot(x, x), so its distances are bitwise those of the batched
// kernel and of the fused hop kernel for the same (query, row) pair.
#include <stdint.h>

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

template <bool L2, bool HAS_NORMS>
__global__ void __launch_bounds__(256)
gather_one_kernel(const int* __restrict__ ids,
                  const float* __restrict__ queries,
                  const float* __restrict__ vectors,
                  const float* __restrict__ norms, float* __restrict__ out,
                  int K, int N, int D) {
  extern __shared__ float4 q4s[];  // [ceil(D / 4)]
  float* qs = reinterpret_cast<float*>(q4s);
  __shared__ float s_q2;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* q = queries + (long long)blockIdx.x * D;
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    const float4* qg = reinterpret_cast<const float4*>(q);
    for (int c = tid; c < (D >> 2); c += blockDim.x) q4s[c] = qg[c];
  } else {
    for (int d = tid; d < D; d += blockDim.x) qs[d] = q[d];
  }
  __syncthreads();
  if (L2 && wid == 0) {
    const float q2 = warp_dot(qs, qs, D, lane);
    if (lane == 0) s_q2 = q2;
  }
  __syncthreads();
  const int* idb = ids + (long long)blockIdx.x * K;
  float* ob = out + (long long)blockIdx.x * K;
  for (int j = wid; j < K; j += nwarps) {
    const int id = idb[j];
    if (id < 0) {
      if (lane == 0) ob[j] = CUDART_INF_F;
      continue;
    }
    const int sid = id < N ? id : N - 1;
    const float* x = vectors + (long long)sid * D;
    const float prod = warp_dot(x, qs, D, lane);
    float d;
    if (L2) {
      const float x2 = HAS_NORMS ? norms[sid] : warp_dot(x, x, D, lane);
      d = l2_combine(s_q2, x2, prod);
    } else {
      d = -prod;
    }
    if (lane == 0) ob[j] = d;
  }
}

// one block per query; B is 1 on the serial search's path
extern "C" int gather_one_launch(const int* ids, const float* queries,
                                 const float* vectors, const float* norms,
                                 float* out, int B, int K, int N, int D,
                                 int l2, void* stream) {
  if (B == 0 || K == 0) return 0;
  const int threads = 32 * (K < 8 ? K : 8);
  const size_t smem = (size_t)((D + 3) / 4) * 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (!l2) {
    gather_one_kernel<false, false><<<B, threads, smem, s>>>(
        ids, queries, vectors, norms, out, K, N, D);
  } else if (norms != nullptr) {
    gather_one_kernel<true, true><<<B, threads, smem, s>>>(
        ids, queries, vectors, norms, out, K, N, D);
  } else {
    gather_one_kernel<true, false><<<B, threads, smem, s>>>(
        ids, queries, vectors, norms, out, K, N, D);
  }
  return (int)cudaGetLastError();
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
