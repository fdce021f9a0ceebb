// Exact brute-force top-k with an additive row bias.
//
// Replaces the TPU kernel repro/kernels/topk_score.py::topk_score (body
// _kernel): for every query, the k smallest of
// ((||q||^2 + ||x||^2) - 2<x, q>) + bias[row] (l2) or -<x, q> + bias[row]
// (ip) over all N rows, ties to the lower row id, as lax.top_k gives them.
// Rows whose score is +inf (bias +inf masks dead slots; rows past N) never
// enter; a query with fewer than k finite rows pads with (+inf, -1).
//
// Bound on the H100: operations, 2*N*B*D fp32 flops against 4*N*D bytes
// of table.  The TPU walks N in order and carries a (k, B) top-k in VMEM
// scratch across grid steps; blocks on Hopper carry nothing between them,
// so the work is split in two passes.  Pass 1: a 2-D grid of (row chunks x
// query groups); each block streams its chunk through shared memory in
// 256-row tiles, each thread scores one row against 16 queries held in
// registers (the table is read once per query group, not once per query),
// and each warp keeps the running top-k of two queries in shared memory:
// a tile's candidates below the current k-th score are inserted in row
// order by rank (k <= 64).  Pass 2: one warp per query merges the chunks'
// partial lists the same way.  The ragged last tile is masked in-kernel.
#include "common.cuh"

#define TN 256   // rows per tile = threads per block
#define QB 16    // queries per block
#define DC 16    // depth chunk staged in shared memory
#define TILES_PER_CHUNK 32
#define K_MAX 64

// rank of (v, id) among a sorted list of k entries, lexicographic
__device__ __forceinline__ int lex_rank(const float* lv, const int* li,
                                        int k, float v, int id, int lane) {
  int cnt = 0;
  for (int e = lane; e < k; e += 32) {
    cnt += (lv[e] < v) || (lv[e] == v && li[e] < id);
  }
  return (int)warp_sum((float)cnt);
}

// insert (v, id) at position pos of a sorted k-list, dropping the last
__device__ __forceinline__ void list_insert(float* lv, int* li, int k,
                                            int pos, float v, int id,
                                            int lane) {
  float tv[2];
  int ti[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    if (e < k) {
      if (e < pos) { tv[s] = lv[e]; ti[s] = li[e]; }
      else if (e == pos) { tv[s] = v; ti[s] = id; }
      else { tv[s] = lv[e - 1]; ti[s] = li[e - 1]; }
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    if (e < k) { lv[e] = tv[s]; li[e] = ti[s]; }
  }
  __syncwarp();
}

// offer a warp's 32 candidates (one per lane, in lane order = id order)
__device__ __forceinline__ void offer(float* lv, int* li, int k, float v,
                                     int id, int lane) {
  unsigned m = __ballot_sync(0xffffffffu,
                             (v < lv[k - 1]) ||
                                 (v == lv[k - 1] && id < li[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(0xffffffffu, v, src);
    const int ci = __shfl_sync(0xffffffffu, id, src);
    const int pos = lex_rank(lv, li, k, cv, ci, lane);
    if (pos < k) list_insert(lv, li, k, pos, cv, ci, lane);
  }
}

template <bool L2>
__global__ void __launch_bounds__(TN)
topk_partial_kernel(const float* __restrict__ queries,
                    const float* __restrict__ vectors,
                    const float* __restrict__ norms,
                    const float* __restrict__ bias, float* part_v,
                    int* part_i, int B, int N, int D, int k) {
  __shared__ float xs[TN][DC + 1];
  __shared__ float qs[DC][QB];
  __shared__ float sc[QB][TN];
  __shared__ float qn[QB];
  __shared__ float lv[QB][K_MAX];
  __shared__ int li[QB][K_MAX];

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int chunk = blockIdx.x, q0 = blockIdx.y * QB;
  const int nq = min(QB, B - q0);
  for (int j = wid; j < QB; j += TN / 32) {
    float v = 0.0f;
    if (j < nq) {
      const float* qp = queries + (long long)(q0 + j) * D;
      v = warp_dot(qp, qp, D, lane);
    }
    if (lane == 0) qn[j] = v;
  }
  for (int e = tid; e < QB * K_MAX; e += TN) {
    lv[e / K_MAX][e % K_MAX] = CUDART_INF_F;
    li[e / K_MAX][e % K_MAX] = -1;
  }
  __syncthreads();

  for (int tile = 0; tile < TILES_PER_CHUNK; ++tile) {
    const long long row0 =
        ((long long)chunk * TILES_PER_CHUNK + tile) * TN;
    if (row0 >= N) break;
    float acc[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      for (int f = tid; f < TN * DC; f += TN) {
        const int rr = f / DC, cc = f % DC;
        const long long row = row0 + rr;
        xs[rr][cc] = (row < N && d0 + cc < D)
                         ? vectors[row * D + d0 + cc] : 0.0f;
      }
      for (int f = tid; f < DC * QB; f += TN) {
        const int cc = f / QB, j = f % QB;
        qs[cc][j] = (j < nq && d0 + cc < D)
                        ? queries[(long long)(q0 + j) * D + d0 + cc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float xv = xs[tid][cc];
#pragma unroll
        for (int j = 0; j < QB; ++j) acc[j] = fmaf(xv, qs[cc][j], acc[j]);
      }
      __syncthreads();
    }
    const long long row = row0 + tid;
    const bool in = row < N;
    const float xn = (L2 && in) ? norms[row] : 0.0f;
    const float bb = in ? bias[row] : 0.0f;
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      float s = L2 ? l2_combine(qn[j], xn, acc[j]) : -acc[j];
      s = __fadd_rn(s, bb);
      sc[j][tid] = in ? s : CUDART_INF_F;
    }
    __syncthreads();
    for (int j = wid; j < nq; j += TN / 32) {
      for (int s = 0; s < TN / 32; ++s) {
        const int rr = s * 32 + lane;
        offer(lv[j], li[j], k, sc[j][rr], (int)(row0 + rr), lane);
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nq * k; e += TN) {
    const int j = e / k, c = e % k;
    const long long o = ((long long)chunk * B + q0 + j) * k + c;
    part_v[o] = lv[j][c];
    part_i[o] = li[j][c];
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  float* out_v, int* out_i, int B,
                                  int n_chunks, int k) {
  __shared__ float lv[K_MAX];
  __shared__ int li[K_MAX];
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int e = lane; e < k; e += 32) { lv[e] = CUDART_INF_F; li[e] = -1; }
  __syncwarp();
  const long long total = (long long)n_chunks * k;
  for (long long base = 0; base < total; base += 32) {
    const long long e = base + lane;
    float v = CUDART_INF_F;
    int id = -1;
    if (e < total) {
      const long long c = e / k, j = e % k;
      const long long o = (c * B + b) * k + j;
      v = part_v[o];
      id = part_i[o];
    }
    if (id < 0) v = CUDART_INF_F;
    offer(lv, li, k, v, id, lane);
  }
  for (int e = lane; e < k; e += 32) {
    const bool fin = isfinite(lv[e]);
    out_v[(long long)b * k + e] = fin ? lv[e] : CUDART_INF_F;
    out_i[(long long)b * k + e] = fin ? li[e] : -1;
  }
}

extern "C" int topk_n_chunks(int N) {
  const long long rows = (long long)TN * TILES_PER_CHUNK;
  return (int)((N + rows - 1) / rows);
}

extern "C" int topk_score_launch(const float* queries, const float* vectors,
                                 const float* norms, const float* bias,
                                 float* part_v, int* part_i, float* out_v,
                                 int* out_i, int B, int N, int D, int k,
                                 int l2, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > K_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = topk_n_chunks(N);
  if (n_chunks > 0) {
    dim3 grid(n_chunks, (B + QB - 1) / QB);
    if (l2) {
      topk_partial_kernel<true><<<grid, TN, 0, s>>>(
          queries, vectors, norms, bias, part_v, part_i, B, N, D, k);
    } else {
      topk_partial_kernel<false><<<grid, TN, 0, s>>>(
          queries, vectors, norms, bias, part_v, part_i, B, N, D, k);
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  topk_merge_kernel<<<B, 32, 0, s>>>(part_v, part_i, out_v, out_i, B,
                                     n_chunks, k);
  return (int)cudaGetLastError();
}
