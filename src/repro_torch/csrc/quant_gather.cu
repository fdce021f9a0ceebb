// Fused gather + distance over the int8 code table (the quantized tier).
//
// Replaces the TPU kernel repro/kernels/quant_gather.py:71
// gather_distance_batched_q (its pallas_call at :113, body
// _kernel_batched_q): for a (B, K) id tile, gather int8 rows of `codes` and
// score each against queries[b]:
//   prod = (codes[id] . q) * scale[id]   (raw dot in f32, then the scale)
//   l2:  (||q||^2 + qnorm[id]) - 2 prod,   ip: -prod;
// INVALID (< 0) ids give +inf, ids >= N read row N - 1.  That op order is
// the quantized tier's contract (repro/core/quant.py); the product is
// rounded explicitly so nvcc cannot contract it into the combine.
//
// Bound on the H100: bytes.  The tile needs about B*K*(D + 8) bytes of
// random rows with their scale and qnorm, plus the ids, the queries and the
// outputs, and does 2D flops a row; at B = 512, K = 64, D = 128 that is
// about 4.5 MB, 1.35 us at 3.35 TB/s.  What kept the first design (one
// warp per output) far from it was latency and instruction count, not
// bytes: every warp read its query from global memory twice (the dot and
// ||q||^2), once per output, then walked a dependent chain (id, then row,
// scale and qnorm) for one row and reduced it with two 5-step
// butterflies.
//
// Here a block owns one query's K ids (wpq warps), or at K = 1 holds
// several queries, one warp each (the host picks the shape:
// kernels/quant_gather.py::launch_shape).  The query is staged in shared
// memory once, by 16-byte cp.async copies when D % 4 == 0 and q is aligned,
// sent before the ids so the two latencies overlap; ||q||^2 is computed
// once per query, by one warp, with warp_dot over the staged copy.  A warp
// takes ROWS ids at a time (8, or 1 at K = 1): it loads the ids, scales and
// qnorms and then every row's first char4 at once (a D = 128 row is one
// char4 a lane), and reduces the ROWS partial sums together in a
// reduce-scatter (9 shuffles for 8 rows where 8 butterflies take 40),
// after which lane 4r holds row r's sum.
//
// Bits: each row's sum is warp_dot_i8's (common.cuh): lane l takes char4
// chunks l, l + 32, ... with fmaf in x, y, z, w order (bytes l, l + 32, ...
// when D % 4 != 0).  Every step of the reduce-scatter adds to a lane's own
// partial the partial of lane l ^ off for the same row, as the xor
// butterfly does, so a row's sum is the butterfly's, bit for bit.  This
// kernel and the fused hop kernel (beam_hop.cu, the same warp_dot_i8) give
// the same bits for a (query, row) pair.
#include <stdint.h>

#include "common.cuh"

constexpr int kRows = 8;      // rows a warp takes at a time (K > 1)
constexpr int kMaxWarps = 8;  // warps a block holds

// The sums over the warp of ROWS partials at once.  Step `off` (16, 8, ...)
// halves the rows a lane keeps while more than one is left: a lane keeps
// the upper half when its bit `off` is set and adds the partner's partial
// of each row it keeps to its own; the remaining steps are the plain
// butterfly.  Lane l ends with the sum of row l / (32 / ROWS).
template <int ROWS>
__device__ __forceinline__ float reduce_rows(float (&acc)[ROWS], int lane) {
#pragma unroll
  for (int off = 16, m = ROWS; off > 0; off >>= 1) {
    if (m > 1) {
      const int half = m >> 1;
      const bool hi = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = hi ? acc[i] : acc[i + half];
        const float keep = hi ? acc[i + half] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      m = half;
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
    }
  }
  return acc[0];
}

// One warp's round of up to ROWS ids of one query, from id j0: nr rows
// (the same in every lane).  Row r belongs to lanes 32 / ROWS * r and up:
// each of them holds the row's id, its clamped id s (-1 for INVALID, N - 1
// past N), scale and qnorm.  A row's clamped id reaches the other lanes by
// a shuffle.  For char4 rows every lane also holds its first chunk of each
// row.
template <bool L2, bool VEC, int ROWS>
struct Round {
  int nr, id, s;
  float scale, qn;
  char4 v[ROWS];

  __device__ __forceinline__ void fetch(const int* __restrict__ idb, int j0,
                                        int K, const signed char* codes,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ qnorms,
                                        int N, int D, int lane) {
    constexpr int kLanes = 32 / ROWS;
    const int r = lane / kLanes;
    nr = min(ROWS, K - j0);
    id = r < nr ? idb[j0 + r] : -1;
    s = id < N ? id : N - 1;
    scale = 0.0f;
    qn = 0.0f;
    if (id >= 0) {
      scale = scales[s];
      if (L2) qn = qnorms[s];
    }
    if (VEC) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int si = __shfl_sync(0xffffffffu, s, i * kLanes);
        v[i] = (si >= 0 && lane < (D >> 2))
                   ? reinterpret_cast<const char4*>(
                         codes + (long long)si * D)[lane]
                   : make_char4(0, 0, 0, 0);
      }
    }
  }

  // Each row's raw dot with the staged query, reduced: lane l gets row
  // l / (32 / ROWS)'s.  The chunks fetched with the ids go first, every
  // row at once; any further ones (D > 128, or the byte loads) row by row,
  // which keeps one row's addresses live at a time.
  __device__ __forceinline__ float dot(const signed char* codes,
                                       const float* qs, int D,
                                       int lane) const {
    constexpr int kLanes = 32 / ROWS;
    float acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;
    if (VEC) {
      const int D4 = D >> 2;
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      if (lane < D4) {
        const float4 qv = q4[lane];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          acc[i] = fmaf((float)v[i].x, qv.x, acc[i]);
          acc[i] = fmaf((float)v[i].y, qv.y, acc[i]);
          acc[i] = fmaf((float)v[i].z, qv.z, acc[i]);
          acc[i] = fmaf((float)v[i].w, qv.w, acc[i]);
        }
      }
      if (D4 > 32) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int si = __shfl_sync(0xffffffffu, s, i * kLanes);
          if (si < 0) continue;
          const char4* x4 =
              reinterpret_cast<const char4*>(codes + (long long)si * D);
          for (int c = lane + 32; c < D4; c += 32) {
            const char4 x = x4[c];
            const float4 qv = q4[c];
            acc[i] = fmaf((float)x.x, qv.x, acc[i]);
            acc[i] = fmaf((float)x.y, qv.y, acc[i]);
            acc[i] = fmaf((float)x.z, qv.z, acc[i]);
            acc[i] = fmaf((float)x.w, qv.w, acc[i]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int si = __shfl_sync(0xffffffffu, s, i * kLanes);
        if (si < 0) continue;
        const signed char* x = codes + (long long)si * D;
        for (int d = lane; d < D; d += 32) {
          acc[i] = fmaf((float)x[d], qs[d], acc[i]);
        }
      }
    }
    return reduce_rows<ROWS>(acc, lane);
  }
};

// Copy nq queries of D floats from qg to qs, by n threads from t, with
// 16-byte cp.async copies when the rows allow it (VEC and qg aligned: the
// caller then waits with cp_async_wait_all); false when they do not.
template <bool VEC>
__device__ __forceinline__ bool stage_async(float* qs, const float* qg,
                                            int nq, int D, int t, int n) {
  if (!VEC || (reinterpret_cast<uintptr_t>(qg) & 15) != 0) return false;
  for (int c = t; c < nq * (D >> 2); c += n) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(qs + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(qg + 4 * c)
                 : "memory");
  }
  return true;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The same copy with plain loads, `stride` floats a staged query.
__device__ __forceinline__ void stage_plain(float* qs, const float* qg,
                                            int nq, int D, int stride, int t,
                                            int n) {
  for (int i = t; i < nq * D; i += n) qs[(i / D) * stride + i % D] = qg[i];
}

// Block: queries b0 .. b0 + qpb - 1, wpq warps each.  Warp w serves query
// b0 + w / wpq and takes its ids j0 = (w % wpq) * ROWS + i * wpq * ROWS,
// ROWS at a time.  At most 64 registers a thread, so that 4 blocks of 256
// threads share an SM: a (512, 64) tile is one wave.
template <bool L2, bool VEC, int ROWS>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
quant_gather_block_kernel(const int* __restrict__ ids,
                          const float* __restrict__ queries,
                          const signed char* __restrict__ codes,
                          const float* __restrict__ scales,
                          const float* __restrict__ qnorms,
                          float* __restrict__ out, int B, int K, int N, int D,
                          int wpq, int qpb) {
  constexpr int kLanes = 32 / ROWS;
  extern __shared__ float4 q4s[];  // [qpb][ceil(D / 4)]
  __shared__ float s_q2[kMaxWarps];
  float* qs_all = reinterpret_cast<float*>(q4s);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int stride = ((D + 3) >> 2) * 4;  // floats per staged query
  const int b0 = blockIdx.x * qpb;
  const int nq = min(qpb, B - b0);
  const int ql = wid / wpq;
  const bool serves = ql < nq;
  const int step = wpq * ROWS;
  int j0 = (wid % wpq) * ROWS;
  const int* idb = ids + (long long)(b0 + ql) * K;

  // the staging copies go out first, then the first round's ids, row
  // terms and first chunks
  Round<L2, VEC, ROWS> rd;
  float* qs = qs_all + ql * stride;
  float q2 = 0.0f;
  if (wpq == 1) {
    // a warp a query: the warp stages its query and computes its ||q||^2
    // itself, with no block barrier
    if (!serves) return;
    const float* qg = queries + (long long)(b0 + ql) * D;
    const bool async = stage_async<VEC>(qs, qg, 1, D, lane, 32);
    if (j0 < K) rd.fetch(idb, j0, K, codes, scales, qnorms, N, D, lane);
    if (async) {
      cp_async_wait_all();
    } else {
      stage_plain(qs, qg, 1, D, stride, lane, 32);
    }
    __syncwarp();
    if (L2) q2 = warp_dot(qs, qs, D, lane);
  } else {
    const float* qg = queries + (long long)b0 * D;
    const bool async = stage_async<VEC>(qs_all, qg, nq, D, tid, blockDim.x);
    if (serves && j0 < K) {
      rd.fetch(idb, j0, K, codes, scales, qnorms, N, D, lane);
    }
    if (async) {
      cp_async_wait_all();
    } else {
      stage_plain(qs_all, qg, nq, D, stride, tid, blockDim.x);
    }
    __syncthreads();
    if (L2 && wid < nq) {
      const float* qw = qs_all + wid * stride;
      const float v = warp_dot(qw, qw, D, lane);
      if (lane == 0) s_q2[wid] = v;
    }
    __syncthreads();
    if (!serves) return;
    if (L2) q2 = s_q2[ql];
  }
  float* ob = out + (long long)(b0 + ql) * K;
  const int r = lane / kLanes;  // the row whose sum this lane ends with
  while (j0 < K) {
    const float raw = rd.dot(codes, qs, D, lane);
    if (lane % kLanes == 0 && r < rd.nr) {
      float d = CUDART_INF_F;
      if (rd.id >= 0) {
        const float prod = __fmul_rn(raw, rd.scale);
        d = L2 ? l2_combine(q2, rd.qn, prod) : -prod;
      }
      ob[j0 + r] = d;
    }
    j0 += step;
    if (j0 < K) rd.fetch(idb, j0, K, codes, scales, qnorms, N, D, lane);
  }
}

template <bool L2, bool VEC, int ROWS>
static int launch(int blocks, int threads, size_t smem, cudaStream_t s,
                  const int* ids, const float* queries,
                  const signed char* codes, const float* scales,
                  const float* qnorms, float* out, int B, int K, int N, int D,
                  int wpq, int qpb) {
  // past 40 KB of staged queries (D > 10,240 at one query a block) the
  // static q2 slots would cross the 48 KB default: opt in to more
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_gather_block_kernel<L2, VEC, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  quant_gather_block_kernel<L2, VEC, ROWS><<<blocks, threads, smem, s>>>(
      ids, queries, codes, scales, qnorms, out, B, K, N, D, wpq, qpb);
  return (int)cudaGetLastError();
}

template <int ROWS>
static int launch_rows(bool l2, bool vec, int blocks, int threads,
                       size_t smem, cudaStream_t s, const int* ids,
                       const float* queries, const signed char* codes,
                       const float* scales, const float* qnorms, float* out,
                       int B, int K, int N, int D, int wpq, int qpb) {
  if (l2) {
    return vec ? launch<true, true, ROWS>(blocks, threads, smem, s, ids,
                                          queries, codes, scales, qnorms, out,
                                          B, K, N, D, wpq, qpb)
               : launch<true, false, ROWS>(blocks, threads, smem, s, ids,
                                           queries, codes, scales, qnorms,
                                           out, B, K, N, D, wpq, qpb);
  }
  return vec ? launch<false, true, ROWS>(blocks, threads, smem, s, ids,
                                         queries, codes, scales, qnorms, out,
                                         B, K, N, D, wpq, qpb)
             : launch<false, false, ROWS>(blocks, threads, smem, s, ids,
                                          queries, codes, scales, qnorms, out,
                                          B, K, N, D, wpq, qpb);
}

// rows ids a warp takes at a time (1 or kRows), wpq warps per query, qpb
// queries per block: launch_shape on the host
extern "C" int quant_gather_launch(const int* ids, const float* queries,
                                   const signed char* codes,
                                   const float* scales, const float* qnorms,
                                   float* out, int B, int K, int N, int D,
                                   int l2, int rows, int wpq, int qpb,
                                   void* stream) {
  if (B == 0 || K == 0) return 0;
  if ((rows != 1 && rows != kRows) || wpq < 1 || qpb < 1 ||
      wpq * qpb > kMaxWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (B + qpb - 1) / qpb;
  const int threads = 32 * wpq * qpb;
  const size_t smem = (size_t)qpb * ((D + 3) / 4) * 16;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (D & 3) == 0;
  return rows == 1
             ? launch_rows<1>(l2, vec, blocks, threads, smem, s, ids, queries,
                              codes, scales, qnorms, out, B, K, N, D, wpq,
                              qpb)
             : launch_rows<kRows>(l2, vec, blocks, threads, smem, s, ids,
                                  queries, codes, scales, qnorms, out, B, K,
                                  N, D, wpq, qpb);
}
