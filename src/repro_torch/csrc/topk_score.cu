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
// so the work is split in two passes.
//
// Pass 1 is a register-tiled fp32 product.  A block owns a tile of BQ = 128
// queries and a chunk of up to TPC_MAX row tiles of BN = 128 rows, with
// 256 threads; each thread holds an 8 x 8 (query x row) micro-tile of sums
// in registers, so every value read from shared memory feeds 8 FMAs.  The
// tiles are staged in DK = 16-deep slices through an NSTAGE-deep cp.async
// ring (the next slices load while the current one is computed): the row
// tile row-major with 16-byte copies when D % 4 == 0 and the table is
// 16-byte aligned (4-byte copies otherwise), the query tile from a
// transposed, zero-padded copy of the queries that the wrapper makes, also
// with 16-byte copies; both padded so the micro-tile reads are free of bank
// conflicts.  The grid is (query tiles, chunks) with the query tile varying
// fastest, so the blocks that share a chunk run together and the table
// comes from HBM about once and from L2 for the other query tiles; the
// host picks the chunk length that fills the card's block slots in whole
// waves, so a small B still spreads over every SM by rows.
//
// Each (query, row) sum is one fmaf chain over d ascending from 0 (zero
// padding past D adds exact zeros), and the score is l2_combine, then
// __fadd_rn with the bias, so grid data gives the plain version's bits.
// Epilogue of a row tile, by halves of the query tile: each thread writes
// its scores to a shared score tile and tests them against its queries'
// running k-th entries, held in shared memory ((v, id) lexicographically
// below); a warp per query that has a passing score takes the query's row
// of scores and merges those below the k-th entry into the list by rank
// (merge32: ties to the lower row, in any order of arrival).  Pass 2: one
// warp per query merges the chunks' partial lists the same way.  k <= 64.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

#define BQ 128               // queries per block tile
#define BN 128               // rows per row tile
#define DK 16                // depth of one staged slice
#define NSTAGE 3             // cp.async ring depth
#define XS (DK + 4)          // row stride of the staged row tile
#define QS (BQ + 4)          // row stride of the transposed query tile
#define SS (BN + 2)          // row stride of the score half-tile
#define TPC_MAX 64           // most row tiles per block (8,192 rows)
#define TPB 256
// each thread issues two 16-byte copies (or eight 4-byte ones) of the row
// tile and two of the query tile per stage
static_assert(BN * DK / 4 == 2 * TPB && BN * DK == 8 * TPB &&
                  DK * BQ / 4 == 2 * TPB,
              "the copy layout assumes these tile sizes");
#define K_MAX 64

__device__ __forceinline__ bool lex_less(float av, int ai, float bv,
                                         int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Merge a warp's candidates (one per lane where `in`) into a sorted k-list
// in shared memory, ties to the lower id.  Candidates not below the k-th
// entry are dropped first; the rest and the list entries each compute
// their rank in the union (ids are distinct; a candidate's rank in the list
// is a ballot over the entries, two per lane), and those ranked below k are
// written there.  Arrival order does not matter.
__device__ __forceinline__ void merge32(float* lv, int* li, int k, float v,
                                       int id, bool in, int lane) {
  in = in && lex_less(v, id, lv[k - 1], li[k - 1]);
  unsigned m = __ballot_sync(0xffffffffu, in);
  if (!m) return;
  float ev[2];
  int ei[2], er[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    ev[s] = e < k ? lv[e] : CUDART_INF_F;
    ei[s] = e < k ? li[e] : INT_MAX;
    er[s] = e;
  }
  int rank = 0;
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(0xffffffffu, v, src);
    const int ci = __shfl_sync(0xffffffffu, id, src);
    const int below =
        __popc(__ballot_sync(0xffffffffu, lex_less(ev[0], ei[0], cv, ci))) +
        __popc(__ballot_sync(0xffffffffu, lex_less(ev[1], ei[1], cv, ci)));
    rank += lex_less(cv, ci, v, id) + (lane == src ? below : 0);
#pragma unroll
    for (int s = 0; s < 2; ++s) er[s] += lex_less(cv, ci, ev[s], ei[s]);
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (lane + 32 * s < k && er[s] < k) {
      lv[er[s]] = ev[s];
      li[er[s]] = ei[s];
    }
  }
  if (in && rank < k) { lv[rank] = v; li[rank] = id; }
  __syncwarp();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dynamic shared memory of pass 1, in 4-byte words, for a given k
__host__ __device__ constexpr int ring_words() {
  return NSTAGE * (BN * XS + DK * QS + 2 * BN);
}
__host__ __device__ constexpr int smem_words(int k) {
  return ring_words() + BQ + (BQ / 2) * SS + 2 * BQ * k + BQ;
}

// the micro-tile's i-th query and j-th row within the block's tiles
__device__ __forceinline__ int tile_query(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

// Diagnostic builds (kernels/topk_breakdown.py) may define
// TOPK_SKIP_LOADS (stages after the first NSTAGE - 1 are not copied) or
// TOPK_SKIP_EPILOGUE (no scores, no lists): their results are wrong, their
// times split the kernel's time into its parts.
template <bool L2, bool VEC>
__global__ void __launch_bounds__(TPB, 2)
topk_partial_kernel(const float* __restrict__ queries,
                    const float* __restrict__ qt,
                    const float* __restrict__ vectors,
                    const float* __restrict__ norms,
                    const float* __restrict__ bias, float* part_v,
                    int* part_i, int B, int ldq, int N, int D, int k,
                    int tpc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                              // [NSTAGE][BN][XS]
  float* qs = xs + NSTAGE * BN * XS;             // [NSTAGE][DK][QS]
  float* nb = qs + NSTAGE * DK * QS;             // [NSTAGE][2][BN]
  float* qn = nb + NSTAGE * 2 * BN;              // [BQ]
  float* sc = qn + BQ;                           // [BQ / 2][SS]
  float* lv = sc + (BQ / 2) * SS;                // [BQ][k]
  int* li = reinterpret_cast<int*>(lv + BQ * k);  // [BQ][k]
  int* flag = li + BQ * k;                       // [BQ] a score passed

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // the thread's place (ty, tx) in the 16 x 16 grid of micro-tiles: a warp
  // covers 4 query groups x 8 row groups
  const int ty = ((wid >> 1) << 2) | (lane >> 3);
  const int tx = ((wid & 1) << 3) | (lane & 7);
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, B - q0);
  const long long crow0 = (long long)blockIdx.y * tpc * BN;
  const int ntiles = (int)min((long long)tpc, (N - crow0 + BN - 1) / BN);
  const int nsl = (D + DK - 1) / DK;
  const int nstages = ntiles * nsl;

  for (int j = wid; j < BQ; j += TPB / 32) {
    float v = 0.0f;
    if (j < nq) {
      const float* qp = queries + (long long)(q0 + j) * D;
      v = warp_dot(qp, qp, D, lane);
    }
    if (lane == 0) qn[j] = v;
  }
  for (int e = tid; e < BQ * k; e += TPB) {
    lv[e] = CUDART_INF_F;
    li[e] = -1;
  }
  for (int e = tid; e < BQ; e += TPB) flag[e] = 0;

  // Each thread's copies keep one place in every stage: in the row tile
  // the 16-byte pieces at rows xr + 64 h, depth xd (VEC), or the floats at
  // rows xr + 16 h, depth xd; in the query tile the 16-byte pieces at
  // depths qd + 8 h, query qc.
  const int xr = VEC ? tid >> 2 : tid >> 4;
  const int xd = VEC ? (tid & 3) * 4 : tid & 15;
  const int qd = tid >> 5, qc = (tid & 31) * 4;
  const float* gx = vectors + (crow0 + xr) * D + xd;
  const float* gq = qt + (long long)qd * ldq + q0 + qc;

  // issue the copies of stage s (row tile s / nsl, depth slice s % nsl)
  auto load_stage = [&](int s) {
    const int t = s / nsl, sl = s - t * nsl;
    const long long row0 = crow0 + (long long)t * BN;
    const int d0 = sl * DK;
    const int buf = s % NSTAGE;
    float* xb = xs + buf * BN * XS;
    float* qb = qs + buf * DK * QS;
    const long long off = (long long)t * BN * D + d0;
    if (VEC) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool p = row0 + xr + 64 * h < N && d0 + xd < D;
        cp_async16(xb + (xr + 64 * h) * XS + xd,
                   p ? gx + off + 64LL * h * D : vectors, p);
      }
    } else {
#pragma unroll
      for (int h = 0; h < BN * DK / TPB; ++h) {
        const bool p = row0 + xr + 16 * h < N && d0 + xd < D;
        cp_async4(xb + (xr + 16 * h) * XS + xd,
                  p ? gx + off + 16LL * h * D : vectors, p);
      }
    }
    // queries from their transposed, zero-padded copy: 16-byte copies
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool p = d0 + qd + 8 * h < D;
      cp_async16(qb + (qd + 8 * h) * QS + qc,
                 p ? gq + (long long)(d0 + 8 * h) * ldq : qt, p);
    }
    if (sl == 0) {
      float* nbt = nb + (t % NSTAGE) * 2 * BN;
      const int r = tid & (BN - 1);
      const long long row = row0 + r;
      if (tid < BN) {
        cp_async4(nbt + r, L2 && row < N ? norms + row : bias, L2 && row < N);
      } else {
        cp_async4(nbt + BN + r, row < N ? bias + row : bias, row < N);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nstages) load_stage(s);
    cp_async_commit();
  }

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
#ifndef TOPK_SKIP_LOADS
    if (s + NSTAGE - 1 < nstages) load_stage(s + NSTAGE - 1);
#endif
    cp_async_commit();

    const float* xb = xs + (s % NSTAGE) * BN * XS;
    const float* qb = qs + (s % NSTAGE) * DK * QS;
#pragma unroll
    for (int dg = 0; dg < DK; dg += 4) {
      float4 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = *reinterpret_cast<const float4*>(xb + (tx + 16 * j) * XS + dg);
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 a =
            *reinterpret_cast<const float4*>(qb + (dg + dd) * QS + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(
            qb + (dg + dd) * QS + 64 + ty * 4);
        const float qv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = dd == 0 ? x[j].x : dd == 1 ? x[j].y
                         : dd == 2 ? x[j].z : x[j].w;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(qv[i], xv, acc[i][j]);
        }
      }
    }

    const int t = s / nsl;
    if (s - t * nsl != nsl - 1) continue;
#ifdef TOPK_SKIP_EPILOGUE
    if (k <= K_MAX) continue;  // always; the compiler keeps the sums
#endif

    // ---- epilogue of row tile t, by halves of the query tile: each thread
    // writes its scores to shared memory and tests them against their
    // queries' k-th entries; then a warp per query with a score below its
    // k-th entry merges the query's row of scores
    const long long row0 = crow0 + (long long)t * BN;
    const float* nbt = nb + (t % NSTAGE) * 2 * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * h + ii, q = tile_query(ty, i);
        const float q2 = qn[q], tv = lv[q * k + k - 1];
        const int ti = li[q * k + k - 1];
        bool pass = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = tx + 16 * j;
          float v = L2 ? l2_combine(q2, nbt[r], acc[i][j]) : -acc[i][j];
          v = row0 + r < N ? __fadd_rn(v, nbt[BN + r]) : CUDART_INF_F;
          sc[(ty * 4 + ii) * SS + r] = v;
          pass |= lex_less(v, (int)(row0 + r), tv, ti);
          acc[i][j] = 0.0f;
        }
        if (pass) flag[q] = 1;
      }
      __syncthreads();
      for (int qq = wid; qq < BQ / 2 && 64 * h + qq < nq; qq += TPB / 32) {
        const int q = 64 * h + qq;
        if (!flag[q]) continue;
        // the query's scores below its k-th entry: a batch of 32 rows with
        // many of them is merged as it is, the few of the others are
        // packed into the lanes of one merge
        float* ql = lv + q * k;
        int* qi = li + q * k;
        const float tv = ql[k - 1];
        const int ti = qi[k - 1];
        float pv = CUDART_INF_F;
        int pi = -1, np = 0;
#pragma unroll
        for (int c = 0; c < BN / 32; ++c) {
          const float v = sc[qq * SS + 32 * c + lane];
          const int id = (int)(row0 + 32 * c + lane);
          const bool ok = lex_less(v, id, tv, ti);
          unsigned m = __ballot_sync(0xffffffffu, ok);
          if (__popc(m) > 8) {  // many (a chunk's first tiles): as they lie
            merge32(ql, qi, k, v, id, ok, lane);
            continue;
          }
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float sv = __shfl_sync(0xffffffffu, v, src);
            const int si = __shfl_sync(0xffffffffu, id, src);
            if (lane == np) { pv = sv; pi = si; }
            ++np;
          }
        }
        if (np) merge32(ql, qi, k, pv, pi, lane < np, lane);
        if (lane == 0) flag[q] = 0;
      }
      __syncthreads();
    }
  }

  __syncthreads();
  for (int e = tid; e < nq * k; e += TPB) {
    const int j = e / k, c = e % k;
    const long long o = ((long long)blockIdx.y * B + q0 + j) * k + c;
    part_v[o] = lv[j * k + c];
    part_i[o] = li[j * k + c];
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
    merge32(lv, li, k, v, id, id >= 0, lane);
  }
  for (int e = lane; e < k; e += 32) {
    const bool fin = isfinite(lv[e]);
    out_v[(long long)b * k + e] = fin ? lv[e] : CUDART_INF_F;
    out_i[(long long)b * k + e] = fin ? li[e] : -1;
  }
}

// Row tiles per block for a launch: the count that fills the card's block
// slots in the fewest tile-times, counting about two tile-times per block
// for its first tiles (the lists fill there), the larger count on a tie.
// A small B thus still spreads over every SM by rows.
static int plan_tiles(int B, int N, int k) {
  static int sms = 0;
  static int occ[K_MAX + 1] = {0};
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int most = smem_words(K_MAX) * 4;
    cudaFuncSetAttribute(topk_partial_kernel<true, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(topk_partial_kernel<true, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(topk_partial_kernel<false, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(topk_partial_kernel<false, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  if (occ[k] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[k], topk_partial_kernel<true, true>, TPB, smem_words(k) * 4);
    if (occ[k] < 1) occ[k] = 1;
  }
  const long long slots = (long long)sms * occ[k];
  const long long ntiles = ((long long)N + BN - 1) / BN;
  const long long nqt = (B + BQ - 1) / BQ;
  const int lo = (int)((ntiles + 65534) / 65535) + (ntiles == 0);
  int best = lo;
  long long best_cost = -1;
  for (int t = lo; t <= (lo > TPC_MAX ? lo : TPC_MAX); ++t) {
    const long long blocks = nqt * ((ntiles + t - 1) / t);
    const long long cost = ((blocks + slots - 1) / slots) * (t + 2);
    if (best_cost < 0 || cost <= best_cost) { best = t; best_cost = cost; }
  }
  return best;
}

extern "C" int topk_n_chunks(int B, int N, int k) {
  if (N <= 0 || B <= 0 || k < 1 || k > K_MAX) return 0;
  const long long rows = (long long)BN * plan_tiles(B, N, k);
  return (int)((N + rows - 1) / rows);
}

template <bool L2, bool VEC>
static int launch_partial(dim3 grid, size_t smem, cudaStream_t s,
                          const float* queries, const float* qt,
                          const float* vectors, const float* norms,
                          const float* bias, float* part_v, int* part_i,
                          int B, int ldq, int N, int D, int k, int tpc) {
  topk_partial_kernel<L2, VEC><<<grid, TPB, smem, s>>>(
      queries, qt, vectors, norms, bias, part_v, part_i, B, ldq, N, D, k,
      tpc);
  return (int)cudaGetLastError();
}

// `qt` is the queries transposed, [D][ldq] with ldq = B rounded up to BQ
// and zeros past B (the wrapper makes it); `queries` gives ||q||^2.
extern "C" int topk_score_launch(const float* queries, const float* qt,
                                 const float* vectors, const float* norms,
                                 const float* bias, float* part_v,
                                 int* part_i, float* out_v, int* out_i,
                                 int B, int N, int D, int k, int l2,
                                 void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > K_MAX || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = topk_n_chunks(B, N, k);
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0) {
    const int tpc = plan_tiles(B, N, k);
    const int ldq = (B + BQ - 1) / BQ * BQ;
    const dim3 grid(ldq / BQ, n_chunks);
    const size_t smem = (size_t)smem_words(k) * 4;
    const bool vec = (D % 4 == 0) && ((uintptr_t)vectors % 16 == 0);
    int err;
    if (l2) {
      err = vec ? launch_partial<true, true>(grid, smem, s, queries, qt,
                                             vectors, norms, bias, part_v,
                                             part_i, B, ldq, N, D, k, tpc)
                : launch_partial<true, false>(grid, smem, s, queries, qt,
                                              vectors, norms, bias, part_v,
                                              part_i, B, ldq, N, D, k, tpc);
    } else {
      err = vec ? launch_partial<false, true>(grid, smem, s, queries, qt,
                                              vectors, norms, bias, part_v,
                                              part_i, B, ldq, N, D, k, tpc)
                : launch_partial<false, false>(grid, smem, s, queries, qt,
                                               vectors, norms, bias, part_v,
                                               part_i, B, ldq, N, D, k, tpc);
    }
    if (err) return err;
  }
  topk_merge_kernel<<<B, 32, 0, s>>>(part_v, part_i, out_v, out_i, B,
                                     n_chunks, k);
  return (int)cudaGetLastError();
}
