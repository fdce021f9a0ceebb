// Fused multi-hop beam-search super-step, over the f32 table or the int8
// code table of the quantized tier.
//
// Replaces the TPU kernels repro/kernels/beam_hop.py::beam_hop_fused (body
// _kernel, per-lane step _lane_hop) and ::beam_hop_fused_q (body _kernel_q,
// the `scales=` path of _lane_hop): H masked hops per lane in one launch.
// Each hop pops the closest unexpanded beam entry (first minimum), records
// it in the visited list if it is returnable, reads its adjacency row,
// keeps the neighbours that are navigable and not yet seen, computes their
// distances, sets their seen bits, and merges them into the beam (stable by
// distance, beam entries first on ties), keeping the best l.  An inactive
// lane is an exact no-op, so it leaves the hop loop at once.
//
// Bound on the H100: by bytes, the random row gathers (per hop and lane an
// R-int adjacency row plus up to R rows of 4D bytes and their norms, or of
// D int8 bytes and their scales and qnorms); by time, the chain of
// dependent steps of each hop, since one block runs one lane and a batch of
// a few hundred lanes puts only about four blocks on each SM.  The kernel
// is templated on the row type: only the distance line differs.  Over int8
// rows the raw dot is warp_dot_i8 (shared with the quantized gather
// kernel), the row's scale multiplies the product with an explicit
// rounding, and `norms` are the cached qnorms of the dequantized rows.
//
// Design, per hop, so that a hop waits for about three HBM round trips:
//   * pop: the beam is kept sorted by distance, so the frontier's first
//     minimum is its lowest index: one ballot pass.  The kernel checks on
//     entry that the beam it was handed is sorted; if not, it sets
//     STATUS_UNSORTED and leaves the lane untouched (the caller raises).
//   * expand: one thread per adjacency slot loads the neighbour id, then
//     its navigable word, its seen word, its norm (and scale) at once.  The
//     fresh neighbours are compacted, in adjacency order, into a work list
//     by warp ballot and prefix.  All freshness tests of a hop finish (a
//     barrier) before any of its seen bits is set, which is the reference's
//     read-then-write order.  The seen row (ceil(n_cap/32) words, 125 KB
//     per lane at n_cap = 10^6) stays in global memory: only the words a
//     hop touches are tested (L2-coherent loads) and set (atomicOr); the
//     lane owns its row and OR is idempotent, so duplicates need no dedup.
//   * fetch + dots: every fresh row is copied into a shared-memory staging
//     area at once, by one TMA bulk copy each completing on one mbarrier
//     (rows of a multiple of 16 bytes on a 16-byte aligned table), else by
//     4-byte cp.async copies, else (int8 rows of D not a multiple of 4) by
//     plain loads; rows wider than the staging budget go in rounds.  Then
//     each warp scores two staged rows at a time, each with warp_dot's
//     partials and butterfly (interleaved), so fused and unfused engines
//     give the same bits.
//   * merge: with the beam sorted, the stable merge of beam ++ new keeps a
//     beam entry c at c + #(new < key) and puts a new entry at
//     #(beam <= key) + its rank among the new (ties by adjacency order);
//     both counts over a sorted list are binary searches.  Non-fresh slots
//     have distance +inf and would land at l or beyond, so only the work
//     list takes part; the result is the reference's stable sort.
// After its H hops a lane that is still active (the lane_active test on the
// carry it leaves) sets STATUS_ACTIVE, so the search loop needs one host
// read of one word per super-step.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hop_phases.cuh"

#define NT 128
#define NWARPS (NT / 32)
#define L_MAX 256
#define R_MAX 128
#define STAGE_BYTES (32 * 1024)  // row staging per round
#define STATUS_UNSORTED 1
#define STATUS_ACTIVE 2
// how a hop copies its fresh rows into shared memory: rows of a multiple of
// 16 bytes on a 16-byte aligned table take TMA bulk copies (they beat
// 16-byte cp.async for f32 and int8 rows at D = 128 on the H100: PERF.md)
#define COPY_BULK 0    // one TMA bulk copy a row, on one mbarrier
#define COPY_ASYNC4 1  // 4-byte cp.async
#define COPY_PLAIN 2   // plain loads

static_assert(R_MAX <= NT, "one adjacency slot per thread");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One arrival that also expects `bytes` of copies in the current phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void async_copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool bit_of(int word, int id) {
  return ((word >> (id & 31)) & 1) != 0;
}

// One lane's partial of the raw row . q dot of each row type (the int8 one
// before its scale): warp_dot / warp_dot_i8 without their butterfly.
__device__ __forceinline__ float row_partial(const float* x, const float* q,
                                             int D, int lane) {
  return lane_dot(x, q, D, lane);
}
__device__ __forceinline__ float row_partial(const signed char* x,
                                             const float* q, int D,
                                             int lane) {
  return lane_dot_i8(x, q, D, lane);
}

// The lowest index of an unexpanded valid entry (l when there is none): in
// a sorted beam, the frontier's first minimum.  Every thread gets it; one
// barrier.
__device__ __forceinline__ int first_frontier(const int* bi, const int* be,
                                              int l, int* s_first, int tid) {
  const int lane = tid & 31, wid = tid >> 5;
  int first = l;
  for (int base = 0; base < l; base += NT) {
    const int i = base + tid;
    const unsigned m =
        __ballot_sync(0xffffffffu, i < l && bi[i] >= 0 && be[i] == 0);
    if (m != 0 && first == l) first = base + wid * 32 + __ffs(m) - 1;
  }
  if (lane == 0) s_first[wid] = first;
  __syncthreads();
  int best = s_first[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) best = min(best, s_first[w]);
  return best;
}

// #(a[i] <= key) over a sorted a[0, n).
__device__ __forceinline__ int count_le(const float* a, int n, float key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #(a[i] < key) over a sorted a[0, n).
__device__ __forceinline__ int count_lt(const float* a, int n, float key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// T = float: `rows` is the f32 table, `norms` its squared norms, `scales`
// unused.  T = signed char: `rows` is the int8 code table, `scales` the
// per-row scales, `norms` the qnorms.  `status` collects STATUS_* bits;
// block 0 zeroes `status_clear` (the word the next launch will use) when it
// is given.
template <typename T, bool L2>
__global__ void __launch_bounds__(NT, 4)
beam_hop_kernel(const float* __restrict__ queries, int* beam_ids,
                float* beam_dists, int* beam_exp, int* seen, int* vis_ids,
                float* vis_dists, int* n_vis, int* n_comps, int* n_hops,
                const int* __restrict__ adj, const T* __restrict__ rows,
                const float* __restrict__ scales,
                const float* __restrict__ norms,
                const int* __restrict__ nav_words,
                const int* __restrict__ ret_words, int* status,
                int* status_clear, int l, int r, int mv, int n_cap, int W,
                int D, int h, int copy_mode, int round_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);                  // [D]
  unsigned char* stage = smem + ((D * 4 + 15) & ~15);         // [round_rows]
  __shared__ int s_bi[2][L_MAX];
  __shared__ float s_bd[2][L_MAX];
  __shared__ int s_be[2][L_MAX];
  __shared__ int s_fid[R_MAX];    // the hop's fresh neighbours, in order
  __shared__ float s_fx[R_MAX];   // their norms (qnorms)
  __shared__ float s_fs[R_MAX];   // their scales (int8 rows)
  __shared__ float s_nd[R_MAX];   // their distances
  __shared__ float s_sk[R_MAX];   // the same distances, sorted
  __shared__ int s_first[NWARPS];
  __shared__ int s_cnt[NWARPS];
  __shared__ float s_q2;
  __shared__ __align__(8) uint64_t s_bar;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long lb = (long long)b * l;
  const int row_bytes = D * (int)sizeof(T);
  const int stride = (row_bytes + 15) & ~15;
  if (b == 0 && tid == 0 && status_clear != nullptr) *status_clear = 0;
  for (int d = tid; d < D; d += NT) q[d] = queries[(long long)b * D + d];
  for (int i = tid; i < l; i += NT) {
    s_bi[0][i] = beam_ids[lb + i];
    s_bd[0][i] = beam_dists[lb + i];
    s_be[0][i] = beam_exp[lb + i];
  }
  if (tid == 0 && copy_mode == COPY_BULK) bar_init(&s_bar);
  __syncthreads();
  // the merge needs a sorted beam: refuse any other, leaving the lane as is
  bool unsorted = false;
  for (int i = tid; i + 1 < l; i += NT) {
    unsorted |= !(s_bd[0][i] <= s_bd[0][i + 1]);
  }
  if (__syncthreads_or(unsorted)) {
    if (tid == 0) atomicOr(status, STATUS_UNSORTED);
    return;
  }
  if (L2 && wid == 0) {
    const float q2 = warp_dot(q, q, D, lane);
    if (lane == 0) s_q2 = q2;
  }
  int* seen_row = seen + (long long)b * W;
  // every thread keeps the counters; thread 0's are written back
  int nvis = n_vis[b], ncomp = n_comps[b], nhop = n_hops[b];
  int cur = 0;
  unsigned parity = 0;
  bool active = false;
  HOP_DECL

  for (int t = 0; t < h; ++t) {
    HOP_START();
    // ---- pop: the frontier's first entry (the beam is sorted) -----------
    const int i0 = first_frontier(s_bi[cur], s_be[cur], l, s_first, tid);
    active = i0 < l && isfinite(s_bd[cur][i0]) && nhop < mv;
    if (!active) break;  // the remaining hops are exact no-ops
    const int v = s_bi[cur][i0];
    const int sv = min(max(v, 0), n_cap - 1);
    // thread 0 records the pop once the expand's loads are in flight
    const int ret_word = tid == 0 ? __ldg(ret_words + (sv >> 5)) : 0;
    nhop += 1;
    HOP_MARK(0);

    // ---- expand: freshness of the popped vertex's row (read phase) -----
    int nb = -1;
    float xn = 0.0f, xs = 0.0f;
    bool fresh = false;
    if (tid < r) {
      nb = __ldg(adj + (long long)sv * r + tid);
      const int snb = min(max(nb, 0), n_cap - 1);
      const int nav = __ldg(nav_words + (snb >> 5));
      const int sw = __ldcg(seen_row + (snb >> 5));
      if (L2) xn = __ldg(norms + snb);
      if constexpr (sizeof(T) == 1) xs = __ldg(scales + snb);
      fresh = nb >= 0 && bit_of(nav, snb) && !bit_of(sw, snb);
    }
    if (tid == 0) {
      s_be[cur][i0] = 1;
      if (bit_of(ret_word, sv)) {  // visited list: returnable pops
        vis_ids[(long long)b * mv + nvis] = v;
        vis_dists[(long long)b * mv + nvis] = s_bd[cur][i0];
        nvis += 1;
      }
    }
    const unsigned fm = __ballot_sync(0xffffffffu, fresh);
    if (lane == 0) s_cnt[wid] = __popc(fm);
    __syncthreads();  // every freshness test of the hop is done
    int nf = 0, off = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      off += w < wid ? s_cnt[w] : 0;
      nf += s_cnt[w];
    }
    if (fresh) {  // write phase: the work list and the seen bits
      const int f = off + __popc(fm & ((1u << lane) - 1u));
      s_fid[f] = nb;
      s_fx[f] = xn;
      s_fs[f] = xs;
      atomicOr(reinterpret_cast<unsigned*>(seen_row) + (nb >> 5),
               1u << (nb & 31));
    }
    ncomp += nf;
    HOP_MARK(1);
    if (nf == 0) {  // nothing to merge: the beam stays as it is
      HOP_MARK(2);
      HOP_END();
      continue;
    }
    __syncthreads();  // the work list is complete

    // ---- fetch + dots: all fresh rows in flight, then one warp a row ---
    for (int base = 0; base < nf; base += round_rows) {
      const int nr = min(round_rows, nf - base);
      if (copy_mode == COPY_BULK) {
        if (tid == 0) bar_expect(&s_bar, (unsigned)(nr * row_bytes));
        if (tid < nr) {
          bulk_copy(stage + tid * stride,
                    rows + (long long)s_fid[base + tid] * D,
                    (unsigned)row_bytes, &s_bar);
        }
        bar_wait(&s_bar, parity);
        parity ^= 1u;
      } else if (copy_mode == COPY_ASYNC4) {
        const int wpr = row_bytes >> 2;
        for (int w = tid; w < nr * wpr; w += NT) {
          const int k = w / wpr, c = w - k * wpr;
          async_copy4(stage + k * stride + 4 * c,
                      reinterpret_cast<const unsigned char*>(
                          rows + (long long)s_fid[base + k] * D) + 4 * c);
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
      } else {
        for (int w = tid; w < nr * row_bytes; w += NT) {
          const int k = w / row_bytes, c = w - k * row_bytes;
          stage[k * stride + c] = reinterpret_cast<const unsigned char*>(
              rows + (long long)s_fid[base + k] * D)[c];
        }
        __syncthreads();
      }
      // a warp sums two rows at once: the two butterflies interleave
      for (int k = wid; k < nr; k += 2 * NWARPS) {
        const int k2 = k + NWARPS;
        float prod[2];
        prod[0] = row_partial(reinterpret_cast<const T*>(stage + k * stride),
                              q, D, lane);
        prod[1] = k2 < nr ? row_partial(reinterpret_cast<const T*>(
                                            stage + k2 * stride),
                                        q, D, lane)
                          : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          prod[0] += __shfl_xor_sync(0xffffffffu, prod[0], off);
          prod[1] += __shfl_xor_sync(0xffffffffu, prod[1], off);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int f = base + k + u * NWARPS;
          if (k + u * NWARPS < nr && lane == 0) {
            float p = prod[u];
            if constexpr (sizeof(T) == 1) p = __fmul_rn(p, s_fs[f]);
            s_nd[f] = L2 ? l2_combine(s_q2, s_fx[f], p) : -p;
          }
        }
      }
      __syncthreads();  // the staging area is free again
    }
    HOP_MARK(2);

    // ---- merge: stable merge of the sorted beam and the new entries ----
    const int nxt = cur ^ 1;
    if (tid < nf) {
      const float key = s_nd[tid];
      int rank = 0;  // among the new, ties by adjacency order
      for (int k = 0; k < nf; ++k) {
        const float o = s_nd[k];
        rank += (o < key) || (o == key && k < tid);
      }
      s_sk[rank] = key;
      const int pos = count_le(s_bd[cur], l, key) + rank;
      if (pos < l) {
        s_bi[nxt][pos] = s_fid[tid];
        s_bd[nxt][pos] = key;
        s_be[nxt][pos] = 0;
      }
    }
    __syncthreads();
    for (int c = tid; c < l; c += NT) {
      const float key = s_bd[cur][c];
      const int pos = c + count_lt(s_sk, nf, key);
      if (pos < l) {
        s_bi[nxt][pos] = s_bi[cur][c];
        s_bd[nxt][pos] = key;
        s_be[nxt][pos] = s_be[cur][c];
      }
    }
    __syncthreads();
    cur = nxt;
    HOP_END();
  }
  HOP_FLUSH();

  for (int i = tid; i < l; i += NT) {
    beam_ids[lb + i] = s_bi[cur][i];
    beam_dists[lb + i] = s_bd[cur][i];
    beam_exp[lb + i] = s_be[cur][i];
  }
  if (tid == 0) {
    n_vis[b] = nvis;
    n_comps[b] = ncomp;
    n_hops[b] = nhop;
  }
  if (active) {  // all H hops ran: is the lane still active?
    const int i1 = first_frontier(s_bi[cur], s_be[cur], l, s_first, tid);
    if (tid == 0 && i1 < l && isfinite(s_bd[cur][i1]) && nhop < mv) {
      atomicOr(status, STATUS_ACTIVE);
    }
  }
}

template <typename T, bool L2>
static cudaError_t launch_one(const float* queries, int* beam_ids,
                              float* beam_dists, int* beam_exp, int* seen,
                              int* vis_ids, float* vis_dists, int* n_vis,
                              int* n_comps, int* n_hops, const int* adj,
                              const T* rows, const float* scales,
                              const float* norms, const int* nav_words,
                              const int* ret_words, int* status,
                              int* status_clear, int B, int l, int r, int mv,
                              int n_cap, int W, int D, int h,
                              cudaStream_t s) {
  const int row_bytes = D * (int)sizeof(T);
  const int stride = (row_bytes + 15) & ~15;
  const int round_rows = max(1, min(r, STAGE_BYTES / stride));
  const size_t smem = (size_t)((D * 4 + 15) & ~15) +
                      (size_t)round_rows * stride;
  const uintptr_t base = reinterpret_cast<uintptr_t>(rows);
  const int mode = row_bytes % 16 == 0 && base % 16 == 0 ? COPY_BULK
                   : row_bytes % 4 == 0 && base % 4 == 0  ? COPY_ASYNC4
                                                           : COPY_PLAIN;
  // above 48 KB of static plus dynamic shared memory, the kernel must be
  // allowed the dynamic part
  static size_t static_smem = SIZE_MAX;
  if (static_smem == SIZE_MAX) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr,
                                                  beam_hop_kernel<T, L2>);
    if (err != cudaSuccess) return err;
    static_smem = attr.sharedSizeBytes;
  }
  if (static_smem + smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_hop_kernel<T, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  beam_hop_kernel<T, L2><<<B, NT, smem, s>>>(
      queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
      n_vis, n_comps, n_hops, adj, rows, scales, norms, nav_words, ret_words,
      status, status_clear, l, r, mv, n_cap, W, D, h, mode, round_rows);
  return cudaGetLastError();
}

template <typename T>
static int launch(const float* queries, int* beam_ids, float* beam_dists,
                  int* beam_exp, int* seen, int* vis_ids, float* vis_dists,
                  int* n_vis, int* n_comps, int* n_hops, const int* adj,
                  const T* rows, const float* scales, const float* norms,
                  const int* nav_words, const int* ret_words, int* status,
                  int* status_clear, int B, int l, int r, int mv, int n_cap,
                  int W, int D, int h, int l2, void* stream) {
  if (l > L_MAX || r > R_MAX || status == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || h == 0) {  // no launch; the next word is cleared all the same
    return status_clear == nullptr
               ? 0
               : (int)cudaMemsetAsync(status_clear, 0, sizeof(int), s);
  }
  if (l2) {
    return (int)launch_one<T, true>(
        queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
        n_vis, n_comps, n_hops, adj, rows, scales, norms, nav_words,
        ret_words, status, status_clear, B, l, r, mv, n_cap, W, D, h, s);
  }
  return (int)launch_one<T, false>(
      queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
      n_vis, n_comps, n_hops, adj, rows, scales, norms, nav_words, ret_words,
      status, status_clear, B, l, r, mv, n_cap, W, D, h, s);
}

extern "C" int beam_hop_launch(const float* queries, int* beam_ids,
                               float* beam_dists, int* beam_exp, int* seen,
                               int* vis_ids, float* vis_dists, int* n_vis,
                               int* n_comps, int* n_hops, const int* adj,
                               const float* vectors, const float* norms,
                               const int* nav_words, const int* ret_words,
                               int* status, int* status_clear, int B, int l,
                               int r, int mv, int n_cap, int W, int D, int h,
                               int l2, void* stream) {
  return launch<float>(queries, beam_ids, beam_dists, beam_exp, seen,
                       vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                       vectors, nullptr, norms, nav_words, ret_words, status,
                       status_clear, B, l, r, mv, n_cap, W, D, h, l2, stream);
}

extern "C" int beam_hop_q_launch(const float* queries, int* beam_ids,
                                 float* beam_dists, int* beam_exp, int* seen,
                                 int* vis_ids, float* vis_dists, int* n_vis,
                                 int* n_comps, int* n_hops, const int* adj,
                                 const signed char* codes,
                                 const float* scales, const float* qnorms,
                                 const int* nav_words, const int* ret_words,
                                 int* status, int* status_clear, int B, int l,
                                 int r, int mv, int n_cap, int W, int D,
                                 int h, int l2, void* stream) {
  return launch<signed char>(queries, beam_ids, beam_dists, beam_exp, seen,
                             vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                             codes, scales, qnorms, nav_words, ret_words,
                             status, status_clear, B, l, r, mv, n_cap, W, D,
                             h, l2, stream);
}
