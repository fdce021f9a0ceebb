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
// Bound on the H100: bytes, in the random row gathers (per hop and lane an
// R-int adjacency row plus up to R rows of 4D bytes and their norms, or of
// D int8 bytes and their scales and qnorms); the beam merge and the argmin
// are a few thousand shared-memory comparisons.  The kernel is templated on
// the row type: only the distance line differs.  Over int8 rows the raw
// dot is warp_dot_i8 (shared with the quantized gather kernel), the row's
// scale multiplies the product with an explicit rounding, and `norms` are
// the cached qnorms of the dequantized rows.
// Design: one block per lane keeps its beam (double-buffered), the popped
// adjacency row and the R new distances in shared memory across all H hops;
// one warp scores one neighbour with the same warp_dot as the gather kernel,
// so fused and unfused engines give the same bits.  The seen row
// (ceil(n_cap/32) words, 125 KB per lane at n_cap = 10^6) is NOT copied to
// shared memory: only the words a hop touches are tested (L2-coherent
// loads) and set (atomicOr) in place in global memory.  The lane owns its
// row and OR is idempotent, so duplicate neighbours need no dedup.  All
// freshness tests of a hop finish before any of its bits are set, which is
// the reference's read-then-write order.  The merge ranks every entry of
// the (l + R) concatenation directly: rank = #smaller + #equal-and-earlier,
// which is exactly a stable sort, in one pass with no sorting network.
#include <climits>

#include "common.cuh"

#define NT 128
#define NWARPS (NT / 32)
#define L_MAX 256
#define R_MAX 128

__device__ __forceinline__ bool test_bit(const int* words, int id) {
  return ((__ldcg(words + (id >> 5)) >> (id & 31)) & 1) != 0;
}

// The raw row . q dot of each row type (the int8 one before its scale).
__device__ __forceinline__ float row_dot(const float* x, const float* q,
                                         int D, int lane) {
  return warp_dot(x, q, D, lane);
}
__device__ __forceinline__ float row_dot(const signed char* x, const float* q,
                                         int D, int lane) {
  return warp_dot_i8(x, q, D, lane);
}

// T = float: `rows` is the f32 table, `norms` its squared norms, `scales`
// unused.  T = signed char: `rows` is the int8 code table, `scales` the
// per-row scales, `norms` the qnorms.
template <typename T, bool L2>
__global__ void __launch_bounds__(NT)
beam_hop_kernel(const float* __restrict__ queries, int* beam_ids,
                float* beam_dists, int* beam_exp, int* seen, int* vis_ids,
                float* vis_dists, int* n_vis, int* n_comps, int* n_hops,
                const int* __restrict__ adj, const T* __restrict__ rows,
                const float* __restrict__ scales,
                const float* __restrict__ norms,
                const int* __restrict__ nav_words,
                const int* __restrict__ ret_words, int l, int r, int mv,
                int n_cap, int W, int D, int h) {
  extern __shared__ float q[];  // [D]
  __shared__ int s_bi[2][L_MAX];
  __shared__ float s_bd[2][L_MAX];
  __shared__ int s_be[2][L_MAX];
  __shared__ int s_mk[R_MAX];
  __shared__ float s_nd[R_MAX];
  __shared__ float s_red_v[NWARPS];
  __shared__ int s_red_i[NWARPS];
  __shared__ int s_red_a[NWARPS];
  __shared__ int s_active, s_pop_sv, s_fresh;
  __shared__ float s_q2;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long lb = (long long)b * l;
  for (int d = tid; d < D; d += NT) q[d] = queries[(long long)b * D + d];
  for (int i = tid; i < l; i += NT) {
    s_bi[0][i] = beam_ids[lb + i];
    s_bd[0][i] = beam_dists[lb + i];
    s_be[0][i] = beam_exp[lb + i];
  }
  __syncthreads();
  if (L2 && wid == 0) {
    const float q2 = warp_dot(q, q, D, lane);
    if (lane == 0) s_q2 = q2;
  }
  int* seen_row = seen + (long long)b * W;
  int nvis = n_vis[b], ncomp = n_comps[b], nhop = n_hops[b];
  int cur = 0;

  for (int t = 0; t < h; ++t) {
    // ---- active test + first-minimum argmin over the frontier ----------
    float bv = CUDART_INF_F;
    int bidx = INT_MAX, any = 0;
    for (int i = tid; i < l; i += NT) {
      const bool fr = s_bi[cur][i] >= 0 && s_be[cur][i] == 0;
      const float dd = s_bd[cur][i];
      const float fd = fr ? dd : CUDART_INF_F;
      any |= (fr && isfinite(dd));
      if (fd < bv || (fd == bv && i < bidx)) { bv = fd; bidx = i; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ov < bv || (ov == bv && oi < bidx)) { bv = ov; bidx = oi; }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) { s_red_v[wid] = bv; s_red_i[wid] = bidx; s_red_a[wid] = any; }
    __syncthreads();
    if (tid == 0) {
      float v0 = s_red_v[0];
      int i0 = s_red_i[0], a0 = s_red_a[0];
      for (int w = 1; w < NWARPS; ++w) {
        if (s_red_v[w] < v0 || (s_red_v[w] == v0 && s_red_i[w] < i0)) {
          v0 = s_red_v[w]; i0 = s_red_i[w];
        }
        a0 |= s_red_a[w];
      }
      const int active = a0 && nhop < mv;
      s_active = active;
      if (active) {
        const int v = s_bi[cur][i0];
        const float dv = s_bd[cur][i0];
        s_be[cur][i0] = 1;
        const int sv = min(max(v, 0), n_cap - 1);
        s_pop_sv = sv;
        if (test_bit(ret_words, sv)) {  // visited list: returnable pops
          vis_ids[(long long)b * mv + nvis] = v;
          vis_dists[(long long)b * mv + nvis] = dv;
          nvis += 1;
        }
        nhop += 1;
      }
      s_fresh = 0;
    }
    __syncthreads();
    if (!s_active) break;  // the remaining hops are exact no-ops

    // ---- expand: filter the popped vertex's row (read phase) -----------
    const int* row = adj + (long long)s_pop_sv * r;
    int nfresh = 0;
    for (int j = tid; j < r; j += NT) {
      const int nb = row[j];
      const int snb = min(max(nb, 0), n_cap - 1);
      const bool fresh = nb >= 0 && test_bit(nav_words, snb) &&
                         !test_bit(seen_row, snb);
      s_mk[j] = fresh ? nb : -1;
      nfresh += fresh;
    }
    if (nfresh) atomicAdd(&s_fresh, nfresh);
    __syncthreads();
    // ---- write phase: seen bits, then one warp per neighbour distance --
    for (int j = tid; j < r; j += NT) {
      const int nb = s_mk[j];
      if (nb >= 0) {
        atomicOr(reinterpret_cast<unsigned*>(seen_row) + (nb >> 5),
                 1u << (nb & 31));
      }
    }
    for (int j = wid; j < r; j += NWARPS) {
      const int nb = s_mk[j];
      float d = CUDART_INF_F;
      if (nb >= 0) {
        float prod = row_dot(rows + (long long)nb * D, q, D, lane);
        if constexpr (sizeof(T) == 1) prod = __fmul_rn(prod, scales[nb]);
        d = L2 ? l2_combine(s_q2, norms[nb], prod) : -prod;
      }
      if (lane == 0) s_nd[j] = d;
    }
    __syncthreads();
    // ---- stable merge of beam ++ new, keep the best l -------------------
    const int nxt = cur ^ 1;
    for (int c = tid; c < l + r; c += NT) {
      int pos = 0;
      if (c < l) {
        const float key = s_bd[cur][c];
        for (int i = 0; i < l; ++i) {
          const float o = s_bd[cur][i];
          pos += (o < key) || (o == key && i < c);
        }
        for (int k = 0; k < r; ++k) pos += s_nd[k] < key;
        if (pos < l) {
          s_bi[nxt][pos] = s_bi[cur][c];
          s_bd[nxt][pos] = key;
          s_be[nxt][pos] = s_be[cur][c];
        }
      } else {
        const int j = c - l;
        const float key = s_nd[j];
        for (int i = 0; i < l; ++i) pos += s_bd[cur][i] <= key;
        for (int k = 0; k < r; ++k) {
          const float o = s_nd[k];
          pos += (o < key) || (o == key && k < j);
        }
        if (pos < l) {
          s_bi[nxt][pos] = s_mk[j];
          s_bd[nxt][pos] = key;
          s_be[nxt][pos] = 0;
        }
      }
    }
    if (tid == 0) ncomp += s_fresh;
    __syncthreads();
    cur = nxt;
  }

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
}

template <typename T, bool L2>
static void launch_one(const float* queries, int* beam_ids,
                       float* beam_dists, int* beam_exp, int* seen,
                       int* vis_ids, float* vis_dists, int* n_vis,
                       int* n_comps, int* n_hops, const int* adj,
                       const T* rows, const float* scales, const float* norms,
                       const int* nav_words, const int* ret_words, int B,
                       int l, int r, int mv, int n_cap, int W, int D, int h,
                       cudaStream_t s) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(beam_hop_kernel<T, L2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  beam_hop_kernel<T, L2><<<B, NT, smem, s>>>(
      queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
      n_vis, n_comps, n_hops, adj, rows, scales, norms, nav_words, ret_words,
      l, r, mv, n_cap, W, D, h);
}

template <typename T>
static int launch(const float* queries, int* beam_ids, float* beam_dists,
                  int* beam_exp, int* seen, int* vis_ids, float* vis_dists,
                  int* n_vis, int* n_comps, int* n_hops, const int* adj,
                  const T* rows, const float* scales, const float* norms,
                  const int* nav_words, const int* ret_words, int B, int l,
                  int r, int mv, int n_cap, int W, int D, int h, int l2,
                  void* stream) {
  if (B == 0 || h == 0) return 0;
  if (l > L_MAX || r > R_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (l2) {
    launch_one<T, true>(queries, beam_ids, beam_dists, beam_exp, seen,
                        vis_ids, vis_dists, n_vis, n_comps, n_hops, adj, rows,
                        scales, norms, nav_words, ret_words, B, l, r, mv,
                        n_cap, W, D, h, s);
  } else {
    launch_one<T, false>(queries, beam_ids, beam_dists, beam_exp, seen,
                         vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                         rows, scales, norms, nav_words, ret_words, B, l, r,
                         mv, n_cap, W, D, h, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int beam_hop_launch(const float* queries, int* beam_ids,
                               float* beam_dists, int* beam_exp, int* seen,
                               int* vis_ids, float* vis_dists, int* n_vis,
                               int* n_comps, int* n_hops, const int* adj,
                               const float* vectors, const float* norms,
                               const int* nav_words, const int* ret_words,
                               int B, int l, int r, int mv, int n_cap, int W,
                               int D, int h, int l2, void* stream) {
  return launch<float>(queries, beam_ids, beam_dists, beam_exp, seen,
                       vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                       vectors, nullptr, norms, nav_words, ret_words, B, l, r,
                       mv, n_cap, W, D, h, l2, stream);
}

extern "C" int beam_hop_q_launch(const float* queries, int* beam_ids,
                                 float* beam_dists, int* beam_exp, int* seen,
                                 int* vis_ids, float* vis_dists, int* n_vis,
                                 int* n_comps, int* n_hops, const int* adj,
                                 const signed char* codes,
                                 const float* scales, const float* qnorms,
                                 const int* nav_words, const int* ret_words,
                                 int B, int l, int r, int mv, int n_cap,
                                 int W, int D, int h, int l2, void* stream) {
  return launch<signed char>(queries, beam_ids, beam_dists, beam_exp, seen,
                             vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                             codes, scales, qnorms, nav_words, ret_words, B,
                             l, r, mv, n_cap, W, D, h, l2, stream);
}
