// RobustPrune's selection loop (Algorithm 3) in one launch: kernel 7.
//
// Stands for the reference's `lax.fori_loop` in repro/core/prune.py::
// robust_prune, which has no Pallas kernel: XLA runs it as one while loop on
// the TPU.  The port ran each of its r steps as some eleven eager PyTorch
// ops (a masked min, gathers, compares, a scatter) and read the host every
// eight steps, about 10 ms of launch latency per call around microseconds
// of work.  Here the whole selection of a row is one thread block.
//
// Inputs, computed by the caller's PyTorch code before the launch, for M
// rows of C candidates: ids i32[M, C] (INVALID = -1 where the candidate is
// dead), d_p f32[M, C] (d(p, x_u), +inf where dead), pair f32[M, C, C]
// (pair[m, j, u] = d(x_j, x_u)) and alpha rounded to f32.  Output
// i32[M, R]: the selected ids in selection order, INVALID after the last.
// A step is the plain loop's (kernels/robust_prune.py), bit for bit:
//
//   key_u = alive_u ? d_p[u] : +inf;  j = the first minimum of key
//     (NaN before any number and the lowest index among equals, as
//     torch.min's dim reduction, so -0 ties +0);
//   key_j <  +inf: emit ids[j]; alive_u &= alpha * pair[j, u] > d_p[u];
//   key_j == +inf: no live candidate is finite, so this step and every
//     later one emit nothing: stop;
//   key_j NaN:     emit nothing;
//   alive_j = false.
//
// Bound on the H100: latency, not bytes.  A call reads
// M * (8C + 4C * steps) bytes (an insert, M = 1, C = 192, about 50 KB:
// 15 ns at 3.35 TB/s) but takes up to R dependent steps, each a block-wide
// argmin and one read of a C-float row of the pair matrix, which its
// producer has just written and the L2 holds.  The design keeps the step
// short: one thread per candidate (C <= 512, a warp multiple of threads)
// with its id, d_p and alive bit in registers; the argmin is one 64-bit
// key (order-preserving bits of the value, then the index) reduced by
// warp shuffles and one pass over the per-warp minima in shared memory,
// which every warp reads itself, so no second barrier hands the winner
// out; the candidate that wins writes its own id; the loop ends at
// __syncthreads_or(alive) once nothing is left, with no host read.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 512;
constexpr unsigned long long kPast = ~0ull;  // a thread past C
constexpr unsigned int kInfBits = 0xff800000u;  // order_bits(+inf)

// Unsigned bits ordered as the floats, NaN first; -0 maps to +0.
__device__ __forceinline__ unsigned int order_bits(float v) {
  if (v != v) return 0u;
  unsigned int u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o < k ? o : k;
  }
  return k;
}

__global__ void __launch_bounds__(kMaxC)
robust_prune_kernel(const int* __restrict__ ids,
                    const float* __restrict__ d_p,
                    const float* __restrict__ pair, int* __restrict__ out,
                    int C, int R, float alpha) {
  __shared__ unsigned long long s_min[kMaxC / 32];
  const int u = threadIdx.x, lane = u & 31, wid = u >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const bool in = u < C;
  const int id = in ? ids[row * C + u] : -1;
  const float dp = in ? d_p[row * C + u] : 0.0f;
  const unsigned long long live_key =
      ((unsigned long long)order_bits(dp) << 32) | (unsigned)u;
  const unsigned long long dead_key =
      in ? (((unsigned long long)kInfBits << 32) | (unsigned)u) : kPast;
  const float* prow = pair + row * C * C;
  int* orow = out + row * R;
  bool alive = id >= 0;
  int n_out = 0;
  for (int step = 0; step < R; ++step) {
    // also the barrier between the last step's reads of s_min and this
    // step's writes
    if (!__syncthreads_or(alive)) break;
    unsigned long long k = warp_min(alive ? live_key : dead_key);
    if (lane == 0) s_min[wid] = k;
    __syncthreads();
    k = warp_min(lane < nwarps ? s_min[lane] : kPast);
    const unsigned int bits = (unsigned int)(k >> 32);
    const int j = (int)(unsigned int)k;
    if (bits == kInfBits) break;
    if (bits != 0u) {
      if (u == j) orow[n_out] = id;
      ++n_out;
      if (alive) alive = __fmul_rn(alpha, prow[(long long)j * C + u]) > dp;
    }
    if (u == j) alive = false;
  }
  for (int i = n_out + u; i < R; i += blockDim.x) orow[i] = -1;
}

}  // namespace

extern "C" int robust_prune_launch(const int* ids, const float* d_p,
                                   const float* pair, int* out, int M, int C,
                                   int R, float alpha, cudaStream_t stream) {
  if (M < 1 || C < 1 || C > kMaxC || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (C + 31) / 32 * 32;
  robust_prune_kernel<<<M, threads, 0, stream>>>(ids, d_p, pair, out, C, R,
                                                 alpha);
  return (int)cudaGetLastError();
}
