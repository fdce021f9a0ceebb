// Diagnostic split of the fused hop kernel's time by phase, from clock64
// counters: 0 pop, 1 expand (adjacency row, freshness tests), 2 fetch +
// dots (neighbour rows and their distances), 3 merge.  Thread 0 of each
// block reads the clock at the phase boundaries of every hop that does work
// (an inactive lane's last test is not counted) and, when the block ends,
// adds its sums to one device array.
//
// Compiled in only with -DBEAM_HOP_PHASES, in a variant build that
// kernels/beam_hop_breakdown.py loads; the regular build defines the marks
// as nothing.  beam_hop_phases(out) copies the sums (cycles of phases 0-3,
// hops, blocks) to the host and zeroes them.
#pragma once

#ifdef BEAM_HOP_PHASES
__device__ unsigned long long g_hop_phase[6];

#define HOP_DECL                                  \
  unsigned long long hp_acc[4] = {0, 0, 0, 0};    \
  unsigned long long hp_n = 0;                    \
  long long hp_t = 0;
#define HOP_START()                               \
  if (threadIdx.x == 0) hp_t = clock64();
#define HOP_MARK(k)                               \
  if (threadIdx.x == 0) {                         \
    const long long hp_c = clock64();             \
    hp_acc[k] += (unsigned long long)(hp_c - hp_t); \
    hp_t = hp_c;                                  \
  }
#define HOP_END()                                 \
  HOP_MARK(3)                                     \
  if (threadIdx.x == 0) hp_n += 1;
#define HOP_FLUSH()                               \
  if (threadIdx.x == 0) {                         \
    for (int hp_k = 0; hp_k < 4; ++hp_k)          \
      atomicAdd(&g_hop_phase[hp_k], hp_acc[hp_k]); \
    atomicAdd(&g_hop_phase[4], hp_n);             \
    atomicAdd(&g_hop_phase[5], 1ull);             \
  }

extern "C" int beam_hop_phases(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_hop_phase, sizeof(g_hop_phase));
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_hop_phase, zero, sizeof(zero));
  return (int)err;
}
#else
#define HOP_DECL
#define HOP_START()
#define HOP_MARK(k)
#define HOP_END()
#define HOP_FLUSH()
#endif
