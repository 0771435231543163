// Edge-list scatter-gather aggregation for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel scatter_gather_aggregate
// (src/repro/kernels/scatter_gather.py, _kernel):
//
//     out[c, i] = sum_e [dst[c, e] == i] * w[c, e] * h[c, src[c, e]]
//
// The TPU kernel routes edges through one-hot matmuls because its matrix
// unit is the only fast path there. A GPU gathers rows directly, so this
// kernel walks the edge list.
//
// Design: one warp per (c, tile of 32 feature columns). The warp keeps an
// [N, 32] fp32 accumulator in shared memory (32 KB at N=256), each lane
// owning one column. It walks the edges in order, 32 at a time: every lane
// loads one edge (coalesced), the warp broadcasts them with shuffles, and
// each lane adds w * h[src, col] into acc[dst, col]. So every destination
// sums its edges in edge order, with the multiply and the add rounded
// separately, exactly as segment_sum does: no atomics, the same result on
// every run, no padding of E to a block multiple, and a destination that
// receives many edges (the paper's RAW hazard) sums them all in order.
// Edges whose src or dst fall outside [0, N) are skipped, as segment_sum
// drops out-of-range destinations, and so are edges of weight 0, which add
// nothing for finite h (the padded tail of every subgraph's edge list).
//
// Bound: the function must move src, dst, w, h and out once, and does
// 2 FLOP per real edge and column, so it is bound by bytes. This kernel
// is instead bound by latency: one warp per 32 columns, at most 7 warps an
// SM under the accumulator's shared memory. Each chunk's 32 row gathers
// are issued together before its 32 ordered adds, so their latencies
// overlap; a dst-sorted segmented reduction that keeps sums in registers
// is later work.
#include <cuda_runtime.h>

namespace {

constexpr int BF = 32;               // columns per warp, one per lane

__global__ void __launch_bounds__(BF) scatter_gather_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, int N, int E, int F) {
  extern __shared__ float acc[];     // [N][BF]
  const int c = blockIdx.y;
  const int lane = threadIdx.x;
  const int f = blockIdx.x * BF + lane;
  const bool col_ok = f < F;
  for (int i = lane; i < N * BF; i += BF) acc[i] = 0.0f;
  __syncwarp();
  const int* sc = src + (long long)c * E;
  const int* dc = dst + (long long)c * E;
  const float* wc = w + (long long)c * E;
  const float* hc = h + (long long)c * N * F;
  for (int e0 = 0; e0 < E; e0 += BF) {
    const int e = e0 + lane;
    int se = -1, de = -1;
    float we = 0.0f;
    if (e < E) {
      se = sc[e];
      de = dc[e];
      we = wc[e];
    }
    // edges of weight 0 (the padded tail of every subgraph's list) and
    // edges with an index outside [0, N) are skipped; the vote is
    // warp-uniform, so a chunk of padding costs one ballot
    const bool ok = we != 0.0f &&
                    static_cast<unsigned>(se) < static_cast<unsigned>(N) &&
                    static_cast<unsigned>(de) < static_cast<unsigned>(N);
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    if (live == 0u) continue;
    // gather the chunk's 32 source rows first (independent loads in
    // flight together), then accumulate them in edge order
    float v[BF];
#pragma unroll
    for (int j = 0; j < BF; ++j) {
      const int sj = __shfl_sync(0xffffffffu, se, j);
      v[j] = ((live >> j) & 1u) && col_ok ? hc[(long long)sj * F + f]
                                          : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BF; ++j) {
      const int dj = __shfl_sync(0xffffffffu, de, j);
      const float wj = __shfl_sync(0xffffffffu, we, j);
      if ((live >> j) & 1u)
        acc[dj * BF + lane] =
            __fadd_rn(acc[dj * BF + lane], __fmul_rn(v[j], wj));
    }
  }
  __syncwarp();
  if (col_ok)
    for (int i = 0; i < N; ++i)
      out[((long long)c * N + i) * F + f] = acc[i * BF + lane];
}

}  // namespace

extern "C" {

// Shared memory one block needs at this N (the caller checks the limit).
int scatter_gather_smem_bytes(int N) {
  return N * BF * static_cast<int>(sizeof(float));
}

// src/dst [C,E] int32, w [C,E], h [C,N,F], out [C,N,F]. Returns
// cudaGetLastError.
int scatter_gather_aggregate_f32(const int* src, const int* dst,
                                 const float* w, const float* h, float* out,
                                 int C, int N, int E, int F, void* stream) {
  const int smem = scatter_gather_smem_bytes(N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((F + BF - 1) / BF, C);
  scatter_gather_kernel<<<grid, BF, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, w, h, out, N, E, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
