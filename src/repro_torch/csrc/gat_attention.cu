// Dense GAT attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel gat_attention
// (src/repro/kernels/gat_attention.py, _kernel). Per subgraph c, head hh
// and destination row i:
//
//     e[j]    = LeakyReLU(s_dst[i] + s_src[j]), or -1e30 where struct <= 0
//     m       = max_j e[j]
//     ex[j]   = exp(e[j] - m), then 0 where struct <= 0
//     attn[j] = ex[j] / max(sum_j ex[j], 1e-20)   (0 for an empty row)
//     out[i, hh*fh:(hh+1)*fh] = sum_j attn[j] * z[j, hh*fh:(hh+1)*fh]
//
// The TPU kernel holds a head's whole [N, N] score matrix on chip (256 KB
// at N=256); here one warp owns one row: its N scores live in shared
// memory (1 KB at N=256), a block of 8 warps takes 8 rows of one
// (c, head), and the head's s_src column is staged once per block. The
// max and the sum are warp reductions; exp is expf, not the fast __expf.
// The weighted sum runs over j in order, each lane owning up to four of
// the head's columns, and skips the j whose weight is 0 (outside the
// structure), which changes nothing for finite z.
//
// Bound: the function moves z, struct and out once and does ~2 FLOP per
// structural entry and head column, so at N=256, F=256, 4 heads it is
// bound by fp32 operations where the structure is dense and by bytes
// where it is sparse. This kernel re-reads the head's z rows from L1/L2
// for every destination row; staging z in shared memory and tiling the
// weighted sum as a small GEMM is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;             // destination rows per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32) gat_attention_kernel(
    const float* __restrict__ z, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const float* __restrict__ st,
    float* __restrict__ out, int N, int F, int H, float slope) {
  extern __shared__ float smem[];
  float* ssrc = smem;                          // [N] this head's s_src
  const int c = blockIdx.z;
  const int hh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int fh = F / H;
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    ssrc[j] = s_src[((long long)c * N + j) * H + hh];
  __syncthreads();
  const int i = blockIdx.x * WARPS + warp;
  if (i >= N) return;                          // no barrier below
  float* e = smem + N + warp * N;              // [N] this row's scores
  const float sd = s_dst[((long long)c * N + i) * H + hh];
  const float* srow = st + ((long long)c * N + i) * N;
  float m = __int_as_float(0xff800000);   // -inf
  for (int j = lane; j < N; j += 32) {
    float v = sd + ssrc[j];
    v = v >= 0.0f ? v : slope * v;
    v = srow[j] > 0.0f ? v : NEG_INF;
    e[j] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float sum = 0.0f;
  for (int j = lane; j < N; j += 32) {
    float x = expf(e[j] - m);
    x = srow[j] > 0.0f ? x : 0.0f;
    e[j] = x;
    sum += x;
  }
  const float denom = fmaxf(warp_sum(sum), 1e-20f);
  for (int j = lane; j < N; j += 32) e[j] = e[j] / denom;
  __syncwarp();
  const float* zc = z + (long long)c * N * F + hh * fh;
  float* orow = out + ((long long)c * N + i) * F + hh * fh;
  for (int f0 = 0; f0 < fh; f0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < N; ++j) {
      const float a = e[j];
      if (a == 0.0f) continue;               // warp-uniform
      const float* zr = zc + (long long)j * F + f0 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f0 + q * 32 + lane < fh) acc[q] = fmaf(a, zr[q * 32], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (f0 + q * 32 + lane < fh) orow[f0 + q * 32 + lane] = acc[q];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at this N (the caller checks the limit).
int gat_attention_smem_bytes(int N) {
  return (1 + WARPS) * N * static_cast<int>(sizeof(float));
}

// z [C,N,F], s_src/s_dst [C,N,H], struct [C,N,N], out [C,N,F]; F % H == 0.
// Returns cudaGetLastError.
int gat_attention_f32(const float* z, const float* s_src, const float* s_dst,
                      const float* st, float* out, int C, int N, int F,
                      int H, float slope, void* stream) {
  const int smem = gat_attention_smem_bytes(N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gat_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + WARPS - 1) / WARPS, H, C);
  gat_attention_kernel<<<grid, WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      z, s_src, s_dst, st, out, N, F, H, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
