// Fused GNN layer for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel fused_gnn_layer (src/repro/kernels/fused_gnn.py,
// _kernel):
//
//     out[c] = act(A[c] @ (H[c] @ Wn) + H[c] @ Ws + b) * mask[c]
//
// Either weight may be absent; act is none, relu or elu.
//
// Design: one tiled shared-memory GEMM with a fused epilogue, batched over
// C through blockIdx.z. A launch computes
//
//     out[c] = epilogue(X1[c] @ Y1[c] + X2[c] @ Y2[c])
//
// where each Y is either shared by every c (batch stride 0: a weight) or
// per c (batch stride K*Nc: the scratch HW). The layer runs as two passes:
//     pass 1:  HW[c]  = H[c] @ Wn                  (into a scratch buffer)
//     pass 2:  out[c] = act(A[c] @ HW[c] + H[c] @ Ws + b) * mask[c]
// and as one pass when Wn is absent (out = act(H @ Ws + b) * mask).
// The TPU kernel keeps HW on chip for the whole layer; an H100 block has
// at most 227 KB of shared memory, far less than the ~1.8 MB that A, H and
// W take at N=256, Fin=512, so this kernel tiles over N and Fin and
// writes HW to device memory. Keeping HW on chip (one block owning whole
// rows of A) is later work.
//
// Bound: at the serving shapes (N=256, Fin=512, Fout=256) the layer does
// ~64 FLOP per byte it must move, above the fp32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by fp32 operations.
// No TF32: the tensor cores would miss the fp32 tolerance of 2e-5. The
// design does the standard register blocking (4x4 outputs a thread, 64x64
// a block, K in steps of 16) so each shared-memory value feeds 4 FMAs,
// with two shared-memory stages so the next step's loads overlap the FMAs.
//
// Numerics: every output element sums its K products in increasing k,
// first over X1 @ Y1 and then over X2 @ Y2, whatever the grid; col_block
// (the TPU kernel's block_f) only groups column tiles into blocks and
// never changes a result.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;               // rows of the output tile
constexpr int BN = 64;               // columns of the output tile
constexpr int BK = 16;               // depth of one shared-memory stage
constexpr int TM = 4;                // rows a thread owns
constexpr int TN = 4;                // columns a thread owns
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_ELU = 2 };

// Four consecutive floats of row r, columns c..c+3, of a row-major
// [R, Cc] matrix with leading dimension ld; zeros outside the matrix. One
// 16-byte load where the row slice is whole and aligned (vec).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int r,
                                        int c, int R, int Cc, int ld,
                                        bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= R) return v;
  const float* q = p + (long long)r * ld + c;
  if (vec && c + 3 < Cc) return *reinterpret_cast<const float4*>(q);
  if (c < Cc) v.x = q[0];
  if (c + 1 < Cc) v.y = q[1];
  if (c + 2 < Cc) v.z = q[2];
  if (c + 3 < Cc) v.w = q[3];
  return v;
}

__device__ __forceinline__ bool aligned16(const float* p, int ld) {
  return (ld % 4) == 0 && (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// acc[TM][TN] += X[m0:m0+BM, :K] @ Y[:K, n0:n0+BN] for this thread's
// 4x4 sub-tile; X is [M, K] row-major, Y is [K, Nc] row-major. Two shared
// stages: the global loads of K-step t+1 are issued into registers before
// the FMAs of step t and stored to the other stage after them, so one
// barrier a step suffices and the loads' latency hides under the FMAs.
// Every output sums its products in increasing k.
__device__ __forceinline__ void mainloop(
    const float* __restrict__ x, const float* __restrict__ y, int M,
    int K, int Nc, int m0, int n0, float (*xs)[BK][BM],
    float (*ys)[BK][BN], float acc[TM][TN]) {
  const int t = threadIdx.x;
  const int ty = t / (BN / TN);
  const int tx = t % (BN / TN);
  // X tile loader: 64 rows x 16 k, 4 consecutive k per thread
  const int xr = t / (BK / 4);
  const int xk = (t % (BK / 4)) * 4;
  // Y tile loader: 16 k x 64 columns, 4 consecutive columns per thread
  const int yk = t / (BN / 4);
  const int yc = (t % (BN / 4)) * 4;
  const bool vx = aligned16(x, K);
  const bool vy = aligned16(y, Nc);
  const int steps = (K + BK - 1) / BK;
  float4 xa = load4(x, m0 + xr, xk, M, K, K, vx);
  float4 ya = load4(y, yk, n0 + yc, K, Nc, Nc, vy);
  xs[0][xk + 0][xr] = xa.x;
  xs[0][xk + 1][xr] = xa.y;
  xs[0][xk + 2][xr] = xa.z;
  xs[0][xk + 3][xr] = xa.w;
  *reinterpret_cast<float4*>(&ys[0][yk][yc]) = ya;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool next = s + 1 < steps;
    if (next) {
      const int k0 = (s + 1) * BK;
      xa = load4(x, m0 + xr, k0 + xk, M, K, K, vx);
      ya = load4(y, k0 + yk, n0 + yc, K, Nc, Nc, vy);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(&xs[cur][kk][ty * TM]);
      const float4 b =
          *reinterpret_cast<const float4*>(&ys[cur][kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) {
      xs[cur ^ 1][xk + 0][xr] = xa.x;
      xs[cur ^ 1][xk + 1][xr] = xa.y;
      xs[cur ^ 1][xk + 2][xr] = xa.z;
      xs[cur ^ 1][xk + 3][xr] = xa.w;
      *reinterpret_cast<float4*>(&ys[cur ^ 1][yk][yc]) = ya;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) gemm_epilogue_kernel(
    const float* __restrict__ x1, long long sx1,
    const float* __restrict__ y1, long long sy1, int k1,
    const float* __restrict__ x2, long long sx2,
    const float* __restrict__ y2, long long sy2, int k2,
    const float* __restrict__ bias, const float* __restrict__ mask,
    float* __restrict__ out, int M, int Nc, int col_block, int act) {
  __shared__ __align__(16) float xs[2][BK][BM];
  __shared__ __align__(16) float ys[2][BK][BN];
  const int c = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
  const int n_end = min(Nc, (blockIdx.y + 1) * col_block);
  for (int n0 = blockIdx.y * col_block; n0 < n_end; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    mainloop(x1 + c * sx1, y1 + c * sy1, M, k1, Nc, m0, n0, xs, ys, acc);
    if (x2 != nullptr)
      mainloop(x2 + c * sx2, y2 + c * sy2, M, k2, Nc, m0, n0, xs, ys, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
      const float mk = mask != nullptr ? mask[(long long)c * M + m] : 1.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n >= n_end) continue;
        float v = acc[i][j];
        if (bias != nullptr) v += bias[n];
        if (act == ACT_RELU) v = fmaxf(v, 0.0f);
        else if (act == ACT_ELU) v = v > 0.0f ? v : expm1f(v);
        out[((long long)c * M + m) * Nc + n] = v * mk;
      }
    }
  }
}

}  // namespace

extern "C" {

// adj [C,N,N] (unused when w_neigh is null), h [C,N,Fin], w_neigh and
// w_self [Fin,Fout] (either may be null, not both), b [Fout] or null,
// mask [C,N] or null, hw [C,N,Fout] scratch (unused when w_neigh is null),
// out [C,N,Fout]. col_block is a multiple of 64. Returns cudaGetLastError.
int fused_gnn_layer_f32(const float* adj, const float* h,
                        const float* w_neigh, const float* w_self,
                        const float* b, const float* mask, float* hw,
                        float* out, int C, int N, int Fin, int Fout,
                        int col_block, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BM - 1) / BM, (Fout + col_block - 1) / col_block, C);
  const long long sh = (long long)N * Fin;
  if (w_neigh == nullptr) {
    gemm_epilogue_kernel<<<grid, THREADS, 0, s>>>(
        h, sh, w_self, 0, Fin, nullptr, 0, nullptr, 0, 0, b, mask, out, N,
        Fout, col_block, act);
    return static_cast<int>(cudaGetLastError());
  }
  gemm_epilogue_kernel<<<grid, THREADS, 0, s>>>(
      h, sh, w_neigh, 0, Fin, nullptr, 0, nullptr, 0, 0, nullptr, nullptr,
      hw, N, Fout, col_block, ACT_NONE);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_epilogue_kernel<<<grid, THREADS, 0, s>>>(
      adj, (long long)N * N, hw, (long long)N * Fout, N,
      w_self != nullptr ? h : nullptr, sh, w_self, 0, Fin, b, mask, out, N,
      Fout, col_block, act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
