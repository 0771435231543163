// Fused GNN layer for Hopper (sm_90a): fp32 in and out, or (cuda_core only)
// bf16 h, weights, bias and out with fp32 adj and mask, as the reference
// takes them (every product and sum in fp32, the output rounded once).
//
// Replaces the TPU kernel fused_gnn_layer (src/repro/kernels/fused_gnn.py,
// _kernel):
//
//     out[c] = act(A[c] @ (H[c] @ Wn) + H[c] @ Ws + b) * mask[c]
//
// Either weight may be absent; act is none, relu or elu. Two kernels; the
// caller picks one by shape before launch (kernels/fused_gnn.py,
// fused_variant).
//
// tf32x3 (N <= 256, Fin and, with Wn, N multiples of 4, h and A 16-byte
// aligned): the tensor cores at about fp32 accuracy, one launch, HW never in
// device memory. Bound: at the serving shape (C=64, N=256, Fin=512,
// Fout=256, +Ws) the layer does 6.44 GFLOP on 67.6 MB; three tf32 products
// each take 3 x 6.44 GFLOP / 494.7 TFLOP/s = 0.039 ms, above the bytes'
// 0.020 ms, so it is bound by tensor-core operations.
//   Split: x = hi + lo with hi = tf32(x) (cvt.rna), lo = tf32(x - hi) (x - hi
//   is exact in fp32); a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small
//   products issued first. What is dropped (a_lo.b_lo and the rounding of
//   each lo) is ~2^-22 of |a.b|. The tensor cores truncate each fp32 sum
//   instead of rounding it; summed that way over all of K (3 x 64 adds at
//   Fin=512) a first version missed the 2e-5 tolerance on the card. So each
//   32-wide k-tile's 12 products go into a fresh partial (scale-d = 0),
//   which the CUDA cores add into the layer's accumulators, rounded to
//   nearest.
//   Grid: one block of 384 threads per (64 output columns, c). Warpgroup 0
//   is the producer: one thread issues TMA loads (3-D tensor maps
//   [C, rows, cols], 128-byte swizzle, boxes of 256 rows x 32 fp32; rows
//   past N and columns past the end read as zeros, so a box never reads the
//   next subgraph) of H's k-tiles and A[c]'s k-tiles; its 128 threads load
//   each 32 x 64 k-tile of Wn and Ws, split it into hi and lo, and store it
//   transposed (tf32 wgmma has no transpose bit: B must be K-major) into the
//   same swizzled layout. Warpgroups 1 and 2 own 128 rows each (two m64
//   tiles) and read their A operand (H, then A[c]) from the swizzled box
//   into registers, split it there and issue wgmma m64n64k8 (A from
//   registers, B from shared memory).
//   Phase 1: HW[:, tile] = H @ Wn[:, tile] and S = H @ Ws[:, tile] in two
//   accumulators over ceil(Fin/32) k-tiles in a two-stage ring (H loaded
//   once per block). Phase 2: HW leaves the registers as HW^T hi and lo
//   (K-major, swizzled) in shared memory, and S += A[c] @ HW over
//   ceil(N/32) k-tiles of A[c], prefetched into a ring of their own during
//   phase 1. Epilogue: the accumulators go to shared memory (over ring 1,
//   row stride 68 floats), then + b, act, * mask, and out as whole 256-byte
//   rows (storing from the fragments, 8-byte pieces of 8 rows at a time,
//   took as long as phase 2).
//   Shared memory (bytes): ring 1, two stages of { H box 32,768; Wn hi, Wn
//   lo, Ws hi, Ws lo 8,192 each } = 131,072, reused after phase 1 for HW^T
//   hi + lo (2 x 65,536); ring 2, two A[c] boxes, 65,536; 10 mbarriers; 1,024
//   of alignment slack: 197,712 of the 232,448 a block may have.
//   Registers: three pairs of m64n64 fp32 accumulators (HW, the output,
//   a k-tile's partial: 192) and the split A fragments of two k-steps (32)
//   in the consumers (setmaxnreg 232); the producer keeps 40.
//
// cuda_core (every other shape, and every bf16 call: the tf32x3 layout is
// fp32's): fp32 on the CUDA cores, one tiled
// shared-memory GEMM with a fused epilogue, batched over C through
// blockIdx.z. A launch computes
//
//     out[c] = epilogue(X1[c] @ Y1[c] + X2[c] @ Y2[c])
//
// where each Y is either shared by every c (batch stride 0: a weight) or
// per c (batch stride K*Nc: the scratch HW). The layer runs as two passes:
//     pass 1:  HW[c]  = H[c] @ Wn                  (into a scratch buffer)
//     pass 2:  out[c] = act(A[c] @ HW[c] + H[c] @ Ws + b) * mask[c]
// and as one pass when Wn is absent (out = act(H @ Ws + b) * mask). It
// does the standard register blocking (4x4 outputs a thread, 64x64 a
// block, K in steps of 16) with two shared-memory stages.
//
// Numerics (both): every output element sums its products in one fixed
// order whatever the grid (tf32x3: over k-tiles of H @ Ws, then of
// A @ HW; cuda_core: H @ Wn's products in increasing k, then A @ HW's, then
// H @ Ws's), with no atomics, so two launches are bitwise equal; col_block
// (the TPU kernel's block_f) only groups column tiles and never changes a
// result.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "hopper.cuh"

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

__host__ __device__ __forceinline__ bool aligned16(const float* p, int ld) {
  return (ld % 4) == 0 && (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// The same four elements of a bf16 matrix, widened to fp32 (scalar loads).
__device__ __forceinline__ float4 load4(const elem::bf16* __restrict__ p,
                                        int r, int c, int R, int Cc, int ld,
                                        bool) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= R) return v;
  const elem::bf16* q = p + (long long)r * ld + c;
  if (c < Cc) v.x = __bfloat162float(q[0]);
  if (c + 1 < Cc) v.y = __bfloat162float(q[1]);
  if (c + 2 < Cc) v.z = __bfloat162float(q[2]);
  if (c + 3 < Cc) v.w = __bfloat162float(q[3]);
  return v;
}
__host__ __device__ __forceinline__ bool aligned16(const elem::bf16*, int) {
  return false;
}

// acc[TM][TN] += X[m0:m0+BM, :K] @ Y[:K, n0:n0+BN] for this thread's
// 4x4 sub-tile; X is [M, K] row-major, Y is [K, Nc] row-major. Two shared
// stages: the global loads of K-step t+1 are issued into registers before
// the FMAs of step t and stored to the other stage after them, so one
// barrier a step suffices and the loads' latency hides under the FMAs.
// Every output sums its products in increasing k.
template <typename TX, typename TY>
__device__ __forceinline__ void mainloop(
    const TX* __restrict__ x, const TY* __restrict__ y, int M,
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

// X1, Y1: the first product's operands; X2: the second's (both h and the
// weight); O: the bias and the output.
template <typename X1, typename Y1, typename X2, typename O>
__global__ void __launch_bounds__(THREADS) gemm_epilogue_kernel(
    const X1* __restrict__ x1, long long sx1,
    const Y1* __restrict__ y1, long long sy1, int k1,
    const X2* __restrict__ x2, long long sx2,
    const X2* __restrict__ y2, long long sy2, int k2,
    const O* __restrict__ bias, const float* __restrict__ mask,
    O* __restrict__ out, int M, int Nc, int col_block, int act) {
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
        if (bias != nullptr) v += elem::to_f32(bias[n]);
        if (act == ACT_RELU) v = fmaxf(v, 0.0f);
        else if (act == ACT_ELU) v = v > 0.0f ? v : expm1f(v);
        out[((long long)c * M + m) * Nc + n] = elem::from_f32<O>(v * mk);
      }
    }
  }
}


// -- the tf32x3 kernel ------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int ROWS = 256;            // rows per block: all of N
constexpr int BN = 64;               // output columns per block
constexpr int BK = 32;               // k per stage: one 128-byte fp32 row
constexpr int THREADS = 384;         // producer + 2 consumer warpgroups
constexpr int KG = 2;                // k8 steps per wgmma group
constexpr int TILE_A = ROWS * BK * 4;        // a box of H or A[c]: 32 KB
constexpr int TILE_W = BN * BK * 4;          // a k-tile of W^T: 8 KB
constexpr int STAGE1 = TILE_A + 4 * TILE_W;  // H box, Wn hi/lo, Ws hi/lo
constexpr int HWT = ROWS * BN * 4;           // HW^T, hi or lo: 64 KB
constexpr int RING2 = 2 * STAGE1;            // offset of the A[c] ring
constexpr int BARS = RING2 + 2 * TILE_A;     // offset of the mbarriers
constexpr int SMEM = 1024 + BARS + 8 * 10;
constexpr int OT = BN + 4;                   // row stride of the output tile
static_assert(2 * HWT <= RING2, "HW^T must fit in ring 1");
static_assert(ROWS * OT * 4 <= RING2, "the output tile must fit in ring 1");

// Byte offset of element (r, k) in a [rows][32] fp32 tile with 128-byte
// swizzle (the layout TMA writes and wgmma reads; the tile 1024-aligned).
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + (k & 3) * 4;
}

// The k-tile k0..k0+31 x n0..n0+63 of w [Fin, Fout] as W^T [64][32] tf32
// hi and lo tiles (K-major, swizzled), zeros outside w. 128 threads; a warp
// covers 8 k x 16 columns per step, so its stores hit 16 banks.
__device__ __forceinline__ void stage_w(const float* __restrict__ w, int k0,
                                        int n0, int Fin, int Fout, bool vec,
                                        uint8_t* hi, uint8_t* lo, int tid) {
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 128 * i, wp = idx >> 5, ln = idx & 31;
    const int k = 8 * (wp >> 2) + (ln >> 2);
    const int n = 4 * (4 * (wp & 3) + (ln & 3));
    v[i] = load4(w, k0 + k, n0 + n, Fin, Fout, Fout, vec);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 128 * i, wp = idx >> 5, ln = idx & 31;
    const int k = 8 * (wp >> 2) + (ln >> 2);
    const int n = 4 * (4 * (wp & 3) + (ln & 3));
    const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t h = tf32_rna(x[j]);
      const int off = swz(n + j, k);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) =
          tf32_rna(x[j] - __uint_as_float(h));
    }
  }
}

// This thread's A fragments of k8 steps kk0..kk0+KG-1 for its two m64
// tiles (rows r0 + 64 mt, + 8), read from a swizzled [256][32] box and split.
__device__ __forceinline__ void load_split(const uint8_t* tile, int kk0,
                                           int r0, int t,
                                           uint32_t (&hi)[KG][2][4],
                                           uint32_t (&lo)[KG][2][4]) {
#pragma unroll
  for (int q = 0; q < KG; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = r0 + 64 * mt, k = 8 * (kk0 + q) + t;
      const float x[4] = {
          *reinterpret_cast<const float*>(tile + swz(r, k)),
          *reinterpret_cast<const float*>(tile + swz(r + 8, k)),
          *reinterpret_cast<const float*>(tile + swz(r, k + 4)),
          *reinterpret_cast<const float*>(tile + swz(r + 8, k + 4))};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[q][mt][e] = tf32_rna(x[e]);
        lo[q][mt][e] = tf32_rna(x[e] - __uint_as_float(hi[q][mt][e]));
      }
    }
}

// acc (+)= a . b in three tf32 products, the two small ones first (acc is
// overwritten where `first`). b_hi and b_lo: shared-memory addresses of
// the k8 slice of B^T's hi and lo tiles.
__device__ __forceinline__ void mma3(float (&acc)[32], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b_hi,
                                     uint32_t b_lo, bool first) {
  wgmma_rs_m64n64k8_tf32(acc, al, desc_sw128(b_hi, 16, 1024), !first);
  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_lo, 16, 1024), 1);
  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_hi, 16, 1024), 1);
}

// acc += the product of one k-tile: this thread's rows of the [256][32] A
// box `tile` times B^T's k-tile (hi and lo at b_hi, b_lo). The tensor
// cores sum the tile's 12 products into the partial p from zero; p is then
// added to acc on the CUDA cores, rounded to nearest. So the truncating
// sums of the tensor cores run over one tile's partial, never over the
// whole of K, and the error stays near fp32's.
__device__ __forceinline__ void tile_product(const uint8_t* tile,
                                             uint32_t b_hi, uint32_t b_lo,
                                             int r0, int t,
                                             float (&p)[2][32],
                                             float (&acc)[2][32]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; kk += KG) {
    uint32_t ah[KG][2][4], al[KG][2][4];
    load_split(tile, kk, r0, t, ah, al);
    fence_regs(p[0]);
    fence_regs(p[1]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KG; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t k8 = 32 * (kk + q);
        mma3(p[mt], ah[q][mt], al[q][mt], b_hi + k8, b_lo + k8,
             kk + q == 0);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(p[0]);
    fence_regs(p[1]);
#pragma unroll
    for (int q = 0; q < KG; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        fence_regs(ah[q][mt]);
        fence_regs(al[q][mt]);
      }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] += p[mt][i];
}

template <bool NEIGH, bool SELF>
__global__ void __launch_bounds__(THREADS, 1) fused_tf32x3_kernel(
    const __grid_constant__ CUtensorMap tm_h,
    const __grid_constant__ CUtensorMap tm_a,
    const float* __restrict__ wn, const float* __restrict__ ws,
    const float* __restrict__ bias, const float* __restrict__ mask,
    float* __restrict__ out, int N, int Fin, int Fout, int act, int vec_w) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t bar = s0 + BARS;
  auto full_h = [&](int s) { return bar + 8 * s; };
  auto full_w = [&](int s) { return bar + 8 * (2 + s); };
  auto empty1 = [&](int s) { return bar + 8 * (4 + s); };
  auto full_a = [&](int s) { return bar + 8 * (6 + s); };
  auto empty_a = [&](int s) { return bar + 8 * (8 + s); };
  const int n0 = blockIdx.x * BN;
  const int c = blockIdx.y;
  const int kt1 = (Fin + BK - 1) / BK;
  const int kt2 = NEIGH ? (N + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_h(s), 1);
      mbar_init(full_w(s), 128);                  // every producer thread
      mbar_init(empty1(s), 2);                    // one per consumer
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                        // producer warpgroup
    regs_dealloc<40>();
    const int tid = threadIdx.x;
    if (tid == 0)
      for (int j = 0; j < 2 && j < kt2; ++j) {
        mbar_expect_tx(full_a(j), TILE_A);
        tma_load_3d(s0 + RING2 + j * TILE_A, &tm_a, full_a(j), BK * j, 0, c);
      }
    for (int kt = 0; kt < kt1; ++kt) {
      const int s = kt & 1;
      if (kt >= 2) mbar_wait(empty1(s), ((kt >> 1) - 1) & 1);
      uint8_t* st = sm + s * STAGE1;
      if (tid == 0) {
        mbar_expect_tx(full_h(s), TILE_A);
        tma_load_3d(s0 + s * STAGE1, &tm_h, full_h(s), BK * kt, 0, c);
      }
      if (NEIGH)
        stage_w(wn, BK * kt, n0, Fin, Fout, vec_w, st + TILE_A,
                st + TILE_A + TILE_W, tid);
      if (SELF)
        stage_w(ws, BK * kt, n0, Fin, Fout, vec_w, st + TILE_A + 2 * TILE_W,
                st + TILE_A + 3 * TILE_W, tid);
      fence_proxy_async();
      mbar_arrive(full_w(s));
    }
    if (tid == 0)
      for (int j = 2; j < kt2; ++j) {
        const int s = j & 1;
        mbar_wait(empty_a(s), ((j >> 1) - 1) & 1);
        mbar_expect_tx(full_a(s), TILE_A);
        tma_load_3d(s0 + RING2 + s * TILE_A, &tm_a, full_a(s), BK * j, 0, c);
      }
    return;
  }

  // consumer warpgroup cw owns rows 128 cw .. + 127: this thread's rows are
  // r0 + 64 mt and + 8, its columns 8 i + 2 t + {0, 1} of the tile
  regs_alloc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int r0 = 128 * cw + 16 * (tid / 32) + (tid % 32) / 4;
  float an[2][32], as[2][32], p[2][32];           // HW, the output, a tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) an[mt][i] = as[mt][i] = 0.0f;

  for (int kt = 0; kt < kt1; ++kt) {
    const int s = kt & 1;
    const uint32_t phase = (kt >> 1) & 1;
    mbar_wait(full_h(s), phase);
    mbar_wait(full_w(s), phase);
    const uint8_t* tile = sm + s * STAGE1;
    const uint32_t w0 = s0 + s * STAGE1 + TILE_A;
    if (NEIGH) tile_product(tile, w0, w0 + TILE_W, r0, t, p, an);
    if (SELF)
      tile_product(tile, w0 + 2 * TILE_W, w0 + 3 * TILE_W, r0, t, p, as);
    if (tid == 0) mbar_arrive(empty1(s));         // release the stage
  }

  if (NEIGH) {
    // HW leaves the registers as HW^T [64][256] tf32 hi and lo, in boxes
    // of 32 rows of HW (K-major for phase 2's B), over ring 1
    bar_sync(1, 256);                             // ring 1 read by both
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 64 * mt + 8 * (e >> 1);
          const int n = 8 * i + 2 * t + (e & 1);
          const int off = (r >> 5) * TILE_W + swz(n, r & 31);
          const float x = an[mt][4 * i + e];
          const uint32_t h = tf32_rna(x);
          *reinterpret_cast<uint32_t*>(sm + off) = h;
          *reinterpret_cast<uint32_t*>(sm + HWT + off) =
              tf32_rna(x - __uint_as_float(h));
        }
    fence_proxy_async();
    bar_sync(1, 256);                             // HW^T whole

    for (int j = 0; j < kt2; ++j) {
      const int s = j & 1;
      mbar_wait(full_a(s), (j >> 1) & 1);
      tile_product(sm + RING2 + s * TILE_A, s0 + j * TILE_W,
                   s0 + HWT + j * TILE_W, r0, t, p, as);
      if (tid == 0) mbar_arrive(empty_a(s));
    }
  }

  // epilogue: the tile goes through shared memory (ring 1, read by no one
  // any more), so that it leaves as whole 256-byte rows
  bar_sync(1, 256);
  float* ot = reinterpret_cast<float*>(sm);       // [256][OT] fp32
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(
            ot + (r0 + 64 * mt + 8 * half) * OT + 8 * i + 2 * t) =
            make_float2(as[mt][4 * i + 2 * half],
                        as[mt][4 * i + 2 * half + 1]);
  bar_sync(1, 256);
  const int cid = threadIdx.x - 128;              // 0 .. 255
  const int q = cid % 16;                         // columns 4q .. 4q + 3
  const int n = n0 + 4 * q;
  float bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (bias != nullptr)
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = n + j < Fout ? bias[n + j] : 0.0f;
  const bool vec_o = (Fout & 3) == 0 && n + 3 < Fout &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int r = cid / 16; r < N; r += 16) {
    const float4 a4 = *reinterpret_cast<const float4*>(ot + r * OT + 4 * q);
    const float m = mask != nullptr ? mask[(long long)c * N + r] : 1.0f;
    float v[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] += bb[j];
      if (act == ACT_RELU) v[j] = fmaxf(v[j], 0.0f);
      else if (act == ACT_ELU) v[j] = v[j] > 0.0f ? v[j] : expm1f(v[j]);
      v[j] *= m;
    }
    float* orow = out + ((long long)c * N + r) * Fout;
    if (vec_o) {
      *reinterpret_cast<float4*>(orow + n) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < Fout) orow[n + j] = v[j];
    }
  }
}

template <bool NEIGH, bool SELF>
int launch(const float* adj, const float* h, const float* wn, const float* ws,
           const float* b, const float* mask, float* out, int C, int N,
           int Fin, int Fout, int act, cudaStream_t stream) {
  CUtensorMap mh, ma;
  int err = make_map_3d(&mh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, h, Fin, N, C,
                        BK, ROWS);
  if (!err)
    err = make_map_3d(&ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      NEIGH ? adj : h, NEIGH ? N : Fin, N, C, BK, ROWS);
  if (err) return err;
  auto kernel = fused_tf32x3_kernel<NEIGH, SELF>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float* w_any = NEIGH ? wn : ws;
  const int vec_w = aligned16(w_any, Fout) && (!NEIGH || !SELF ||
                                               aligned16(ws, Fout));
  const dim3 grid((Fout + BN - 1) / BN, C);
  kernel<<<grid, THREADS, SMEM, stream>>>(mh, ma, wn, ws, b, mask, out, N,
                                          Fin, Fout, act, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The cuda_core kernel's passes for element type T of h, the weights, b and
// out (HW and adj stay fp32).
template <typename T>
int core_launch(const float* adj, const T* h, const T* w_neigh,
                const T* w_self, const T* b, const float* mask, float* hw,
                T* out, int C, int N, int Fin, int Fout, int col_block,
                int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BM - 1) / BM, (Fout + col_block - 1) / col_block, C);
  const long long sh = (long long)N * Fin;
  if (w_neigh == nullptr) {
    gemm_epilogue_kernel<T, T, T, T><<<grid, THREADS, 0, s>>>(
        h, sh, w_self, 0, Fin, nullptr, 0, nullptr, 0, 0, b, mask, out, N,
        Fout, col_block, act);
    return static_cast<int>(cudaGetLastError());
  }
  gemm_epilogue_kernel<T, T, T, float><<<grid, THREADS, 0, s>>>(
      h, sh, w_neigh, 0, Fin, nullptr, 0, nullptr, 0, 0, nullptr, nullptr,
      hw, N, Fout, col_block, ACT_NONE);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_epilogue_kernel<float, float, T, T><<<grid, THREADS, 0, s>>>(
      adj, (long long)N * N, hw, (long long)N * Fout, N,
      w_self != nullptr ? h : nullptr, sh, w_self, 0, Fin, b, mask, out, N,
      Fout, col_block, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// adj [C,N,N] (unused when w_neigh is null), h [C,N,Fin], w_neigh and
// w_self [Fin,Fout] (either may be null, not both), b [Fout] or null,
// mask [C,N] or null, out [C,N,Fout], all contiguous fp32. Each returns 0
// or the error of the launch (cudaError_t, or 10000 + CUresult where a
// tensor map could not be made).

// Shared memory of one tf32x3 block (the wrapper's table checks it).
int fused_tf32x3_smem_bytes() { return tc::SMEM; }

// The tf32x3 kernel: N <= 256; Fin % 4 == 0 and h 16-byte aligned; with
// w_neigh also N % 4 == 0 and adj 16-byte aligned.
int fused_gnn_layer_tf32x3(const float* adj, const float* h,
                           const float* w_neigh, const float* w_self,
                           const float* b, const float* mask, float* out,
                           int C, int N, int Fin, int Fout, int act,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > tc::ROWS) return static_cast<int>(cudaErrorInvalidValue);
  if (w_neigh != nullptr && w_self != nullptr)
    return tc::launch<true, true>(adj, h, w_neigh, w_self, b, mask, out, C,
                                  N, Fin, Fout, act, s);
  if (w_neigh != nullptr)
    return tc::launch<true, false>(adj, h, w_neigh, w_self, b, mask, out, C,
                                   N, Fin, Fout, act, s);
  return tc::launch<false, true>(adj, h, w_neigh, w_self, b, mask, out, C, N,
                                 Fin, Fout, act, s);
}

// The cuda_core kernel, any shape: hw [C,N,Fout] fp32 scratch (unused when
// w_neigh is null); col_block is a multiple of 64. _f32: every tensor fp32;
// _bf16: h, the weights, b and out bf16, adj and mask fp32.
int fused_gnn_layer_f32(const float* adj, const float* h,
                        const float* w_neigh, const float* w_self,
                        const float* b, const float* mask, float* hw,
                        float* out, int C, int N, int Fin, int Fout,
                        int col_block, int act, void* stream) {
  return core_launch<float>(adj, h, w_neigh, w_self, b, mask, hw, out, C, N,
                            Fin, Fout, col_block, act, stream);
}
int fused_gnn_layer_bf16(const float* adj, const elem::bf16* h,
                         const elem::bf16* w_neigh, const elem::bf16* w_self,
                         const elem::bf16* b, const float* mask, float* hw,
                         elem::bf16* out, int C, int N, int Fin, int Fout,
                         int col_block, int act, void* stream) {
  return core_launch<elem::bf16>(adj, h, w_neigh, w_self, b, mask, hw, out, C,
                                 N, Fin, Fout, col_block, act, stream);
}

}  // extern "C"
