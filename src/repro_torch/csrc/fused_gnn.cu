// Fused GNN layer for Hopper (sm_90a): fp32 in and out, or bf16 h,
// weights, bias and out with fp32 adj and mask, as the reference takes them
// (every product exact or in fp32, every sum in fp32, the output rounded
// once).
//
// Replaces the TPU kernel fused_gnn_layer (src/repro/kernels/fused_gnn.py,
// _kernel):
//
//     out[c] = act(A[c] @ (H[c] @ Wn) + H[c] @ Ws + b) * mask[c]
//
// Either weight may be absent; act is none, relu or elu. Three kernels; the
// caller picks one by dtype and shape before launch (kernels/fused_gnn.py,
// fused_variant).
//
// tf32x3 (N <= 256, Fin and, with Wn, N multiples of 4, h and A 16-byte
// aligned): the tensor cores at about fp32 accuracy, one launch, HW never in
// device memory. Bound: at the serving shape (C=64, N=256, Fin=512,
// Fout=256, w_neigh) the layer does 6.44 GFLOP on 67.7 MB; three tf32
// products each take 3 x 6.44 GFLOP / 494.7 TFLOP/s = 0.039 ms, above the
// bytes' 0.020 ms, so it is bound by tensor-core operations.
//   Split: x = hi + lo with hi = tf32(x) (cvt.rna), lo = tf32(x - hi) (x - hi
//   is exact in fp32); a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small
//   products issued first. What is dropped (a_lo.b_lo and the rounding of
//   each lo) is ~2^-22 of |a.b|. The tensor cores truncate each fp32 sum
//   instead of rounding it; summed that way over all of K (3 x 64 adds at
//   Fin=512) a first version missed the 2e-5 tolerance on the card. So each
//   32-wide k-tile's 12 products go into a fresh partial (scale-d = 0),
//   which the CUDA cores add into the layer's accumulators, rounded to
//   nearest.
//   The weights come split: the wrapper makes W^T's hi and lo once a weight
//   (kernels/fused_gnn.py, weight_split; the same bits as tf32_rna below)
//   as [2][Fout][Fin], K-major, the layout tf32 wgmma's B operand needs
//   (tf32 has no transpose bit), so no block splits or transposes them.
//   Grid: one block of 384 threads per (64 output columns, c). Warpgroup 0
//   is the producer: one thread issues every TMA load (3-D tensor maps,
//   128-byte swizzle, boxes of 32 fp32 along k; rows past N and columns
//   past the end read as zeros, so a box never reads the next subgraph): H's
//   and A[c]'s k-tiles as [256][32] boxes, the W^T hi and lo k-tiles of the
//   block's columns as [64][32] boxes. Warpgroups 1 and 2 own 128 rows each
//   (two m64 tiles) and read their A operand (H, then A[c]) from the
//   swizzled box into registers, split it there and issue wgmma m64n64k8
//   (A from registers, B from shared memory): one wgmma group a k8 step, the
//   next step's fragments read and split while it runs (a wait that leaves
//   one group pending), so the pipe drains once a k-tile, where the
//   partial is added.
//   Phase 1: HW[:, tile] = H @ Wn[:, tile] and S = H @ Ws[:, tile] in two
//   accumulators over ceil(Fin/32) k-tiles in a three-stage ring. Phase 2:
//   HW leaves the registers as HW^T hi and lo (K-major, swizzled) in shared
//   memory, and S += A[c] @ HW over ceil(N/32) k-tiles of A[c] in a ring of
//   their own. Epilogue: the accumulators go to shared memory (over ring 1,
//   row stride 68 floats), then + b, act, * mask, and out as whole 256-byte
//   rows (storing from the fragments, 8-byte pieces of 8 rows at a time,
//   took as long as phase 2).
//   Where the time goes (scripts/fused_phase_probe.py, serving shape):
//   ~1.26 us a k-tile of either phase with both consumers issuing; a k-tile
//   reads ~176 KB of shared memory (TMA's writes, wgmma's B, the A
//   fragments), about two thirds of what the SM's shared memory moves in
//   that time, and the tensor cores run at about two thirds of their rate.
//   Tried and dropped (scripts/fused_design_probe.py): clusters of 2 and 4
//   blocks of one subgraph sharing each H and A[c] box by TMA multicast
//   (1.7x and 3x slower), the consumers staggered by half a k-tile, the
//   tensor maps prefetched (neither moved the time), a persistent grid
//   whose producer loads the next item's first k-tiles under the epilogue
//   (the output tile over ring 2; 7 % slower at Fin=512, with 48 bytes of
//   spill in the w_neigh form).
//   Shared memory (bytes): ring 1, three stages of { H box 32,768; W^T hi
//   and lo 8,192 each, of Wn and of Ws } = 147,456 or 196,608; HW^T hi + lo
//   (2 x 65,536) over its first 131,072 after phase 1 and ring 2, two A[c]
//   boxes, right after them (over ring 1's last stage, loaded once phase 1
//   has released it); 10 mbarriers; 1,024 of alignment slack: 197,712 of
//   the 232,448 a block may have (self-only: 148,560).
//   Registers: three pairs of m64n64 fp32 accumulators (HW, the output,
//   a k-tile's partial: 192) and two k8 steps' split A fragments (32) in
//   the consumers (setmaxnreg 240); the producer keeps 24: exactly the
//   168 x 384 the launch holds.
//
// wgmma_bf16 (bf16 at tf32x3's shapes, Fin and Fout multiples of 8, h and
// the weights 16-byte aligned): tf32x3's pipeline with phase 1 in bf16.
// Bound: at C=64 N=256 Fin=512 Fout=256 (w_neigh) the layer does 4.29
// GFLOP of bf16 products (4.3 us at 989 TFLOP/s) and 2.15 GFLOP of A @ HW
// in three tf32 products (13.0 us at 494.7), above its bytes' 10.8 us.
//   Phase 1 runs on bf16 wgmma m64n64k16 with both operands straight from
//   the TMA-loaded tiles: a [256][64] bf16 box of H (K-major, 128-byte
//   swizzle) and [64][64] tiles of Wn and Ws read MN-major with the
//   transpose bit, so the producer's threads split and stage nothing (one
//   thread issues every load). A three-stage ring of { H box 32,768; Wn,
//   Ws tiles 8,192 each }. bf16 products are exact in fp32; each 64-wide
//   k-tile's products go into a fresh partial (scale-d = 0) added on the
//   CUDA cores, as in tf32x3, so the tensor cores' truncating sums never
//   run over all of Fin. HW stays fp32 and phase 2 and the epilogue are
//   tf32x3's (A @ HW in three tf32 products), with one rounding to bf16 at
//   the store. Every consumer warp arrives on the empty barriers itself,
//   after its own wgmma wait. Shared memory: ring 1 147,456 (HW^T hi + lo
//   and the output tile reuse it), ring 2 65,536, 10 mbarriers, 1,024 of
//   slack: 214,096.
//
// cuda_core (every other shape): fp32 on the CUDA cores, one tiled
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
// Numerics (all three): every output element sums its products in one
// fixed order whatever the grid (tf32x3 and wgmma_bf16: over k-tiles of
// H @ Ws, then of A @ HW; cuda_core: H @ Wn's products in increasing k,
// then A @ HW's, then H @ Ws's), with no atomics, so two launches are
// bitwise equal; col_block
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
constexpr int STAGES = 3;            // ring 1's depth
constexpr int WARPS = 8;             // consumer warps: one arrive each
constexpr int TILE_A = ROWS * BK * 4;        // a box of H or A[c]: 32 KB
constexpr int TILE_W = BN * BK * 4;          // a k-tile of W^T hi or lo: 8 KB
constexpr int HWT = ROWS * BN * 4;           // HW^T, hi or lo: 64 KB
constexpr int OT = BN + 4;                   // row stride of the output tile
constexpr int MAX_SMEM = 232448;             // what a block may have

// One form's shared memory: ring 1 (STAGES x { H box; W^T hi, lo of Wn
// and of Ws }); with Wn, HW^T hi and lo (phase 2's B) over ring 1's first
// 128 KB and ring 2 (two A[c] boxes) right after them, over ring 1's last
// stage where ring 1 is longer (three stages: ring 2 is loaded once phase 1
// has released that stage); then the mbarriers. The output tile reuses the
// space below ring 2.
template <bool NEIGH, bool SELF>
struct Layout {
  static constexpr int STAGE1 = TILE_A + 2 * (NEIGH + SELF) * TILE_W;
  static constexpr int RING1 = STAGES * STAGE1;
  static constexpr int RING2 = 2 * HWT;
  static constexpr bool OVER = NEIGH && RING1 > RING2;
  static constexpr int END2 = NEIGH ? RING2 + 2 * TILE_A : 0;
  static constexpr int BARS = RING1 > END2 ? RING1 : END2;
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * STAGES + 4);
  static_assert(!OVER || (STAGES - 1) * STAGE1 <= RING2,
                "ring 2 may lie over ring 1's last stage only");
  static_assert(ROWS * OT * 4 <= (NEIGH ? RING2 : RING1),
                "the output tile must fit below ring 2");
  static_assert(SMEM <= MAX_SMEM, "more shared memory than a block has");
};

// Byte offset of element (r, k) in a [rows][32] fp32 tile with 128-byte
// swizzle (the layout TMA writes and wgmma reads; the tile 1024-aligned).
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + (k & 3) * 4;
}

// This thread's A fragments of k8 step kk for its two m64 tiles (rows r0
// + 64 mt, + 8), read from a swizzled [256][32] box and split.
__device__ __forceinline__ void load_split(const uint8_t* tile, int kk,
                                           int r0, int t,
                                           uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = r0 + 64 * mt, k = 8 * kk + t;
    const float x[4] = {
        *reinterpret_cast<const float*>(tile + swz(r, k)),
        *reinterpret_cast<const float*>(tile + swz(r + 8, k)),
        *reinterpret_cast<const float*>(tile + swz(r, k + 4)),
        *reinterpret_cast<const float*>(tile + swz(r + 8, k + 4))};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[mt][e] = tf32_rna(x[e]);
      lo[mt][e] = tf32_rna(x[e] - __uint_as_float(hi[mt][e]));
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

// fence_regs for the fragments of both m64 tiles.
__device__ __forceinline__ void fence_frags(uint32_t (&f)[2][4]) {
  fence_regs(f[0]);
  fence_regs(f[1]);
}

// acc += the product of one k-tile: this thread's rows of the [256][32] A
// box `tile` times B^T's k-tile (hi and lo at b_hi, b_lo). The tensor
// cores sum the tile's 12 products into the partial p from zero; p is then
// added to acc on the CUDA cores, rounded to nearest. So the truncating
// sums of the tensor cores run over one tile's partial, never over the
// whole of K, and the error stays near fp32's. Each k8 step's products are
// one wgmma group; the next step's fragments are read and split while it
// runs (two fragment buffers, a wait that leaves one group pending), so
// the warpgroup drains once a tile.
__device__ __forceinline__ void tile_product(const uint8_t* tile,
                                             uint32_t b_hi, uint32_t b_lo,
                                             int r0, int t,
                                             float (&p)[2][32],
                                             float (&acc)[2][32]) {
  uint32_t ah[2][2][4], al[2][2][4];              // [buffer][mt][4]
  load_split(tile, 0, r0, t, ah[0], al[0]);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int cur = kk & 1;
    fence_regs(p[0]);
    fence_regs(p[1]);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma3(p[mt], ah[cur][mt], al[cur][mt], b_hi + 32 * kk, b_lo + 32 * kk,
           kk == 0);
    wgmma_commit();
    if (kk + 1 < BK / 8) {
      wgmma_wait<1>();                            // step kk - 1 done
      fence_frags(ah[cur ^ 1]);
      fence_frags(al[cur ^ 1]);
      load_split(tile, kk + 1, r0, t, ah[cur ^ 1], al[cur ^ 1]);
    }
  }
  wgmma_wait<0>();
  fence_regs(p[0]);
  fence_regs(p[1]);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    fence_frags(ah[b]);
    fence_frags(al[b]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] += p[mt][i];
}

// HW (this thread's fragment of the [256][64] fp32 tile) leaves the
// registers as HW^T [64][256] tf32 hi and lo at sm and sm + HWT, in boxes
// of 32 rows of HW (K-major for phase 2's B operand); fenced for the async
// proxy. The caller brackets it with barriers of the consumers.
__device__ __forceinline__ void store_hwt(uint8_t* sm, const float (&an)[2][32],
                                          int r0, int t) {
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
}

// The consumers' epilogue (256 threads): the output tile (this thread's
// fragment `as`) goes to shared memory at sm ([256][OT] fp32, over ring 1,
// which no one reads any more), then each thread takes 4 columns of every
// 16th row: + b, act, * mask, one rounding to O, stored as whole rows. The
// thread's 16 mask values and 4 bias values are loaded first, so that their
// latency passes under the tile's trip through shared memory (loaded row
// by row after it, they took 7.4 us of a 41 us block).
template <typename O>
__device__ __forceinline__ void epilogue(uint8_t* sm, const float (&as)[2][32],
                                         int r0, int t, int n0, int c, int N,
                                         int Fout, int act,
                                         const O* __restrict__ bias,
                                         const float* __restrict__ mask,
                                         O* __restrict__ out) {
  constexpr int RPT = ROWS / 16;                  // rows a thread stores
  const int cid = threadIdx.x - 128;              // 0 .. 255
  const int q = cid % 16;                         // columns 4q .. 4q + 3
  const int n = n0 + 4 * q;
  float mk[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = cid / 16 + 16 * i;
    mk[i] = mask == nullptr ? 1.0f
                            : (r < N ? mask[(long long)c * N + r] : 0.0f);
  }
  float bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (bias != nullptr)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = n + j < Fout ? elem::to_f32(bias[n + j]) : 0.0f;
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
  const bool vec_o = (Fout & 3) == 0 && n + 3 < Fout &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = cid / 16 + 16 * i;
    if (r >= N) break;
    const float4 a4 = *reinterpret_cast<const float4*>(ot + r * OT + 4 * q);
    float v[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] += bb[j];
      if (act == ACT_RELU) v[j] = fmaxf(v[j], 0.0f);
      else if (act == ACT_ELU) v[j] = v[j] > 0.0f ? v[j] : expm1f(v[j]);
      v[j] *= mk[i];
    }
    elem::store4(out + ((long long)c * N + r) * Fout + n, Fout - n, vec_o,
                 v);
  }
}

// Grid: (column tiles, C). The weights come split: tm_wn / tm_ws map
// [2][Fout][Fin] (W^T's tf32 hi, then lo, made once a weight by the
// wrapper), so the producer's one thread loads them by TMA like H, and no
// thread splits them.
template <bool NEIGH, bool SELF>
__global__ void __launch_bounds__(THREADS, 1) fused_tf32x3_kernel(
    const __grid_constant__ CUtensorMap tm_h,
    const __grid_constant__ CUtensorMap tm_a,
    const __grid_constant__ CUtensorMap tm_wn,
    const __grid_constant__ CUtensorMap tm_ws,
    const float* __restrict__ bias, const float* __restrict__ mask,
    float* __restrict__ out, int N, int Fin, int Fout, int act) {
  using L = Layout<NEIGH, SELF>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t bar = s0 + L::BARS;
  auto full1 = [&](int s) { return bar + 8 * s; };
  auto empty1 = [&](int s) { return bar + 8 * (STAGES + s); };
  auto full_a = [&](int s) { return bar + 8 * (2 * STAGES + s); };
  auto empty_a = [&](int s) { return bar + 8 * (2 * STAGES + 2 + s); };
  const int n0 = blockIdx.x * BN;
  const int c = blockIdx.y;
  const int kt1 = (Fin + BK - 1) / BK;
  const int kt2 = NEIGH ? (N + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full1(s), 1);
      mbar_init(empty1(s), WARPS);                // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                        // producer warpgroup
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      auto load1 = [&](int kt) {                  // one stage of ring 1
        const int s = kt % STAGES;
        const uint32_t st = s0 + s * L::STAGE1;
        mbar_expect_tx(full1(s), L::STAGE1);
        tma_load_3d(st, &tm_h, full1(s), BK * kt, 0, c);
        uint32_t w = st + TILE_A;
        if (NEIGH) {
          tma_load_3d(w, &tm_wn, full1(s), BK * kt, n0, 0);
          tma_load_3d(w + TILE_W, &tm_wn, full1(s), BK * kt, n0, 1);
          w += 2 * TILE_W;
        }
        if (SELF) {
          tma_load_3d(w, &tm_ws, full1(s), BK * kt, n0, 0);
          tma_load_3d(w + TILE_W, &tm_ws, full1(s), BK * kt, n0, 1);
        }
      };
      auto load_a = [&](int j) {                  // one box of A[c]
        const int s = j & 1;
        mbar_expect_tx(full_a(s), TILE_A);
        tma_load_3d(s0 + L::RING2 + s * TILE_A, &tm_a, full_a(s), BK * j,
                    0, c);
      };
      for (int kt = 0; kt < STAGES && kt < kt1; ++kt) load1(kt);
      if (!L::OVER)
        for (int j = 0; j < 2 && j < kt2; ++j) load_a(j);
      for (int kt = STAGES; kt < kt1; ++kt) {
        mbar_wait(empty1(kt % STAGES), (kt / STAGES - 1) & 1);
        load1(kt);
      }
      if (L::OVER && kt2 > 0) {
        // ring 2 lies over ring 1's last stage: wait until the consumers
        // have released that stage's last k-tile of phase 1
        const int uses = kt1 / STAGES;
        if (uses > 0) mbar_wait(empty1(STAGES - 1), (uses - 1) & 1);
        for (int j = 0; j < 2 && j < kt2; ++j) load_a(j);
      }
      for (int j = 2; j < kt2; ++j) {
        mbar_wait(empty_a(j & 1), ((j >> 1) - 1) & 1);
        load_a(j);
      }
    }
    return;
  }

  // consumer warpgroup cw owns rows 128 cw .. + 127: this thread's rows are
  // r0 + 64 mt and + 8, its columns 8 i + 2 t + {0, 1} of the tile
  regs_alloc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int r0 = 128 * cw + 16 * (tid / 32) + (tid % 32) / 4;
  const bool lead = (tid & 31) == 0;              // arrives for its warp
  float an[2][32], as[2][32], p[2][32];           // HW, the output, a tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) an[mt][i] = as[mt][i] = 0.0f;

  for (int kt = 0; kt < kt1; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full1(s), (kt / STAGES) & 1);
    const uint8_t* tile = sm + s * L::STAGE1;
    uint32_t w = s0 + s * L::STAGE1 + TILE_A;
    if (NEIGH) {
      tile_product(tile, w, w + TILE_W, r0, t, p, an);
      w += 2 * TILE_W;
    }
    if (SELF) tile_product(tile, w, w + TILE_W, r0, t, p, as);
    if (lead) mbar_arrive(empty1(s));             // release the stage
  }

  if (NEIGH) {
    // HW leaves the registers as HW^T [64][256] tf32 hi and lo, in boxes
    // of 32 rows of HW (K-major for phase 2's B), over ring 1
    bar_sync(1, 256);                             // ring 1 read by both
    store_hwt(sm, an, r0, t);
    bar_sync(1, 256);                             // HW^T whole

    for (int j = 0; j < kt2; ++j) {
      const int s = j & 1;
      mbar_wait(full_a(s), (j >> 1) & 1);
      tile_product(sm + L::RING2 + s * TILE_A, s0 + j * TILE_W,
                   s0 + HWT + j * TILE_W, r0, t, p, as);
      if (lead) mbar_arrive(empty_a(s));
    }
  }

  // epilogue: the tile goes through shared memory (ring 1, read by no one
  // any more), so that it leaves as whole 256-byte rows
  bar_sync(1, 256);
  epilogue(sm, as, r0, t, n0, c, N, Fout, act, bias, mask, out);
}

template <bool NEIGH, bool SELF>
int launch(const float* adj, const float* h, const float* wn, const float* ws,
           const float* b, const float* mask, float* out, int C, int N,
           int Fin, int Fout, int act, cudaStream_t stream) {
  using L = Layout<NEIGH, SELF>;
  // the weights' maps are made once a split weight (this thread's cache)
  static thread_local MapCache wmaps;
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const float* w_any = NEIGH ? wn : ws;
  CUtensorMap mh, ma, mwn, mws;
  int err = make_map_3d(&mh, F32, 4, h, Fin, N, C, BK, ROWS);
  if (!err)
    err = make_map_3d(&ma, F32, 4, NEIGH ? adj : h, NEIGH ? N : Fin, N, C,
                      BK, ROWS);
  if (!err)
    err = make_map_3d_cached(wmaps, &mwn, F32, 4, w_any, Fin, Fout, 2, BK,
                             BN);
  if (!err)
    err = make_map_3d_cached(wmaps, &mws, F32, 4, SELF ? ws : w_any, Fin,
                             Fout, 2, BK, BN);
  if (err) return err;
  auto kernel = fused_tf32x3_kernel<NEIGH, SELF>;
  static std::atomic<unsigned long long> limit_set{0};
  err = smem_limit_once(reinterpret_cast<const void*>(kernel), L::SMEM,
                        limit_set);
  if (err) return err;
  const dim3 grid((Fout + BN - 1) / BN, C);
  kernel<<<grid, THREADS, L::SMEM, stream>>>(mh, ma, mwn, mws, b, mask, out,
                                             N, Fin, Fout, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc


// -- the wgmma_bf16 kernel ---------------------------------------------------

namespace bt {

using namespace hopper;
using tc::HWT;
using tc::ROWS;
using tc::THREADS;
using tc::TILE_A;

constexpr int BK = 64;                       // k per stage: one 128-byte row
constexpr int STAGES = 3;                    // ring 1's depth
constexpr int TILE_H = ROWS * BK * 2;        // a box of H: 32 KB
constexpr int TILE_W = BK * tc::BN * 2;      // a k-tile of Wn or Ws: 8 KB
constexpr int STAGE1 = TILE_H + 2 * TILE_W;  // H box, Wn and Ws tiles
constexpr int RING2 = STAGES * STAGE1;       // offset of the A[c] ring
constexpr int BARS = RING2 + 2 * TILE_A;     // offset of the mbarriers
constexpr int NBARS = 2 * STAGES + 4;
constexpr int SMEM = 1024 + BARS + 8 * NBARS;
constexpr int WARPS = 8;                     // consumer warps: one arrive each
static_assert(2 * HWT <= RING2, "HW^T must fit in ring 1");
static_assert(ROWS * tc::OT * 4 <= RING2, "the output tile must fit in ring 1");
static_assert(SMEM <= 232448, "more shared memory than a block has");

// acc += one k-tile's product: this warpgroup's 128 rows (from row0) of
// the [256][64] bf16 H box at h_tile times the [64][64] bf16 W tile at
// w_tile (MN-major: the transpose bit). The tensor cores sum the tile's
// products (exact in fp32) into the partial p from zero; p is then added
// to acc on the CUDA cores, rounded to nearest, so their truncating sums
// run over one tile, never over the whole of Fin.
__device__ __forceinline__ void tile_product(uint32_t h_tile, uint32_t w_tile,
                                             int row0, float (&p)[2][32],
                                             float (&acc)[2][32]) {
  fence_regs(p[0]);
  fence_regs(p[1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      wgmma_ss_m64n64k16_tb(
          p[mt],
          desc_sw128(h_tile + (row0 + 64 * mt) * 128 + 32 * kk, 16, 1024),
          desc_sw128(w_tile + kk * 16 * 128, TILE_W, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(p[0]);
  fence_regs(p[1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] += p[mt][i];
}

template <bool NEIGH, bool SELF>
__global__ void __launch_bounds__(THREADS, 1) fused_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_h,
    const __grid_constant__ CUtensorMap tm_wn,
    const __grid_constant__ CUtensorMap tm_ws,
    const __grid_constant__ CUtensorMap tm_a,
    const elem::bf16* __restrict__ bias, const float* __restrict__ mask,
    elem::bf16* __restrict__ out, int N, int Fin, int Fout, int act) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t bar = s0 + BARS;
  auto full1 = [&](int s) { return bar + 8 * s; };
  auto empty1 = [&](int s) { return bar + 8 * (STAGES + s); };
  auto full_a = [&](int s) { return bar + 8 * (2 * STAGES + s); };
  auto empty_a = [&](int s) { return bar + 8 * (2 * STAGES + 2 + s); };
  const int n0 = blockIdx.x * tc::BN;
  const int c = blockIdx.y;
  const int kt1 = (Fin + BK - 1) / BK;
  const int kt2 = NEIGH ? (N + tc::BK - 1) / tc::BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full1(s), 1);
      mbar_init(empty1(s), WARPS);                // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                        // producer warpgroup
    regs_dealloc<40>();
    if (threadIdx.x != 0) return;
    auto load1 = [&](int kt) {                    // one stage of ring 1
      const int s = kt % STAGES;
      const uint32_t st = s0 + s * STAGE1;
      mbar_expect_tx(full1(s), TILE_H + (NEIGH + SELF) * TILE_W);
      tma_load_3d(st, &tm_h, full1(s), BK * kt, 0, c);
      if (NEIGH) tma_load_3d(st + TILE_H, &tm_wn, full1(s), n0, BK * kt, 0);
      if (SELF)
        tma_load_3d(st + TILE_H + TILE_W, &tm_ws, full1(s), n0, BK * kt, 0);
    };
    auto load_a = [&](int j) {                    // one box of A[c]
      const int s = j & 1;
      mbar_expect_tx(full_a(s), TILE_A);
      tma_load_3d(s0 + RING2 + s * TILE_A, &tm_a, full_a(s), tc::BK * j, 0,
                  c);
    };
    for (int kt = 0; kt < STAGES && kt < kt1; ++kt) load1(kt);
    for (int j = 0; j < 2 && j < kt2; ++j) load_a(j);
    for (int kt = STAGES; kt < kt1; ++kt) {
      mbar_wait(empty1(kt % STAGES), (kt / STAGES - 1) & 1);
      load1(kt);
    }
    for (int j = 2; j < kt2; ++j) {
      mbar_wait(empty_a(j & 1), ((j >> 1) - 1) & 1);
      load_a(j);
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
  const bool lead = (tid & 31) == 0;              // arrives for its warp
  float an[2][32], as[2][32], p[2][32];           // HW, the output, a tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) an[mt][i] = as[mt][i] = 0.0f;

  // phase 1: HW = H . Wn and S = H . Ws, bf16 products on the tensor cores
  for (int kt = 0; kt < kt1; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full1(s), (kt / STAGES) & 1);
    const uint32_t st = s0 + s * STAGE1;
    if (NEIGH) tile_product(st, st + TILE_H, 128 * cw, p, an);
    if (SELF) tile_product(st, st + TILE_H + TILE_W, 128 * cw, p, as);
    if (lead) mbar_arrive(empty1(s));             // release the stage
  }

  if (NEIGH) {
    // phase 2: S += A[c] . HW in three tf32 products, as the tf32x3 kernel
    bar_sync(1, 256);                             // ring 1 read by both
    tc::store_hwt(sm, an, r0, t);
    bar_sync(1, 256);                             // HW^T whole
    for (int j = 0; j < kt2; ++j) {
      const int s = j & 1;
      mbar_wait(full_a(s), (j >> 1) & 1);
      tc::tile_product(sm + RING2 + s * TILE_A, s0 + j * tc::TILE_W,
                       s0 + HWT + j * tc::TILE_W, r0, t, p, as);
      if (lead) mbar_arrive(empty_a(s));
    }
  }

  bar_sync(1, 256);
  tc::epilogue(sm, as, r0, t, n0, c, N, Fout, act, bias, mask, out);
}

template <bool NEIGH, bool SELF>
int launch(const float* adj, const elem::bf16* h, const elem::bf16* wn,
           const elem::bf16* ws, const elem::bf16* b, const float* mask,
           elem::bf16* out, int C, int N, int Fin, int Fout, int act,
           cudaStream_t stream) {
  CUtensorMap mh, mwn, mws, ma;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const elem::bf16* w_any = NEIGH ? wn : ws;
  int err = make_map_3d(&mh, BF16, 2, h, Fin, N, C, BK, ROWS);
  if (!err)
    err = make_map_3d(&mwn, BF16, 2, w_any, Fout, Fin, 1, tc::BN, BK);
  if (!err)
    err = make_map_3d(&mws, BF16, 2, SELF ? ws : w_any, Fout, Fin, 1, tc::BN,
                      BK);
  if (!err)
    err = make_map_3d(&ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      NEIGH ? static_cast<const void*>(adj)
                            : static_cast<const void*>(h),
                      NEIGH ? N : Fin / 2, N, C, tc::BK, ROWS);
  if (err) return err;
  auto kernel = fused_bf16_kernel<NEIGH, SELF>;
  static std::atomic<unsigned long long> limit_set{0};
  err = smem_limit_once(reinterpret_cast<const void*>(kernel), SMEM,
                        limit_set);
  if (err) return err;
  const dim3 grid((Fout + tc::BN - 1) / tc::BN, C);
  kernel<<<grid, THREADS, SMEM, stream>>>(mh, mwn, mws, ma, b, mask, out, N,
                                          Fin, Fout, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bt

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

// Shared memory of the largest tf32x3 block (the wrapper's table checks
// it).
int fused_tf32x3_smem_bytes() {
  constexpr int a = tc::Layout<true, false>::SMEM;
  constexpr int b = tc::Layout<true, true>::SMEM;
  constexpr int c = tc::Layout<false, true>::SMEM;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The tf32x3 kernel: N <= 256; Fin % 4 == 0 and h 16-byte aligned; with
// w_neigh also N % 4 == 0 and adj 16-byte aligned. Here w_neigh and w_self
// are the weights split: [2][Fout][Fin], W^T rounded to tf32 (hi), then
// W^T - hi rounded to tf32 (lo), as cvt.rna.tf32.f32 gives them.
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

// Shared memory of one wgmma_bf16 block.
int fused_bf16_smem_bytes() { return bt::SMEM; }

// The wgmma_bf16 kernel: h, the weights, b and out bf16, adj and mask fp32;
// N <= 256; Fin and Fout multiples of 8; h and both weights 16-byte
// aligned; with w_neigh also N % 4 == 0 and adj 16-byte aligned.
int fused_gnn_layer_wgmma_bf16(const float* adj, const elem::bf16* h,
                               const elem::bf16* w_neigh,
                               const elem::bf16* w_self, const elem::bf16* b,
                               const float* mask, elem::bf16* out, int C,
                               int N, int Fin, int Fout, int act,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > tc::ROWS) return static_cast<int>(cudaErrorInvalidValue);
  if (w_neigh != nullptr && w_self != nullptr)
    return bt::launch<true, true>(adj, h, w_neigh, w_self, b, mask, out, C,
                                  N, Fin, Fout, act, s);
  if (w_neigh != nullptr)
    return bt::launch<true, false>(adj, h, w_neigh, w_self, b, mask, out, C,
                                   N, Fin, Fout, act, s);
  return bt::launch<false, true>(adj, h, w_neigh, w_self, b, mask, out, C, N,
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
