// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/
// flash_attention.py, _kernel). For each (batch, head h, query row r):
//
//     s[c]  = (q[r] . k[c]) * scale              scale = 1/sqrt(D), fp32 sums
//     s[c]  = -1e30 where causal and c > r       (top-left aligned)
//     online softmax over key tiles: m, l running max and sum
//     out[r] = (sum_c exp(s[c] - m) v[c]) / max(l, 1e-20)   in q's type
//
// q [B,H,Sq,D], k [B,Kh,Sk,D], v [B,Kh,Sk,Dv], out [B,H,Sq,Dv] with
// H % Kh == 0: query head h reads KV head h / (H/Kh) (grouped-query
// attention, read in place, no copies).
//
// Two kernels; the caller picks one by dtype, D and v's width Dv before
// launch (kernels/flash_attention.py, flash_variant):
//
// wgmma (bf16, (D, Dv) in {(64, 64), (128, 128), (192, 128)}): bound by
// operations. (64, 64), whisper's width, and (128, 128), phi3's, pixtral's
// and Jamba's, have kernels of their own (namespaces w64 and w128, below:
// persistent grids, Q.K^T overlapped with the softmax; at 128 the two
// consumers also take turns at the tensor cores). (192, 128), MLA
// prefill's core, runs the template here, written for any width: Q.K^T
// runs D/16 k-steps over D/64 swizzled 64-column boxes of Q and K, P.V
// runs over Dv/64 boxes of V into a [64, Dv] accumulator, and the output
// is Dv wide (q and k nope + rope, v at its own width: no padded third of
// P.V). It keeps S and O at 64 fp32 a thread and needs 214,072 bytes of
// shared memory (Q 48 KiB, a stage 48 KiB of K and 32 KiB of V).
// One block of 384 threads per (b*h, 128 query rows), the heaviest causal
// tiles launched first. Warpgroup 0 is the producer: one thread issues TMA
// loads (128-byte swizzle) of Q once and of 128-row K and V tiles into a
// ring of two stages, each with full barriers for K and V and an empty
// barrier the consumers release; it gives its registers away (setmaxnreg).
// Warpgroups 1 and 2 each own 64 query rows: S = Q.K^T by wgmma
// m64n128k16 from shared memory (fp32 accumulators), the online softmax on
// the accumulator fragment in registers (row max over the 4 lanes of a row
// by shuffles, exp2 with scale*log2(e) folded in, the row sums kept per
// lane and reduced once at the end), P rounded to bf16 in registers and
// fed as wgmma's A operand for O += P.V (V read MN-major, transpose bit
// set), O in registers for the block's life. Tiles wholly above the
// diagonal are never loaded; only the diagonal and ragged tiles are masked
// (TMA fills rows past Sq or Sk with zeros), so any Sq and Sk work.
// Rounding P to bf16 before P.V is what the reference's model paths do.
//
// CUDA cores (float32 at any D <= 256, bf16 at other widths; Dv = D, the
// wrapper zero-pads a narrower v): every product and sum in fp32, as in
// the TPU kernel, P kept in fp32. One block of 256
// threads per (b*h, 64 query rows); the query tile sits in shared memory,
// transposed; key and value tiles of 64 rows are staged through shared
// memory one at a time (fp32, zero-padded to a multiple of 64 columns).
// Thread (g, h) of a 16 x 16 grid owns query rows 4g..4g+3 and computes
// the 4 x 4 score patch of key columns 4h..4h+3 from float4 loads, keeps m
// and l in registers (shuffles across the 16 threads of a row group),
// writes its exp'd patch transposed over the key tile it no longer needs,
// and accumulates out[4 rows][64b+4h..+3] for each 64-column slab b. It
// runs at the CUDA cores' fp32 rate (67 TFLOP/s), so at the serving shape
// it would be bound at 10.3 ms.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int LDT = 68;           // row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max and sum over the 16 threads of one row group (lanes 0-15, 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Shared memory (floats): Qt [DP][LDT], Kt [DP][LDT] (its first BK rows
// double as Pt [BK][LDT] once the scores are taken), Vs [BK][DP].
template <int NB>
constexpr int smem_floats() {
  return 64 * NB * LDT * 2 + BK * 64 * NB;
}

template <typename T, int NB>
__global__ void __launch_bounds__(THREADS, NB <= 2 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Kh, int Sq, int Sk, int D, float scale,
                       int causal) {
  constexpr int DP = 64 * NB;           // D padded to 64-column slabs
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + DP * LDT;
  float* Pt = Kt;
  float* Vs = Kt + DP * LDT;

  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int g = tid / 16;               // rows 4g..4g+3
  const int h = tid % 16;               // columns 4h..4h+3 (of each slab)
  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + (long long)kvh * Sk * D;
  const T* vb = v + (long long)kvh * Sk * D;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    Qt[d * LDT + r] = (q0 + r < Sq && d < D)
                          ? to_f(qb[(long long)(q0 + r) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NB; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                    // Pt and Vs of the last tile read
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int c = i / DP, d = i % DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + c < Sk && d < D) {
        const long long off = (long long)(k0 + c) * D + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      Kt[d * LDT + c] = kx;
      Vs[c * DP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * LDT + 4 * g]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * LDT + 4 * h]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * g + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * h + j;
        float x = s[i][j] * scale;
        if (causal && col > row) x = NEG_INF;
        if (col >= Sk) x = -INFINITY;   // ragged tile: p = 0 exactly
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      const float alpha = expf(m[i] - m_new);
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ls += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(ls);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NB; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                    // every thread is done with Kt
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(4 * h + j) * LDT + 4 * g]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * LDT + 4 * g]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 va =
            *reinterpret_cast<const float4*>(&Vs[c * DP + 64 * b + 4 * h]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * b + 0] = fmaf(pv[i], va.x, acc[i][4 * b + 0]);
          acc[i][4 * b + 1] = fmaf(pv[i], va.y, acc[i][4 * b + 1]);
          acc[i][4 * b + 2] = fmaf(pv[i], va.z, acc[i][4 * b + 2]);
          acc[i][4 * b + 3] = fmaf(pv[i], va.w, acc[i][4 * b + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * g + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = out + ((long long)bh * Sq + row) * D;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 64 * b + 4 * h + j;
        if (col < D) store(&orow[col], acc[i][4 * b + j] / den);
      }
  }
}

template <typename T, int NB>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Kh, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const int smem = smem_floats<NB>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, NB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Kh, Sq, Sk, D,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Kh, int Sq, int Sk, int D, float scale, int causal,
             cudaStream_t s) {
#define FLASH_LAUNCH(NB) \
  launch<T, NB>(q, k, v, out, B, H, Kh, Sq, Sk, D, scale, causal, s)
  switch ((D + 63) / 64) {
    case 1: return FLASH_LAUNCH(1);
    case 2: return FLASH_LAUNCH(2);
    case 3: return FLASH_LAUNCH(3);
    case 4: return FLASH_LAUNCH(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH
}


// -- the wgmma template (bf16; (D, Dv) = (192, 128)) --------------------------

namespace wg {

using namespace hopper;

constexpr int BQ = 128;           // query rows per block (2 x 64)
constexpr int BK = 128;           // key rows per tile
constexpr int STAGES = 2;         // K/V ring depth
constexpr int THREADS = 384;      // producer + 2 consumer warpgroups
constexpr int BOX_Q = BQ * 128;   // bytes of one 64-column TMA box of Q
constexpr int BOX_KV = BK * 128;  // ... of K or V
constexpr float LOG2E = 1.4426950408889634f;

// Q is DK wide, K DK and V DV wide per stage.
template <int DK, int DV>
struct Smem {
  static constexpr int Q = BQ * DK * 2;
  static constexpr int K = BK * DK * 2;
  static constexpr int V = BK * DV * 2;
  // 1024 bytes of slack to align the tiles; 3 * STAGES + 1 barriers
  static constexpr int BYTES =
      1024 + Q + STAGES * (K + V) + 8 * (3 * STAGES + 1);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x in one instruction (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two neighbouring outputs, rounded to the nearest bf16.
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int DV>
__device__ __forceinline__ void pv_mma(float (&o)[DV / 2],
                                       const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void pv_mma<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_rs_m64n128k16(o, a, b);
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int H, int Kh, int Sq,
                   int Sk, float scale_log2, int causal) {
  using S = Smem<DK, DV>;
  static_assert(S::BYTES <= 232448, "more shared memory than a block has");
  constexpr int QK_BOXES = DK / 64;
  constexpr int V_BOXES = DV / 64;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sK = sQ + S::Q;                    // + stage * S::K
  const uint32_t sV = sK + STAGES * S::K;           // + stage * S::V
  const uint32_t bar = sV + STAGES * S::V;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2);                     // one arrive per consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                        // producer warpgroup
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, S::Q);
      for (int b = 0; b < QK_BOXES; ++b)
        tma_load_3d(sQ + b * BOX_Q, &tm_q, q_full, 64 * b, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), (j / STAGES - 1) & 1);
        mbar_expect_tx(k_full(s), S::K);
        for (int b = 0; b < QK_BOXES; ++b)
          tma_load_3d(sK + s * S::K + b * BOX_KV, &tm_k, k_full(s), 64 * b,
                      j * BK, kvh);
        mbar_expect_tx(v_full(s), S::V);
        for (int b = 0; b < V_BOXES; ++b)
          tma_load_3d(sV + s * S::V + b * BOX_KV, &tm_v, v_full(s), 64 * b,
                      j * BK, kvh);
      }
    }
    return;
  }

  // consumer warpgroup cw owns query rows q0 + 64 cw .. + 63; this thread
  // holds rows r0 and r0 + 8, key (or output) columns 8 j + 2 t + {0, 1}
  regs_alloc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int r0 = q0 + 64 * cw + 16 * (tid / 32) + (tid % 32) / 4;
  const int r1 = r0 + 8;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;           // running max (raw q.k)
  float l0 = 0.0f, l1 = 0.0f;                     // this lane's part of l
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t phase = (j / STAGES) & 1;
    const int k0 = j * BK;
    float sc[BK / 2];
    mbar_wait(k_full(s), phase);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;   // 16 columns = 32 bytes
      const uint64_t da = desc_sw128(
          sQ + (kk / 4) * BOX_Q + cw * 64 * 128 + col, 16, 1024);
      const uint64_t db =
          desc_sw128(sK + s * S::K + (kk / 4) * BOX_KV + col, 16, 1024);
      wgmma_ss_m64n128k16(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if ((causal && k0 + BK - 1 > q0 + 64 * cw) || k0 + BK > Sk) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * i + 2 * t + e;
          if ((causal && c > r0) || c >= Sk) sc[4 * i + e] = -INFINITY;
          if ((causal && c > r1) || c >= Sk) sc[4 * i + 2 + e] = -INFINITY;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // exp(x*scale - m*scale) = exp2(x*c - m*c), c = scale*log2(e)
    const float ms0 = mx0 == -INFINITY ? 0.0f : mx0 * scale_log2;
    const float ms1 = mx1 == -INFINITY ? 0.0f : mx1 * scale_log2;
    const float alpha0 = exp2_fast(m0 * scale_log2 - ms0);
    const float alpha1 = exp2_fast(m1 * scale_log2 - ms1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * i + e] = exp2_fast(fmaf(sc[4 * i + e], scale_log2, -ms0));
        sc[4 * i + 2 + e] =
            exp2_fast(fmaf(sc[4 * i + 2 + e], scale_log2, -ms1));
        rs0 += sc[4 * i + e];
        rs1 += sc[4 * i + 2 + e];
      }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
    // P in bf16 as wgmma's A fragment: k-step kk takes p[4 kk .. 4 kk + 3]
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    mbar_wait(v_full(s), phase);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      pv_mma<DV>(o, a,
                 desc_sw128(sV + s * S::V + kk * 16 * 128, BOX_KV, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (tid == 0) mbar_arrive(empty(s));          // release the stage
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* ob = out + (long long)bh * Sq * DV;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (r0 < Sq)
      store_bf16x2(&ob[(long long)r0 * DV + c], o[4 * i] / den0,
                   o[4 * i + 1] / den0);
    if (r1 < Sq)
      store_bf16x2(&ob[(long long)r1 * DV + c], o[4 * i + 2] / den1,
                   o[4 * i + 3] / den1);
  }
}

// [heads, rows, D] bf16, boxes of 64 columns x `box_rows` rows x 1 head,
// 128-byte swizzle; rows past the end read as zeros. Returns 0 or an error.
// [heads, rows, D] bf16 through the host thread's map cache.
int make_map_cached(CUtensorMap* map, const void* ptr, int heads, int rows,
                    int D, int box_rows) {
  thread_local MapCache cache;
  return make_map_3d_cached(cache, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            ptr, D, rows, heads, 64, box_rows);
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Kh, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map_cached(&mq, q, B * H, Sq, DK, BQ);
  if (!err) err = make_map_cached(&mk, k, B * Kh, Sk, DK, BK);
  if (!err) err = make_map_cached(&mv, v, B * Kh, Sk, DV, BK);
  if (err) return err;
  auto kernel = flash_wgmma_kernel<DK, DV>;
  constexpr int smem = Smem<DK, DV>::BYTES;
  static std::atomic<unsigned long long> limit_set{0};
  err = smem_limit_once(reinterpret_cast<const void*>(kernel), smem,
                        limit_set);
  if (err) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, Kh, Sq, Sk,
      scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// -- the wgmma kernel at (D, Dv) = (64, 64): whisper's shapes ----------------
//
// At D=64 the scores' exp2 pass is about twice D=128's share of a tile, so
// this instance is designed on its own:
// - three consumer warpgroups (192 query rows an item) at 160 registers and
//   a producer at 32: 512 threads, one block an SM;
// - inside a warpgroup, Q.K_j^T is issued before the softmax of tile j - 1
//   ends: tile j's scores are computed while P_{j-1}.V_{j-1} runs, and O is
//   rescaled after it (O = (O + P_{j-1} V_{j-1}) alpha_j; the D=128
//   instances rescale first), so S (64 fp32), P (32) and O (32) fit 160;
// - a persistent grid (one block an SM) walks the items (b*h, 192 query
//   rows), the heaviest causal ones first; Q is double-buffered, so the
//   producer loads an item's Q and K/V tiles while the consumers finish the
//   previous one, and the four-stage K/V ring runs on across items;
// - a warpgroup computes only the tiles its own rows need (causal) and
//   none when its rows lie past Sq; for the others it waits and releases.
// Every warp arrives on the empty barriers itself, after its own wait.

namespace w64 {

using namespace hopper;
using wg::exp2_fast;
using wg::pack_bf16;
using wg::store_bf16x2;

constexpr int D = 64;
constexpr int CONSUMERS = 3;
constexpr int BQ = 64 * CONSUMERS;             // query rows an item
constexpr int BK = 128;                        // key rows a tile
constexpr int STAGES = 4;                      // K/V ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int WARPS = 4 * CONSUMERS;           // consumer warps
constexpr int Q_BYTES = BQ * D * 2;            // one Q buffer
constexpr int KV_BYTES = BK * D * 2;           // one K or V tile
constexpr int NBARS = 4 + 3 * STAGES;
constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * NBARS;
static_assert(SMEM <= 232448, "more shared memory than a block has");

struct Item {
  int bh, q0, n_tiles;
};

// Item i: query tile n_qb - 1 - i / BH (the last, heaviest when causal,
// first) of head i % BH; its K/V tiles run to its last row's diagonal.
__device__ __forceinline__ Item item_of(int i, int BH, int n_qb, int Sq,
                                        int Sk, int causal) {
  Item w;
  w.bh = i % BH;
  w.q0 = (n_qb - 1 - i / BH) * BQ;
  const int q_last = min(w.q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  w.n_tiles = (k_end + BK - 1) / BK;
  return w;
}

// S = Q.K^T for this warpgroup's 64 rows (Q at sq) and a 128-row K tile.
__device__ __forceinline__ void qk(float (&sc)[64], uint32_t sq, uint32_t sk) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n128k16(sc, desc_sw128(sq + 32 * kk, 16, 1024),
                        desc_sw128(sk + 32 * kk, 16, 1024), kk > 0);
  wgmma_commit();
}

// O += P.V for a 128-row V tile (MN-major) with P in registers.
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&p)[32],
                                   uint32_t sv) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs_m64n64k16(o, a, desc_sw128(sv + kk * 16 * 128, KV_BYTES, 1024));
  }
  wgmma_commit();
}

// The online softmax of one tile of scores (the D=128 instances'
// arithmetic): masks (causal, past Sk), moves the running max m, replaces
// sc by exp2(s c - m c), and returns alpha (the old sums' factor) and this
// thread's part of the tile's row sums.
__device__ __forceinline__ void softmax(float (&sc)[64], int k0, int r0,
                                        int r_first, int Sk, int causal,
                                        float scale_log2, float (&m)[2],
                                        float (&alpha)[2], float (&rs)[2],
                                        int t) {
  const int r1 = r0 + 8;
  if ((causal && k0 + BK - 1 > r_first) || k0 + BK > Sk) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * i + 2 * t + e;
        if ((causal && c > r0) || c >= Sk) sc[4 * i + e] = -INFINITY;
        if ((causal && c > r1) || c >= Sk) sc[4 * i + 2 + e] = -INFINITY;
      }
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float ms0 = mx0 == -INFINITY ? 0.0f : mx0 * scale_log2;
  const float ms1 = mx1 == -INFINITY ? 0.0f : mx1 * scale_log2;
  alpha[0] = exp2_fast(m[0] * scale_log2 - ms0);
  alpha[1] = exp2_fast(m[1] * scale_log2 - ms1);
  m[0] = mx0;
  m[1] = mx1;
  rs[0] = rs[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * i + e] = exp2_fast(fmaf(sc[4 * i + e], scale_log2, -ms0));
      sc[4 * i + 2 + e] = exp2_fast(fmaf(sc[4 * i + 2 + e], scale_log2, -ms1));
      rs[0] += sc[4 * i + e];
      rs[1] += sc[4 * i + 2 + e];
    }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma64_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ out, int H, int Kh, int Sq,
                     int Sk, float scale_log2, int causal, int n_items,
                     int n_qb) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;   // + buffer * Q
  const uint32_t sK = sQ + 2 * Q_BYTES;                   // + stage * KV
  const uint32_t sV = sK + STAGES * KV_BYTES;             // + stage * KV
  const uint32_t bar = sV + STAGES * KV_BYTES;
  auto q_full = [&](int b) { return bar + 8 * b; };
  auto q_empty = [&](int b) { return bar + 8 * (2 + b); };
  auto k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto v_full = [&](int s) { return bar + 8 * (4 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (4 + 2 * STAGES + s); };
  const int BH = n_items / n_qb;                  // B * H

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                        // producer warpgroup
    regs_dealloc<32>();
    if (threadIdx.x != 0) return;
    int g = 0;                                    // tiles loaded so far
    for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
      const Item w = item_of(i, BH, n_qb, Sq, Sk, causal);
      const int kvh = (w.bh / H) * Kh + (w.bh % H) / (H / Kh);
      const int b = it & 1;
      if (it >= 2) mbar_wait(q_empty(b), ((it >> 1) - 1) & 1);
      mbar_expect_tx(q_full(b), Q_BYTES);
      tma_load_3d(sQ + b * Q_BYTES, &tm_q, q_full(b), 0, w.q0, w.bh);
      for (int j = 0; j < w.n_tiles; ++j, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), (g / STAGES - 1) & 1);
        mbar_expect_tx(k_full(s), KV_BYTES);
        tma_load_3d(sK + s * KV_BYTES, &tm_k, k_full(s), 0, j * BK, kvh);
        mbar_expect_tx(v_full(s), KV_BYTES);
        tma_load_3d(sV + s * KV_BYTES, &tm_v, v_full(s), 0, j * BK, kvh);
      }
    }
    return;
  }

  // consumer warpgroup cw owns rows q0 + 64 cw .. + 63 of each item; this
  // thread holds rows r0 and r0 + 8, columns 8 j + 2 t + {0, 1}
  regs_alloc<160>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const bool lead = (tid & 31) == 0;              // arrives for its warp
  int g = 0;                                      // tiles consumed so far
  for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
    const Item w = item_of(i, BH, n_qb, Sq, Sk, causal);
    const int b = it & 1;
    const int r_first = w.q0 + 64 * cw;
    const int r0 = r_first + 16 * (tid / 32) + (tid % 32) / 4;
    const int r_last = min(r_first + 63, Sq - 1);
    // the tiles this warpgroup's rows need: none past Sq, to its last
    // row's diagonal when causal
    const int mine =
        r_first >= Sq ? 0
        : causal      ? min(w.n_tiles, (min(Sk, r_last + 1) + BK - 1) / BK)
                      : w.n_tiles;
    const uint32_t sq = sQ + b * Q_BYTES + cw * 64 * 128;
    mbar_wait(q_full(b), (it >> 1) & 1);

    float o[32], sc[64];
    uint32_t p[32];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float alpha[2], rs[2];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.0f;
    if (mine > 0) {
      int s = g % STAGES;
      mbar_wait(k_full(s), (g / STAGES) & 1);
      qk(sc, sq, sK + s * KV_BYTES);
      wgmma_wait<0>();
      fence_regs(sc);
      if (mine == 1 && lead) mbar_arrive(q_empty(b));
      softmax(sc, 0, r0, r_first, Sk, causal, scale_log2, m, alpha, rs, t);
      l[0] = rs[0];
      l[1] = rs[1];
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
      for (int j = 1; j < mine; ++j) {
        const int sp = g % STAGES;                // tile j - 1's stage
        s = (g + 1) % STAGES;
        mbar_wait(k_full(s), ((g + 1) / STAGES) & 1);
        qk(sc, sq, sK + s * KV_BYTES);
        mbar_wait(v_full(sp), (g / STAGES) & 1);
        pv(o, p, sV + sp * KV_BYTES);
        wgmma_wait<1>();                          // S_j done, PV in flight
        fence_regs(sc);
        if (j == mine - 1 && lead) mbar_arrive(q_empty(b));
        softmax(sc, j * BK, r0, r_first, Sk, causal, scale_log2, m, alpha, rs,
                t);
        wgmma_wait<0>();                          // P_{j-1} V_{j-1} done
        fence_regs(o);
        fence_regs(p);
        if (lead) mbar_arrive(empty(sp));         // release tile j - 1
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[4 * e] *= alpha[0];
          o[4 * e + 1] *= alpha[0];
          o[4 * e + 2] *= alpha[1];
          o[4 * e + 3] *= alpha[1];
        }
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int e = 0; e < 32; ++e)
          p[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
        ++g;
      }
      s = g % STAGES;
      mbar_wait(v_full(s), (g / STAGES) & 1);
      pv(o, p, sV + s * KV_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lead) mbar_arrive(empty(s));
      ++g;
    } else if (lead) {
      mbar_arrive(q_empty(b));
    }
    for (int j = mine; j < w.n_tiles; ++j, ++g) { // tiles past its rows
      const int s = g % STAGES;
      mbar_wait(k_full(s), (g / STAGES) & 1);
      mbar_wait(v_full(s), (g / STAGES) & 1);
      if (lead) mbar_arrive(empty(s));
    }
    if (mine == 0) continue;

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    const float inv0 = 1.0f / fmaxf(l[0], 1e-20f);
    const float inv1 = 1.0f / fmaxf(l[1], 1e-20f);
    __nv_bfloat16* ob = out + (long long)w.bh * Sq * D;
    const int r1 = r0 + 8;
#pragma unroll
    for (int e = 0; e < D / 8; ++e) {
      const int c = 8 * e + 2 * t;
      if (r0 < Sq)
        store_bf16x2(&ob[(long long)r0 * D + c], o[4 * e] * inv0,
                     o[4 * e + 1] * inv0);
      if (r1 < Sq)
        store_bf16x2(&ob[(long long)r1 * D + c], o[4 * e + 2] * inv1,
                     o[4 * e + 3] * inv1);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Kh, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = wg::make_map_cached(&mq, q, B * H, Sq, D, BQ);
  if (!err) err = wg::make_map_cached(&mk, k, B * Kh, Sk, D, BK);
  if (!err) err = wg::make_map_cached(&mv, v, B * Kh, Sk, D, BK);
  if (err) return err;
  static std::atomic<unsigned long long> limit_set{0};
  err = smem_limit_once(reinterpret_cast<const void*>(flash_wgmma64_kernel),
                        SMEM, limit_set);
  if (err) return err;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int n_qb = (Sq + BQ - 1) / BQ;
  const long long items = (long long)B * H * n_qb;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(items);
  const int grid = n_items < sms ? n_items : sms;
  flash_wgmma64_kernel<<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, Kh, Sq, Sk,
      scale * wg::LOG2E, causal, n_items, n_qb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace w64

// -- the wgmma kernel at (D, Dv) = (128, 128): phi3's, pixtral's and Jamba's
// prefill ---------------------------------------------------------------------
//
// Replaces src/repro/kernels/flash_attention.py:79 (flash_attention) at head
// width 128. Bound by operations: at phi3's prefill shape (B=1, H=40, 10 KV
// heads, S=8192, causal) 6.87e11 of them, 0.6948 ms at the tensor cores'
// 989 TFLOP/s (bf16). The template above (namespace wg), which (192, 128)
// runs, leaves the tensor cores idle three ways; this kernel answers each:
// 1. inside a warpgroup, the template waits for Q.K^T and for P.V in full
//    around the softmax. Here, as in w64, Q.K_j^T and P_{j-1}.V_{j-1} are
//    issued together, tile j's softmax runs while P.V is in flight, O is
//    rescaled after the add (O = (O + P_{j-1} V_{j-1}) alpha_j), and the
//    last tile's P.V goes at the end. S (64 fp32), O (64) and P (32 words)
//    a thread fit in 240 registers; a third consumer at 160 would not hold
//    them, so
// 2. the two consumer warpgroups (64 query rows each) take turns at the
//    tensor cores (ping-pong): a warpgroup issues its GEMMs only while it
//    holds a token, which it hands to the other by named barrier (bar.sync
//    on its own barrier, bar.arrive on the other's; barriers 1 and 2), so
//    one warpgroup's softmax runs under the other's GEMMs;
// 3. the template's block per (b*h, 128 query rows) pays its barrier
//    set-up, its Q load and its first tile's latency alone. Here a
//    persistent grid of min(items, SMs) blocks walks the items, heaviest
//    causal first, in a snake (round r gives item r * grid + c to block c
//    when r is even, to block grid - 1 - c when odd, so the causal work
//    that a plain stride leaves heavier on the first blocks evens out), b*h
//    fastest, so the query heads of one KV group run together and share
//    K/V in L2. Q is double-buffered and the two-stage K/V ring runs on
//    across items, K and V released apart (K once Q.K^T is done, V once
//    P.V is), so the producer loads the next item while the consumers
//    finish this one.
// Shared memory: two Q buffers (32 KiB each) and two stages of K and V
// (64 KiB a stage), 197,728 bytes; one Q buffer and three stages would need
// 230,512. Tiles wholly above the diagonal are never loaded; only diagonal
// and ragged tiles are masked (w64::softmax, the same arithmetic), so any
// Sq and Sk work. With BQ = BK and q0 a multiple of BK both warpgroups need
// every tile of an item, unless warpgroup 1's rows lie past Sq: it then
// computes nothing, and the item runs without turns.

namespace w128 {

using namespace hopper;
using wg::pack_bf16;
using wg::store_bf16x2;

constexpr int D = 128;
constexpr int BQ = 128;                        // query rows an item (2 x 64)
constexpr int BK = 128;                        // key rows a tile
constexpr int QBUF = 2;                        // Q buffers
constexpr int STAGES = 2;                      // K/V ring depth
constexpr int THREADS = 384;                   // producer + 2 consumers
constexpr int WARPS = 8;                       // consumer warps
constexpr int BOX = 128 * 128;                 // a 64-column box of 128 rows
constexpr int TILE = 2 * BOX;                  // Q, K or V: 128 x 128 bf16
constexpr int NBARS = 2 * QBUF + 4 * STAGES;
constexpr int SMEM = 1024 + QBUF * TILE + 2 * STAGES * TILE + 8 * NBARS;
static_assert(SMEM <= 232448, "more shared memory than a block has");
constexpr int TURN = 1;                        // named barriers 1 and 2

struct Item {
  int bh, q0, n_tiles;
};

// Item i: query tile n_qb - 1 - i / BH (the last, heaviest when causal,
// first) of head i % BH; its K/V tiles run to its last row's diagonal.
__device__ __forceinline__ Item item_of(int i, int BH, int n_qb, int Sq,
                                        int Sk, int causal) {
  Item w;
  w.bh = i % BH;
  w.q0 = (n_qb - 1 - i / BH) * BQ;
  const int q_last = min(w.q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  w.n_tiles = (k_end + BK - 1) / BK;
  return w;
}

// The item block `block` takes on round r (the snake), or -1 past the
// last item.
__device__ __forceinline__ int item_index(int r, int grid, int block,
                                          int n_items) {
  const int i = r * grid + ((r & 1) ? grid - 1 - block : block);
  return i < n_items ? i : -1;
}

// S = Q.K^T for this warpgroup's 64 rows (Q at sq) and a 128-row K tile:
// 8 k-steps over two swizzled 64-column boxes.
__device__ __forceinline__ void qk(float (&sc)[64], uint32_t sq, uint32_t sk) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_ss_m64n128k16(sc, desc_sw128(sq + off, 16, 1024),
                        desc_sw128(sk + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P.V for a 128-row V tile (MN-major, two 64-column boxes) with P in
// registers.
__device__ __forceinline__ void pv(float (&o)[64], const uint32_t (&p)[32],
                                   uint32_t sv) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs_m64n128k16(o, a, desc_sw128(sv + kk * 16 * 128, BOX, 1024));
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma128_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, int H, int Kh, int Sq,
                      int Sk, float scale_log2, int causal, int n_items,
                      int n_qb) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;   // + buffer * TILE
  const uint32_t sK = sQ + QBUF * TILE;                   // + stage * TILE
  const uint32_t sV = sK + STAGES * TILE;                 // + stage * TILE
  const uint32_t bar = sV + STAGES * TILE;
  auto q_full = [&](int b) { return bar + 8 * b; };
  auto q_empty = [&](int b) { return bar + 8 * (QBUF + b); };
  auto k_full = [&](int s) { return bar + 8 * (2 * QBUF + s); };
  auto v_full = [&](int s) { return bar + 8 * (2 * QBUF + STAGES + s); };
  auto k_empty = [&](int s) { return bar + 8 * (2 * QBUF + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar + 8 * (2 * QBUF + 3 * STAGES + s); };
  const int BH = n_items / n_qb;                  // B * H

  if (threadIdx.x == 0) {
    for (int b = 0; b < QBUF; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), WARPS);
      mbar_init(v_empty(s), WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                        // producer warpgroup
    regs_dealloc<24>();
    if (threadIdx.x != 0) return;
    int g = 0;                                    // tiles loaded so far
    for (int r = 0;; ++r) {
      const int i = item_index(r, gridDim.x, blockIdx.x, n_items);
      if (i < 0) break;
      const Item w = item_of(i, BH, n_qb, Sq, Sk, causal);
      const int kvh = (w.bh / H) * Kh + (w.bh % H) / (H / Kh);
      const int b = r % QBUF;
      if (r >= QBUF) mbar_wait(q_empty(b), (r / QBUF - 1) & 1);
      mbar_expect_tx(q_full(b), TILE);
      for (int x = 0; x < 2; ++x)
        tma_load_3d(sQ + b * TILE + x * BOX, &tm_q, q_full(b), 64 * x, w.q0,
                    w.bh);
      for (int j = 0; j < w.n_tiles; ++j, ++g) {
        const int s = g % STAGES;
        const uint32_t freed = (g / STAGES - 1) & 1;
        if (g >= STAGES) mbar_wait(k_empty(s), freed);
        mbar_expect_tx(k_full(s), TILE);
        for (int x = 0; x < 2; ++x)
          tma_load_3d(sK + s * TILE + x * BOX, &tm_k, k_full(s), 64 * x,
                      j * BK, kvh);
        if (g >= STAGES) mbar_wait(v_empty(s), freed);
        mbar_expect_tx(v_full(s), TILE);
        for (int x = 0; x < 2; ++x)
          tma_load_3d(sV + s * TILE + x * BOX, &tm_v, v_full(s), 64 * x,
                      j * BK, kvh);
      }
    }
    return;
  }

  // consumer warpgroup cw owns rows q0 + 64 cw .. + 63 of each item; this
  // thread holds rows r0 and r0 + 8, columns 8 e + 2 t + {0, 1}
  regs_alloc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const bool lead = (tid & 31) == 0;              // arrives for its warp
  // the turn at the tensor cores: warpgroup cw issues its GEMMs after
  // bar_sync(TURN + cw) and passes the turn on with bar_arrive(TURN + 1 -
  // cw); warpgroup 0 has the first
  if (cw == 1) bar_arrive(TURN, 256);
  int g = 0;                                      // tiles consumed so far
  for (int r = 0;; ++r) {
    const int i = item_index(r, gridDim.x, blockIdx.x, n_items);
    if (i < 0) break;
    const Item w = item_of(i, BH, n_qb, Sq, Sk, causal);
    const int b = r % QBUF;
    const int r_first = w.q0 + 64 * cw;
    const int r0 = r_first + 16 * (tid / 32) + (tid % 32) / 4;
    const bool turns = w.q0 + 64 < Sq;           // both warpgroups compute
    const int mine = r_first < Sq ? w.n_tiles : 0;
    const uint32_t sq = sQ + b * TILE + cw * 64 * 128;
    mbar_wait(q_full(b), (r / QBUF) & 1);

    if (mine == 0) {                              // rows past Sq
      if (lead) mbar_arrive(q_empty(b));
      for (int j = 0; j < w.n_tiles; ++j, ++g) {
        const int s = g % STAGES;
        mbar_wait(k_full(s), (g / STAGES) & 1);
        if (lead) mbar_arrive(k_empty(s));
        mbar_wait(v_full(s), (g / STAGES) & 1);
        if (lead) mbar_arrive(v_empty(s));
      }
      continue;
    }

    float o[64], sc[64];
    uint32_t p[32];
    float m[2] = {-INFINITY, -INFINITY}, l[2];
    float alpha[2], rs[2];
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.0f;
    int s = g % STAGES;
    mbar_wait(k_full(s), (g / STAGES) & 1);
    if (turns) bar_sync(TURN + cw, 256);
    qk(sc, sq, sK + s * TILE);
    if (turns) bar_arrive(TURN + 1 - cw, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lead) {
      mbar_arrive(k_empty(s));
      if (mine == 1) mbar_arrive(q_empty(b));
    }
    w64::softmax(sc, 0, r0, r_first, Sk, causal, scale_log2, m, alpha, rs, t);
    l[0] = rs[0];
    l[1] = rs[1];
#pragma unroll
    for (int e = 0; e < 32; ++e) p[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
    for (int j = 1; j < mine; ++j) {
      const int sp = g % STAGES;                  // tile j - 1's stage
      s = (g + 1) % STAGES;
      mbar_wait(k_full(s), ((g + 1) / STAGES) & 1);
      mbar_wait(v_full(sp), (g / STAGES) & 1);
      if (turns) bar_sync(TURN + cw, 256);
      qk(sc, sq, sK + s * TILE);
      pv(o, p, sV + sp * TILE);
      if (turns) bar_arrive(TURN + 1 - cw, 256);
      wgmma_wait<1>();                            // S_j done, P.V in flight
      fence_regs(sc);
      if (lead) {
        mbar_arrive(k_empty(s));
        if (j == mine - 1) mbar_arrive(q_empty(b));
      }
      w64::softmax(sc, j * BK, r0, r_first, Sk, causal, scale_log2, m, alpha,
                   rs, t);
      wgmma_wait<0>();                            // P_{j-1} V_{j-1} done
      fence_regs(o);
      fence_regs(p);
      if (lead) mbar_arrive(v_empty(sp));         // release V of tile j - 1
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        o[4 * e] *= alpha[0];
        o[4 * e + 1] *= alpha[0];
        o[4 * e + 2] *= alpha[1];
        o[4 * e + 3] *= alpha[1];
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
      ++g;
    }
    s = g % STAGES;
    mbar_wait(v_full(s), (g / STAGES) & 1);
    if (turns) bar_sync(TURN + cw, 256);
    pv(o, p, sV + s * TILE);
    if (turns) bar_arrive(TURN + 1 - cw, 256);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lead) mbar_arrive(v_empty(s));
    ++g;

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    const float inv0 = 1.0f / fmaxf(l[0], 1e-20f);
    const float inv1 = 1.0f / fmaxf(l[1], 1e-20f);
    __nv_bfloat16* ob = out + (long long)w.bh * Sq * D;
    const int r1 = r0 + 8;
#pragma unroll
    for (int e = 0; e < D / 8; ++e) {
      const int c = 8 * e + 2 * t;
      if (r0 < Sq)
        store_bf16x2(&ob[(long long)r0 * D + c], o[4 * e] * inv0,
                     o[4 * e + 1] * inv0);
      if (r1 < Sq)
        store_bf16x2(&ob[(long long)r1 * D + c], o[4 * e + 2] * inv1,
                     o[4 * e + 3] * inv1);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Kh, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = wg::make_map_cached(&mq, q, B * H, Sq, D, BQ);
  if (!err) err = wg::make_map_cached(&mk, k, B * Kh, Sk, D, BK);
  if (!err) err = wg::make_map_cached(&mv, v, B * Kh, Sk, D, BK);
  if (err) return err;
  static std::atomic<unsigned long long> limit_set{0};
  err = smem_limit_once(reinterpret_cast<const void*>(flash_wgmma128_kernel),
                        SMEM, limit_set);
  if (err) return err;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int n_qb = (Sq + BQ - 1) / BQ;
  const long long items = (long long)B * H * n_qb;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(items);
  const int grid = sms < n_items ? sms : n_items;
  flash_wgmma128_kernel<<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, Kh, Sq, Sk,
      scale * wg::LOG2E, causal, n_items, n_qb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace w128

}  // namespace

extern "C" {

// Shared memory one block needs at head dim D (the caller checks it
// against the 232,448 bytes a block may have).
int flash_attention_smem_bytes(int D) {
  const int nb = (D + 63) / 64;
  return (64 * nb * LDT * 2 + BK * 64 * nb) * static_cast<int>(sizeof(float));
}

// q [B,H,Sq,D], k/v [B,Kh,Sk,D], out [B,H,Sq,D], contiguous, H % Kh == 0;
// scale multiplies q.k (1/sqrt(D), rounded to fp32 by the caller as the
// TPU kernel's Python float is). Each returns 0 or the error of the launch
// (cudaError_t, or 10000 + CUresult where a tensor map could not be made).

// The CUDA-core kernel: dtype 0 = float32, 1 = bfloat16 (all four alike),
// D <= 256.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Kh, int Sq, int Sk,
                        int D, float scale, int causal, int dtype,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, Kh, Sq, Sk, D, scale, causal,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Kh, Sq, Sk, D, scale,
                                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma kernel: bfloat16, pointers 16-byte aligned, q and k D wide,
// v [B,Kh,Sk,Dv] and out [B,H,Sq,Dv] Dv wide, (D, Dv) one of (64, 64),
// (128, 128) and (192, 128). (192, 192) would need 246,840 bytes of shared
// memory at two stages, more than a block has.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              void* out, int B, int H, int Kh, int Sq, int Sk,
                              int D, int Dv, float scale, int causal,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(DK, DV) \
  wg::launch<DK, DV>(q, k, v, out, B, H, Kh, Sq, Sk, scale, causal, s)
  if (D == 128 && Dv == 128)
    return w128::launch(q, k, v, out, B, H, Kh, Sq, Sk, scale, causal, s);
  if (D == 64 && Dv == 64)
    return w64::launch(q, k, v, out, B, H, Kh, Sq, Sk, scale, causal, s);
  if (D == 192 && Dv == 128) return WG_LAUNCH(192, 128);
#undef WG_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
