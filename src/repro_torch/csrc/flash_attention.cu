// Flash attention (forward) for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/
// flash_attention.py, _kernel). For each (batch*head, query row r):
//
//     s[c]  = (q[r] . k[c]) * scale              scale = 1/sqrt(D), fp32
//     s[c]  = -1e30 where causal and c > r       (top-left aligned)
//     online softmax over key tiles: m, l running max and sum
//     out[r] = (sum_c exp(s[c] - m) v[c]) / max(l, 1e-20)
//
// q [BH,Sq,D], k/v [BH,Sk,D], out [BH,Sq,D], float32 or bfloat16 (out in
// q's type); every product and sum is fp32, as in the TPU kernel.
//
// Design (a first, simple one): one block of 256 threads per (bh, 64-row
// query tile), the heaviest causal tiles launched first. The query tile
// sits in shared memory, transposed, for the block's life; key and value
// tiles of 64 rows are staged through shared memory one at a time (fp32,
// zero-padded to a multiple of 64 columns). Thread (g, h) of a 16 x 16
// grid owns query rows 4g..4g+3: it computes the 4 x 4 score patch of key
// columns 4h..4h+3 from float4 loads, keeps m and l of its rows in
// registers (max and sum are shuffles across the 16 threads of a row
// group), writes its exp'd patch transposed into shared memory over the
// key tile it no longer needs, and accumulates out[4 rows][64b+4h..+3]
// for each 64-column slab b in registers. Key tiles wholly above the
// diagonal are never loaded; ragged tiles are masked (columns >= Sk get
// p = 0, rows >= Sq are not stored), so any Sq and Sk work.
//
// Bound: at the serving shape (B=1, H=40, S=8192, D=128, bf16, causal)
// the function moves 335 MB and does 6.87e11 operations, so it is bound
// by operations: 0.69 ms at the tensor cores' 989 TFLOP/s (bf16), 10.3 ms
// at the CUDA cores' 67 TFLOP/s (fp32). This kernel runs on the CUDA cores
// (fp32 FMAs fed by float4 shared-memory loads, 8 FMAs per load); wgmma
// on bf16 tiles, TMA and a pipelined K/V ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int D, float scale, int causal) {
  constexpr int DP = 64 * NB;           // D padded to 64-column slabs
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + DP * LDT;
  float* Pt = Kt;
  float* Vs = Kt + DP * LDT;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int g = tid / 16;               // rows 4g..4g+3
  const int h = tid % 16;               // columns 4h..4h+3 (of each slab)
  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + (long long)bh * Sk * D;
  const T* vb = v + (long long)bh * Sk * D;

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
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const int smem = smem_floats<NB>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, NB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int Sq, int Sk, int D, float scale, int causal,
             cudaStream_t s) {
  switch ((D + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, out, BH, Sq, Sk, D, scale, causal, s);
    case 2: return launch<T, 2>(q, k, v, out, BH, Sq, Sk, D, scale, causal, s);
    case 3: return launch<T, 3>(q, k, v, out, BH, Sq, Sk, D, scale, causal, s);
    case 4: return launch<T, 4>(q, k, v, out, BH, Sq, Sk, D, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at head dim D (the caller checks it
// against the 232,448 bytes a block may have).
int flash_attention_smem_bytes(int D) {
  const int nb = (D + 63) / 64;
  return (64 * nb * LDT * 2 + BK * 64 * nb) * static_cast<int>(sizeof(float));
}

// q [BH,Sq,D], k/v [BH,Sk,D], out [BH,Sq,D], contiguous; dtype 0 = float32,
// 1 = bfloat16 (all four alike); scale multiplies q.k (1/sqrt(D), rounded
// to fp32 by the caller as the TPU kernel's Python float is). Returns
// cudaGetLastError.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int BH, int Sq, int Sk, int D,
                        float scale, int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, BH, Sq, Sk, D, scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, scale,
                                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
