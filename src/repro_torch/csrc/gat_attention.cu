// Dense GAT attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel gat_attention
// (src/repro/kernels/gat_attention.py, _kernel), with the semantics of its
// oracle (repro.kernels.ref.gat_attention_ref). Per subgraph c, head hh
// and destination row i:
//
//     e[j]    = LeakyReLU(s_dst[i] + s_src[j]), or -1e30 where struct <= 0
//     m       = max_j e[j]                       (over all N entries)
//     ex[j]   = exp(e[j] - m), then 0 where struct <= 0
//     attn[j] = ex[j] / max(sum_j ex[j], 1e-20)  (0 for an empty row)
//     out[i, hh*fh:(hh+1)*fh] = sum_j attn[j] * z[j, hh*fh:(hh+1)*fh]
//
// The sum runs over all N rows j, so a weight of 0 (outside the structure,
// or a structural exp that underflowed) times an inf or NaN in z gives NaN,
// as the oracle's attn @ z does.
//
// Bound: the function must read z and struct and write out once and does
// ~2 FLOP per structural entry and head column plus a few per score: at
// C=64, N=256, F=256, 4 heads that is 50.3 MB against ~0.23 G operations,
// so bytes bound it (0.0152 ms at 3.35 TB/s). The structure is sparse on
// the serving path (15.8 of 256 entries a row on average; a quarter of the
// rows are empty padding, and the rows longer than 32 hold 72 % of the
// entries), so all work after one pass over the structure is done on its
// entries only, and z, struct and out each cross device memory once.
//
// Two kernels; the caller (kernels/gat_attention.py, gat_variant) picks one
// from the shapes:
//
// "slab" (N <= 256, N and fh multiples of 4, 16-byte aligned z and struct:
// every serving shape). One block of 16 warps per (subgraph c, slice of at
// most 64 columns of one head); the head is the fast grid index, so the
// blocks that read one subgraph's structure run together and its re-reads
// hit L2. Two blocks an SM: 256 blocks, one wave, at the serving shape.
//   Staging: cp.async copies the z slab (N x 64 fp32, 64 KB at N=256) into
//   shared memory, with a row of zeros after it; the block reads s_src[c]
//   and s_dst[c] contiguously and keeps its head's column of each.
//   Structure: meanwhile every warp streams structure rows with 16-byte
//   loads, four rows at a time, and packs each row into a bitmap (N/32
//   words) in shared memory: a lane's four flags form a nibble, and three
//   xor-shuffles OR eight nibbles into a word.
//   Non-finite z: once z has landed, each slab row's non-finite columns
//   are ORed into a 64-bit mask (OR is order-free: the same bits on every
//   launch), and a flag says whether any row has one.
//   Rows: one warp per destination row, rows dealt to the warps in turn.
//   Its lanes hold the row's bitmap words; a scan of their popcounts gives
//   each word's place, and the warp walks the non-zero words only,
//   compacting the structural columns into a list in ascending j of
//   (offset of z[j] in the slab, score). The max over the list is one
//   redux.sync on an integer key that orders as the floats do, seeded at
//   the masked entries' -1e30 where the list is shorter than N (so a row
//   whose structural scores are all -inf gives 0, as the oracle does, not
//   NaN); then expf (not __expf) and the sum over the list, the 1e-20
//   clamp, and each weight times the sum's reciprocal. The list is padded
//   with zero-weight entries pointing at the zero row to whole steps, and
//   the two half-warps each sum alternate entries in list order (16 lanes,
//   four columns a lane, 16-byte loads of z from shared memory, fmaf, zero
//   weights included), then add their halves. Where the flag is set, the
//   row ORs the masks of the non-finite z rows outside its structure (a
//   weight of exactly 0) and writes NaN in those columns. Each row leaves
//   as one coalesced 256-byte store. No atomics in any sum: every launch
//   gives the same bits.
//   Where the time goes (scripts/gat_phase_probe.py, PERF.md): the first
//   phase is bound by L2 (each of a subgraph's four blocks reads its
//   structure), the rows phase by each row's chain of dependent steps and,
//   for entries, by shared-memory bandwidth (256 bytes of z an entry).
//   Shared memory: 64 KB slab, N*N/8 bitmap, a list of N + 8 pairs a warp:
//   111,888 bytes at N=256.
//
// "row" (the rest: N > 256, odd widths, unaligned tensors, and every bf16
// call: the slab's cp.async staging and float4 list walk are fp32's). One
// warp per destination row: its N scores live in shared memory, a block of
// 8 warps takes 8 rows of one (c, head); the weighted sum walks all N rows
// j in order, each lane owning up to four of the head's columns from L2. z
// and out are fp32 or bf16 (z widened on load, sums in fp32, out rounded
// once); the scores and the structure are fp32.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;           // the oracle's masked score

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_or(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(FULL, v, o);
  return v;
}

// A float's bits as an int that orders as the float does (-0 below +0;
// NaN above +inf or below -inf by its sign), and back.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.0f ? v : slope * v;
}

// A softmax weight's exp: expf, not __expf (the oracle's accuracy).
__device__ __forceinline__ float weight_exp(float v) { return expf(v); }

// -- "slab" -----------------------------------------------------------------

constexpr int SLAB_WARPS = 16;
constexpr int SLAB_THREADS = 32 * SLAB_WARPS;
constexpr int SLAB_COLS = 64;          // columns of one head a block takes
constexpr int SLAB_MAX_N = 256;        // two 16-byte loads a lane a row
constexpr int ROWS = 4;                // structure rows a warp loads at once
constexpr int GATHER = 4;              // list entries a half-warp reads a step
constexpr int PAD = 2 * GATHER;        // lists are padded to whole steps

struct SlabLayout {                    // byte offsets into shared memory
  int slab, bits, ssrc, sdst, bad, flag, lst, bytes;
  __host__ __device__ explicit SlabLayout(int N) {
    const int nw = (N + 31) / 32;
    slab = 0;                          // float [N + 1][<= SLAB_COLS]
    bits = slab + 4 * (N + 1) * SLAB_COLS;   // uint32 [N][nw]
    ssrc = bits + 4 * N * nw;          // float [32 nw]
    sdst = ssrc + 4 * 32 * nw;         // float [32 nw]
    bad = sdst + 4 * 32 * nw;          // uint2 [N]: non-finite columns
    flag = bad + 8 * N;                // int: any non-finite z
    lst = flag + 16;                   // int2 [SLAB_WARPS][N + PAD]
    bytes = lst + 8 * SLAB_WARPS * (N + PAD);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 z) {
  acc.x = fmaf(a, z.x, acc.x);
  acc.y = fmaf(a, z.y, acc.y);
  acc.z = fmaf(a, z.z, acc.z);
  acc.w = fmaf(a, z.w, acc.w);
}

__global__ void __launch_bounds__(SLAB_THREADS, 2) gat_slab_kernel(
    const float* __restrict__ z, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const float* __restrict__ st,
    float* __restrict__ out, int N, int F, int H, int slices, float slope) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SlabLayout L(N);
  float* slab = reinterpret_cast<float*>(smem + L.slab);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  float* ssrc = reinterpret_cast<float*>(smem + L.ssrc);
  float* sdst = reinterpret_cast<float*>(smem + L.sdst);
  uint2* bad = reinterpret_cast<uint2*>(smem + L.bad);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int c = blockIdx.y;
  const int hh = blockIdx.x / slices, sl = blockIdx.x % slices;
  const int fh = F / H;
  const int col0 = hh * fh + sl * SLAB_COLS;
  const int W = min(SLAB_COLS, fh - sl * SLAB_COLS);   // a multiple of 4
  const int q4 = W / 4;                // 16-byte groups in a slab row
  const int nw = (N + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // staging: the z slab by cp.async (and a row of zeros after it); this
  // head's scores; the non-finite masks and counters cleared
  const float* zc = z + (long long)c * N * F + col0;
  for (int t = threadIdx.x; t < N * q4; t += SLAB_THREADS) {
    const int r = t / q4, q = 4 * (t % q4);
    cp_async16(slab + r * W + q, zc + (long long)r * F + q);
  }
  cp_async_commit();
  for (int t = threadIdx.x; t < W; t += SLAB_THREADS) slab[N * W + t] = 0.0f;
  const float* ssc = s_src + (long long)c * N * H;
  const float* sdc = s_dst + (long long)c * N * H;
  for (int t = threadIdx.x; t < N * H; t += SLAB_THREADS) {
    const float a = __ldg(ssc + t), b = __ldg(sdc + t);
    if (t % H == hh) {
      ssrc[t / H] = a;
      sdst[t / H] = b;
    }
  }
  for (int t = threadIdx.x; t < N; t += SLAB_THREADS)
    bad[t] = make_uint2(0u, 0u);
  if (threadIdx.x == 0) *flag = 0;

  // the structure rows, packed into bitmaps
  const float* sp = st + (long long)c * N * N;
  const int n4 = N / 4;
  for (int i0 = warp; i0 < N; i0 += SLAB_WARPS * ROWS) {
    float4 v[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r * SLAB_WARPS;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = lane + 32 * u;
        v[r][u] = i < N && q < n4
                      ? __ldg(reinterpret_cast<const float4*>(
                            sp + (long long)i * N) + q)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r * SLAB_WARPS;
      if (i >= N) break;               // warp-uniform
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 x = v[r][u];
        uint32_t word = static_cast<uint32_t>(
                            (x.x > 0.0f) | (x.y > 0.0f) << 1 |
                            (x.z > 0.0f) << 2 | (x.w > 0.0f) << 3)
                        << (4 * (lane & 7));
        word |= __shfl_xor_sync(FULL, word, 1);
        word |= __shfl_xor_sync(FULL, word, 2);
        word |= __shfl_xor_sync(FULL, word, 4);
        const int w = 4 * u + lane / 8;
        if ((lane & 7) == 0 && w < nw) bits[i * nw + w] = word;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the non-finite columns of each slab row: bit k of .x is column k, of
  // .y column 32 + k
  for (int t = threadIdx.x; t < N * q4; t += SLAB_THREADS) {
    const int r = t / q4, q = 4 * (t % q4);
    const float4 x = *reinterpret_cast<const float4*>(slab + r * W + q);
    if (!isfinite((x.x + x.y) + (x.z + x.w))) {      // inf or NaN in any
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (!isfinite(e[k])) {
          const int col = q + k;
          atomicOr(col < 32 ? &bad[r].x : &bad[r].y, 1u << (col % 32));
          *flag = 1;
        }
    }
  }
  __syncthreads();
  const bool any_bad = *flag != 0;

  // a warp per destination row, rows dealt to the warps in turn; the two
  // half-warps take alternate list entries, lane g of each the slice's
  // columns 4g .. 4g + 3
  const float4* slab4 = reinterpret_cast<const float4*>(slab);
  int2* lst = reinterpret_cast<int2*>(smem + L.lst) + warp * (N + PAD);
  const uint32_t below = (1u << lane) - 1u;
  const int g = lane % 16, side = lane / 16;
  const int gq = min(g, q4 - 1);       // lanes past the slice read a copy
  for (int i = warp; i < N; i += SLAB_WARPS) {
    // the row's words: lane w holds word w; n structural entries in all,
    // woff of them in the words before w
    const uint32_t* brow = bits + i * nw;
    const uint32_t myword = lane < nw ? brow[lane] : 0u;
    int incl = __popc(myword);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int woff = incl - __popc(myword);
    const int n = __shfl_sync(FULL, incl, 7);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (n > 0) {
      // the list, (slab offset of z[j], score) in ascending j, from the
      // row's non-zero words only; the max as an ordered integer key
      const float sd = sdst[i];
      int key = INT_MIN;
      for (uint32_t live = __ballot_sync(FULL, myword != 0u); live;
           live &= live - 1u) {
        const int w = __ffs(live) - 1;
        const uint32_t word = __shfl_sync(FULL, myword, w);
        const int base = __shfl_sync(FULL, woff, w);
        if ((word >> lane) & 1u) {
          const int j = 32 * w + lane;
          const float e = leaky(sd + ssrc[j], slope);
          lst[base + __popc(word & below)] = make_int2(j * q4,
                                                       __float_as_int(e));
          key = max(key, order_key(e));
        }
      }
      float m = from_key(__reduce_max_sync(FULL, key));
      if (n < N) m = fmaxf(m, NEG_BIG);  // the masked entries' -1e30
      __syncwarp();
      // weights: exp over the list, then times 1 / the clamped sum
      int2 q0 = make_int2(0, 0);
      float x0 = 0.0f;
      if (lane < n) {
        q0 = lst[lane];
        x0 = weight_exp(__int_as_float(q0.y) - m);
      }
      float sum = x0;
      for (int p = lane + 32; p < n; p += 32) {
        const float x = weight_exp(__int_as_float(lst[p].y) - m);
        lst[p].y = __float_as_int(x);
        sum += x;
      }
      const float inv = 1.0f / fmaxf(warp_sum(sum), 1e-20f);
      if (lane < n) lst[lane] = make_int2(q0.x, __float_as_int(x0 * inv));
      for (int p = lane + 32; p < n; p += 32)
        lst[p].y = __float_as_int(__int_as_float(lst[p].y) * inv);
      const int np = (n + PAD - 1) / PAD * PAD;
      if (n + lane < np) lst[n + lane] = make_int2(N * q4, 0);  // zero row
      __syncwarp();

      // the weighted sum: each half-warp its entries in list order, zero
      // weights included, then the two halves added
      for (int p = side; p < np; p += PAD) {
        int2 e[GATHER];
        float4 zv[GATHER];
#pragma unroll
        for (int u = 0; u < GATHER; ++u) e[u] = lst[p + 2 * u];
#pragma unroll
        for (int u = 0; u < GATHER; ++u) zv[u] = slab4[e[u].x + gq];
#pragma unroll
        for (int u = 0; u < GATHER; ++u)
          fma4(acc, __int_as_float(e[u].y), zv[u]);
      }
      acc.x += __shfl_xor_sync(FULL, acc.x, 16);
      acc.y += __shfl_xor_sync(FULL, acc.y, 16);
      acc.z += __shfl_xor_sync(FULL, acc.z, 16);
      acc.w += __shfl_xor_sync(FULL, acc.w, 16);
    }
    if (any_bad) {                     // 0 * inf or NaN outside the list
      uint32_t px = 0, py = 0;
      for (int j = lane; j < N; j += 32) {
        const uint2 b = bad[j];
        if ((b.x | b.y) && !((brow[j / 32] >> (j % 32)) & 1u)) {
          px |= b.x;
          py |= b.y;
        }
      }
      px = warp_or(px);
      py = warp_or(py);
      const uint32_t cols = (g < 8 ? px : py) >> (4 * g % 32);
      const float nan = __int_as_float(0x7fffffff);
      if (cols & 1u) acc.x = nan;
      if (cols & 2u) acc.y = nan;
      if (cols & 4u) acc.z = nan;
      if (cols & 8u) acc.w = nan;
    }
    if (side == 0 && g < q4)
      *reinterpret_cast<float4*>(out + ((long long)c * N + i) * F + col0 +
                                 4 * g) = acc;
    __syncwarp();                      // lst is rewritten for the next row
  }
}

// -- "row" ------------------------------------------------------------------

constexpr int ROW_WARPS = 8;           // destination rows per block

template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) gat_row_kernel(
    const T* __restrict__ z, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const float* __restrict__ st,
    T* __restrict__ out, int N, int F, int H, float slope) {
  extern __shared__ float smem_f[];
  float* ssrc = smem_f;                        // [N] this head's s_src
  const int c = blockIdx.z;
  const int hh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int fh = F / H;
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    ssrc[j] = s_src[((long long)c * N + j) * H + hh];
  __syncthreads();
  const int i = blockIdx.x * ROW_WARPS + warp;
  if (i >= N) return;                          // no barrier below
  float* e = smem_f + N + warp * N;            // [N] this row's scores
  const float sd = s_dst[((long long)c * N + i) * H + hh];
  const float* srow = st + ((long long)c * N + i) * N;
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) {
    float v = leaky(sd + ssrc[j], slope);
    v = srow[j] > 0.0f ? v : NEG_BIG;
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
  const T* zc = z + (long long)c * N * F + hh * fh;
  T* orow = out + ((long long)c * N + i) * F + hh * fh;
  for (int f0 = 0; f0 < fh; f0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < N; ++j) {              // weight 0 included
      const float a = e[j];
      const T* zr = zc + (long long)j * F + f0 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f0 + q * 32 + lane < fh)
          acc[q] = fmaf(a, elem::to_f32(zr[q * 32]), acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (f0 + q * 32 + lane < fh)
        orow[f0 + q * 32 + lane] = elem::from_f32<T>(acc[q]);
  }
}

int row_smem_bytes(int N) {
  return (1 + ROW_WARPS) * N * static_cast<int>(sizeof(float));
}

template <typename T>
int row_launch(const T* z, const float* s_src, const float* s_dst,
               const float* st, T* out, int C, int N, int F, int H,
               float slope, void* stream) {
  const int smem = row_smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gat_row_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + ROW_WARPS - 1) / ROW_WARPS, H, C);
  gat_row_kernel<T><<<grid, ROW_WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      z, s_src, s_dst, st, out, N, F, H, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of each kernel needs at this N (the caller checks
// the limit).
int gat_slab_smem_bytes(int N) { return SlabLayout(N).bytes; }
// The largest N the slab kernel takes (the wrapper's routing checks it).
int gat_slab_max_n() { return SLAB_MAX_N; }
int gat_row_smem_bytes(int N) { return row_smem_bytes(N); }

// z [C,N,F], s_src/s_dst [C,N,H], struct [C,N,N], out [C,N,F]; F % H == 0.
// The slab kernel also needs N <= 256, N and F/H multiples of 4, and z,
// struct and out on 16-byte boundaries. Return cudaGetLastError.
int gat_attention_slab_f32(const float* z, const float* s_src,
                           const float* s_dst, const float* st, float* out,
                           int C, int N, int F, int H, float slope,
                           void* stream) {
  const int fh = F / H;
  if (N > SLAB_MAX_N || N % 4 || fh % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = SlabLayout(N).bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      gat_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (fh + SLAB_COLS - 1) / SLAB_COLS;
  const dim3 grid(H * slices, C);
  gat_slab_kernel<<<grid, SLAB_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      z, s_src, s_dst, st, out, N, F, H, slices, slope);
  return static_cast<int>(cudaGetLastError());
}

// The row kernel: z and out fp32 (_f32) or bf16 (_bf16).
int gat_attention_row_f32(const float* z, const float* s_src,
                          const float* s_dst, const float* st, float* out,
                          int C, int N, int F, int H, float slope,
                          void* stream) {
  return row_launch<float>(z, s_src, s_dst, st, out, C, N, F, H, slope,
                           stream);
}
int gat_attention_row_bf16(const elem::bf16* z, const float* s_src,
                           const float* s_dst, const float* st,
                           elem::bf16* out, int C, int N, int F, int H,
                           float slope, void* stream) {
  return row_launch<elem::bf16>(z, s_src, s_dst, st, out, C, N, F, H, slope,
                                stream);
}

}  // extern "C"
