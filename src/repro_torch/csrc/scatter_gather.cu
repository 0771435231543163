// Edge-list scatter-gather aggregation for Hopper (sm_90a); h and out fp32
// or bf16 (widened to fp32 on load, every sum in fp32, rounded once on the
// store), w fp32.
//
// Replaces the TPU kernel scatter_gather_aggregate
// (src/repro/kernels/scatter_gather.py, _kernel), with the semantics of its
// oracle (repro.kernels.ref.scatter_gather_aggregate_ref: w * h[src] summed
// per destination by segment_sum):
//
//     out[c, i] = sum_e [dst[c, e] == i] * w[c, e] * h[c, src[c, e]]
//
// The TPU kernel routes edges through one-hot matmuls because its matrix
// unit is its only fast path. A GPU gathers rows directly.
//
// Bound: the function must move src, dst, w, h and out once and does 2 FLOP
// per live edge and column, so it is bound by bytes (0.024 ms at the serving
// batch, F=512). Gathering a row of h per live edge from L2 moves 20 times
// that (506 MB at the serving batch: every source row is read by ~15
// edges), which held a first version of this design at 7.4x the bound. So
// each block stages its column tile of h[c] in shared memory once and
// gathers from there.
//
// Two variants; the caller picks one by shape before launch
// (kernels/scatter_gather.py, sg_variant).
//
// "sort" (E <= 65,536 and its shared memory fits at (N, E): every serving
// launch at N=256). One block of 16 warps per (c, tile of BF columns), BF =
// 128, 64 or 32: by default the narrowest that still covers F in one tile
// (F <= 32: 32, F <= 64: 64, else 128; a narrower block stages less and
// more blocks share an SM), never wider than the widest whose shared
// memory fits at (N, E); or the width the caller asks for (autotune's
// knob, which changes no result, since every lane sums its columns in the
// same edge order). A lane owns BF/32 consecutive columns.
//   Staging: cp.async copies h[c, :, tile] (N x BF fp32, 128 KB at N=256)
//   into shared memory while phase 1 runs (bf16 h: plain loads, widened).
//   Phase 1, a stable counting sort of the live edges (w != 0, src and dst
//   in [0, N)) by destination, in shared memory: each warp counts its
//   contiguous range of edges into its own histogram; one scan over
//   (destination, warp) gives each destination's bucket and each warp's
//   cursor in it; each warp then writes its edges' indices into the
//   buckets, ranking the lanes of a 32-edge chunk that share a destination
//   (match.any), so every bucket holds its edges in edge order. Both
//   passes load eight chunks of edges before using them.
//   Phase 2, one warp per destination row at a time (rows taken from a
//   shared counter, so a heavy row does not hold up a fixed set of others):
//   the warp walks the row's bucket, reading 8 rows of the staged tile at a
//   time before adding them, acc = __fadd_rn(acc, __fmul_rn(h[src], w)) in
//   registers, and writes the row once (zeros where the bucket is empty).
//   Each output thus sums its edges in edge order, with the multiply and
//   the add rounded separately, as segment_sum does: no atomics in the
//   sums, the same result on every run.
//   Weight-0 edges (the padding of every subgraph's edge list, ~80 % of the
//   slots on the serving batch, all pointing at vertex n_pad - 1) add
//   0 * h[src]: nothing for finite h, NaN where h[src, col] is inf or NaN.
//   They are not walked: phase 1 marks the distinct sources of in-range
//   weight-0 edges, tests each marked row's column tile for non-finite
//   values once, and ORs that row's mask into a NaN mask of each such
//   edge's destination; phase 2 writes NaN where the mask is set (NaN
//   absorbs any sum, so its place in the order does not matter).
//   Edges with src or dst outside [0, N) are skipped, as segment_sum drops
//   out-of-range destinations.
//
// Shared memory: the h tile (4 N BF bytes), 16 histograms of N ints, N + 1
// bucket starts, two N x 16-byte column masks, N flags, a counter, and a
// 16-bit index per edge slot (so E <= 65,536): 195,104 bytes at N=256,
// E=18,688, BF=128; one block an SM.
//
// "bucket" (the rest: E > 65,536, or N too large for the sort's shared
// memory, as forced sg on the Flickr-sized graph at N=1024 with its edge
// budget of 74,496 slots). The same sort with 32-bit indices and its
// scratch in device memory, in two launches. bucket_sort_kernel, one block
// of 16 warps a subgraph: the per-warp counts, the bucket starts and the
// weight-0 marks in a [C]-sliced scratch, the live edges written stably
// by destination as (src, w) pairs into a [C, E] scratch, and each
// weight-0 edge from a source row with non-finite columns ORing that row's
// column mask (one bit a column) into its destination's. bucket_gather_
// kernel, a warp per (destination row, 128 columns): the row's pairs in
// bucket (edge) order, h[c, src] read from device memory (L2), acc =
// __fadd_rn(acc, __fmul_rn(h, w)) in registers, NaN where the mask says,
// the row written once. The same sums in the same order as "sort": no
// atomics in any sum, the same result on every run. Bound: as "sort", by
// bytes; it re-reads a source row from L2 for every live edge.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int GATHER = 8;              // staged rows read per step
constexpr int UNROLL = 8;              // 32-edge chunks loaded per step
constexpr unsigned FULL = 0xffffffffu;

struct Layout {                        // byte offsets into shared memory
  int tile, cnt, start, bad, poison, zsrc, next, idx, bytes;
  __host__ __device__ Layout(int N, int E, int BF) {
    tile = 0;                          // float [N][BF]
    cnt = tile + 4 * N * BF;           // int [WARPS][N], then cursors
    start = cnt + 4 * WARPS * N;       // int [N + 1]
    bad = (start + 4 * (N + 1) + 15) & ~15;   // uint32 [N][4]
    poison = bad + 16 * N;             // uint32 [N][4]
    zsrc = poison + 16 * N;            // int [N]
    next = zsrc + 4 * N;               // int
    idx = next + 16;                   // uint16 [E]
    bytes = idx + ((2 * E + 15) & ~15);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// V consecutive floats of shared memory (16-, 8- or 4-byte aligned).
template <int V>
__device__ __forceinline__ void lds(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 1) scatter_gather_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const T* __restrict__ h,
    T* __restrict__ out, int N, int E, int F, int vec) {
  constexpr int BF = 32 * V;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(N, E, BF);
  float* tile = reinterpret_cast<float*>(smem + L.tile);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* start = reinterpret_cast<int*>(smem + L.start);
  uint32_t* bad = reinterpret_cast<uint32_t*>(smem + L.bad);
  uint32_t* poison = reinterpret_cast<uint32_t*>(smem + L.poison);
  int* zsrc = reinterpret_cast<int*>(smem + L.zsrc);
  int* next = reinterpret_cast<int*>(smem + L.next);
  uint16_t* idx = reinterpret_cast<uint16_t*>(smem + L.idx);

  const int c = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * BF;
  const int f = col0 + V * lane;                 // this lane's V columns
  const int* sc = src + (long long)c * E;
  const int* dc = dst + (long long)c * E;
  const float* wc = w + (long long)c * E;
  const T* hc = h + (long long)c * N * F;
  const int per = (E + WARPS - 1) / WARPS;
  const int e_begin = min(E, warp * per), e_end = min(E, e_begin + per);

  // staging of h[c, :, col0 : col0 + BF], zeros past F
  for (int i = threadIdx.x; i < N * BF / 4; i += THREADS) {
    const int r = i / (BF / 4), q = 4 * (i % (BF / 4));
    const T* g = hc + (long long)r * F + col0 + q;
    float* s = tile + r * BF + q;
    if (std::is_same<T, float>::value && vec && col0 + q + 3 < F) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = col0 + q + j < F ? elem::to_f32(g[j]) : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < WARPS * N; i += THREADS) cnt[i] = 0;
  for (int i = threadIdx.x; i < 4 * N; i += THREADS) bad[i] = poison[i] = 0;
  for (int i = threadIdx.x; i < N; i += THREADS) zsrc[i] = 0;
  if (threadIdx.x == 0) *next = 0;
  __syncthreads();

  // 1a: per-warp counts of live edges by destination; sources of weight-0
  for (int e0 = e_begin + lane; e0 < e_end; e0 += 32 * UNROLL) {
    int s[UNROLL], d[UNROLL];
    float we[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + 32 * u;
      s[u] = d[u] = -1;
      we[u] = 0.0f;
      if (e < e_end) {
        s[u] = sc[e];
        d[u] = dc[e];
        we[u] = wc[e];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (static_cast<unsigned>(s[u]) >= static_cast<unsigned>(N) ||
          static_cast<unsigned>(d[u]) >= static_cast<unsigned>(N))
        continue;
      if (we[u] != 0.0f) atomicAdd(&cnt[warp * N + d[u]], 1);
      else zsrc[s[u]] = 1;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 1b: the non-finite columns of each weight-0 source row (a warp a row)
  for (int s = warp; s < N; s += WARPS) {
    if (!zsrc[s]) continue;
    float x[V];
    lds<V>(tile + s * BF + V * lane, x);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const unsigned m = __ballot_sync(FULL, !isfinite(x[j]));
      if (lane == 0) bad[4 * s + j] = m;
    }
  }
  // ... and the buckets: per destination the total and each warp's
  // offset inside it; then the starts, an exclusive scan over N (warp 0)
  for (int d = threadIdx.x; d < N; d += THREADS) {
    int run = 0;
    for (int k = 0; k < WARPS; ++k) {
      const int n = cnt[k * N + d];
      cnt[k * N + d] = run;
      run += n;
    }
    start[d] = run;
  }
  __syncthreads();
  if (warp == 0) {
    const int chunk = (N + 31) / 32;
    const int lo = min(N, lane * chunk), hi = min(N, lo + chunk);
    int sum = 0;
    for (int d = lo; d < hi; ++d) sum += start[d];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int d = lo; d < hi; ++d) {
      const int n = start[d];
      start[d] = run;
      run += n;
    }
    if (lane == 31) start[N] = incl;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < WARPS * N; i += THREADS)
    cnt[i] += start[i % N];
  __syncthreads();

  // 1c: each warp places its live edges in edge order; weight-0 edges whose
  // source row has non-finite columns mark their destination
  const unsigned below = (1u << lane) - 1u;
  for (int e0 = e_begin; e0 < e_end; e0 += 32 * UNROLL) {
    int s[UNROLL], d[UNROLL];
    float we[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + 32 * u + lane;
      s[u] = d[u] = -1;
      we[u] = 0.0f;
      if (e < e_end) {
        s[u] = sc[e];
        d[u] = dc[e];
        we[u] = wc[e];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in =
          static_cast<unsigned>(s[u]) < static_cast<unsigned>(N) &&
          static_cast<unsigned>(d[u]) < static_cast<unsigned>(N);
      const bool live = in && we[u] != 0.0f;
      const unsigned peers = __match_any_sync(FULL, live ? d[u] : -1);
      const int rank = __popc(peers & below);
      if (live)
        idx[cnt[warp * N + d[u]] + rank] =
            static_cast<uint16_t>(e0 + 32 * u + lane);
      __syncwarp();
      if (live && rank == 0) cnt[warp * N + d[u]] += __popc(peers);
      __syncwarp();
      if (in && !live)
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (bad[4 * s[u] + j])
            atomicOr(&poison[4 * d[u] + j], bad[4 * s[u] + j]);
    }
  }
  __syncthreads();

  // 2: a warp per destination row, the row's edges in bucket (edge) order
  for (;;) {
    int row = 0;
    if (lane == 0) row = atomicAdd(next, 1);
    row = __shfl_sync(FULL, row, 0);
    if (row >= N) break;
    const int b0 = start[row], b1 = start[row + 1];
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int j0 = b0; j0 < b1; j0 += 32) {
      const int n = min(32, b1 - j0);
      int se = 0;
      float we = 0.0f;
      if (lane < n) {
        const int e = idx[j0 + lane];
        se = sc[e];
        we = wc[e];
      }
      for (int q0 = 0; q0 < n; q0 += GATHER) {
        float v[GATHER][V];
#pragma unroll
        for (int u = 0; u < GATHER; ++u) {
          const int sj = __shfl_sync(FULL, se, q0 + u);
          if (q0 + u < n) {
            lds<V>(tile + sj * BF + V * lane, v[u]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) v[u][j] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < GATHER; ++u) {
          const float wj = __shfl_sync(FULL, we, q0 + u);
          if (q0 + u < n)
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[j] = __fadd_rn(acc[j], __fmul_rn(v[u][j], wj));
        }
      }
    }
    const float nan = __int_as_float(0x7fffffff);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if ((poison[4 * row + j] >> lane) & 1u) acc[j] = nan;
    T* o = out + ((long long)c * N + row) * F;
    if constexpr (V == 4) {
      elem::store4(o + f, F - f, vec, acc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (f + j < F) o[f + j] = elem::from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int V>
int launch(const int* src, const int* dst, const float* w, const T* h,
           T* out, int C, int N, int E, int F, int vec,
           cudaStream_t stream) {
  const int smem = Layout(N, E, 32 * V).bytes;
  auto kernel = scatter_gather_kernel<T, V>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + 32 * V - 1) / (32 * V), C);
  kernel<<<grid, THREADS, smem, stream>>>(src, dst, w, h, out, N, E, F, vec);
  return static_cast<int>(cudaGetLastError());
}

constexpr int MAX_SMEM = 232448;       // bytes a block may have (H100)

// The default columns a block at (N, E, F): the narrowest candidate that
// covers F, capped at the widest that fits; 0 where none fits.
int block_cols(int N, int E, int F) {
  if (E > 65536) return 0;             // 16-bit edge indices
  int bf = 128;
  while (bf >= 32 && Layout(N, E, bf).bytes > MAX_SMEM) bf /= 2;
  if (bf < 32) return 0;
  while (bf > 32 && bf / 2 >= F) bf /= 2;
  return bf;
}

// -- "bucket" ----------------------------------------------------------------

constexpr int GROWS = 8;               // destination rows (warps) a block

// Per-subgraph slices of the bucket variant's int32 scratch.
struct Scratch {
  int *cnt, *start, *zsrc;             // [WARPS][N], [N + 2], [N]
  uint32_t *bad, *poison;              // [N][FW] each: one bit a column
  int2* pairs;                         // [E]: (src, w bits) by destination
  __host__ __device__ static long long words(int N, int E, int FW) {
    // N + 2 starts (one of padding): the pairs stay 8-byte aligned
    return (long long)WARPS * N + (N + 2) + N + 2LL * N * FW + 2LL * E;
  }
  __device__ Scratch(int* base, int c, int N, int E, int FW) {
    int* p = base + (long long)c * words(N, E, FW);
    cnt = p;
    start = cnt + WARPS * N;
    zsrc = start + N + 2;
    bad = reinterpret_cast<uint32_t*>(zsrc + N);
    poison = bad + (long long)N * FW;
    pairs = reinterpret_cast<int2*>(poison + (long long)N * FW);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) bucket_sort_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const T* __restrict__ h,
    int* __restrict__ scratch, int N, int E, int F) {
  const int c = blockIdx.x;
  const int FW = (F + 31) / 32;
  Scratch S(scratch, c, N, E, FW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* sc = src + (long long)c * E;
  const int* dc = dst + (long long)c * E;
  const float* wc = w + (long long)c * E;
  const T* hc = h + (long long)c * N * F;
  const int per = (E + WARPS - 1) / WARPS;
  const int lo = min(E, warp * per), hi = min(E, lo + per);

  for (int i = threadIdx.x; i < WARPS * N; i += THREADS) S.cnt[i] = 0;
  for (int i = threadIdx.x; i < N; i += THREADS) S.zsrc[i] = 0;
  for (int i = threadIdx.x; i < N * FW; i += THREADS)
    S.bad[i] = S.poison[i] = 0;
  __syncthreads();

  // per-warp counts of live edges by destination; weight-0 sources marked
  for (int e = lo + lane; e < hi; e += 32) {
    const int s = sc[e], d = dc[e];
    if (static_cast<unsigned>(s) >= static_cast<unsigned>(N) ||
        static_cast<unsigned>(d) >= static_cast<unsigned>(N))
      continue;
    if (wc[e] != 0.0f) atomicAdd(&S.cnt[warp * N + d], 1);
    else S.zsrc[s] = 1;
  }
  __syncthreads();

  // the non-finite columns of each marked source row (a warp a row); the
  // mark becomes 2 where the row has any
  for (int s = warp; s < N; s += WARPS) {
    if (!S.zsrc[s]) continue;
    unsigned any = 0;
    for (int k = 0; k < FW; ++k) {
      const int f = 32 * k + lane;
      const float x = f < F ? elem::to_f32(hc[(long long)s * F + f]) : 0.0f;
      const unsigned m = __ballot_sync(FULL, !isfinite(x));
      any |= m;
      if (lane == 0) S.bad[s * FW + k] = m;
    }
    if (lane == 0 && any) S.zsrc[s] = 2;
  }
  // each destination's total and each warp's offset inside its bucket
  for (int d = threadIdx.x; d < N; d += THREADS) {
    int run = 0;
    for (int k = 0; k < WARPS; ++k) {
      const int n = S.cnt[k * N + d];
      S.cnt[k * N + d] = run;
      run += n;
    }
    S.start[d] = run;
  }
  __syncthreads();
  if (warp == 0) {                     // exclusive scan of the totals
    const int chunk = (N + 31) / 32;
    const int a = min(N, lane * chunk), b = min(N, a + chunk);
    int sum = 0;
    for (int d = a; d < b; ++d) sum += S.start[d];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int d = a; d < b; ++d) {
      const int n = S.start[d];
      S.start[d] = run;
      run += n;
    }
    if (lane == 31) S.start[N] = incl;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < WARPS * N; i += THREADS)
    S.cnt[i] += S.start[i % N];
  __syncthreads();

  // each warp writes its live edges in edge order (lanes of a 32-edge
  // chunk that share a destination ranked by match.any); weight-0 edges
  // from marked rows OR the row's mask into their destination's
  const unsigned below = (1u << lane) - 1u;
  for (int e0 = lo; e0 < hi; e0 += 32) {
    const int e = e0 + lane;
    int s = -1, d = -1;
    float we = 0.0f;
    if (e < hi) {
      s = sc[e];
      d = dc[e];
      we = wc[e];
    }
    const bool ok = static_cast<unsigned>(s) < static_cast<unsigned>(N) &&
                    static_cast<unsigned>(d) < static_cast<unsigned>(N);
    const bool take = ok && we != 0.0f;
    const unsigned peers = __match_any_sync(FULL, take ? d : -1);
    const int rank = __popc(peers & below);
    int* cur = take ? &S.cnt[warp * N + d] : nullptr;
    if (take) S.pairs[*cur + rank] = make_int2(s, __float_as_int(we));
    __syncwarp();
    if (take && rank == 0) *cur += __popc(peers);
    __syncwarp();
    if (ok && !take && S.zsrc[s] == 2)
      for (int k = 0; k < FW; ++k) {
        const uint32_t m = S.bad[s * FW + k];
        if (m) atomicOr(&S.poison[d * FW + k], m);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * GROWS) bucket_gather_kernel(
    const T* __restrict__ h, const int* __restrict__ scratch,
    T* __restrict__ out, int N, int E, int F, int vec) {
  const int c = blockIdx.z;
  const int FW = (F + 31) / 32;
  Scratch S(const_cast<int*>(scratch), c, N, E, FW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * GROWS + warp;
  if (i >= N) return;
  const int f = blockIdx.y * 128 + 4 * lane;   // this lane's 4 columns
  const T* hc = h + (long long)c * N * F;
  const int first = S.start[i], last = S.start[i + 1];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = first; j0 < last; j0 += 32) {
    const int n = min(32, last - j0);
    const int2 mine = lane < n ? S.pairs[j0 + lane] : make_int2(0, 0);
    for (int q0 = 0; q0 < n; q0 += GATHER) {
      float v[GATHER][4];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int sj = __shfl_sync(FULL, mine.x, q0 + u);
        if (q0 + u < n) {
          elem::load4(hc + (long long)sj * F + f, F - f, vec, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const float wj = __int_as_float(__shfl_sync(FULL, mine.y, q0 + u));
        if (q0 + u < n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(v[u][j], wj));
      }
    }
  }
  const float nan = __int_as_float(0x7fffffff);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (f + j < F && ((S.poison[i * FW + (f + j) / 32] >> ((f + j) % 32)) & 1u))
      acc[j] = nan;
  elem::store4(out + ((long long)c * N + i) * F + f, F - f, vec, acc);
}

// Whether the sort variant takes (N, E) at bc columns a block.
bool fits(int N, int E, int bc) {
  return (bc == 128 || bc == 64 || bc == 32) && E <= 65536 &&
         Layout(N, E, bc).bytes <= MAX_SMEM;
}

template <typename T>
int launch_sort(const int* src, const int* dst, const float* w, const T* h,
                T* out, int C, int N, int E, int F, int bc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (bc == 0) bc = block_cols(N, E, F);
  else if (!fits(N, E, bc)) return static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
    case 128: return launch<T, 4>(src, dst, w, h, out, C, N, E, F, vec, s);
    case 64: return launch<T, 2>(src, dst, w, h, out, C, N, E, F, vec, s);
    case 32: return launch<T, 1>(src, dst, w, h, out, C, N, E, F, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bucket(const int* src, const int* dst, const float* w, const T* h,
                  T* out, int* scratch, int C, int N, int E, int F,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  bucket_sort_kernel<T><<<C, THREADS, 0, s>>>(src, dst, w, h, scratch, N, E,
                                               F);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + GROWS - 1) / GROWS, (F + 127) / 128, C);
  bucket_gather_kernel<T><<<grid, 32 * GROWS, 0, s>>>(h, scratch, out, N, E,
                                                       F, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The columns a block of the sort variant takes by default at (N, E) for F
// columns: 128, 64 or 32, the narrowest that covers F, capped at the
// widest whose shared memory fits a block; 0 where none fits or E > 65,536
// (then the bucket variant takes the shape).
int scatter_gather_block_cols(int N, int E, int F) {
  return block_cols(N, E, F);
}

// int32 words of scratch the bucket variant needs for C subgraphs.
long long scatter_gather_bucket_scratch_words(int C, int N, int E, int F) {
  return (long long)C * Scratch::words(N, E, (F + 31) / 32);
}

// src/dst [C,E] int32, w [C,E] fp32, h [C,N,F] and out [C,N,F] fp32 (_f32)
// or bf16 (_bf16), contiguous. The sort variant needs
// scatter_gather_block_cols(N, E, F) != 0 and takes block_cols columns a
// block (128, 64 or 32; 0 = scatter_gather_block_cols(N, E, F)); the bucket
// variant takes any shape and `scratch` of
// scatter_gather_bucket_scratch_words int32. Each returns cudaGetLastError
// (cudaErrorInvalidValue where the sort's shared memory does not fit at
// the width asked for).
int scatter_gather_sort_f32(const int* src, const int* dst, const float* w,
                            const float* h, float* out, int C, int N, int E,
                            int F, int block_cols, void* stream) {
  return launch_sort<float>(src, dst, w, h, out, C, N, E, F, block_cols,
                            stream);
}
int scatter_gather_sort_bf16(const int* src, const int* dst, const float* w,
                             const elem::bf16* h, elem::bf16* out, int C,
                             int N, int E, int F, int block_cols,
                             void* stream) {
  return launch_sort<elem::bf16>(src, dst, w, h, out, C, N, E, F, block_cols,
                                 stream);
}
int scatter_gather_bucket_f32(const int* src, const int* dst, const float* w,
                              const float* h, float* out, int* scratch, int C,
                              int N, int E, int F, void* stream) {
  return launch_bucket<float>(src, dst, w, h, out, scratch, C, N, E, F,
                              stream);
}
int scatter_gather_bucket_bf16(const int* src, const int* dst,
                               const float* w, const elem::bf16* h,
                               elem::bf16* out, int* scratch, int C, int N,
                               int E, int F, void* stream) {
  return launch_bucket<elem::bf16>(src, dst, w, h, out, scratch, C, N, E, F,
                                   stream);
}

}  // extern "C"
