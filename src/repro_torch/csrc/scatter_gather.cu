// Edge-list scatter-gather aggregation for Hopper (sm_90a), fp32.
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
// Design: one block of 16 warps per (c, tile of BF columns), BF = 128 where
// shared memory allows, else 64 or 32 (the caller picks the widest that
// fits at (N, E)); a lane owns BF/32 consecutive columns.
//   Staging: cp.async copies h[c, :, tile] (N x BF fp32, 128 KB at N=256)
//   into shared memory while phase 1 runs.
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
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int V>
__global__ void __launch_bounds__(THREADS, 1) scatter_gather_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ h,
    float* __restrict__ out, int N, int E, int F, int vec) {
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
  const float* hc = h + (long long)c * N * F;
  const int per = (E + WARPS - 1) / WARPS;
  const int e_begin = min(E, warp * per), e_end = min(E, e_begin + per);

  // staging of h[c, :, col0 : col0 + BF], zeros past F
  for (int i = threadIdx.x; i < N * BF / 4; i += THREADS) {
    const int r = i / (BF / 4), q = 4 * (i % (BF / 4));
    const float* g = hc + (long long)r * F + col0 + q;
    float* s = tile + r * BF + q;
    if (vec && col0 + q + 3 < F) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = col0 + q + j < F ? __ldg(g + j) : 0.0f;
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
    float* o = out + ((long long)c * N + row) * F;
    if (V == 4 && vec && f + 3 < F) {
      *reinterpret_cast<float4*>(o + f) =
          make_float4(acc[0], acc[V > 1 ? 1 : 0], acc[V > 2 ? 2 : 0],
                      acc[V > 3 ? 3 : 0]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (f + j < F) o[f + j] = acc[j];
    }
  }
}

template <int V>
int launch(const int* src, const int* dst, const float* w, const float* h,
           float* out, int C, int N, int E, int F, int vec,
           cudaStream_t stream) {
  const int smem = Layout(N, E, 32 * V).bytes;
  auto kernel = scatter_gather_kernel<V>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + 32 * V - 1) / (32 * V), C);
  kernel<<<grid, THREADS, smem, stream>>>(src, dst, w, h, out, N, E, F, vec);
  return static_cast<int>(cudaGetLastError());
}

constexpr int MAX_SMEM = 232448;       // bytes a block may have (H100)

}  // namespace

extern "C" {

// The columns a block takes at (N, E): 128, 64 or 32, the widest whose
// shared memory fits a block; 0 where none does.
int scatter_gather_block_cols(int N, int E) {
  for (int bf = 128; bf >= 32; bf /= 2)
    if (Layout(N, E, bf).bytes <= MAX_SMEM) return bf;
  return 0;
}

// src/dst [C,E] int32, w [C,E], h [C,N,F], out [C,N,F], contiguous,
// E <= 65,536. Returns cudaGetLastError (cudaErrorInvalidValue where no
// block width fits shared memory).
int scatter_gather_aggregate_f32(const int* src, const int* dst,
                                 const float* w, const float* h, float* out,
                                 int C, int N, int E, int F, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  switch (scatter_gather_block_cols(N, E)) {
    case 128: return launch<4>(src, dst, w, h, out, C, N, E, F, vec, s);
    case 64: return launch<2>(src, dst, w, h, out, C, N, E, F, vec, s);
    case 32: return launch<1>(src, dst, w, h, out, C, N, E, F, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
