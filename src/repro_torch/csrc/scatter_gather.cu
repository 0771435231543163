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
// memory: forced sg on the Flickr-sized graph at N=1024 with its 74,496
// edge slots, and the offline build's chunk, C=1 with N=32,868 source rows
// and 2048 destinations). Its output has n_out rows of the caller's
// choosing (destinations in [0, n_out); edges to others are dropped, as
// segment_sum(num_segments=n_out) drops them), so a chunk writes only its
// own rows. The same stable sort by destination, spread over many blocks,
// its scratch in device memory, in four launches:
//   1. bucket_count_kernel, a block per (tile of TILE = 2048 edge slots,
//      subgraph): the tile's live edges counted by destination and its
//      weight-0 sources marked, into the tile's own rows of the scratch.
//   2. bucket_scan_kernel: block 0 of each subgraph scans the counts over
//      (destination, tile), destination-major: each destination's bucket
//      start and each tile's offset inside each bucket, so that the tiles'
//      edges follow one another in edge order; and it lists the hub rows
//      (HUB = 512 live edges or more). The other blocks OR every tile's
//      weight-0 marks, test each marked source row for non-finite columns
//      and zero the destinations' NaN masks.
//   3. bucket_place_kernel, a block a tile: a block-wide stable radix sort
//      of the tile's (destination, edge) pairs (cub::BlockRadixSort, on
//      the destination's bits only), then each live edge written as
//      (src, w) at bucket start + tile offset + its rank in the tile's run;
//      weight-0 edges from a flagged source OR the row's column mask into
//      their destination's.
//   4. bucket_gather_kernel, a warp per (output row, 128 columns): the
//      row's bucket walked in edge order, three stages of 8 edges' h rows
//      in flight through a ring in shared memory (cp.async, or plain loads
//      where rows or columns are not 16-byte aligned, as bf16 at F=500), a
//      stage's values in registers while the stage before it is summed,
//      acc = __fadd_rn(acc, __fmul_rn(h, w)), NaN where the mask says, the
//      row written once. A hub row (HUB = 512 live edges or more) takes a
//      block per 8 columns instead, launched first: one warp sums while
//      three copy six stages of 32 edges ahead, a barrier a stage (the
//      copies, not the sums, bound a warp that copies for itself: ~68
//      cycles a 16-byte-a-lane cp.async over four rows).
// The same sums in the same order as "sort", and as this variant before
// the split: no atomics in any sum, the same result on every run. Bound:
// bytes (src, dst, w, h once, the n_out rows once); it reads a source row
// from L2 for every live edge, and a hub row's chain of dependent adds
// (18,406 of them on the Flickr-sized graph) takes ~37 us at 1.98 GHz.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cub/block/block_radix_sort.cuh>
#include <type_traits>

#include "elem.cuh"
#include "hopper.cuh"

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

constexpr int MAX_SMEM = 232448;       // bytes a block may have (H100)

template <typename T, int V>
int launch(const int* src, const int* dst, const float* w, const T* h,
           T* out, int C, int N, int E, int F, int vec,
           cudaStream_t stream) {
  const int smem = Layout(N, E, 32 * V).bytes;
  auto kernel = scatter_gather_kernel<T, V>;
  static std::atomic<unsigned long long> limit_set{0};
  const int err = hopper::smem_limit_once(
      reinterpret_cast<const void*>(kernel), MAX_SMEM, limit_set);
  if (err) return err;
  const dim3 grid((F + 32 * V - 1) / (32 * V), C);
  kernel<<<grid, THREADS, smem, stream>>>(src, dst, w, h, out, N, E, F, vec);
  return static_cast<int>(cudaGetLastError());
}

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

constexpr int TB = 256;                // threads of a tile's block
constexpr int TITEMS = 8;              // edge slots a thread of a tile
constexpr int TILE = TB * TITEMS;      // edge slots a tile
constexpr int HUB = 512;               // live in-edges that make a row a hub
constexpr int GWARPS = 4;              // warps a gather block
// A gather warp's shared memory: a ring of RING bytes of h rows (4
// stages of 8 edges at 128 columns), then PAIRS bytes of the stages'
// sources and weights, 8 stages of them; a hub's block takes the four
// warps' shares as one ring.
constexpr int RING = 16384;
constexpr int PAIRS = 512;
constexpr int WARP_SMEM = RING + PAIRS;
constexpr int GATHER_SMEM = GWARPS * WARP_SMEM;

// The bucket variant's shapes, and the offsets (int32 words) of its
// per-subgraph scratch.
struct Bucket {
  int N, n_out, E, F;
  int T;      // tiles of TILE edge slots
  int NW;     // 32-row words of a source bitmap
  int FW;     // 32-column words of a column mask
  int HMAX;   // rows that can hold HUB live edges
  __host__ __device__ Bucket(int N_, int n_out_, int E_, int F_)
      : N(N_), n_out(n_out_), E(E_), F(F_) {
    T = E > 0 ? (E + TILE - 1) / TILE : 1;
    NW = (N + 31) / 32;
    FW = (F + 31) / 32;
    HMAX = E / HUB < n_out ? E / HUB : n_out;
  }
  // cnt [T][n_out]: a tile's live edges by destination, then (scan) its
  // offset inside each destination's bucket
  __host__ __device__ long long o_mark() const {   // uint32 [T][NW]
    return (long long)T * n_out;
  }
  __host__ __device__ long long o_start() const {  // int [n_out + 1]
    return o_mark() + (long long)T * NW;
  }
  // hubs: their count, the gather's next work item, the rows as listed,
  // the rows by live edges, most first
  __host__ __device__ long long o_hubs() const {   // int [2 + 2 HMAX]
    return o_start() + n_out + 1;
  }
  __host__ __device__ long long o_flag() const {   // uint32 [NW]
    return o_hubs() + 2 + 2LL * HMAX;
  }
  __host__ __device__ long long o_bad() const {    // uint32 [N][FW]
    return o_flag() + NW;
  }
  __host__ __device__ long long o_poison() const { // uint32 [n_out][FW]
    return o_bad() + (long long)N * FW;
  }
  __host__ __device__ long long o_pairs() const {  // int2 [E], 8-aligned
    return (o_poison() + (long long)n_out * FW + 1) & ~1LL;
  }
  __host__ __device__ long long words() const {
    return o_pairs() + 2LL * E;
  }
};

__device__ __forceinline__ bool bit(const uint32_t* m, int i) {
  return (m[i >> 5] >> (i & 31)) & 1u;
}

// 1. Per tile: its live edges counted by destination and its weight-0
// sources marked, each into the tile's own rows of the scratch (zeroed
// here first: no other block writes them). Lanes of a 32-edge chunk that
// share a destination (or a weight-0 source) add once.
__global__ void __launch_bounds__(TB) bucket_count_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, int* __restrict__ scratch, Bucket B) {
  const int c = blockIdx.y, t = blockIdx.x, lane = threadIdx.x % 32;
  int* base = scratch + (long long)c * B.words();
  int* cnt = base + (long long)t * B.n_out;
  uint32_t* mark =
      reinterpret_cast<uint32_t*>(base + B.o_mark()) + (long long)t * B.NW;
  for (int i = threadIdx.x; i < B.n_out; i += TB) cnt[i] = 0;
  for (int i = threadIdx.x; i < B.NW; i += TB) mark[i] = 0;
  __syncthreads();
  const long long off = (long long)c * B.E;
  const unsigned below = (1u << lane) - 1u;
  int s[TITEMS], d[TITEMS];
  float we[TITEMS];
#pragma unroll
  for (int k = 0; k < TITEMS; ++k) {
    const int e = t * TILE + k * TB + threadIdx.x;
    s[k] = d[k] = -1;
    we[k] = 0.0f;
    if (e < B.E) {
      s[k] = src[off + e];
      d[k] = dst[off + e];
      we[k] = w[off + e];
    }
  }
#pragma unroll
  for (int k = 0; k < TITEMS; ++k) {
    const bool in = static_cast<unsigned>(s[k]) < static_cast<unsigned>(B.N) &&
                    static_cast<unsigned>(d[k]) <
                        static_cast<unsigned>(B.n_out);
    const bool live = in && we[k] != 0.0f;
    const unsigned lp = __match_any_sync(FULL, live ? d[k] : -1);
    if (live && (lp & below) == 0) atomicAdd(&cnt[d[k]], __popc(lp));
    const bool zero = in && we[k] == 0.0f;
    const unsigned zp = __match_any_sync(FULL, zero ? s[k] : -1);
    if (zero && (zp & below) == 0)
      atomicOr(&mark[s[k] >> 5], 1u << (s[k] & 31));
  }
}

// An exclusive scan of x over the block's THREADS threads (`part`: WARPS
// ints of shared memory).
__device__ __forceinline__ int block_exclusive(int x, int* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < WARPS ? part[lane] : 0;
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, vi, o);
      if (lane >= o) vi += y;
    }
    if (lane < WARPS) part[lane] = vi - v;
  }
  __syncthreads();
  return part[warp] + incl - x;
}

// 2. Block 0 of each subgraph: each destination's total over the tiles and
// each tile's offset inside its bucket (a running sum over the tiles, in
// tile order), the bucket starts (an exclusive scan of the totals) and the
// list of hub rows. The other blocks: the marks of all tiles ORed, each
// marked source row's non-finite columns (a warp a 32-row word: the row's
// column mask where any, and the word's flags), and the destinations'
// NaN masks zeroed. Every tile's marks are in before any row is tested.
template <typename T>
__global__ void __launch_bounds__(THREADS) bucket_scan_kernel(
    const T* __restrict__ h, int* __restrict__ scratch, Bucket B) {
  const int c = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* base = scratch + (long long)c * B.words();
  if (blockIdx.x == 0) {
    __shared__ int part[WARPS];
    __shared__ int nhub;
    int* start = base + B.o_start();
    int* hubs = base + B.o_hubs();
    if (threadIdx.x == 0) nhub = 0;
    __syncthreads();
    for (int d = threadIdx.x; d < B.n_out; d += THREADS) {
      int run = 0;
      for (int t0 = 0; t0 < B.T; t0 += UNROLL) {   // UNROLL loads in flight
        int n[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          n[u] = t0 + u < B.T ? base[(long long)(t0 + u) * B.n_out + d] : 0;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (t0 + u < B.T) base[(long long)(t0 + u) * B.n_out + d] = run;
          run += n[u];
        }
      }
      start[d] = run;
      if (run >= HUB) hubs[2 + atomicAdd(&nhub, 1)] = d;
    }
    __syncthreads();
    const int per = (B.n_out + THREADS - 1) / THREADS;
    const int lo = min(B.n_out, threadIdx.x * per);
    const int hi = min(B.n_out, lo + per);
    int sum = 0;
    for (int d = lo; d < hi; ++d) sum += start[d];
    int run = block_exclusive(sum, part);
    for (int d = lo; d < hi; ++d) {
      const int n = start[d];
      start[d] = run;
      run += n;
    }
    if (threadIdx.x == THREADS - 1) {
      start[B.n_out] = run;
      hubs[0] = nhub;
      hubs[1] = 0;
    }
    __syncthreads();
    // the hubs by live edges, most first (rows in order among equals): the
    // gather's blocks take the longest chains first
    for (int a = threadIdx.x; a < nhub; a += THREADS) {
      const int d = hubs[2 + a], n = start[d + 1] - start[d];
      int rank = 0;
      for (int b = 0; b < nhub; ++b) {
        const int d2 = hubs[2 + b], n2 = start[d2 + 1] - start[d2];
        rank += n2 > n || (n2 == n && d2 < d);
      }
      hubs[2 + B.HMAX + rank] = d;
    }
    return;
  }
  const int b = blockIdx.x - 1, nb = gridDim.x - 1;
  const uint32_t* mark = reinterpret_cast<const uint32_t*>(base + B.o_mark());
  uint32_t* flag = reinterpret_cast<uint32_t*>(base + B.o_flag());
  uint32_t* bad = reinterpret_cast<uint32_t*>(base + B.o_bad());
  uint32_t* poison = reinterpret_cast<uint32_t*>(base + B.o_poison());
  const long long np = (long long)B.n_out * B.FW;
  for (long long i = (long long)b * THREADS + threadIdx.x; i < np;
       i += (long long)nb * THREADS)
    poison[i] = 0;
  const T* hc = h + (long long)c * B.N * B.F;
  for (int wd = b * WARPS + warp; wd < B.NW; wd += nb * WARPS) {
    uint32_t m = 0;
    for (int t = lane; t < B.T; t += 32) m |= mark[(long long)t * B.NW + wd];
    m = __reduce_or_sync(FULL, m);
    uint32_t flagged = 0;
    while (m) {
      const int r = __ffs(m) - 1;
      m &= m - 1;
      const int s = 32 * wd + r;
      unsigned any = 0;
      for (int k = 0; k < B.FW; ++k) {
        const int f = 32 * k + lane;
        const float x =
            f < B.F ? elem::to_f32(hc[(long long)s * B.F + f]) : 0.0f;
        const unsigned bm = __ballot_sync(FULL, !isfinite(x));
        any |= bm;
        if (lane == 0) bad[(long long)s * B.FW + k] = bm;
      }
      if (any) flagged |= 1u << r;
    }
    if (lane == 0) flag[wd] = flagged;
  }
}

// 3. Per tile: its live edges sorted stably by destination (a block-wide
// radix sort of (destination, edge) in the tile's edge order; the dead
// slots keyed n_out, past every destination), each written as (src, w) at
// its bucket's start + the tile's offset in the bucket + its rank among
// the tile's edges to that destination; weight-0 edges from a flagged
// source OR its column mask into their destination's.
__global__ void __launch_bounds__(TB) bucket_place_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, int* __restrict__ scratch, Bucket B,
    int end_bit) {
  using Sort = cub::BlockRadixSort<unsigned, TB, TITEMS, int>;
  __shared__ typename Sort::TempStorage tmp;
  __shared__ unsigned tail[TB];
  const int c = blockIdx.y, t = blockIdx.x;
  int* base = scratch + (long long)c * B.words();
  int* cur = base + (long long)t * B.n_out;
  const int* start = base + B.o_start();
  const uint32_t* flag =
      reinterpret_cast<const uint32_t*>(base + B.o_flag());
  const uint32_t* bad = reinterpret_cast<const uint32_t*>(base + B.o_bad());
  uint32_t* poison = reinterpret_cast<uint32_t*>(base + B.o_poison());
  int2* pairs = reinterpret_cast<int2*>(base + B.o_pairs());
  const long long off = (long long)c * B.E;
  const int p0 = threadIdx.x * TITEMS;       // this thread's first slot
  unsigned key[TITEMS];
  int val[TITEMS];
#pragma unroll
  for (int k = 0; k < TITEMS; ++k) {
    const int e = t * TILE + p0 + k;
    int s = -1, d = -1;
    float we = 0.0f;
    if (e < B.E) {
      s = src[off + e];
      d = dst[off + e];
      we = w[off + e];
    }
    const bool in = static_cast<unsigned>(s) < static_cast<unsigned>(B.N) &&
                    static_cast<unsigned>(d) < static_cast<unsigned>(B.n_out);
    key[k] = in && we != 0.0f ? static_cast<unsigned>(d)
                              : static_cast<unsigned>(B.n_out);
    val[k] = e;
    if (in && we == 0.0f && bit(flag, s))
      for (int j = 0; j < B.FW; ++j) {
        const uint32_t m = bad[(long long)s * B.FW + j];
        if (m) atomicOr(&poison[(long long)d * B.FW + j], m);
      }
  }
  Sort(tmp).Sort(key, val, 0, end_bit);
  tail[threadIdx.x] = key[TITEMS - 1];
  __syncthreads();
  // the first of each destination's run turns the tile's offset into the
  // run's base (bucket start + offset - its sorted position)
#pragma unroll
  for (int k = 0; k < TITEMS; ++k) {
    const unsigned d = key[k];
    const unsigned prev =
        k ? key[k - 1] : (threadIdx.x ? tail[threadIdx.x - 1] : ~0u);
    if (d < static_cast<unsigned>(B.n_out) && prev != d)
      cur[d] = start[d] + cur[d] - (p0 + k);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TITEMS; ++k) {
    const unsigned d = key[k];
    if (d < static_cast<unsigned>(B.n_out)) {
      const long long e = off + val[k];
      pairs[cur[d] + p0 + k] = make_int2(src[e], __float_as_int(w[e]));
    }
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements of shared memory as fp32.
template <typename T>
__device__ __forceinline__ void lds4_as_f32(const uint8_t* p, float (&x)[4]) {
  if constexpr (std::is_same<T, float>::value) {
    lds<4>(reinterpret_cast<const float*>(p), x);
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    x[0] = __low2float(a); x[1] = __high2float(a);
    x[2] = __low2float(b); x[3] = __high2float(b);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One warp's output row, columns [col0, col0 + 128), four a lane: the
// row's bucket walked in edge order in stages of 8 edges; three stages of
// h rows in flight through a ring in shared memory (cp.async 16-byte
// pieces where VEC says rows and columns are 16-byte aligned, plain loads
// otherwise), each stage's sources and weights fetched with the stage
// three before it; a stage's values read into registers while the stage
// before it is summed, its weights four at a time; acc = __fadd_rn(acc,
// __fmul_rn(h, w)), NaN where the row's mask says, the row written once.
template <typename T, bool VEC>
__device__ __forceinline__ void gather(
    const T* __restrict__ hc, const int2* __restrict__ pairs,
    const uint32_t* __restrict__ poison, T* __restrict__ orow, int first,
    int deg, int col0, int F, int vec_o, uint8_t* ring, int lane) {
  constexpr int V = 4;                           // columns a lane
  constexpr int EPS = 8;                         // edges a stage
  constexpr int STAGES = 4;
  constexpr int EB = 32 * V * sizeof(T);         // bytes an edge's columns
  constexpr int SB = EPS * EB;                   // bytes a stage
  constexpr int CPE = EB / 16;                   // 16-byte pieces an edge
  constexpr int EPW = 32 / CPE;                  // edges a warp's copy
  constexpr int EPC = 16 / sizeof(T);            // elements a piece
  static_assert(STAGES * SB <= RING && 2 * STAGES * EPS * 8 <= PAIRS &&
                EPW * CPE == 32 && EPS % EPW == 0, "");
  int* ps = reinterpret_cast<int*>(ring + RING);              // [2S][EPS]
  float* pw = reinterpret_cast<float*>(ps + 2 * STAGES * EPS);  // [2S][EPS]
  const int nst = (deg + EPS - 1) / EPS;
  // this lane's piece of each edge it copies: edges lane / CPE + EPW q
  const int le = lane / CPE, col = col0 + (lane % CPE) * EPC;
  const bool mine = col < F;
  const T* hcol = hc + col;
  uint8_t* ldst = ring + le * EB + (lane % CPE) * 16;
  auto fetch_pairs = [&](int m) {
    const int p = m * EPS + lane, slot = (m % (2 * STAGES)) * EPS + lane;
    if (lane < EPS && p < deg) {
      cp_async4(ps + slot, &pairs[first + p].x);
      cp_async4(pw + slot, &pairs[first + p].y);
    }
  };
  auto fetch_rows = [&](int m) {
    if (m >= nst || !mine) return;
    const int* sp = ps + (m % (2 * STAGES)) * EPS + le;
    uint8_t* slot = ldst + (m % STAGES) * SB;
    const int n = deg - m * EPS - le;
#pragma unroll
    for (int q = 0; q < EPS / EPW; ++q) {
      if (EPW * q < n) {
        const T* g = hcol + (long long)sp[EPW * q] * F;
        uint8_t* s = slot + EPW * q * EB;
        if constexpr (VEC) {
          cp_async16(s, g);
        } else {
          T* st = reinterpret_cast<T*>(s);
#pragma unroll
          for (int j = 0; j < EPC; ++j)
            st[j] = col + j < F ? g[j] : elem::from_f32<T>(0.0f);
        }
      }
    }
  };
  auto load_stage = [&](int k, float (&x)[EPS][V]) {
    const uint8_t* s = ring + (k % STAGES) * SB + lane * V * sizeof(T);
#pragma unroll
    for (int e = 0; e < EPS; ++e) lds4_as_f32<T>(s + e * EB, x[e]);
  };
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  auto add = [&](const float (&x)[V], float w) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], w));
  };
  auto sum_stage = [&](int k, const float (&x)[EPS][V]) {
    const float* w = pw + (k % (2 * STAGES)) * EPS;
    const int n = min(EPS, deg - k * EPS);
    if (n == EPS) {
#pragma unroll
      for (int i = 0; i < EPS / 4; ++i) {
        const float4 w4 = reinterpret_cast<const float4*>(w)[i];
        add(x[4 * i], w4.x);
        add(x[4 * i + 1], w4.y);
        add(x[4 * i + 2], w4.z);
        add(x[4 * i + 3], w4.w);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPS; ++e)
        if (e < n) add(x[e], w[e]);
    }
  };
  // stage k: fetch stage k + STAGES - 1 (group k + STAGES - 1: its rows
  // and the pairs of stage k + 2 STAGES - 2; the slots they overwrite were
  // last read before the previous stage's __syncwarp), read stage k + 1
  // into registers, sum stage k
  auto step = [&](int k, const float (&cur)[EPS][V], float (&nxt)[EPS][V]) {
    fetch_rows(k + STAGES - 1);
    fetch_pairs(k + 2 * STAGES - 2);
    cp_async_commit();
    if (k + 1 < nst) {
      cp_async_wait<STAGES - 2>();
      __syncwarp();
      load_stage(k + 1, nxt);
    }
    sum_stage(k, cur);
  };
  for (int m = 0; m < STAGES - 1; ++m) fetch_pairs(m);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  for (int m = 0; m < STAGES - 1; ++m) {   // group m: stage m's rows, and
    fetch_rows(m);                         // stage m + STAGES - 1's pairs
    fetch_pairs(m + STAGES - 1);
    cp_async_commit();
  }
  float xa[EPS][V], xb[EPS][V];
  if (nst > 0) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    load_stage(0, xa);
  }
  for (int k = 0; k < nst; k += 2) {
    step(k, xa, xb);
    if (k + 1 < nst) step(k + 1, xb, xa);
  }
  cp_async_wait<0>();                  // no copy outlives the warp
  const int f = col0 + V * lane;
  const float nan = __int_as_float(0x7fffffff);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (f + j < F && ((poison[(f + j) / 32] >> ((f + j) % 32)) & 1u))
      acc[j] = nan;
  elem::store4(orow + f, F - f, vec_o, acc);
}

// A hub row's HW columns [col0, col0 + HW), by a whole block: warp 0 sums
// (a column a lane) while warps 1-3 copy. The row's bucket is walked in
// stages of 32 edges through a ring of HS stages in shared memory; at each
// stage boundary the copiers issue stage k + HD (cp.async 16-byte pieces
// where VEC says rows and columns are 16-byte aligned, plain loads
// otherwise) and the (src, w) pairs of stage k + 2 HD, and wait for stage
// k + 2; the summer reads stage k + 1 into registers (values and weights)
// while it adds stage k's, acc = __fadd_rn(acc, __fmul_rn(h, w)) in edge
// order; one barrier of the block's 128 threads a stage.
constexpr int HW = 8;                  // columns of a hub's block
constexpr int HD = 6;                  // stages of a hub's rows in flight
constexpr int HS = 8;                  // stages of a hub's ring
constexpr int HP = 2 * HD + 2;         // stages of its pairs kept
template <typename T, bool VEC>
__device__ __forceinline__ void gather_hub(
    const T* __restrict__ hc, const int2* __restrict__ pairs,
    const uint32_t* __restrict__ poison, T* __restrict__ orow, int first,
    int deg, int col0, int F, uint8_t* smem) {
  constexpr int EPS = 32;                        // edges a stage
  constexpr int EB = HW * sizeof(T);             // bytes an edge's columns
  constexpr int SB = EPS * EB;                   // bytes a stage
  constexpr int CPE = EB >= 16 ? EB / 16 : 1;    // 16-byte pieces an edge
  constexpr int PIECES = EPS * CPE;              // pieces a stage
  constexpr int EPC = 16 / sizeof(T);            // elements a piece
  constexpr int COPIERS = 32 * (GWARPS - 1);
  static_assert(EB % 16 == 0, "");
  static_assert(HS * SB + HP * EPS * 8 <= GATHER_SMEM && HD < HS, "");
  int* ps = reinterpret_cast<int*>(smem + HS * SB);           // [HP][EPS]
  float* pw = reinterpret_cast<float*>(ps + HP * EPS);        // [HP][EPS]
  const int nst = (deg + EPS - 1) / EPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = threadIdx.x - 32;                // copier index
  auto sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(32 * GWARPS)
                                : "memory"); };
  auto fetch_pairs = [&](int m) {                // copiers t < EPS
    const int p = m * EPS + t, slot = (m % HP) * EPS + t;
    if (t < EPS && p < deg) {
      cp_async4(ps + slot, &pairs[first + p].x);
      cp_async4(pw + slot, &pairs[first + p].y);
    }
  };
  auto fetch_rows = [&](int m) {                 // stage m's pairs landed
    if (m >= nst) return;
    const int n = min(EPS, deg - m * EPS);
#pragma unroll
    for (int q = t; q < PIECES; q += COPIERS) {
      const int e = q / CPE, piece = q % CPE;
      const int col = col0 + piece * EPC;
      if (e < n && col < F) {
        const T* g = hc + (long long)ps[(m % HP) * EPS + e] * F + col;
        uint8_t* s = smem + (m % HS) * SB + e * EB + piece * 16;
        if constexpr (VEC) {
          cp_async16(s, g);
        } else {
          T* st = reinterpret_cast<T*>(s);
#pragma unroll
          for (int j = 0; j < EPC; ++j)
            st[j] = col + j < F ? g[j] : elem::from_f32<T>(0.0f);
        }
      }
    }
  };
  // the summer reads stage k + 1 into registers while it sums stage k
  auto load = [&](int k, float (&x)[EPS], float4 (&w)[EPS / 4]) {
    const uint8_t* s = smem + (k % HS) * SB + (lane % HW) * sizeof(T);
#pragma unroll
    for (int e = 0; e < EPS; ++e)
      x[e] = elem::to_f32(*reinterpret_cast<const T*>(s + e * EB));
#pragma unroll
    for (int i = 0; i < EPS / 4; ++i)
      w[i] = reinterpret_cast<const float4*>(pw + (k % HP) * EPS)[i];
  };
  float acc = 0.0f;
  auto sum = [&](int k, const float (&x)[EPS], const float4 (&w)[EPS / 4]) {
    const int n = min(EPS, deg - k * EPS);
    if (n == EPS) {
#pragma unroll
      for (int i = 0; i < EPS / 4; ++i) {
        acc = __fadd_rn(acc, __fmul_rn(x[4 * i], w[i].x));
        acc = __fadd_rn(acc, __fmul_rn(x[4 * i + 1], w[i].y));
        acc = __fadd_rn(acc, __fmul_rn(x[4 * i + 2], w[i].z));
        acc = __fadd_rn(acc, __fmul_rn(x[4 * i + 3], w[i].w));
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPS; ++e) {
        const float4 q = w[e / 4];
        const float we = e % 4 == 0 ? q.x : e % 4 == 1 ? q.y
                         : e % 4 == 2 ? q.z : q.w;
        if (e < n) acc = __fadd_rn(acc, __fmul_rn(x[e], we));
      }
    }
  };
  // stage k: the copiers issue group k + HD (stage k + HD's rows, into the
  // slot of stage k + HD - HS, read before stage k - 1's barrier, and
  // stage k + 2 HD's pairs) and wait for stage k + 2's rows; the summer
  // reads stage k + 1 and sums stage k; then the barrier
  auto step = [&](int k, const float (&x)[EPS], const float4 (&w)[EPS / 4],
                  float (&nx)[EPS], float4 (&nw)[EPS / 4]) {
    if (warp == 0) {
      if (k + 1 < nst) load(k + 1, nx, nw);
      sum(k, x, w);
    } else {
      fetch_rows(k + HD);
      fetch_pairs(k + 2 * HD);
      cp_async_commit();
      cp_async_wait<HD - 2>();
    }
    sync();
  };
  if (warp) {                          // copiers: pairs of stages < HD,
    for (int m = 0; m < HD; ++m) fetch_pairs(m);
    cp_async_commit();
    cp_async_wait<0>();
  }
  sync();
  if (warp) {                          // group j: rows of stage j, pairs of
    for (int j = 0; j < HD; ++j) {     // stage j + HD
      fetch_rows(j);
      fetch_pairs(j + HD);
      cp_async_commit();
    }
    cp_async_wait<HD - 2>();           // stages 0 and 1's rows
  }
  sync();
  float xa[EPS], xb[EPS];
  float4 wa[EPS / 4], wb[EPS / 4];
  if (warp == 0 && nst > 0) load(0, xa, wa);
  for (int k = 0; k < nst; k += 2) {
    step(k, xa, wa, xb, wb);
    if (k + 1 < nst) step(k + 1, xb, wb, xa, wa);
  }
  if (warp) cp_async_wait<0>();        // no copy outlives the block
  const int f = col0 + lane;
  if (warp == 0 && lane < HW && f < F) {
    if ((poison[f / 32] >> (f % 32)) & 1u) acc = __int_as_float(0x7fffffff);
    orow[f] = elem::from_f32<T>(acc);
  }
}

// 4. The first `hub_blocks` blocks take (hub row, HW columns) items, the
// hubs' (HUB live edges or more) longest first, from a counter until none
// is left; then a warp per (output row, 128 columns), those of hub rows
// returning at once.
template <typename T>
__global__ void __launch_bounds__(32 * GWARPS) bucket_gather_kernel(
    const T* __restrict__ h, int* __restrict__ scratch, T* __restrict__ out,
    Bucket B, int hub_blocks, int vec_h, int vec_o) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* base = scratch + (long long)c * B.words();
  const int* start = base + B.o_start();
  int* hubs = base + B.o_hubs();
  const T* hc = h + (long long)c * B.N * B.F;
  const int2* pairs = reinterpret_cast<const int2*>(base + B.o_pairs());
  const uint32_t* poison =
      reinterpret_cast<const uint32_t*>(base + B.o_poison());
  T* oc = out + (long long)c * B.n_out * B.F;
  const int NT = (B.F + 127) / 128;
  if (blockIdx.x < hub_blocks) {
    __shared__ int item;
    const int slices = (B.F + HW - 1) / HW;
    const int items = hubs[0] * slices;
    for (;;) {
      if (threadIdx.x == 0) item = atomicAdd(&hubs[1], 1);
      __syncthreads();
      const int it = item;
      __syncthreads();
      if (it >= items) return;
      const int i = hubs[2 + B.HMAX + it / slices];
      const int col0 = HW * (it % slices);
      const int first = start[i], deg = start[i + 1] - first;
      if (vec_h)
        gather_hub<T, true>(hc, pairs, poison + (long long)i * B.FW,
                            oc + (long long)i * B.F, first, deg, col0, B.F,
                            smem);
      else
        gather_hub<T, false>(hc, pairs, poison + (long long)i * B.FW,
                             oc + (long long)i * B.F, first, deg, col0, B.F,
                             smem);
    }
  }
  const long long g = ((long long)blockIdx.x - hub_blocks) * GWARPS + warp;
  if (g >= (long long)B.n_out * NT) return;
  const int i = static_cast<int>(g % B.n_out);
  const int col0 = 128 * static_cast<int>(g / B.n_out);
  const int first = start[i], deg = start[i + 1] - first;
  if (deg >= HUB) return;              // a hub's columns: the blocks above
  if (vec_h)
    gather<T, true>(hc, pairs, poison + (long long)i * B.FW,
                    oc + (long long)i * B.F, first, deg, col0, B.F, vec_o,
                    smem + warp * WARP_SMEM, lane);
  else
    gather<T, false>(hc, pairs, poison + (long long)i * B.FW,
                     oc + (long long)i * B.F, first, deg, col0, B.F, vec_o,
                     smem + warp * WARP_SMEM, lane);
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
                  T* out, int* scratch, int C, int N, int n_out, int E, int F,
                  void* stream) {
  if (C == 0 || n_out == 0 || F == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bucket B(N, n_out, E, F);
  const int vec_h = (F * static_cast<int>(sizeof(T))) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const int vec_o = F % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  bucket_count_kernel<<<dim3(B.T, C), TB, 0, s>>>(src, dst, w, scratch, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rb = std::min(1024, std::max(1, (B.NW + WARPS - 1) / WARPS));
  bucket_scan_kernel<T><<<dim3(1 + rb, C), THREADS, 0, s>>>(h, scratch, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int end_bit = 32 - __builtin_clz(static_cast<unsigned>(n_out));
  bucket_place_kernel<<<dim3(B.T, C), TB, 0, s>>>(src, dst, w, scratch, B,
                                                   end_bit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = bucket_gather_kernel<T>;
  static std::atomic<unsigned long long> limit_set{0};
  const int e = hopper::smem_limit_once(
      reinterpret_cast<const void*>(kernel), GATHER_SMEM, limit_set);
  if (e) return e;
  // hub blocks: as many as can be resident (3 a SM), at most one an item
  const long long NT = (F + 127) / 128;
  const int hub_blocks = static_cast<int>(std::min<long long>(
      (long long)B.HMAX * ((F + HW - 1) / HW),
      3LL * std::max(1, hopper::sm_count())));
  const long long blocks =
      hub_blocks + ((long long)n_out * NT + GWARPS - 1) / GWARPS;
  kernel<<<dim3(static_cast<unsigned>(blocks), C), 32 * GWARPS, GATHER_SMEM,
           s>>>(h, scratch, out, B, hub_blocks, vec_h, vec_o);
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

// int32 words of scratch the bucket variant needs for C subgraphs of N
// source rows, n_out destinations, E edge slots and F columns.
long long scatter_gather_bucket_scratch_words(int C, int N, int n_out, int E,
                                              int F) {
  return (long long)C * Bucket(N, n_out, E, F).words();
}

// The bucket variant's edge slots a tile and live in-edges of a hub row.
int scatter_gather_bucket_tile() { return TILE; }
int scatter_gather_bucket_hub() { return HUB; }

// src/dst [C,E] int32, w [C,E] fp32, h [C,N,F] fp32 (_f32) or bf16 (_bf16),
// contiguous. The sort variant needs scatter_gather_block_cols(N, E, F) != 0,
// takes block_cols columns a block (128, 64 or 32; 0 =
// scatter_gather_block_cols(N, E, F)) and writes out [C,N,F]; the bucket
// variant takes any shape, writes out [C,n_out,F] (destinations in
// [0, n_out); edges to others are dropped) and takes `scratch` of
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
                              int N, int n_out, int E, int F, void* stream) {
  return launch_bucket<float>(src, dst, w, h, out, scratch, C, N, n_out, E, F,
                              stream);
}
int scatter_gather_bucket_bf16(const int* src, const int* dst,
                               const float* w, const elem::bf16* h,
                               elem::bf16* out, int* scratch, int C, int N,
                               int n_out, int E, int F, void* stream) {
  return launch_bucket<elem::bf16>(src, dst, w, h, out, scratch, C, N, n_out,
                                   E, F, stream);
}

}  // extern "C"
