// Device code shared by the three one-pass edge-step backwards: the fused3
// backward (fused_edge3_bwd.cu, #2), the v2 backward (fused_edge_bwd.cu, #6)
// and the pair-blocked backward (fused_edge2_bwd.cu, #8). It holds the
// split-weight ring of their tile kernels' tensor-core products, the
// preparation of their weights, and their weight grads: a weight-grad
// kernel that sums A[i]ᵀB[i] over a list of (A, B) stream pairs per weight
// grad, and the ordered reduce of its partials. An including source
// includes "mma_sm90.cuh" and "fused3_tile.cuh" first (a header includes no
// other local header). Everything here lives in an anonymous namespace.
//
// The weight grads Σ_i A[i]ᵀB[i] sum over every slot (~2.6e5 at the
// flagship size), which the TPU kernels sum into one block revisited by
// every grid step. Here the rows are cut into chunks (wgrad_chunks), and
// each weight-grad block is summed over a chunk in items of WG = 32 rows and
// one (A, B) pair: the tensor cores sum each k16 block of rows from 0 (in
// fp32 mode the six cross products of the three-term splits, bf16x6,
// smallest first), an item's two blocks are added in fp32, and that 32-row
// partial is added to an fp64 register accumulator (it rounds at the size
// of a few products, not of the running sum). `bwd_reduce_kernel` sums the
// per-chunk and the tile kernel's per-part partials in order in fp64 and
// rounds once: two calls give bit-equal weight grads. `bwd_wgrad_kernel_ws`
// forms the per-chunk partials at every width and dtype, warp-specialized on
// Hopper's wgmma (below); ptxas (sm_90a, CUDA 12.8), fp32 / bf16 streams:
// 134 / 128 registers at 384 threads, 222,272 / 87,104 bytes of dynamic
// shared memory, one CTA per SM, no spills; 12 / 2 HGMMA (wgmma m64n64k16)
// in the SASS. It replaced a lockstep mma.sync kernel (CTA per chunk, weight
// grad and 64-row block; the same sums in the same order, bit-equal), which
// took 0.9-2.5x its time (PERF.md §6).
// Every kernel of the pass has `bwd_wgrad_kernel`, `bwd_reduce_kernel` or
// `prepare_weights_kernel` in its name: the benchmark finds #2's shared
// sub-kernels by those substrings (perfbench/kernels/fused_edge3_bwd.json),
// so a kernel named otherwise would drop out of #2's roofline.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int WG = 32;           // rows of a weight-grad item (one fp32 partial)
constexpr int MAX_CHUNK = 8192;  // rows of a weight-grad chunk, at most
constexpr int MAX_STREAMS = 10;  // operand streams of a weight-grad launch
constexpr int MAX_PAIRS = 2;     // (A, B) pairs of a weight grad

// The split-weight ring of a tile kernel's tensor-core products: chunk q of
// the stream (KC rows of one of the NW weights in turn, NT terms, swizzled)
// goes to stage q & 1 by cp.async. acquire() waits for chunk q and starts
// chunk q + 1.
template <int NT, int L, int NW>
struct SplitRing {
  const uint16_t* wsplit;  // (NW, NT, L, L) bf16 terms
  uint16_t* ring;          // 2 stages of (NT, KC, L)
  int q;

  __device__ __forceinline__ void issue(int qq) {
    constexpr int CHUNKS = L / KC, ROW8 = L / 8, PER_TERM = KC * ROW8;
    const int w = (qq / CHUNKS) % NW, kc = qq % CHUNKS;
    uint16_t* dst = ring + (qq & 1) * NT * KC * L;
    for (int p = threadIdx.x; p < NT * PER_TERM; p += THREADS) {
      const int t = p / PER_TERM, r = (p % PER_TERM) / ROW8, c = (p % ROW8) * 8;
      cp_async16(dst + t * KC * L + swz<L>(r, c),
                 wsplit + (static_cast<int64_t>(w * NT + t) * L + kc * KC + r) * L + c);
    }
    cp_async_commit();
  }
  // One barrier a chunk: it publishes chunk q, and every thread has left
  // chunk q - 1, whose stage chunk q + 1 then takes.
  __device__ __forceinline__ const uint16_t* acquire() {
    cp_async_wait<0>();
    __syncthreads();
    issue(q + 1);
    return ring + (q & 1) * NT * KC * L;
  }
  __device__ __forceinline__ void release() { ++q; }
};

// Copies the NW split weights into shared memory (swizzled by row), where
// they stay resident: one cp.async group.
template <int NT, int L, int NW>
__device__ __forceinline__ void load_resident(uint16_t* dst, const uint16_t* wsplit) {
  for (int p = threadIdx.x; p < NW * NT * L * L / 8; p += THREADS) {
    const int r = p / (L / 8), c = (p % (L / 8)) * 8;  // row r of the stacked weights
    cp_async16(dst + (r / L) * L * L + swz<L>(r % L, c), wsplit + static_cast<int64_t>(r) * L + c);
  }
  cp_async_commit();
}

// One split weight: acc[a] += op[a] · W for a < NA (op[a] an (R, L) tile),
// W the ring's next weight, or (RES) resident weight w.
template <int NT, int L, int NA, int R, bool RES, int NW>
__device__ __forceinline__ void mma_weight(SplitRing<NT, L, NW>& ring, const uint16_t* res, int w,
                                           Frag<L, R>* const (&acc)[NA],
                                           const uint16_t* const (&op)[NA]) {
  if constexpr (RES) {
#pragma unroll 1
    for (int k0 = 0; k0 < L; k0 += KC)
      mma_chunk<NT, L, NA, false, R>(acc, op, res + (static_cast<int64_t>(w) * NT * L + k0) * L,
                                     L * L, k0);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < L; k0 += KC) {
      const uint16_t* wc = ring.acquire();
      mma_chunk<NT, L, NA, false, R>(acc, op, wc, KC * L, k0);
      ring.release();
    }
  }
}

struct Weights {
  const void* w[8];  // each (L, L) in the stream dtype
};

// wfma[w] = weight w (< n_fma) in fp32; wsplit[w - n_fma][t] = term t of
// weight w >= n_fma (< n_w), (L, L) row-major bf16 bits.
template <typename T, int NT>
__global__ void prepare_weights_kernel(const Weights ws, int n_fma, int n_w,
                                       float* __restrict__ wfma, uint16_t* __restrict__ wsplit,
                                       int64_t L) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t LL = L * L;
  if (idx >= n_w * LL) return;
  const int64_t w = idx / LL, i = idx % LL;
  const float v = to_f(static_cast<const T*>(ws.w[w])[i]);
  if (w < n_fma) {
    wfma[idx] = v;
    return;
  }
  uint32_t t[NT];
  split<NT>(v, t);
#pragma unroll
  for (int k = 0; k < NT; ++k) wsplit[((w - n_fma) * NT + k) * LL + i] = static_cast<uint16_t>(t[k]);
}

template <typename T, int NT>
cudaError_t prepare_weights(const Weights& ws, int n_fma, int n_w, float* wfma, uint16_t* wsplit,
                            int64_t L, cudaStream_t stream) {
  const int64_t n = n_w * L * L;
  prepare_weights_kernel<T, NT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      ws, n_fma, n_w, wfma, wsplit, L);
  return cudaGetLastError();
}

// How row i of a weight-grad operand stream is found.
enum StreamKind {
  ROW,     // row i
  AT_IDX,  // row idx[i], missing where idx[i] lies outside [0, n_idx)
};

struct WgradArgs {
  const void* src[MAX_STREAMS];  // (·, L) operand streams, stream dtype
  int kind[MAX_STREAMS];         // StreamKind of each
  const int32_t* idx;            // (n_rows,) the AT_IDX streams' rows, or null
  int64_t n_idx;                 // rows of an AT_IDX stream
  int n_mats;                    // weight grads
  int n_pairs[4];                // (A, B) stream pairs of each
  int pa[4][MAX_PAIRS], pb[4][MAX_PAIRS];
  double* wpart;                 // (n_chunks, n_mats, L, L)
  int64_t n_rows, chunk;
};

// Chunks of a weight-grad launch over n_rows rows for n_mats weight grads:
// at least 256 / n_mats (at L = 128 #2's 64 chunks of 8 CTAs and the v2's
// 128 of 4: ~4 waves on 132 SMs), and enough that a chunk has at most
// MAX_CHUNK rows.
inline int64_t wgrad_chunks(int64_t n_rows, int64_t n_mats) {
  const int64_t need = (n_rows + MAX_CHUNK - 1) / MAX_CHUNK;
  const int64_t least = 256 / n_mats;
  return need > least ? need : least;
}

// ---- The warp-specialized weight-grad kernel (wgmma) ----
//
// `bwd_wgrad_kernel_ws` forms a chunk's partials item by item, with the
// work split by role instead of run in lockstep. A job is one 64 x 64 block (rows 64·rb, columns 64·cb) of one
// weight grad; a CTA takes one or two jobs of one chunk, paired on the host
// (`ws_plan`) so that they share operand tiles, and the CTAs of a chunk are
// neighbours in the grid, so a row one CTA fetched is an L2 hit for the
// others. A tile is 64 columns (block b) of one operand stream; a stage is
// 16 rows of the CTA's tiles, an item two stages. Its 384 threads are:
// - warps 0-3, the splitters, which also fetch: each thread copies its own
//   values of every tile (2 runs of 4 a tile) WS_RAW - 1 stages ahead by
//   cp.async into its part of a ring of WS_RAW raw stages (zero-filled where
//   a row is missing), waits for its own copies of stage s, and splits them
//   into NT bf16 terms, once for both jobs, in wgmma's MN-major
//   128-byte-swizzled layout, into a ring of WS_SPLIT split stages. No other
//   thread reads a thread's raw values, so the raw ring has no barrier;
// - warps 4-7 and 8-11, one consumer warpgroup a job: for each item and
//   each (A, B) pair of its weight grad, the term products of each 16-row
//   block on wgmma m64n64k16 (both operands in shared memory, MN-major),
//   summed by the tensor cores from 0 in the order of mma_chunk; the two
//   blocks added in fp32, that 32-row partial added to an fp64 register
//   accumulator. The two warpgroups' MMAs queue on the tensor cores, so one's
//   fp64 adds run under the other's MMAs.
// The split ring hands stages on by mbarriers (full: the terms are in;
// empty: both warpgroups are done); no CTA-wide barrier after the set-up.
// Measured on the card (PERF.md §6): a producer warp with the tensor memory
// accelerator (16 x 64 boxes) and cp.async.bulk rows was slower (1.8-3.0
// ms a flagship #2 launch against 1.42), as were loads into registers
// (1.67-1.80: too little in flight).

constexpr int WS_ROWS = 16;       // rows of a stage: one k16 block; an item is two
constexpr int WS_COLS = 64;       // columns of a tile and of a job's block
constexpr int WS_TILE = WS_ROWS * WS_COLS;  // values of a tile in a stage
constexpr int WS_RAW = 3;         // raw stages: each splitter thread's copies in flight
constexpr int WS_SPLIT = 4;       // split stages: the consumers' item and the next
constexpr int WS_TILES = 6;       // tiles of a CTA, at most
constexpr int WS_JOBS = 2;        // jobs (consumer warpgroups) of a CTA
constexpr int WS_SPLITTERS = 4;   // splitter warps (one warpgroup)
constexpr int WS_THREADS = 32 * (WS_SPLITTERS + 4 * WS_JOBS);
static_assert(WS_TILE / 4 % (32 * WS_SPLITTERS) == 0, "whole float4s of a tile per splitter");
constexpr int WS_MAX_JOBS = 4 * 16;  // jobs of a chunk: 4 weight grads of 16 blocks at L = 256

// One CTA of a chunk: its tiles and its jobs; a job's pair p reads tiles
// ta[p] (A) and tb[p] (B).
struct WsCta {
  int8_t n_tiles, n_jobs;
  int8_t stream[WS_TILES], blk[WS_TILES];
  int8_t mat[WS_JOBS], rb[WS_JOBS], cb[WS_JOBS], n_pairs[WS_JOBS];
  int8_t ta[WS_JOBS][MAX_PAIRS], tb[WS_JOBS][MAX_PAIRS];
};
struct WsPlan {
  int n_ctas;
  WsCta cta[WS_MAX_JOBS];  // a CTA has one job at least
};

// The CTAs of a chunk: the jobs in order (weight grad, row block, column
// block), each paired with the first later free job with which it shares
// the most tiles (within WS_TILES); a job that shares none runs alone.
// With #2's four weight grads at L = 128: dW2 blocks in pairs along a row
// (6 tiles), dWe likewise (3), each dWu block with its dWv block (the same
// 4 tiles).
inline WsPlan ws_plan(const WgradArgs& a, int L) {
  const int nb = L / WS_COLS;
  struct Job { int mat, rb, cb; };
  Job jobs[WS_MAX_JOBS];
  int nj = 0;
  for (int m = 0; m < a.n_mats; ++m)
    for (int rb = 0; rb < nb; ++rb)
      for (int cb = 0; cb < nb; ++cb) jobs[nj++] = {m, rb, cb};
  // the tiles (stream, block) of a set of jobs, without repeats
  auto tiles_of = [&](const int* js, int n, int (&st)[2 * WS_TILES], int (&bl)[2 * WS_TILES]) {
    int nt = 0;
    auto add = [&](int s, int b) {
      for (int t = 0; t < nt; ++t)
        if (st[t] == s && bl[t] == b) return;
      st[nt] = s, bl[nt] = b, ++nt;
    };
    for (int k = 0; k < n; ++k) {
      const Job& j = jobs[js[k]];
      for (int p = 0; p < a.n_pairs[j.mat]; ++p) {
        add(a.pa[j.mat][p], j.rb);
        add(a.pb[j.mat][p], j.cb);
      }
    }
    return nt;
  };
  WsPlan plan{};
  bool used[WS_MAX_JOBS] = {};
  int st[2 * WS_TILES], bl[2 * WS_TILES];
  for (int i = 0; i < nj; ++i) {
    if (used[i]) continue;
    used[i] = true;
    int pick[2] = {i, -1};
    const int alone = tiles_of(pick, 1, st, bl);
    int best = -1, best_shared = 0;
    for (int k = i + 1; k < nj; ++k) {
      if (used[k]) continue;
      pick[1] = k;
      int one[1] = {k};
      const int other = tiles_of(one, 1, st, bl);
      const int both = tiles_of(pick, 2, st, bl);
      if (both <= WS_TILES && alone + other - both > best_shared) {
        best = k;
        best_shared = alone + other - both;
      }
    }
    pick[1] = best;
    const int n = best >= 0 ? 2 : 1;
    if (best >= 0) used[best] = true;
    WsCta& c = plan.cta[plan.n_ctas++];
    c.n_tiles = static_cast<int8_t>(tiles_of(pick, n, st, bl));
    for (int t = 0; t < c.n_tiles; ++t) {
      c.stream[t] = static_cast<int8_t>(st[t]);
      c.blk[t] = static_cast<int8_t>(bl[t]);
    }
    c.n_jobs = static_cast<int8_t>(n);
    for (int k = 0; k < n; ++k) {
      const Job& j = jobs[pick[k]];
      c.mat[k] = static_cast<int8_t>(j.mat);
      c.rb[k] = static_cast<int8_t>(j.rb);
      c.cb[k] = static_cast<int8_t>(j.cb);
      c.n_pairs[k] = static_cast<int8_t>(a.n_pairs[j.mat]);
      for (int p = 0; p < a.n_pairs[j.mat]; ++p)
        for (int t = 0; t < c.n_tiles; ++t) {
          if (st[t] == a.pa[j.mat][p] && bl[t] == j.rb) c.ta[k][p] = static_cast<int8_t>(t);
          if (st[t] == a.pb[j.mat][p] && bl[t] == j.cb) c.tb[k][p] = static_cast<int8_t>(t);
        }
    }
  }
  return plan;
}

// Shared memory of a warp-specialized weight-grad CTA: 1024 bytes of
// alignment, WS_SPLIT stages of WS_TILES tiles of NT bf16 terms, WS_RAW raw
// stages in the stream dtype, the split ring's mbarriers.
template <typename T, int NT>
constexpr int64_t wgrad_ws_smem_bytes() {
  return 1024 + WS_SPLIT * WS_TILES * NT * WS_TILE * 2 +
         WS_RAW * WS_TILES * WS_TILE * static_cast<int64_t>(sizeof(T)) + 2 * WS_SPLIT * 8;
}

// d (=, or += with `acc`) the term products of one 16-row block, A and B
// tiles of NT terms: the smallest first, as mma_chunk orders them.
template <int NT>
__device__ __forceinline__ void ws_block(float (&d)[32], const uint16_t* a_tile,
                                         const uint16_t* b_tile, int acc) {
#pragma unroll
  for (int tb = NT - 1; tb >= 0; --tb)
#pragma unroll
    for (int ta = NT - 1 - tb; ta >= 0; --ta) {
      if constexpr (keep(WITHOUT_WG_MMA))
        wgmma_64x64(d, wgmma_desc(a_tile + ta * WS_TILE), wgmma_desc(b_tile + tb * WS_TILE), acc);
      acc = 1;
    }
}

template <typename T, int NT, int L>
__global__ void __launch_bounds__(WS_THREADS, 1)
    bwd_wgrad_kernel_ws(const __grid_constant__ WgradArgs a, const __grid_constant__ WsPlan plan) {
  extern __shared__ float4 wsmem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(wsmem4);
  base += (1024 - (smem_addr(base) & 1023)) & 1023;  // the swizzle atoms' alignment
  uint16_t* split_s = reinterpret_cast<uint16_t*>(base);  // [WS_SPLIT][WS_TILES][NT] tiles
  T* raw_s = reinterpret_cast<T*>(split_s + WS_SPLIT * WS_TILES * NT * WS_TILE);
  uint64_t* split_full = reinterpret_cast<uint64_t*>(raw_s + WS_RAW * WS_TILES * WS_TILE);
  uint64_t* split_empty = split_full + WS_SPLIT;

  const WsCta& c = plan.cta[blockIdx.x];
  const int n_tiles = c.n_tiles, n_jobs = c.n_jobs;
  // the warp index through a shuffle: provably uniform in a warp, so the
  // roles' branches are not divergent paths to the compiler (which would
  // serialize the wgmma instructions in them)
  const int tid = static_cast<int>(threadIdx.x), lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int64_t ck = blockIdx.y;
  const int64_t lo = ck * a.chunk;
  const int64_t hi = lo + a.chunk < a.n_rows ? lo + a.chunk : a.n_rows;
  const int64_t n_items = hi > lo ? (hi - lo + WG - 1) / WG : 0;
  const int64_t n_stages = 2 * n_items;
  if (tid == 0) {
    for (int s = 0; s < WS_SPLIT; ++s) {
      mbar_init(split_full + s, 32 * WS_SPLITTERS);
      mbar_init(split_empty + s, 4 * n_jobs);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < WS_SPLITTERS) {
    // the splitters: thread t owns the same PER_TILE runs of 4 values of
    // every tile in every stage; a row is missing at or past hi, or where
    // its index lies outside the indexed stream. An indexed row's index is
    // read two stages before its copy.
    constexpr int PER_TILE = WS_TILE / 4 / (32 * WS_SPLITTERS);
    auto elem = [&](int k) { return (tid + k * 32 * WS_SPLITTERS) * 4; };  // in a tile
    auto indices = [&](int64_t s, int64_t (&ix)[PER_TILE]) {
#pragma unroll
      for (int k = 0; k < PER_TILE; ++k) {
        const int64_t i = lo + s * WS_ROWS + elem(k) / WS_COLS;
        ix[k] = a.idx != nullptr && i < hi ? a.idx[i] : -1;
      }
    };
    auto fetch = [&](int64_t s, const int64_t (&ix)[PER_TILE]) {
      if (keep(WITHOUT_WG_FETCH) && s < n_stages) {
        T* dst = raw_s + (s % WS_RAW) * WS_TILES * WS_TILE;
#pragma unroll
        for (int t = 0; t < WS_TILES; ++t) {
          if (t >= n_tiles) break;
          const int st = c.stream[t];
          const bool indexed = a.kind[st] == AT_IDX;
          const T* base = static_cast<const T*>(a.src[st]) + c.blk[t] * WS_COLS;
#pragma unroll
          for (int k = 0; k < PER_TILE; ++k) {
            const int e = elem(k);
            const int64_t i = lo + s * WS_ROWS + e / WS_COLS;
            const int64_t row = indexed ? ix[k] : i;
            const bool ok = indexed ? row >= 0 && row < a.n_idx : i < hi;
            cp_async_4_zfill<T>(dst + t * WS_TILE + e, base + (ok ? row * L + e % WS_COLS : 0), ok);
          }
        }
      }
      cp_async_commit();  // one group a stage, empty or not
    };
    int64_t ix0[PER_TILE], ix1[PER_TILE], ix2[PER_TILE];
    for (int s = 0; s < WS_RAW - 1; ++s) {
      indices(s, ix0);
      fetch(s, ix0);
    }
    indices(WS_RAW - 1, ix0);
    indices(WS_RAW, ix1);
#pragma unroll 1
    for (int64_t s = 0; s < n_stages; ++s) {
      indices(s + WS_RAW + 1, ix2);
      fetch(s + WS_RAW - 1, ix0);
#pragma unroll
      for (int k = 0; k < PER_TILE; ++k) ix0[k] = ix1[k], ix1[k] = ix2[k];
      const int ss = static_cast<int>(s % WS_SPLIT);
      cp_async_wait<WS_RAW - 1>();  // this thread's copies of stage s
      mbar_wait(split_empty + ss, static_cast<uint32_t>((s / WS_SPLIT) & 1) ^ 1u);
      const T* src = raw_s + (s % WS_RAW) * WS_TILES * WS_TILE;
      uint16_t* dst = split_s + ss * WS_TILES * NT * WS_TILE;
      if constexpr (keep(WITHOUT_WG_SPLIT)) {
        // every load of the stage goes out before the first split
        float4 v[WS_TILES][PER_TILE];
#pragma unroll
        for (int t = 0; t < WS_TILES; ++t)
#pragma unroll
          for (int k = 0; k < PER_TILE; ++k)
            v[t][k] = t < n_tiles ? load4(src + t * WS_TILE + elem(k))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < WS_TILES; ++t)
          if (t < n_tiles)
#pragma unroll
            for (int k = 0; k < PER_TILE; ++k)
              put4<NT, WS_COLS>(dst + t * NT * WS_TILE, WS_TILE, elem(k) / WS_COLS,
                                elem(k) % WS_COLS, v[t][k]);
      }
      fence_proxy_async();
      mbar_arrive(split_full + ss);
    }
    cp_async_wait<0>();
  } else {
    // a consumer warpgroup: job j's block over the chunk
    const int j = (warp - WS_SPLITTERS) / 4;
    if (j >= n_jobs) return;
    const int mat = c.mat[j], n_pairs = c.n_pairs[j];
    double acc[32];
    float x[32], y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0, x[i] = 0.f, y[i] = 0.f;
#pragma unroll 1
    for (int64_t it = 0; it < n_items; ++it) {
      const int64_t s0 = 2 * it;
      const int ss0 = static_cast<int>(s0 % WS_SPLIT), ss1 = static_cast<int>((s0 + 1) % WS_SPLIT);
      mbar_wait(split_full + ss0, static_cast<uint32_t>((s0 / WS_SPLIT) & 1));
      const uint16_t* st0 = split_s + ss0 * WS_TILES * NT * WS_TILE;
      const uint16_t* st1 = split_s + ss1 * WS_TILES * NT * WS_TILE;
#pragma unroll 1
      for (int p = 0; p < n_pairs; ++p) {
        const int ta = c.ta[j][p] * NT * WS_TILE, tb = c.tb[j][p] * NT * WS_TILE;
        wgmma_hold(x);
        wgmma_hold(y);
        wgmma_fence();
        // one fp32 partial per item: each block's term products summed by
        // the tensor cores from 0, the two blocks added in fp32; with one
        // term the second block's MMA adds to the first's itself
        ws_block<NT>(x, st0 + ta, st0 + tb, 0);
        if (p == 0) mbar_wait(split_full + ss1, static_cast<uint32_t>(((s0 + 1) / WS_SPLIT) & 1));
        if constexpr (NT > 1) ws_block<NT>(y, st1 + ta, st1 + tb, 0);
        else ws_block<NT>(x, st1 + ta, st1 + tb, 1);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(x);
        wgmma_hold(y);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[i] += static_cast<double>(NT > 1 ? x[i] + y[i] : x[i]);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(split_empty + ss0);
        mbar_arrive(split_empty + ss1);
      }
    }
    double* out = a.wpart + (ck * a.n_mats + mat) * L * L;
    const int64_t r0 = c.rb[j] * WS_COLS + (warp % 4) * 16 + lane / 4;
    const int64_t c0 = c.cb[j] * WS_COLS + 2 * (lane % 4);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<double2*>(out + (r0 + 8 * h) * L + c0 + 8 * jn) =
            make_double2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
  }
}

// Σ_k p[k·stride] for k < n in fp64, in order; the loads go out 8 at a time
// before they are added.
__device__ __forceinline__ double ordered_sum(const double* __restrict__ p, int64_t n,
                                              int64_t stride) {
  double s = 0.0;
  int64_t k = 0;
  for (; k + 8 <= n; k += 8) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[(k + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; k < n; ++k) s += p[k * stride];
  return s;
}

// wb = [the n_mats weight grads; db2; db0] (n_mats·L + 2, L) fp32: the
// per-chunk partials wpart (n_chunks, n_mats, L, L) and the per-part
// partials bpart (n_parts, 2, L) = [Σ dy1 + dy2, Σ dpre1 + dpre2] summed in
// order in fp64, rounded once.
__global__ void bwd_reduce_kernel(const double* __restrict__ wpart, int64_t n_chunks,
                                  int64_t n_mats, const double* __restrict__ bpart,
                                  int64_t n_parts, int64_t L, float* __restrict__ wb) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_w = n_mats * L * L;
  if (idx < n_w) {
    wb[idx] = static_cast<float>(ordered_sum(wpart + idx, n_chunks, n_w));
  } else if (idx < n_w + 2 * L) {
    const int64_t j = (idx - n_w) / L, c = (idx - n_w) % L;
    wb[idx] = static_cast<float>(ordered_sum(bpart + j * L + c, n_parts, 2 * L));
  }
}

// Launches the weight-grad and reduce kernels on `stream`, after a tile
// kernel has filled the scratch streams and bpart. The CTAs' plan depends
// only on the weight grads' pairs: it is made at the first launch of a
// contract at this (T, NT, L) and kept while the contract stays the same.
template <typename T, int NT, int L>
cudaError_t launch_wgrad_reduce(const WgradArgs& wa, int64_t n_chunks, const double* bpart,
                                int64_t n_parts, float* wb, cudaStream_t stream) {
  static_assert(wgrad_ws_smem_bytes<T, NT>() <= 232448, "fits an SM's 227 KB");
  const int smem = static_cast<int>(wgrad_ws_smem_bytes<T, NT>());
  cudaError_t err = cudaFuncSetAttribute(bwd_wgrad_kernel_ws<T, NT, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  struct Contract { int n_mats, n_pairs[4], pa[4][MAX_PAIRS], pb[4][MAX_PAIRS]; };
  Contract now{};
  now.n_mats = wa.n_mats;
  for (int m = 0; m < wa.n_mats; ++m) {
    now.n_pairs[m] = wa.n_pairs[m];
    for (int p = 0; p < wa.n_pairs[m]; ++p) now.pa[m][p] = wa.pa[m][p], now.pb[m][p] = wa.pb[m][p];
  }
  static thread_local Contract planned{};
  static thread_local WsPlan plan{};
  if (plan.n_ctas == 0 || std::memcmp(&now, &planned, sizeof now) != 0) {
    plan = ws_plan(wa, L);
    planned = now;
  }
  bwd_wgrad_kernel_ws<T, NT, L><<<dim3(static_cast<unsigned>(plan.n_ctas),
                                       static_cast<unsigned>(n_chunks)),
                                  WS_THREADS, smem, stream>>>(wa, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_out = (wa.n_mats * L + 2) * static_cast<int64_t>(L);
  bwd_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      wa.wpart, n_chunks, wa.n_mats, bpart, n_parts, L, wb);
  return cudaGetLastError();
}

}  // namespace
