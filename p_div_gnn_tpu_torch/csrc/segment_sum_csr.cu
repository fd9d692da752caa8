// Segment sums over the block-CSR layouts for NVIDIA Hopper (sm_90a).
//
// `pdg_segment_sum_csr` replaces the Pallas TPU kernel `_kernel` of
// p_div_gnn_tpu/ops/scatter_pallas.py (launched by `pallas_segment_sum`):
//
//   out[n] = Σ rows[perm[s]] (rows[s] without perm) over the slots s with
//            rcv[s] == n,
//
// rows (n_src, L) fp32 or bf16, out (num_nodes, L) fp32. A slot whose
// receiver lies outside [0, num_nodes) (the layouts' -1 padding) or whose
// source row lies outside [0, n_src) adds nothing. The slots of one
// receiver must be consecutive: the receiver-major layout sorts each
// tile's slots by receiver, and the sender gathers' backward reads the
// sender view in the derived order `GraphBatch.snd_run_perm` /
// `snd_run_sorted` (each tile's slots stably sorted by sender, padding
// last), which is. On another order a receiver's later run would overwrite
// its earlier one, so the wrapper (ops/scatter_csr.py) checks the order
// once per layout tensor and raises instead of launching.
//
// What bounds it on this card: bytes. Each slot's row is read once (L·4
// bytes in fp32, L·2 in bf16) with its two indices, and each output row is
// written once; one add per element read is far below any compute rate.
//
// Design: a streaming segmented reduction, in two kernels and a memset.
// 1. `run_chunk_kernel`: one warp per chunk of 64 consecutive slots, four
//    warps a CTA, no shared memory: at 78 registers a thread, 6 resident
//    CTAs (24 warps) per SM.
//    Lane j holds columns 4j..4j+3 of a 128-column group, so a warp reads a
//    whole 512-byte fp32 row (256 bytes in bf16) with one 16-byte (8-byte)
//    load per lane. The chunk's receivers and source rows are loaded once,
//    two per lane, and broadcast with __shfl_sync; each unrolled step issues
//    the row loads of 8 slots before it adds any of them. A run of slots
//    with one receiver is summed in fp64 registers (the receiver is the
//    same for all lanes, so the branch at a run's end does not diverge) and
//    written once, rounded once, when it ends inside the chunk.
// 2. A run that crosses a chunk's edge is split there: each chunk writes
//    the piece of its first run (if the run began in an earlier chunk) and
//    of its last run (if it goes on into the next) as an fp64 row of a
//    scratch array, and a flag word saying which it wrote. Only these rows
//    are written, ~1 in 10 chunks at the flagship size outside the one long
//    run. `run_merge_kernel`: one CTA per chunk; the CTA of the chunk where
//    a split run begins finds the chunks the run covers (32 flags a
//    __ballot_sync), its four warps each sum every fourth piece in chunk
//    order, and the owner adds the run's first piece and the four sums in
//    that order and rounds once. So the receiver layout's padding node,
//    whose run is ~1.7e4 slots long in the sender view, costs 266 pieces
//    summed by four warps, not one warp's 1.7e4 slots.
// - Every sum is in a fixed order and no atomics are used: two calls give
//   bit-equal outputs. The fp64 sums put the result within one rounding of
//   the exact sum (the plain version's fp64 `index_add_`).
// - Nodes with no slot get 0 from a memset of out before the kernels.
// - ptxas (sm_90a, CUDA 12.8): run_chunk_kernel 78 registers in fp32, 72
//   in bf16, no shared memory; run_merge_kernel 54 registers and 4,112
//   bytes of shared memory; no spills (scripts/port_sass.py).
//
// The pair entry point `pdg_segment_sum_csr_pair` replaces the Pallas TPU
// kernel `_kernel_pair` of the same file (launched by
// `pallas_segment_sum_pair`, the backward of `ops/gather.py`'s
// `sender_gather_pair`): two fp32 streams a and b (read through the same
// `perm`) summed over one layout in one pass, into out_a and out_b. It
// takes any slot order within a block's tile. What bounds it: bytes, twice
// over. Design, in two launches: `pair_partial_kernel`, one CTA per (block,
// part of `part_rows` node rows of the block's tile), 2L threads (thread
// (s, c) owns column c of stream s, so each slot's two rows are read by one
// CTA), sums the block's slots whose receiver lies in its part into a
// shared (part_rows, L) fp32 accumulator per stream, a run of consecutive
// slots with the same receiver first in an fp64 register, and writes it as
// a partial tile; `pair_merge_kernel` merges the partial tiles of both
// streams in block order, in fp64. A slot whose receiver is -1 or lies
// outside its block's tile adds nothing. With parts of 64 rows (64 KB at L
// 128) three CTAs share an SM; the partial tiles cost
// 2·n_blocks·tile·L·4 bytes of scratch. The register runs and the merge add
// in fp64: the batch's last node sends every padding slot of the receiver
// layout (~1.6e4 at the flagship size), and fp32 running sums over those
// put its sum at 0.78 of the 1e-4 check against the plain fp64 sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 32;  // row reads in flight per thread (pair kernel)

// First index in the sorted array a[0, n) whose value is >= key.
__device__ __forceinline__ int64_t first_not_less(const int32_t* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int RUN_CHUNK = 64;    // slots per warp in run_chunk_kernel
constexpr int RUN_STEP = 8;      // row loads in flight per lane
constexpr int RUN_WARPS = 4;     // warps per CTA of both run kernels
constexpr int GROUP_COLS = 128;  // columns per warp: 32 lanes x 4
constexpr unsigned FULL = 0xffffffffu;
static_assert(RUN_CHUNK == 64 && RUN_CHUNK % RUN_STEP == 0, "two index words per lane");
// flag bits of a chunk: HEAD, its first run's piece was written (the run
// began in an earlier chunk); CONT, that run also goes on into the next
// chunk (it covers the whole chunk); TAIL, its last run began here and goes
// on into the next chunk, and its piece was written
enum { PIECE_HEAD = 1, PIECE_CONT = 2, PIECE_TAIL = 4 };

// Four consecutive values of a row as fp32 (16-byte load in fp32, 8-byte
// in bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The receiver of a slot, -1 where it adds nothing.
__device__ __forceinline__ int node_of(const int32_t* rcv, int64_t s, int64_t num_nodes) {
  const int r = rcv[s];
  return r >= 0 && r < num_nodes ? r : -1;
}

__device__ __forceinline__ void store4(double* p, const double (&a)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a[0], a[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(a[2], a[3]);
}

__device__ __forceinline__ void store4(float* p, const double (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(static_cast<float>(a[0]), static_cast<float>(a[1]),
                                              static_cast<float>(a[2]), static_cast<float>(a[3]));
}

// Warp (blockIdx.x·RUN_WARPS + warp) sums chunk c = slots [c·64, c·64 + 64)
// over columns [blockIdx.y·128, +128): complete runs into out, split runs'
// pieces into pieces[c][0] (first run) and pieces[c][1] (last run), and
// chunk c's flag word into kind[c].
template <typename T>
__global__ void __launch_bounds__(RUN_WARPS * 32) run_chunk_kernel(
    const T* __restrict__ rows, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ rcv, float* __restrict__ out, double* __restrict__ pieces,
    int32_t* __restrict__ kind, int64_t n_src, int64_t n_slots, int64_t L, int64_t num_nodes) {
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int64_t c = static_cast<int64_t>(blockIdx.x) * RUN_WARPS + threadIdx.x / 32;
  const int64_t n_chunks = (n_slots + RUN_CHUNK - 1) / RUN_CHUNK;
  if (c >= n_chunks) return;  // the whole warp
  const int64_t s0 = c * RUN_CHUNK;
  const int n = static_cast<int>(n_slots - s0 < RUN_CHUNK ? n_slots - s0 : RUN_CHUNK);
  const int64_t col = static_cast<int64_t>(blockIdx.y) * GROUP_COLS + 4 * lane;
  const bool col_ok = col < L;

  // the chunk's receivers and source rows (-1 where the slot adds
  // nothing): lane j holds slot j in word 0 and slot 32 + j in word 1
  int r_w[2], p_w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h * 32 + lane;
    r_w[h] = i < n ? node_of(rcv, s0 + i, num_nodes) : -1;
    const int64_t src = i < n ? (perm != nullptr ? static_cast<int64_t>(perm[s0 + i]) : s0 + i)
                              : -1;
    p_w[h] = src >= 0 && src < n_src ? static_cast<int>(src) : -1;
  }
  const int first_r = __shfl_sync(FULL, r_w[0], 0);
  const int last_r = __shfl_sync(FULL, n > 32 ? r_w[1] : r_w[0], (n - 1) % 32);
  const bool cont_in = first_r >= 0 && s0 > 0 && node_of(rcv, s0 - 1, num_nodes) == first_r;
  const bool cont_out =
      last_r >= 0 && s0 + n < n_slots && node_of(rcv, s0 + n, num_nodes) == last_r;

  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  int cur = first_r;
  bool first = true;  // cur is the chunk's first run
  int flags = 0;
  for (int i0 = 0; i0 < n; i0 += RUN_STEP) {
    const int r_h = i0 < 32 ? r_w[0] : r_w[1];
    const int p_h = i0 < 32 ? p_w[0] : p_w[1];
    float4 v[RUN_STEP];
    int r[RUN_STEP];
#pragma unroll
    for (int u = 0; u < RUN_STEP; ++u) {
      r[u] = __shfl_sync(FULL, r_h, (i0 + u) % 32);
      const int src = __shfl_sync(FULL, p_h, (i0 + u) % 32);
      v[u] = r[u] >= 0 && src >= 0 && col_ok ? load4(rows + static_cast<int64_t>(src) * L + col)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < RUN_STEP; ++u) {
      if (i0 + u >= n) break;
      if (r[u] != cur) {  // the run of cur ended inside the chunk
        if (cur >= 0 && col_ok) {
          if (first && cont_in) store4(pieces + (c * 2) * L + col, acc);
          else store4(out + static_cast<int64_t>(cur) * L + col, acc);
        }
        if (first && cont_in) flags |= PIECE_HEAD;
        cur = r[u];
        first = false;
        acc[0] = acc[1] = acc[2] = acc[3] = 0.0;
      }
      acc[0] += v[u].x;
      acc[1] += v[u].y;
      acc[2] += v[u].z;
      acc[3] += v[u].w;
    }
  }
  // the chunk's last run
  if (cur >= 0) {
    if (first && cont_in) {
      if (col_ok) store4(pieces + (c * 2) * L + col, acc);
      flags |= PIECE_HEAD | (cont_out ? PIECE_CONT : 0);
    } else if (cont_out) {
      if (col_ok) store4(pieces + (c * 2 + 1) * L + col, acc);
      flags |= PIECE_TAIL;
    } else if (col_ok) {
      store4(out + static_cast<int64_t>(cur) * L + col, acc);
    }
  }
  if (lane == 0 && blockIdx.y == 0) kind[c] = flags;
}

// CTA c (grid (n_chunks, column groups), RUN_WARPS warps): if chunk c
// holds the first piece of a split run, out[run's node] = that piece +
// the first-run pieces of the chunks the run goes on into, summed as
// Σ_w (Σ pieces j ≡ w mod RUN_WARPS) in that fixed order, rounded once.
__global__ void __launch_bounds__(RUN_WARPS * 32) run_merge_kernel(
    const double* __restrict__ pieces, const int32_t* __restrict__ kind,
    const int32_t* __restrict__ rcv, float* __restrict__ out, int64_t n_slots, int64_t L) {
  __shared__ double part[RUN_WARPS][GROUP_COLS];
  __shared__ int64_t last_s;
  const int64_t c = blockIdx.x;
  if (!(kind[c] & PIECE_TAIL)) return;  // the whole CTA
  const int64_t n_chunks = (n_slots + RUN_CHUNK - 1) / RUN_CHUNK;
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int64_t col = static_cast<int64_t>(blockIdx.y) * GROUP_COLS + 4 * lane;
  const bool col_ok = col < L;

  // the run ends in the first chunk after c without PIECE_CONT
  if (warp == 0) {
    int64_t base = c + 1;
    for (;;) {
      const int64_t k = base + lane;
      const bool stop = k >= n_chunks || !(kind[k] & PIECE_CONT);
      const unsigned ends = __ballot_sync(FULL, stop);
      if (ends != 0) {
        if (lane == 0) last_s = base + __ffs(static_cast<int>(ends)) - 1;
        break;
      }
      base += 32;
    }
  }
  __syncthreads();
  const int64_t last = last_s;  // chunks c+1 .. last hold the run's other pieces
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (col_ok) {
    for (int64_t k0 = c + 1 + warp; k0 <= last; k0 += 4 * RUN_WARPS) {
      double2 v[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t k = k0 + u * RUN_WARPS;
        const double2* p = reinterpret_cast<const double2*>(pieces + (k * 2) * L + col);
        v[u][0] = k <= last ? p[0] : make_double2(0.0, 0.0);
        v[u][1] = k <= last ? p[1] : make_double2(0.0, 0.0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[0] += v[u][0].x;
        acc[1] += v[u][0].y;
        acc[2] += v[u][1].x;
        acc[3] += v[u][1].y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = acc[j];
  __syncthreads();
  if (warp == 0 && col_ok) {
    const double* tail = pieces + (c * 2 + 1) * L + col;
    double sum[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sum[j] = tail[j];
      for (int w = 0; w < RUN_WARPS; ++w) sum[j] += part[w][4 * lane + j];
    }
    const int64_t s_last = (c + 1) * RUN_CHUNK - 1;  // a slot of the run
    store4(out + static_cast<int64_t>(rcv[s_last]) * L + col, sum);
  }
}

// Two fp32 streams over one layout: CTA (b, p) sums the slots of block b
// whose receiver lies in node rows [p·part_rows, (p+1)·part_rows) of the
// block's tile into partial[s][b] (s = 0 for a, 1 for b); thread (s, c)
// owns column c of stream s. A run of consecutive slots with the same
// receiver is summed in an fp64 register first.
__global__ void pair_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                    const int32_t* __restrict__ perm,
                                    const int32_t* __restrict__ rcv,
                                    const int32_t* __restrict__ block_tile,
                                    float* __restrict__ partial, int64_t n_src, int64_t L,
                                    int64_t tile, int64_t block, int64_t n_blocks,
                                    int64_t part_rows) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x;  // == 2L
  int64_t* src_s = reinterpret_cast<int64_t*>(smem4);  // (nt,) source row per slot
  float* acc = reinterpret_cast<float*>(src_s + nt);    // (2, part_rows, L) accumulators
  int* rl_s = reinterpret_cast<int*>(acc + 2 * part_rows * L);  // (nt,) local row or -1

  const int s = static_cast<int>(threadIdx.x / L);
  const int c = static_cast<int>(threadIdx.x % L);
  const float* rows = s ? b : a;
  float* acc_s = acc + s * part_rows * L;
  const int64_t bi = blockIdx.x;
  const int64_t row_lo = static_cast<int64_t>(blockIdx.y) * part_rows;
  const int64_t n_rows = tile - row_lo < part_rows ? tile - row_lo : part_rows;
  const int64_t node_lo = static_cast<int64_t>(block_tile[bi]) * tile + row_lo;
  const int64_t s_lo = bi * block, s_hi = s_lo + block;

  for (int64_t r = 0; r < n_rows; ++r) acc_s[r * L + c] = 0.f;
  double run = 0.0;
  int run_rl = -1;
  for (int64_t base = s_lo; base < s_hi; base += nt) {
    __syncthreads();  // the previous stage's indices are consumed
    {
      const int64_t sl = base + threadIdx.x;
      int rl = -1;
      int64_t src = 0;
      if (sl < s_hi) {
        const int64_t r = rcv[sl];
        src = perm != nullptr ? static_cast<int64_t>(perm[sl]) : sl;
        if (r >= node_lo && r < node_lo + n_rows && src >= 0 && src < n_src)
          rl = static_cast<int>(r - node_lo);
      }
      rl_s[threadIdx.x] = rl;
      src_s[threadIdx.x] = src;
    }
    __syncthreads();
    const int n = static_cast<int>(s_hi - base < nt ? s_hi - base : nt);
    for (int i0 = 0; i0 < n; i0 += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u;
        v[u] = (i < n && rl_s[i] >= 0) ? rows[src_s[i] * L + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u;
        const int rl = i < n ? rl_s[i] : -1;
        if (rl < 0) continue;
        if (rl != run_rl) {
          if (run_rl >= 0) acc_s[run_rl * L + c] += static_cast<float>(run);
          run = 0.0;
          run_rl = rl;
        }
        run += v[u];
      }
    }
  }
  if (run_rl >= 0) acc_s[run_rl * L + c] += static_cast<float>(run);
  // column c of acc_s was written by this thread only: no barrier needed
  float* out = partial + ((s * n_blocks + bi) * tile + row_lo) * L;
  for (int64_t r = 0; r < n_rows; ++r) out[r * L + c] = acc_s[r * L + c];
}

// out[z][t·tile + r][c] = Σ partial[z][b][r][c] over the blocks b of tile t,
// in block order (fp64), for both streams z; grid (n_tiles,
// tile / rows_per_cta, 2), L threads.
__global__ void pair_merge_kernel(const float* __restrict__ partial,
                                  const int32_t* __restrict__ block_tile, int64_t n_blocks,
                                  float* __restrict__ out, int64_t L, int64_t tile,
                                  int64_t rows_per_cta) {
  const int64_t t = blockIdx.x;
  const int64_t z = blockIdx.z;
  const int64_t num_nodes = static_cast<int64_t>(gridDim.x) * tile;
  const int64_t b_lo = first_not_less(block_tile, n_blocks, t);
  const int64_t b_hi = first_not_less(block_tile, n_blocks, t + 1);
  const float* pz = partial + z * n_blocks * tile * L;
  float* oz = out + z * num_nodes * L;
  const int c = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_cta;
  for (int64_t r = r0; r < r0 + rows_per_cta && r < tile; ++r) {
    double s = 0.0;
    for (int64_t bb = b_lo; bb < b_hi; ++bb) s += pz[(bb * tile + r) * L + c];
    oz[(t * tile + r) * L + c] = static_cast<float>(s);
  }
}

constexpr int64_t MERGE_ROWS = 16;  // output rows per merge CTA
// accumulator bytes of one pair_partial_kernel CTA, at most
constexpr int64_t PAIR_ACC_BYTES = 64 * 1024;

int64_t pair_part_rows(int64_t L, int64_t tile) {
  int64_t rows = PAIR_ACC_BYTES / (2 * L * static_cast<int64_t>(sizeof(float)));
  if (rows < 1) rows = 1;
  return rows < tile ? rows : tile;
}

template <typename T>
cudaError_t launch_runs(const void* rows, const int32_t* perm, const int32_t* rcv,
                        double* pieces, int32_t* kind, float* out, int64_t n_src,
                        int64_t n_slots, int64_t L, int64_t num_nodes, cudaStream_t stream) {
  const int64_t n_chunks = (n_slots + RUN_CHUNK - 1) / RUN_CHUNK;
  const unsigned groups = static_cast<unsigned>((L + GROUP_COLS - 1) / GROUP_COLS);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(num_nodes * L) * sizeof(float),
                                    stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n_chunks + RUN_WARPS - 1) / RUN_WARPS), groups);
  run_chunk_kernel<T><<<grid, RUN_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(rows), perm, rcv, out, pieces, kind, n_src, n_slots, L, num_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  run_merge_kernel<<<dim3(static_cast<unsigned>(n_chunks), groups), RUN_WARPS * 32, 0,
                     stream>>>(pieces, kind, rcv, out, n_slots, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots per chunk: the scratch of pdg_segment_sum_csr holds
// ceil(n_slots / this) chunks.
int64_t pdg_segment_sum_csr_chunk_slots() { return RUN_CHUNK; }

// Launches the segment sum on `stream`. rows (n_src, L) is fp32 (bf16 == 0)
// or bf16 (bf16 == 1), L a multiple of 4; perm (n_slots,) int32 or null;
// rcv (n_slots,) int32 with each receiver's slots consecutive (not
// checked here: the wrapper checks it); pieces
// (n_chunks, 2, L) fp64 and kind (n_chunks,) int32 scratch; out
// (num_nodes, L) fp32. Returns a cudaError_t value (0 on success).
int pdg_segment_sum_csr(int bf16, const void* rows, const void* perm, const void* rcv,
                        void* pieces, void* kind, void* out, int64_t n_src, int64_t n_slots,
                        int64_t L, int64_t num_nodes, void* stream) {
  if (L < 4 || L % 4 != 0 || n_slots < 1 || num_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* r = static_cast<const int32_t*>(rcv);
  auto* pc = static_cast<double*>(pieces);
  auto* k = static_cast<int32_t*>(kind);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_runs<__nv_bfloat16>(rows, p, r, pc, k, o, n_src, n_slots, L, num_nodes, s)
           : launch_runs<float>(rows, p, r, pc, k, o, n_src, n_slots, L, num_nodes, s);
  return static_cast<int>(err);
}

// Shared memory one CTA of the pair partial kernel needs (2L threads).
int64_t pdg_segment_sum_csr_pair_smem_bytes(int64_t L, int64_t tile) {
  return 2 * L * static_cast<int64_t>(sizeof(int64_t) + sizeof(int)) +
         2 * pair_part_rows(L, tile) * L * static_cast<int64_t>(sizeof(float));
}

// Launches the pair segment sum on `stream`. a and b (n_src, L) are fp32;
// perm (n_slots,) int32 or null; rcv (n_slots,) and block_tile (n_blocks,)
// int32; partial (2, n_blocks, tile, L) fp32 scratch; out (2, num_nodes, L)
// fp32, out[0] the sums of a and out[1] those of b. Returns a cudaError_t
// value (0 on success).
int pdg_segment_sum_csr_pair(const void* a, const void* b, const void* perm, const void* rcv,
                             const void* block_tile, void* partial, void* out, int64_t n_src,
                             int64_t n_slots, int64_t L, int64_t num_nodes, int64_t tile,
                             int64_t n_blocks, void* stream) {
  if (L < 1 || L > 512 || tile <= 0 || num_nodes % tile != 0 || n_blocks <= 0 ||
      n_slots % n_blocks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t part_rows = pair_part_rows(L, tile);
  const size_t smem = static_cast<size_t>(pdg_segment_sum_csr_pair_smem_bytes(L, tile));
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      pair_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* bt = static_cast<const int32_t*>(block_tile);
  auto* part = static_cast<float*>(partial);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((tile + part_rows - 1) / part_rows));
  pair_partial_kernel<<<grid, static_cast<unsigned>(2 * L), smem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(rcv), bt, part, n_src, L,
      tile, n_slots / n_blocks, n_blocks, part_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 mgrid(static_cast<unsigned>(num_nodes / tile),
                   static_cast<unsigned>((tile + MERGE_ROWS - 1) / MERGE_ROWS), 2);
  pair_merge_kernel<<<mgrid, static_cast<unsigned>(L), 0, st>>>(
      part, bt, n_blocks, static_cast<float*>(out), L, tile, MERGE_ROWS);
  return static_cast<int>(cudaGetLastError());
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
