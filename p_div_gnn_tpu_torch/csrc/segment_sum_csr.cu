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
// `sender_gather_pair` and the sender-side sums of the fused2 backward): two
// streams a and b (fp32 or bf16, read through the same `perm`) summed over
// one layout into out_a and out_b. It is the same streaming reduction over
// the same runs, twice: what bounds it is bytes, each slot's two rows read
// once and each output row written once. Both callers pass the sender view
// in run order, as #3's. Both streams go to one warp (NS = 2): it reads a
// chunk's indices once and keeps 2 x 8 rows in flight; one warp a stream
// (grid.z = 2) was 3-10 % slower on both callers' views in fp32 and bf16
// (PERF.md §6). The pieces of the split runs are kept per stream, the
// flag words once (they depend on the layout only); every sum is in a
// fixed order in fp64, so two calls give bit-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The rows of up to two streams (#3 sums one, the pair sum two).
template <typename T>
struct Streams {
  const T* rows[2];
};

// Warp (blockIdx.x·RUN_WARPS + warp) sums chunk c = slots [c·64, c·64 + 64)
// over columns [blockIdx.y·128, +128) of the NS streams: complete runs into
// out, split runs' pieces into pieces[c][0] (first run) and pieces[c][1]
// (last run), and chunk c's flag word into kind[c]. Stream k's out and
// pieces lie k·num_nodes·L and k·n_chunks·2·L elements after stream 0's.
template <typename T, int NS>
__global__ void __launch_bounds__(RUN_WARPS * 32) run_chunk_kernel(
    Streams<T> streams, const int32_t* __restrict__ perm,
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
  const T* rows[NS];
  float* outs[NS];
  double* pcs[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    rows[k] = streams.rows[k];
    outs[k] = out + k * num_nodes * L;
    pcs[k] = pieces + k * n_chunks * 2 * L;
  }

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

  double acc[NS][4] = {};
  int cur = first_r;
  bool first = true;  // cur is the chunk's first run
  int flags = 0;
  for (int i0 = 0; i0 < n; i0 += RUN_STEP) {
    const int r_h = i0 < 32 ? r_w[0] : r_w[1];
    const int p_h = i0 < 32 ? p_w[0] : p_w[1];
    float4 v[NS][RUN_STEP];
    int r[RUN_STEP];
#pragma unroll
    for (int u = 0; u < RUN_STEP; ++u) {
      r[u] = __shfl_sync(FULL, r_h, (i0 + u) % 32);
      const int src = __shfl_sync(FULL, p_h, (i0 + u) % 32);
      const bool ok = r[u] >= 0 && src >= 0 && col_ok;
#pragma unroll
      for (int k = 0; k < NS; ++k)
        v[k][u] = ok ? load4(rows[k] + static_cast<int64_t>(src) * L + col)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < RUN_STEP; ++u) {
      if (i0 + u >= n) break;
      if (r[u] != cur) {  // the run of cur ended inside the chunk
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          if (cur >= 0 && col_ok) {
            if (first && cont_in) store4(pcs[k] + (c * 2) * L + col, acc[k]);
            else store4(outs[k] + static_cast<int64_t>(cur) * L + col, acc[k]);
          }
          acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0;
        }
        if (first && cont_in) flags |= PIECE_HEAD;
        cur = r[u];
        first = false;
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        acc[k][0] += v[k][u].x;
        acc[k][1] += v[k][u].y;
        acc[k][2] += v[k][u].z;
        acc[k][3] += v[k][u].w;
      }
    }
  }
  // the chunk's last run
  if (cur >= 0) {
    if (first && cont_in) flags |= PIECE_HEAD | (cont_out ? PIECE_CONT : 0);
    else if (cont_out) flags |= PIECE_TAIL;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (!col_ok) continue;
      if (first && cont_in) store4(pcs[k] + (c * 2) * L + col, acc[k]);
      else if (cont_out) store4(pcs[k] + (c * 2 + 1) * L + col, acc[k]);
      else store4(outs[k] + static_cast<int64_t>(cur) * L + col, acc[k]);
    }
  }
  if (lane == 0 && blockIdx.y == 0) kind[c] = flags;
}

// CTA c (grid (n_chunks, column groups, streams), RUN_WARPS warps): if
// chunk c holds the first piece of a split run, out[run's node] = that
// piece + the first-run pieces of the chunks the run goes on into, summed
// as Σ_w (Σ pieces j ≡ w mod RUN_WARPS) in that fixed order, rounded once;
// for stream blockIdx.z, whose out and pieces lie as run_chunk_kernel
// lays them.
__global__ void __launch_bounds__(RUN_WARPS * 32) run_merge_kernel(
    const double* __restrict__ pieces, const int32_t* __restrict__ kind,
    const int32_t* __restrict__ rcv, float* __restrict__ out, int64_t n_slots, int64_t L,
    int64_t num_nodes) {
  __shared__ double part[RUN_WARPS][GROUP_COLS];
  __shared__ int64_t last_s;
  const int64_t c = blockIdx.x;
  if (!(kind[c] & PIECE_TAIL)) return;  // the whole CTA
  const int64_t n_chunks = (n_slots + RUN_CHUNK - 1) / RUN_CHUNK;
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int64_t col = static_cast<int64_t>(blockIdx.y) * GROUP_COLS + 4 * lane;
  const bool col_ok = col < L;
  pieces += static_cast<int64_t>(blockIdx.z) * n_chunks * 2 * L;
  out += static_cast<int64_t>(blockIdx.z) * num_nodes * L;

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

// The run kernels over the NS streams of `streams` (1 or 2): the memset of
// out, run_chunk_kernel, run_merge_kernel.
template <typename T, int NS>
cudaError_t launch_runs(Streams<T> streams, const int32_t* perm, const int32_t* rcv,
                        double* pieces, int32_t* kind, float* out, int64_t n_src,
                        int64_t n_slots, int64_t L, int64_t num_nodes, cudaStream_t stream) {
  const int64_t n_chunks = (n_slots + RUN_CHUNK - 1) / RUN_CHUNK;
  const unsigned groups = static_cast<unsigned>((L + GROUP_COLS - 1) / GROUP_COLS);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(NS * num_nodes * L) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n_chunks + RUN_WARPS - 1) / RUN_WARPS), groups);
  run_chunk_kernel<T, NS><<<grid, RUN_WARPS * 32, 0, stream>>>(
      streams, perm, rcv, out, pieces, kind, n_src, n_slots, L, num_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  run_merge_kernel<<<dim3(static_cast<unsigned>(n_chunks), groups, NS), RUN_WARPS * 32, 0,
                     stream>>>(
      pieces, kind, rcv, out, n_slots, L, num_nodes);
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
      bf16 ? launch_runs<__nv_bfloat16, 1>({{static_cast<const __nv_bfloat16*>(rows), nullptr}},
                                           p, r, pc, k, o, n_src, n_slots, L, num_nodes, s)
           : launch_runs<float, 1>({{static_cast<const float*>(rows), nullptr}}, p, r, pc, k, o,
                                   n_src, n_slots, L, num_nodes, s);
  return static_cast<int>(err);
}

// Launches the pair segment sum on `stream`: a and b (n_src, L) both fp32
// (bf16 == 0) or both bf16 (bf16 == 1), L a multiple of 4; perm, rcv as
// for pdg_segment_sum_csr; pieces (2, n_chunks, 2, L) fp64 and kind
// (n_chunks,) int32 scratch; out (2, num_nodes, L) fp32, out[0] the sums
// of a and out[1] those of b. Returns a cudaError_t value (0 on success).
int pdg_segment_sum_csr_pair(int bf16, const void* a, const void* b, const void* perm,
                             const void* rcv, void* pieces, void* kind, void* out,
                             int64_t n_src, int64_t n_slots, int64_t L, int64_t num_nodes,
                             void* stream) {
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
      bf16 ? launch_runs<__nv_bfloat16, 2>(
                 {{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b)}},
                 p, r, pc, k, o, n_src, n_slots, L, num_nodes, s)
           : launch_runs<float, 2>({{static_cast<const float*>(a), static_cast<const float*>(b)}},
                                   p, r, pc, k, o, n_src, n_slots, L, num_nodes, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
