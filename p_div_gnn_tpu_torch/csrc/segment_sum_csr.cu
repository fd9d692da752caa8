// Block-CSR segment sum into node tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// p_div_gnn_tpu/ops/scatter_pallas.py (launched by `pallas_segment_sum`).
// The rows are grouped into blocks of n_slots / n_blocks slots; block b
// feeds node tile block_tile[b] (sorted), and
//
//   out[t·tile + j] = Σ rows[s] over the slots s of tile t's blocks with
//                     rcv[s] == t·tile + j,
//
// accumulated in fp32 and written as (num_nodes, L) fp32. A slot whose
// receiver is -1 (or lies outside its block's tile) adds nothing. With
// `perm` set, slot s reads row perm[s] of the source stream (the sender
// gather's backward permutes its cotangent into the sender-major view
// this way, without a permuted copy in device memory).
//
// What bounds it on this card: bytes. It reads each slot's row once
// (L·4 bytes in fp32, L·2 in bf16) and its indices, and writes the output
// once; it does one add per element read, far below any compute rate.
//
// Design, in two launches:
// 1. `block_partial_kernel`: one CTA per block. The TPU grid runs in order
//    and accumulates a tile's blocks into one revisited output block; here
//    each block's CTA sums its slots into a (tile, L) fp32 accumulator in
//    shared memory and writes it out as the block's partial tile. Thread c
//    owns column c, so no atomics are needed and the sums run in slot
//    order. The sender view is grouped by sender tile but not sorted by
//    sender inside a tile, so a sum cannot stay in a register across the
//    block; a run of consecutive slots with the same receiver is summed in
//    a register before it is added to the shared tile. A CTA per block,
//    not per tile, keeps the work of a CTA bounded: the view's padding
//    edges all send from the batch's last node, so its last tile holds
//    ~1.7e4 slots at the flagship size against ~1.5e3 for the others.
// 2. `tile_merge_kernel`: out[t] = Σ partial[b] over tile t's blocks, in
//    block order. The result does not change from run to run.
// - Row reads are unrolled 32 deep so that many are in flight per thread.
// - Shared memory of kernel 1 is tile·L·4 bytes + 12·L (129.5 KB at tile
//   256, L 128): one CTA per SM. The partial tiles cost n_blocks·tile·L·4
//   bytes of scratch (45 MB at the flagship size), written and read once.
//
// The pair entry point `pdg_segment_sum_csr_pair` replaces the Pallas TPU
// kernel `_kernel_pair` of the same file (launched by
// `pallas_segment_sum_pair`, the backward of `ops/gather.py`'s
// `sender_gather_pair`): two fp32 streams a and b (read through the same
// `perm`) summed over one layout in one pass, into out_a and out_b. What
// bounds it: bytes, as above, twice over. Its design is the same two
// stages, with 2L threads per CTA (thread (s, c) owns column c of stream
// s, so each slot's two rows are read by one CTA) and each block's tile
// cut into parts of `part_rows` node rows: two (tile, L) fp32 accumulators
// would not fit in shared memory, and with parts of 64 rows (64 KB at L
// 128) three CTAs share an SM. A CTA reads the block's indices and only
// the rows whose receiver lies in its part, so every row is still read
// once. `pair_merge_kernel` then merges the partial tiles of both streams
// in block order. The register runs and the merge add in fp64: the
// batch's last node sends every padding slot of the receiver layout
// (~1.6e4 at the flagship size), and fp32 running sums over those put its
// sum at 0.78 of the 1e-4 check against the plain fp64 sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 32;  // row reads in flight per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// First index in the sorted array a[0, n) whose value is >= key.
__device__ __forceinline__ int64_t first_not_less(const int32_t* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void block_partial_kernel(
    const T* __restrict__ rows, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ rcv, const int32_t* __restrict__ block_tile,
    float* __restrict__ partial, int64_t n_src, int64_t L, int64_t tile, int64_t block) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x;  // == L: thread c owns column c
  int64_t* src_s = reinterpret_cast<int64_t*>(smem4);  // (nt,) source row per slot
  float* acc = reinterpret_cast<float*>(src_s + nt);    // (tile, L) accumulator
  int* rl_s = reinterpret_cast<int*>(acc + tile * L);   // (nt,) local row or -1

  const int c = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t node_lo = static_cast<int64_t>(block_tile[b]) * tile;
  const int64_t s_lo = b * block, s_hi = s_lo + block;

  for (int64_t r = 0; r < tile; ++r) acc[r * L + c] = 0.f;
  float run = 0.f;
  int run_rl = -1;
  for (int64_t base = s_lo; base < s_hi; base += nt) {
    __syncthreads();  // the previous stage's indices are consumed
    {
      const int64_t s = base + c;
      int rl = -1;
      int64_t src = 0;
      if (s < s_hi) {
        const int64_t r = rcv[s];
        src = perm != nullptr ? static_cast<int64_t>(perm[s]) : s;
        if (r >= node_lo && r < node_lo + tile && src >= 0 && src < n_src)
          rl = static_cast<int>(r - node_lo);
      }
      rl_s[c] = rl;
      src_s[c] = src;
    }
    __syncthreads();
    const int n = static_cast<int>(s_hi - base < nt ? s_hi - base : nt);
    for (int i0 = 0; i0 < n; i0 += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u;
        v[u] = (i < n && rl_s[i] >= 0) ? to_f(rows[src_s[i] * L + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u;
        const int rl = i < n ? rl_s[i] : -1;
        if (rl < 0) continue;
        if (rl != run_rl) {
          if (run_rl >= 0) acc[run_rl * L + c] += run;
          run = 0.f;
          run_rl = rl;
        }
        run += v[u];
      }
    }
  }
  if (run_rl >= 0) acc[run_rl * L + c] += run;
  // column c of acc was written by this thread only: no barrier needed
  float* out = partial + b * tile * L;
  for (int64_t r = 0; r < tile; ++r) out[r * L + c] = acc[r * L + c];
}

// out[t·tile + r][c] = Σ partial[b][r][c] over the blocks b of tile t, in
// block order; grid (n_tiles, tile / rows_per_cta), L threads.
__global__ void tile_merge_kernel(const float* __restrict__ partial,
                                  const int32_t* __restrict__ block_tile, int64_t n_blocks,
                                  float* __restrict__ out, int64_t L, int64_t tile,
                                  int64_t rows_per_cta) {
  const int64_t t = blockIdx.x;
  const int64_t b_lo = first_not_less(block_tile, n_blocks, t);
  const int64_t b_hi = first_not_less(block_tile, n_blocks, t + 1);
  const int c = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_cta;
  for (int64_t r = r0; r < r0 + rows_per_cta && r < tile; ++r) {
    float s = 0.f;
    for (int64_t b = b_lo; b < b_hi; ++b) s += partial[(b * tile + r) * L + c];
    out[(t * tile + r) * L + c] = s;
  }
}

// Two fp32 streams over one layout: CTA (b, p) sums the slots of block b
// whose receiver lies in node rows [p·part_rows, (p+1)·part_rows) of the
// block's tile into partial[s][b] (s = 0 for a, 1 for b); thread (s, c)
// owns column c of stream s. As in block_partial_kernel, a run of
// consecutive slots with the same receiver is summed in a register.
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
cudaError_t launch(const void* rows, const int32_t* perm, const int32_t* rcv,
                   const int32_t* block_tile, float* partial, float* out, int64_t n_src,
                   int64_t n_slots, int64_t L, int64_t num_nodes, int64_t tile,
                   int64_t n_blocks, size_t smem, cudaStream_t stream) {
  const int64_t n_tiles = num_nodes / tile;
  const int64_t block = n_slots / n_blocks;
  cudaError_t err = cudaFuncSetAttribute(
      block_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  block_partial_kernel<T><<<static_cast<unsigned>(n_blocks), static_cast<unsigned>(L), smem,
                            stream>>>(static_cast<const T*>(rows), perm, rcv, block_tile,
                                      partial, n_src, L, tile, block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((tile + MERGE_ROWS - 1) / MERGE_ROWS));
  tile_merge_kernel<<<grid, static_cast<unsigned>(L), 0, stream>>>(
      partial, block_tile, n_blocks, out, L, tile, MERGE_ROWS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the partial kernel needs (L threads).
int64_t pdg_segment_sum_csr_smem_bytes(int64_t L, int64_t tile) {
  return L * static_cast<int64_t>(sizeof(int64_t)) +
         tile * L * static_cast<int64_t>(sizeof(float)) +
         L * static_cast<int64_t>(sizeof(int));
}

// Launches the segment sum on `stream`. rows (n_src, L) is fp32 (bf16 == 0)
// or bf16 (bf16 == 1); perm (n_slots,) int32 or null; rcv (n_slots,) and
// block_tile (n_blocks,) int32; partial (n_blocks, tile, L) fp32 scratch;
// out (num_nodes, L) fp32. Returns a cudaError_t value (0 on success).
int pdg_segment_sum_csr(int bf16, const void* rows, const void* perm, const void* rcv,
                        const void* block_tile, void* partial, void* out, int64_t n_src,
                        int64_t n_slots, int64_t L, int64_t num_nodes, int64_t tile,
                        int64_t n_blocks, void* stream) {
  if (L < 1 || L > 1024 || tile <= 0 || num_nodes % tile != 0 || n_blocks <= 0 ||
      n_slots % n_blocks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(pdg_segment_sum_csr_smem_bytes(L, tile));
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* r = static_cast<const int32_t*>(rcv);
  const auto* bt = static_cast<const int32_t*>(block_tile);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(rows, p, r, bt, part, o, n_src, n_slots, L, num_nodes, tile,
                                   n_blocks, smem, s)
           : launch<float>(rows, p, r, bt, part, o, n_src, n_slots, L, num_nodes, tile,
                           n_blocks, smem, s);
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
