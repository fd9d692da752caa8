// Pair-blocked fused edge-step forward ("fused2") for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step2_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched by `_step2_forward` through
// `fused_edge_step2`). The edge slots are in the pair-blocked layout
// (graphs/batching.py::blockify_edges_pair): grouped by (receiver tile,
// sender tile), each group padded to whole edge blocks, receiver-tile-major;
// block b names its receiver tile block_tile[b] and its sender tile
// block_snd_tile[b]. Given the hoisted node projections u = x·Wu and
// v = x·Wv, for every edge slot i of block b with receiver r and sender s:
//
//   u_r = u[r] if r lies in block_tile[b], else 0        (v_r likewise)
//   u_s = u[s] if s lies in block_snd_tile[b], else 0    (v_s likewise)
//   ep    = e[i]·We
//   z_msg = relu(relu(((u_r + v_s) + ep) + b0)·W2 + b2) · mask_i
//   z_upd = relu(relu(((v_r + u_s) + ep) + b0)·W2 + b2) · mask_i
//
// and it writes z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
// R[r] = Σ z_msg over the slots into r that lie in their block's receiver
// tile, and M (8, L) fp32 holding Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four
// zero rows. mask_i = 0 where edge_gid[i] >= n_graphs (padding slots). The
// in-tile rules are the TPU kernel's one-hot contractions, which read zero
// for an endpoint outside the block's tile; the layout never makes one.
//
// What bounds it on this card: 3 L×L products per real edge slot (e·We,
// shared by both evaluations, then h·W2 twice), 2·3·L² flops per slot,
// against ~1 KB of streamed bytes per slot in fp32 (e in, z_upd out; both
// endpoint rows are read from the node projections, which sit in L2):
// operations bound it in fp32, bytes in bf16 (against the tensor-core
// rate).
//
// Design (the v2 forward's, fused_edge_fwd.cu, on this layout):
// - One CTA per receiver tile walks the tile's blocks (block_tile is sorted;
//   a binary search finds the run), 32 slots at a time, with 2L threads:
//   thread (p, c) owns column c of path p (p = 0 the messages, p = 1 the
//   edge update). The shared e·We of a chunk is formed half by each path.
// - Both endpoint rows are read directly from u and v (the TPU kernel's
//   one-hot gather matmuls have no place here); the sender row is read at
//   the slot's sender, with no streamed sender gather.
// - Padding: about half of the layout's slots pad their group to a whole
//   block, and they sit at the end of each group. A chunk of only padding
//   slots writes its zero rows of z_upd and skips its products; it would
//   add exact zeros to R and M.
// - R: a receiver tile's slots are sorted by receiver within each (receiver
//   tile, sender tile) group and restart at the next group, so one receiver
//   is met in up to ~4 runs. The message path's thread c keeps the running
//   fp64 sum of its column for the current receiver in a register and adds
//   it to an fp64 scratch row of the tile (zeroed by this CTA, which is its
//   only writer) when the receiver changes; after the tile's last block it
//   rounds the tile's rows once into R. R is the correctly rounded sum, as
//   the plain version's fp64 segment sum gives it, with no atomics.
// - M: each path's thread c sums its column's z and z² over the tile in
//   fp64 into per-tile partials; a one-CTA kernel sums the partials in tile
//   order and rounds once. The result does not change from run to run.
// - Rounding: each product is one FMA chain over k in order, as a GEMM
//   computes it, and the first-layer sum is grouped as the plain "xla"
//   Processor (and the TPU kernel) groups it, ((u_r + v_s) + ep) + b0.
// - Precision: fp32 FMA only, no TF32. In bf16 mode the operands are bf16
//   with fp32 accumulation, h = relu(pre) is rounded to bf16 before ·W2, R
//   sums the bf16-rounded z_msg and M the unrounded fp32 z, where the JAX
//   package rounds (`_step2_kernel`).

#include "edge_common.cuh"

namespace {

constexpr int EC = 32;  // edge slots staged per chunk
constexpr int HALF = EC / 2;

template <typename T>
__global__ void __launch_bounds__(512) pair_fwd_tile_kernel(
    const T* __restrict__ proj_u, const T* __restrict__ proj_v, const T* __restrict__ e,
    const int32_t* __restrict__ rcv, const int32_t* __restrict__ snd,
    const int32_t* __restrict__ gid, const int32_t* __restrict__ block_tile,
    const int32_t* __restrict__ block_snd_tile, const T* __restrict__ we,
    const T* __restrict__ w2, const T* __restrict__ b0, const T* __restrict__ b2,
    T* __restrict__ z_upd, float* __restrict__ R, double* __restrict__ r64,
    double* __restrict__ mpart, int64_t L, int64_t tile, int64_t block, int64_t n_blocks,
    int64_t n_graphs) {
  extern __shared__ float4 smem4[];
  float* es = reinterpret_cast<float*>(smem4);  // (EC, L) e rows
  float* eps = es + EC * L;                     // (EC, L) e·We
  float* hs = eps + EC * L;                     // (2, EC, L) h of each path
  int* rl_s = reinterpret_cast<int*>(hs + 2 * EC * L);  // (EC,) local receiver or -1
  int* sg_s = rl_s + EC;                                // (EC,) sender row or -1
  float* mk_s = reinterpret_cast<float*>(sg_s + EC);    // (EC,) mask

  // blockDim.x == 2L: thread (path, c) owns column c of one path; the
  // messages read u at the receiver and v at the sender, the edge update
  // the other way round
  const int path = static_cast<int>(threadIdx.x / L);
  const int c = static_cast<int>(threadIdx.x % L);
  const T* a_r = path ? proj_v : proj_u;
  const T* a_s = path ? proj_u : proj_v;
  float* h_own = hs + path * EC * L;
  const int64_t t = blockIdx.x;
  const int64_t node_lo = t * tile;
  const int64_t e_lo = first_not_less(block_tile, n_blocks, t) * block;
  const int64_t e_hi = first_not_less(block_tile, n_blocks, t + 1) * block;
  double* r64_tile = r64 + node_lo * L;

  if (path == 0)
    for (int64_t rl = 0; rl < tile; ++rl) r64_tile[rl * L + c] = 0.0;

  const float b0c = to_f(b0[c]);
  const float b2c = to_f(b2[c]);
  double s_z = 0.0, s_z2 = 0.0;  // this path's moment partials
  double run = 0.0;              // message path: R of the current receiver
  int run_rl = -1;

  for (int64_t base = e_lo; base < e_hi; base += EC) {
    for (int i = threadIdx.x; i < EC; i += blockDim.x) {
      const int64_t ei = base + i;
      int rl = -1, sg = -1;
      float m = 0.f;
      if (ei < e_hi) {
        const int64_t r = rcv[ei];
        if (r >= node_lo && r < node_lo + tile) rl = static_cast<int>(r - node_lo);
        const int64_t s = snd[ei];
        const int64_t s_lo = static_cast<int64_t>(block_snd_tile[ei / block]) * tile;
        if (s >= s_lo && s < s_lo + tile) sg = static_cast<int>(s);
        m = gid[ei] < n_graphs ? 1.f : 0.f;
      }
      rl_s[i] = rl;
      sg_s[i] = sg;
      mk_s[i] = m;
    }
    __syncthreads();
    bool live = false;
    for (int i = 0; i < EC; ++i) live = live || mk_s[i] != 0.f;
    if (!live) {  // padding only: zero rows of z_upd, nothing to add
      if (path)
        for (int i = 0; i < EC && base + i < e_hi; ++i) z_upd[(base + i) * L + c] = from_f<T>(0.f);
      __syncthreads();  // mk_s is restaged next chunk
      continue;
    }
    for (int i = path; i < EC; i += 2) {
      const int64_t ei = base + i;
      es[i * L + c] = ei < e_hi ? to_f(e[ei * L + c]) : 0.f;
    }
    __syncthreads();

    // e·We of the chunk: each path forms half of the slots
    {
      float ep[HALF];
      rows_times_w<T, HALF>(es + path * HALF * L, we, L, c, ep);
#pragma unroll
      for (int i = 0; i < HALF; ++i) eps[(path * HALF + i) * L + c] = ep[i];
    }
    __syncthreads();

    // h = relu(((a_r + a_s) + ep) + b0), grouped as the plain path groups it
#pragma unroll 4
    for (int i = 0; i < EC; ++i) {
      const int rl = rl_s[i];
      const int sg = sg_s[i];
      const float ar = rl >= 0 ? to_f(a_r[(node_lo + rl) * L + c]) : 0.f;
      const float as = sg >= 0 ? to_f(a_s[static_cast<int64_t>(sg) * L + c]) : 0.f;
      h_own[i * L + c] = round_sd<T>(fmaxf(((ar + as) + eps[i * L + c]) + b0c, 0.f));
    }
    __syncthreads();

    // y = h·W2 of this path's slots
    float y[EC];
    rows_times_w<T, EC>(h_own, w2, L, c, y);
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      const float z = fmaxf(y[i] + b2c, 0.f) * mk_s[i];
      s_z += z;
      s_z2 += static_cast<double>(z) * z;
      if (path) {
        if (ei < e_hi) z_upd[ei * L + c] = from_f<T>(z);
        continue;
      }
      const int rl = rl_s[i];
      if (rl < 0) continue;
      if (rl != run_rl) {
        if (run_rl >= 0) r64_tile[run_rl * L + c] += run;
        run = 0.0;
        run_rl = rl;
      }
      run += round_sd<T>(z);
    }
    __syncthreads();  // es / eps / hs / rl_s / sg_s / mk_s are restaged next chunk
  }

  if (path == 0) {
    if (run_rl >= 0) r64_tile[run_rl * L + c] += run;
    for (int64_t rl = 0; rl < tile; ++rl)
      R[(node_lo + rl) * L + c] = static_cast<float>(r64_tile[rl * L + c]);
  }
  double* mp = mpart + t * 4 * L;
  mp[(2 * path) * L + c] = s_z;
  mp[(2 * path + 1) * L + c] = s_z2;
}

template <typename T>
cudaError_t launch(const void* proj_u, const void* proj_v, const void* e, const int32_t* rcv,
                   const int32_t* snd, const int32_t* gid, const int32_t* block_tile,
                   const int32_t* block_snd_tile, const void* we, const void* w2,
                   const void* b0, const void* b2, void* z_upd, float* R, double* r64,
                   double* mpart, float* M, int64_t n_nodes, int64_t n_edges, int64_t L,
                   int64_t tile, int64_t n_blocks, int64_t n_graphs, size_t smem,
                   cudaStream_t stream) {
  const int64_t n_tiles = n_nodes / tile;
  const int64_t block = n_edges / n_blocks;
  cudaError_t err = cudaFuncSetAttribute(pair_fwd_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  pair_fwd_tile_kernel<T><<<static_cast<unsigned>(n_tiles), static_cast<unsigned>(2 * L), smem,
                            stream>>>(
      c(proj_u), c(proj_v), c(e), rcv, snd, gid, block_tile, block_snd_tile, c(we), c(w2),
      c(b0), c(b2), static_cast<T*>(z_upd), R, r64, mpart, L, tile, block, n_blocks, n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_moments_kernel<<<1, 256, 0, stream>>>(mpart, n_tiles, L, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the tile kernel needs.
int64_t pdg_fused_edge2_smem_bytes(int64_t L) {
  return 4 * EC * L * static_cast<int64_t>(sizeof(float)) +
         EC * static_cast<int64_t>(2 * sizeof(int) + sizeof(float));
}

// Launches the forward on `stream`. Pointers are device pointers; proj_u,
// proj_v (n_nodes, L), e, z_upd (n_edges, L) and the weights are fp32
// (bf16 == 0) or bf16 (bf16 == 1); rcv, snd, gid (n_edges,), block_tile
// and block_snd_tile (n_blocks,) are int32; R (n_nodes, L) and M (8, L) are
// fp32 and written whole; r64 (n_nodes, L) and mpart (n_nodes/tile, 4, L)
// are fp64 scratch. Returns a cudaError_t value (0 on success).
int pdg_fused_edge2_fwd(int bf16, const void* proj_u, const void* proj_v, const void* e,
                        const void* rcv, const void* snd, const void* gid,
                        const void* block_tile, const void* block_snd_tile, const void* we,
                        const void* w2, const void* b0, const void* b2, void* z_upd, void* R,
                        void* r64, void* mpart, void* M, int64_t n_nodes, int64_t n_edges,
                        int64_t L, int64_t tile, int64_t n_blocks, int64_t n_graphs,
                        void* stream) {
  if (L < 4 || L > 256 || L % 4 != 0 || tile <= 0 || n_nodes % tile != 0 || n_blocks <= 0 ||
      n_edges % n_blocks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(pdg_fused_edge2_smem_bytes(L));
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto* Rf = static_cast<float*>(R);
  auto* r6 = static_cast<double*>(r64);
  auto* mp = static_cast<double*>(mpart);
  auto* Mf = static_cast<float*>(M);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(proj_u, proj_v, e, i32(rcv), i32(snd), i32(gid),
                                   i32(block_tile), i32(block_snd_tile), we, w2, b0, b2, z_upd,
                                   Rf, r6, mp, Mf, n_nodes, n_edges, L, tile, n_blocks, n_graphs,
                                   smem, s)
           : launch<float>(proj_u, proj_v, e, i32(rcv), i32(snd), i32(gid), i32(block_tile),
                           i32(block_snd_tile), we, w2, b0, b2, z_upd, Rf, r6, mp, Mf, n_nodes,
                           n_edges, L, tile, n_blocks, n_graphs, smem, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
