// Fused edge-step forward (v2, the "fused" Processor) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched by `_step_forward` through
// `fused_edge_step`). Given the hoisted node projections a_u = x·Wu,
// a_v = x·Wv and their sender gathers g_v = a_v[snd], g_u = a_u[snd], for
// every edge slot i with receiver r:
//
//   ep    = e[i]·We
//   z_msg = relu(relu(((a_u[r] + g_v[i]) + ep) + b0)·W2 + b2) · mask_i
//   z_upd = relu(relu(((a_v[r] + g_u[i]) + ep) + b0)·W2 + b2) · mask_i
//
// and it writes z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
// R[r] = Σ z_msg over the edges into r (R is zeroed by the caller), and
// M (8, L) fp32 holding the rows Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four
// zero rows. mask_i = 0 where edge_gid[i] >= n_graphs (padding slots).
//
// What bounds it on this card: 3 L×L products per edge slot (e·We, shared
// by both evaluations, then h·W2 twice), 2·3·L² flops per slot, against
// ~2.6 KB of streamed bytes per slot in fp32 (g_v, g_u, e in, z_upd out):
// ~38 flop/byte at L=128, above the fp32 FMA rate's ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte; the tensor cores are not used), so operations
// bound it in fp32 and bytes in bf16 (against the tensor-core rate).
//
// Design:
// - The TPU grid runs in order and accumulates R and M into revisited
//   output blocks. Here each CTA takes one node tile and walks the tile's
//   edge blocks (edge_block_tile is sorted; a binary search finds the
//   run), so it is the only writer of its R rows: no atomics.
// - 2L threads: thread (p, c) owns column c of path p (p = 0 the messages,
//   p = 1 the edge update). The shared e·We of a chunk of 32 slots is
//   formed half by each path, then each path forms its own h and h·W2.
// - R is summed without a shared tile: the layout sorts each tile's slots
//   by receiver, so the message path's thread c keeps the running sum of
//   its column for the current receiver in a register (fp64) and adds it
//   to R when the receiver changes. Shared memory is 4·32·L·4 bytes
//   (64 KB at L 128), so two CTAs share an SM, where the fused3 forward's
//   128 KB R tile allows one.
// - M: each path's thread c sums its column's z and z² over the tile in
//   fp64 (the one-pass variance that reads them amplifies their rounding),
//   into per-tile partials; a one-CTA kernel sums the partials in tile
//   order and rounds once. The result does not change from run to run.
// - The receiver rows a_u[r], a_v[r] are read directly (the TPU's one-hot
//   gather matmul has no place here); a receiver outside the CTA's tile
//   reads zero and adds nothing to R, as the one-hot contraction does.
// - Rounding: each product is one FMA chain over k in order, as a GEMM
//   computes it, and the first-layer sum is grouped as the plain "xla"
//   Processor groups it, ((a[r] + g) + ep) + b0, so that the fused path
//   rounds like the plain one (the JAX kernel groups (a[r] + g) + (ep + b0);
//   the trained model amplifies one-ulp differences of its edge
//   activations ~250x into its output).
// - Precision: fp32 FMA only, no TF32. In bf16 mode the operands are bf16
//   with fp32 accumulation, h = relu(pre) is rounded to bf16 before ·W2, R
//   sums the bf16-rounded z_msg and M the unrounded fp32 z — where the JAX
//   package rounds (`_step_kernel`).

#include "edge_common.cuh"

namespace {

constexpr int EC = 32;  // edge slots staged per chunk
constexpr int HALF = EC / 2;

template <typename T>
__global__ void __launch_bounds__(512) v2_fwd_tile_kernel(
    const T* __restrict__ a_u, const T* __restrict__ a_v, const T* __restrict__ g_v,
    const T* __restrict__ g_u, const T* __restrict__ e, const int32_t* __restrict__ rcv,
    const int32_t* __restrict__ gid, const int32_t* __restrict__ block_tile,
    const T* __restrict__ we, const T* __restrict__ w2, const T* __restrict__ b0,
    const T* __restrict__ b2, T* __restrict__ z_upd, float* __restrict__ R,
    double* __restrict__ mpart, int64_t L, int64_t tile, int64_t block, int64_t n_blocks,
    int64_t n_graphs) {
  extern __shared__ float4 smem4[];
  float* es = reinterpret_cast<float*>(smem4);  // (EC, L) e rows
  float* eps = es + EC * L;                     // (EC, L) e·We
  float* hs = eps + EC * L;                     // (2, EC, L) h of each path
  int* rl_s = reinterpret_cast<int*>(hs + 2 * EC * L);  // (EC,) local receiver or -1
  float* mk_s = reinterpret_cast<float*>(rl_s + EC);    // (EC,) mask

  // blockDim.x == 2L: thread (path, c) owns column c of one path
  const int path = static_cast<int>(threadIdx.x / L);
  const int c = static_cast<int>(threadIdx.x % L);
  const T* a = path ? a_v : a_u;
  const T* g = path ? g_u : g_v;
  float* h_own = hs + path * EC * L;
  const int64_t t = blockIdx.x;
  const int64_t node_lo = t * tile;
  const int64_t e_lo = first_not_less(block_tile, n_blocks, t) * block;
  const int64_t e_hi = first_not_less(block_tile, n_blocks, t + 1) * block;

  const float b0c = to_f(b0[c]);
  const float b2c = to_f(b2[c]);
  double s_z = 0.0, s_z2 = 0.0;  // this path's moment partials
  double run = 0.0;              // message path: R of the current receiver
  int run_rl = -1;

  for (int64_t base = e_lo; base < e_hi; base += EC) {
    for (int i = threadIdx.x; i < EC; i += blockDim.x) {
      const int64_t ei = base + i;
      int rl = -1;
      float m = 0.f;
      if (ei < e_hi) {
        const int64_t r = rcv[ei];
        if (r >= node_lo && r < node_lo + tile) rl = static_cast<int>(r - node_lo);
        m = gid[ei] < n_graphs ? 1.f : 0.f;
      }
      rl_s[i] = rl;
      mk_s[i] = m;
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

    // h = relu(((a[r] + g) + ep) + b0), grouped as the plain path groups it
#pragma unroll 4
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      const int rl = rl_s[i];
      const float ar = rl >= 0 ? to_f(a[(node_lo + rl) * L + c]) : 0.f;
      const float gi = ei < e_hi ? to_f(g[ei * L + c]) : 0.f;
      h_own[i * L + c] = round_sd<T>(fmaxf(((ar + gi) + eps[i * L + c]) + b0c, 0.f));
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
        if (run_rl >= 0) R[(node_lo + run_rl) * L + c] += static_cast<float>(run);
        run = 0.0;
        run_rl = rl;
      }
      run += round_sd<T>(z);
    }
    __syncthreads();  // es / eps / hs / rl_s / mk_s are restaged next chunk
  }

  if (run_rl >= 0) R[(node_lo + run_rl) * L + c] += static_cast<float>(run);
  double* mp = mpart + t * 4 * L;
  mp[(2 * path) * L + c] = s_z;
  mp[(2 * path + 1) * L + c] = s_z2;
}

template <typename T>
cudaError_t launch(const void* a_u, const void* a_v, const void* g_v, const void* g_u,
                   const void* e, const int32_t* rcv, const int32_t* gid,
                   const int32_t* block_tile, const void* we, const void* w2, const void* b0,
                   const void* b2, void* z_upd, float* R, double* mpart, float* M,
                   int64_t n_nodes, int64_t n_edges, int64_t L, int64_t tile, int64_t n_blocks,
                   int64_t n_graphs, size_t smem, cudaStream_t stream) {
  const int64_t n_tiles = n_nodes / tile;
  const int64_t block = n_edges / n_blocks;
  cudaError_t err = cudaFuncSetAttribute(
      v2_fwd_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  v2_fwd_tile_kernel<T><<<static_cast<unsigned>(n_tiles), static_cast<unsigned>(2 * L), smem,
                          stream>>>(
      c(a_u), c(a_v), c(g_v), c(g_u), c(e), rcv, gid, block_tile, c(we), c(w2), c(b0), c(b2),
      static_cast<T*>(z_upd), R, mpart, L, tile, block, n_blocks, n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_moments_kernel<<<1, 256, 0, stream>>>(mpart, n_tiles, L, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the tile kernel needs.
int64_t pdg_fused_edge_smem_bytes(int64_t L) {
  return 4 * EC * L * static_cast<int64_t>(sizeof(float)) +
         EC * static_cast<int64_t>(sizeof(int) + sizeof(float));
}

// Launches the forward on `stream`. Pointers are device pointers; a_u, a_v
// (n_nodes, L), g_v, g_u, e, z_upd (n_edges, L) and the weights are fp32
// (bf16 == 0) or bf16 (bf16 == 1); rcv, gid and block_tile are int32; R
// (n_nodes, L, zeroed by the caller) and M (8, L) are fp32; mpart
// (n_nodes/tile, 4, L) is fp64 scratch. Returns a cudaError_t value (0 on
// success).
int pdg_fused_edge_fwd(int bf16, const void* a_u, const void* a_v, const void* g_v,
                       const void* g_u, const void* e, const void* rcv, const void* gid,
                       const void* block_tile, const void* we, const void* w2, const void* b0,
                       const void* b2, void* z_upd, void* R, void* mpart, void* M,
                       int64_t n_nodes, int64_t n_edges, int64_t L, int64_t tile,
                       int64_t n_blocks, int64_t n_graphs, void* stream) {
  if (L < 4 || L > 256 || L % 4 != 0 || tile <= 0 || n_nodes % tile != 0 || n_blocks <= 0 ||
      n_edges % n_blocks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(pdg_fused_edge_smem_bytes(L));
  const auto* r = static_cast<const int32_t*>(rcv);
  const auto* gi = static_cast<const int32_t*>(gid);
  const auto* bt = static_cast<const int32_t*>(block_tile);
  auto* Rf = static_cast<float*>(R);
  auto* mp = static_cast<double*>(mpart);
  auto* Mf = static_cast<float*>(M);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(a_u, a_v, g_v, g_u, e, r, gi, bt, we, w2, b0, b2, z_upd, Rf,
                                   mp, Mf, n_nodes, n_edges, L, tile, n_blocks, n_graphs, smem,
                                   s)
           : launch<float>(a_u, a_v, g_v, g_u, e, r, gi, bt, we, w2, b0, b2, z_upd, Rf, mp, Mf,
                           n_nodes, n_edges, L, tile, n_blocks, n_graphs, smem, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
