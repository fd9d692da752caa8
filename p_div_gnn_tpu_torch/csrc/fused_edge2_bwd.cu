// Pair-blocked fused edge-step backward ("fused2") for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step2_bwd_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched from `_step2_bwd`, the VJP of
// `fused_edge_step2`). The forward (fused_edge2_fwd.cu) computes, for every
// slot i of block b of the pair-blocked layout with receiver r and sender s
// (an endpoint outside its block's receiver or sender tile reads 0),
//
//   ep = e[i]·We
//   pre1 = ((u[r] + v[s]) + ep) + b0     h1 = relu(pre1)
//   pre2 = ((v[r] + u[s]) + ep) + b0     h2 = relu(pre2)
//   z_msg = relu(h1·W2 + b2)·mask_i      z_upd = relu(h2·W2 + b2)·mask_i
//
// with R[r] += z_msg and the moment rows M = [Σz_msg, Σz_msg², Σz_upd,
// Σz_upd²]. Given the cotangents dz_upd (Ep, L), dR (Np, L) and dM (8, L)
// this backward recomputes ep, h1, h2 and z_msg (z_upd is the forward's,
// zero on the padding slots) and forms
//
//   dy1 = (dR[r] + dM0 + 2·dM1·z_msg)·(z_msg > 0)    dpre1 = dy1·W2ᵀ·(h1 > 0)
//   dy2 = (dz_upd + dM2 + 2·dM3·z_upd)·(z_upd > 0)   dpre2 = dy2·W2ᵀ·(h2 > 0)
//   dpre1, dpre2, de = (dpre1 + dpre2)·Weᵀ              (Ep, L) stream dtype
//   du_r[r] += dpre1, dv_r[r] += dpre2 (r in tile)      (Np, L) fp32
//   dW2 = Σ h1ᵀdy1 + h2ᵀdy2   dWe = Σ eᵀ(dpre1 + dpre2)
//   db2 = Σ dy1 + dy2         db0 = Σ dpre1 + dpre2
//
// The sender-side adds (d u += S(dpre2), d v += S(dpre1), S the segment sum
// over senders) run outside, in one pair segment sum over the layout's
// sender view (segment_sum_csr.cu), as the TPU kernel leaves them outside:
// a sender tile's blocks are not consecutive in receiver-major order.
//
// What bounds it on this card: 8 L×L products per real edge slot (e·We and
// h1·W2 to recompute the forward, dy1·W2ᵀ, dy2·W2ᵀ and dps·Weᵀ for the data
// cotangents, h1ᵀdy1, h2ᵀdy2 and eᵀdps for the weight grads), 2·8·L² flops
// per slot, so the fp32 FMA rate (the tensor cores are not used) bounds it
// in fp32, and bytes bound it in bf16 (against the tensor-core rate).
//
// Design, in three launches (the v2 backward's, fused_edge_bwd.cu, on this
// layout):
// 1. `pair_bwd_tile_kernel`: one CTA per receiver tile, walking the tile's
//    blocks (binary search in block_tile) 16 slots at a time, with 2L
//    threads: thread (p, c) owns column c of path p (p = 0 the messages,
//    p = 1 the edge update). Both endpoint rows are read from u and v. The
//    five per-slot products are split evenly between the paths. A chunk of
//    only padding slots writes its zero rows of dpre1, dpre2 and de and
//    skips its products. du_r / dv_r: one receiver is met in up to ~4 runs
//    (receivers restart at each (receiver tile, sender tile) group), so
//    path p's thread c keeps the fp64 sum of its column of dpre for the
//    current receiver in a register and adds it to an fp64 scratch row of
//    the tile (zeroed by this CTA, its only writer) when the receiver
//    changes; after the tile's last block it rounds the rows once. db2 and
//    db0 go to per-tile fp64 partials. h1, h2, dy1, dy2 and dpre1 + dpre2
//    of the real slots, rounded to the stream dtype as the weight-grad
//    contractions take them, go to a scratch stream.
// 2. and 3. `edge_bwd_wgrad_kernel` and `edge_bwd_reduce_kernel`
//    (edge_common.cuh, shared with the v2 backward): the weight grads
//    Σ_i A[i]ᵀB[i] over all real slots, which the TPU kernel sums into one
//    (2L+8, L) block revisited by every grid step, as fp32 FMAs summed over
//    8 slots and in fp64 across them, then one ordered reduce of the
//    partials into one (2L+2, L) block [dW2; dWe; db2; db0], rounded once.
//    The result does not change from run to run. Padding slots are staged
//    as zero rows, and a step of only padding slots is skipped.
// - Each product is one FMA chain over k in order; the first-layer sum is
//   grouped as the forward groups it, so the recomputed z_msg is the
//   forward's bit for bit. (dR[r] + dM0) + (2·dM1)·z is rounded after each
//   operation, as the plain version rounds it (no contraction into an FMA).
// - Precision: fp32 FMA for the per-slot products (no TF32) and for the
//   8-slot weight-grad sums, fp64 for the sums of those, for du_r / dv_r and
//   for db0 / db2. In bf16 mode every contraction takes bf16 operands with
//   fp32 accumulation, as the JAX kernel does (`mm` of `_step2_bwd_kernel`
//   casts both operands): the gathered dR row, h, dy and dpre1 + dpre2 are
//   rounded before they are contracted, and du_r / dv_r sum the
//   bf16-rounded dpre; db2 and db0 sum the unrounded dy and dpre.
// - Shared memory of kernel 1 is 5·16·L·4 bytes + 192 (41 KB at L 128);
//   it and the weight-grad kernel run at most 128 registers a thread (launch bound 512),
//   so two of their 256-thread CTAs share an SM at L 128.

#include "edge_common.cuh"

namespace {

constexpr int EC = 16;  // edge slots staged per chunk of the tile kernel
constexpr int HALF = EC / 2;

template <typename T>
__global__ void __launch_bounds__(512) pair_bwd_tile_kernel(
    const T* __restrict__ proj_u, const T* __restrict__ proj_v, const T* __restrict__ e,
    const T* __restrict__ z_upd, const T* __restrict__ dz_upd, const float* __restrict__ dR,
    const float* __restrict__ dM, const int32_t* __restrict__ rcv,
    const int32_t* __restrict__ snd, const int32_t* __restrict__ gid,
    const int32_t* __restrict__ block_tile, const int32_t* __restrict__ block_snd_tile,
    const T* __restrict__ we, const T* __restrict__ w2, const T* __restrict__ weT,
    const T* __restrict__ w2T, const T* __restrict__ b0, const T* __restrict__ b2,
    T* __restrict__ dpre1, T* __restrict__ dpre2, T* __restrict__ de, float* __restrict__ dur,
    double* __restrict__ d64, T* __restrict__ scratch, double* __restrict__ bpart,
    int64_t n_nodes, int64_t n_edges, int64_t L, int64_t tile, int64_t block,
    int64_t n_blocks, int64_t n_graphs) {
  extern __shared__ float4 smem4[];
  float* s_e = reinterpret_cast<float*>(smem4);  // (EC, L) e rows
  float* s_ep = s_e + EC * L;                    // (EC, L) e·We
  float* s_h = s_ep + EC * L;                    // (2, EC, L) h, then dy, of each path
  float* s_y = s_h + 2 * EC * L;                 // (EC, L) h1·W2, then dpre1, then dps
  int* rl_s = reinterpret_cast<int*>(s_y + EC * L);     // (EC,) local receiver or -1
  int* sg_s = rl_s + EC;                                // (EC,) sender row or -1
  float* mk_s = reinterpret_cast<float*>(sg_s + EC);    // (EC,) mask

  // blockDim.x == 2L: thread (path, c) owns column c of one path; the
  // messages read u at the receiver and v at the sender, the edge update
  // the other way round
  const int path = static_cast<int>(threadIdx.x / L);
  const int c = static_cast<int>(threadIdx.x % L);
  const T* a_r = path ? proj_v : proj_u;
  const T* a_s = path ? proj_u : proj_v;
  T* dpre_own = path ? dpre2 : dpre1;
  float* h_own = s_h + path * EC * L;
  const int64_t t = blockIdx.x;
  const int64_t node_lo = t * tile;
  const int64_t e_lo = first_not_less(block_tile, n_blocks, t) * block;
  const int64_t e_hi = first_not_less(block_tile, n_blocks, t + 1) * block;
  const int64_t EL = n_edges * L;
  double* d64_tile = d64 + (path * n_nodes + node_lo) * L;
  for (int64_t rl = 0; rl < tile; ++rl) d64_tile[rl * L + c] = 0.0;

  const float b0c = to_f(b0[c]);
  const float b2c = to_f(b2[c]);
  const float dm_a = dM[(2 * path) * L + c];             // dM0 or dM2
  const float dm_b2 = 2.f * dM[(2 * path + 1) * L + c];  // 2·dM1 or 2·dM3
  double s_dy = 0.0, s_dps = 0.0;  // db2 of this path; db0 (edge-update path)
  double d_run = 0.0;              // du_r / dv_r of the current receiver
  int d_rl = -1;

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
    if (!live) {  // padding only: zero rows of dpre1, dpre2 and de
      for (int i = 0; i < EC && base + i < e_hi; ++i) {
        dpre_own[(base + i) * L + c] = from_f<T>(0.f);
        if (path == 0) de[(base + i) * L + c] = from_f<T>(0.f);
      }
      __syncthreads();  // mk_s is restaged next chunk
      continue;
    }
    for (int i = path; i < EC; i += 2) {
      const int64_t ei = base + i;
      s_e[i * L + c] = ei < e_hi ? to_f(e[ei * L + c]) : 0.f;
    }
    __syncthreads();

    // --- recompute e·We, half the slots per path
    {
      float acc[HALF];
      rows_times_w<T, HALF>(s_e + path * HALF * L, we, L, c, acc);
#pragma unroll
      for (int i = 0; i < HALF; ++i) s_ep[(path * HALF + i) * L + c] = acc[i];
    }
    __syncthreads();

    // --- h of this path, as the forward forms it; bit i of `on` is pre > 0
    uint32_t on = 0;
#pragma unroll 4
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      const int rl = rl_s[i];
      const int sg = sg_s[i];
      const float ar = rl >= 0 ? to_f(a_r[(node_lo + rl) * L + c]) : 0.f;
      const float as = sg >= 0 ? to_f(a_s[static_cast<int64_t>(sg) * L + c]) : 0.f;
      const float pre = ((ar + as) + s_ep[i * L + c]) + b0c;
      on |= (pre > 0.f ? 1u : 0u) << i;
      const float h = round_sd<T>(fmaxf(pre, 0.f));
      h_own[i * L + c] = h;
      if (ei < e_hi && mk_s[i] != 0.f) scratch[(S_H1 + path) * EL + ei * L + c] = from_f<T>(h);
    }
    __syncthreads();

    // --- h1·W2 (the message path's z), half the slots per path
    {
      float acc[HALF];
      rows_times_w<T, HALF>(s_h + path * HALF * L, w2, L, c, acc);
#pragma unroll
      for (int i = 0; i < HALF; ++i) s_y[(path * HALF + i) * L + c] = acc[i];
    }
    __syncthreads();

    // --- dy of this path
#pragma unroll 4
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      const bool valid = ei < e_hi;
      float z, dz;
      if (path == 0) {
        const int rl = rl_s[i];
        z = fmaxf(s_y[i * L + c] + b2c, 0.f) * mk_s[i];
        // the JAX kernel contracts dR in the stream dtype
        dz = (rl >= 0 ? round_sd<T>(dR[(node_lo + rl) * L + c]) : 0.f) + dm_a;
      } else {
        z = valid ? to_f(z_upd[ei * L + c]) : 0.f;
        dz = (valid ? to_f(dz_upd[ei * L + c]) : 0.f) + dm_a;
      }
      // (dz + dM) + (2·dM')·z, each operation rounded as the plain version
      dz = __fadd_rn(dz, __fmul_rn(dm_b2, z));
      const float dy = dz * (z > 0.f && mk_s[i] != 0.f ? 1.f : 0.f);
      s_dy += dy;
      h_own[i * L + c] = round_sd<T>(dy);
      if (valid && mk_s[i] != 0.f) scratch[(S_DY1 + path) * EL + ei * L + c] = from_f<T>(dy);
    }
    __syncthreads();

    // --- dpre = (dy·W2ᵀ)·(pre > 0) of this path, and the receiver runs
    float dp[EC];
    rows_times_w<T, EC>(h_own, w2T, L, c, dp);
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      dp[i] *= (on >> i) & 1u ? 1.f : 0.f;
      if (ei < e_hi) dpre_own[ei * L + c] = from_f<T>(dp[i]);
      if (path == 0) s_y[i * L + c] = dp[i];
      const int rl = rl_s[i];
      if (rl < 0) continue;
      if (rl != d_rl) {
        if (d_rl >= 0) d64_tile[d_rl * L + c] += d_run;
        d_run = 0.0;
        d_rl = rl;
      }
      d_run += round_sd<T>(dp[i]);
    }
    __syncthreads();

    // --- dps = dpre1 + dpre2, formed by the edge-update path
    if (path == 1) {
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const int64_t ei = base + i;
        const float dps = s_y[i * L + c] + dp[i];
        s_dps += dps;
        s_y[i * L + c] = round_sd<T>(dps);
        if (ei < e_hi && mk_s[i] != 0.f) scratch[S_DPS * EL + ei * L + c] = from_f<T>(dps);
      }
    }
    __syncthreads();

    // --- de = dps·Weᵀ, half the slots per path
    {
      float acc[HALF];
      rows_times_w<T, HALF>(s_y + path * HALF * L, weT, L, c, acc);
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int64_t ei = base + path * HALF + i;
        if (ei < e_hi) de[ei * L + c] = from_f<T>(acc[i]);
      }
    }
    __syncthreads();  // the staged rows are restaged next chunk
  }

  if (d_rl >= 0) d64_tile[d_rl * L + c] += d_run;
  float* dur_tile = dur + (path * n_nodes + node_lo) * L;
  for (int64_t rl = 0; rl < tile; ++rl)
    dur_tile[rl * L + c] = static_cast<float>(d64_tile[rl * L + c]);
  bpart[(t * 3 + path) * L + c] = s_dy;
  if (path == 1) bpart[(t * 3 + 2) * L + c] = s_dps;
}

struct Args {
  const void *proj_u, *proj_v, *e, *z_upd, *dz_upd;
  const float *dR, *dM;
  const int32_t *rcv, *snd, *gid, *block_tile, *block_snd_tile;
  const void *we, *w2, *weT, *w2T, *b0, *b2;
  void *dpre1, *dpre2, *de;
  float* dur;
  double* d64;
  void* scratch;
  double *bpart, *wpart;
  float* wb;
  int64_t n_nodes, n_edges, L, tile, n_blocks, n_graphs, n_chunks;
};

template <typename T>
cudaError_t launch(const Args& a, size_t smem_tile, cudaStream_t stream) {
  const int64_t n_tiles = a.n_nodes / a.tile;
  const int64_t block = a.n_edges / a.n_blocks;
  cudaError_t err = cudaFuncSetAttribute(pair_bwd_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_tile));
  if (err != cudaSuccess) return err;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  pair_bwd_tile_kernel<T><<<static_cast<unsigned>(n_tiles), static_cast<unsigned>(2 * a.L),
                            smem_tile, stream>>>(
      c(a.proj_u), c(a.proj_v), c(a.e), c(a.z_upd), c(a.dz_upd), a.dR, a.dM, a.rcv, a.snd,
      a.gid, a.block_tile, a.block_snd_tile, c(a.we), c(a.w2), c(a.weT), c(a.w2T), c(a.b0),
      c(a.b2), static_cast<T*>(a.dpre1), static_cast<T*>(a.dpre2), static_cast<T*>(a.de),
      a.dur, a.d64, static_cast<T*>(a.scratch), a.bpart, a.n_nodes, a.n_edges, a.L, a.tile,
      block, a.n_blocks, a.n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  return launch_wgrad_reduce<T>(static_cast<const T*>(a.scratch), c(a.e), a.gid, a.wpart,
                                a.bpart, a.wb, a.n_edges, a.L, n_tiles, a.n_chunks,
                                a.n_graphs, stream);
}

}  // namespace

extern "C" {

// Shared memory of one CTA of the tile kernel.
int64_t pdg_fused_edge2_bwd_tile_smem_bytes(int64_t L) {
  return 5 * EC * L * static_cast<int64_t>(sizeof(float)) +
         EC * static_cast<int64_t>(2 * sizeof(int) + sizeof(float));
}

// Launches the backward on `stream`. Pointers are device pointers. proj_u,
// proj_v, e, z_upd, dz_upd, the weights, their transposes (weT[k][c] =
// we[c][k], w2T likewise), dpre1, dpre2, de and scratch (5, n_edges, L) are
// fp32 (bf16 == 0) or bf16 (bf16 == 1); dR (n_nodes, L), dM (8, L), dur
// (2, n_nodes, L: du_r, dv_r, written whole) and wb (2L+2, L) are fp32;
// rcv, snd, gid (n_edges,), block_tile and block_snd_tile (n_blocks,) are
// int32; d64 (2, n_nodes, L), bpart (n_nodes/tile, 3, L) and wpart
// (n_chunks, 2, L, L) are fp64 scratch. Returns a cudaError_t value (0 on
// success).
int pdg_fused_edge2_bwd(int bf16, const void* proj_u, const void* proj_v, const void* e,
                        const void* z_upd, const void* dz_upd, const void* dR, const void* dM,
                        const void* rcv, const void* snd, const void* gid,
                        const void* block_tile, const void* block_snd_tile, const void* we,
                        const void* w2, const void* weT, const void* w2T, const void* b0,
                        const void* b2, void* dpre1, void* dpre2, void* de, void* dur,
                        void* d64, void* scratch, void* bpart, void* wpart, void* wb,
                        int64_t n_nodes, int64_t n_edges, int64_t L, int64_t tile,
                        int64_t n_blocks, int64_t n_graphs, int64_t n_chunks, void* stream) {
  if (L < KB || L > 4 * KB || L % KB != 0 || tile <= 0 || n_nodes % tile != 0 ||
      n_blocks <= 0 || n_edges % n_blocks != 0 || n_chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  Args a{proj_u, proj_v, e, z_upd, dz_upd,
         static_cast<const float*>(dR), static_cast<const float*>(dM),
         i32(rcv), i32(snd), i32(gid), i32(block_tile), i32(block_snd_tile),
         we, w2, weT, w2T, b0, b2, dpre1, dpre2, de, static_cast<float*>(dur),
         static_cast<double*>(d64), scratch, static_cast<double*>(bpart),
         static_cast<double*>(wpart), static_cast<float*>(wb),
         n_nodes, n_edges, L, tile, n_blocks, n_graphs, n_chunks};
  const size_t smem_tile = static_cast<size_t>(pdg_fused_edge2_bwd_tile_smem_bytes(L));
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch<__nv_bfloat16>(a, smem_tile, s)
                         : launch<float>(a, smem_tile, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
