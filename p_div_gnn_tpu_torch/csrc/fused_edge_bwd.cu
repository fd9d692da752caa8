// Fused edge-step backward (v2, the "fused" Processor) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step_bwd_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched by `_step_backward_pallas`
// from `_step_bwd`, the VJP of `fused_edge_step`). The forward
// (fused_edge_fwd.cu) computes, for every edge slot i with receiver r,
//
//   ep = e[i]·We
//   pre1 = ((a_u[r] + g_v[i]) + ep) + b0     h1 = relu(pre1)
//   pre2 = ((a_v[r] + g_u[i]) + ep) + b0     h2 = relu(pre2)
//   z_msg = relu(h1·W2 + b2)·mask_i          z_upd = relu(h2·W2 + b2)·mask_i
//
// with R[r] += z_msg and the moment rows M = [Σz_msg, Σz_msg², Σz_upd,
// Σz_upd²]. Given the cotangents dz_upd (Ep, L), dR (Np, L) and dM (8, L)
// this backward recomputes ep, h1, h2 and z_msg (re-masked: mask_i = 0
// where edge_gid[i] >= n_graphs; z_upd is the forward's) and forms
//
//   dy1 = (dR[r] + dM0 + 2·dM1·z_msg)·(z_msg > 0)    dpre1 = dy1·W2ᵀ·(h1 > 0)
//   dy2 = (dz_upd + dM2 + 2·dM3·z_upd)·(z_upd > 0)   dpre2 = dy2·W2ᵀ·(h2 > 0)
//   dg_v = dpre1, dg_u = dpre2, de = (dpre1 + dpre2)·Weᵀ   (Ep, L) stream dtype
//   da_u[r] += dpre1, da_v[r] += dpre2                      (Np, L) fp32
//   dW2 = Σ h1ᵀdy1 + h2ᵀdy2   dWe = Σ eᵀ(dpre1 + dpre2)
//   db2 = Σ dy1 + dy2         db0 = Σ dpre1 + dpre2
//
// What bounds it on this card: 8 L×L products per edge slot (e·We and h1·W2
// to recompute the forward, dy1·W2ᵀ, dy2·W2ᵀ and dps·Weᵀ for the data
// cotangents, h1ᵀdy1, h2ᵀdy2 and eᵀdps for the weight grads), 2·8·L² flops
// per slot, against ~4.1 KB of streamed bytes per slot in fp32 (g_v, g_u,
// e, z_upd, dz_upd in, dg_v, dg_u, de out): ~64 flop/byte at L=128, so the
// fp32 FMA rate (67 TFLOP/s; the tensor cores are not used) bounds it in
// fp32, and bytes bound it in bf16 (against the tensor-core rate).
//
// Design, in three launches:
// 1. `v2_bwd_tile_kernel`: one CTA per node tile, walking the tile's edge
//    blocks (binary search in edge_block_tile) 16 slots at a time, with 2L
//    threads: thread (p, c) owns column c of path p (p = 0 the messages,
//    p = 1 the edge update). The five per-slot products are split evenly:
//    each path forms half the slots' e·We, half of h1·W2 and half of
//    dps·Weᵀ, and its own dpre = dy·W2ᵀ. The TPU kernel sums dA into
//    node-tile blocks that the sequential grid revisits; here the layout
//    sorts each tile's slots by receiver, so path p's thread c keeps the
//    running fp64 sum of its column of dpre for the current receiver in a
//    register and adds it to da_p when the receiver changes: this CTA is
//    the only writer of its tile's rows, no atomics. db2 and db0 go to
//    per-tile fp64 partials. h1, h2, dy1, dy2 and dpre1 + dpre2, rounded to
//    the stream dtype as the weight-grad contractions take them, go to a
//    scratch stream.
// 2. `v2_bwd_wgrad_kernel`: the weight grads Σ_i A[i]ᵀB[i] over all slots,
//    which the TPU kernel sums into one (2L+8, L) block revisited by every
//    grid step. The slots are cut into chunks; each CTA computes one 64-row
//    slab of one weight grad over one chunk, an outer product per slot from
//    shared memory with a 4×8 register tile per thread. The products are
//    fp32 FMAs into a register that restarts every WG = 8 slots; each
//    8-slot sum is added to an fp64 accumulator. (The fused3 backward's
//    scheme: one fp32 chain per chunk would round at the size of the
//    running sum, ~1e-3 absolute on the entries that cancel to near zero
//    against a 2e-4 check; an 8-slot chain rounds at the size of a few
//    products.)
// 3. `v2_bwd_reduce_kernel`: sums the per-chunk and per-tile partials in a
//    fixed order and rounds once to fp32, into one (2L+2, L) block
//    [dW2; dWe; db2; db0]. The result does not change from run to run.
// - Each product is one FMA chain over k in order; the first-layer sum is
//   grouped as the forward groups it, so the recomputed z_msg is the
//   forward's bit for bit. (dR[r] + dM0) + (2·dM1)·z is rounded after each
//   operation, as the plain version rounds it (no contraction into an FMA).
// - Precision: fp32 FMA for the per-slot products (no TF32) and for the
//   8-slot weight-grad sums, fp64 for the sums of those, for dA and for
//   db0 / db2. In bf16 mode every contraction takes bf16 operands with
//   fp32 accumulation, as the JAX kernel does (`mm` of `_step_bwd_kernel`):
//   h, dy and dpre1 + dpre2 are rounded before they are contracted, and dA
//   sums the bf16-rounded dpre. The gathered dR row is not rounded, as in
//   the JAX op on the CPU, to which the tests hold the port (the TPU's
//   DEFAULT-precision one-hot gather may round it to bf16).
// - Shared memory of kernel 1 is 5·16·L·4 bytes + 128 (41 KB at L 128);
//   kernel 1 runs at most 128 registers a thread (launch bound 512), so
//   two 256-thread CTAs share an SM. Kernel 2 (16·L/8 threads) has the
//   same bound, so two of its CTAs share an SM at L 128: at 136 registers
//   the bf16 instance ran one CTA per SM and took 1.8x the fp32 time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EC = 16;   // edge slots staged per chunk in kernel 1
constexpr int HALF = EC / 2;
constexpr int EW = 32;   // edge slots staged per step in kernel 2
constexpr int KB = 64;   // weight-grad rows per CTA in kernel 2
constexpr int TK = 4;    // weight-grad rows per thread (one float4 of A)
constexpr int TC = 8;    // weight-grad columns per thread
constexpr int WG = 8;    // slots per fp32 weight-grad sum in kernel 2
static_assert(EW % WG == 0, "a staged step holds whole fp32 sums");
// scratch streams written by kernel 1, then the edge stream e
enum { S_H1, S_H2, S_DY1, S_DY2, S_DPS, N_SCRATCH, SRC_E = N_SCRATCH };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value through the stream dtype (identity in fp32).
template <typename T> __device__ __forceinline__ float round_sd(float v) {
  return to_f(from_f<T>(v));
}

// First index in the sorted array a[0, n) whose value is >= key.
__device__ __forceinline__ int64_t first_not_less(const int32_t* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// acc[i] = Σ_k rows[i·L + k]·w[k·L + c] for N staged rows, one FMA chain
// per output over k in order (w is (L, L) row-major, read along column c).
template <typename T, int N>
__device__ __forceinline__ void rows_times_w(const float* rows, const T* __restrict__ w,
                                             int64_t L, int c, float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int64_t k = 0; k < L; k += 4) {
    float w_k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w_k[j] = to_f(w[(k + j) * L + c]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 r4 = *reinterpret_cast<const float4*>(rows + i * L + k);
      acc[i] = fmaf(r4.x, w_k[0], acc[i]);
      acc[i] = fmaf(r4.y, w_k[1], acc[i]);
      acc[i] = fmaf(r4.z, w_k[2], acc[i]);
      acc[i] = fmaf(r4.w, w_k[3], acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(512) v2_bwd_tile_kernel(
    const T* __restrict__ a_u, const T* __restrict__ a_v, const T* __restrict__ g_v,
    const T* __restrict__ g_u, const T* __restrict__ e, const T* __restrict__ z_upd,
    const T* __restrict__ dz_upd, const float* __restrict__ dR, const float* __restrict__ dM,
    const int32_t* __restrict__ rcv, const int32_t* __restrict__ gid,
    const int32_t* __restrict__ block_tile, const T* __restrict__ we,
    const T* __restrict__ w2, const T* __restrict__ weT, const T* __restrict__ w2T,
    const T* __restrict__ b0, const T* __restrict__ b2, T* __restrict__ dg_v,
    T* __restrict__ dg_u, T* __restrict__ de, float* __restrict__ da,
    T* __restrict__ scratch, double* __restrict__ bpart, int64_t n_nodes, int64_t n_edges,
    int64_t L, int64_t tile, int64_t block, int64_t n_blocks, int64_t n_graphs) {
  extern __shared__ float4 smem4[];
  float* s_e = reinterpret_cast<float*>(smem4);  // (EC, L) e rows
  float* s_ep = s_e + EC * L;                    // (EC, L) e·We
  float* s_h = s_ep + EC * L;                    // (2, EC, L) h, then dy, of each path
  float* s_y = s_h + 2 * EC * L;                 // (EC, L) h1·W2, then dpre1, then dps
  int* rl_s = reinterpret_cast<int*>(s_y + EC * L);     // (EC,) local receiver or -1
  float* mk_s = reinterpret_cast<float*>(rl_s + EC);    // (EC,) mask

  // blockDim.x == 2L: thread (path, c) owns column c of one path
  const int path = static_cast<int>(threadIdx.x / L);
  const int c = static_cast<int>(threadIdx.x % L);
  const T* a = path ? a_v : a_u;
  const T* g = path ? g_u : g_v;
  T* dg = path ? dg_u : dg_v;
  float* da_own = da + path * n_nodes * L;
  float* h_own = s_h + path * EC * L;
  const int64_t t = blockIdx.x;
  const int64_t node_lo = t * tile;
  const int64_t e_lo = first_not_less(block_tile, n_blocks, t) * block;
  const int64_t e_hi = first_not_less(block_tile, n_blocks, t + 1) * block;
  const int64_t EL = n_edges * L;

  const float b0c = to_f(b0[c]);
  const float b2c = to_f(b2[c]);
  const float dm_a = dM[(2 * path) * L + c];           // dM0 or dM2
  const float dm_b2 = 2.f * dM[(2 * path + 1) * L + c];  // 2·dM1 or 2·dM3
  double s_dy = 0.0, s_dps = 0.0;  // db2 of this path; db0 (edge-update path)
  double da_run = 0.0;             // dA of the current receiver
  int da_rl = -1;

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
      const float ar = rl >= 0 ? to_f(a[(node_lo + rl) * L + c]) : 0.f;
      const float gi = ei < e_hi ? to_f(g[ei * L + c]) : 0.f;
      const float pre = ((ar + gi) + s_ep[i * L + c]) + b0c;
      on |= (pre > 0.f ? 1u : 0u) << i;
      const float h = round_sd<T>(fmaxf(pre, 0.f));
      h_own[i * L + c] = h;
      if (ei < e_hi) scratch[(S_H1 + path) * EL + ei * L + c] = from_f<T>(h);
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
        dz = (rl >= 0 ? dR[(node_lo + rl) * L + c] : 0.f) + dm_a;
      } else {
        z = valid ? to_f(z_upd[ei * L + c]) : 0.f;
        dz = (valid ? to_f(dz_upd[ei * L + c]) : 0.f) + dm_a;
      }
      // (dz + dM) + (2·dM')·z, each operation rounded as the plain version
      dz = __fadd_rn(dz, __fmul_rn(dm_b2, z));
      const float dy = dz * (z > 0.f ? 1.f : 0.f);
      s_dy += dy;
      h_own[i * L + c] = round_sd<T>(dy);
      if (valid) scratch[(S_DY1 + path) * EL + ei * L + c] = from_f<T>(dy);
    }
    __syncthreads();

    // --- dpre = (dy·W2ᵀ)·(pre > 0) of this path: dg and the dA runs
    float dp[EC];
    rows_times_w<T, EC>(h_own, w2T, L, c, dp);
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      dp[i] *= (on >> i) & 1u ? 1.f : 0.f;
      if (ei < e_hi) dg[ei * L + c] = from_f<T>(dp[i]);
      if (path == 0) s_y[i * L + c] = dp[i];
      const int rl = rl_s[i];
      if (rl < 0) continue;
      if (rl != da_rl) {
        if (da_rl >= 0) da_own[(node_lo + da_rl) * L + c] += static_cast<float>(da_run);
        da_run = 0.0;
        da_rl = rl;
      }
      da_run += round_sd<T>(dp[i]);
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
        if (ei < e_hi) scratch[S_DPS * EL + ei * L + c] = from_f<T>(dps);
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

  if (da_rl >= 0) da_own[(node_lo + da_rl) * L + c] += static_cast<float>(da_run);
  bpart[(t * 3 + path) * L + c] = s_dy;
  if (path == 1) bpart[(t * 3 + 2) * L + c] = s_dps;
}

// Four consecutive values of a stream as fp32 (p is 16-byte aligned for
// fp32, 8-byte for bf16: rows are L values long and col0 + 4·j4 is a
// multiple of 4).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Loads the staged rows' values of one operand stream as fp32 into
// dst[i * width + j] = src(base + i)[col0 + j] for i < EW, j < width; rows
// past `end` are zero. Each warp loads whole rows, four values per lane
// and load.
template <typename T>
__device__ __forceinline__ void stage_operand(float* dst, int src, int64_t col0, int width,
                                              int64_t base, int64_t end,
                                              const T* __restrict__ scratch,
                                              const T* __restrict__ e, int64_t n_edges,
                                              int64_t L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int i = warp; i < EW; i += n_warps) {
    const int64_t ei = base + i;
    const T* row = nullptr;
    if (ei < end) row = src == SRC_E ? e + ei * L : scratch + (src * n_edges + ei) * L;
    for (int j4 = lane; j4 < width / 4; j4 += 32) {
      const float4 v = row ? load4(row + col0 + 4 * j4) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + i * width + 4 * j4) = v;
    }
  }
}

// One 64-row slab of one weight grad over one chunk of slots:
// wpart[chunk][mat][k][c] = Σ_{i in chunk} Σ_pairs A[i][k]·B[i][c], fp32 over
// each WG slots, fp64 across them. mat 0 is dW2, mat 1 dWe.
template <typename T>
__global__ void __launch_bounds__(512) v2_bwd_wgrad_kernel(
    const T* __restrict__ scratch, const T* __restrict__ e, double* __restrict__ wpart,
    int64_t n_edges, int64_t L, int64_t chunk) {
  extern __shared__ float4 wsmem4[];
  float* a_s = reinterpret_cast<float*>(wsmem4);  // (EW, KB)
  float* b_s = a_s + EW * KB;                     // (EW, L)

  const int64_t ck = blockIdx.x;
  const int n_kb = static_cast<int>(L / KB);
  const int mat = blockIdx.y / n_kb;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y % n_kb) * KB;
  // thread (ty, tx) owns rows k0 + ty·TK + a and columns tx + b·(L/TC):
  // neighbouring threads read neighbouring columns of the staged rows
  const int n_tx = static_cast<int>(L / TC);
  const int tx = threadIdx.x % n_tx;
  const int ty = threadIdx.x / n_tx;
  const int64_t lo = ck * chunk;
  const int64_t hi = lo + chunk < n_edges ? lo + chunk : n_edges;

  // (A, B) stream pairs of each weight grad: dW2, dWe
  int pa[2], pb[2], n_pairs;
  if (mat == 0) { pa[0] = S_H1; pb[0] = S_DY1; pa[1] = S_H2; pb[1] = S_DY2; n_pairs = 2; }
  else { pa[0] = SRC_E; pb[0] = S_DPS; pa[1] = 0; pb[1] = 0; n_pairs = 1; }

  double acc[TK][TC];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TC; ++b) acc[a][b] = 0.0;

  for (int p = 0; p < n_pairs; ++p) {
    for (int64_t base = lo; base < hi; base += EW) {
      __syncthreads();  // the previous step's operands are consumed
      stage_operand<T>(a_s, pa[p], k0, KB, base, hi, scratch, e, n_edges, L);
      stage_operand<T>(b_s, pb[p], 0, static_cast<int>(L), base, hi, scratch, e, n_edges, L);
      __syncthreads();
      for (int i0 = 0; i0 < EW; i0 += WG) {
        float part[TK][TC];
#pragma unroll
        for (int a = 0; a < TK; ++a)
#pragma unroll
          for (int b = 0; b < TC; ++b) part[a][b] = 0.f;
#pragma unroll
        for (int i = i0; i < i0 + WG; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(a_s + i * KB + ty * TK);
          const float av[TK] = {a4.x, a4.y, a4.z, a4.w};
          float bv[TC];
#pragma unroll
          for (int b = 0; b < TC; ++b) bv[b] = b_s[i * L + b * n_tx + tx];
#pragma unroll
          for (int a = 0; a < TK; ++a)
#pragma unroll
            for (int b = 0; b < TC; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
        }
#pragma unroll
        for (int a = 0; a < TK; ++a)
#pragma unroll
          for (int b = 0; b < TC; ++b) acc[a][b] += static_cast<double>(part[a][b]);
      }
    }
  }
  double* out = wpart + (ck * 2 + mat) * L * L;
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TC; ++b) out[(k0 + ty * TK + a) * L + b * n_tx + tx] = acc[a][b];
}

// wb = [dW2; dWe; db2; db0] (2L+2, L) fp32: the per-chunk and per-tile
// partials summed in order in fp64, rounded once.
__global__ void v2_bwd_reduce_kernel(const double* __restrict__ wpart, int64_t n_chunks,
                                     const double* __restrict__ bpart, int64_t n_tiles,
                                     int64_t L, float* __restrict__ wb) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_w = 2 * L * L;
  if (idx < n_w) {
    double s = 0.0;
    for (int64_t ck = 0; ck < n_chunks; ++ck) s += wpart[ck * n_w + idx];
    wb[idx] = static_cast<float>(s);
  } else if (idx < n_w + L) {  // db2 = Σ dy1 + Σ dy2
    const int64_t c = idx - n_w;
    double s = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) s += bpart[(t * 3 + 0) * L + c] + bpart[(t * 3 + 1) * L + c];
    wb[idx] = static_cast<float>(s);
  } else if (idx < n_w + 2 * L) {  // db0 = Σ dps
    const int64_t c = idx - n_w - L;
    double s = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) s += bpart[(t * 3 + 2) * L + c];
    wb[idx] = static_cast<float>(s);
  }
}

struct Args {
  const void *a_u, *a_v, *g_v, *g_u, *e, *z_upd, *dz_upd;
  const float *dR, *dM;
  const int32_t *rcv, *gid, *block_tile;
  const void *we, *w2, *weT, *w2T, *b0, *b2;
  void *dg_v, *dg_u, *de;
  float* da;
  void* scratch;
  double *bpart, *wpart;
  float* wb;
  int64_t n_nodes, n_edges, L, tile, n_blocks, n_graphs, n_chunks;
};

template <typename T>
cudaError_t launch(const Args& a, size_t smem_tile, size_t smem_wgrad, cudaStream_t stream) {
  const int64_t n_tiles = a.n_nodes / a.tile;
  const int64_t block = a.n_edges / a.n_blocks;
  cudaError_t err = cudaFuncSetAttribute(v2_bwd_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_tile));
  if (err != cudaSuccess) return err;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  v2_bwd_tile_kernel<T><<<static_cast<unsigned>(n_tiles), static_cast<unsigned>(2 * a.L),
                          smem_tile, stream>>>(
      c(a.a_u), c(a.a_v), c(a.g_v), c(a.g_u), c(a.e), c(a.z_upd), c(a.dz_upd), a.dR, a.dM,
      a.rcv, a.gid, a.block_tile, c(a.we), c(a.w2), c(a.weT), c(a.w2T), c(a.b0), c(a.b2),
      static_cast<T*>(a.dg_v), static_cast<T*>(a.dg_u), static_cast<T*>(a.de), a.da,
      static_cast<T*>(a.scratch), a.bpart, a.n_nodes, a.n_edges, a.L, a.tile, block,
      a.n_blocks, a.n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(v2_bwd_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_wgrad));
  if (err != cudaSuccess) return err;
  const int64_t chunk = (a.n_edges + a.n_chunks - 1) / a.n_chunks;
  const dim3 grid(static_cast<unsigned>(a.n_chunks), static_cast<unsigned>(2 * (a.L / KB)));
  const unsigned threads = static_cast<unsigned>((KB / TK) * (a.L / TC));
  v2_bwd_wgrad_kernel<T><<<grid, threads, smem_wgrad, stream>>>(
      static_cast<const T*>(a.scratch), c(a.e), a.wpart, a.n_edges, a.L, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n_out = (2 * a.L + 2) * a.L;
  v2_bwd_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      a.wpart, a.n_chunks, a.bpart, n_tiles, a.L, a.wb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one CTA of the tile kernel and of the weight-grad kernel.
int64_t pdg_fused_edge_bwd_tile_smem_bytes(int64_t L) {
  return 5 * EC * L * static_cast<int64_t>(sizeof(float)) +
         EC * static_cast<int64_t>(sizeof(int) + sizeof(float));
}
int64_t pdg_fused_edge_bwd_wgrad_smem_bytes(int64_t L) {
  return EW * (KB + L) * static_cast<int64_t>(sizeof(float));
}

// Launches the backward on `stream`. Pointers are device pointers. a_u,
// a_v, g_v, g_u, e, z_upd, dz_upd, the weights, their transposes
// (weT[k][c] = we[c][k], w2T likewise), dg_v, dg_u, de and scratch
// (5, n_edges, L) are fp32 (bf16 == 0) or bf16 (bf16 == 1); dR (n_nodes,
// L), dM (8, L), da (2, n_nodes, L, zeroed by the caller) and wb (2L+2, L)
// are fp32; rcv, gid and block_tile are int32; bpart (n_nodes/tile, 3, L)
// and wpart (n_chunks, 2, L, L) are fp64 scratch. Returns a cudaError_t
// value (0 on success).
int pdg_fused_edge_bwd(int bf16, const void* a_u, const void* a_v, const void* g_v,
                       const void* g_u, const void* e, const void* z_upd, const void* dz_upd,
                       const void* dR, const void* dM, const void* rcv, const void* gid,
                       const void* block_tile, const void* we, const void* w2,
                       const void* weT, const void* w2T, const void* b0, const void* b2,
                       void* dg_v, void* dg_u, void* de, void* da, void* scratch, void* bpart,
                       void* wpart, void* wb, int64_t n_nodes, int64_t n_edges, int64_t L,
                       int64_t tile, int64_t n_blocks, int64_t n_graphs, int64_t n_chunks,
                       void* stream) {
  if (L < KB || L > 4 * KB || L % KB != 0 || tile <= 0 || n_nodes % tile != 0 ||
      n_blocks <= 0 || n_edges % n_blocks != 0 || n_chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{a_u, a_v, g_v, g_u, e, z_upd, dz_upd,
         static_cast<const float*>(dR), static_cast<const float*>(dM),
         static_cast<const int32_t*>(rcv), static_cast<const int32_t*>(gid),
         static_cast<const int32_t*>(block_tile),
         we, w2, weT, w2T, b0, b2, dg_v, dg_u, de, static_cast<float*>(da), scratch,
         static_cast<double*>(bpart), static_cast<double*>(wpart), static_cast<float*>(wb),
         n_nodes, n_edges, L, tile, n_blocks, n_graphs, n_chunks};
  const size_t smem_tile = static_cast<size_t>(pdg_fused_edge_bwd_tile_smem_bytes(L));
  const size_t smem_wgrad = static_cast<size_t>(pdg_fused_edge_bwd_wgrad_smem_bytes(L));
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch<__nv_bfloat16>(a, smem_tile, smem_wgrad, s)
                         : launch<float>(a, smem_tile, smem_wgrad, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
