// Fused edge-step backward (fused3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step3_bwd_kernel` of
// p_div_gnn_tpu/ops/fused_edge3.py (launched by `_step3_backward_pallas`
// from `_step3_bwd`, the VJP of `fused_edge_step3`). The forward
// (fused_edge3_fwd.cu) computes, for every edge slot i with receiver r,
//
//   pre1 = x[r]·Wu + g[i]·Wv + e[i]·We + b0     h1 = relu(pre1)
//   pre2 = x[r]·Wv + g[i]·Wu + e[i]·We + b0     h2 = relu(pre2)
//   z_msg = relu(h1·W2 + b2)·mask_i             z_upd = relu(h2·W2 + b2)·mask_i
//
// with R[r] += z_msg and the moment rows M = [Σz_msg, Σz_msg², Σz_upd,
// Σz_upd²]. Given the cotangents dz_upd (Ep, L), dR (Np, L) and dM (8, L)
// this backward recomputes h1, h2 and z_msg (re-masked: mask_i = 0 where
// edge_gid[i] >= n_graphs) and forms
//
//   dy1 = (dR[r] + dM0 + 2·dM1·z_msg)·(z_msg > 0)    dpre1 = dy1·W2ᵀ·(h1 > 0)
//   dy2 = (dz_upd + dM2 + 2·dM3·z_upd)·(z_upd > 0)   dpre2 = dy2·W2ᵀ·(h2 > 0)
//   dg = dpre1·Wvᵀ + dpre2·Wuᵀ       (Ep, L) stream dtype
//   de = (dpre1 + dpre2)·Weᵀ         (Ep, L) stream dtype
//   dx[r] += dpre1·Wuᵀ + dpre2·Wvᵀ   (Np, L) fp32
//   dW2 = Σ h1ᵀdy1 + h2ᵀdy2   dWe = Σ eᵀ(dpre1+dpre2)   db2 = Σ dy1+dy2
//   dWu = Σ x[r]ᵀdpre1 + gᵀdpre2   dWv = Σ x[r]ᵀdpre2 + gᵀdpre1   db0 = Σ dpre1+dpre2
//
// What bounds it on this card: 20 L×L products per edge slot (6 to
// recompute the forward, 7 for the data cotangents, 7 for the weight
// grads), 2·20·L² flops per slot against ~3.3 KB of streamed bytes per
// slot in fp32 (g, e, z_upd, dz_upd in, dg, de out, and the node rows):
// ~180 flop/byte at L=128, so the fp32 FMA rate (67 TFLOP/s; the tensor
// cores are not used) is the bound, not HBM.
//
// Design, in three launches:
// 1. `step3_bwd_tile_kernel`: one CTA per node tile, as in the forward. It
//    walks the tile's edge blocks (binary search in edge_block_tile), 16
//    edges at a time, and does the 13 per-edge products. Thread c owns
//    column c of the tile's dx rows and is their only writer (the TPU
//    kernel sums dx into a node-tile block the sequential grid revisits; no
//    atomics are needed here and the sums run in edge order): a run of
//    slots with the same receiver is summed in a register and added to dx
//    when it ends. It sums db2 and db0 for its column in fp64 into per-tile
//    partials. It writes h1, h2, dy1, dy2, dpre1, dpre2 and dpre1+dpre2,
//    rounded to the stream dtype as the weight-grad contractions take them,
//    to a scratch stream.
// 2. `step3_bwd_wgrad_kernel`: the weight-grad products Σ_i A[i]ᵀB[i]
//    over all slots, which the TPU kernel sums into one (4L+8, L) block
//    revisited by every grid step. Here the slots are cut into chunks;
//    each CTA computes one 64-row slab of one weight grad over one chunk,
//    an outer product per edge from shared memory with a 4×8 register
//    tile per thread, and writes a per-chunk partial. The products are
//    fp32 FMAs into a register that starts from zero every WG = 8 slots;
//    each such 8-slot sum is then added to an fp64 accumulator. The sums
//    run over ~2.6e5 slots at the flagship size: one fp32 chain per chunk
//    would carry its rounding at the size of the running sum (~1e-3
//    absolute on the entries that cancel to near zero, against a 2e-4
//    check), while an 8-slot chain rounds at the size of a few products,
//    close to the floor that rounding each fp32 product alone sets. The
//    fp64 adds are one per 8 FMAs, so the kernel runs at the fp32 rate.
// 3. `step3_bwd_reduce_kernel`: sums the per-chunk and per-tile partials in
//    a fixed order and rounds once to fp32, into one (4L+2, L) block
//    [dW2; dWe; dWu; dWv; db2; db0]. The result does not change from run
//    to run.
// - Each product is one FMA chain over k in order; the first-layer sum is
//   grouped as the forward groups it, so the recomputed h1, h2 and z_msg
//   are the forward's bit for bit.
// - Precision: fp32 FMA for the per-edge products (no TF32) and for the
//   8-slot weight-grad sums, fp64 for the sums of those and for db0 / db2.
//   In bf16 mode the operands of every contraction are bf16 with fp32
//   accumulation, as the JAX package's `_mms` rounds them: h, dy and dpre
//   are rounded before they are contracted, and each dx row is rounded
//   before it is added.
// - Shared memory of kernel 1 is 3·16·L·4 bytes + 128 (24.7 KB at L 128),
//   and 128 threads of at most 255 registers each take half an SM's 64 K
//   registers, so two CTAs share an SM and the 167 tiles of the flagship
//   batch run in one wave on 132 SMs. The per-thread column mapping, which
//   re-reads each weight from L2 for every 16 edges and runs no
//   tensor-core instruction, is what a faster version works on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EC = 16;   // edges staged per chunk in kernel 1
constexpr int EW = 32;   // edges staged per step in kernel 2
constexpr int KB = 64;   // weight-grad rows per CTA in kernel 2
constexpr int TK = 4;    // weight-grad rows per thread (one float4 of A)
constexpr int TC = 8;    // weight-grad columns per thread
constexpr int WG = 8;    // slots per fp32 weight-grad sum in kernel 2
static_assert(EW % WG == 0, "a staged step holds whole fp32 sums");
enum { S_H1, S_H2, S_DY1, S_DY2, S_DP1, S_DP2, S_DPS, SRC_E, SRC_G, SRC_XR };

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

// acc[i] = Σ_k rows[i][k]·w[k][c] for the EC staged rows, one FMA chain per
// output over k in order (w is (L, L) row-major, read along column c).
template <typename T>
__device__ __forceinline__ void rows_times_w(const float* rows, const T* __restrict__ w,
                                             int64_t L, int c, float (&acc)[EC]) {
#pragma unroll
  for (int i = 0; i < EC; ++i) acc[i] = 0.f;
  for (int64_t k = 0; k < L; k += 4) {
    float w_k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w_k[j] = to_f(w[(k + j) * L + c]);
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const float4 r4 = *reinterpret_cast<const float4*>(rows + i * L + k);
      acc[i] = fmaf(r4.x, w_k[0], acc[i]);
      acc[i] = fmaf(r4.y, w_k[1], acc[i]);
      acc[i] = fmaf(r4.z, w_k[2], acc[i]);
      acc[i] = fmaf(r4.w, w_k[3], acc[i]);
    }
  }
}

template <typename T>
__global__ void step3_bwd_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ e,
    const T* __restrict__ z_upd, const T* __restrict__ dz_upd,
    const float* __restrict__ dR, const float* __restrict__ dM,
    const int32_t* __restrict__ rcv, const int32_t* __restrict__ gid,
    const int32_t* __restrict__ block_tile,
    const T* __restrict__ wu, const T* __restrict__ wv, const T* __restrict__ we,
    const T* __restrict__ w2, const T* __restrict__ wuT, const T* __restrict__ wvT,
    const T* __restrict__ weT, const T* __restrict__ w2T,
    const T* __restrict__ b0, const T* __restrict__ b2,
    T* __restrict__ dg, T* __restrict__ de, float* __restrict__ dx,
    T* __restrict__ scratch, double* __restrict__ bpart,
    int64_t n_edges, int64_t L, int64_t tile, int64_t block, int64_t n_blocks,
    int64_t n_graphs) {
  extern __shared__ float4 smem4[];
  float* s0 = reinterpret_cast<float*>(smem4);    // (EC, L) x[r] → h1 → dy1 → dpre1
  float* s1 = s0 + EC * L;                        // (EC, L) g    → h2 → dy2 → dpre2
  float* s2 = s1 + EC * L;                        // (EC, L) e    →            dpre1+dpre2
  int* rl_s = reinterpret_cast<int*>(s2 + EC * L);      // (EC,) local receiver or -1
  float* mk_s = reinterpret_cast<float*>(rl_s + EC);    // (EC,) mask

  const int c = threadIdx.x;  // blockDim.x == L: thread c owns column c
  const int64_t t = blockIdx.x;
  const int64_t node_lo = t * tile;
  const int64_t e_lo = first_not_less(block_tile, n_blocks, t) * block;
  const int64_t e_hi = first_not_less(block_tile, n_blocks, t + 1) * block;
  const int64_t EL = n_edges * L;

  // dx: a run of slots with the same receiver (the layout sorts each tile's
  // slots by receiver) is summed in a register and added to dx (zeroed by
  // the caller) when the run ends; this CTA is the only writer of its tile
  float dx_run = 0.f;
  int dx_rl = -1;
  const float b0c = to_f(b0[c]);
  const float b2c = to_f(b2[c]);
  const float dm0 = dM[0 * L + c], dm1 = dM[1 * L + c];
  const float dm2 = dM[2 * L + c], dm3 = dM[3 * L + c];
  double s_db2 = 0.0, s_db0 = 0.0;

  for (int64_t base = e_lo; base < e_hi; base += EC) {
    for (int i = c; i < EC; i += blockDim.x) {
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
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      const bool valid = ei < e_hi;
      const int rl = rl_s[i];
      s0[i * L + c] = rl >= 0 ? to_f(x[(node_lo + rl) * L + c]) : 0.f;
      s1[i * L + c] = valid ? to_f(g[ei * L + c]) : 0.f;
      s2[i * L + c] = valid ? to_f(e[ei * L + c]) : 0.f;
    }
    __syncthreads();

    // --- recompute the forward's first layer, as fused_edge3_fwd.cu runs it:
    // pre = ((x·Wu + g·Wv) + e·We) + b0; bit i of on1 / on2 is pre > 0
    float h1[EC], h2[EC];
    uint32_t on1 = 0, on2 = 0;
    {
      float xu[EC], xv[EC], gu[EC], gv[EC], ep[EC];
#pragma unroll
      for (int i = 0; i < EC; ++i) xu[i] = xv[i] = gu[i] = gv[i] = ep[i] = 0.f;
      for (int64_t k = 0; k < L; k += 4) {
        float wu_k[4], wv_k[4], we_k[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wu_k[j] = to_f(wu[(k + j) * L + c]);
          wv_k[j] = to_f(wv[(k + j) * L + c]);
          we_k[j] = to_f(we[(k + j) * L + c]);
        }
#pragma unroll
        for (int i = 0; i < EC; ++i) {
          const float4 x4 = *reinterpret_cast<const float4*>(s0 + i * L + k);
          const float4 g4 = *reinterpret_cast<const float4*>(s1 + i * L + k);
          const float4 e4 = *reinterpret_cast<const float4*>(s2 + i * L + k);
          const float xa[4] = {x4.x, x4.y, x4.z, x4.w};
          const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
          const float ea[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xu[i] = fmaf(xa[j], wu_k[j], xu[i]);
            xv[i] = fmaf(xa[j], wv_k[j], xv[i]);
            gu[i] = fmaf(ga[j], wu_k[j], gu[i]);
            gv[i] = fmaf(ga[j], wv_k[j], gv[i]);
            ep[i] = fmaf(ea[j], we_k[j], ep[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const float pre1 = ((xu[i] + gv[i]) + ep[i]) + b0c;
        const float pre2 = ((xv[i] + gu[i]) + ep[i]) + b0c;
        on1 |= (pre1 > 0.f ? 1u : 0u) << i;
        on2 |= (pre2 > 0.f ? 1u : 0u) << i;
        h1[i] = round_sd<T>(fmaxf(pre1, 0.f));
        h2[i] = round_sd<T>(fmaxf(pre2, 0.f));
      }
    }
    __syncthreads();  // every thread is done reading x / g / e
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      s0[i * L + c] = h1[i];
      s1[i * L + c] = h2[i];
      if (ei < e_hi) {
        scratch[S_H1 * EL + ei * L + c] = from_f<T>(h1[i]);
        scratch[S_H2 * EL + ei * L + c] = from_f<T>(h2[i]);
      }
    }
    __syncthreads();

    // --- z_msg = relu(h1·W2 + b2)·mask, then the two output cotangents
    float dy1[EC], dy2[EC];
    {
      float am[EC];
      rows_times_w<T>(s0, w2, L, c, am);
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const int64_t ei = base + i;
        const bool valid = ei < e_hi;
        const int rl = rl_s[i];
        const float zm = fmaxf(am[i] + b2c, 0.f) * mk_s[i];
        // (dR[r] + dM0) + (2·dM1)·z, rounded after each operation as the
        // plain version rounds it (no contraction into an FMA)
        const float dzm = __fadd_rn((rl >= 0 ? dR[(node_lo + rl) * L + c] : 0.f) + dm0,
                                    __fmul_rn(2.f * dm1, zm));
        dy1[i] = dzm * (zm > 0.f ? 1.f : 0.f);
        const float zu = valid ? to_f(z_upd[ei * L + c]) : 0.f;
        const float dzu = __fadd_rn((valid ? to_f(dz_upd[ei * L + c]) : 0.f) + dm2,
                                    __fmul_rn(2.f * dm3, zu));
        dy2[i] = dzu * (zu > 0.f ? 1.f : 0.f);
        s_db2 += static_cast<double>(dy1[i] + dy2[i]);
      }
    }
    __syncthreads();  // every thread is done reading h1
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      s0[i * L + c] = round_sd<T>(dy1[i]);
      s1[i * L + c] = round_sd<T>(dy2[i]);
      if (ei < e_hi) {
        scratch[S_DY1 * EL + ei * L + c] = from_f<T>(dy1[i]);
        scratch[S_DY2 * EL + ei * L + c] = from_f<T>(dy2[i]);
      }
    }
    __syncthreads();

    // --- dpre = (dy·W2ᵀ)·(pre > 0)
    float dp1[EC], dp2[EC];
#pragma unroll
    for (int i = 0; i < EC; ++i) dp1[i] = dp2[i] = 0.f;
    for (int64_t k = 0; k < L; k += 4) {
      float w_k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w_k[j] = to_f(w2T[(k + j) * L + c]);
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(s0 + i * L + k);
        const float4 q4 = *reinterpret_cast<const float4*>(s1 + i * L + k);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dp1[i] = fmaf(pa[j], w_k[j], dp1[i]);
          dp2[i] = fmaf(qa[j], w_k[j], dp2[i]);
        }
      }
    }
    __syncthreads();  // every thread is done reading dy
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      dp1[i] *= (on1 >> i) & 1u ? 1.f : 0.f;
      dp2[i] *= (on2 >> i) & 1u ? 1.f : 0.f;
      const float dps = dp1[i] + dp2[i];
      s_db0 += static_cast<double>(dps);
      s0[i * L + c] = round_sd<T>(dp1[i]);
      s1[i * L + c] = round_sd<T>(dp2[i]);
      s2[i * L + c] = round_sd<T>(dps);
      if (ei < e_hi) {
        scratch[S_DP1 * EL + ei * L + c] = from_f<T>(dp1[i]);
        scratch[S_DP2 * EL + ei * L + c] = from_f<T>(dp2[i]);
        scratch[S_DPS * EL + ei * L + c] = from_f<T>(dps);
      }
    }
    __syncthreads();

    // --- dg = dpre1·Wvᵀ + dpre2·Wuᵀ, de = dps·Weᵀ, dx[r] += dpre1·Wuᵀ + dpre2·Wvᵀ
    {
      float a1[EC], a2[EC], a3[EC], a4[EC], a5[EC];
#pragma unroll
      for (int i = 0; i < EC; ++i) a1[i] = a2[i] = a3[i] = a4[i] = a5[i] = 0.f;
      for (int64_t k = 0; k < L; k += 4) {
        float wu_k[4], wv_k[4], we_k[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wu_k[j] = to_f(wuT[(k + j) * L + c]);
          wv_k[j] = to_f(wvT[(k + j) * L + c]);
          we_k[j] = to_f(weT[(k + j) * L + c]);
        }
#pragma unroll
        for (int i = 0; i < EC; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(s0 + i * L + k);
          const float4 q4 = *reinterpret_cast<const float4*>(s1 + i * L + k);
          const float4 s4 = *reinterpret_cast<const float4*>(s2 + i * L + k);
          const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
          const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
          const float sa[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a1[i] = fmaf(pa[j], wv_k[j], a1[i]);
            a2[i] = fmaf(qa[j], wu_k[j], a2[i]);
            a3[i] = fmaf(sa[j], we_k[j], a3[i]);
            a4[i] = fmaf(pa[j], wu_k[j], a4[i]);
            a5[i] = fmaf(qa[j], wv_k[j], a5[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const int64_t ei = base + i;
        if (ei < e_hi) {
          dg[ei * L + c] = from_f<T>(a1[i] + a2[i]);
          de[ei * L + c] = from_f<T>(a3[i]);
        }
        const int rl = rl_s[i];
        if (rl < 0) continue;
        if (rl != dx_rl) {
          if (dx_rl >= 0) dx[(node_lo + dx_rl) * L + c] += dx_run;
          dx_run = 0.f;
          dx_rl = rl;
        }
        dx_run += round_sd<T>(a4[i] + a5[i]);
      }
    }
    __syncthreads();  // s0 / s1 / s2 / rl_s / mk_s are restaged next chunk
  }

  if (dx_rl >= 0) dx[(node_lo + dx_rl) * L + c] += dx_run;
  bpart[(t * 2 + 0) * L + c] = s_db2;
  bpart[(t * 2 + 1) * L + c] = s_db0;
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
// past `end` are zero. Stream SRC_XR reads x at the slot's receiver. Each
// warp loads whole rows, four values per lane and load.
template <typename T>
__device__ __forceinline__ void stage_operand(
    float* dst, int src, int64_t col0, int width, int64_t base, int64_t end,
    const T* __restrict__ scratch, const T* __restrict__ x, const T* __restrict__ g,
    const T* __restrict__ e, const int32_t* __restrict__ rcv, int64_t n_nodes,
    int64_t n_edges, int64_t L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int i = warp; i < EW; i += n_warps) {
    const int64_t ei = base + i;
    const T* row = nullptr;
    if (ei < end) {
      if (src == SRC_XR) {
        const int64_t r = rcv[ei];
        if (r >= 0 && r < n_nodes) row = x + r * L;
      } else if (src == SRC_G) {
        row = g + ei * L;
      } else if (src == SRC_E) {
        row = e + ei * L;
      } else {
        row = scratch + (src * n_edges + ei) * L;
      }
    }
    for (int j4 = lane; j4 < width / 4; j4 += 32) {
      const float4 v = row ? load4(row + col0 + 4 * j4) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + i * width + 4 * j4) = v;
    }
  }
}

// One 64-row slab of one weight grad over one chunk of slots:
// wpart[chunk][mat][k][c] = Σ_{i in chunk} Σ_pairs A[i][k]·B[i][c], fp32 over
// each WG slots, fp64 across them.
template <typename T>
__global__ void step3_bwd_wgrad_kernel(
    const T* __restrict__ scratch, const T* __restrict__ x, const T* __restrict__ g,
    const T* __restrict__ e, const int32_t* __restrict__ rcv, double* __restrict__ wpart,
    int64_t n_nodes, int64_t n_edges, int64_t L, int64_t chunk) {
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

  // (A, B) stream pairs of each weight grad: dW2, dWe, dWu, dWv
  int pa[2], pb[2], n_pairs;
  if (mat == 0) { pa[0] = S_H1; pb[0] = S_DY1; pa[1] = S_H2; pb[1] = S_DY2; n_pairs = 2; }
  else if (mat == 1) { pa[0] = SRC_E; pb[0] = S_DPS; pa[1] = 0; pb[1] = 0; n_pairs = 1; }
  else if (mat == 2) { pa[0] = SRC_XR; pb[0] = S_DP1; pa[1] = SRC_G; pb[1] = S_DP2; n_pairs = 2; }
  else { pa[0] = SRC_XR; pb[0] = S_DP2; pa[1] = SRC_G; pb[1] = S_DP1; n_pairs = 2; }

  double acc[TK][TC];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TC; ++b) acc[a][b] = 0.0;

  for (int p = 0; p < n_pairs; ++p) {
    for (int64_t base = lo; base < hi; base += EW) {
      __syncthreads();  // the previous step's operands are consumed
      stage_operand<T>(a_s, pa[p], k0, KB, base, hi, scratch, x, g, e, rcv, n_nodes,
                       n_edges, L);
      stage_operand<T>(b_s, pb[p], 0, static_cast<int>(L), base, hi, scratch, x, g, e, rcv,
                       n_nodes, n_edges, L);
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
  double* out = wpart + (ck * 4 + mat) * L * L;
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TC; ++b) out[(k0 + ty * TK + a) * L + b * n_tx + tx] = acc[a][b];
}

// wb = [dW2; dWe; dWu; dWv; db2; db0] (4L+2, L) fp32: the per-chunk and
// per-tile partials summed in order in fp64, rounded once.
__global__ void step3_bwd_reduce_kernel(const double* __restrict__ wpart, int64_t n_chunks,
                                        const double* __restrict__ bpart, int64_t n_tiles,
                                        int64_t L, float* __restrict__ wb) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_w = 4 * L * L;
  if (idx < n_w) {
    double s = 0.0;
    for (int64_t ck = 0; ck < n_chunks; ++ck) s += wpart[ck * n_w + idx];
    wb[idx] = static_cast<float>(s);
  } else if (idx < n_w + 2 * L) {
    const int64_t j = (idx - n_w) / L, c = (idx - n_w) % L;
    double s = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) s += bpart[(t * 2 + j) * L + c];
    wb[idx] = static_cast<float>(s);
  }
}

struct Args {
  const void *x, *g, *e, *z_upd, *dz_upd;
  const float *dR, *dM;
  const int32_t *rcv, *gid, *block_tile;
  const void *wu, *wv, *we, *w2, *wuT, *wvT, *weT, *w2T, *b0, *b2;
  void *dg, *de;
  float* dx;
  void* scratch;
  double *bpart, *wpart;
  float* wb;
  int64_t n_nodes, n_edges, L, tile, n_blocks, n_graphs, n_chunks;
};

template <typename T>
cudaError_t launch(const Args& a, size_t smem_tile, size_t smem_wgrad, cudaStream_t stream) {
  const int64_t n_tiles = a.n_nodes / a.tile;
  const int64_t block = a.n_blocks > 0 ? a.n_edges / a.n_blocks : 0;
  cudaError_t err = cudaFuncSetAttribute(step3_bwd_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_tile));
  if (err != cudaSuccess) return err;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  step3_bwd_tile_kernel<T><<<static_cast<unsigned>(n_tiles), static_cast<unsigned>(a.L),
                             smem_tile, stream>>>(
      c(a.x), c(a.g), c(a.e), c(a.z_upd), c(a.dz_upd), a.dR, a.dM, a.rcv, a.gid, a.block_tile,
      c(a.wu), c(a.wv), c(a.we), c(a.w2), c(a.wuT), c(a.wvT), c(a.weT), c(a.w2T), c(a.b0),
      c(a.b2), static_cast<T*>(a.dg), static_cast<T*>(a.de), a.dx, static_cast<T*>(a.scratch),
      a.bpart, a.n_edges, a.L, a.tile, block, a.n_blocks, a.n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(step3_bwd_wgrad_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_wgrad));
  if (err != cudaSuccess) return err;
  const int64_t chunk = (a.n_edges + a.n_chunks - 1) / a.n_chunks;
  const dim3 grid(static_cast<unsigned>(a.n_chunks), static_cast<unsigned>(4 * (a.L / KB)));
  const unsigned threads = static_cast<unsigned>((KB / TK) * (a.L / TC));
  step3_bwd_wgrad_kernel<T><<<grid, threads, smem_wgrad, stream>>>(
      static_cast<const T*>(a.scratch), c(a.x), c(a.g), c(a.e), a.rcv, a.wpart, a.n_nodes,
      a.n_edges, a.L, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n_out = (4 * a.L + 2) * a.L;
  step3_bwd_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      a.wpart, a.n_chunks, a.bpart, n_tiles, a.L, a.wb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one CTA of the tile kernel and of the weight-grad kernel.
int64_t pdg_fused_edge3_bwd_tile_smem_bytes(int64_t L) {
  return 3 * EC * L * static_cast<int64_t>(sizeof(float)) +
         EC * static_cast<int64_t>(sizeof(int) + sizeof(float));
}
int64_t pdg_fused_edge3_bwd_wgrad_smem_bytes(int64_t L) {
  return EW * (KB + L) * static_cast<int64_t>(sizeof(float));
}

// Launches the backward on `stream`. Pointers are device pointers. x, g, e,
// z_upd, dz_upd, the weights, their transposes (wuT[k][c] = wu[c][k], ...),
// dg, de and scratch (7, n_edges, L) are fp32 (bf16 == 0) or bf16
// (bf16 == 1); dR (n_nodes, L), dM (8, L), dx (n_nodes, L, zeroed by the
// caller) and wb (4L+2, L) are fp32; rcv, gid and block_tile are int32; bpart (n_nodes/tile, 2, L)
// and wpart (n_chunks, 4, L, L) are fp64 scratch. Returns a cudaError_t
// value (0 on success).
int pdg_fused_edge3_bwd(int bf16, const void* x, const void* g, const void* e,
                        const void* z_upd, const void* dz_upd, const void* dR, const void* dM,
                        const void* rcv, const void* gid, const void* block_tile,
                        const void* wu, const void* wv, const void* we, const void* w2,
                        const void* wuT, const void* wvT, const void* weT, const void* w2T,
                        const void* b0, const void* b2, void* dg, void* de, void* dx,
                        void* scratch, void* bpart, void* wpart, void* wb, int64_t n_nodes,
                        int64_t n_edges, int64_t L, int64_t tile, int64_t n_blocks,
                        int64_t n_graphs, int64_t n_chunks, void* stream) {
  if (L < KB || L > 4 * KB || L % KB != 0 || tile <= 0 || n_nodes % tile != 0 ||
      n_blocks <= 0 || n_edges % n_blocks != 0 || n_chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{x, g, e, z_upd, dz_upd,
         static_cast<const float*>(dR), static_cast<const float*>(dM),
         static_cast<const int32_t*>(rcv), static_cast<const int32_t*>(gid),
         static_cast<const int32_t*>(block_tile),
         wu, wv, we, w2, wuT, wvT, weT, w2T, b0, b2, dg, de, static_cast<float*>(dx), scratch,
         static_cast<double*>(bpart), static_cast<double*>(wpart), static_cast<float*>(wb),
         n_nodes, n_edges, L, tile, n_blocks, n_graphs, n_chunks};
  const size_t smem_tile = static_cast<size_t>(pdg_fused_edge3_bwd_tile_smem_bytes(L));
  const size_t smem_wgrad = static_cast<size_t>(pdg_fused_edge3_bwd_wgrad_smem_bytes(L));
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch<__nv_bfloat16>(a, smem_tile, smem_wgrad, s)
                         : launch<float>(a, smem_tile, smem_wgrad, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
