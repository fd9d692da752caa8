// The one-pass backward of the v2 edge step, shared by the receiver-major
// v2 backward (fused_edge_bwd.cu, #6) and the pair-blocked one
// (fused_edge2_bwd.cu, #8): the tile kernel, the zero rows of the
// pair-blocked layout's padding slots, and the launch sequence. An
// including source includes "mma_sm90.cuh", "fused3_tile.cuh" and
// "bwd_common.cuh" first. Everything here lives in an anonymous namespace.
//
// For each entry i of a list of edge slots (#6: every slot, in order; #8:
// the real slots, each receiver's consecutive) with slot s_i, receiver r
// and the first layer's other addends (#6: a_u[r] + g_v[s_i] and a_v[r] +
// g_u[s_i]; #8: u[r] + v[snd] and v[r] + u[snd], an endpoint outside its
// block's tile reading 0), the tile kernel recomputes
//
//   ep = e·We   pre1 = ((a1 + g1) + ep) + b0   pre2 = ((a2 + g2) + ep) + b0
//   h1 = relu(pre1), h2 = relu(pre2)           z_msg = relu(h1·W2 + b2)·mask
//
// and forms dy1, dy2, dpre1 = (dy1·W2ᵀ)·(pre1 > 0), dpre2 = (dy2·W2ᵀ)·(pre2 >
// 0), de = (dpre1 + dpre2)·Weᵀ, the receiver sums of dpre1 and dpre2, and
// the per-part sums of dy1 + dy2 (db2) and dpre1 + dpre2 (db0); the weight
// grads dW2 = Σ h1ᵀdy1 + h2ᵀdy2 and dWe = Σ eᵀ(dpre1 + dpre2) follow in
// bwd_common.cuh's weight-grad kernel.
//
// Which products run where (the rule of the fused3 backward, fused_edge3_bwd.cu):
// the four products whose results feed a relu gate, a bf16 rounding or a
// weight-grad sum, e·We (both pre-activations), h1·W2 (the z_msg gate),
// dy1·W2ᵀ and dy2·W2ᵀ (the h gates, dpre and every weight grad), are fp32
// FMA chains over k in order, bit-equal to the plain version's products:
// fused3_tile.cuh's register tile (a 4 x 4 block a thread, operands from
// transposed fp32 tiles, the weights We, W2, W2ᵀ from a two-stage cp.async
// ring of 2·KF-row chunks). de = dps·Weᵀ feeds no gate and runs on the
// tensor cores (mma.sync m16n8k16; in fp32 mode both operands split into
// three bf16 terms, the six cross products summed, each k16 block from 0),
// Weᵀ resident in shared memory at L <= 128, from a ring at 256; so do the
// weight grads.
//
// The grid: one CTA of 8 warps per part of ~V2_PART = 512 entries, the
// part's ends moved to the next receiver-run boundary (part_bounds), so
// each receiver's entries lie in one CTA, the only writer of its two rows
// of da: its threads sum a column of a run in fp64 in entry order and write
// it once (no atomics, no zeroed scratch rows). A part walks its entries in
// edge steps of S = fma_rows<L>() (64, 32, 16 at L = 64, 128, 256). h1, h2,
// dy1, dy2 and dpre1 + dpre2, rounded to the stream dtype as the weight-grad
// contractions take them, go to a 5-stream scratch in entry order; db2 and
// db0 to per-part fp64 partials. Every sum runs in a fixed order: two calls
// give bit-equal outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V2_PART = 512;  // entries per tile-kernel CTA, before the run alignment
// the scratch streams of the weight grads, in entry order, then the e stream
enum { V_H1, V_H2, V_DY1, V_DY2, V_DPS, V_E };
// the weights: We, W2, W2ᵀ in fp32 for the chains, then Weᵀ split for the
// tensor cores
constexpr int V2_FMA = 3, V2_WEIGHTS = 4;

// rows of We, W2 or W2ᵀ in a ring chunk: 2·KF
template <int L> __host__ __device__ constexpr int v2_kf() { return L <= 128 ? 32 : 16; }
// Weᵀ's terms stay resident in shared memory at L <= 128 (96 KB in fp32
// mode); at 256 they stream through the split-weight ring
template <int L> __host__ __device__ constexpr bool v2_resident() { return L <= 128; }

struct V2TileArgs {
  const void *a1, *a2;      // (Np, L): the receiver rows of pre1, pre2 (#6 a_u, a_v; #8 u, v)
  const void *g1, *g2;      // #6: g_v, g_u (Ep, L) at the slot; #8: v, u (Np, L) at the sender
  const void *e, *z_upd, *dz_upd;  // (Ep, L)
  const float *dR, *dM;     // (Np, L), (8, L)
  const int32_t* rcv;       // (n,) each entry's receiver (-1: none), consecutive runs
  const int32_t* snd;       // #8: (n,) each entry's sender (-1: none); #6: null
  const int32_t* slot;      // #8: (n,) each entry's slot; #6: null (entry i is slot i)
  const int32_t* gid;       // #6: (Ep,) graph of each slot (mask); #8: null (all real)
  const void *b0, *b2;
  const float* wfma;        // (3, L, L) fp32: We, W2, W2ᵀ
  const uint16_t* wsplit;   // (1, NT, L, L) bf16 terms of Weᵀ
  void *d1, *d2, *de;       // (Ep, L) dpre1, dpre2 (#6: dg_v, dg_u), de
  float* da;                // (2, Np, L) receiver sums of dpre1, dpre2
  void* scratch;            // (5, n, L) h1, h2, dy1, dy2, dps in entry order
  double* bpart;            // (n_parts, 2, L) db2, db0 column sums of each CTA
  int64_t n_nodes, n, n_graphs;
};

// Bytes of the operand region: three transposed fp32 operands of the chains
// (eᵀ then h1ᵀ, dy1ᵀ, dy2ᵀ), then over them the NT-term tile of dps and the
// step's dpre1 and dpre2 rows (fma_rows<L>() · L = 4096 values a row set).
template <typename T, int NT, int L>
__host__ __device__ constexpr int64_t v2_region_bytes() {
  constexpr int64_t S = fma_rows<L>();
  constexpr int64_t chains = 3 * L * S * 4, tail = NT * S * L * 2 + 2 * S * L * sizeof(T);
  return chains > tail ? chains : tail;
}

template <typename T, int NT, int L>
__host__ __device__ constexpr int64_t v2_tile_smem_bytes() {
  return v2_region_bytes<T, NT, L>() + 2 * 2 * v2_kf<L>() * L * 4 +
         (v2_resident<L>() ? NT * L * L * 2 : 2 * NT * KC * L * 2) + 16 +
         4 * fma_rows<L>() * 4 + 6 * L * 4;
}

// The tile kernel's body; `v2_bwd_tile_kernel` (#6) and
// `pair_bwd_tile_kernel` (#8) launch it.
template <typename T, int NT, int L, bool PAIR>
__device__ __forceinline__ void v2_bwd_tile(const V2TileArgs& a) {
  constexpr int S = fma_rows<L>();  // entries of an edge step
  constexpr int KF = v2_kf<L>();
  constexpr bool RES = v2_resident<L>();
  static_assert(v2_tile_smem_bytes<T, NT, L>() <= 232448, "fits an SM's 227 KB");
  extern __shared__ float4 smem4[];
  float* at0 = reinterpret_cast<float*>(smem4);  // (L, S): eᵀ → h1ᵀ
  float* at1 = at0 + L * S;                      // dy1ᵀ
  float* at2 = at1 + L * S;                      // dy2ᵀ
  // over them once dy1ᵀ, dy2ᵀ are consumed: the dps terms, the dpre rows
  uint16_t* op = reinterpret_cast<uint16_t*>(smem4);  // NT × (S, L)
  T* dp_s = reinterpret_cast<T*>(op + NT * S * L);    // (2, S, L) dpre1, dpre2
  float* fring_s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                            v2_region_bytes<T, NT, L>());  // fp32 weight ring
  // the split-weight ring, or (RES) Weᵀ's terms
  uint16_t* sring_s = reinterpret_cast<uint16_t*>(fring_s + 2 * 2 * KF * L);
  int64_t* bounds_s =
      reinterpret_cast<int64_t*>(sring_s + (RES ? NT * L * L : 2 * NT * KC * L));  // (2,)
  int* slot_s = reinterpret_cast<int*>(bounds_s + 2);  // (S,) slot or -1
  int* rcv_s = slot_s + S;                             // (S,) receiver or -1
  int* snd_s = rcv_s + S;                              // (S,) sender or -1 (#8)
  float* mask_s = reinterpret_cast<float*>(snd_s + S);  // (S,)
  float* cst_s = mask_s + S;  // (6, L): b0, b2, dM0, dM1, dM2, dM3

  const T* a1 = static_cast<const T*>(a.a1);
  const T* a2 = static_cast<const T*>(a.a2);
  const T* g1 = static_cast<const T*>(a.g1);
  const T* g2 = static_cast<const T*>(a.g2);
  const T* e = static_cast<const T*>(a.e);
  const T* z_upd = static_cast<const T*>(a.z_upd);
  const T* dz_upd = static_cast<const T*>(a.dz_upd);
  T* d1 = static_cast<T*>(a.d1);
  T* d2 = static_cast<T*>(a.d2);
  T* de = static_cast<T*>(a.de);
  T* scratch = static_cast<T*>(a.scratch);
  const int64_t NL = a.n * L;
  const int tid = static_cast<int>(threadIdx.x);

  // this CTA's entries: [V2_PART·b, V2_PART·(b+1)), both ends moved to the
  // next start of a receiver run
  if (tid < 32) {
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * V2_PART;
    const int64_t s1 = s0 + V2_PART < a.n ? s0 + V2_PART : a.n;
    part_bounds(a.rcv, s0, s1, a.n, bounds_s);
  }
  for (int i = tid; i < L; i += THREADS) {
    cst_s[0 * L + i] = to_f(static_cast<const T*>(a.b0)[i]);
    cst_s[1 * L + i] = to_f(static_cast<const T*>(a.b2)[i]);
    for (int j = 0; j < 4; ++j) cst_s[(2 + j) * L + i] = a.dM[j * L + i];
  }
  __syncthreads();
  const int64_t lo = bounds_s[0], hi = bounds_s[1];
  double* bpart = a.bpart + static_cast<int64_t>(blockIdx.x) * 2 * L;
  if (lo >= hi) {  // the whole CTA: a run longer than V2_PART took its entries
    for (int i = tid; i < 2 * L; i += THREADS) bpart[i] = 0.0;
    return;
  }

  Fp32Ring<L, KF, 3, 0> fring{a.wfma, fring_s, 0};
  SplitRing<NT, L, 1> sring{a.wsplit, sring_s, 0};
  fring.issue(0);
  if constexpr (RES) {
    load_resident<NT, L, 1>(sring_s, a.wsplit);
  } else {
    sring.issue(0);
  }
  const int r0 = quad_row<L>(), c0 = quad_col<L>();
  // the receiver sums: thread t sums columns t + THREADS·j of [dpre1 | dpre2]
  // (2L columns) over the current receiver run, in fp64
  constexpr int CPT = 2 * L > THREADS ? 2 * L / THREADS : 1;
  double run[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) run[j] = 0.0;
  int run_r = -1;
  auto flush = [&]() {
    if (run_r < 0) return;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int cc = tid + j * THREADS;
      if (cc < 2 * L)
        a.da[(static_cast<int64_t>(cc / L) * a.n_nodes + run_r) * L + cc % L] =
            static_cast<float>(run[j]);
    }
  };
  // db2 = Σ dy1 + dy2 and db0 = Σ dpre1 + dpre2 over this thread's rows, per
  // column of its quad, in fp64
  double db2[4] = {0.0, 0.0, 0.0, 0.0}, db0[4] = {0.0, 0.0, 0.0, 0.0};
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const Raw4<T> zr{};  // raw bits of four zeros

#pragma unroll 1
  for (int64_t base = lo; base < hi; base += S) {
    const int n = static_cast<int>(hi - base < S ? hi - base : S);
    if (tid < S) {
      int sl = -1, r = -1, sn = -1;
      float m = 0.f;
      if (tid < n) {
        const int64_t i = base + tid;
        sl = PAIR ? a.slot[i] : static_cast<int>(i);
        r = a.rcv[i];
        if (r < 0 || r >= a.n_nodes) r = -1;
        if constexpr (PAIR) {
          sn = a.snd[i];
          if (sn < 0 || sn >= a.n_nodes) sn = -1;
          m = 1.f;
        } else {
          m = a.gid[i] < a.n_graphs ? 1.f : 0.f;
        }
      }
      slot_s[tid] = sl;
      rcv_s[tid] = r;
      snd_s[tid] = sn;
      mask_s[tid] = m;
    }
    __syncthreads();
    // eᵀ into at0; the first layer's other addends of this thread's rows
    // into registers, raw, all loads out before any use
    Raw4<T> av1[4], av2[4], gv1[4], gv2[4];
    {
      float4 v[rows_per_thread<L>()];
#pragma unroll
      for (int u = 0; u < rows_per_thread<L>(); ++u) {
        const int p = tid + u * THREADS, row = p % S, col = (p / S) * 4;
        v[u] = row < n ? load4(e + static_cast<int64_t>(slot_s[row]) * L + col) : z4;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
        const int r = keep(WITHOUT_GATHER) ? rcv_s[row] : -1;
        av1[i] = r >= 0 ? raw4(a1 + static_cast<int64_t>(r) * L + c0) : zr;
        av2[i] = r >= 0 ? raw4(a2 + static_cast<int64_t>(r) * L + c0) : zr;
        const int src = !keep(WITHOUT_GATHER) ? -1 : PAIR ? snd_s[row]
                                                    : (row < n ? slot_s[row] : -1);
        gv1[i] = src >= 0 ? raw4(g1 + static_cast<int64_t>(src) * L + c0) : zr;
        gv2[i] = src >= 0 ? raw4(g2 + static_cast<int64_t>(src) * L + c0) : zr;
      }
#pragma unroll
      for (int u = 0; u < rows_per_thread<L>(); ++u) {
        const int p = tid + u * THREADS, row = p % S, col = (p / S) * 4;
        at0[(col + 0) * S + row] = v[u].x;
        at0[(col + 1) * S + row] = v[u].y;
        at0[(col + 2) * S + row] = v[u].z;
        at0[(col + 3) * S + row] = v[u].w;
      }
    }
    __syncthreads();

    // --- ep = e·We on an FMA chain, then h1, h2 as the forward forms them
    uint32_t on1 = 0, on2 = 0;  // relu gates of the quad, bit 4·i + j
    {
      Quad ep;
      ep.zero();
#pragma unroll 1
      for (int k0 = 0; k0 < L; k0 += 2 * KF) {
        const float* wc = fring.acquire();
        fma_chunk<L, 2 * KF, 1>({&ep}, {at0}, {wc}, k0);
        fring.release();
      }
      __syncthreads();  // every warp is done with eᵀ, whose place h1ᵀ takes
      float h2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a14 = cvt4(av1[i]), a24 = cvt4(av2[i]), g14 = cvt4(gv1[i]),
                     g24 = cvt4(gv2[i]);
        const float a1v[4] = {a14.x, a14.y, a14.z, a14.w};
        const float a2v[4] = {a24.x, a24.y, a24.z, a24.w};
        const float g1v[4] = {g14.x, g14.y, g14.z, g14.w};
        const float g2v[4] = {g24.x, g24.y, g24.z, g24.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b0c = cst_s[c0 + j];
          const float p1 = ((a1v[j] + g1v[j]) + ep.v[i][j]) + b0c;
          const float p2 = ((a2v[j] + g2v[j]) + ep.v[i][j]) + b0c;
          on1 |= (p1 > 0.f ? 1u : 0u) << (4 * i + j);
          on2 |= (p2 > 0.f ? 1u : 0u) << (4 * i + j);
          ep.v[i][j] = round_sd<T>(fmaxf(p1, 0.f));  // h1
          h2[i][j] = round_sd<T>(fmaxf(p2, 0.f));
        }
      }
      put_quad_t<L>(at0, ep);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < n) {
          store4(scratch + V_H1 * NL + (base + r0 + i) * L + c0, ep.v[i]);
          store4(scratch + V_H2 * NL + (base + r0 + i) * L + c0, h2[i]);
        }
    }
    __syncthreads();

    // --- z_msg = relu(h1·W2 + b2)·mask, then the two output cotangents
    {
      float4 dr[4];  // every row's loads out before the chain, z_upd and dz_upd raw
      Raw4<T> zu[4], dzu[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i, r = rcv_s[row];
        const int64_t sl = slot_s[row];
        dr[i] = r >= 0 ? load4(a.dR + static_cast<int64_t>(r) * L + c0) : z4;
        zu[i] = row < n ? raw4(z_upd + sl * L + c0) : zr;
        dzu[i] = row < n ? raw4(dz_upd + sl * L + c0) : zr;
      }
      Quad am;
      am.zero();
#pragma unroll 1
      for (int k0 = 0; k0 < L; k0 += 2 * KF) {
        const float* wc = fring.acquire();
        fma_chunk<L, 2 * KF, 1>({&am}, {at0}, {wc}, k0);
        fring.release();
      }
      Quad dy1, dy2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
        const float4 zu4 = cvt4(zu[i]), dzu4 = cvt4(dzu[i]);
        const float drv[4] = {dr[i].x, dr[i].y, dr[i].z, dr[i].w},
                    zuv[4] = {zu4.x, zu4.y, zu4.z, zu4.w},
                    dzv[4] = {dzu4.x, dzu4.y, dzu4.z, dzu4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float zm = fmaxf(am.v[i][j] + cst_s[L + c], 0.f) * mask_s[row];
          // the pair-blocked kernel contracts dR in the stream dtype, as
          // `_step2_bwd_kernel` does; the v2 one takes it unrounded
          const float dri = PAIR ? round_sd<T>(drv[j]) : drv[j];
          // (dR[r] + dM0) + (2·dM1)·z, rounded after each operation as the
          // plain version rounds it (no contraction into an FMA)
          const float dzm =
              __fadd_rn(dri + cst_s[2 * L + c], __fmul_rn(2.f * cst_s[3 * L + c], zm));
          dy1.v[i][j] = dzm * (zm > 0.f ? 1.f : 0.f);
          const float dz2 =
              __fadd_rn(dzv[j] + cst_s[4 * L + c], __fmul_rn(2.f * cst_s[5 * L + c], zuv[j]));
          dy2.v[i][j] = dz2 * (zuv[j] > 0.f ? 1.f : 0.f);
          db2[j] += static_cast<double>(dy1.v[i][j] + dy2.v[i][j]);
        }
        if (row < n) {
          store4(scratch + V_DY1 * NL + (base + row) * L + c0, dy1.v[i]);
          store4(scratch + V_DY2 * NL + (base + row) * L + c0, dy2.v[i]);
        }
      }
      // the operands of the next products, rounded as the plain version's
      // products take them
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dy1.v[i][j] = round_sd<T>(dy1.v[i][j]);
          dy2.v[i][j] = round_sd<T>(dy2.v[i][j]);
        }
      put_quad_t<L>(at1, dy1);
      put_quad_t<L>(at2, dy2);
    }
    __syncthreads();

    // --- dpre = (dy·W2ᵀ)·(pre > 0) on FMA chains: the d1, d2 rows, the dps
    // tile and scratch, the dpre rows of the receiver sums
    {
      Quad dp1, dp2;
      dp1.zero();
      dp2.zero();
#pragma unroll 1
      for (int k0 = 0; k0 < L; k0 += 2 * KF) {
        const float* wc = fring.acquire();
        fma_chunk<L, 2 * KF, 2>({&dp1, &dp2}, {at1, at2}, {wc, wc}, k0);
        fring.release();
      }
      __syncthreads();  // every warp is done with dy1ᵀ and dy2ᵀ, over which the tiles go
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
        float p[4], q[4], s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = dp1.v[i][j] * ((on1 >> (4 * i + j)) & 1u ? 1.f : 0.f);
          q[j] = dp2.v[i][j] * ((on2 >> (4 * i + j)) & 1u ? 1.f : 0.f);
          s[j] = p[j] + q[j];
          db0[j] += static_cast<double>(s[j]);
        }
        put4<NT, L>(op, S * L, row, c0, make_float4(s[0], s[1], s[2], s[3]));
        store4(dp_s + row * L + c0, p);  // rounded to the stream dtype as the sums take them
        store4(dp_s + (S + row) * L + c0, q);
        if (row < n) {
          const int64_t o = static_cast<int64_t>(slot_s[row]) * L + c0;
          store4(d1 + o, p);
          store4(d2 + o, q);
          store4(scratch + V_DPS * NL + (base + row) * L + c0, s);
        }
      }
    }
    __syncthreads();

    // --- de = dps·Weᵀ on the tensor cores
    {
      Frag<L, S> f;
      f.zero();
      mma_weight<NT, L, 1, S, RES>(sring, sring_s, 0, {&f}, {op});
      for_pairs<L, S>(f, [&](int row, int col, float& v0, float& v1) {
        if (row < n) store2(de + static_cast<int64_t>(slot_s[row]) * L + col, v0, v1);
      });
    }
    // --- the receiver runs: column sums in entry order, each run written once
    for (int i = 0; i < (keep(WITHOUT_RUNS) ? n : 0); ++i) {
      const int r = rcv_s[i];
      if (r != run_r) {
        flush();
#pragma unroll
        for (int j = 0; j < CPT; ++j) run[j] = 0.0;
        run_r = r;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int cc = tid + j * THREADS;
        if (cc < 2 * L) run[j] += to_f(dp_s[(cc / L) * S * L + i * L + cc % L]);
      }
    }
    __syncthreads();  // the entries and the tiles are restaged next step
  }
  flush();
  // the lanes of a column group (lanes l, l + L/32, ...), in a fixed xor tree
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int o = L / 32; o < 32; o <<= 1) {
      db2[j] += __shfl_xor_sync(FULL, db2[j], o);
      db0[j] += __shfl_xor_sync(FULL, db0[j], o);
    }
  }
  if (tid % 32 < L / 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bpart[c0 + j] = db2[j];
      bpart[L + c0 + j] = db0[j];
    }
  }
  cp_async_wait<0>();
}

template <typename T, int NT, int L>
__global__ void __launch_bounds__(THREADS, 1) v2_bwd_tile_kernel(const V2TileArgs a) {
  v2_bwd_tile<T, NT, L, false>(a);
}

template <typename T, int NT, int L>
__global__ void __launch_bounds__(THREADS, 1) pair_bwd_tile_kernel(const V2TileArgs a) {
  v2_bwd_tile<T, NT, L, true>(a);
}

// Zero rows of d1, d2 and de at the slots rows[0, n_rows) (the pair-blocked
// layout's padding slots), 16 bytes a thread.
template <typename T>
__global__ void zero_rows_kernel(T* __restrict__ d1, T* __restrict__ d2, T* __restrict__ de,
                                 const int32_t* __restrict__ rows, int64_t n_rows, int64_t L) {
  const int64_t per_row = L * static_cast<int64_t>(sizeof(T)) / 16;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3 * n_rows * per_row) return;
  const int64_t k = idx % per_row, rr = (idx / per_row) % n_rows, w = idx / (per_row * n_rows);
  T* out = w == 0 ? d1 : w == 1 ? d2 : de;
  const uint4 zero = {0u, 0u, 0u, 0u};
  reinterpret_cast<uint4*>(out + static_cast<int64_t>(rows[rr]) * L)[k] = zero;
}

// Dynamic shared memory of the tile kernel (which == 0) or of the
// weight-grad kernel (which == 1), bytes.
template <typename T, int NT, int L>
int64_t v2_smem_of(int which) {
  return which == 0 ? v2_tile_smem_bytes<T, NT, L>() : wgrad_ws_smem_bytes<T, NT>();
}
inline int64_t v2_bwd_smem(int bf16, int64_t L, int which) {
  using B = __nv_bfloat16;
  if (bf16)
    return L == 64    ? v2_smem_of<B, 1, 64>(which)
           : L == 128 ? v2_smem_of<B, 1, 128>(which)
                      : v2_smem_of<B, 1, 256>(which);
  return L == 64    ? v2_smem_of<float, 3, 64>(which)
         : L == 128 ? v2_smem_of<float, 3, 128>(which)
                    : v2_smem_of<float, 3, 256>(which);
}

// Entries of a tile-kernel part: the rows of bpart.
inline int64_t v2_parts(int64_t n) { return (n + V2_PART - 1) / V2_PART; }

// The backward on `stream`: the weights prepared, the zero rows written,
// the tile kernel over the n entries, then the weight grads dW2 = Σ h1ᵀdy1 +
// h2ᵀdy2 and dWe = Σ eᵀdps and the reduce into wb = [dW2; dWe; db2; db0].
// e_idx maps an entry to its slot for the weight grads' e rows (#8), or is
// null (#6: entry i is slot i).
template <typename T, int NT, int L, bool PAIR>
cudaError_t v2_bwd_launch(const V2TileArgs& ta, const Weights& ws, float* wfma, uint16_t* wsplit,
                          const int32_t* zero_rows, int64_t n_zero, const int32_t* e_idx,
                          int64_t n_edges, double* wpart, int64_t n_chunks, float* wb,
                          cudaStream_t stream) {
  cudaError_t err = prepare_weights<T, NT>(ws, V2_FMA, V2_WEIGHTS, wfma, wsplit, L, stream);
  if (err != cudaSuccess) return err;
  if (n_zero > 0) {
    const int64_t n_threads = 3 * n_zero * (L * static_cast<int64_t>(sizeof(T)) / 16);
    zero_rows_kernel<T><<<static_cast<unsigned>((n_threads + 255) / 256), 256, 0, stream>>>(
        static_cast<T*>(ta.d1), static_cast<T*>(ta.d2), static_cast<T*>(ta.de), zero_rows,
        n_zero, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t n_parts = v2_parts(ta.n);
  if (n_parts > 0) {
    const int smem = static_cast<int>(v2_tile_smem_bytes<T, NT, L>());
    if constexpr (PAIR) {
      err = cudaFuncSetAttribute(pair_bwd_tile_kernel<T, NT, L>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      pair_bwd_tile_kernel<T, NT, L><<<static_cast<unsigned>(n_parts), THREADS, smem, stream>>>(
          ta);
    } else {
      err = cudaFuncSetAttribute(v2_bwd_tile_kernel<T, NT, L>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      v2_bwd_tile_kernel<T, NT, L><<<static_cast<unsigned>(n_parts), THREADS, smem, stream>>>(ta);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  WgradArgs wa{};
  const int64_t plane = ta.n * L;
  for (int s = V_H1; s <= V_DPS; ++s) {
    wa.src[s] = static_cast<const T*>(ta.scratch) + s * plane;
    wa.kind[s] = ROW;
  }
  wa.src[V_E] = ta.e;
  wa.kind[V_E] = e_idx != nullptr ? AT_IDX : ROW;
  wa.idx = e_idx;
  wa.n_idx = n_edges;
  wa.n_mats = 2;  // dW2, dWe
  wa.n_pairs[0] = 2;
  wa.pa[0][0] = V_H1, wa.pb[0][0] = V_DY1, wa.pa[0][1] = V_H2, wa.pb[0][1] = V_DY2;
  wa.n_pairs[1] = 1;
  wa.pa[1][0] = V_E, wa.pb[1][0] = V_DPS;
  wa.wpart = wpart;
  wa.n_rows = ta.n;
  wa.chunk = ta.n > 0 ? (ta.n + n_chunks - 1) / n_chunks : 1;
  return launch_wgrad_reduce<T, NT, L>(wa, n_chunks, ta.bpart, n_parts, wb, stream);
}

template <typename T, int NT, bool PAIR>
cudaError_t v2_bwd_launch_width(const V2TileArgs& ta, const Weights& ws, float* wfma,
                                uint16_t* wsplit, const int32_t* zero_rows, int64_t n_zero,
                                const int32_t* e_idx, int64_t n_edges, double* wpart,
                                int64_t n_chunks, float* wb, int64_t L, cudaStream_t stream) {
  switch (L) {
    case 64:
      return v2_bwd_launch<T, NT, 64, PAIR>(ta, ws, wfma, wsplit, zero_rows, n_zero, e_idx,
                                            n_edges, wpart, n_chunks, wb, stream);
    case 128:
      return v2_bwd_launch<T, NT, 128, PAIR>(ta, ws, wfma, wsplit, zero_rows, n_zero, e_idx,
                                             n_edges, wpart, n_chunks, wb, stream);
    default:
      return v2_bwd_launch<T, NT, 256, PAIR>(ta, ws, wfma, wsplit, zero_rows, n_zero, e_idx,
                                             n_edges, wpart, n_chunks, wb, stream);
  }
}

}  // namespace
