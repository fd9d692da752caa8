// Fused edge-step backward (fused3) for NVIDIA Hopper (sm_90a), on the
// tensor cores and on FMA chains that track the plain version's rounding.
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
//   dx[r] = Σ dpre1·Wuᵀ + dpre2·Wvᵀ  (Np, L) fp32
//   dW2 = Σ h1ᵀdy1 + h2ᵀdy2   dWe = Σ eᵀ(dpre1+dpre2)   db2 = Σ dy1+dy2
//   dWu = Σ x[r]ᵀdpre1 + gᵀdpre2   dWv = Σ x[r]ᵀdpre2 + gᵀdpre1   db0 = Σ dpre1+dpre2
//
// What bounds it on this card: 20 L×L products per edge slot (6 recompute
// the forward, 7 form the data cotangents, 7 the weight grads), of which
// x[r]·Wu and x[r]·Wv are needed once per receiver: ~2·18·L² flops per slot
// against ~3.3 KB of streamed bytes in fp32: operations.
//
// Which products run where, and why. The weight grads sum ~2.6e5 slots of
// products, and the check against the plain version (rtol = atol = 2e-4 in
// fp32) holds their entries that cancel to near 0 to a few fp32 roundings
// of the data. On the flagship batch the plain fp32 version is itself at
// 1.06 of that check against the same backward in fp64, and a backward whose
// h1, dy and dpre differ from the plain version's by fp32 rounding (the
// tensor cores' sums do) at 2.5 of it (scripts/port_fp32_noise.py --split
// --flagship, PERF.md). With bf16 streams the same holds at the 3e-2
// check: a variant with all 20 products on the tensor cores put dx at
// 3.07 of the allowance at the flagship size (relu gates flipped where
// its pre-activations rounded otherwise; PERF.md §6). So the 8 products
// whose results feed the relu gates, the bf16 roundings and the
// weight-grad sums are formed as the plain version forms them, and the
// other 12 run on the tensor cores:
// - FMA chains (bit-equal to the plain version's cuBLAS products, each an
//   fp32 FMA chain over k in order; the first layer grouped as
//   ((x·Wa + g·Wb) + e·We) + b0): pre1, pre2 (5 products), h1·W2, dy1·W2ᵀ
//   and dy2·W2ᵀ. The gates and roundings are then the plain version's.
// - Tensor cores (bf16 operands, fp32 accumulation): dg, de and the dx rows
//   (5 products) on mma.sync m16n8k16 (HMMA in the SASS), the 7 weight-grad
//   products on wgmma m64n64k16 (HGMMA). With bf16 streams each operand is one bf16 term
//   (`_dot_default` as `_mms` applies it); with fp32 streams each is split
//   into three bf16 terms (`_split3`) and the six cross products of terms
//   i + j <= 2 are summed, smallest first: what Mosaic lowers
//   Precision.HIGHEST to (`_mm_f32`). The tensor cores sum a k16 block from
//   0 and the block is added in fp32: their own sum truncates to the
//   largest magnitude in it, which, chained over a whole product, biased
//   the weight grads (PERF.md §6).
//
// Design, in four launches (the FMA tile, its weight ring, the staging of an
// edge step's rows, the part split, the swizzled tiles and the tensor-core
// chunk are shared with the forward, in fused3_tile.cuh; the split-weight
// ring, the weight preparation and the weight-grad and reduce kernels with
// the v2 backwards, in bwd_common.cuh), at L = 64, 128 or 256 (the wrapper
// pads any other L <= 256 with zeros, which is exact):
// 0. `prepare_weights_kernel`: Wu, Wv, We, W2, W2ᵀ in fp32 for the chains,
//    Weᵀ, Wuᵀ, Wvᵀ as NT bf16 terms (NT = 3 for fp32 streams, 1 for bf16).
// 1. `step3_bwd_tile_kernel`: one CTA of 8 warps per part of ~PART = 512
//    slots, the part's ends moved to the next receiver-run boundary, so each
//    node's run lies in one CTA, the only writer of its dx row (the
//    receiver-major layout sorts each tile's slots by receiver, so a
//    receiver has one run; the wrapper checks that once per layout tensor
//    and raises on another order, a pair-blocked batch's among them). It
//    walks its part in edge steps of S = fma_rows<L>() slots (64, 32, 16 at
//    L = 64, 128, 256). The chains run as a register-tiled SIMT product:
//    lane l of warp w holds a 4 x 4 block (at L = 128 rows 4·(l/4), columns
//    16w + 4·(l%4)) and reads its operands from transposed fp32 tiles and
//    the weights from a two-stage ring of fp32 chunks (cp.async; KF = 32
//    rows of Wu, Wv and We, the first layer's five chains at once, then 2·KF
//    rows of W2 or W2ᵀ; KF = 16 with bf16 streams; at L = 256 KF = 8 and 16,
//    where the 16-slot step's tiles and the rings fill the 227 KB), one
//    barrier a chunk. The tensor-core
//    products read dpre1, dpre2 and dpre1 + dpre2 as NT-term tiles (over the
//    consumed fp32 operands) with ldmatrix from XOR-swizzled rows (no bank
//    conflicts), and the split weights from a second two-stage ring of
//    32-row chunks, or, with bf16 streams at L <= 128, from a copy resident in shared
//    memory. Each staged chunk serves the step's S rows: a step reads each
//    weight from L2 once, where the column-per-thread CTA of the earlier
//    kernel read them for every 16 slots. dx: the step's dx rows
//    (rounded to the stream dtype) pass through shared memory, and thread c
//    sums column c of each receiver run in slot order in fp64 and writes
//    it once: no atomics, one writer per node. db2 and db0 are summed per
//    column in fp64 from the fp32 values and written per CTA.
//    The weight-grad operands h1, h2, dy1, dy2, dpre1, dpre2 and dpre1 +
//    dpre2 go to a 7-stream scratch in the stream dtype, written once and
//    read once: 7·Ep·L·4 bytes in fp32 (917 MB at the flagship size, ~0.55
//    ms of HBM time in and out at the peak rate), half that in bf16. A sum
//    over ~2.6e5 slots of 128×128 per weight grad does not fit a CTA's
//    registers or shared memory, so it is not fused here.
// 2. The weight-grad pass (bwd_common.cuh), asked for four weight grads
//    and their (A, B) stream pairs: dW2 (h1, dy1), (h2, dy2); dWe (e, dps);
//    dWu (x[r], dpre1), (g, dpre2); dWv (x[r], dpre2), (g, dpre1). Each
//    32-slot item's partial of a pair on the tensor cores, added to an fp64
//    accumulator per chunk of slots, by `bwd_wgrad_kernel_ws` (wgmma): per
//    chunk 8 CTAs at L = 128, each one or two 64 x 64 blocks that share
//    operand tiles (dW2 and dWe blocks in pairs along a row, each dWu block
//    with its dWv block), which fetch and split 2,176 values a slot (34
//    tiles of 64 columns) where the former mma.sync kernel, CTA by CTA,
//    staged 2,688 (1,280 distinct).
// 3. `bwd_reduce_kernel` (bwd_common.cuh): sums the per-chunk and per-part
//    partials in order in fp64 and rounds once, into [dW2; dWe; dWu; dWv;
//    db2; db0]. Every sum runs in a fixed order: two calls give bit-equal
//    outputs.
// - ptxas at L = 128 (sm_90a, CUDA 12.8), fp32 / bf16 streams: the tile
//   kernel 246 / 185 registers and 224,528 / 199,952 bytes of dynamic
//   shared memory (one CTA per SM); the wgmma weight-grad kernel 134 / 128
//   registers at 384 threads and 222,272 / 87,104 bytes (one CTA per SM);
//   no spills. The SASS holds 240 / 40 HMMA instructions in the tile kernel
//   and 12 / 2 HGMMA (wgmma m64n64k16) in the weight-grad kernel
//   (scripts/port_sass.py; PERF.md §6). chip_smoke.py prints the figures at
//   each width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "fused3_tile.cuh"
#include "bwd_common.cuh"
#include "wide_tile.cuh"

namespace {

constexpr int PART = 512;     // slots per tile-kernel CTA, before the run alignment
// With bf16 streams (NT = 1 term) at L <= 128 the tensor cores' split
// weights stay resident in shared memory (96 KB at L = 128), and the fp32
// ring's chunks (kf rows of the first layer's three weights) are halved to
// make room for them; at L = 256 both rings shrink to fit the 16-slot
// step's tiles.
template <int NT, int L> __host__ __device__ constexpr int kf() {
  return L == 256 ? (NT == 1 ? 16 : 8) : (NT == 1 ? 16 : 32);
}
template <int NT, int L> __host__ __device__ constexpr bool resident() {
  return NT == 1 && L <= 128;
}
enum { S_H1, S_H2, S_DY1, S_DY2, S_DP1, S_DP2, S_DPS, SRC_E, SRC_G, SRC_XR, N_SRC };
// the fp32 weights of the FMA chains (fused3_tile.cuh's F_U .. F_2, then
// W2ᵀ) and the split weights of the tile kernel's tensor-core products, in
// the order an edge step streams them
constexpr int N_FMA = F_2 + 2;
enum { T_ET, T_UT, T_VT, N_TC };
constexpr int N_WEIGHTS = static_cast<int>(N_FMA) + static_cast<int>(N_TC);

struct TileArgs {
  const void *x, *g, *e, *z_upd, *dz_upd;
  const float *dR, *dM;
  const int32_t *rcv, *gid;
  const void *b0, *b2;
  const float* wfma;        // (N_FMA, L, L) fp32: Wu, Wv, We, W2, W2ᵀ
  const uint16_t* wsplit;   // (N_TC, NT, L, L) bf16 terms: Weᵀ, Wuᵀ, Wvᵀ
  void *dg, *de;
  float* dx;
  void* scratch;
  double* bpart;            // (n_parts, 2, L) this CTA's db2, db0 column sums
  int64_t n_nodes, n_edges, n_graphs;
};

// Bytes of the tile kernel's operand region: three transposed fp32 operands
// of the chains, then (over them) three split operand tiles of the tensor
// cores, then the step's dx rows (fma_rows<L>() · L = 4096 values at every
// width).
template <int NT, int L>
__host__ __device__ constexpr int64_t tile_operand_bytes() {
  constexpr int S = fma_rows<L>();
  return 3 * L * S * 4 > 3 * NT * S * L * 2 ? 3 * L * S * 4 : 3 * NT * S * L * 2;
}

// Shared memory of one tile-kernel CTA: the operand region, the fp32 and the
// split weight rings, the step's receivers and masks, the biases and dM rows.
template <int NT, int L>
constexpr int64_t tile_smem_bytes() {
  return tile_operand_bytes<NT, L>() + 2 * 3 * kf<NT, L>() * L * 4 +
         (resident<NT, L>() ? N_TC * L * L * 2 : 2 * NT * KC * L * 2) + 16 +
         fma_rows<L>() * 8 + 6 * L * 4;
}

template <typename T, int NT, int L>
__global__ void __launch_bounds__(THREADS, 1) step3_bwd_tile_kernel(const TileArgs a) {
  constexpr int S = fma_rows<L>();  // slots of an edge step
  extern __shared__ float4 smem4[];
  float* at0 = reinterpret_cast<float*>(smem4);  // (L, S): x[r]ᵀ → h1ᵀ
  float* at1 = at0 + L * S;                      // gᵀ → dy1ᵀ
  float* at2 = at1 + L * S;                      // eᵀ → dy2ᵀ
  // over them once dy1ᵀ, dy2ᵀ are consumed: the tensor cores' operands
  uint16_t* op0 = reinterpret_cast<uint16_t*>(smem4);  // dpre1 terms
  uint16_t* op1 = op0 + NT * S * L;                    // dpre2 terms
  uint16_t* op2 = op1 + NT * S * L;                    // dpre1+dpre2 terms
  float* fring_s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                            tile_operand_bytes<NT, L>());  // fp32 weight ring
  // the split weight ring, or (resident) the N_TC split weights
  constexpr int KF = kf<NT, L>();
  constexpr bool RES = resident<NT, L>();
  uint16_t* sring_s = reinterpret_cast<uint16_t*>(fring_s + 2 * 3 * KF * L);
  int64_t* bounds_s = reinterpret_cast<int64_t*>(
      sring_s + (RES ? N_TC * L * L : 2 * NT * KC * L));  // (2,)
  int* rcv_s = reinterpret_cast<int*>(bounds_s + 2);  // (S,) receiver or -1
  float* mask_s = reinterpret_cast<float*>(rcv_s + S);  // (S,)
  float* cst_s = mask_s + S;        // (6, L): b0, b2, dM0, dM1, dM2, dM3
  T* dx_s = reinterpret_cast<T*>(smem4);  // (S, L) the step's dx rows, over op0 once consumed

  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* e = static_cast<const T*>(a.e);
  const T* z_upd = static_cast<const T*>(a.z_upd);
  const T* dz_upd = static_cast<const T*>(a.dz_upd);
  T* dg = static_cast<T*>(a.dg);
  T* de = static_cast<T*>(a.de);
  T* scratch = static_cast<T*>(a.scratch);
  const int64_t EL = a.n_edges * L;
  const int tid = static_cast<int>(threadIdx.x);

  // this CTA's slots: [PART·b, PART·(b+1)), both ends moved to the next
  // start of a receiver run
  if (tid < 32) {
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * PART;
    const int64_t s1 = s0 + PART < a.n_edges ? s0 + PART : a.n_edges;
    part_bounds(a.rcv, s0, s1, a.n_edges, bounds_s);
  }
  for (int i = tid; i < L; i += THREADS) {
    cst_s[0 * L + i] = to_f(static_cast<const T*>(a.b0)[i]);
    cst_s[1 * L + i] = to_f(static_cast<const T*>(a.b2)[i]);
    for (int j = 0; j < 4; ++j) cst_s[(2 + j) * L + i] = a.dM[j * L + i];
  }
  __syncthreads();
  const int64_t lo = bounds_s[0], hi = bounds_s[1];
  double* bpart = a.bpart + static_cast<int64_t>(blockIdx.x) * 2 * L;
  if (lo >= hi) {  // the whole CTA: a run longer than PART took its slots
    for (int i = tid; i < 2 * L; i += THREADS) bpart[i] = 0.0;
    return;
  }

  Fp32Ring<L, KF, 2> fring{a.wfma, fring_s, 0};
  SplitRing<NT, L, N_TC> sring{a.wsplit, sring_s, 0};
  fring.issue(0);
  if constexpr (RES) {
    load_resident<NT, L, N_TC>(sring_s, a.wsplit);
  } else {
    sring.issue(0);
  }
  const int r0 = quad_row<L>(), c0 = quad_col<L>();
  // dx: thread c < L sums column c of the current receiver run in fp64
  double dx_run = 0.0;
  int dx_r = -1;
  // db2 = Σ dy1 + dy2 and db0 = Σ dpre1 + dpre2 over this thread's rows, per
  // column of its quad, in fp64
  double db2[4] = {0.0, 0.0, 0.0, 0.0}, db0[4] = {0.0, 0.0, 0.0, 0.0};

#pragma unroll 1
  for (int64_t base = lo; base < hi; base += S) {
    const int n = static_cast<int>(hi - base < S ? hi - base : S);
    if (tid < S) {
      int r = -1;
      float m = 0.f;
      if (tid < n) {
        r = a.rcv[base + tid];
        if (r < 0 || r >= a.n_nodes) r = -1;
        m = a.gid[base + tid] < a.n_graphs ? 1.f : 0.f;
      }
      rcv_s[tid] = r;
      mask_s[tid] = m;
    }
    __syncthreads();
    stage_rows_t<T, L>(at0, at1, at2, x, g, e, rcv_s, base, n);
    __syncthreads();

    // --- the first layer on FMA chains: xu, gv, ep, xv, gu
    uint32_t on1 = 0, on2 = 0;  // relu gates of the quad, bit 4·i + j
    {
      Quad xu, gv, ep, xv, gu;
      xu.zero(); gv.zero(); ep.zero(); xv.zero(); gu.zero();
#pragma unroll 1
      for (int k0 = 0; k0 < L; k0 += KF) {
        const float* wc = fring.acquire();
        const float* wu_c = wc;
        const float* wv_c = wc + KF * L;
        const float* we_c = wc + 2 * KF * L;
        fma_chunk<L, KF, 5>({&xu, &gv, &ep, &xv, &gu}, {at0, at1, at2, at0, at1},
                        {wu_c, wv_c, we_c, wv_c, wu_c}, k0);
        fring.release();
      }
      __syncthreads();  // every warp is done with x[r], whose place h1 takes
      // pre = ((x·Wa + g·Wb) + e·We) + b0, as the plain version adds them
      float h1[4][4], h2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b0c = cst_s[c0 + j];
          const float p1 = ((xu.v[i][j] + gv.v[i][j]) + ep.v[i][j]) + b0c;
          const float p2 = ((xv.v[i][j] + gu.v[i][j]) + ep.v[i][j]) + b0c;
          on1 |= (p1 > 0.f ? 1u : 0u) << (4 * i + j);
          on2 |= (p2 > 0.f ? 1u : 0u) << (4 * i + j);
          h1[i][j] = round_sd<T>(fmaxf(p1, 0.f));
          h2[i][j] = round_sd<T>(fmaxf(p2, 0.f));
          xu.v[i][j] = h1[i][j];
        }
      put_quad_t<L>(at0, xu);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < n) {
          store4(scratch + S_H1 * EL + (base + r0 + i) * L + c0, h1[i]);
          store4(scratch + S_H2 * EL + (base + r0 + i) * L + c0, h2[i]);
        }
    }
    __syncthreads();

    // --- z_msg = relu(h1·W2 + b2)·mask, then the two output cotangents
    {
      Quad am;
      am.zero();
#pragma unroll 1
      for (int k0 = 0; k0 < L; k0 += 2 * KF) {
        const float* wc = fring.acquire();
        fma_chunk<L, 2 * KF, 1>({&am}, {at0}, {wc}, k0);
        fring.release();
      }
      Quad dy1, dy2;
      float4 dr[4], zu[4], dzu[4];  // every row's loads out before the first use
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i, r = rcv_s[row];
        const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
        dr[i] = r >= 0 ? load4(a.dR + static_cast<int64_t>(r) * L + c0) : z4;
        zu[i] = row < n ? load4(z_upd + (base + row) * L + c0) : z4;
        dzu[i] = row < n ? load4(dz_upd + (base + row) * L + c0) : z4;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
        const float drv[4] = {dr[i].x, dr[i].y, dr[i].z, dr[i].w},
                    zuv[4] = {zu[i].x, zu[i].y, zu[i].z, zu[i].w},
                    dzv[4] = {dzu[i].x, dzu[i].y, dzu[i].z, dzu[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float zm = fmaxf(am.v[i][j] + cst_s[L + c], 0.f) * mask_s[row];
          // (dR[r] + dM0) + (2·dM1)·z, rounded after each operation as the
          // plain version rounds it (no contraction into an FMA)
          const float dzm =
              __fadd_rn(drv[j] + cst_s[2 * L + c], __fmul_rn(2.f * cst_s[3 * L + c], zm));
          dy1.v[i][j] = dzm * (zm > 0.f ? 1.f : 0.f);
          const float d2 =
              __fadd_rn(dzv[j] + cst_s[4 * L + c], __fmul_rn(2.f * cst_s[5 * L + c], zuv[j]));
          dy2.v[i][j] = d2 * (zuv[j] > 0.f ? 1.f : 0.f);
          db2[j] += static_cast<double>(dy1.v[i][j] + dy2.v[i][j]);
        }
        if (row < n) {
          store4(scratch + S_DY1 * EL + (base + row) * L + c0, dy1.v[i]);
          store4(scratch + S_DY2 * EL + (base + row) * L + c0, dy2.v[i]);
        }
      }
      // the operands of the next products, rounded as the plain version's
      // products take them; g and e are consumed
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

    // --- dpre = (dy·W2ᵀ)·(pre > 0)
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
        float p[4], q[4], s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = (on1 >> (4 * i + j)) & 1u ? dp1.v[i][j] : 0.f;
          q[j] = (on2 >> (4 * i + j)) & 1u ? dp2.v[i][j] : 0.f;
          s[j] = p[j] + q[j];
          db0[j] += static_cast<double>(s[j]);
        }
        const int row = r0 + i;
        put4<NT, L>(op0, S * L, row, c0, make_float4(p[0], p[1], p[2], p[3]));
        put4<NT, L>(op1, S * L, row, c0, make_float4(q[0], q[1], q[2], q[3]));
        put4<NT, L>(op2, S * L, row, c0, make_float4(s[0], s[1], s[2], s[3]));
        if (row < n) {
          const int64_t o = (base + row) * L + c0;
          store4(scratch + S_DP1 * EL + o, p);
          store4(scratch + S_DP2 * EL + o, q);
          store4(scratch + S_DPS * EL + o, s);
        }
      }
    }
    __syncthreads();

    // --- on the tensor cores: de = dps·Weᵀ; dg = dpre1·Wvᵀ + dpre2·Wuᵀ; dx
    // rows dpre1·Wuᵀ + dpre2·Wvᵀ
    {
      Frag<L, S> f1, f2;
      f1.zero();
      mma_weight<NT, L, 1, S, RES>(sring, sring_s, T_ET, {&f1}, {op2});
      for_pairs<L, S>(f1, [&](int row, int col, float& v0, float& v1) {
        if (row < n) store2(de + (base + row) * L + col, v0, v1);
      });
      f1.zero();
      f2.zero();
      mma_weight<NT, L, 2, S, RES>(sring, sring_s, T_UT, {&f1, &f2}, {op1, op0});
      mma_weight<NT, L, 2, S, RES>(sring, sring_s, T_VT, {&f1, &f2}, {op0, op1});
      for_pairs<L, S>(f1, [&](int row, int col, float& v0, float& v1) {
        if (row < n) store2(dg + (base + row) * L + col, v0, v1);
      });
      __syncthreads();  // every warp is done with the tiles, over which the dx rows go
      for_pairs<L, S>(f2, [&](int row, int col, float& v0, float& v1) {
        store2(dx_s + row * L + col, v0, v1);
      });
    }
    __syncthreads();
    if (tid < L) {
      for (int i = 0; i < n; ++i) {
        const int r = rcv_s[i];
        if (r != dx_r) {
          if (dx_r >= 0) a.dx[static_cast<int64_t>(dx_r) * L + tid] = static_cast<float>(dx_run);
          dx_run = 0.0;
          dx_r = r;
        }
        dx_run += to_f(dx_s[i * L + tid]);
      }
    }
    __syncthreads();  // rcv_s and the operands are restaged next step
  }
  if (tid < L && dx_r >= 0) a.dx[static_cast<int64_t>(dx_r) * L + tid] = static_cast<float>(dx_run);
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
cudaError_t launch(const TileArgs& ta, const WgradArgs& wa, const Weights& ws, uint16_t* wsplit,
                   int64_t n_chunks, float* wb, cudaStream_t stream) {
  cudaError_t err = prepare_weights<T, NT>(ws, N_FMA, N_WEIGHTS, const_cast<float*>(ta.wfma),
                                           wsplit, L, stream);
  if (err != cudaSuccess) return err;

  static_assert(tile_smem_bytes<NT, L>() <= 232448, "fits an SM's 227 KB");
  const int smem_tile = static_cast<int>(tile_smem_bytes<NT, L>());
  err = cudaFuncSetAttribute(step3_bwd_tile_kernel<T, NT, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_tile);
  if (err != cudaSuccess) return err;
  const int64_t n_parts = (ta.n_edges + PART - 1) / PART;
  step3_bwd_tile_kernel<T, NT, L><<<static_cast<unsigned>(n_parts), THREADS, smem_tile, stream>>>(
      ta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_wgrad_reduce<T, NT, L>(wa, n_chunks, ta.bpart, n_parts, wb, stream);
}

template <typename T, int NT>
cudaError_t launch_width(const TileArgs& ta, const WgradArgs& wa, const Weights& ws,
                         uint16_t* wsplit, int64_t n_chunks, float* wb, int64_t L,
                         cudaStream_t stream) {
  switch (L) {
    case 64: return launch<T, NT, 64>(ta, wa, ws, wsplit, n_chunks, wb, stream);
    case 128: return launch<T, NT, 128>(ta, wa, ws, wsplit, n_chunks, wb, stream);
    default: return launch<T, NT, 256>(ta, wa, ws, wsplit, n_chunks, wb, stream);
  }
}

}  // namespace

extern "C" {

// CTAs of the tile kernel over n_edges slots: the rows of bpart.
int64_t pdg_fused_edge3_bwd_parts(int64_t n_edges) { return (n_edges + PART - 1) / PART; }

// Weight-grad chunks over n_edges slots: the rows of wpart.
int64_t pdg_fused_edge3_bwd_chunks(int64_t n_edges) { return wgrad_chunks(n_edges, 4); }

// Launches the backward on `stream`. Pointers are device pointers. x, g, e,
// z_upd, dz_upd, the weights, their transposes (wuT[k][c] = wu[c][k], ...),
// dg, de and scratch (7, n_edges, L) are fp32 (bf16 == 0) or bf16
// (bf16 == 1); dR (n_nodes, L), dM (8, L), dx (n_nodes, L, zeroed by the
// caller) and wb (4L+2, L) are fp32; rcv (receiver-sorted runs) and gid are
// int32; wfma (5, L, L) fp32 and wsplit (3, 3 or 1, L, L) bf16 scratch
// (3 terms in fp32 mode);
// bpart (pdg_fused_edge3_bwd_parts(n_edges), 2, L) and wpart (n_chunks =
// pdg_fused_edge3_bwd_chunks(n_edges), 4, L, L) fp64 scratch. L is
// 64, 128 or 256. Returns a cudaError_t value (0 on success).
int pdg_fused_edge3_bwd(int bf16, const void* x, const void* g, const void* e,
                        const void* z_upd, const void* dz_upd, const void* dR, const void* dM,
                        const void* rcv, const void* gid, const void* wu, const void* wv,
                        const void* we, const void* w2, const void* wuT, const void* wvT,
                        const void* weT, const void* w2T, const void* b0, const void* b2,
                        void* dg, void* de, void* dx, void* scratch, void* wsplit,
                        void* wfma, void* bpart, void* wpart, void* wb, int64_t n_nodes,
                        int64_t n_edges,
                        int64_t L, int64_t n_graphs, int64_t n_chunks, void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_nodes < 1 || n_edges < 1 || n_chunks < 1 ||
      (n_edges + n_chunks - 1) / n_chunks > MAX_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* r = static_cast<const int32_t*>(rcv);
  TileArgs ta{x, g, e, z_upd, dz_upd, static_cast<const float*>(dR),
              static_cast<const float*>(dM), r, static_cast<const int32_t*>(gid), b0, b2,
              static_cast<const float*>(wfma), static_cast<const uint16_t*>(wsplit), dg, de,
              static_cast<float*>(dx), scratch, static_cast<double*>(bpart),
              n_nodes, n_edges, n_graphs};
  // the weight grads' operand streams: the 7 scratch streams, e, g, and x
  // at the receivers
  WgradArgs wa{};
  const int64_t plane = n_edges * L * (bf16 ? 2 : 4);
  for (int s = 0; s < SRC_E; ++s) {
    wa.src[s] = static_cast<const char*>(scratch) + s * plane;
    wa.kind[s] = ROW;
  }
  wa.src[SRC_E] = e, wa.kind[SRC_E] = ROW;
  wa.src[SRC_G] = g, wa.kind[SRC_G] = ROW;
  wa.src[SRC_XR] = x, wa.kind[SRC_XR] = AT_IDX;
  wa.idx = r;
  wa.n_idx = n_nodes;
  // dW2, dWe, dWu, dWv
  const int pairs[4][2][2] = {{{S_H1, S_DY1}, {S_H2, S_DY2}},
                              {{SRC_E, S_DPS}, {SRC_E, S_DPS}},
                              {{SRC_XR, S_DP1}, {SRC_G, S_DP2}},
                              {{SRC_XR, S_DP2}, {SRC_G, S_DP1}}};
  wa.n_mats = 4;
  for (int m = 0; m < 4; ++m) {
    wa.n_pairs[m] = m == 1 ? 1 : 2;
    for (int p = 0; p < 2; ++p) wa.pa[m][p] = pairs[m][p][0], wa.pb[m][p] = pairs[m][p][1];
  }
  wa.wpart = static_cast<double*>(wpart);
  wa.n_rows = n_edges;
  wa.chunk = (n_edges + n_chunks - 1) / n_chunks;
  const Weights ws{{wu, wv, we, w2, w2T, weT, wuT, wvT}};
  auto* sp = static_cast<uint16_t*>(wsplit);
  auto* o = static_cast<float*>(wb);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_width<__nv_bfloat16, 1>(ta, wa, ws, sp, n_chunks, o, L, s)
                               : launch_width<float, 3>(ta, wa, ws, sp, n_chunks, o, L, s);
  return static_cast<int>(err);
}

// Weight-grad chunks over n_rows rows for n_mats weight grads.
int64_t pdg_wgrad_chunks(int64_t n_rows, int64_t n_mats) { return wgrad_chunks(n_rows, n_mats); }

// The weight-grad pass alone, as the three backwards launch it: wb[m] =
// Σ_p Σ_i A[i]ᵀB[i] over the (A, B) = (src[pa[m][p]], src[pb[m][p]]) pairs
// p < n_pairs[m] of weight grad m < n_mats, then two rows of zeros. src
// (host array of n_src device pointers, each (·, L) in the stream dtype)
// with kind (host array: 0 row i, 1 row idx[i], missing outside [0,
// n_idx)); idx (n_rows,) int32 or null; pa, pb host arrays (n_mats, 2);
// wpart (n_chunks = pdg_wgrad_chunks(n_rows, n_mats), n_mats, L, L) fp64
// scratch; wb (n_mats·L + 2, L) fp32. L is 64, 128 or 256. Returns a
// cudaError_t value (0 on success).
int pdg_fused_edge3_bwd_wgrad(int bf16, const void* const* src, const int* kind, int n_src,
                              const void* idx, int64_t n_idx, int n_mats, const int* n_pairs,
                              const int* pa, const int* pb, void* wpart, void* wb,
                              int64_t n_rows, int64_t L, int64_t n_chunks, void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_rows < 0 || n_chunks < 1 || n_src < 1 ||
      n_src > MAX_STREAMS || n_mats < 1 || n_mats > 4 ||
      (n_rows + n_chunks - 1) / n_chunks > MAX_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgradArgs wa{};
  for (int k = 0; k < n_src; ++k) {
    wa.src[k] = src[k];
    wa.kind[k] = kind[k] ? AT_IDX : ROW;
    if (kind[k] && idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  wa.idx = static_cast<const int32_t*>(idx);
  wa.n_idx = n_idx;
  wa.n_mats = n_mats;
  for (int m = 0; m < n_mats; ++m) {
    if (n_pairs[m] < 1 || n_pairs[m] > MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
    wa.n_pairs[m] = n_pairs[m];
    for (int p = 0; p < n_pairs[m]; ++p) {
      wa.pa[m][p] = pa[2 * m + p], wa.pb[m][p] = pb[2 * m + p];
      if (wa.pa[m][p] < 0 || wa.pa[m][p] >= n_src || wa.pb[m][p] < 0 || wa.pb[m][p] >= n_src)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  wa.wpart = static_cast<double*>(wpart);
  wa.n_rows = n_rows;
  wa.chunk = n_rows > 0 ? (n_rows + n_chunks - 1) / n_chunks : 1;
  auto* o = static_cast<float*>(wb);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    using B = __nv_bfloat16;
    err = L == 64    ? launch_wgrad_reduce<B, 1, 64>(wa, n_chunks, nullptr, 0, o, st)
          : L == 128 ? launch_wgrad_reduce<B, 1, 128>(wa, n_chunks, nullptr, 0, o, st)
                     : launch_wgrad_reduce<B, 1, 256>(wa, n_chunks, nullptr, 0, o, st);
  } else {
    err = L == 64    ? launch_wgrad_reduce<float, 3, 64>(wa, n_chunks, nullptr, 0, o, st)
          : L == 128 ? launch_wgrad_reduce<float, 3, 128>(wa, n_chunks, nullptr, 0, o, st)
                     : launch_wgrad_reduce<float, 3, 256>(wa, n_chunks, nullptr, 0, o, st);
  }
  return static_cast<int>(err);
}

// Launches the wide variant (wide_tile.cuh) on `stream`: L > 256, a
// multiple of 64; `step` points to a WideStep whose tensors are fp32
// (bf16 == 0) or bf16 (bf16 == 1) streams. Returns a cudaError_t value (0
// on success).
int pdg_fused_edge3_bwd_wide(int bf16, const void* step, void* stream) {
  const auto& s = *static_cast<const WideStep*>(step);
  if (s.L <= 256 || s.L % wide::WN != 0 || s.n < 0 || s.splits < 1 ||
      s.splits > wide::MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? wide::wide_backward<__nv_bfloat16, wide::F3>(s, st)
                               : wide::wide_backward<float, wide::F3>(s, st));
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
