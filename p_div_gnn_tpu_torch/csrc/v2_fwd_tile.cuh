// The forward of the v2 edge step, shared by the receiver-major v2 forward
// (fused_edge_fwd.cu, #5) and the pair-blocked one (fused_edge2_fwd.cu,
// #7): the two tile kernels (fp32 FMA chains, bf16 tensor cores), the zero
// z_upd rows of the pair-blocked layout's padding slots, and the launch
// sequence. An including source includes "mma_sm90.cuh", "fused3_tile.cuh"
// and "fwd_common.cuh" first. Everything here lives in an anonymous
// namespace.
//
// For each entry i of a list of edge slots (#5: every slot, in order; #7:
// the real slots, each receiver's consecutive) with slot s_i, receiver r
// and the first layer's other addends (#5: a_u[r] + g_v[s_i] and a_v[r] +
// g_u[s_i]; #7: u[r] + v[snd] and v[r] + u[snd], an endpoint outside its
// block's tile reading 0), the tile kernel forms
//
//   ep = e[s_i]·We   h1 = relu(((a1 + g1) + ep) + b0)   h2 = relu(((a2 + g2) + ep) + b0)
//   z_msg = relu(h1·W2 + b2)·mask   z_upd = relu(h2·W2 + b2)·mask
//
// writes z_upd at slot s_i, sums z_msg (rounded to the stream dtype) per
// receiver run into R, and Σz, Σz² of both into per-part fp64 partials.
//
// Design (the fused3 forward's, fused_edge3_fwd.cu, on the v2 products):
// - A persistent grid: one 8-warp CTA per SM, the entries cut into one part
//   per CTA, both ends moved to the next start of a receiver run
//   (part_bounds), so each receiver's run lies in one CTA: its z_msg
//   column threads sum the run in fp64 in entry order and write R's row
//   once (fwd_common.cuh's ColumnSums; no atomics, no fp64 scratch rows).
//   #7's parts split its real slots, so they balance by real work.
// - fp32 streams (and bf16 at L = 256): fused3_tile.cuh's register-tiled
//   FMA chains, S = fma_rows<L>() entries a step (64, 32, 16 at L = 64,
//   128, 256), a 4 x 4 block of each chain a thread, operands from
//   transposed fp32 tiles; We and W2 stay resident in shared memory in fp32
//   at L <= 128 (128 KB at 128: no weight traffic and no ring barriers in
//   the steps), and stream from a two-stage cp.async ring of 2·KF-row
//   chunks at 256; the two second-layer chains read each W2 value once.
//   Each product is one fp32 FMA chain over k in order, the first layer
//   grouped as the plain "xla" Processor groups it, h rounded to the stream
//   dtype: in fp32, z_upd is the plain version's bit for bit. The next
//   step's e rows and first-layer addends load into registers while the
//   second layer runs.
// - bf16 streams at L = 64 and 128: the tensor cores (mma.sync m16n8k16,
//   bf16 operands, fp32 accumulation in the MMAs), M = 32 entries a step;
//   We and W2 resident in swizzled shared memory (64 KB at L = 128); the
//   step's e rows and four addend rows arrive by cp.async into one of two
//   buffers, issued at the start of the step before (the indices run two
//   steps ahead); the first-layer sum is grouped in fp32 on the fragments,
//   h rounded to bf16 in shared memory as ·W2's A operand. The relu gates
//   need not round as the plain version does: held at 3e-2.
// - A step of #5 made only of padding slots writes zero z_upd rows and
//   skips its products; #7's padding slots get their zero rows from
//   zero_z_rows_kernel (16-byte stores). Every sum runs in a fixed order:
//   two calls give bit-equal outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct V2FwdArgs {
  const void *a1, *a2;  // (Np, L): the receiver rows of pre1, pre2 (#5 a_u, a_v; #7 u, v)
  const void *g1, *g2;  // #5: g_v, g_u (Ep, L) at the slot; #7: v, u (Np, L) at the sender
  const void* e;        // (Ep, L)
  const int32_t* rcv;   // (n,) each entry's receiver (-1: none), consecutive runs
  const int32_t* snd;   // #7: (n,) each entry's sender (-1: none); #5: null
  const int32_t* slot;  // #7: (n,) each entry's slot; #5: null (entry i is slot i)
  const int32_t* gid;   // #5: (Ep,) graph of each slot (mask); #7: null (all real)
  const void *we, *w2;  // (L, L)
  const void *b0, *b2;  // (L,)
  const float* wfma;    // (2, L, L) fp32 copy of We, W2 (the FMA kernel)
  void* z_upd;          // (Ep, L)
  float* R;             // (Np, L), zeroed before the launch
  double* mpart;        // (gridDim.x, 4, L) each part's moment sums
  float* moments;       // (8, L): M
  int64_t n_nodes, n, n_graphs, part;  // part: nominal entries of a CTA
};

// rows of We or W2 in a ring chunk of the FMA kernel at L = 256: 2·KF
template <int L> __host__ __device__ constexpr int v2f_kf() { return L <= 128 ? 32 : 16; }
// the FMA kernel's We and W2 stay resident in shared memory in fp32 at L <=
// 128 (128 KB at 128); at 256 (512 KB) they stream through the ring
template <int L> __host__ __device__ constexpr bool v2f_resident() { return L <= 128; }

// The MS entries of a step, held by warp 0 (lane l holds rows l, l + 32,
// ...): the row of the receiver addends (-1 outside [0, n_nodes)), of the
// sender addends (#5: the slot; #7: the sender, -1 outside [0, n_nodes)),
// the slot (e and z_upd rows) and the mask; -1 and 0 past the list's end.
// Loaded into registers while the step before runs, then published.
template <int MS, bool PAIR>
struct V2Slots {
  static constexpr int RPL = (MS + 31) / 32;
  int r[RPL], g[RPL], s[RPL];
  float m[RPL];

  __device__ __forceinline__ V2Slots() {
#pragma unroll
    for (int j = 0; j < RPL; ++j) r[j] = g[j] = s[j] = -1, m[j] = 0.f;
  }
  __device__ __forceinline__ void load(const V2FwdArgs& a, int64_t base, int n) {
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int row = static_cast<int>(threadIdx.x) + 32 * j;
      if (row < n) {
        const int64_t i = base + row;
        r[j] = a.rcv[i];
        if (r[j] < 0 || r[j] >= a.n_nodes) r[j] = -1;
        if constexpr (PAIR) {
          s[j] = a.slot[i];
          g[j] = a.snd[i];
          if (g[j] < 0 || g[j] >= a.n_nodes) g[j] = -1;
          m[j] = 1.f;
        } else {
          s[j] = g[j] = static_cast<int>(i);
          m[j] = a.gid[i] < a.n_graphs ? 1.f : 0.f;
        }
      }
    }
  }
  // Warp 0: the step's indices into idx_s (4 arrays of MS: receiver,
  // sender row, slot, mask), and whether any entry is real.
  __device__ __forceinline__ void publish(int* idx_s, int* live_s) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int row = static_cast<int>(threadIdx.x) + 32 * j;
      if (row < MS) {
        idx_s[row] = r[j];
        idx_s[MS + row] = g[j];
        idx_s[2 * MS + row] = s[j];
        reinterpret_cast<float*>(idx_s)[3 * MS + row] = m[j];
      }
      any = any || m[j] != 0.f;
    }
    const unsigned live = __ballot_sync(FULL, any);
    if (threadIdx.x == 0) *live_s = live != 0u;
  }
};

// The part of a CTA: [lo, hi) of the entries, published in bounds_s by
// warp 0 (the caller syncs).
__device__ __forceinline__ void v2_part(const V2FwdArgs& a, int64_t* bounds_s) {
  if (threadIdx.x < 32) {
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * a.part;
    const int64_t s1 = s0 + a.part < a.n ? s0 + a.part : a.n;
    part_bounds(a.rcv, s0 < a.n ? s0 : a.n, s1, a.n, bounds_s);
  }
}

// fp32 values of the FMA kernel's resident weights or weight ring
template <int L> __host__ __device__ constexpr int v2f_weight_floats() {
  return v2f_resident<L>() ? 2 * L * L : 2 * 2 * v2f_kf<L>() * L;
}

// Shared memory of the FMA kernel: two transposed (L, S) operand tiles, the
// resident weights or the weight ring, the z tiles, the indices of two steps
// and the biases.
template <int L> __host__ __device__ constexpr int64_t v2f_fma_smem() {
  constexpr int S = fma_rows<L>();
  return (2 * L * S + v2f_weight_floats<L>() + 2 * S * (L + 4)) * 4 + 16 + 2 * 4 * S * 4 + 16 +
         2 * L * 4;
}

// This thread's share of a step's rows: e (rows_per_thread<L>() float4s, as
// stage_rows_t lays them out) and the four first-layer addends of its quad's
// rows (a1, g1, a2, g2 at columns quad_col .. + 3), raw; all of the loads go
// out before any use.
template <typename T, int L>
struct V2Rows {
  float4 e[rows_per_thread<L>()];
  Raw4<T> q[4][4];  // [a1, g1, a2, g2][row of the quad]

  __device__ __forceinline__ void load(const V2FwdArgs& a, const int* idx_s) {
    constexpr int S = fma_rows<L>();
    const int tid = static_cast<int>(threadIdx.x);
    const T* e_ = static_cast<const T*>(a.e);
    const T* src[4] = {static_cast<const T*>(a.a1), static_cast<const T*>(a.g1),
                       static_cast<const T*>(a.a2), static_cast<const T*>(a.g2)};
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const Raw4<T> zr{};
#pragma unroll
    for (int u = 0; u < rows_per_thread<L>(); ++u) {
      const int p = tid + u * THREADS, row = p % S, col = (p / S) * 4;
      const int sl = idx_s[2 * S + row];
      e[u] = sl >= 0 ? load4(e_ + static_cast<int64_t>(sl) * L + col) : z4;
    }
    const int r0 = quad_row<L>(), c0 = quad_col<L>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + i;
      const int r = keep(WITHOUT_GATHER) ? idx_s[row] : -1;
      const int g = keep(WITHOUT_GATHER) ? idx_s[S + row] : -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int at = k % 2 == 0 ? r : g;
        q[k][i] = at >= 0 ? raw4(src[k] + static_cast<int64_t>(at) * L + c0) : zr;
      }
    }
  }
  // e transposed into the (L, S) fp32 operand at
  __device__ __forceinline__ void store_e(float* at) const {
    constexpr int S = fma_rows<L>();
    const int tid = static_cast<int>(threadIdx.x);
#pragma unroll
    for (int u = 0; u < rows_per_thread<L>(); ++u) {
      const int p = tid + u * THREADS, row = p % S, col = (p / S) * 4;
      at[(col + 0) * S + row] = e[u].x;
      at[(col + 1) * S + row] = e[u].y;
      at[(col + 2) * S + row] = e[u].z;
      at[(col + 3) * S + row] = e[u].w;
    }
  }
};

// Register-tiled FMA chains over stream dtype T (fp32 at every width, bf16
// at L = 256, where the tensor-core kernel's resident weights would not
// fit): in fp32, z_upd bit-equal to the plain version. The body of
// `v2_fwd_tile_fma_kernel` (#5) and `pair_fwd_tile_fma_kernel` (#7).
template <typename T, int L, bool PAIR>
__device__ __forceinline__ void fwd_tile_fma(const V2FwdArgs& a) {
  constexpr int S = fma_rows<L>(), KF = v2f_kf<L>(), ZS = L + 4;
  constexpr bool RES = v2f_resident<L>();
  static_assert(v2f_fma_smem<L>() <= 232448, "fits an SM's 227 KB");
  PartClock timer;
  extern __shared__ float4 smem4[];
  float* at0 = reinterpret_cast<float*>(smem4);  // (L, S): eᵀ → h1ᵀ
  float* at1 = at0 + L * S;                      // h2ᵀ
  float* w_s = at1 + L * S;  // RES: (2, L, L) We, W2; else 2 ring stages of (2·KF, L)
  float* zm_s = w_s + v2f_weight_floats<L>();    // (S, ZS) z_msg
  float* zu_s = zm_s + S * ZS;                   // (S, ZS) z_upd
  int64_t* bounds_s = reinterpret_cast<int64_t*>(zu_s + S * ZS);  // (2,)
  int* idx_s = reinterpret_cast<int*>(bounds_s + 2);  // (2, 4, S) by step parity
  int* live_s = idx_s + 2 * 4 * S;                    // (4,): 2 used
  float* cst_s = reinterpret_cast<float*>(live_s + 4);  // (2, L): b0, b2

  T* z_upd = static_cast<T*>(a.z_upd);
  const int tid = static_cast<int>(threadIdx.x);
  v2_part(a, bounds_s);
  for (int i = tid; i < L; i += THREADS) {
    cst_s[i] = to_f(static_cast<const T*>(a.b0)[i]);
    cst_s[L + i] = to_f(static_cast<const T*>(a.b2)[i]);
  }
  __syncthreads();
  const int64_t lo = bounds_s[0], hi = bounds_s[1];
  ColumnSums<T, L, S> cs;
  if (lo < hi) {
    Fp32Ring<L, KF, 2, 0> ring{a.wfma, w_s, 0};  // We, then W2 (not RES)
    if constexpr (RES) {
      for (int p = tid; p < 2 * L * L / 4; p += THREADS) cp_async16(w_s + 4 * p, a.wfma + 4 * p);
      cp_async_commit();
    } else {
      ring.issue(0);
    }
    if (tid < 32) {
      V2Slots<S, PAIR> first;
      first.load(a, lo, static_cast<int>(hi - lo < S ? hi - lo : S));
      first.publish(idx_s, live_s);
    }
    if constexpr (RES) cp_async_wait<0>();
    __syncthreads();
    const int r0 = quad_row<L>(), c0 = quad_col<L>();
    // the rows of the step: loaded during the step before's second layer
    // (have_rows) or at the step's start
    V2Rows<T, L> rows;
    bool have_rows = false;
    int s = 0;
#pragma unroll 1
    for (int64_t base = lo; base < hi; base += S, ++s) {
      const int b = s & 1;
      const int n = static_cast<int>(hi - base < S ? hi - base : S);
      const int64_t next = base + S;
      const int nn = next < hi ? static_cast<int>(hi - next < S ? hi - next : S) : 0;
      const int* idx = idx_s + b * 4 * S;
      // the next step's indices, in flight while this step's first layer runs
      V2Slots<S, PAIR> nx;
      if (tid < 32) nx.load(a, next, nn);
      const bool live = live_s[b] != 0;
      Quad ep;
      if (live) {
        if (!have_rows) rows.load(a, idx);
        // published by the ring's first barrier
        if constexpr (keep(WITHOUT_STAGE)) rows.store_e(at0);
        // --- ep = e·We, one FMA chain
        ep.zero();
        if constexpr (RES) {
          __syncthreads();
          fma_chunk<L, L, 1>({&ep}, {at0}, {w_s}, 0);
        } else {
#pragma unroll 1
          for (int k0 = 0; k0 < L; k0 += 2 * KF) {
            const float* wc = ring.acquire();
            fma_chunk<L, 2 * KF, 1>({&ep}, {at0}, {wc}, k0);
            ring.release();
          }
        }
      }
      if (tid < 32) nx.publish(idx_s + (b ^ 1) * 4 * S, live_s + (b ^ 1));
      // every warp is done with eᵀ, whose place h1ᵀ takes; the next step's
      // indices are in
      __syncthreads();
      have_rows = false;
      if (live) {
        // pre = ((a + g) + ep) + b0, as the plain version adds them; h =
        // relu(pre) rounded to the stream dtype, as the plain version
        // rounds it
        Quad h2;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a14 = cvt4(rows.q[0][i]), g14 = cvt4(rows.q[1][i]),
                       a24 = cvt4(rows.q[2][i]), g24 = cvt4(rows.q[3][i]);
          const float a1v[4] = {a14.x, a14.y, a14.z, a14.w};
          const float g1v[4] = {g14.x, g14.y, g14.z, g14.w};
          const float a2v[4] = {a24.x, a24.y, a24.z, a24.w};
          const float g2v[4] = {g24.x, g24.y, g24.z, g24.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b0c = cst_s[c0 + j];
            const float p1 = ((a1v[j] + g1v[j]) + ep.v[i][j]) + b0c;
            const float p2 = ((a2v[j] + g2v[j]) + ep.v[i][j]) + b0c;
            ep.v[i][j] = round_sd<T>(fmaxf(p1, 0.f));  // h1
            h2.v[i][j] = round_sd<T>(fmaxf(p2, 0.f));
          }
        }
        put_quad_t<L>(at0, ep);
        put_quad_t<L>(at1, h2);
        // the next step's rows, in flight while the second layer runs
        if (nn > 0 && live_s[b ^ 1]) {
          rows.load(a, idx_s + (b ^ 1) * 4 * S);
          have_rows = true;
        }
        // --- the second layer: y = h·W2 for both, each W2 value read once
        // (published by the ring's first barrier)
        Quad am, au;
        am.zero();
        au.zero();
        if constexpr (RES) {
          __syncthreads();
          fma_chunk<L, L, 2>({&am, &au}, {at0, at1}, {w_s + L * L, w_s + L * L}, 0);
        } else {
#pragma unroll 1
          for (int k0 = 0; k0 < L; k0 += 2 * KF) {
            const float* wc = ring.acquire();
            fma_chunk<L, 2 * KF, 2>({&am, &au}, {at0, at1}, {wc, wc}, k0);
            ring.release();
          }
        }
        const float* mask = reinterpret_cast<const float*>(idx) + 3 * S;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = mask[r0 + i];
          float zm[4], zu[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b2c = cst_s[L + c0 + j];
            zm[j] = fmaxf(am.v[i][j] + b2c, 0.f) * m;
            zu[j] = fmaxf(au.v[i][j] + b2c, 0.f) * m;
          }
          *reinterpret_cast<float4*>(zm_s + (r0 + i) * ZS + c0) =
              make_float4(zm[0], zm[1], zm[2], zm[3]);
          *reinterpret_cast<float4*>(zu_s + (r0 + i) * ZS + c0) =
              make_float4(zu[0], zu[1], zu[2], zu[3]);
        }
        __syncthreads();
      }
      cs.step(zm_s, zu_s, idx, n, live, base, z_upd, a.R, idx + 2 * S);
      __syncthreads();  // the tiles and this step's indices are restaged
    }
  }
  cs.finish(a.R, a.mpart + static_cast<int64_t>(blockIdx.x) * 4 * L);
  cp_async_wait<0>();
  timer.stop();
}

// The tensor-core kernel's row tiles of a step: e, then the addends.
enum { R_E, R_A1, R_G1, R_A2, R_G2, N_ROWS };

// Shared memory of the tensor-core kernel: the resident We and W2, two
// buffers of the step's five row tiles, the h tiles (all bf16, swizzled),
// the fp32 z tiles, then the indices of three steps and the biases.
template <int L> __host__ __device__ constexpr int64_t v2f_mma_smem() {
  return (2 * L * L + 2 * N_ROWS * M * L + 2 * M * L) * 2 + 2 * M * (L + 4) * 4 + 16 +
         3 * 4 * M * 4 + 16 + 2 * L * 4;
}

// Issues the cp.async copies of the five row tiles of a step (indices
// idx_s; a row without its index is zero-filled) into the swizzled tiles of
// buffer buf, and commits them.
template <int L>
__device__ __forceinline__ void issue_v2_rows(const V2FwdArgs& a, uint16_t* buf,
                                              const int* idx_s) {
  constexpr int CH = L / 8;  // 16-byte chunks of a row
  for (int p = static_cast<int>(threadIdx.x); p < N_ROWS * M * CH; p += THREADS) {
    const int t = p / (M * CH), row = (p / CH) % M, c = (p % CH) * 8;
    // e at the slot, a1 / a2 at the receiver, g1 / g2 at the sender row
    const int at = idx_s[(t == R_E ? 2 : t % 2 == 1 ? 0 : 1) * M + row];
    const void* base = t == R_E ? a.e : t == R_A1 ? a.a1 : t == R_G1 ? a.g1 : t == R_A2 ? a.a2
                                                                                      : a.g2;
    const uint16_t* src =
        static_cast<const uint16_t*>(base) + (at >= 0 ? static_cast<int64_t>(at) * L + c : 0);
    if constexpr (keep(WITHOUT_COPY))
      cp_async16_zfill(buf + t * M * L + swz<L>(row, c), src, at >= 0);
    else
      (void)src;
  }
  cp_async_commit();
}

// bf16 streams at L = 64 or 128: the three products on the tensor cores.
// The body of `v2_fwd_tile_mma_kernel` (#5) and `pair_fwd_tile_mma_kernel`
// (#7).
template <typename T, int L, bool PAIR>
__device__ __forceinline__ void fwd_tile_mma(const V2FwdArgs& a) {
  static_assert(sizeof(T) == 2, "bf16 streams");
  static_assert(v2f_mma_smem<L>() <= 232448, "fits an SM's 227 KB");
  constexpr int ZS = L + 4;
  PartClock timer;
  extern __shared__ float4 smem4[];
  uint16_t* w_s = reinterpret_cast<uint16_t*>(smem4);  // (2, L, L): We, W2
  uint16_t* buf_s = w_s + 2 * L * L;                   // 2 × N_ROWS (M, L) row tiles
  uint16_t* h_s = buf_s + 2 * N_ROWS * M * L;          // (2, M, L): h1, h2
  float* zm_s = reinterpret_cast<float*>(h_s + 2 * M * L);  // (M, ZS) z_msg
  float* zu_s = zm_s + M * ZS;                              // (M, ZS) z_upd
  int64_t* bounds_s = reinterpret_cast<int64_t*>(zu_s + M * ZS);  // (2,)
  int* idx_s = reinterpret_cast<int*>(bounds_s + 2);  // (3, 4, M): step s at s % 3
  int* live_s = idx_s + 3 * 4 * M;                    // (4,): 3 used
  float* cst_s = reinterpret_cast<float*>(live_s + 4);  // (2, L): b0, b2

  T* z_upd = static_cast<T*>(a.z_upd);
  const int tid = static_cast<int>(threadIdx.x);
  v2_part(a, bounds_s);
  for (int i = tid; i < L; i += THREADS) {
    cst_s[i] = to_f(static_cast<const T*>(a.b0)[i]);
    cst_s[L + i] = to_f(static_cast<const T*>(a.b2)[i]);
  }
  __syncthreads();
  const int64_t lo = bounds_s[0], hi = bounds_s[1];
  auto rows_of = [&](int64_t base) {
    return base < hi ? static_cast<int>(hi - base < M ? hi - base : M) : 0;
  };
  ColumnSums<T, L, M> cs;
  if (lo < hi) {
    for (int w = 0; w < 2; ++w) {
      const auto* src = static_cast<const uint16_t*>(w == 0 ? a.we : a.w2);
      for (int p = tid; p < L * L / 8; p += THREADS) {
        const int r = p / (L / 8), c = (p % (L / 8)) * 8;
        cp_async16(w_s + w * L * L + swz<L>(r, c), src + r * L + c);
      }
    }
    cp_async_commit();
    // the indices of steps 0 and 1, then step 0's rows
    if (tid < 32) {
      V2Slots<M, PAIR> first;
      first.load(a, lo, rows_of(lo));
      first.publish(idx_s, live_s);
      V2Slots<M, PAIR> second;
      second.load(a, lo + M, rows_of(lo + M));
      second.publish(idx_s + 4 * M, live_s + 1);
    }
    __syncthreads();
    if (live_s[0]) issue_v2_rows<L>(a, buf_s, idx_s);

    int s = 0;
#pragma unroll 1
    for (int64_t base = lo; base < hi; base += M, ++s) {
      const int n = rows_of(base);
      const int b3 = s % 3, n3 = (s + 1) % 3, f3 = (s + 2) % 3;
      // the indices of the step after next, in flight while this step runs
      V2Slots<M, PAIR> nx;
      if (tid < 32) nx.load(a, base + 2 * M, rows_of(base + 2 * M));
      cp_async_wait<0>();
      __syncthreads();  // this step's rows (and the weights) are in
      const int* idx = idx_s + b3 * 4 * M;
      uint16_t* cur = buf_s + (s & 1) * N_ROWS * M * L;
      // the next step's rows, in flight while this step runs
      if (rows_of(base + M) > 0 && live_s[n3])
        issue_v2_rows<L>(a, buf_s + ((s + 1) & 1) * N_ROWS * M * L, idx_s + n3 * 4 * M);
      const bool live = live_s[b3] != 0;
      if (live) {
        // --- ep = e·We, then h = relu(((a + g) + ep) + b0) grouped in fp32
        Frag<L> ep;
        ep.zero();
#pragma unroll 1
        for (int k0 = 0; k0 < L; k0 += KC)
          mma_chunk<1, L, 1, true>({&ep}, {cur + R_E * M * L}, w_s + k0 * L, L * L, k0);
        for_pairs<L>(ep, [&](int row, int col, float& v0, float& v1) {
          const int o = swz<L>(row, col);
          float2 t[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            t[k] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(cur + (R_A1 + k) * M * L + o));
          const float b0a = cst_s[col], b0b = cst_s[col + 1];
          store2(reinterpret_cast<__nv_bfloat16*>(h_s + o),
                 fmaxf(((t[0].x + t[1].x) + v0) + b0a, 0.f),
                 fmaxf(((t[0].y + t[1].y) + v1) + b0b, 0.f));
          store2(reinterpret_cast<__nv_bfloat16*>(h_s + M * L + o),
                 fmaxf(((t[2].x + t[3].x) + v0) + b0a, 0.f),
                 fmaxf(((t[2].y + t[3].y) + v1) + b0b, 0.f));
        });
      }
      if (tid < 32) nx.publish(idx_s + f3 * 4 * M, live_s + f3);
      __syncthreads();  // h1, h2 and the indices of the step after next are in
      if (live) {
        // --- the second layer: y = h·W2 for both
        Frag<L> y1, y2;
        y1.zero();
        y2.zero();
#pragma unroll 1
        for (int k0 = 0; k0 < L; k0 += KC)
          mma_chunk<1, L, 2, true>({&y1, &y2}, {h_s, h_s + M * L}, w_s + (L + k0) * L, L * L,
                                   k0);
        const float* mask = reinterpret_cast<const float*>(idx) + 3 * M;
        auto put_z = [&](float* z_s) {
          return [&, z_s](int row, int col, float& v0, float& v1) {
            *reinterpret_cast<float2*>(z_s + row * ZS + col) =
                make_float2(fmaxf(v0 + cst_s[L + col], 0.f) * mask[row],
                            fmaxf(v1 + cst_s[L + col + 1], 0.f) * mask[row]);
          };
        };
        for_pairs<L>(y1, put_z(zm_s));
        for_pairs<L>(y2, put_z(zu_s));
        __syncthreads();
      }
      cs.step(zm_s, zu_s, idx, n, live, base, z_upd, a.R, idx + 2 * M);
    }
  }
  cs.finish(a.R, a.mpart + static_cast<int64_t>(blockIdx.x) * 4 * L);
  cp_async_wait<0>();
  timer.stop();
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) v2_fwd_tile_fma_kernel(const V2FwdArgs a) {
  fwd_tile_fma<T, L, false>(a);
}
template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) pair_fwd_tile_fma_kernel(const V2FwdArgs a) {
  fwd_tile_fma<T, L, true>(a);
}
template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) v2_fwd_tile_mma_kernel(const V2FwdArgs a) {
  fwd_tile_mma<T, L, false>(a);
}
template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) pair_fwd_tile_mma_kernel(const V2FwdArgs a) {
  fwd_tile_mma<T, L, true>(a);
}

// Zero rows of z_upd at the slots rows[0, n_rows) (the pair-blocked
// layout's padding slots), 16 bytes a thread.
template <typename T>
__global__ void zero_z_rows_kernel(T* __restrict__ z, const int32_t* __restrict__ rows,
                                   int64_t n_rows, int64_t L) {
  const int64_t per_row = L * static_cast<int64_t>(sizeof(T)) / 16;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_rows * per_row) return;
  const uint4 zero = {0u, 0u, 0u, 0u};
  reinterpret_cast<uint4*>(z + static_cast<int64_t>(rows[idx / per_row]) * L)[idx % per_row] =
      zero;
}

// Whether a launch at width L with bf16 (1) or fp32 (0) streams runs the
// FMA kernel, which reads the fp32 weight copy wfma.
__host__ __device__ constexpr bool v2f_needs_wfma(int bf16, int64_t L) {
  return !bf16 || L == 256;
}

// Dynamic shared memory of the tile kernel that runs at (bf16, L), bytes.
inline int64_t v2f_smem(int bf16, int64_t L) {
  if (!v2f_needs_wfma(bf16, L)) return L == 64 ? v2f_mma_smem<64>() : v2f_mma_smem<128>();
  return L == 64 ? v2f_fma_smem<64>() : L == 128 ? v2f_fma_smem<128>() : v2f_fma_smem<256>();
}

template <typename K>
cudaError_t v2f_launch_tile(K kernel, int64_t smem, const V2FwdArgs& a, unsigned grid,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// The forward on `stream`: R zeroed, the zero rows written, the weights
// copied for the FMA chains, the tile kernel over the entries (one CTA a
// part), then the moments reduce.
template <typename T, int L, bool PAIR>
cudaError_t v2_fwd_launch(const V2FwdArgs& a, const int32_t* zero_rows, int64_t n_zero,
                          int64_t n_parts, cudaStream_t s) {
  constexpr bool FMA = v2f_needs_wfma(sizeof(T) == 2, L);
  cudaError_t err =
      cudaMemsetAsync(a.R, 0, static_cast<size_t>(a.n_nodes * L) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (n_zero > 0) {
    const int64_t n_threads = n_zero * (L * static_cast<int64_t>(sizeof(T)) / 16);
    zero_z_rows_kernel<T><<<static_cast<unsigned>((n_threads + 255) / 256), 256, 0, s>>>(
        static_cast<T*>(a.z_upd), zero_rows, n_zero, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>(n_parts);
  if constexpr (FMA) {
    err = copy_weights<T>(WeightList{{a.we, a.w2, nullptr, nullptr}}, 2, L,
                          const_cast<float*>(a.wfma), s);
    if (err != cudaSuccess) return err;
    if constexpr (PAIR)
      err = v2f_launch_tile(pair_fwd_tile_fma_kernel<T, L>, v2f_fma_smem<L>(), a, grid, s);
    else
      err = v2f_launch_tile(v2_fwd_tile_fma_kernel<T, L>, v2f_fma_smem<L>(), a, grid, s);
  } else if constexpr (PAIR) {
    err = v2f_launch_tile(pair_fwd_tile_mma_kernel<T, L>, v2f_mma_smem<L>(), a, grid, s);
  } else {
    err = v2f_launch_tile(v2_fwd_tile_mma_kernel<T, L>, v2f_mma_smem<L>(), a, grid, s);
  }
  if (err != cudaSuccess) return err;
  return moments_reduce(a.mpart, n_parts, L, a.moments, s);
}

}  // namespace
