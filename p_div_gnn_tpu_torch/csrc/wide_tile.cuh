// The wide variant of the six fused edge-step kernels (L > 256), shared by
// fused_edge3_fwd.cu / fused_edge3_bwd.cu (#1, #2), fused_edge_fwd.cu /
// fused_edge_bwd.cu (#5, #6) and fused_edge2_fwd.cu / fused_edge2_bwd.cu
// (#7, #8). An including source includes "fused3_tile.cuh" first (dtype
// helpers, load4, round_sd) and calls wide_forward<T, MODE> or
// wide_backward<T, MODE> from its `pdg_<name>_wide` entry point.
//
// Why a variant of its own: the tile kernels hold an edge step's rows of
// all L columns in registers and shared memory (fma_rows<L>() =
// THREADS·16/L slots a step), and their weights resident or in a two-stage
// ring; above L = 256 a step would no longer fill an m16 MMA tile and #2
// alone would need more than an SM's 227 KB. The wide variant strips the
// output columns instead: a CTA computes a tile of WM = 32 slots × WN = 64
// output columns, and each of its products runs the full k sum, 0 .. L − 1
// in order, as one fp32 FMA chain per output (the k sums are never split,
// so no partial product is rounded on its own). The operand rows and the
// weight rows are staged WK = 32 k at a time through shared memory (37 KB,
// static). The second layer needs all of h: each layer is a kernel of its
// own, and h, dy, dpre and the other per-slot rows cross between them as
// fp32 rows of a global scratch (n, L) each, so shared memory does not
// grow with L. The wrapper pads L to a multiple of WN (ops/widths.py: the
// zero columns are exact) and runs every width above 256 here, in both
// stream dtypes: bf16 runs the same FMA chains on widened bf16 operands,
// rounding where the plain version rounds (h before ·W2; dy, dpre and
// dpre1 + dpre2 before their products and weight-grad sums; each output).
//
// A call is a few launches on one stream, each over (slot tiles, column
// strips): the first layer (h1, h2 = relu(pre)), then the forward's second
// layer (z_upd, the rounded z_msg for R, the moment partials) or the
// backward's dy, dpre and output products; the receiver run sums (R, dx,
// da), one run per receiver (the layouts' run order, checked by the
// wrapper), summed in fp64 in slot order and written once; the column sums
// (M, db0, db2) and the weight grads (each a CTA per 64 × 64 output tile
// and slot range: fp32 products summed over 8 slots, as the v2 backward's
// kernel sums them, then in fp64; the ranges added in order). No atomics:
// two calls give bit-equal outputs.

#pragma once

namespace {
namespace wide {

constexpr int WT = 256;       // threads of a wide CTA
constexpr int WM = 32;        // slots of a CTA's tile
constexpr int WN = 64;        // output columns of a CTA's tile (the strip)
constexpr int WK = 32;        // k rows staged at a time
constexpr int WMP = WM + 1;   // staged operand row stride (bank spread)
constexpr int MAX_OPS = 3;    // operands and weights of one product kernel
constexpr int SMEM_FLOATS = MAX_OPS * WK * WMP + MAX_OPS * WK * WN;
constexpr int WG = 64;        // weight-grad output tile (WG × WG)
constexpr int WG_SLOTS = 32;  // slots a weight-grad CTA stages at a time
constexpr int WG_PART = 8;    // slots of one fp32 partial of a weight grad
constexpr int MAX_SPLITS = 32;  // slot ranges of the weight grads
static_assert(2 * 2 * WG_SLOTS * WG <= SMEM_FLOATS, "weight-grad staging fits");
static_assert(16 * 4 * WN * 2 <= SMEM_FLOATS, "the column partials fit");
static_assert(SMEM_FLOATS % 4 == 0, "whole float4s");

enum Mode { F3 = 0, V2 = 1, P2 = 2 };
// what an operand's rows are: the stream dtype's rows, fp32 rows rounded
// through the stream dtype, or two fp32 rows added and then rounded
enum Src { IN_T = 0, RND = 1, RND_SUM = 2 };

}  // namespace wide

// One wide call's tensors; null where a mode does not use them. Entries j
// in [0, n) are the slots (fused3, v2: n = Ep, entry j is slot j) or the
// real slots sorted by receiver (fused2: slot[j], rcv[j], snd[j]).
struct WideStep {
  // inputs, in the stream dtype
  const void* na;   // (Np, L) fused3 x, v2 a_u, fused2 proj_u
  const void* nb;   // (Np, L) v2 a_v, fused2 proj_v
  const void* ga;   // (Ep, L) fused3 g_x, v2 g_v
  const void* gb;   // (Ep, L) v2 g_u
  const void* e;    // (Ep, L)
  const void* wu;   // (L, L) fused3 first-layer weights
  const void* wv;
  const void* we;
  const void* w2;
  const void* wuT;  // their transposes (backwards)
  const void* wvT;
  const void* weT;
  const void* w2T;
  const void* b0;   // (L,)
  const void* b2;
  const void* z_upd;  // (Ep, L) the forward's output (backwards)
  const void* dz;     // (Ep, L) its cotangent
  const float* dr;    // (Np, L) fp32
  const float* dm;    // (8, L) fp32
  const int32_t* slot;  // (n,) fused2; null: entry j is slot j
  const int32_t* rcv;   // (n,) receiver of entry j, -1: none
  const int32_t* snd;   // (n,) fused2 sender of entry j, -1: none
  const int32_t* gid;   // (Ep,) fused3, v2: padding where >= n_graphs
  // scratch
  float* h1;  // (n, L) fp32 rows each
  float* h2;
  float* s1;
  float* s2;
  float* s3;
  float* s4;
  float* s5;
  double* part;   // (tiles, 4, L) column partials
  double* wpart;  // (splits, L, L) weight-grad partials
  // outputs
  void* z_out;     // forward: z_upd (Ep, L), stream dtype
  float* r_out;    // (Np, L): forward R; fused3 dx; v2 da_u; fused2 du_r
  float* r_out2;   // (Np, L): v2 da_v; fused2 dv_r
  float* m_out;    // forward M (8, L); backward (db2, db0) (2, L)
  void* dg;        // fused3 dg (Ep, L), stream dtype
  void* dg1;       // v2 dg_v, fused2 dpre1
  void* dg2;       // v2 dg_u, fused2 dpre2
  void* de;        // de
  float* w_out;    // weight grads (dW2, dWe[, dWu, dWv]), each (L, L) fp32
  int64_t n, L, Np, Ep, n_graphs, splits;
};

namespace wide {

struct Rows {
  const void* p;       // rows of L values: stream dtype (IN_T) or fp32
  const float* p2;     // RND_SUM: the rows added to p's
  const int32_t* idx;  // the row of entry j is idx[j] (null: j); < 0 reads zeros
  int src;
};

__device__ __forceinline__ int64_t row_of(const Rows& o, int64_t j, int64_t n) {
  if (j >= n) return -1;
  return o.idx != nullptr ? static_cast<int64_t>(o.idx[j]) : j;
}

// Four consecutive values of an operand's row as fp32 (zeros for row < 0).
template <typename T>
__device__ __forceinline__ float4 load_row(const Rows& o, int64_t row, int64_t col, int64_t L) {
  if (row < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t off = row * L + col;
  if (o.src == IN_T) return load4(static_cast<const T*>(o.p) + off);
  float4 v = load4(static_cast<const float*>(o.p) + off);
  if (o.src == RND_SUM) {
    const float4 u = load4(o.p2 + off);
    v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
  }
  return make_float4(round_sd<T>(v.x), round_sd<T>(v.y), round_sd<T>(v.z), round_sd<T>(v.w));
}

// A product plan: chain c multiplies operand (PLAN >> 6c) & 7 by weight
// (PLAN >> (6c + 3)) & 7.
__host__ __device__ constexpr unsigned plan1(int op, int w) {
  return static_cast<unsigned>(op) | (static_cast<unsigned>(w) << 3);
}
__host__ __device__ constexpr unsigned plan(unsigned c0, unsigned c1 = 0, unsigned c2 = 0,
                                            unsigned c3 = 0, unsigned c4 = 0) {
  return c0 | (c1 << 6) | (c2 << 12) | (c3 << 18) | (c4 << 24);
}

// acc[c][i][q] = Σ_k op_c[j0 + 2·ty + i][k] · w_c[k][col0 + 4·tx + q] over
// k = 0 .. L − 1 in order, one fp32 FMA chain per output (tx = t % 16,
// ty = t / 16 of the CTA's 256 threads), for the NC chains of PLAN. The
// operands' rows and the weights' rows are staged WK at a time in sm.
template <typename T, int NO, int NW, int NC, unsigned PLAN>
__device__ __forceinline__ void chains(float (&acc)[NC][2][4], const Rows (&ops)[NO],
                                       const T* const (&w)[NW], int64_t j0, int64_t n,
                                       int64_t L, int64_t col0, float* sm) {
  static_assert(NO <= MAX_OPS && NW <= MAX_OPS, "three operands and weights at most");
  float* as = sm;                   // [NO][WK][WMP], operand k-major
  float* ws = sm + NO * WK * WMP;   // [NW][WK][WN]
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[c][i][q] = 0.f;
  // this thread stages entry j0 + si of each operand, columns sk .. sk + 3
  const int si = t / 8, sk = (t % 8) * 4;
  int64_t srow[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) srow[o] = row_of(ops[o], j0 + si, n);
  for (int64_t k0 = 0; k0 < L; k0 += WK) {
    __syncthreads();  // every thread has left the previous chunk
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const float4 v = load_row<T>(ops[o], srow[o], k0 + sk, L);
      float* a = as + o * WK * WMP;
      a[(sk + 0) * WMP + si] = v.x;
      a[(sk + 1) * WMP + si] = v.y;
      a[(sk + 2) * WMP + si] = v.z;
      a[(sk + 3) * WMP + si] = v.w;
    }
#pragma unroll
    for (int wi = 0; wi < NW; ++wi)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = t + u * WT, r = p / 16, c4 = (p % 16) * 4;
        *reinterpret_cast<float4*>(ws + (wi * WK + r) * WN + c4) =
            load4(w[wi] + (k0 + r) * L + col0 + c4);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < WK; ++kk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int o = (PLAN >> (6 * c)) & 7, wi = (PLAN >> (6 * c + 3)) & 7;
        const float a0 = as[(o * WK + kk) * WMP + 2 * ty];
        const float a1 = as[(o * WK + kk) * WMP + 2 * ty + 1];
        const float4 b = *reinterpret_cast<const float4*>(ws + (wi * WK + kk) * WN + 4 * tx);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[c][0][q] = fmaf(a0, bv[q], acc[c][0][q]);
          acc[c][1][q] = fmaf(a1, bv[q], acc[c][1][q]);
        }
      }
    }
  }
}

__device__ __forceinline__ float relu(float v) { return v > 0.f ? v : 0.f; }
__device__ __forceinline__ float gate(bool on) { return on ? 1.f : 0.f; }

// Whether entry j < n is a real slot.
template <int MODE>
__device__ __forceinline__ bool real_slot(const WideStep& s, int64_t j) {
  if constexpr (MODE == P2) return true;  // the list holds the real slots only
  return s.gid[j] < s.n_graphs;
}

__device__ __forceinline__ int64_t slot_of(const WideStep& s, int64_t j) {
  return s.slot != nullptr ? static_cast<int64_t>(s.slot[j]) : j;
}

// Four consecutive values of node row r (zeros for r < 0).
template <typename T>
__device__ __forceinline__ float4 node4(const void* p, int64_t r, int64_t col, int64_t L) {
  if (r < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  return load4(static_cast<const T*>(p) + r * L + col);
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Four fp32 values stored in the stream dtype.
template <typename T>
__device__ __forceinline__ void put4(void* p, int64_t off, const float (&v)[4]) {
  store4(static_cast<T*>(p) + off, v);
}

__device__ __forceinline__ void put4f(float* p, int64_t off, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + off) = make_float4(v[0], v[1], v[2], v[3]);
}

// The CTA's column sums of NQ quantities (ps[qq][q] is this thread's sum
// over its two rows, column 4·tx + q) into part[(blockIdx.x·stride + q0 +
// qq)·L + col0 + c], each summed over the 16 row pairs in order. sm is
// free (the products are done).
template <int NQ>
__device__ __forceinline__ void column_partials(const double (&ps)[NQ][4], double* part,
                                                int stride, int q0, int64_t L, int64_t col0,
                                                float* sm) {
  double* red = reinterpret_cast<double*>(sm);  // [16][NQ][WN]
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
  __syncthreads();  // every thread has left the staged chunks
#pragma unroll
  for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
    for (int q = 0; q < 4; ++q) red[(ty * NQ + qq) * WN + 4 * tx + q] = ps[qq][q];
  __syncthreads();
  if (t < NQ * WN) {
    const int qq = t / WN, c = t % WN;
    double sum = 0.0;
    for (int r = 0; r < 16; ++r) sum += red[(r * NQ + qq) * WN + c];
    part[(static_cast<int64_t>(blockIdx.x) * stride + q0 + qq) * L + col0 + c] = sum;
  }
}

// h1 = relu(pre1), h2 = relu(pre2), unrounded fp32, for the tile's
// entries: fused3 pre = x[r]·W_a + g·W_b + e·We + b0 (the three products
// added in that order, (a, b) = (u, v) for the messages and (v, u) for the
// edge update); v2 and fused2 ((n_a[r] + n_b[s or slot]) + e·We) + b0.
template <typename T, int MODE>
__global__ void __launch_bounds__(WT) wide_first_kernel(WideStep s) {
  __shared__ float4 sm4[SMEM_FLOATS / 4];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int64_t L = s.L, j0 = static_cast<int64_t>(blockIdx.x) * WM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * WN;
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
  const int64_t col = col0 + 4 * tx;
  const float4 b0 = load4(static_cast<const T*>(s.b0) + col);
  if constexpr (MODE == F3) {
    const Rows ops[3] = {{s.na, nullptr, s.rcv, IN_T}, {s.ga, nullptr, nullptr, IN_T},
                         {s.e, nullptr, nullptr, IN_T}};
    const T* const w[3] = {static_cast<const T*>(s.wu), static_cast<const T*>(s.wv),
                           static_cast<const T*>(s.we)};
    float acc[5][2][4];
    // x·Wu, g·Wv, e·We, x·Wv, g·Wu
    chains<T, 3, 3, 5, plan(plan1(0, 0), plan1(1, 1), plan1(2, 2), plan1(0, 1), plan1(1, 0))>(
        acc, ops, w, j0, s.n, L, col0, sm);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t j = j0 + 2 * ty + i;
      if (j >= s.n) continue;
      float v1[4], v2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v1[q] = relu(((acc[0][i][q] + acc[1][i][q]) + acc[2][i][q]) + at(b0, q));
        v2[q] = relu(((acc[3][i][q] + acc[4][i][q]) + acc[2][i][q]) + at(b0, q));
      }
      put4f(s.h1, j * L + col, v1);
      put4f(s.h2, j * L + col, v2);
    }
  } else {
    const Rows ops[1] = {{s.e, nullptr, s.slot, IN_T}};
    const T* const w[1] = {static_cast<const T*>(s.we)};
    float acc[1][2][4];
    chains<T, 1, 1, 1, plan(plan1(0, 0))>(acc, ops, w, j0, s.n, L, col0, sm);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t j = j0 + 2 * ty + i;
      if (j >= s.n) continue;
      const int64_t r = s.rcv[j];
      float4 a1, c1, a2, c2;  // pre1 = (a1 + c1) + ..., pre2 = (a2 + c2) + ...
      if constexpr (MODE == V2) {
        a1 = node4<T>(s.na, r, col, L);
        a2 = node4<T>(s.nb, r, col, L);
        c1 = load4(static_cast<const T*>(s.ga) + j * L + col);
        c2 = load4(static_cast<const T*>(s.gb) + j * L + col);
      } else {
        const int64_t sn = s.snd[j];
        a1 = node4<T>(s.na, r, col, L);   // u[r]
        c1 = node4<T>(s.nb, sn, col, L);  // v[s]
        a2 = node4<T>(s.nb, r, col, L);   // v[r]
        c2 = node4<T>(s.na, sn, col, L);  // u[s]
      }
      float v1[4], v2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v1[q] = relu(((at(a1, q) + at(c1, q)) + acc[0][i][q]) + at(b0, q));
        v2[q] = relu(((at(a2, q) + at(c2, q)) + acc[0][i][q]) + at(b0, q));
      }
      put4f(s.h1, j * L + col, v1);
      put4f(s.h2, j * L + col, v2);
    }
  }
}

// The forward's second layer: z_msg = relu(h1·W2 + b2)·mask, z_upd
// likewise from h2 (h rounded through the stream dtype first); z_upd goes
// to its slot, z_msg rounded to s1 (R's rows), and the CTA's column sums of
// z_msg, z_msg², z_upd, z_upd² (fp64) to part.
template <typename T, int MODE>
__global__ void __launch_bounds__(WT) wide_second_kernel(WideStep s) {
  __shared__ float4 sm4[SMEM_FLOATS / 4];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int64_t L = s.L, j0 = static_cast<int64_t>(blockIdx.x) * WM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * WN;
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
  const int64_t col = col0 + 4 * tx;
  const Rows ops[2] = {{s.h1, nullptr, nullptr, RND}, {s.h2, nullptr, nullptr, RND}};
  const T* const w[1] = {static_cast<const T*>(s.w2)};
  float acc[2][2][4];
  chains<T, 2, 1, 2, plan(plan1(0, 0), plan1(1, 0))>(acc, ops, w, j0, s.n, L, col0, sm);
  const float4 b2 = load4(static_cast<const T*>(s.b2) + col);
  double ps[4][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t j = j0 + 2 * ty + i;
    if (j >= s.n) continue;
    const float mask = gate(real_slot<MODE>(s, j));
    float zm[4], zu[4], zq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      zm[q] = relu(acc[0][i][q] + at(b2, q)) * mask;
      zu[q] = relu(acc[1][i][q] + at(b2, q)) * mask;
      zq[q] = round_sd<T>(zm[q]);
      const double dm = zm[q], du = zu[q];
      ps[0][q] += dm;
      ps[1][q] += dm * dm;
      ps[2][q] += du;
      ps[3][q] += du * du;
    }
    put4<T>(s.z_out, slot_of(s, j) * L + col, zu);
    put4f(s.s1, j * L + col, zq);
  }
  column_partials<4>(ps, s.part, 4, 0, L, col0, sm);
}

// The backward's dy: z_msg recomputed from h1 as the forward does, then
// dy1 = ((dR[r] + dM0) + 2dM1·z_msg)·[z_msg > 0] and dy2 = ((dz_upd +
// dM2) + 2dM3·z_upd)·[z_upd > 0], unrounded fp32 to s1, s2 (fused2 reads
// dR[r] rounded through the stream dtype, as its JAX kernel casts it);
// the column sums of dy1 + dy2 (db2) to part row 0.
template <typename T, int MODE>
__global__ void __launch_bounds__(WT) wide_dy_kernel(WideStep s) {
  __shared__ float4 sm4[SMEM_FLOATS / 4];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int64_t L = s.L, j0 = static_cast<int64_t>(blockIdx.x) * WM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * WN;
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
  const int64_t col = col0 + 4 * tx;
  const Rows ops[1] = {{s.h1, nullptr, nullptr, RND}};
  const T* const w[1] = {static_cast<const T*>(s.w2)};
  float acc[1][2][4];
  chains<T, 1, 1, 1, plan(plan1(0, 0))>(acc, ops, w, j0, s.n, L, col0, sm);
  const float4 b2 = load4(static_cast<const T*>(s.b2) + col);
  const float4 dm0 = load4(s.dm + 0 * L + col), dm1 = load4(s.dm + 1 * L + col);
  const float4 dm2 = load4(s.dm + 2 * L + col), dm3 = load4(s.dm + 3 * L + col);
  double ps[1][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t j = j0 + 2 * ty + i;
    if (j >= s.n) continue;
    const float mask = gate(real_slot<MODE>(s, j));
    const int64_t r = s.rcv[j], sl = slot_of(s, j);
    const float4 dr = r >= 0 ? load4(s.dr + r * L + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 zu4 = load4(static_cast<const T*>(s.z_upd) + sl * L + col);
    const float4 dz4 = load4(static_cast<const T*>(s.dz) + sl * L + col);
    float dy1[4], dy2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float zm = relu(acc[0][i][q] + at(b2, q)) * mask;
      const float drq = MODE == P2 ? round_sd<T>(at(dr, q)) : at(dr, q);
      const float dzm = __fadd_rn(__fadd_rn(drq, at(dm0, q)),
                                  __fmul_rn(__fmul_rn(2.f, at(dm1, q)), zm));
      dy1[q] = __fmul_rn(dzm, gate(zm > 0.f));
      const float zu = at(zu4, q);
      const float dzu = __fadd_rn(__fadd_rn(at(dz4, q), at(dm2, q)),
                                  __fmul_rn(__fmul_rn(2.f, at(dm3, q)), zu));
      dy2[q] = __fmul_rn(dzu, gate(zu > 0.f));
      ps[0][q] += static_cast<double>(dy1[q] + dy2[q]);
    }
    put4f(s.s1, j * L + col, dy1);
    put4f(s.s2, j * L + col, dy2);
  }
  column_partials<1>(ps, s.part, 2, 0, L, col0, sm);
}

// dpre1 = (dy1·W2ᵀ)·[h1 > 0], dpre2 = (dy2·W2ᵀ)·[h2 > 0] (dy rounded
// through the stream dtype first), unrounded fp32 to s3, s4; v2 and fused2
// also write them to their slots in the stream dtype (dg_v, dg_u; dpre1,
// dpre2). The column sums of dpre1 + dpre2 (db0) to part row 1.
template <typename T, int MODE>
__global__ void __launch_bounds__(WT) wide_dpre_kernel(WideStep s) {
  __shared__ float4 sm4[SMEM_FLOATS / 4];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int64_t L = s.L, j0 = static_cast<int64_t>(blockIdx.x) * WM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * WN;
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
  const int64_t col = col0 + 4 * tx;
  const Rows ops[2] = {{s.s1, nullptr, nullptr, RND}, {s.s2, nullptr, nullptr, RND}};
  const T* const w[1] = {static_cast<const T*>(s.w2T)};
  float acc[2][2][4];
  chains<T, 2, 1, 2, plan(plan1(0, 0), plan1(1, 0))>(acc, ops, w, j0, s.n, L, col0, sm);
  double ps[1][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t j = j0 + 2 * ty + i;
    if (j >= s.n) continue;
    const float4 h1 = load4(s.h1 + j * L + col), h2 = load4(s.h2 + j * L + col);
    float d1[4], d2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d1[q] = acc[0][i][q] * gate(at(h1, q) > 0.f);
      d2[q] = acc[1][i][q] * gate(at(h2, q) > 0.f);
      ps[0][q] += static_cast<double>(d1[q] + d2[q]);
    }
    put4f(s.s3, j * L + col, d1);
    put4f(s.s4, j * L + col, d2);
    if constexpr (MODE != F3) {
      const int64_t sl = slot_of(s, j);
      put4<T>(s.dg1, sl * L + col, d1);
      put4<T>(s.dg2, sl * L + col, d2);
    }
  }
  column_partials<1>(ps, s.part, 2, 1, L, col0, sm);
}

// The backward's outputs: de = (dpre1 + dpre2)·Weᵀ for every mode; fused3
// also dg = dpre1·Wvᵀ + dpre2·Wuᵀ and dx's rows dpre1·Wuᵀ + dpre2·Wvᵀ
// (rounded, to s5), each operand rounded through the stream dtype first.
template <typename T, int MODE>
__global__ void __launch_bounds__(WT) wide_out_kernel(WideStep s) {
  __shared__ float4 sm4[SMEM_FLOATS / 4];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int64_t L = s.L, j0 = static_cast<int64_t>(blockIdx.x) * WM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * WN;
  const int t = static_cast<int>(threadIdx.x), tx = t % 16, ty = t / 16;
  const int64_t col = col0 + 4 * tx;
  if constexpr (MODE == F3) {
    const Rows ops[3] = {{s.s3, s.s4, nullptr, RND_SUM}, {s.s3, nullptr, nullptr, RND},
                         {s.s4, nullptr, nullptr, RND}};
    const T* const w[3] = {static_cast<const T*>(s.weT), static_cast<const T*>(s.wvT),
                           static_cast<const T*>(s.wuT)};
    float acc[5][2][4];
    // dps·Weᵀ, dpre1·Wvᵀ, dpre2·Wuᵀ, dpre1·Wuᵀ, dpre2·Wvᵀ
    chains<T, 3, 3, 5, plan(plan1(0, 0), plan1(1, 1), plan1(2, 2), plan1(1, 2), plan1(2, 1))>(
        acc, ops, w, j0, s.n, L, col0, sm);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t j = j0 + 2 * ty + i;
      if (j >= s.n) continue;
      float de[4], dg[4], dx[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        de[q] = acc[0][i][q];
        dg[q] = acc[1][i][q] + acc[2][i][q];
        dx[q] = round_sd<T>(acc[3][i][q] + acc[4][i][q]);
      }
      put4<T>(s.de, j * L + col, de);
      put4<T>(s.dg, j * L + col, dg);
      put4f(s.s5, j * L + col, dx);
    }
  } else {
    const Rows ops[1] = {{s.s3, s.s4, nullptr, RND_SUM}};
    const T* const w[1] = {static_cast<const T*>(s.weT)};
    float acc[1][2][4];
    chains<T, 1, 1, 1, plan(plan1(0, 0))>(acc, ops, w, j0, s.n, L, col0, sm);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t j = j0 + 2 * ty + i;
      if (j >= s.n) continue;
      float de[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) de[q] = acc[0][i][q];
      put4<T>(s.de, slot_of(s, j) * L + col, de);
    }
  }
}

// out[r] = Σ round(src[j]) over the run of entries j with rcv[j] == r, in
// fp64 in entry order, rounded once: thread (entry, 4 columns) sums the
// run that starts at its entry. Each receiver's entries are one run.
template <typename T>
__global__ void __launch_bounds__(WT) wide_runs_kernel(const float* __restrict__ src,
                                                       const int32_t* __restrict__ rcv,
                                                       float* __restrict__ out, int64_t n,
                                                       int64_t L, int64_t Np) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (WT / 16) + threadIdx.x / 16;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * WN + 4 * (threadIdx.x % 16);
  if (j >= n) return;
  const int r = rcv[j];
  if (r < 0 || r >= Np || (j > 0 && rcv[j - 1] == r)) return;
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t k = j; k < n && rcv[k] == r; ++k) {
    const float4 v = load4(src + k * L + col);
    a[0] += round_sd<T>(v.x);
    a[1] += round_sd<T>(v.y);
    a[2] += round_sd<T>(v.z);
    a[3] += round_sd<T>(v.w);
  }
  *reinterpret_cast<float4*>(out + r * L + col) =
      make_float4(static_cast<float>(a[0]), static_cast<float>(a[1]), static_cast<float>(a[2]),
                  static_cast<float>(a[3]));
}

// out[q][c] = Σ_b part[b][q][c] over the nb tiles in order, rounded once;
// q < nq, the partials (nb, stride, L).
__global__ void __launch_bounds__(WT) wide_colsum_kernel(const double* __restrict__ part,
                                                         int64_t nb, int64_t stride, int64_t nq,
                                                         int64_t L, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * WT + threadIdx.x;
  if (i >= nq * L) return;
  const int64_t q = i / L, c = i % L;
  double sum = 0.0;
  for (int64_t b = 0; b < nb; ++b) sum += part[(b * stride + q) * L + c];
  out[i] = static_cast<float>(sum);
}

// wpart[z][a][b] = Σ over the entries j of slot range z and the NP pairs
// p of a_p[j][a]·b_p[j][b]: per WG_PART entries an fp32 sum of the
// products (pair by pair for each entry, entries in order), then added in
// fp64. CTA (b tile, a tile, z); thread t holds a rows 4·(t / 16) .. + 3,
// b columns 4·(t % 16) .. + 3 of the tile.
template <typename T, int NP>
__global__ void __launch_bounds__(WT) wide_wgrad_kernel(Rows a0, Rows b0, Rows a1, Rows b1,
                                                        double* __restrict__ wpart, int64_t n,
                                                        int64_t L, int64_t per_split) {
  __shared__ float4 sm4[SMEM_FLOATS / 4];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  float* as = sm;                        // [NP][WG_SLOTS][WG]
  float* bs = sm + NP * WG_SLOTS * WG;   // [NP][WG_SLOTS][WG]
  const Rows aa[2] = {a0, a1}, bb[2] = {b0, b1};
  const int t = static_cast<int>(threadIdx.x), ta = t / 16, tb = t % 16;
  const int64_t c_b = static_cast<int64_t>(blockIdx.x) * WG;
  const int64_t c_a = static_cast<int64_t>(blockIdx.y) * WG;
  const int64_t lo = static_cast<int64_t>(blockIdx.z) * per_split;
  const int64_t hi = lo + per_split < n ? lo + per_split : n;
  double acc[4][4] = {};
  for (int64_t base = lo; base < hi; base += WG_SLOTS) {
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = t + u * WT, r = e / 16, c4 = (e % 16) * 4;
        const int64_t j = base + r < hi ? base + r : n;  // past the range: zeros
        *reinterpret_cast<float4*>(as + (p * WG_SLOTS + r) * WG + c4) =
            load_row<T>(aa[p], row_of(aa[p], j, n), c_a + c4, L);
        *reinterpret_cast<float4*>(bs + (p * WG_SLOTS + r) * WG + c4) =
            load_row<T>(bb[p], row_of(bb[p], j, n), c_b + c4, L);
      }
    __syncthreads();
    for (int r0 = 0; r0 < WG_SLOTS; r0 += WG_PART) {
      float tmp[4][4] = {};
#pragma unroll
      for (int r = r0; r < r0 + WG_PART; ++r)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 av = *reinterpret_cast<const float4*>(as + (p * WG_SLOTS + r) * WG + 4 * ta);
          const float4 bv = *reinterpret_cast<const float4*>(bs + (p * WG_SLOTS + r) * WG + 4 * tb);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) tmp[i][k] = fmaf(at(av, i), at(bv, k), tmp[i][k]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] += tmp[i][k];
    }
  }
  double* out = wpart + static_cast<int64_t>(blockIdx.z) * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(c_a + 4 * ta + i) * L + c_b + 4 * tb + k] = acc[i][k];
}

inline unsigned tiles_of(int64_t n, int64_t per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

// One weight grad into out (L, L) fp32: the NP pairs' products over the
// entries, the slot ranges' fp64 partials added in order.
template <typename T, int NP>
cudaError_t launch_wgrad(const WideStep& s, Rows a0, Rows b0, Rows a1, Rows b1, float* out,
                         cudaStream_t st) {
  const int64_t L = s.L;
  const int64_t per = ((s.n + s.splits - 1) / s.splits + WG_SLOTS - 1) / WG_SLOTS * WG_SLOTS;
  const dim3 grid(static_cast<unsigned>(L / WG), static_cast<unsigned>(L / WG),
                  static_cast<unsigned>(s.splits));
  wide_wgrad_kernel<T, NP><<<grid, WT, 0, st>>>(a0, b0, a1, b1, s.wpart, s.n, L, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_colsum_kernel<<<tiles_of(L * L, WT), WT, 0, st>>>(s.wpart, s.splits, L, L, L, out);
  return cudaGetLastError();
}

// The wide forward: z_upd, R (Np, L) and M (8, L: rows 4-7 zero).
template <typename T, int MODE>
cudaError_t wide_forward(const WideStep& s, cudaStream_t st) {
  const int64_t L = s.L;
  cudaError_t err = cudaMemsetAsync(s.r_out, 0, static_cast<size_t>(s.Np * L) * sizeof(float), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(s.m_out, 0, static_cast<size_t>(8 * L) * sizeof(float), st);
  if (err == cudaSuccess && MODE == P2)  // the padding slots' rows stay zero
    err = cudaMemsetAsync(s.z_out, 0, static_cast<size_t>(s.Ep * L) * sizeof(T), st);
  if (err != cudaSuccess || s.n == 0) return err;
  const dim3 grid(tiles_of(s.n, WM), static_cast<unsigned>(L / WN));
  wide_first_kernel<T, MODE><<<grid, WT, 0, st>>>(s);
  wide_second_kernel<T, MODE><<<grid, WT, 0, st>>>(s);
  wide_runs_kernel<T><<<dim3(tiles_of(s.n, WT / 16), static_cast<unsigned>(L / WN)), WT, 0, st>>>(
      s.s1, s.rcv, s.r_out, s.n, L, s.Np);
  wide_colsum_kernel<<<tiles_of(4 * L, WT), WT, 0, st>>>(s.part, grid.x, 4, 4, L, s.m_out);
  return cudaGetLastError();
}

// The wide backward: the data cotangents, the receiver run sums, (db2,
// db0) and the weight grads (dW2, dWe[, dWu, dWv]).
template <typename T, int MODE>
cudaError_t wide_backward(const WideStep& s, cudaStream_t st) {
  const int64_t L = s.L;
  const size_t node_bytes = static_cast<size_t>(s.Np * L) * sizeof(float);
  cudaError_t err = cudaMemsetAsync(s.r_out, 0, node_bytes, st);
  if (err == cudaSuccess && MODE != F3) err = cudaMemsetAsync(s.r_out2, 0, node_bytes, st);
  if (err == cudaSuccess && MODE == P2) {  // the padding slots' rows stay zero
    const size_t slot_bytes = static_cast<size_t>(s.Ep * L) * sizeof(T);
    err = cudaMemsetAsync(s.dg1, 0, slot_bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(s.dg2, 0, slot_bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(s.de, 0, slot_bytes, st);
  }
  if (err != cudaSuccess) return err;
  const int n_wg = MODE == F3 ? 4 : 2;
  if (s.n == 0) {
    err = cudaMemsetAsync(s.m_out, 0, static_cast<size_t>(2 * L) * sizeof(float), st);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(s.w_out, 0, static_cast<size_t>(n_wg * L * L) * sizeof(float), st);
  }
  const dim3 grid(tiles_of(s.n, WM), static_cast<unsigned>(L / WN));
  const dim3 run_grid(tiles_of(s.n, WT / 16), static_cast<unsigned>(L / WN));
  wide_first_kernel<T, MODE><<<grid, WT, 0, st>>>(s);
  wide_dy_kernel<T, MODE><<<grid, WT, 0, st>>>(s);
  wide_dpre_kernel<T, MODE><<<grid, WT, 0, st>>>(s);
  wide_out_kernel<T, MODE><<<grid, WT, 0, st>>>(s);
  if (MODE == F3) {
    wide_runs_kernel<T><<<run_grid, WT, 0, st>>>(s.s5, s.rcv, s.r_out, s.n, L, s.Np);
  } else {
    wide_runs_kernel<T><<<run_grid, WT, 0, st>>>(s.s3, s.rcv, s.r_out, s.n, L, s.Np);
    wide_runs_kernel<T><<<run_grid, WT, 0, st>>>(s.s4, s.rcv, s.r_out2, s.n, L, s.Np);
  }
  wide_colsum_kernel<<<tiles_of(2 * L, WT), WT, 0, st>>>(s.part, grid.x, 2, 2, L, s.m_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Rows h1{s.h1, nullptr, nullptr, RND}, h2{s.h2, nullptr, nullptr, RND};
  const Rows dy1{s.s1, nullptr, nullptr, RND}, dy2{s.s2, nullptr, nullptr, RND};
  const Rows dp1{s.s3, nullptr, nullptr, RND}, dp2{s.s4, nullptr, nullptr, RND};
  const Rows dps{s.s3, s.s4, nullptr, RND_SUM}, e{s.e, nullptr, s.slot, IN_T};
  float* w = s.w_out;
  err = launch_wgrad<T, 2>(s, h1, dy1, h2, dy2, w, st);  // dW2
  if (err == cudaSuccess) err = launch_wgrad<T, 1>(s, e, dps, e, dps, w + L * L, st);  // dWe
  if (MODE == F3) {
    const Rows x{s.na, nullptr, s.rcv, IN_T}, g{s.ga, nullptr, nullptr, IN_T};
    if (err == cudaSuccess) err = launch_wgrad<T, 2>(s, x, dp1, g, dp2, w + 2 * L * L, st);  // dWu
    if (err == cudaSuccess) err = launch_wgrad<T, 2>(s, x, dp2, g, dp1, w + 3 * L * L, st);  // dWv
  }
  return err;
}

}  // namespace wide
}  // namespace
