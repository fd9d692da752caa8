// Device code shared by the fused3 edge step's forward
// (fused_edge3_fwd.cu) and the three one-pass backwards (fused_edge3_bwd.cu,
// fused_edge_bwd.cu, fused_edge2_bwd.cu): dtype helpers,
// the swizzled bf16 tiles and tensor-core products (mma.sync m16n8k16 over
// ldmatrix fragments), the register-tiled fp32 FMA chains with their weight
// ring, the transposed staging of an edge step's rows, and the split of the
// slots into parts whose ends lie on receiver-run boundaries. An including
// source includes "mma_sm90.cuh" first. Each including source is its own
// translation unit, so everything here lives in an anonymous namespace.
//
// The tile kernels run THREADS = 256 threads (8 warps). The backwards and
// the forward's FMA kernel take fma_rows<L>() slots an edge step at L = 64,
// 128 or 256 (64, 32, 16), the forward's tensor-core kernel M = 32 slots at
// L = 64 or 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M = 32;         // slots per edge step of the forward's tensor-core kernel
constexpr int MI = M / 32;    // m16 tiles of a warp in that kernel's products
constexpr int KC = 32;        // weight rows per tensor-core chunk (mma_chunk)
constexpr int THREADS = 256;  // 8 warps in a tile kernel
constexpr unsigned FULL = 0xffffffffu;
// the fp32 weights of the FMA chains, in the order an edge step streams them
enum { F_U, F_V, F_E, F_2 };

// A timing ablation (scripts/port_fwd_ablation.py, port_bwd_ablation.py)
// builds a tile kernel with -DPDG_WITHOUT=<part>, a name below, to take that
// part of its work out; its results are then wrong. Every other build
// leaves it 0.
#ifndef PDG_WITHOUT
#define PDG_WITHOUT 0
#endif
enum Part {
  WITHOUT_FMA = 1,   // the FMA chains' FMAs (and the shared loads feeding them)
  WITHOUT_MMA,       // the tensor-core chunks' MMAs
  WITHOUT_STAGE,     // fwd fp32: staging an edge step's rows into shared memory
  WITHOUT_COPY,      // fwd bf16: copying an edge step's rows into shared memory
  WITHOUT_RUNS,      // fwd: the R run sums; v2 bwd: the da run sums
  WITHOUT_MOMENTS,   // fwd: the moment sums
  WITHOUT_COLUMNS,   // fwd: the column walks (R, M and the z_upd stores)
  WITHOUT_WG_MMA,    // bwd: the weight-grad kernel's MMAs
  WITHOUT_WG_SPLIT,  // bwd: the weight-grad kernel's term split
  WITHOUT_WG_FETCH,  // bwd: the weight-grad kernel's operand fetch
  WITHOUT_GATHER,    // v2 bwd: the first layer's receiver and sender rows
};
__host__ __device__ constexpr bool keep(int part) { return PDG_WITHOUT != part; }

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

// Four consecutive values of a row in the stream dtype's bits (raw4), and
// as fp32 (cvt4 of them; load4 both at once). A load kept raw until its use
// lets the thread go on while it is in flight; a conversion right after
// the load waits for it.
__device__ __forceinline__ float4 raw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 raw4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float4 cvt4(float4 v) { return v; }
__device__ __forceinline__ float4 cvt4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
template <typename T> using Raw4 = decltype(raw4(static_cast<const T*>(nullptr)));
__device__ __forceinline__ float4 load4(const float* p) { return raw4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) { return cvt4(raw4(p)); }

// Two consecutive fp32 values stored in the stream dtype.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// The NT bf16 terms of v (their bits): NT = 1 rounds v, NT = 3 splits it as
// `_split3` does (b1 = bf16(v), b2 = bf16(v − b1), b3 = bf16(v − b1 − b2)).
template <int NT>
__device__ __forceinline__ void split(float v, uint32_t (&t)[NT]) {
  float r = v;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const __nv_bfloat16 b = __float2bfloat16_rn(r);
    t[i] = __bfloat16_as_ushort(b);
    r -= __bfloat162float(b);
  }
}

// Offset (in bf16 elements) of (row, col) in a tile of RL-element rows whose
// 16-byte chunks are XOR-swizzled by the row: the 8 rows an ldmatrix reads
// at one column fall in 8 different bank groups.
template <int RL>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int CPR = RL / 8;
  constexpr int X = CPR < 8 ? CPR - 1 : 7;
  return row * RL + ((((col >> 3) ^ (row & X))) << 3) + (col & 7);
}

// The NT bf16 terms of a and b, packed two to a word (a in the low half):
// split<NT> of each, one conversion instruction a term for both.
template <int NT>
__device__ __forceinline__ void split2(float a, float b, uint32_t (&t)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    t[i] = *reinterpret_cast<const uint32_t*>(&p);
    if (i + 1 < NT) {
      a -= __uint_as_float(t[i] << 16);
      b -= __uint_as_float(t[i] & 0xffff0000u);
    }
  }
}

// Writes the NT terms of 4 consecutive values at (row, col) of a swizzled
// tile; term t lies at tile + t·tstride.
template <int NT, int RL>
__device__ __forceinline__ void put4(uint16_t* tile, int tstride, int row, int col, float4 v) {
  uint32_t lo[NT], hi[NT];
  split2<NT>(v.x, v.y, lo);
  split2<NT>(v.z, v.w, hi);
  const int o = swz<RL>(row, col);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    uint2 u;
    u.x = lo[t];
    u.y = hi[t];
    *reinterpret_cast<uint2*>(tile + t * tstride + o) = u;
  }
}

// First slot at or after s (< n) that starts a receiver run, n if none.
// Warp-collective: every lane gets the same answer.
__device__ __forceinline__ int64_t run_start(const int32_t* __restrict__ rcv, int64_t s,
                                             int64_t n) {
  if (s <= 0) return 0;
  if (s >= n) return n;
  const int lane = static_cast<int>(threadIdx.x % 32);
  for (int64_t b = s;; b += 32) {
    const int64_t i = b + lane;
    const bool start = i >= n || rcv[i] != rcv[i - 1];
    const unsigned m = __ballot_sync(FULL, start);
    if (m != 0) return b + __ffs(static_cast<int>(m)) - 1;
  }
}

// The slots [lo, hi) of one CTA: the nominal part [s0, s1) with both ends
// moved to the next start of a receiver run, so each receiver's run lies in
// one CTA. Warp-collective (one whole warp); lane 0 writes lo and hi to
// bounds_s.
__device__ __forceinline__ void part_bounds(const int32_t* __restrict__ rcv, int64_t s0,
                                            int64_t s1, int64_t n, int64_t* bounds_s) {
  const int64_t lo = run_start(rcv, s0, n);
  const int64_t hi = run_start(rcv, s1, n);
  if (threadIdx.x % 32 == 0) {
    bounds_s[0] = lo;
    bounds_s[1] = hi;
  }
}

// The fp32 weight ring of the FMA chains: chunk q holds rows of the weights
// of one part of an edge step: with N1 = 3, (Wu, Wv, We) for the fused3
// first layer, then the NS weights N1, N1 + 1, ... one at a time (the
// fused3 forward: W2; its backward: W2, W2ᵀ; the v2 backwards, N1 = 0: We,
// W2, W2ᵀ). Chunk q goes to stage q & 1 by cp.async; acquire()
// waits for chunk q and starts chunk q + 1, with one barrier a chunk: it
// publishes chunk q, and every thread has left chunk q - 1, whose stage
// chunk q + 1 then takes (a wait for chunk q also waits for any other
// cp.async group the thread committed before it).
template <int L, int KF, int NS, int N1 = 3>
struct Fp32Ring {
  static_assert(N1 == 3 || N1 == 0, "a first layer of three weights, or none");
  const float* wfma;  // (N1 + NS, L, L) fp32: Wu, Wv, We (N1 = 3), then the NS weights
  float* ring;        // 2 stages of STAGE floats
  int q;
  // chunks of an edge step: the first layer's (Wu, Wv, We) KF rows at a
  // time, then each of the NS weights 2·KF rows at a time
  static constexpr int FIRST = N1 ? L / KF : 0, SINGLE = L / (2 * KF),
                       STEP = FIRST + NS * SINGLE;
  static constexpr int STAGE = (N1 ? 3 : 2) * KF * L;  // floats of a stage

  __device__ __forceinline__ void issue(int qq) {
    constexpr int ROW4 = L / 4;
    const int c = qq % STEP;
    int w[3], n, rows, k0;
    if (c < FIRST) {
      w[0] = F_U; w[1] = F_V; w[2] = F_E;
      n = 3, rows = KF, k0 = c * KF;
    } else {
      w[0] = N1 + (c - FIRST) / SINGLE;
      n = 1, rows = 2 * KF, k0 = ((c - FIRST) % SINGLE) * 2 * KF;
    }
    float* dst = ring + (qq & 1) * STAGE;
    for (int p = threadIdx.x; p < n * rows * ROW4; p += THREADS) {
      const int i = p / (rows * ROW4), r = (p % (rows * ROW4)) / ROW4, col = (p % ROW4) * 4;
      cp_async16(dst + (i * rows + r) * L + col,
                 wfma + (static_cast<int64_t>(w[i]) * L + k0 + r) * L + col);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ const float* acquire() {
    cp_async_wait<0>();
    __syncthreads();
    issue(q + 1);
    return ring + (q & 1) * STAGE;
  }
  __device__ __forceinline__ void release() { ++q; }
};

// A warp's block of an (R, L) tensor-core product (R = 16, 32 or 64 rows):
// the 8 warps lie in WR = 2 rows of warps (R >= 32) or 1, and WC = 8 / WR
// columns; warp w holds rows (R/WR)·(w % WR) + 16·mi + ..., columns
// (L/WC)·(w / WR) + 8·nj + ..., in mma fragment order.
template <int L, int R = M>
struct Frag {
  static constexpr int WR = R >= 32 ? 2 : 1, WC = 8 / WR, MI = R / WR / 16, NTL = L / WC / 8;
  static_assert(MI >= 1 && NTL >= 2 && NTL % 2 == 0, "whole m16 tiles, pairs of n8 tiles");
  float v[MI][NTL][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[mi][nj][e] = 0.f;
  }
};

// acc[a] += op[a][:, k0 : k0 + KC] · wc for a < NA: op[a] an (R, L) operand
// tile of NT terms, wc the weight rows k0 .. k0 + KC (NT terms wstride apart,
// swizzled by row), summing the cross products of terms i + j < NT. With
// DIRECT (one term only) each MMA adds to acc itself, as a plain bf16
// product with fp32 accumulation does.
template <int NT, int L, int NA, bool DIRECT = false, int R = M>
__device__ __forceinline__ void mma_chunk(Frag<L, R>* const (&acc)[NA],
                                          const uint16_t* const (&op)[NA],
                                          const uint16_t* wc, int wstride, int k0) {
  static_assert(!DIRECT || NT == 1, "direct accumulation takes one term");
  using F = Frag<L, R>;
  constexpr int NTL = F::NTL, MI = F::MI;
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const int wm = warp % F::WR, wn = warp / F::WR;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
          ldsm_x4(af[t], op[a] + t * R * L +
                             swz<L>(wm * (R / F::WR) + mi * 16 + lane % 16,
                                    k0 + kk + (lane / 16) * 8));
        // the k16 block's term products, the smallest first ((i, 2), (i, 1),
        // (i, 0) for the A terms i with i + j < NT), are summed by the tensor
        // cores from 0, then added to the accumulator in fp32: the tensor
        // cores' own sum truncates to the largest magnitude in it, so it is
        // kept to one block
        float t16[NTL][4];
        if constexpr (!DIRECT) {
#pragma unroll
          for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
            for (int k = 0; k < 4; ++k) t16[nj][k] = 0.f;
        }
#pragma unroll
        for (int tb = NT - 1; tb >= 0; --tb) {
          uint32_t b[NTL][2];
#pragma unroll
          for (int j = 0; j < NTL; j += 2) {
            const int q = lane / 8;
            uint32_t r[4];
            ldsm_x4_trans(r, wc + tb * wstride +
                                 swz<L>(kk + lane % 8 + (q & 1) * 8,
                                        wn * (L / F::WC) + j * 8 + (q >> 1) * 8));
            b[j][0] = r[0];
            b[j][1] = r[1];
            b[j + 1][0] = r[2];
            b[j + 1][1] = r[3];
          }
#pragma unroll
          for (int ta = NT - 1 - tb; ta >= 0; --ta)
#pragma unroll
            for (int nj = 0; nj < NTL; ++nj)
              if constexpr (keep(WITHOUT_MMA))
                mma_bf16_16816(DIRECT ? acc[a]->v[mi][nj] : t16[nj], af[ta], b[nj][0], b[nj][1]);
        }
        if constexpr (!DIRECT) {
#pragma unroll
          for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[a]->v[mi][nj][k] += t16[nj][k];
        }
      }
  }
}

// Calls fn(row, col, v0, v1) for each pair of fragment values (columns col
// and col + 1 of one row) of this thread.
template <int L, int R = M, typename Fn>
__device__ __forceinline__ void for_pairs(Frag<L, R>& f, Fn&& fn) {
  using F = Frag<L, R>;
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < F::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < F::NTL; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn((warp % F::WR) * (R / F::WR) + mi * 16 + g + 8 * h,
           (warp / F::WR) * (L / F::WC) + nj * 8 + 2 * tq, f.v[mi][nj][2 * h],
           f.v[mi][nj][2 * h + 1]);
}

// The FMA chains' register tile of an (fma_rows<L>(), L) product: each of
// the 256 threads holds one 4 x 4 block. With WC = L / 32, warp w owns
// columns (L/8)·w .. (L/8)·(w + 1) − 1 and lane l the block at rows
// 4·(l / WC), columns (L/8)·w + 4·(l % WC) (at L = 128: rows 4·(l / 4),
// columns 16w + 4·(l % 4)). Each output is one fp32 FMA chain over k in
// order, as the plain version's cuBLAS product forms it at these shapes.
template <int L> __host__ __device__ constexpr int fma_rows() { return THREADS * 16 / L; }

struct Quad {
  float v[4][4];  // [row][column]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }
};
static_assert(fma_rows<128>() == M, "at L = 128 the FMA tile covers an edge step's M rows");

template <int L = 128> __device__ __forceinline__ int quad_row() {
  return 4 * (static_cast<int>(threadIdx.x % 32) / (L / 32));
}
template <int L = 128> __device__ __forceinline__ int quad_col() {
  return (L / 8) * static_cast<int>(threadIdx.x / 32) + 4 * static_cast<int>(threadIdx.x % (L / 32));
}

// acc[c] = fma(AT_c[k][row], W_c[k][col], acc[c]) for the rows k of a staged
// chunk, for NC chains: AT_c an (L, fma_rows<L>()) transposed fp32
// operand, W_c the chunk of weight w_c (ROWS rows, plain fp32 layout).
template <int L, int ROWS, int NC>
__device__ __forceinline__ void fma_chunk(Quad* const (&acc)[NC], const float* const (&at)[NC],
                                          const float* const (&wc)[NC], int k0) {
  constexpr int MS = fma_rows<L>();
  const int r0 = quad_row<L>(), c0 = quad_col<L>();
#pragma unroll 4
  for (int kk = 0; kk < ROWS; ++kk) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(at[c] + (k0 + kk) * MS + r0);
      const float4 b4 = *reinterpret_cast<const float4*>(wc[c] + kk * L + c0);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (keep(WITHOUT_FMA)) acc[c]->v[i][j] = fmaf(av[i], bv[j], acc[c]->v[i][j]);
        }
    }
  }
}

// Writes a quad's 4 x 4 values transposed into an (L, fma_rows<L>()) fp32
// operand.
template <int L = 128>
__device__ __forceinline__ void put_quad_t(float* at, const Quad& q) {
  constexpr int MS = fma_rows<L>();
  const int r0 = quad_row<L>(), c0 = quad_col<L>();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(at + (c0 + j) * MS + r0) =
        make_float4(q.v[0][j], q.v[1][j], q.v[2][j], q.v[3][j]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  store2(p, v[0], v[1]);
  store2(p + 2, v[2], v[3]);
}

// float4s of an edge step's x[r], g and e rows (fma_rows<L>() of them) that
// one thread stages
template <int L> __host__ __device__ constexpr int rows_per_thread() {
  return fma_rows<L>() * L / 4 / THREADS;
}

// Loads this thread's share of an edge step's x[r], g and e rows (rows past
// n, and slots whose receiver rcv_s[row] is -1 for x, are zero): thread t
// takes row t % MS of each float4 column (MS = fma_rows<L>()), so at L <=
// 128 store_rows_t's column-major stores fall in 32 banks. All of the loads
// go out before any use.
template <typename T, int L>
__device__ __forceinline__ void load_rows(float4 (&v)[3][rows_per_thread<L>()],
                                          const T* __restrict__ x, const T* __restrict__ g,
                                          const T* __restrict__ e, const int* rcv_s,
                                          int64_t base, int n) {
  constexpr int MS = fma_rows<L>();
  const int tid = static_cast<int>(threadIdx.x);
#pragma unroll
  for (int u = 0; u < rows_per_thread<L>(); ++u) {
    const int p = tid + u * THREADS, row = p % MS, col = (p / MS) * 4;
    const int r = rcv_s[row];
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    v[0][u] = r >= 0 ? load4(x + static_cast<int64_t>(r) * L + col) : z;
    v[1][u] = row < n ? load4(g + (base + row) * L + col) : z;
    v[2][u] = row < n ? load4(e + (base + row) * L + col) : z;
  }
}

// Stores load_rows' values transposed into the (L, fma_rows<L>()) fp32
// operands at0, at1, at2.
template <int L>
__device__ __forceinline__ void store_rows_t(float* at0, float* at1, float* at2,
                                             const float4 (&v)[3][rows_per_thread<L>()]) {
  constexpr int MS = fma_rows<L>();
  const int tid = static_cast<int>(threadIdx.x);
#pragma unroll
  for (int u = 0; u < rows_per_thread<L>(); ++u) {
    const int p = tid + u * THREADS, row = p % MS, col = (p / MS) * 4;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* at = k == 0 ? at0 : k == 1 ? at1 : at2;
      at[(col + 0) * MS + row] = v[k][u].x;
      at[(col + 1) * MS + row] = v[k][u].y;
      at[(col + 2) * MS + row] = v[k][u].z;
      at[(col + 3) * MS + row] = v[k][u].w;
    }
  }
}

// Stages an edge step's x[r], g and e rows transposed into the
// (L, fma_rows<L>()) fp32 operands at0, at1, at2 (the fused3 backward):
// load_rows, then store_rows_t.
template <typename T, int L>
__device__ __forceinline__ void stage_rows_t(float* at0, float* at1, float* at2,
                                             const T* __restrict__ x, const T* __restrict__ g,
                                             const T* __restrict__ e, const int* rcv_s,
                                             int64_t base, int n) {
  float4 v[3][rows_per_thread<L>()];
  load_rows<T, L>(v, x, g, e, rcv_s, base, n);
  store_rows_t<L>(at0, at1, at2, v);
}

}  // namespace
