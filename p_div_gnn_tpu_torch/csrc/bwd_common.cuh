// Device code shared by the three one-pass edge-step backwards: the fused3
// backward (fused_edge3_bwd.cu, #2), the v2 backward (fused_edge_bwd.cu, #6)
// and the pair-blocked backward (fused_edge2_bwd.cu, #8). It holds the
// split-weight ring of their tile kernels' tensor-core products, the
// preparation of their weights, and their weight grads: a weight-grad
// kernel that sums A[i]ᵀB[i] over a list of (A, B) stream pairs per weight
// grad, and the ordered reduce of its partials. An including source
// includes "mma_sm90.cuh" and "fused3_tile.cuh" first (a header includes no
// other local header). Everything here lives in an anonymous namespace.
//
// The weight grads Σ_i A[i]ᵀB[i] sum over every slot (~2.6e5 at the
// flagship size), which the TPU kernels sum into one block revisited by
// every grid step. Here `bwd_wgrad_kernel` cuts the rows into chunks; CTA
// (chunk, weight grad, 64-row block, column block of at most 128) sums its
// block over the chunk in items of WG = 32 rows and one (A, B) pair:
// cp.async (zero-filling past the chunk and where a row is missing) keeps 3
// items' rows in flight while one is split into NT-term bf16 tiles, both
// read with ldmatrix.trans; the tensor cores (mma.sync m16n8k16) sum each
// k16 block of rows from 0 (in fp32 mode the six cross products of the
// three-term splits, bf16x6), an item's two blocks are added in fp32, and
// that 32-row partial is added to an fp64 register accumulator (it rounds
// at the size of a few products, not of the running sum). `bwd_reduce_kernel`
// sums the per-chunk and the tile kernel's per-part partials in order in
// fp64 and rounds once: two calls give bit-equal weight grads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 32;          // rows of a weight-grad item (one fp32 partial)
constexpr int WSTAGES = 4;      // weight-grad items in shared memory: 3 in flight
constexpr int WG_ROWS = 64;     // weight-grad rows of a CTA
constexpr int WG_COLS = 128;    // weight-grad columns of a CTA, at most
constexpr int MAX_CHUNK = 8192;  // rows of a weight-grad chunk, at most (indices in shared memory)
constexpr int MAX_STREAMS = 10;  // operand streams of a weight-grad launch
constexpr int MAX_PAIRS = 2;     // (A, B) pairs of a weight grad

template <int L> __host__ __device__ constexpr int wg_cols() { return L < WG_COLS ? L : WG_COLS; }
// threads of a weight-grad CTA: 16 warps with fp32 streams (one CTA per SM),
// 8 with bf16 (two); fewer where a 64-column block leaves each warp column
// under two n8 tiles
template <int NT, int L> __host__ __device__ constexpr int wthreads() {
  return 64 * ((NT == 1 ? 4 : 8) < wg_cols<L>() / 16 ? (NT == 1 ? 4 : 8) : wg_cols<L>() / 16);
}

// The split-weight ring of a tile kernel's tensor-core products: chunk q of
// the stream (KC rows of one of the NW weights in turn, NT terms, swizzled)
// goes to stage q & 1 by cp.async. acquire() waits for chunk q and starts
// chunk q + 1.
template <int NT, int L, int NW>
struct SplitRing {
  const uint16_t* wsplit;  // (NW, NT, L, L) bf16 terms
  uint16_t* ring;          // 2 stages of (NT, KC, L)
  int q;

  __device__ __forceinline__ void issue(int qq) {
    constexpr int CHUNKS = L / KC, ROW8 = L / 8, PER_TERM = KC * ROW8;
    const int w = (qq / CHUNKS) % NW, kc = qq % CHUNKS;
    uint16_t* dst = ring + (qq & 1) * NT * KC * L;
    for (int p = threadIdx.x; p < NT * PER_TERM; p += THREADS) {
      const int t = p / PER_TERM, r = (p % PER_TERM) / ROW8, c = (p % ROW8) * 8;
      cp_async16(dst + t * KC * L + swz<L>(r, c),
                 wsplit + (static_cast<int64_t>(w * NT + t) * L + kc * KC + r) * L + c);
    }
    cp_async_commit();
  }
  // One barrier a chunk: it publishes chunk q, and every thread has left
  // chunk q - 1, whose stage chunk q + 1 then takes.
  __device__ __forceinline__ const uint16_t* acquire() {
    cp_async_wait<0>();
    __syncthreads();
    issue(q + 1);
    return ring + (q & 1) * NT * KC * L;
  }
  __device__ __forceinline__ void release() { ++q; }
};

// Copies the NW split weights into shared memory (swizzled by row), where
// they stay resident: one cp.async group.
template <int NT, int L, int NW>
__device__ __forceinline__ void load_resident(uint16_t* dst, const uint16_t* wsplit) {
  for (int p = threadIdx.x; p < NW * NT * L * L / 8; p += THREADS) {
    const int r = p / (L / 8), c = (p % (L / 8)) * 8;  // row r of the stacked weights
    cp_async16(dst + (r / L) * L * L + swz<L>(r % L, c), wsplit + static_cast<int64_t>(r) * L + c);
  }
  cp_async_commit();
}

// One split weight: acc[a] += op[a] · W for a < NA (op[a] an (R, L) tile),
// W the ring's next weight, or (RES) resident weight w.
template <int NT, int L, int NA, int R, bool RES, int NW>
__device__ __forceinline__ void mma_weight(SplitRing<NT, L, NW>& ring, const uint16_t* res, int w,
                                           Frag<L, R>* const (&acc)[NA],
                                           const uint16_t* const (&op)[NA]) {
  if constexpr (RES) {
#pragma unroll 1
    for (int k0 = 0; k0 < L; k0 += KC)
      mma_chunk<NT, L, NA, false, R>(acc, op, res + (static_cast<int64_t>(w) * NT * L + k0) * L,
                                     L * L, k0);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < L; k0 += KC) {
      const uint16_t* wc = ring.acquire();
      mma_chunk<NT, L, NA, false, R>(acc, op, wc, KC * L, k0);
      ring.release();
    }
  }
}

struct Weights {
  const void* w[8];  // each (L, L) in the stream dtype
};

// wfma[w] = weight w (< n_fma) in fp32; wsplit[w - n_fma][t] = term t of
// weight w >= n_fma (< n_w), (L, L) row-major bf16 bits.
template <typename T, int NT>
__global__ void prepare_weights_kernel(const Weights ws, int n_fma, int n_w,
                                       float* __restrict__ wfma, uint16_t* __restrict__ wsplit,
                                       int64_t L) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t LL = L * L;
  if (idx >= n_w * LL) return;
  const int64_t w = idx / LL, i = idx % LL;
  const float v = to_f(static_cast<const T*>(ws.w[w])[i]);
  if (w < n_fma) {
    wfma[idx] = v;
    return;
  }
  uint32_t t[NT];
  split<NT>(v, t);
#pragma unroll
  for (int k = 0; k < NT; ++k) wsplit[((w - n_fma) * NT + k) * LL + i] = static_cast<uint16_t>(t[k]);
}

template <typename T, int NT>
cudaError_t prepare_weights(const Weights& ws, int n_fma, int n_w, float* wfma, uint16_t* wsplit,
                            int64_t L, cudaStream_t stream) {
  const int64_t n = n_w * L * L;
  prepare_weights_kernel<T, NT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      ws, n_fma, n_w, wfma, wsplit, L);
  return cudaGetLastError();
}

// How row i of a weight-grad operand stream is found.
enum StreamKind {
  ROW,     // row i
  AT_IDX,  // row idx[i], missing where idx[i] lies outside [0, n_idx)
};

struct WgradArgs {
  const void* src[MAX_STREAMS];  // (·, L) operand streams, stream dtype
  int kind[MAX_STREAMS];         // StreamKind of each
  const int32_t* idx;            // (n_rows,) the AT_IDX streams' rows, or null
  int64_t n_idx;                 // rows of an AT_IDX stream
  int n_mats;                    // weight grads
  int n_pairs[4];                // (A, B) stream pairs of each
  int pa[4][MAX_PAIRS], pb[4][MAX_PAIRS];
  double* wpart;                 // (n_chunks, n_mats, L, L)
  int64_t n_rows, chunk;
};

// Chunks of a weight-grad launch over n_rows rows for n_mats weight grads:
// at least 256 / n_mats (with 2 row blocks of a 128-wide weight grad, ~4
// waves of CTAs on 132 SMs), and enough that a chunk has at most MAX_CHUNK
// rows.
inline int64_t wgrad_chunks(int64_t n_rows, int64_t n_mats) {
  const int64_t need = (n_rows + MAX_CHUNK - 1) / MAX_CHUNK;
  const int64_t least = 256 / n_mats;
  return need > least ? need : least;
}

// Shared memory of one weight-grad CTA: WSTAGES stages of one item's raw
// rows (stream dtype), its NT-term tiles and the chunk's indices.
template <typename T, int NT, int L>
constexpr int64_t wgrad_smem_bytes() {
  return WSTAGES * WG * (WG_ROWS + wg_cols<L>()) * static_cast<int64_t>(sizeof(T)) +
         NT * WG * (WG_ROWS + wg_cols<L>()) * 2 + MAX_CHUNK * 4;
}

// CTA (chunk ck, block y): rows [64·rb, +64) and columns [BW·cb, +BW) of
// weight grad mat over the rows of chunk ck, as Σ_pairs Σ_i A[i]ᵀB[i]: the
// tensor cores sum each pair over 32 rows in fp32, which is then added to
// an fp64 accumulator. Warp w owns rows 32·(w % 2) .. of the block and
// columns (BW/WN)·(w / 2) ... The work is a sequence of items, (32 rows,
// one pair) each; cp.async fetches the raw rows of the next WSTAGES - 1
// items while one is split into its terms and multiplied.
template <typename T, int NT, int L>
__global__ void __launch_bounds__(wthreads<NT, L>(), NT == 1 ? 2 : 1)
    bwd_wgrad_kernel(const WgradArgs a) {
  extern __shared__ float4 wsmem4[];
  constexpr int WTHREADS = wthreads<NT, L>();
  constexpr int WN = WTHREADS / 64;     // warp columns (two warp rows)
  constexpr int AW = WG_ROWS;           // weight-grad rows of a CTA
  constexpr int BW = wg_cols<L>();      // weight-grad columns of a CTA
  constexpr int RB = L / AW, CB = L / BW;
  constexpr int MT = AW / 2 / 16;       // m16 tiles of a warp
  constexpr int NTL = BW / WN / 8;      // n8 tiles of a warp
  constexpr int RAW = WG * (AW + BW);   // raw values of one item: A (WG, AW), B (WG, BW)
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // values per 16-byte copy
  static_assert(L % AW == 0 && L % BW == 0 && NTL >= 2 && NTL % 2 == 0, "weight-grad blocks");
  T* raw_s = reinterpret_cast<T*>(wsmem4);  // [stage] (RAW,)
  uint16_t* a_s = reinterpret_cast<uint16_t*>(raw_s + WSTAGES * RAW);  // NT × (WG, AW)
  uint16_t* b_s = a_s + NT * WG * AW;                                  // NT × (WG, BW)
  int32_t* idx_s = reinterpret_cast<int32_t*>(b_s + NT * WG * BW);      // (chunk,)

  const int tid = static_cast<int>(threadIdx.x), lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int64_t ck = blockIdx.x;
  const int mat = static_cast<int>(blockIdx.y) / (RB * CB);
  const int rb = (static_cast<int>(blockIdx.y) / CB) % RB, cb = static_cast<int>(blockIdx.y) % CB;
  const int64_t lo = ck * a.chunk;
  const int64_t hi = lo + a.chunk < a.n_rows ? lo + a.chunk : a.n_rows;
  const int n_pairs = a.n_pairs[mat];
  const int64_t n_items = hi > lo ? (hi - lo + WG - 1) / WG * n_pairs : 0;
  if (a.idx != nullptr)
    for (int64_t i = tid; i < hi - lo; i += WTHREADS) idx_s[i] = a.idx[lo + i];
  __syncthreads();

  // the address of row i of stream s at column col, or null where it is
  // missing (past the chunk, or an index outside the indexed stream)
  auto row_at = [&](int s, int64_t i, int col) -> const T* {
    if (i >= hi) return nullptr;
    const T* base = static_cast<const T*>(a.src[s]);
    if (a.kind[s] == AT_IDX) {
      const int64_t r = idx_s[i - lo];
      return r >= 0 && r < a.n_idx ? base + r * L + col : nullptr;
    }
    return base + i * L + col;
  };
  // item it's raw rows into its stage (zero-filled where a row is missing);
  // an item past the last commits an empty group
  auto fetch = [&](int64_t it) {
    if (it < n_items) {
      const int p = static_cast<int>(it % n_pairs);
      const int64_t base = lo + (it / n_pairs) * WG;
      T* dst = raw_s + (it % WSTAGES) * RAW;
      for (int q = tid; q < RAW / V; q += WTHREADS) {
        const bool in_a = q < WG * AW / V;
        const int qq = in_a ? q : q - WG * AW / V;
        const int width = in_a ? AW : BW;
        const int row = qq / (width / V), col = (qq % (width / V)) * V;
        const T* src = in_a ? row_at(a.pa[mat][p], base + row, rb * AW + col)
                            : row_at(a.pb[mat][p], base + row, cb * BW + col);
        if constexpr (keep(WITHOUT_WG_FETCH))
          cp_async16_zfill(dst + (in_a ? 0 : WG * AW) + row * width + col,
                           src != nullptr ? src : a.src[0], src != nullptr);
        else
          (void)src;
      }
    }
    cp_async_commit();
  };

  double acc[MT][NTL][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][nj][k] = 0.0;

  for (int s = 0; s < WSTAGES - 1; ++s) fetch(s);
#pragma unroll 1
  for (int64_t it = 0; it < n_items; ++it) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();  // item it's rows are in; item it - 1's tiles and stage are free
    fetch(it + WSTAGES - 1);
    const T* src = raw_s + (it % WSTAGES) * RAW;
    for (int q = tid; q < RAW / 4; q += WTHREADS) {
      const bool in_a = q < WG * AW / 4;
      const int qq = in_a ? q : q - WG * AW / 4;
      const int width = in_a ? AW : BW;
      const int row = qq / (width / 4), col = (qq % (width / 4)) * 4;
      const float4 v = load4(src + (in_a ? 0 : WG * AW) + row * width + col);
      if constexpr (keep(WITHOUT_WG_SPLIT)) {
        if (in_a) put4<NT, AW>(a_s, WG * AW, row, col, v);
        else put4<NT, BW>(b_s, WG * BW, row, col, v);
      } else if (v.x == 1234.5f) {
        a_s[tid] = 1;  // keeps the load
      }
    }
    __syncthreads();
    // one fp32 partial per item (32 rows): each k16 block's term products
    // are summed by the tensor cores from 0 and added to it in fp32, and it
    // is added to the fp64 accumulator
    const int j8 = lane / 8;
    float part[MT][NTL][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[mi][nj][k] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WG; kk += 16) {
      // with one term a block is one MMA, which adds to the partial itself
      float t16[MT][NTL][4];
      if constexpr (NT > 1) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
            for (int k = 0; k < 4; ++k) t16[mi][nj][k] = 0.f;
      }
      uint32_t af[NT][MT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldsm_x4_trans(af[t][mi], a_s + t * WG * AW +
                                       swz<AW>(kk + lane % 8 + (j8 >> 1) * 8,
                                               wm * (AW / 2) + mi * 16 + (j8 & 1) * 8));
#pragma unroll
      for (int tb = NT - 1; tb >= 0; --tb) {  // as mma_chunk orders the terms
        uint32_t bf[NTL][2];
#pragma unroll
        for (int j = 0; j < NTL; j += 2) {
          uint32_t r[4];
          ldsm_x4_trans(r, b_s + tb * WG * BW +
                               swz<BW>(kk + lane % 8 + (j8 & 1) * 8,
                                       wn * (BW / WN) + j * 8 + (j8 >> 1) * 8));
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int ta = NT - 1 - tb; ta >= 0; --ta)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int nj = 0; nj < NTL; ++nj)
              if constexpr (keep(WITHOUT_WG_MMA))
                mma_bf16_16816(NT > 1 ? t16[mi][nj] : part[mi][nj], af[ta][mi], bf[nj][0],
                               bf[nj][1]);
      }
      if constexpr (NT > 1) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
            for (int k = 0; k < 4; ++k) part[mi][nj][k] += t16[mi][nj][k];
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nj][k] += static_cast<double>(part[mi][nj][k]);
  }
  cp_async_wait<0>();
  double* out = a.wpart + (ck * a.n_mats + mat) * L * L;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = rb * AW + wm * (AW / 2) + mi * 16 + lane / 4 + 8 * h;
        const int64_t col = cb * BW + wn * (BW / WN) + nj * 8 + 2 * (lane % 4);
        *reinterpret_cast<double2*>(out + row * L + col) =
            make_double2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
}

// Σ_k p[k·stride] for k < n in fp64, in order; the loads go out 8 at a time
// before they are added.
__device__ __forceinline__ double ordered_sum(const double* __restrict__ p, int64_t n,
                                              int64_t stride) {
  double s = 0.0;
  int64_t k = 0;
  for (; k + 8 <= n; k += 8) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[(k + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; k < n; ++k) s += p[k * stride];
  return s;
}

// wb = [the n_mats weight grads; db2; db0] (n_mats·L + 2, L) fp32: the
// per-chunk partials wpart (n_chunks, n_mats, L, L) and the per-part
// partials bpart (n_parts, 2, L) = [Σ dy1 + dy2, Σ dpre1 + dpre2] summed in
// order in fp64, rounded once.
__global__ void bwd_reduce_kernel(const double* __restrict__ wpart, int64_t n_chunks,
                                  int64_t n_mats, const double* __restrict__ bpart,
                                  int64_t n_parts, int64_t L, float* __restrict__ wb) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_w = n_mats * L * L;
  if (idx < n_w) {
    wb[idx] = static_cast<float>(ordered_sum(wpart + idx, n_chunks, n_w));
  } else if (idx < n_w + 2 * L) {
    const int64_t j = (idx - n_w) / L, c = (idx - n_w) % L;
    wb[idx] = static_cast<float>(ordered_sum(bpart + j * L + c, n_parts, 2 * L));
  }
}

// Launches the weight-grad and reduce kernels on `stream`, after a tile
// kernel has filled the scratch streams and bpart.
template <typename T, int NT, int L>
cudaError_t launch_wgrad_reduce(const WgradArgs& wa, int64_t n_chunks, const double* bpart,
                                int64_t n_parts, float* wb, cudaStream_t stream) {
  const int smem = static_cast<int>(wgrad_smem_bytes<T, NT, L>());
  cudaError_t err = cudaFuncSetAttribute(bwd_wgrad_kernel<T, NT, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(wa.n_mats * (L / WG_ROWS) * (L / wg_cols<L>()));
  bwd_wgrad_kernel<T, NT, L><<<dim3(static_cast<unsigned>(n_chunks), blocks), wthreads<NT, L>(),
                               smem, stream>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_out = (wa.n_mats * L + 2) * static_cast<int64_t>(L);
  bwd_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      wa.wpart, n_chunks, wa.n_mats, bpart, n_parts, L, wb);
  return cudaGetLastError();
}

}  // namespace
