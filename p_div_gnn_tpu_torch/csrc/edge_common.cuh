// Device code shared by the v2 (fused_edge_{fwd,bwd}.cu) and the
// pair-blocked (fused_edge2_{fwd,bwd}.cu) edge-step kernels: dtype helpers,
// the sequential-k row-times-weight product, the moments reduction of the
// forwards, and the weight-grad GEMM and final reduction of the backwards.
// None of it depends on the edge layout. Each including source is its own
// translation unit, so everything here lives in an anonymous namespace.
//
// The backwards' weight grads Σ_i A[i]ᵀB[i] over all slots (which the TPU
// kernels sum into one (2L+8, L) block revisited by every grid step) are
// formed as follows. The tile kernel writes h1, h2, dy1, dy2 and
// dpre1 + dpre2, rounded to the stream dtype as the contractions take them,
// to a scratch stream (5, Ep, L). `edge_bwd_wgrad_kernel` cuts the slots
// into chunks; each CTA computes one 64-row slab of one weight grad over one
// chunk, an outer product per slot from shared memory with a 4×8 register
// tile per thread. The products are fp32 FMAs into a register that restarts
// every WG = 8 slots; each 8-slot sum is added to an fp64 accumulator (one
// fp32 chain per chunk would round at the size of the running sum, ~1e-3
// absolute on the entries that cancel to near zero against a 2e-4 check; an
// 8-slot chain rounds at the size of a few products). Padding slots
// (edge_gid >= n_graphs) are staged as zero rows, since their products are
// exact zeros, and a step of only padding slots is skipped, so the tile
// kernel need not write their scratch rows. `edge_bwd_reduce_kernel` sums
// the per-chunk and per-tile partials in a fixed order and rounds once: the
// result does not change from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EW = 32;   // edge slots staged per step of the weight-grad kernel
constexpr int KB = 64;   // weight-grad rows per CTA
constexpr int TK = 4;    // weight-grad rows per thread (one float4 of A)
constexpr int TC = 8;    // weight-grad columns per thread
constexpr int WG = 8;    // slots per fp32 weight-grad sum
static_assert(EW % WG == 0, "a staged step holds whole fp32 sums");
// scratch streams written by a backward's tile kernel, then the edge stream e
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

// M[j] = Σ_t mpart[t][j] for j < 4, in tile order; rows 4..7 are zero.
__global__ void edge_moments_kernel(const double* __restrict__ mpart, int64_t n_tiles,
                                    int64_t L, float* __restrict__ M) {
  for (int64_t c = threadIdx.x; c < L; c += blockDim.x) {
    for (int j = 0; j < 4; ++j) {
      double s = 0.0;
      for (int64_t t = 0; t < n_tiles; ++t) s += mpart[(t * 4 + j) * L + c];
      M[j * L + c] = static_cast<float>(s);
    }
    for (int j = 4; j < 8; ++j) M[j * L + c] = 0.f;
  }
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
// of padding slots (live[i] == 0) and rows past `end` are zero. Each warp
// loads whole rows, four values per lane and load.
template <typename T>
__device__ __forceinline__ void stage_operand(float* dst, int src, int64_t col0, int width,
                                              int64_t base, int64_t end, const int* live,
                                              const T* __restrict__ scratch,
                                              const T* __restrict__ e, int64_t n_edges,
                                              int64_t L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int i = warp; i < EW; i += n_warps) {
    const int64_t ei = base + i;
    const T* row = nullptr;
    if (ei < end && live[i])
      row = src == SRC_E ? e + ei * L : scratch + (src * n_edges + ei) * L;
    for (int j4 = lane; j4 < width / 4; j4 += 32) {
      const float4 v = row ? load4(row + col0 + 4 * j4) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + i * width + 4 * j4) = v;
    }
  }
}

// Shared memory of one CTA of the weight-grad kernel.
inline int64_t edge_bwd_wgrad_smem_bytes(int64_t L) {
  return EW * (KB + L) * static_cast<int64_t>(sizeof(float)) +
         EW * static_cast<int64_t>(sizeof(int));
}

// One 64-row slab of one weight grad over one chunk of slots:
// wpart[chunk][mat][k][c] = Σ_{i in chunk} Σ_pairs A[i][k]·B[i][c], fp32 over
// each WG slots, fp64 across them. mat 0 is dW2, mat 1 dWe. The grid is
// (n_chunks, 2·L/KB) with (KB/TK)·(L/TC) threads.
template <typename T>
__global__ void __launch_bounds__(512) edge_bwd_wgrad_kernel(
    const T* __restrict__ scratch, const T* __restrict__ e, const int32_t* __restrict__ gid,
    double* __restrict__ wpart, int64_t n_edges, int64_t L, int64_t chunk, int64_t n_graphs) {
  extern __shared__ float4 wsmem4[];
  float* a_s = reinterpret_cast<float*>(wsmem4);  // (EW, KB)
  float* b_s = a_s + EW * KB;                     // (EW, L)
  int* live_s = reinterpret_cast<int*>(b_s + EW * L);  // (EW,) real slot

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
      __syncthreads();  // the previous step's operands and flags are consumed
      for (int i = threadIdx.x; i < EW; i += blockDim.x)
        live_s[i] = base + i < hi && gid[base + i] < n_graphs ? 1 : 0;
      __syncthreads();
      bool any = false;
      for (int i = 0; i < EW; ++i) any = any || live_s[i] != 0;
      if (!any) continue;  // padding only: every product is zero
      stage_operand<T>(a_s, pa[p], k0, KB, base, hi, live_s, scratch, e, n_edges, L);
      stage_operand<T>(b_s, pb[p], 0, static_cast<int>(L), base, hi, live_s, scratch, e,
                       n_edges, L);
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

// wb = [dW2; dWe; db2; db0] (2L+2, L) fp32: the per-chunk partials and the
// per-tile partials bpart (n_tiles, 3, L) = [Σdy1, Σdy2, Σdps] summed in
// order in fp64, rounded once.
__global__ void edge_bwd_reduce_kernel(const double* __restrict__ wpart, int64_t n_chunks,
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

// Launches the weight-grad and reduce kernels of a backward on `stream`,
// after its tile kernel has filled `scratch` and `bpart`.
template <typename T>
cudaError_t launch_wgrad_reduce(const T* scratch, const T* e, const int32_t* gid,
                                double* wpart, const double* bpart, float* wb,
                                int64_t n_edges, int64_t L, int64_t n_tiles, int64_t n_chunks,
                                int64_t n_graphs, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(edge_bwd_wgrad_smem_bytes(L));
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_wgrad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t chunk = (n_edges + n_chunks - 1) / n_chunks;
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(2 * (L / KB)));
  const unsigned threads = static_cast<unsigned>((KB / TK) * (L / TC));
  edge_bwd_wgrad_kernel<T><<<grid, threads, smem, stream>>>(scratch, e, gid, wpart, n_edges, L,
                                                            chunk, n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n_out = (2 * L + 2) * L;
  edge_bwd_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      wpart, n_chunks, bpart, n_tiles, L, wb);
  return cudaGetLastError();
}

}  // namespace
