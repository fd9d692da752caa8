// Device code shared by the v2 (fused_edge_fwd.cu) and the pair-blocked
// (fused_edge2_fwd.cu) edge-step forwards: dtype helpers, the binary search
// of a node tile's edge blocks, the sequential-k row-times-weight product
// and the moments reduction. None of it depends on the edge layout. Each
// including source is its own translation unit, so everything here lives in
// an anonymous namespace. (The backwards share their code with the fused3
// backward instead: bwd_common.cuh, v2_bwd_tile.cuh.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
