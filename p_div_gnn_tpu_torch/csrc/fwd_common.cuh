// Device code shared by the three edge-step forwards: the fused3 forward
// (fused_edge3_fwd.cu, #1), the v2 forward (fused_edge_fwd.cu, #5) and the
// pair-blocked forward (fused_edge2_fwd.cu, #7, both through
// v2_fwd_tile.cuh): the column walks that write z_upd and sum R per
// receiver run and the moments per part, the fp32 copy of the weights the
// FMA chains' ring reads, the one-CTA reduce of the moment partials, and
// the part clock of the timing builds. An including source includes
// "mma_sm90.cuh" and "fused3_tile.cuh" first. Everything but the clock's
// C entry lives in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if PDG_PART_CLOCK
// Each CTA's first and last %globaltimer reading (ns) of the last launch:
// built only by scripts/port_fwd_ablation.py, which weighs the parts'
// balance with them.
__device__ unsigned long long part_clock[2 * 1024];
#endif

namespace {

#if PDG_PART_CLOCK
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct PartClock {
  unsigned long long t0;
  __device__ __forceinline__ PartClock() : t0(global_ns()) {}
  __device__ __forceinline__ void stop() {
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < 1024) {
      part_clock[2 * blockIdx.x] = t0;
      part_clock[2 * blockIdx.x + 1] = global_ns();
    }
  }
};
#else
struct PartClock {
  __device__ __forceinline__ void stop() {}
};
#endif

// The column sums of a CTA's slots, from a step's (MS, L + 4) z tiles. Role
// j of thread t is column q = t + 256·j of [z_msg | z_upd] (one role a
// thread, two at L = 256, none for q >= 2L): a z_msg column's thread sums
// each receiver run's z_msg (rounded to the stream dtype) in slot order in
// fp64, writing the sum once when the run ends, and Σz_msg, Σz_msg²; a
// z_upd column's thread writes the column of the z_upd rows (row i of the
// step at slot_s[i], or at base + i without slot_s) and sums Σz_upd,
// Σz_upd². A step of only padding writes zero z_upd rows and adds nothing
// (its z are zeros). The z_msg column of thread t is t.
template <typename T, int L, int MS>
struct ColumnSums {
  static constexpr int NR = 2 * L > THREADS ? 2 * L / THREADS : 1;
  static constexpr int ZS = L + 4, CH = MS < 32 ? MS : 32;  // rows read before their adds
  double s0[NR], s1[NR];  // Σz, Σz² of each role's column
  double run = 0.0;       // the open receiver run's sum (z_msg role)
  int run_r = -1;         // its receiver

  __device__ __forceinline__ ColumnSums() {
#pragma unroll
    for (int j = 0; j < NR; ++j) s0[j] = s1[j] = 0.0;
  }
  __device__ __forceinline__ void flush(float* R) {
    if (run_r >= 0) R[static_cast<int64_t>(run_r) * L + threadIdx.x] = static_cast<float>(run);
  }
  __device__ __forceinline__ void step(const float* zm_s, const float* zu_s, const int* rcv_s,
                                       int n, bool live, int64_t base, T* z_upd, float* R,
                                       const int* slot_s = nullptr) {
    if constexpr (!keep(WITHOUT_COLUMNS)) return;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int q = static_cast<int>(threadIdx.x) + THREADS * j;
      // the column's values (and the receivers) are read before the adds,
      // so the loads overlap; the adds then run in slot order
      float z[CH];
      if (q < L) {
        if (!live) continue;
#pragma unroll 1
        for (int i0 = 0; i0 < MS; i0 += CH) {
          int rr[CH];
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            z[i] = zm_s[(i0 + i) * ZS + q];
            rr[i] = rcv_s[i0 + i];
          }
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            if (i0 + i < n) {
              if constexpr (keep(WITHOUT_RUNS)) {
                if (rr[i] != run_r) {
                  flush(R);
                  run = 0.0;
                  run_r = rr[i];
                }
                run += static_cast<double>(round_sd<T>(z[i]));
              }
              if constexpr (keep(WITHOUT_MOMENTS)) {
                s0[j] += static_cast<double>(z[i]);
                s1[j] += static_cast<double>(z[i]) * z[i];
              }
            }
          }
        }
      } else if (q < 2 * L) {
        const int c = q - L;
#pragma unroll 1
        for (int i0 = 0; i0 < MS; i0 += CH) {
#pragma unroll
          for (int i = 0; i < CH; ++i) z[i] = live ? zu_s[(i0 + i) * ZS + c] : 0.f;
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            if (i0 + i < n) {
              const int64_t row = slot_s ? slot_s[i0 + i] : base + i0 + i;
              z_upd[row * L + c] = from_f<T>(z[i]);
              if constexpr (keep(WITHOUT_MOMENTS)) {
                s0[j] += static_cast<double>(z[i]);
                s1[j] += static_cast<double>(z[i]) * z[i];
              }
            }
          }
        }
      }
    }
  }
  // the last run's sum and this CTA's moment sums (rows 0, 1: z_msg; 2, 3:
  // z_upd)
  __device__ __forceinline__ void finish(float* R, double* mpart) {
    if (static_cast<int>(threadIdx.x) < L) flush(R);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int q = static_cast<int>(threadIdx.x) + THREADS * j;
      if (q < 2 * L) {
        const int row = q < L ? 0 : 2, c = q % L;
        mpart[row * L + c] = s0[j];
        mpart[(row + 1) * L + c] = s1[j];
      }
    }
  }
};

// Up to four (L, L) weights in the stream dtype.
struct WeightList {
  const void* w[4];
};

// wfma[w] = weight w in fp32 for w < n_w (the FMA kernels' ring source).
template <typename T>
__global__ void copy_weights_kernel(const WeightList ws, int n_w, int64_t L,
                                    float* __restrict__ wfma) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t LL = L * L;
  if (idx < n_w * LL) wfma[idx] = to_f(static_cast<const T*>(ws.w[idx / LL])[idx % LL]);
}

template <typename T>
cudaError_t copy_weights(const WeightList& ws, int n_w, int64_t L, float* wfma,
                         cudaStream_t s) {
  const int64_t n = n_w * L * L;
  copy_weights_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(ws, n_w, L,
                                                                                wfma);
  return cudaGetLastError();
}

// M[j] = Σ_p mpart[p][j] for j < 4, in part order; rows 4..7 are zero. One
// thread per (j, column): 4L threads; the loads of 8 parts go out before
// their adds.
__global__ void moments_reduce_kernel(const double* __restrict__ mpart, int64_t n_parts,
                                      int64_t L, float* __restrict__ M) {
  const int64_t j = threadIdx.x / L, c = threadIdx.x % L;
  double s = 0.0;
  int64_t p = 0;
  for (; p + 8 <= n_parts; p += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = mpart[((p + u) * 4 + j) * L + c];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; p < n_parts; ++p) s += mpart[(p * 4 + j) * L + c];
  M[j * L + c] = static_cast<float>(s);
  M[(4 + j) * L + c] = 0.f;
}

cudaError_t moments_reduce(const double* mpart, int64_t n_parts, int64_t L, float* M,
                           cudaStream_t s) {
  moments_reduce_kernel<<<1, static_cast<unsigned>(4 * L), 0, s>>>(mpart, n_parts, L, M);
  return cudaGetLastError();
}

// Parts (CTAs) of a forward's persistent grid on the current device: one
// per SM; 0 on error.
int64_t sm_parts() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

}  // namespace

#if PDG_PART_CLOCK
// Copies the last launch's per-CTA clock readings (2 per CTA, n_parts <=
// 1024 CTAs) to host memory.
extern "C" int pdg_part_clock(unsigned long long* host, int64_t n_parts) {
  if (n_parts < 1 || n_parts > 1024) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(host, part_clock,
                                               static_cast<size_t>(2 * n_parts) * 8));
}
#endif
