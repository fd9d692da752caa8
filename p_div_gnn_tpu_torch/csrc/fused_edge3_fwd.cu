// Fused edge-step forward (fused3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step3_kernel` of
// p_div_gnn_tpu/ops/fused_edge3.py (launched by `_step3_forward` through
// `fused_edge_step3`). For every edge slot i with receiver r:
//
//   pre_msg = x[r]·Wu + g[i]·Wv + e[i]·We + b0
//   pre_upd = x[r]·Wv + g[i]·Wu + e[i]·We + b0
//   z_msg   = relu(relu(pre_msg)·W2 + b2) · mask_i
//   z_upd   = relu(relu(pre_upd)·W2 + b2) · mask_i
//
// and it writes z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
// R[r] = Σ z_msg over the edges into r, and M (8, L) fp32 holding the rows
// Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four zero rows. mask_i = 0 where
// edge_gid[i] >= n_graphs (padding slots).
//
// What bounds it on this card: 7 L×L products per edge slot (x·Wu, x·Wv,
// g·Wu, g·Wv and e·We, shared by both evaluations, then h·W2 twice),
// 2·7·L² flops per slot, against ~0.9 KB of streamed bytes per slot
// in fp32: ~3.6 flop/byte at L=128, so on the H100 the fp32 FMA rate
// (67 TFLOP/s, the tensor cores are not used) is the bound, not HBM.
//
// Design:
// - The TPU grid runs in order and accumulates R and M into revisited
//   output blocks. A CUDA grid does not, so this kernel gives each CTA one
//   node tile: it walks the tile's edge blocks (edge_block_tile is sorted,
//   a binary search finds the run) and is the only writer of that R tile,
//   which it keeps in shared memory. Thread c owns column c of everything it
//   accumulates, so R and the moment partials need no atomics and the sums
//   run in edge order: the result does not change from run to run.
// - M is reduced from per-tile partials by a second, one-CTA kernel. The
//   moment sums run over every edge of the batch (~3e7 terms at the
//   flagship shapes) and feed a one-pass variance E[z²] − mean², which
//   amplifies their rounding; they are accumulated in fp64 (4 adds per
//   edge and column against ~900 fp32 FMAs) and rounded once to fp32.
// - The receiver row is read directly as x[r] (the TPU's one-hot gather
//   matmul has no place here); a receiver outside the CTA's tile reads zero
//   and adds nothing to R, as the one-hot contraction does on the TPU.
// - Edges are staged 16 at a time in shared memory as fp32; the weights
//   stream from L2 (4·L² values, 256 KB in fp32, do not fit beside the
//   128 KB R tile). Each thread keeps the five first-layer products of its
//   16 edges in registers and reads the staged rows as float4 broadcasts,
//   so each shared load feeds 20 FMAs.
// - Each product is one FMA chain over k in order, as a GEMM computes it,
//   and the first-layer sum is grouped as the plain path groups it. The
//   trained model amplifies one-ulp differences in its edge activations to
//   ~1e-5 in its standardized output at the flagship size, the size of the
//   tolerance the fused path is held to against the plain path, so the
//   kernel keeps the plain path's rounding where it can.
// - Precision: fp32 FMA only, no TF32. In bf16 mode operands are bf16 with
//   fp32 accumulation, h = relu(pre) is rounded to bf16 before ·W2, R sums
//   the bf16-rounded z_msg and M the unrounded fp32 z — where the JAX
//   package rounds (fused_edge3.py `_mms`).
// - Shared memory is (tile + 3·16)·L·4 bytes + 128 (152 KB at tile 256,
//   L 128), so one CTA runs per SM: occupancy, and the single wave and a
//   bit of the grid (Np/tile CTAs), are what a faster version works on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EC = 16;  // edges staged per chunk

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

template <typename T>
__global__ void step3_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ e,
    const int32_t* __restrict__ rcv, const int32_t* __restrict__ gid,
    const int32_t* __restrict__ block_tile,
    const T* __restrict__ wu, const T* __restrict__ wv, const T* __restrict__ we,
    const T* __restrict__ w2, const T* __restrict__ b0, const T* __restrict__ b2,
    T* __restrict__ z_upd, float* __restrict__ R, double* __restrict__ mpart,
    int64_t L, int64_t tile, int64_t block, int64_t n_blocks, int64_t n_graphs) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // (tile, L) R accumulator
  float* xs = rs + tile * L;                    // (EC, L) x[r]; later h_msg
  float* gs = xs + EC * L;                      // (EC, L) g;    later h_upd
  float* es = gs + EC * L;                      // (EC, L) e
  int* rl_s = reinterpret_cast<int*>(es + EC * L);  // (EC,) local receiver or -1
  float* mk_s = reinterpret_cast<float*>(rl_s + EC);  // (EC,) mask

  const int c = threadIdx.x;  // blockDim.x == L: thread c owns column c
  const int64_t t = blockIdx.x;
  const int64_t node_lo = t * tile;
  const int64_t e_lo = first_not_less(block_tile, n_blocks, t) * block;
  const int64_t e_hi = first_not_less(block_tile, n_blocks, t + 1) * block;

  for (int64_t r = 0; r < tile; ++r) rs[r * L + c] = 0.f;
  const float b0c = to_f(b0[c]);
  const float b2c = to_f(b2[c]);
  double s_m = 0.0, s_m2 = 0.0, s_u = 0.0, s_u2 = 0.0;

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
      xs[i * L + c] = rl >= 0 ? to_f(x[(node_lo + rl) * L + c]) : 0.f;
      gs[i * L + c] = valid ? to_f(g[ei * L + c]) : 0.f;
      es[i * L + c] = valid ? to_f(e[ei * L + c]) : 0.f;
    }
    __syncthreads();

    // first layer: one FMA chain over k per product, as a GEMM runs it,
    // summed like the plain path: pre = ((x·Wu + g·Wv) + e·We) + b0
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
        const float4 x4 = *reinterpret_cast<const float4*>(xs + i * L + k);
        const float4 g4 = *reinterpret_cast<const float4*>(gs + i * L + k);
        const float4 e4 = *reinterpret_cast<const float4*>(es + i * L + k);
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
    __syncthreads();  // every thread is done reading xs / gs
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      xs[i * L + c] = round_sd<T>(fmaxf(((xu[i] + gv[i]) + ep[i]) + b0c, 0.f));
      gs[i * L + c] = round_sd<T>(fmaxf(((xv[i] + gu[i]) + ep[i]) + b0c, 0.f));
    }
    __syncthreads();

    // second layer: y = h·W2
    float am[EC], au[EC];
#pragma unroll
    for (int i = 0; i < EC; ++i) am[i] = au[i] = 0.f;
    for (int64_t k = 0; k < L; k += 4) {
      float w2_k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w2_k[j] = to_f(w2[(k + j) * L + c]);
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const float4 hm = *reinterpret_cast<const float4*>(xs + i * L + k);
        const float4 hu = *reinterpret_cast<const float4*>(gs + i * L + k);
        am[i] = fmaf(hm.x, w2_k[0], am[i]);
        am[i] = fmaf(hm.y, w2_k[1], am[i]);
        am[i] = fmaf(hm.z, w2_k[2], am[i]);
        am[i] = fmaf(hm.w, w2_k[3], am[i]);
        au[i] = fmaf(hu.x, w2_k[0], au[i]);
        au[i] = fmaf(hu.y, w2_k[1], au[i]);
        au[i] = fmaf(hu.z, w2_k[2], au[i]);
        au[i] = fmaf(hu.w, w2_k[3], au[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < EC; ++i) {
      const int64_t ei = base + i;
      const float m = mk_s[i];
      const float zm = fmaxf(am[i] + b2c, 0.f) * m;
      const float zu = fmaxf(au[i] + b2c, 0.f) * m;
      if (ei < e_hi) z_upd[ei * L + c] = from_f<T>(zu);
      const int rl = rl_s[i];
      if (rl >= 0) rs[rl * L + c] += round_sd<T>(zm);
      s_m += zm;
      s_m2 += static_cast<double>(zm) * zm;
      s_u += zu;
      s_u2 += static_cast<double>(zu) * zu;
    }
    __syncthreads();  // xs / gs / rl_s / mk_s are restaged next chunk
  }

  // column c of rs was written by this thread only: no barrier needed
  for (int64_t r = 0; r < tile; ++r) R[(node_lo + r) * L + c] = rs[r * L + c];
  double* mp = mpart + t * 4 * L;
  mp[0 * L + c] = s_m;
  mp[1 * L + c] = s_m2;
  mp[2 * L + c] = s_u;
  mp[3 * L + c] = s_u2;
}

// M[j] = Σ_t mpart[t][j] for j < 4, in tile order; rows 4..7 are zero.
__global__ void moments_reduce_kernel(const double* __restrict__ mpart, int64_t n_tiles,
                                      int64_t L, float* __restrict__ M) {
  const int c = threadIdx.x;
  for (int j = 0; j < 4; ++j) {
    double s = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) s += mpart[(t * 4 + j) * L + c];
    M[j * L + c] = static_cast<float>(s);
  }
  for (int j = 4; j < 8; ++j) M[j * L + c] = 0.f;
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* e, const int32_t* rcv,
                   const int32_t* gid, const int32_t* block_tile, const void* wu,
                   const void* wv, const void* we, const void* w2, const void* b0,
                   const void* b2, void* z_upd, float* R, double* mpart, float* M,
                   int64_t n_nodes, int64_t n_edges, int64_t L, int64_t tile,
                   int64_t n_blocks, int64_t n_graphs, size_t smem, cudaStream_t stream) {
  const int64_t n_tiles = n_nodes / tile;
  const int64_t block = n_blocks > 0 ? n_edges / n_blocks : 0;
  cudaError_t err = cudaFuncSetAttribute(
      step3_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  step3_tile_kernel<T><<<static_cast<unsigned>(n_tiles), static_cast<unsigned>(L), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(e), rcv, gid,
      block_tile, static_cast<const T*>(wu), static_cast<const T*>(wv),
      static_cast<const T*>(we), static_cast<const T*>(w2), static_cast<const T*>(b0),
      static_cast<const T*>(b2), static_cast<T*>(z_upd), R, mpart, L, tile, block, n_blocks,
      n_graphs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moments_reduce_kernel<<<1, static_cast<unsigned>(L), 0, stream>>>(mpart, n_tiles, L, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the tile kernel needs.
int64_t pdg_fused_edge3_smem_bytes(int64_t L, int64_t tile) {
  return (tile + 3 * EC) * L * static_cast<int64_t>(sizeof(float)) +
         EC * static_cast<int64_t>(sizeof(int) + sizeof(float));
}

// Launches the forward on `stream`. Pointers are device pointers; x, g, e,
// the weights and z_upd are fp32 (bf16 == 0) or bf16 (bf16 == 1); rcv, gid
// and block_tile are int32; R and M (8, L) are fp32; mpart
// (n_nodes/tile, 4, L) is fp64 scratch. Returns a cudaError_t value (0 on success).
int pdg_fused_edge3_fwd(int bf16, const void* x, const void* g, const void* e,
                        const void* rcv, const void* gid, const void* block_tile,
                        const void* wu, const void* wv, const void* we, const void* w2,
                        const void* b0, const void* b2, void* z_upd, void* R, void* mpart,
                        void* M, int64_t n_nodes, int64_t n_edges, int64_t L, int64_t tile,
                        int64_t n_blocks, int64_t n_graphs, void* stream) {
  if (L < 4 || L > 1024 || L % 4 != 0 || tile <= 0 || n_nodes % tile != 0 ||
      n_blocks < 0 || (n_blocks > 0 && n_edges % n_blocks != 0) ||
      (n_blocks == 0 && n_edges != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(pdg_fused_edge3_smem_bytes(L, tile));
  const auto* r = static_cast<const int32_t*>(rcv);
  const auto* gi = static_cast<const int32_t*>(gid);
  const auto* bt = static_cast<const int32_t*>(block_tile);
  auto* Rf = static_cast<float*>(R);
  auto* mp = static_cast<double*>(mpart);
  auto* Mf = static_cast<float*>(M);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, g, e, r, gi, bt, wu, wv, we, w2, b0, b2, z_upd, Rf, mp,
                                   Mf, n_nodes, n_edges, L, tile, n_blocks, n_graphs, smem, s)
           : launch<float>(x, g, e, r, gi, bt, wu, wv, we, w2, b0, b2, z_upd, Rf, mp, Mf,
                           n_nodes, n_edges, L, tile, n_blocks, n_graphs, smem, s);
  return static_cast<int>(err);
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
