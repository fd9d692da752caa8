// Fused edge-step backward (v2, the "fused" Processor) for NVIDIA Hopper
// (sm_90a), on FMA chains that track the plain version's rounding and on
// the tensor cores.
//
// Replaces the Pallas TPU kernel `_step_bwd_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched by `_step_backward_pallas`
// from `_step_bwd`, the VJP of `fused_edge_step`). The forward
// (fused_edge_fwd.cu) computes, for every edge slot i with receiver r,
//
//   ep = e[i]·We
//   pre1 = ((a_u[r] + g_v[i]) + ep) + b0     h1 = relu(pre1)
//   pre2 = ((a_v[r] + g_u[i]) + ep) + b0     h2 = relu(pre2)
//   z_msg = relu(h1·W2 + b2)·mask_i          z_upd = relu(h2·W2 + b2)·mask_i
//
// with R[r] += z_msg and the moment rows M = [Σz_msg, Σz_msg², Σz_upd,
// Σz_upd²]. Given the cotangents dz_upd (Ep, L), dR (Np, L) and dM (8, L)
// this backward recomputes ep, h1, h2 and z_msg (re-masked: mask_i = 0
// where edge_gid[i] >= n_graphs; z_upd is the forward's) and forms
//
//   dy1 = (dR[r] + dM0 + 2·dM1·z_msg)·(z_msg > 0)    dpre1 = dy1·W2ᵀ·(h1 > 0)
//   dy2 = (dz_upd + dM2 + 2·dM3·z_upd)·(z_upd > 0)   dpre2 = dy2·W2ᵀ·(h2 > 0)
//   dg_v = dpre1, dg_u = dpre2, de = (dpre1 + dpre2)·Weᵀ   (Ep, L) stream dtype
//   da_u[r] = Σ dpre1, da_v[r] = Σ dpre2                    (Np, L) fp32
//   dW2 = Σ h1ᵀdy1 + h2ᵀdy2   dWe = Σ eᵀ(dpre1 + dpre2)
//   db2 = Σ dy1 + dy2         db0 = Σ dpre1 + dpre2
//
// What bounds it on this card: 8 L×L products per edge slot (e·We and h1·W2
// to recompute the forward, dy1·W2ᵀ, dy2·W2ᵀ and dps·Weᵀ for the data
// cotangents, h1ᵀdy1, h2ᵀdy2 and eᵀdps for the weight grads), 2·8·L² flops
// per slot, against ~4.1 KB of streamed bytes per slot in fp32 (g_v, g_u,
// e, z_upd, dz_upd in, dg_v, dg_u, de out): operations bound it in fp32
// (the four chains at the fp32 FMA rate), bytes in bf16.
//
// Design (v2_bwd_tile.cuh, shared with the pair-blocked backward; the FMA
// tile, its weight ring and the part split come from fused3_tile.cuh, the
// split-weight ring and the weight-grad and reduce kernels from
// bwd_common.cuh, shared with the fused3 backward), at L = 64, 128 or 256
// (the wrapper pads any other L <= 256 with zeros, which is exact):
// 0. `prepare_weights_kernel`: We, W2, W2ᵀ in fp32 for the chains, Weᵀ as
//    NT bf16 terms (NT = 3 in fp32 mode, 1 in bf16).
// 1. `v2_bwd_tile_kernel`: one CTA per part of ~512 slots, its ends moved to
//    receiver-run boundaries, so one CTA writes each receiver's da_u and
//    da_v rows, once, from fp64 column sums in slot order: the layout must
//    give each receiver one run (the receiver-major layout does; the wrapper
//    checks it once per layout tensor and raises on a split layout). e·We,
//    h1·W2, dy1·W2ᵀ and dy2·W2ᵀ are FMA chains bit-equal to the plain
//    version (so dg_v and dg_u are the parent kernel's bit for bit in fp32);
//    de runs on the tensor cores. The per-part db2 and db0 column sums are
//    fp64.
// 2. The weight-grad pass (bwd_common.cuh), asked for dW2 (h1, dy1), (h2,
//    dy2) and dWe (e, dps), on the tensor cores, each 32-slot partial added
//    in fp64: `bwd_wgrad_kernel_ws` (wgmma; 4 CTAs a chunk at L = 128).
// 3. `bwd_reduce_kernel`: the partials summed in order in fp64, rounded
//    once, into [dW2; dWe; db2; db0]. Two calls give bit-equal outputs.
// - Precision: fp32 FMA chains (no TF32), split-bf16 tensor-core products
//   in fp32 mode; in bf16 mode every contraction takes bf16 operands with
//   fp32 accumulation, as the JAX kernel does (`mm` of `_step_bwd_kernel`):
//   h, dy and dpre1 + dpre2 are rounded before they are contracted, and dA
//   sums the bf16-rounded dpre. The gathered dR row is not rounded, as in
//   the JAX op on the CPU, to which the tests hold the port.
// - The split, as the SASS shows it at L = 128 (scripts/port_sass.py):
//   the tile kernel's four FMA-chain products are 256 FFMA (a 4 x 4 block a
//   thread, unrolled), its one tensor-core product (de) 48 / 8 HMMA with
//   fp32 / bf16 streams (six / one term products per k16 block); the
//   wgmma weight-grad kernel's products 12 / 2 HGMMA (m64n64k16). ptxas at
//   L = 128:
//   the tile kernel 202 / 185 registers, 224,784 / 151,056 bytes of dynamic
//   shared memory (one CTA per SM); the wgmma weight-grad kernel 134 / 128
//   registers at 384 threads (one CTA per SM); no spills. chip_smoke.py prints the
//   figures at each width and dtype (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "fused3_tile.cuh"
#include "bwd_common.cuh"
#include "v2_bwd_tile.cuh"
#include "wide_tile.cuh"

extern "C" {

// CTAs of the tile kernel over n_edges slots: the rows of bpart.
int64_t pdg_fused_edge_bwd_parts(int64_t n_edges) { return v2_parts(n_edges); }

// Dynamic shared memory of the tile kernel (which == 0) or of the
// weight-grad kernel (which == 1) at width L (64, 128, 256), bytes.
int64_t pdg_fused_edge_bwd_smem(int bf16, int64_t L, int which) {
  return v2_bwd_smem(bf16, L, which);
}

// Weight-grad chunks over n_edges slots: the rows of wpart.
int64_t pdg_fused_edge_bwd_chunks(int64_t n_edges) { return wgrad_chunks(n_edges, 2); }

// Launches the backward on `stream`. Pointers are device pointers. a_u,
// a_v, g_v, g_u, e, z_upd, dz_upd, the weights, their transposes
// (weT[k][c] = we[c][k], w2T likewise), dg_v, dg_u, de and scratch
// (5, n_edges, L) are fp32 (bf16 == 0) or bf16 (bf16 == 1); dR (n_nodes,
// L), dM (8, L), da (2, n_nodes, L, zeroed by the caller) and wb (2L+2, L)
// are fp32; rcv (receiver-sorted runs) and gid are int32; wfma (3, L, L)
// fp32 and wsplit (1, 3 or 1, L, L) bf16 scratch (3 terms in fp32 mode);
// bpart (pdg_fused_edge_bwd_parts(n_edges), 2, L) and wpart (n_chunks =
// pdg_fused_edge_bwd_chunks(n_edges), 2, L, L) fp64 scratch. L is 64, 128
// or 256. Returns a cudaError_t value (0 on success).
int pdg_fused_edge_bwd(int bf16, const void* a_u, const void* a_v, const void* g_v,
                       const void* g_u, const void* e, const void* z_upd, const void* dz_upd,
                       const void* dR, const void* dM, const void* rcv, const void* gid,
                       const void* we, const void* w2, const void* w2T, const void* weT,
                       const void* b0, const void* b2, void* dg_v, void* dg_u, void* de,
                       void* da, void* scratch, void* wfma, void* wsplit, void* bpart,
                       void* wpart, void* wb, int64_t n_nodes, int64_t n_edges, int64_t L,
                       int64_t n_graphs, int64_t n_chunks, void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_nodes < 1 || n_edges < 1 || n_chunks < 1 ||
      (n_edges + n_chunks - 1) / n_chunks > MAX_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  V2TileArgs ta{a_u, a_v, g_v, g_u, e, z_upd, dz_upd,
                static_cast<const float*>(dR), static_cast<const float*>(dM),
                static_cast<const int32_t*>(rcv), nullptr, nullptr,
                static_cast<const int32_t*>(gid), b0, b2, static_cast<const float*>(wfma),
                static_cast<const uint16_t*>(wsplit), dg_v, dg_u, de, static_cast<float*>(da),
                scratch, static_cast<double*>(bpart), n_nodes, n_edges, n_graphs};
  const Weights ws{{we, w2, w2T, weT}};
  auto* wf = static_cast<float*>(wfma);
  auto* sp = static_cast<uint16_t*>(wsplit);
  auto* wp = static_cast<double*>(wpart);
  auto* o = static_cast<float*>(wb);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? v2_bwd_launch_width<__nv_bfloat16, 1, false>(ta, ws, wf, sp, nullptr, 0, nullptr,
                                                          n_edges, wp, n_chunks, o, L, s)
           : v2_bwd_launch_width<float, 3, false>(ta, ws, wf, sp, nullptr, 0, nullptr, n_edges,
                                                  wp, n_chunks, o, L, s);
  return static_cast<int>(err);
}

// Launches the wide variant (wide_tile.cuh) on `stream`: L > 256, a
// multiple of 64; `step` points to a WideStep whose tensors are fp32
// (bf16 == 0) or bf16 (bf16 == 1) streams. Returns a cudaError_t value (0
// on success).
int pdg_fused_edge_bwd_wide(int bf16, const void* step, void* stream) {
  const auto& s = *static_cast<const WideStep*>(step);
  if (s.L <= 256 || s.L % wide::WN != 0 || s.n < 0 || s.splits < 1 ||
      s.splits > wide::MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? wide::wide_backward<__nv_bfloat16, wide::V2>(s, st)
                               : wide::wide_backward<float, wide::V2>(s, st));
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
