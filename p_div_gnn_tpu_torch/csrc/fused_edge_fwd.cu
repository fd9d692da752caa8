// Fused edge-step forward (v2, the "fused" Processor) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched by `_step_forward` through
// `fused_edge_step`). Given the hoisted node projections a_u = x·Wu,
// a_v = x·Wv and their sender gathers g_v = a_v[snd], g_u = a_u[snd], for
// every edge slot i with receiver r:
//
//   ep    = e[i]·We
//   z_msg = relu(relu(((a_u[r] + g_v[i]) + ep) + b0)·W2 + b2) · mask_i
//   z_upd = relu(relu(((a_v[r] + g_u[i]) + ep) + b0)·W2 + b2) · mask_i
//
// and it writes z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
// R[r] = Σ z_msg over the edges into r, and
// M (8, L) fp32 holding the rows Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four
// zero rows. mask_i = 0 where edge_gid[i] >= n_graphs (padding slots).
//
// What bounds it on this card: 3 L×L products per real edge slot (e·We,
// shared by both evaluations, then h·W2 twice), 2·3·L² flops per slot,
// against ~2.6 KB of streamed bytes per slot in fp32 (g_v, g_u, e in, z_upd
// out): ~38 flop/byte at L = 128, above the fp32 FMA rate's ridge (67
// TFLOP/s over 3.35 TB/s = 20 flop/byte), so operations bound it in fp32;
// with bf16 streams the products run on the tensor cores (989 TFLOP/s) and
// the bytes are the bound.
//
// Design (v2_fwd_tile.cuh, shared with the pair-blocked forward; the FMA
// tile, its weight ring and the part split come from fused3_tile.cuh, the
// column walks from fwd_common.cuh, shared with the fused3 forward), at L =
// 64, 128 or 256 (the wrapper pads any other L <= 256 with zeros, which is
// exact): a memset of R, for the FMA kernel a copy of We and W2 into one
// fp32 block for its ring, the tile kernel, then the one-CTA moments
// reduce.
// - The tile kernel walks the slots in order, one CTA per SM, each part's
//   ends moved to receiver-run boundaries: the layout must give each
//   receiver one run (the receiver-major layout does; the wrapper checks it
//   once per layout tensor and raises on a split layout, as the v2 backward
//   does). The receiver rows a_u[r], a_v[r] are read directly (the TPU's
//   one-hot gather matmul has no place here). A step made only of padding
//   slots writes zero z_upd rows and skips its products.
// - fp32 streams (and bf16 at L = 256): register-tiled FMA chains over k in
//   order, the first-layer sum grouped as the plain "xla" Processor groups
//   it, ((a[r] + g) + ep) + b0 (the JAX kernel groups (a[r] + g) + (ep +
//   b0); the trained model amplifies one-ulp differences of its edge
//   activations ~250x into its output): z_upd is the plain version's bit for
//   bit. No TF32.
// - bf16 streams at L = 64 and 128: the three products on the tensor cores,
//   bf16 operands with fp32 accumulation, h = relu(pre) rounded to bf16
//   before ·W2, R summing the bf16-rounded z_msg and M the unrounded fp32 z,
//   where the JAX package rounds (`_step_kernel`).
// - R is summed per receiver run in fp64 and written once; M from per-part
//   fp64 partials added in part order. Two calls give bit-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "fused3_tile.cuh"
#include "fwd_common.cuh"
#include "v2_fwd_tile.cuh"
#include "wide_tile.cuh"

extern "C" {

// Parts (CTAs) of a launch on the current device: one per SM; 0 on error.
int64_t pdg_fused_edge_fwd_parts() { return sm_parts(); }

// Whether a launch at width L with bf16 (1) or fp32 (0) streams runs the
// FMA kernel, which reads the fp32 weight copy wfma.
int pdg_fused_edge_fwd_needs_wfma(int bf16, int64_t L) { return v2f_needs_wfma(bf16, L); }

// Dynamic shared memory of the tile kernel that runs at (bf16, L), bytes
// (`which` is unused: the forward has one tile kernel a launch).
int64_t pdg_fused_edge_fwd_smem(int bf16, int64_t L, int which) {
  (void)which;
  return v2f_smem(bf16, L);
}

// Launches the forward on `stream`. Pointers are device pointers; a_u, a_v
// (n_nodes, L), g_v, g_u, e, z_upd (n_edges, L), the weights and biases are
// fp32 (bf16 == 0) or bf16 (bf16 == 1); rcv (each receiver's slots
// consecutive) and gid are int32; R (n_nodes, L) and M (8, L) are fp32 and
// written whole; wfma (2, L, L) fp32 scratch where
// pdg_fused_edge_fwd_needs_wfma says so (else unused); mpart (n_parts, 4, L)
// fp64 scratch. L is 64, 128 or 256. Returns a cudaError_t value (0 on
// success).
int pdg_fused_edge_fwd(int bf16, const void* a_u, const void* a_v, const void* g_v,
                       const void* g_u, const void* e, const void* rcv, const void* gid,
                       const void* we, const void* w2, const void* b0, const void* b2,
                       void* z_upd, void* R, void* wfma, void* mpart, void* M, int64_t n_nodes,
                       int64_t n_edges, int64_t L, int64_t n_graphs, int64_t n_parts,
                       void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_nodes < 1 || n_edges < 1 || n_parts < 1 ||
      (v2f_needs_wfma(bf16, L) && wfma == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const V2FwdArgs a{a_u, a_v, g_v, g_u, e, static_cast<const int32_t*>(rcv), nullptr, nullptr,
                    static_cast<const int32_t*>(gid), we, w2, b0, b2,
                    static_cast<const float*>(wfma), z_upd, static_cast<float*>(R),
                    static_cast<double*>(mpart), static_cast<float*>(M), n_nodes, n_edges,
                    n_graphs, (n_edges + n_parts - 1) / n_parts};
  auto s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  cudaError_t err;
  if (L == 64)
    err = bf16 ? v2_fwd_launch<B, 64, false>(a, nullptr, 0, n_parts, s)
               : v2_fwd_launch<float, 64, false>(a, nullptr, 0, n_parts, s);
  else if (L == 128)
    err = bf16 ? v2_fwd_launch<B, 128, false>(a, nullptr, 0, n_parts, s)
               : v2_fwd_launch<float, 128, false>(a, nullptr, 0, n_parts, s);
  else
    err = bf16 ? v2_fwd_launch<B, 256, false>(a, nullptr, 0, n_parts, s)
               : v2_fwd_launch<float, 256, false>(a, nullptr, 0, n_parts, s);
  return static_cast<int>(err);
}

// Launches the wide variant (wide_tile.cuh) on `stream`: L > 256, a
// multiple of 64; `step` points to a WideStep whose tensors are fp32
// (bf16 == 0) or bf16 (bf16 == 1) streams. Returns a cudaError_t value (0
// on success).
int pdg_fused_edge_fwd_wide(int bf16, const void* step, void* stream) {
  const auto& s = *static_cast<const WideStep*>(step);
  if (s.L <= 256 || s.L % wide::WN != 0 || s.n < 0 || s.splits < 1 ||
      s.splits > wide::MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? wide::wide_forward<__nv_bfloat16, wide::V2>(s, st)
                               : wide::wide_forward<float, wide::V2>(s, st));
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
