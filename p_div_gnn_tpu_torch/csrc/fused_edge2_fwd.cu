// Pair-blocked fused edge-step forward ("fused2") for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_step2_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched by `_step2_forward` through
// `fused_edge_step2`). The edge slots are in the pair-blocked layout
// (graphs/batching.py::blockify_edges_pair): grouped by (receiver tile,
// sender tile), each group padded to whole edge blocks, receiver-tile-major;
// block b names its receiver tile block_tile[b] and its sender tile
// block_snd_tile[b]. Given the hoisted node projections u = x·Wu and
// v = x·Wv, for every edge slot i of block b with receiver r and sender s:
//
//   u_r = u[r] if r lies in block_tile[b], else 0        (v_r likewise)
//   u_s = u[s] if s lies in block_snd_tile[b], else 0    (v_s likewise)
//   ep    = e[i]·We
//   z_msg = relu(relu(((u_r + v_s) + ep) + b0)·W2 + b2) · mask_i
//   z_upd = relu(relu(((v_r + u_s) + ep) + b0)·W2 + b2) · mask_i
//
// and it writes z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
// R[r] = Σ z_msg over the slots into r that lie in their block's receiver
// tile, and M (8, L) fp32 holding Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four
// zero rows. mask_i = 0 where edge_gid[i] >= n_graphs (padding slots). The
// in-tile rules are the TPU kernel's one-hot contractions, which read zero
// for an endpoint outside the block's tile; the layout never makes one.
//
// What bounds it on this card: 3 L×L products per real edge slot (e·We,
// shared by both evaluations, then h·W2 twice), 2·3·L² flops per slot,
// against ~1 KB of streamed bytes per slot in fp32 (e in, z_upd out; both
// endpoint rows are read from the node projections, which sit in L2):
// operations bound it in fp32; with bf16 streams the products run on the
// tensor cores and the bytes are the bound.
//
// Design (v2_fwd_tile.cuh, shared with the v2 forward fused_edge_fwd.cu,
// which describes the tile kernels), at L = 64, 128 or 256 (the wrapper
// pads any other L <= 256 with zeros, which is exact):
// - The tile kernel walks a list of the real slots stably sorted by
//   receiver (ops/fused_edge.py::pair_entries, cached on the layout), so
//   each receiver's slots are one run of the list (the layout meets a
//   receiver in up to ~4 runs, one per sender tile of its receiver tile)
//   and the padding slots (about half of the layout) cost no step; its
//   persistent grid's parts split the real slots, so they balance by real
//   work. Each entry carries its slot (the e and z_upd rows), its receiver
//   and its sender, -1 where the endpoint lies outside its block's tile
//   (that row reads zero, and a -1 receiver adds nothing to R). R is each
//   receiver's run summed in fp64 and written once, the correctly rounded
//   sum the plain version's fp64 segment sum gives, with no atomics and no
//   fp64 scratch rows.
// - The padding slots' z_upd rows are zeroed by zero_z_rows_kernel, 16
//   bytes a thread.
// - Both endpoint rows are read from u and v directly (the TPU kernel's
//   one-hot gather matmuls have no place here), with no streamed sender
//   gather.

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
int64_t pdg_fused_edge2_fwd_parts() { return sm_parts(); }

// Whether a launch at width L with bf16 (1) or fp32 (0) streams runs the
// FMA kernel, which reads the fp32 weight copy wfma.
int pdg_fused_edge2_fwd_needs_wfma(int bf16, int64_t L) { return v2f_needs_wfma(bf16, L); }

// Dynamic shared memory of the tile kernel that runs at (bf16, L), bytes
// (`which` is unused: the forward has one tile kernel a launch).
int64_t pdg_fused_edge2_fwd_smem(int bf16, int64_t L, int which) {
  (void)which;
  return v2f_smem(bf16, L);
}

// Launches the forward on `stream`. Pointers are device pointers; proj_u,
// proj_v (n_nodes, L), e, z_upd (n_edges, L), the weights and biases are
// fp32 (bf16 == 0) or bf16 (bf16 == 1); slot, rcv and snd (n_real,) list
// the real slots with their receiver and sender (-1 outside the block's
// tile), each receiver's entries consecutive; pad (n_pad,) the padding
// slots; all int32; R (n_nodes, L) and M (8, L) are fp32 and written whole;
// wfma (2, L, L) fp32 scratch where pdg_fused_edge2_fwd_needs_wfma says so
// (else unused); mpart (n_parts, 4, L) fp64 scratch. L is 64, 128 or 256.
// Returns a cudaError_t value (0 on success).
int pdg_fused_edge2_fwd(int bf16, const void* proj_u, const void* proj_v, const void* e,
                        const void* slot, const void* rcv, const void* snd, const void* pad,
                        const void* we, const void* w2, const void* b0, const void* b2,
                        void* z_upd, void* R, void* wfma, void* mpart, void* M,
                        int64_t n_nodes, int64_t n_edges, int64_t n_real, int64_t n_pad,
                        int64_t L, int64_t n_parts, void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_nodes < 1 || n_edges < 1 || n_real < 0 ||
      n_pad < 0 || n_real + n_pad != n_edges || n_parts < 1 ||
      (v2f_needs_wfma(bf16, L) && wfma == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  // the messages read u at the receiver and v at the sender, the edge
  // update the other way round
  const V2FwdArgs a{proj_u, proj_v, proj_v, proj_u, e, i32(rcv), i32(snd), i32(slot), nullptr,
                    we, w2, b0, b2, static_cast<const float*>(wfma), z_upd,
                    static_cast<float*>(R), static_cast<double*>(mpart),
                    static_cast<float*>(M), n_nodes, n_real, 0,
                    (n_real + n_parts - 1) / n_parts};
  auto s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  const int32_t* pd = i32(pad);
  cudaError_t err;
  if (L == 64)
    err = bf16 ? v2_fwd_launch<B, 64, true>(a, pd, n_pad, n_parts, s)
               : v2_fwd_launch<float, 64, true>(a, pd, n_pad, n_parts, s);
  else if (L == 128)
    err = bf16 ? v2_fwd_launch<B, 128, true>(a, pd, n_pad, n_parts, s)
               : v2_fwd_launch<float, 128, true>(a, pd, n_pad, n_parts, s);
  else
    err = bf16 ? v2_fwd_launch<B, 256, true>(a, pd, n_pad, n_parts, s)
               : v2_fwd_launch<float, 256, true>(a, pd, n_pad, n_parts, s);
  return static_cast<int>(err);
}

// Launches the wide variant (wide_tile.cuh) on `stream`: L > 256, a
// multiple of 64; `step` points to a WideStep whose tensors are fp32
// (bf16 == 0) or bf16 (bf16 == 1) streams. Returns a cudaError_t value (0
// on success).
int pdg_fused_edge2_fwd_wide(int bf16, const void* step, void* stream) {
  const auto& s = *static_cast<const WideStep*>(step);
  if (s.L <= 256 || s.L % wide::WN != 0 || s.n < 0 || s.splits < 1 ||
      s.splits > wide::MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? wide::wide_forward<__nv_bfloat16, wide::P2>(s, st)
                               : wide::wide_forward<float, wide::P2>(s, st));
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
