// Pair-blocked fused edge-step backward ("fused2") for NVIDIA Hopper
// (sm_90a), on FMA chains that track the plain version's rounding and on
// the tensor cores.
//
// Replaces the Pallas TPU kernel `_step2_bwd_kernel` of
// p_div_gnn_tpu/ops/fused_edge.py (launched from `_step2_bwd`, the VJP of
// `fused_edge_step2`). The forward (fused_edge2_fwd.cu) computes, for every
// slot i of block b of the pair-blocked layout with receiver r and sender s
// (an endpoint outside its block's receiver or sender tile reads 0),
//
//   ep = e[i]·We
//   pre1 = ((u[r] + v[s]) + ep) + b0     h1 = relu(pre1)
//   pre2 = ((v[r] + u[s]) + ep) + b0     h2 = relu(pre2)
//   z_msg = relu(h1·W2 + b2)·mask_i      z_upd = relu(h2·W2 + b2)·mask_i
//
// with R[r] += z_msg and the moment rows M = [Σz_msg, Σz_msg², Σz_upd,
// Σz_upd²]. Given the cotangents dz_upd (Ep, L), dR (Np, L) and dM (8, L)
// this backward recomputes ep, h1, h2 and z_msg (z_upd is the forward's,
// zero on the padding slots) and forms
//
//   dy1 = (dR[r] + dM0 + 2·dM1·z_msg)·(z_msg > 0)    dpre1 = dy1·W2ᵀ·(h1 > 0)
//   dy2 = (dz_upd + dM2 + 2·dM3·z_upd)·(z_upd > 0)   dpre2 = dy2·W2ᵀ·(h2 > 0)
//   dpre1, dpre2, de = (dpre1 + dpre2)·Weᵀ              (Ep, L) stream dtype
//   du_r[r] = Σ dpre1, dv_r[r] = Σ dpre2 (r in tile)    (Np, L) fp32
//   dW2 = Σ h1ᵀdy1 + h2ᵀdy2   dWe = Σ eᵀ(dpre1 + dpre2)
//   db2 = Σ dy1 + dy2         db0 = Σ dpre1 + dpre2
//
// The sender-side adds (d u += S(dpre2), d v += S(dpre1), S the segment sum
// over senders) run outside, in one pair segment sum over the layout's
// sender view (segment_sum_csr.cu), as the TPU kernel leaves them outside.
//
// What bounds it on this card: 8 L×L products per real edge slot, 2·8·L²
// flops per slot: operations bound it in fp32 (the four chains at the fp32
// FMA rate), bytes in bf16. 53 % of the flagship layout's slots are
// padding (664 blocks of 768, 47 % real), whose outputs are zero rows.
//
// Design: the v2 backward's (fused_edge_bwd.cu, v2_bwd_tile.cuh) over a list
// of the real slots. The layout meets a receiver in up to ~4 runs of its
// tile, one per (receiver tile, sender tile) group, so its slot order gives
// no CTA all of a receiver's slots. Of the two ways to keep one writer per
// du_r / dv_r row, parts cut on receiver-tile boundaries (167 tiles of ~1,440
// real slots: 1.3 waves of one CTA per SM on 132 SMs, the second wave a
// quarter full) or parts cut anywhere with fp64 partial rows merged in a
// third pass (a partial row for each receiver a part touches, up to ~4 per
// receiver, written and read again), the wrapper takes neither: it lists
// the real slots stably sorted by receiver (cached per layout), so each
// receiver's slots are one run of the list, in slot order, and the v2
// backward's part split (part_bounds over the list's receivers) applies as
// it is: one CTA writes each row, once, summed in fp64 in slot order, with
// no atomics, no merge pass and no fp64 scratch rows. The list holds real
// slots only, so parts balance by real slots and no edge step is padding;
// the padding slots' zero rows of dpre1, dpre2 and de are written by
// `zero_rows_kernel` as 16-byte stores. The sender rows v[s] and u[s] (and
// the receiver rows) are read at the slot's sender (L2-resident: u and v
// are ~44 MB in fp32) as 16-byte loads of each thread's 4 x 4 block, all
// issued before the e·We chain that hides them and kept raw until their
// use (a timing build without them is at most 0.02 ms faster, so staging
// them by cp.async would gain no more). The weight grads read the scratch
// streams in list order and e at the list's slots, in the weight-grad pass
// of bwd_common.cuh (wgmma) as fused_edge_bwd.cu runs it.
// - Every sum runs in a fixed order: two calls give bit-equal outputs. In
//   fp32, dpre1 and dpre2 are the parent kernel's bit for bit (the same FMA
//   chains); du_r and dv_r sum the same values in the same order, in one
//   fp64 sum per receiver (the parent added per-run fp64 sums).
// - Precision: as fused_edge_bwd.cu; in bf16 mode the gathered dR row is
//   rounded to bf16 too, as `_step2_bwd_kernel`'s `mm` casts both operands,
//   and du_r / dv_r sum the bf16-rounded dpre; db2 and db0 sum the unrounded
//   dy and dpre.
// - The split, as the SASS shows it at L = 128 (scripts/port_sass.py):
//   the tile kernel's four FMA-chain products are 256 FFMA (a 4 x 4 block a
//   thread, unrolled), its one tensor-core product (de) 48 / 8 HMMA with
//   fp32 / bf16 streams (six / one term products per k16 block); the
//   wgmma weight-grad kernel's products 12 / 2 HGMMA (m64n64k16). ptxas at
//   L = 128:
//   the tile kernel 204 / 187 registers, 224,784 / 151,056 bytes of dynamic
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

// CTAs of the tile kernel over n_real listed slots: the rows of bpart.
int64_t pdg_fused_edge2_bwd_parts(int64_t n_real) { return v2_parts(n_real); }

// Dynamic shared memory of the tile kernel (which == 0) or of the
// weight-grad kernel (which == 1) at width L (64, 128, 256), bytes.
int64_t pdg_fused_edge2_bwd_smem(int bf16, int64_t L, int which) {
  return v2_bwd_smem(bf16, L, which);
}

// Weight-grad chunks over n_real listed slots: the rows of wpart.
int64_t pdg_fused_edge2_bwd_chunks(int64_t n_real) { return wgrad_chunks(n_real, 2); }

// Launches the backward on `stream`. Pointers are device pointers. proj_u,
// proj_v, e, z_upd, dz_upd, the weights, their transposes (weT[k][c] =
// we[c][k], w2T likewise), dpre1, dpre2, de and scratch (5, n_real, L) are
// fp32 (bf16 == 0) or bf16 (bf16 == 1); dR (n_nodes, L), dM (8, L), da
// (2, n_nodes, L: du_r, dv_r, zeroed by the caller) and wb (2L+2, L) are
// fp32; slot, rcv and snd (n_real,) list the real slots with their
// receiver and sender (-1 outside the block's tile), each receiver's
// entries consecutive; pad (n_pad,) the padding slots; all int32; wfma
// (3, L, L) fp32 and wsplit (1, 3 or 1, L, L) bf16 scratch; bpart
// (pdg_fused_edge2_bwd_parts(n_real), 2, L) and wpart (n_chunks =
// pdg_fused_edge2_bwd_chunks(n_real), 2, L, L) fp64 scratch. L is 64, 128
// or 256. Returns a cudaError_t value (0 on success).
int pdg_fused_edge2_bwd(int bf16, const void* proj_u, const void* proj_v, const void* e,
                        const void* z_upd, const void* dz_upd, const void* dR, const void* dM,
                        const void* slot, const void* rcv, const void* snd, const void* pad,
                        const void* we, const void* w2, const void* w2T, const void* weT,
                        const void* b0, const void* b2, void* dpre1, void* dpre2, void* de,
                        void* da, void* scratch, void* wfma, void* wsplit, void* bpart,
                        void* wpart, void* wb, int64_t n_nodes, int64_t n_edges, int64_t n_real,
                        int64_t n_pad, int64_t L, int64_t n_chunks, void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_nodes < 1 || n_edges < 1 || n_real < 0 ||
      n_pad < 0 || n_real + n_pad != n_edges || n_chunks < 1 ||
      (n_real + n_chunks - 1) / n_chunks > MAX_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  // the messages read u at the receiver and v at the sender, the edge
  // update the other way round
  V2TileArgs ta{proj_u, proj_v, proj_v, proj_u, e, z_upd, dz_upd,
                static_cast<const float*>(dR), static_cast<const float*>(dM), i32(rcv),
                i32(snd), i32(slot), nullptr, b0, b2, static_cast<const float*>(wfma),
                static_cast<const uint16_t*>(wsplit), dpre1, dpre2, de,
                static_cast<float*>(da), scratch, static_cast<double*>(bpart), n_nodes,
                n_real, 0};
  const Weights ws{{we, w2, w2T, weT}};
  auto* wf = static_cast<float*>(wfma);
  auto* sp = static_cast<uint16_t*>(wsplit);
  auto* wp = static_cast<double*>(wpart);
  auto* o = static_cast<float*>(wb);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? v2_bwd_launch_width<__nv_bfloat16, 1, true>(ta, ws, wf, sp, i32(pad), n_pad,
                                                         i32(slot), n_edges, wp, n_chunks, o, L,
                                                         s)
           : v2_bwd_launch_width<float, 3, true>(ta, ws, wf, sp, i32(pad), n_pad, i32(slot),
                                                 n_edges, wp, n_chunks, o, L, s);
  return static_cast<int>(err);
}

// Launches the wide variant (wide_tile.cuh) on `stream`: L > 256, a
// multiple of 64; `step` points to a WideStep whose tensors are fp32
// (bf16 == 0) or bf16 (bf16 == 1) streams. Returns a cudaError_t value (0
// on success).
int pdg_fused_edge2_bwd_wide(int bf16, const void* step, void* stream) {
  const auto& s = *static_cast<const WideStep*>(step);
  if (s.L <= 256 || s.L % wide::WN != 0 || s.n < 0 || s.splits < 1 ||
      s.splits > wide::MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? wide::wide_backward<__nv_bfloat16, wide::P2>(s, st)
                               : wide::wide_backward<float, wide::P2>(s, st));
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
