// Fused edge-step forward (fused3) for NVIDIA Hopper (sm_90a): fp32 streams
// on register-tiled FMA chains, bf16 streams on the tensor cores.
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
// What bounds it on this card: 7 L×L products per real slot (x·Wu, x·Wv,
// g·Wu, g·Wv and e·We, shared by both evaluations, then h·W2 twice), of
// which x·Wu and x·Wv are needed once per receiver: 2·(5 + 2/deg)·L² flops
// per slot against ~1.3 KB of streamed bytes per slot in fp32, so the fp32
// FMA rate (67 TFLOP/s) bounds fp32 streams. With bf16 streams the products
// run on the tensor cores (989 TFLOP/s) and the bytes (~0.7 KB a slot at
// 3.35 TB/s) are the bound. The kernel forms x·Wu and x·Wv per slot.
//
// Design (one launch of a tile kernel, after a memset of R, and for the FMA
// kernel a copy of the weights into one fp32 block for the ring). L is 64,
// 128 (every configuration of the repo) or 256.
// - The slots are cut into one part per SM (a persistent grid: one 8-warp
//   CTA fits an SM, so every SM gets one CTA and there is no second wave);
//   both ends of a part move to the next start of a receiver run, so each
//   receiver's run lies in one CTA (the wrapper checks once per layout
//   tensor that each receiver's slots are consecutive, and raises on another
//   order). A CTA walks its part in edge steps; a step made only of padding
//   slots writes zero z_upd rows and skips its products.
// - The FMA kernel (fp32 streams at every width, bf16 at L = 256) keeps the
//   plain version's rounding: each product is one fp32 FMA chain over k in
//   order (as cuBLAS forms it at these shapes), the first layer grouped as
//   ((x·Wa + g·Wb) + e·We) + b0, h rounded to the stream dtype; no TF32.
//   The chains run as #2's (fused_edge3_bwd.cu) register-tiled SIMT product
//   (fused3_tile.cuh): each thread holds a 4 x 4 block of each of the five
//   first-layer chains and reads its operands as float4 broadcasts from
//   transposed fp32 tiles, so a step has fma_rows<L>() = 4096 / L slots (32
//   at L = 128); Wu, Wv, We and then W2 stream through a two-stage cp.async
//   ring, each chunk serving the step's rows, so a weight value is read from
//   L2 once a step; the next step's rows are loaded into registers while
//   the second layer runs. In fp32, z_upd is then bit-equal to the plain
//   version.
// - The tensor-core kernel (bf16 streams at L = 64 and 128) runs all seven
//   products on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
//   accumulation: `_dot_default` as `_mms` applies it), in steps of M = 32
//   slots. The four weights stay resident in shared memory as bf16 (128 KB
//   at L = 128, XOR-swizzled rows for ldmatrix; at L = 256 they would take
//   512 KB, more than an SM has, so bf16 at 256 runs the FMA kernel); the
//   step's x[r], g and e rows arrive by cp.async into one of two buffers
//   while the step before is computed; the first-layer sum is grouped in
//   fp32 on the accumulator fragments, and h = relu(pre) is rounded to bf16
//   in shared memory as the A operand of ·W2, where the JAX package rounds
//   it. The forward's relu gates need not round as the plain version does
//   (relu is continuous), so the kernel is held at the 3e-2 bf16 tolerance,
//   not bit-equality. The products accumulate in the MMAs themselves
//   (mma_chunk's DIRECT): 16 registers fewer than summing each k16 block
//   apart, which took the kernel to 255 registers and spills.
// - R and M (fwd_common.cuh's column walks, shared with the v2 and
//   pair-blocked forwards): the step's z_msg and z_upd (fp32, masked) pass
//   through shared memory; the thread of column c of z_msg sums it, rounded
//   to the stream dtype, over each receiver run in slot order in fp64 and
//   writes the run's sum once (no atomics, no R tile: the plain version's
//   fp64 segment sum);
//   the threads of the z_msg and z_upd columns sum Σz and Σz² (the
//   unrounded fp32 z) in fp64; a one-CTA kernel adds the parts' sums in
//   order and rounds once. Every sum runs in a fixed order: two calls give
//   bit-equal outputs.
// - ptxas (sm_90a, CUDA 12.8) at L = 128: the fp32 FMA kernel 232 registers
//   (a 16-byte stack frame, no spills) and 182,816 bytes of dynamic shared
//   memory; the tensor-core kernel 205 registers (no spills) and 231,968
//   bytes. Each runs one CTA per SM, which the persistent grid is sized
//   for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "fused3_tile.cuh"
#include "fwd_common.cuh"
#include "wide_tile.cuh"

namespace {

constexpr int N_W = 4;  // Wu, Wv, We, W2

struct FwdArgs {
  const void *x, *g, *e;
  const int32_t *rcv, *gid;
  const void* w[N_W];  // Wu, Wv, We, W2 (L, L), stream dtype
  const void *b0, *b2;
  const float* wfma;   // (N_W, L, L) fp32 copy of the weights (the FMA kernel)
  void* z_upd;
  float* R;            // (n_nodes, L), zeroed before the launch
  double* mpart;       // (gridDim.x, 4, L) each part's moment sums
  int64_t n_nodes, n_edges, n_graphs, part;  // part: nominal slots of a CTA
};

// The MS slots of a step, held by warp 0 (lane i holds rows i, i + 32, ...):
// their receivers (-1 outside [0, n_nodes)) and masks. A step's slots are
// read into registers while the step before runs, then published to shared
// memory.
template <int MS>
struct SlotIndex {
  static constexpr int RPL = (MS + 31) / 32;
  int r[RPL];
  float m[RPL];

  __device__ __forceinline__ SlotIndex() {
#pragma unroll
    for (int j = 0; j < RPL; ++j) r[j] = -1, m[j] = 0.f;
  }
  // the rows of the step at base, which has n <= MS rows
  __device__ __forceinline__ void load(const FwdArgs& a, int64_t base, int n) {
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int row = static_cast<int>(threadIdx.x) + 32 * j;
      if (row < n) {
        r[j] = a.rcv[base + row];
        if (r[j] < 0 || r[j] >= a.n_nodes) r[j] = -1;
        m[j] = a.gid[base + row] < a.n_graphs ? 1.f : 0.f;
      }
    }
  }
  // Warp 0: the step's receivers and masks, and whether any slot is real.
  __device__ __forceinline__ void publish(int* rcv_s, float* mask_s, int* live_s) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int row = static_cast<int>(threadIdx.x) + 32 * j;
      if (row < MS) {
        rcv_s[row] = r[j];
        mask_s[row] = m[j];
      }
      any = any || m[j] != 0.f;
    }
    const unsigned live = __ballot_sync(FULL, any);
    if (threadIdx.x == 0) *live_s = live != 0u;
  }
};

// The FMA kernel at width L: MS = fma_rows<L>() slots a step (64, 32, 16 at
// L = 64, 128, 256), so each thread holds one 4 x 4 block of each chain; KF
// rows of Wu, Wv and We a ring chunk (W2: 2·KF).
template <int L> __host__ __device__ constexpr int fma_kf() { return L <= 128 ? 32 : 16; }

// Shared memory of the FMA kernel: three transposed (L, MS) operand tiles,
// the weight ring, the z tiles, indices and biases.
template <int L> constexpr int64_t fma_smem_bytes() {
  constexpr int MS = fma_rows<L>(), KF = fma_kf<L>();
  return (3 * L * MS + 2 * 3 * KF * L + 2 * MS * (L + 4)) * 4 + 16 + 2 * MS * 8 + 16 + 2 * L * 4;
}

// Register-tiled FMA chains over stream dtype T (fp32 at every width, bf16
// at L = 256, where the tensor-core kernel's resident weights do not fit):
// in fp32, bit-equal to the plain version.
template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) step3_fwd_fma_kernel(const FwdArgs a) {
  constexpr int MS = fma_rows<L>(), KF = fma_kf<L>(), ZS = L + 4;
  PartClock timer;
  extern __shared__ float4 smem4[];
  float* at0 = reinterpret_cast<float*>(smem4);  // (L, MS): x[r]ᵀ → h1ᵀ
  float* at1 = at0 + L * MS;                     // gᵀ → h2ᵀ
  float* at2 = at1 + L * MS;                     // eᵀ
  float* ring_s = at2 + L * MS;                  // 2 stages of (3, KF, L)
  float* zm_s = ring_s + 2 * 3 * KF * L;         // (MS, ZS) z_msg
  float* zu_s = zm_s + MS * ZS;                  // (MS, ZS) z_upd
  int64_t* bounds_s = reinterpret_cast<int64_t*>(zu_s + MS * ZS);  // (2,)
  int* rcv_s = reinterpret_cast<int*>(bounds_s + 2);              // (2, MS) by step parity
  float* mask_s = reinterpret_cast<float*>(rcv_s + 2 * MS);       // (2, MS)
  int* live_s = reinterpret_cast<int*>(mask_s + 2 * MS);          // (4,): 2 used
  float* cst_s = reinterpret_cast<float*>(live_s + 4);            // (2, L): b0, b2

  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* e = static_cast<const T*>(a.e);
  T* z_upd = static_cast<T*>(a.z_upd);
  const int tid = static_cast<int>(threadIdx.x);

  if (tid < 32) {
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * a.part;
    part_bounds(a.rcv, s0, s0 + a.part, a.n_edges, bounds_s);
  }
  for (int i = tid; i < L; i += THREADS) {
    cst_s[i] = to_f(static_cast<const T*>(a.b0)[i]);
    cst_s[L + i] = to_f(static_cast<const T*>(a.b2)[i]);
  }
  __syncthreads();
  const int64_t lo = bounds_s[0], hi = bounds_s[1];
  ColumnSums<T, L, MS> cs;
  if (lo < hi) {
    Fp32Ring<L, KF, 1> ring{a.wfma, ring_s, 0};
    ring.issue(0);
    if (tid < 32) {
      SlotIndex<MS> first;
      first.load(a, lo, static_cast<int>(hi - lo < MS ? hi - lo : MS));
      first.publish(rcv_s, mask_s, live_s);
    }
    __syncthreads();
    const int r0 = quad_row<L>(), c0 = quad_col<L>();
    // the rows of the step: loaded during the step before's second layer
    // (have_rows) or at the step's start
    float4 rows[3][rows_per_thread<L>()];
    bool have_rows = false;
    int s = 0;
#pragma unroll 1
    for (int64_t base = lo; base < hi; base += MS, ++s) {
      const int b = s & 1;
      const int n = static_cast<int>(hi - base < MS ? hi - base : MS);
      const int64_t next = base + MS;
      const int nn = next < hi ? static_cast<int>(hi - next < MS ? hi - next : MS) : 0;
      // the next step's indices, in flight while this step's first layer runs
      SlotIndex<MS> nx;
      if (tid < 32) nx.load(a, next, nn);
      const bool live = live_s[b] != 0;
      const float* mask = mask_s + b * MS;
      Quad xu, gv, ep, xv, gu;
      if (live) {
        if (!have_rows) load_rows<T, L>(rows, x, g, e, rcv_s + b * MS, base, n);
        // published by the ring's first barrier
        if constexpr (keep(WITHOUT_STAGE)) store_rows_t<L>(at0, at1, at2, rows);
        // --- the first layer: xu, gv, ep, xv, gu, one FMA chain each
        xu.zero(); gv.zero(); ep.zero(); xv.zero(); gu.zero();
#pragma unroll 1
        for (int k0 = 0; k0 < L; k0 += KF) {
          const float* wc = ring.acquire();
          const float* wu_c = wc;
          const float* wv_c = wc + KF * L;
          const float* we_c = wc + 2 * KF * L;
          fma_chunk<L, KF, 5>({&xu, &gv, &ep, &xv, &gu}, {at0, at1, at2, at0, at1},
                              {wu_c, wv_c, we_c, wv_c, wu_c}, k0);
          ring.release();
        }
      }
      if (tid < 32) nx.publish(rcv_s + (b ^ 1) * MS, mask_s + (b ^ 1) * MS, live_s + (b ^ 1));
      // every warp is done with x[r] and g, whose places h1, h2 take; the
      // next step's indices are in
      __syncthreads();
      have_rows = false;
      if (live) {
        // pre = ((x·Wa + g·Wb) + e·We) + b0, as the plain version adds them;
        // h = relu(pre) rounded to the stream dtype, as the plain version
        // rounds it
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b0c = cst_s[c0 + j];
            const float p1 = ((xu.v[i][j] + gv.v[i][j]) + ep.v[i][j]) + b0c;
            const float p2 = ((xv.v[i][j] + gu.v[i][j]) + ep.v[i][j]) + b0c;
            xu.v[i][j] = round_sd<T>(fmaxf(p1, 0.f));
            gv.v[i][j] = round_sd<T>(fmaxf(p2, 0.f));
          }
        put_quad_t<L>(at0, xu);
        put_quad_t<L>(at1, gv);
        // the next step's rows, in flight while the second layer runs
        if (nn > 0 && live_s[b ^ 1]) {
          load_rows<T, L>(rows, x, g, e, rcv_s + (b ^ 1) * MS, next, nn);
          have_rows = true;
        }
        // --- the second layer: y = h·W2 for both (published by the ring's
        // first barrier)
        Quad am, au;
        am.zero();
        au.zero();
#pragma unroll 1
        for (int k0 = 0; k0 < L; k0 += 2 * KF) {
          const float* wc = ring.acquire();
          fma_chunk<L, 2 * KF, 2>({&am, &au}, {at0, at1}, {wc, wc}, k0);
          ring.release();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = mask[r0 + i];
          float zm[4], zu[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b2c = cst_s[L + c0 + j];
            zm[j] = fmaxf(am.v[i][j] + b2c, 0.f) * m;
            zu[j] = fmaxf(au.v[i][j] + b2c, 0.f) * m;
          }
          *reinterpret_cast<float4*>(zm_s + (r0 + i) * ZS + c0) =
              make_float4(zm[0], zm[1], zm[2], zm[3]);
          *reinterpret_cast<float4*>(zu_s + (r0 + i) * ZS + c0) =
              make_float4(zu[0], zu[1], zu[2], zu[3]);
        }
        __syncthreads();
      }
      cs.step(zm_s, zu_s, rcv_s + b * MS, n, live, base, z_upd, a.R);
      __syncthreads();  // the tiles and this step's indices are restaged
    }
  }
  cs.finish(a.R, a.mpart + static_cast<int64_t>(blockIdx.x) * 4 * L);
  cp_async_wait<0>();
  timer.stop();
}

// Shared memory of the tensor-core kernel: the resident weights, two buffers
// of the step's x[r], g, e tiles, the h tiles (all bf16, swizzled), the fp32
// z tiles, then the indices of two steps and the biases.
template <int L> constexpr int64_t mma_smem_bytes() {
  return (N_W * L * L + 2 * 3 * M * L + 2 * M * L) * 2 + 2 * M * (L + 4) * 4 + 16 + 2 * M * 8 +
         16 + 2 * L * 4;
}

// Issues the cp.async copies of the g and e rows (which = 0) or the x[r]
// rows (which = 1) of the step at `base` (n rows, the rest zero-filled) into
// the swizzled tiles of buffer `buf` (x, g, e), and commits them.
template <int L>
__device__ __forceinline__ void issue_rows(const FwdArgs& a, uint16_t* buf, int64_t base, int n,
                                           const int* rcv_s, int which) {
  constexpr int CH = L / 8;  // 16-byte chunks of a row
  const auto* x = static_cast<const uint16_t*>(a.x);
  const auto* g = static_cast<const uint16_t*>(a.g);
  const auto* e = static_cast<const uint16_t*>(a.e);
  if (which == 0) {
    for (int p = static_cast<int>(threadIdx.x); p < 2 * M * CH; p += THREADS) {
      const int t = p / (M * CH), row = (p / CH) % M, c = (p % CH) * 8;
      const bool ok = row < n;
      const uint16_t* src = (t == 0 ? g : e) + (ok ? (base + row) * L + c : 0);
      if constexpr (keep(WITHOUT_COPY))
        cp_async16_zfill(buf + (1 + t) * M * L + swz<L>(row, c), src, ok);
      else
        (void)src;
    }
  } else {
    for (int p = static_cast<int>(threadIdx.x); p < M * CH; p += THREADS) {
      const int row = p / CH, c = (p % CH) * 8;
      const int r = rcv_s[row];
      const uint16_t* src = x + (r >= 0 ? static_cast<int64_t>(r) * L + c : 0);
      if constexpr (keep(WITHOUT_COPY))
        cp_async16_zfill(buf + swz<L>(row, c), src, r >= 0);
      else
        (void)src;
    }
  }
  cp_async_commit();
}

// Calls fn(row, col, mi, nj, k) for each value of this thread's fragments
// (k indexes Frag::v[mi][nj][·]).
template <int L, typename F>
__device__ __forceinline__ void for_values(F&& fn) {
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < L / 32; ++nj)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        fn((warp % 2) * (M / 2) + mi * 16 + lane / 4 + 8 * (k / 2),
           (warp / 2) * (L / 4) + nj * 8 + 2 * (lane % 4) + k % 2, mi, nj, k);
}

// bf16 streams at L = 64 or 128: all seven products on the tensor cores.
template <int L>
__global__ void __launch_bounds__(THREADS, 1) step3_fwd_mma_kernel(const FwdArgs a) {
  constexpr int ZS = L + 4;
  PartClock timer;
  extern __shared__ float4 smem4[];
  uint16_t* w_s = reinterpret_cast<uint16_t*>(smem4);  // (N_W, L, L) resident weights
  uint16_t* buf_s = w_s + N_W * L * L;                 // 2 × (x, g, e) (M, L) tiles
  uint16_t* h_s = buf_s + 2 * 3 * M * L;               // (2, M, L): h1, h2
  float* zm_s = reinterpret_cast<float*>(h_s + 2 * M * L);  // (M, ZS) z_msg
  float* zu_s = zm_s + M * ZS;                              // (M, ZS) z_upd
  int64_t* bounds_s = reinterpret_cast<int64_t*>(zu_s + M * ZS);  // (2,)
  int* rcv_s = reinterpret_cast<int*>(bounds_s + 2);             // (2, M) by step parity
  float* mask_s = reinterpret_cast<float*>(rcv_s + 2 * M);       // (2, M)
  int* live_s = reinterpret_cast<int*>(mask_s + 2 * M);          // (4,): 2 used
  float* cst_s = reinterpret_cast<float*>(live_s + 4);           // (2, L): b0, b2

  auto* z_upd = static_cast<__nv_bfloat16*>(a.z_upd);
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < 32) {
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * a.part;
    part_bounds(a.rcv, s0, s0 + a.part, a.n_edges, bounds_s);
  }
  for (int i = tid; i < L; i += THREADS) {
    cst_s[i] = to_f(static_cast<const __nv_bfloat16*>(a.b0)[i]);
    cst_s[L + i] = to_f(static_cast<const __nv_bfloat16*>(a.b2)[i]);
  }
  __syncthreads();
  const int64_t lo = bounds_s[0], hi = bounds_s[1];
  ColumnSums<__nv_bfloat16, L, M> cs;
  if (lo < hi) {
#pragma unroll
    for (int w = 0; w < N_W; ++w) {
      const auto* src = static_cast<const uint16_t*>(a.w[w]);
      for (int p = tid; p < L * L / 8; p += THREADS) {
        const int r = p / (L / 8), c = (p % (L / 8)) * 8;
        cp_async16(w_s + w * L * L + swz<L>(r, c), src + r * L + c);
      }
    }
    cp_async_commit();
    // step 0's indices and rows
    if (tid < 32) {
      SlotIndex<M> first;
      first.load(a, lo, static_cast<int>(hi - lo < M ? hi - lo : M));
      first.publish(rcv_s, mask_s, live_s);
    }
    __syncthreads();
    const int n0 = static_cast<int>(hi - lo < M ? hi - lo : M);
    issue_rows<L>(a, buf_s, lo, n0, rcv_s, 0);
    if (live_s[0]) issue_rows<L>(a, buf_s, lo, n0, rcv_s, 1);

    int s = 0;
#pragma unroll 1
    for (int64_t base = lo; base < hi; base += M, ++s) {
      const int b = s & 1;
      const int n = static_cast<int>(hi - base < M ? hi - base : M);
      const int64_t next = base + M;
      const int nn = next < hi ? static_cast<int>(hi - next < M ? hi - next : M) : 0;
      // the next step's indices, in flight while this step's products run
      SlotIndex<M> nx;
      if (tid < 32) nx.load(a, next, nn);
      cp_async_wait<0>();
      __syncthreads();  // this step's rows (and the weights) are in
      uint16_t* cur = buf_s + b * 3 * M * L;
      if (nn > 0) issue_rows<L>(a, buf_s + (b ^ 1) * 3 * M * L, next, nn, nullptr, 0);
      const bool live = live_s[b] != 0;
      const float* mask = mask_s + b * M;
      if (live) {
        // --- the first layer: five products, the sum grouped in fp32
        Frag<L> xu, gu, gv, xv, ep;
        xu.zero(); gu.zero(); gv.zero(); xv.zero(); ep.zero();
        const uint16_t* xt = cur;
        const uint16_t* gt = cur + M * L;
        const uint16_t* et = cur + 2 * M * L;
#pragma unroll 1
        for (int k0 = 0; k0 < L; k0 += KC) {
          mma_chunk<1, L, 2, true>({&xu, &gu}, {xt, gt}, w_s + (F_U * L + k0) * L, L * L, k0);
          mma_chunk<1, L, 2, true>({&gv, &xv}, {gt, xt}, w_s + (F_V * L + k0) * L, L * L, k0);
          mma_chunk<1, L, 1, true>({&ep}, {et}, w_s + (F_E * L + k0) * L, L * L, k0);
        }
        for_values<L>([&](int row, int col, int mi, int nj, int k) {
          const float b0c = cst_s[col];
          const float e = ep.v[mi][nj][k];
          xu.v[mi][nj][k] = fmaxf(((xu.v[mi][nj][k] + gv.v[mi][nj][k]) + e) + b0c, 0.f);
          xv.v[mi][nj][k] = fmaxf(((xv.v[mi][nj][k] + gu.v[mi][nj][k]) + e) + b0c, 0.f);
        });
        for_pairs<L>(xu, [&](int row, int col, float& v0, float& v1) {
          store2(reinterpret_cast<__nv_bfloat16*>(h_s + swz<L>(row, col)), v0, v1);
        });
        for_pairs<L>(xv, [&](int row, int col, float& v0, float& v1) {
          store2(reinterpret_cast<__nv_bfloat16*>(h_s + M * L + swz<L>(row, col)), v0, v1);
        });
      }
      if (tid < 32) nx.publish(rcv_s + (b ^ 1) * M, mask_s + (b ^ 1) * M, live_s + (b ^ 1));
      __syncthreads();  // h1, h2 and the next step's indices are in
      if (nn > 0 && live_s[b ^ 1])
        issue_rows<L>(a, buf_s + (b ^ 1) * 3 * M * L, next, nn, rcv_s + (b ^ 1) * M, 1);
      if (live) {
        // --- the second layer: y = h·W2 for both
        Frag<L> y1, y2;
        y1.zero();
        y2.zero();
#pragma unroll 1
        for (int k0 = 0; k0 < L; k0 += KC)
          mma_chunk<1, L, 2, true>({&y1, &y2}, {h_s, h_s + M * L}, w_s + (F_2 * L + k0) * L,
                                   L * L, k0);
        auto put_z = [&](float* z_s) {
          return [&, z_s](int row, int col, float& v0, float& v1) {
            *reinterpret_cast<float2*>(z_s + row * ZS + col) =
                make_float2(fmaxf(v0 + cst_s[L + col], 0.f) * mask[row],
                            fmaxf(v1 + cst_s[L + col + 1], 0.f) * mask[row]);
          };
        };
        for_pairs<L>(y1, put_z(zm_s));
        for_pairs<L>(y2, put_z(zu_s));
        __syncthreads();
      }
      cs.step(zm_s, zu_s, rcv_s + b * M, n, live, base, z_upd, a.R);
    }
  }
  cs.finish(a.R, a.mpart + static_cast<int64_t>(blockIdx.x) * 4 * L);
  cp_async_wait<0>();
  timer.stop();
}

template <typename T, int L>
cudaError_t launch_fma(const FwdArgs& a, unsigned grid, cudaStream_t s) {
  cudaError_t err = copy_weights<T>(WeightList{{a.w[0], a.w[1], a.w[2], a.w[3]}}, N_W, L,
                                    const_cast<float*>(a.wfma), s);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(fma_smem_bytes<L>());
  err = cudaFuncSetAttribute(step3_fwd_fma_kernel<T, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  step3_fwd_fma_kernel<T, L><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_mma(const FwdArgs& a, unsigned grid, cudaStream_t s) {
  const int smem = static_cast<int>(mma_smem_bytes<L>());
  cudaError_t err = cudaFuncSetAttribute(step3_fwd_mma_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  step3_fwd_mma_kernel<L><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Parts (CTAs) of a launch on the current device: one per SM; 0 on error.
int64_t pdg_fused_edge3_fwd_parts() { return sm_parts(); }

// Whether a launch at width L with bf16 (1) or fp32 (0) streams runs the
// FMA kernel, which reads the fp32 weight copy wfma.
int pdg_fused_edge3_fwd_needs_wfma(int bf16, int64_t L) { return !bf16 || L == 256; }

// Launches the forward on `stream`. Pointers are device pointers; x, g, e,
// the weights, the biases and z_upd are fp32 (bf16 == 0) or bf16 (bf16 ==
// 1); rcv (each receiver's slots consecutive) and gid are int32; R
// (n_nodes, L) and M (8, L) are fp32; wfma (4, L, L) fp32 scratch where
// pdg_fused_edge3_fwd_needs_wfma says so (else unused); mpart (n_parts, 4,
// L) fp64 scratch. L is 64, 128 or 256. Returns a cudaError_t value (0 on
// success).
int pdg_fused_edge3_fwd(int bf16, const void* x, const void* g, const void* e, const void* rcv,
                        const void* gid, const void* wu, const void* wv, const void* we,
                        const void* w2, const void* b0, const void* b2, void* z_upd, void* R,
                        void* wfma, void* mpart, void* M, int64_t n_nodes, int64_t n_edges,
                        int64_t L, int64_t n_graphs, int64_t n_parts, void* stream) {
  if ((L != 64 && L != 128 && L != 256) || n_nodes < 1 || n_edges < 1 || n_parts < 1 ||
      (pdg_fused_edge3_fwd_needs_wfma(bf16, L) && wfma == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{x, g, e, static_cast<const int32_t*>(rcv), static_cast<const int32_t*>(gid),
                  {wu, wv, we, w2}, b0, b2, static_cast<const float*>(wfma), z_upd,
                  static_cast<float*>(R), static_cast<double*>(mpart), n_nodes, n_edges,
                  n_graphs, (n_edges + n_parts - 1) / n_parts};
  cudaError_t err = cudaMemsetAsync(R, 0, static_cast<size_t>(n_nodes * L) * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_parts);
  if (L == 64) err = bf16 ? launch_mma<64>(a, grid, s) : launch_fma<float, 64>(a, grid, s);
  else if (L == 128) err = bf16 ? launch_mma<128>(a, grid, s) : launch_fma<float, 128>(a, grid, s);
  else err = bf16 ? launch_fma<__nv_bfloat16, 256>(a, grid, s) : launch_fma<float, 256>(a, grid, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      moments_reduce(static_cast<double*>(mpart), n_parts, L, static_cast<float*>(M), s));
}

// Launches the wide variant (wide_tile.cuh) on `stream`: L > 256, a
// multiple of 64; `step` points to a WideStep whose tensors are fp32
// (bf16 == 0) or bf16 (bf16 == 1) streams. Returns a cudaError_t value (0
// on success).
int pdg_fused_edge3_fwd_wide(int bf16, const void* step, void* stream) {
  const auto& s = *static_cast<const WideStep*>(step);
  if (s.L <= 256 || s.L % wide::WN != 0 || s.n < 0 || s.splits < 1 ||
      s.splits > wide::MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? wide::wide_forward<__nv_bfloat16, wide::F3>(s, st)
                               : wide::wide_forward<float, wide::F3>(s, st));
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
