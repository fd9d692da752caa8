// MeshGraphNets' edge update forward for NVIDIA Hopper (sm_90a): one
// block's edge MLP over the live edge slots in one launch, its three fp32
// products on the tensor cores as bf16x6 split products.
//
// Replaces no TPU kernel: MeshGraphNets (models/meshgraphnets.py) has no
// counterpart in the JAX package. It replaces the ~17 ATen launches of
// GraphNetBlock.edge_update, each of which wrote an (n, 128) fp32 tensor
// that the next one read back. For every slot r < n:
//
//   pre = P_s[snd[r]] + P_r[rcv[r]] + e[r]·W_e + b0    (P_s = x·W_s, P_r = x·W_r)
//   a0  = relu(pre);  a1 = relu(a0·W1 + b1);  y = a1·W2 + b2
//   e'  = LN(y; gamma, beta, eps 1e-5) · mask[r];  e_sum = e[r] + e'
//
// and it writes e' and e_sum, and, for the backward (ops/mgn_edge.py),
// a0, a1, y and y's row mean and rstd: what autograd saved of the plain
// composition. L is 128, MeshGraphNets' width.
//
// What bounds it on this card: 6 rows of 512 bytes a slot to and from HBM
// (e read; a0, a1, y, e', e_sum written; ~0.79 GB a block at the cell's
// ~256 k slots: 0.24 ms at 3.35 TB/s) plus the two gathered rows, which L2
// holds, against the three L×L products, 3·2·L² flops a slot (25.1 GFLOP a
// block: 0.38 ms at 67 TFLOP/s of fp32 FMA). A first design on register-
// tiled FMA chains, the weights resident in shared memory, ran at a third
// of that FMA rate (1.2 ms a block without its stores): each FMA needed 1.5
// bytes from shared memory, more than an SM delivers. So the products run
// on the tensor cores, six bf16 products each (0.15 ms a block at 989
// TFLOP/s), and the bytes bound: ~0.25 ms a block.
//
// Design: a persistent grid, two 8-warp CTAs per SM (so one CTA's
// epilogue, barriers and stores overlap the other's products), each
// walking tiles of TR = 64 slots (tile, tile + grid, ...).
// - Precision: each fp32 operand is split into three bf16 terms (b1 =
//   bf16(v), b2 = bf16(v - b1), b3 = bf16(v - b1 - b2)) and a product sums
//   the six cross products of terms i + j < 3 as fused3_tile.cuh's
//   mma_chunk does (per k16 block, the smallest first, summed by the tensor
//   cores from 0 and then added to the fp32 accumulator): fp32's accuracy,
//   not bit-equal to cuBLAS's FMA chains. No TF32 (its control fails the
//   benchmark's comparison) and no bf16 rounding of any stored value.
// - Weights: a small kernel splits W_e, W1 and W2 into their terms once a
//   launch (288 KB, which L2 holds); the tile kernel streams them through
//   a two-stage cp.async ring in chunks of KC = 32 rows, W_e, W1, W2 for
//   each tile in turn, one barrier a chunk (96 KB of L2 reads a tile and
//   layer: a run without the ring's copies took 3 % less time).
// - The tile's activations live in shared memory as three swizzled bf16
//   terms (48 KB), the A operand of mma.sync m16n8k16 by ldmatrix: e
//   first, then a0, then a1. Each warp holds a 32 × 32 block of the
//   tile's outputs (Frag<128, 64>) and loads its B fragments of a k16
//   block once for both of its m16 tiles. The layers chain on chip: a
//   layer's fp32 accumulators take the bias and ReLU, go to HBM where the
//   backward needs them, and are split into the next layer's operand;
//   pre, h1 and the gathered rows never reach HBM. The first layer's
//   accumulators start from P_s[snd] + P_r[rcv], so the gathers are in
//   flight while its products start: ((P_s + P_r) + e·W_e) + b0, the
//   plain version's grouping with e·W_e added a k16 block at a time.
// - LayerNorm's row statistics: each thread sums its 8 columns of a row,
//   the 4 threads of the row in a warp add by shuffles and the row's 4
//   column warps through shared memory; the mean first, then the mean
//   square deviation (two passes), rstd = 1 / sqrt(var + eps).
// - Rows at or past n (the last tile's) read zeros and write nothing.
//   Padding slots (mask 0) are computed and written as zero e' rows, as
//   the plain version's product with the mask leaves them.
// - ptxas (sm_90a, CUDA 12.8): 128 registers (two CTAs an SM), 108 bytes of
//   spill stores; 103,168 bytes of dynamic shared memory.
// Every sum runs in a fixed order: two calls give bit-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "fused3_tile.cuh"

namespace {

constexpr int WIDTH = 128;  // MeshGraphNets' latent width
constexpr int TR = 64;      // slots a tile
constexpr int CTAS = 2;     // CTAs an SM holds: one's epilogue overlaps the other's products
constexpr int NTERMS = 3;   // bf16 terms of an fp32 value
constexpr int NWEIGHTS = 3;  // W_e, W1, W2, streamed in turn
constexpr int NVEC = 5;     // b0, b1, b2, gamma, beta
constexpr float LN_EPS = 1e-5f;
using Acc = Frag<WIDTH, TR>;
constexpr int OP_ELEMS = NTERMS * TR * WIDTH;       // bf16 terms of the tile's activations
constexpr int STAGE_ELEMS = NTERMS * KC * WIDTH;    // a chunk: KC weight rows, their terms
constexpr int RING_ELEMS = 2 * STAGE_ELEMS;
constexpr int SMEM_BYTES =
    (OP_ELEMS + RING_ELEMS) * 2 + (NVEC * WIDTH + TR * 8 + TR) * 4;

// The weights' terms stream through shared memory in chunks of KC rows:
// chunk q is rows (q % 4)·KC.. of weight (q / 4) % 3 (W_e, W1, W2 for each
// tile in turn), all terms, swizzled by row, in stage q % 2 by cp.async.
// acquire() waits for chunk q, then starts chunk q + 1 in the stage chunk
// q - 1 left: one barrier a chunk, which also publishes whatever the
// threads wrote before it. This is bwd_common.cuh's SplitRing<NTERMS,
// WIDTH, NWEIGHTS> but for the stage, q % 2 here and q & 1 there: the same
// values, but with q & 1 ptxas spills this kernel otherwise at its
// 128-register cap and it takes 6 % longer (0.85 against 0.80 ms a launch,
// outputs bit-equal; PERF.md §6, PR 25).
struct WeightRing {
  const uint16_t* wsplit;  // (NWEIGHTS, NTERMS, L, L) bf16 terms
  uint16_t* ring;          // 2 stages of (NTERMS, KC, L)
  int q;

  __device__ __forceinline__ void issue(int qq) {
    constexpr int CHUNKS = WIDTH / KC, ROW8 = WIDTH / 8, PER_TERM = KC * ROW8;
    const int w = (qq / CHUNKS) % NWEIGHTS, kc = qq % CHUNKS;
    uint16_t* dst = ring + (qq % 2) * STAGE_ELEMS;
    for (int p = static_cast<int>(threadIdx.x); p < NTERMS * PER_TERM; p += THREADS) {
      const int t = p / PER_TERM, r = (p % PER_TERM) / ROW8, c = (p % ROW8) * 8;
      cp_async16(dst + t * KC * WIDTH + swz<WIDTH>(r, c),
                 wsplit + (static_cast<int64_t>(w * NTERMS + t) * WIDTH + kc * KC + r) * WIDTH + c);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ const uint16_t* acquire() {
    cp_async_wait<0>();
    __syncthreads();
    issue(q + 1);
    return ring + (q % 2) * STAGE_ELEMS;
  }
  __device__ __forceinline__ void release() { ++q; }
};

struct EdgeArgs {
  const float* ps;          // (n_nodes, L) x·W_s
  const float* pr;          // (n_nodes, L) x·W_r
  const float* e;           // (n, L)
  const int32_t* snd;       // (n,)
  const int32_t* rcv;       // (n,)
  const float* mask;        // (n,) 1 on real edges, 0 on padding
  const uint16_t* wsplit;   // (3, NTERMS, L, L) the weights' terms
  const float* b[3];        // b0, b1, b2: (L,)
  const float* gamma;       // (L,)
  const float* beta;        // (L,)
  float* e_new;             // (n, L)
  float* e_sum;             // (n, L)
  float* a0;                // (n, L) or null, as a1, y, mean and rstd
  float* a1;
  float* y;
  float* mean;  // (n,)
  float* rstd;  // (n,)
  int64_t n;
};

// wsplit[w][t] = term t of weight w (W_e, W1, W2), row-major bf16 bits.
__global__ void mgn_split_weights_kernel(const float* __restrict__ w_e,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ w2,
                                         uint16_t* __restrict__ wsplit) {
  constexpr int LL = WIDTH * WIDTH;
  const int idx = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (idx >= NWEIGHTS * LL) return;
  const int w = idx / LL, i = idx % LL;
  const float* src = w == 0 ? w_e : w == 1 ? w1 : w2;
  uint32_t t[NTERMS];
  split<NTERMS>(src[i], t);
#pragma unroll
  for (int k = 0; k < NTERMS; ++k) wsplit[(w * NTERMS + k) * LL + i] = static_cast<uint16_t>(t[k]);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2f(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Writes the terms of (a, b) at (row, col) and (row, col + 1) of the
// swizzled operand tile.
__device__ __forceinline__ void put2(uint16_t* op, int row, int col, float a, float b) {
  uint32_t t[NTERMS];
  split2<NTERMS>(a, b, t);
  const int o = swz<WIDTH>(row, col);
#pragma unroll
  for (int k = 0; k < NTERMS; ++k) *reinterpret_cast<uint32_t*>(op + k * TR * WIDTH + o) = t[k];
}

// acc += op · (the ring's next weight), over its chunks of KC rows:
// the cross products of the terms i + j < NTERMS of each k16 block, the
// smallest first, summed by the tensor cores from 0 and added to acc in
// fp32 (as fused3_tile.cuh's mma_chunk sums them). A warp loads its B
// fragments of a k16 block once for all of its MI m16 tiles.
__device__ __forceinline__ void product(WeightRing& ring, const uint16_t* op, Acc& acc) {
  constexpr int MI = Acc::MI, NTL = Acc::NTL;
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const int wm = warp % Acc::WR, wn = warp / Acc::WR;
#pragma unroll 1
  for (int k0 = 0; k0 < WIDTH; k0 += KC) {
    const uint16_t* wc = ring.acquire();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t b[NTERMS][NTL][2];
#pragma unroll
      for (int t = 0; t < NTERMS; ++t)
#pragma unroll
        for (int j = 0; j < NTL; j += 2) {
          const int q = lane / 8;
          uint32_t r[4];
          ldsm_x4_trans(r, wc + t * KC * WIDTH +
                               swz<WIDTH>(kk + lane % 8 + (q & 1) * 8,
                                          wn * (WIDTH / Acc::WC) + j * 8 + (q >> 1) * 8));
          b[t][j][0] = r[0];
          b[t][j][1] = r[1];
          b[t][j + 1][0] = r[2];
          b[t][j + 1][1] = r[3];
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[NTERMS][4];
#pragma unroll
        for (int t = 0; t < NTERMS; ++t)
          ldsm_x4(af[t], op + t * TR * WIDTH +
                             swz<WIDTH>(wm * (TR / Acc::WR) + mi * 16 + lane % 16,
                                        k0 + kk + (lane / 16) * 8));
        float t16[NTL][4];
#pragma unroll
        for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
          for (int k = 0; k < 4; ++k) t16[nj][k] = 0.f;
#pragma unroll
        for (int tb = NTERMS - 1; tb >= 0; --tb)
#pragma unroll
          for (int ta = NTERMS - 1 - tb; ta >= 0; --ta)
#pragma unroll
            for (int nj = 0; nj < NTL; ++nj)
              if constexpr (keep(WITHOUT_MMA))
                mma_bf16_16816(t16[nj], af[ta], b[tb][nj][0], b[tb][nj][1]);
#pragma unroll
        for (int nj = 0; nj < NTL; ++nj)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc.v[mi][nj][k] += t16[nj][k];
      }
    }
    ring.release();
  }
}

// The sum over the row's 128 columns of each of this thread's rows (v[mi][h]
// holds its own 8 columns' part): the row's 4 threads in the warp by
// shuffles, its 4 column warps through `red` (TR × 4 floats, free at the
// call).
__device__ __forceinline__ void row_sums(float (&v)[Acc::MI][2], float* red) {
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const int wn = warp / Acc::WR, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = v[mi][h];
      t += __shfl_xor_sync(FULL, t, 1);
      t += __shfl_xor_sync(FULL, t, 2);
      const int row = (warp % Acc::WR) * (TR / Acc::WR) + mi * 16 + g + 8 * h;
      if (tq == 0) red[row * 4 + wn] = t;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (warp % Acc::WR) * (TR / Acc::WR) + mi * 16 + g + 8 * h;
      const float* p = red + row * 4;
      v[mi][h] = ((p[0] + p[1]) + p[2]) + p[3];
    }
}

// The tile's fragment values of one layer's output after `fn` (bias and
// activation): to HBM where `out` is not null, and split into the next
// layer's operand.
template <typename Fn>
__device__ __forceinline__ void keep(Acc& acc, uint16_t* op, float* out, int64_t r0, int64_t n,
                                     int row0, int col0, Fn&& fn) {
#pragma unroll
  for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mi + 8 * h;
      const int64_t r = r0 + row;
#pragma unroll
      for (int nj = 0; nj < Acc::NTL; ++nj) {
        const int col = col0 + 8 * nj;
        float* v = &acc.v[mi][nj][2 * h];
        fn(col, v);
        if (out != nullptr && r < n) store2f(out + r * WIDTH + col, v[0], v[1]);
        put2(op, row, col, v[0], v[1]);
      }
    }
}

__global__ void __launch_bounds__(THREADS, CTAS) mgn_edge_fwd_kernel(const EdgeArgs a) {
  extern __shared__ float4 smem_f4[];
  uint16_t* op = reinterpret_cast<uint16_t*>(smem_f4);
  float* vec_s = reinterpret_cast<float*>(op + OP_ELEMS + RING_ELEMS);  // (NVEC, L)
  float* red = vec_s + NVEC * WIDTH;                                     // 2 × (TR, 4)
  float* mask_s = red + TR * 8;                                          // (TR,) 0 past n
  WeightRing ring{a.wsplit, op + OP_ELEMS, 0};
  ring.issue(0);
  for (int i = static_cast<int>(threadIdx.x); i < NVEC * WIDTH; i += THREADS) {
    const float* src = i < 3 * WIDTH ? a.b[i / WIDTH] : i < 4 * WIDTH ? a.gamma : a.beta;
    vec_s[i] = src[i % WIDTH];
  }
  const float* b0_s = vec_s;
  const float* b1_s = vec_s + WIDTH;
  const float* b2_s = vec_s + 2 * WIDTH;
  const float* gamma_s = vec_s + 3 * WIDTH;
  const float* beta_s = vec_s + 4 * WIDTH;
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const int g = lane / 4, tq = lane % 4;
  const int row0 = (warp % Acc::WR) * (TR / Acc::WR) + g;  // rows row0 + 16 mi + 8 h
  const int col0 = (warp / Acc::WR) * (WIDTH / Acc::WC) + 2 * tq;  // columns col0 + 8 nj, + 1
  const int64_t n_tiles = (a.n + TR - 1) / TR;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TR;
    __syncthreads();  // the tile before has read op, red and mask_s
    for (int p = static_cast<int>(threadIdx.x); p < TR * WIDTH / 4; p += THREADS) {
      const int row = p / (WIDTH / 4), col = (p % (WIDTH / 4)) * 4;
      const int64_t r = r0 + row;
      const float4 v = r < a.n ? *reinterpret_cast<const float4*>(a.e + r * WIDTH + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      put4<NTERMS, WIDTH>(op, TR * WIDTH, row, col, v);
    }
    for (int row = static_cast<int>(threadIdx.x); row < TR; row += THREADS) {
      const int64_t r = r0 + row;
      mask_s[row] = r < a.n ? a.mask[r] : 0.f;
    }
    // the first layer's accumulators start from P_s[snd] + P_r[rcv]: the
    // gathers are in flight while the product starts
    Acc acc;
#pragma unroll
    for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = r0 + row0 + 16 * mi + 8 * h;
        const bool live = r < a.n;
        const int64_t s = live ? a.snd[r] : 0, q = live ? a.rcv[r] : 0;
#pragma unroll
        for (int nj = 0; nj < Acc::NTL; ++nj) {
          const int col = col0 + 8 * nj;
          float2 u = make_float2(0.f, 0.f), w = u;
          if (live) {
            u = load2(a.ps + s * WIDTH + col);
            w = load2(a.pr + q * WIDTH + col);
          }
          acc.v[mi][nj][2 * h] = u.x + w.x;
          acc.v[mi][nj][2 * h + 1] = u.y + w.y;
        }
      }
    product(ring, op, acc);  // + e·W_e (the ring's first barrier publishes op)
    __syncthreads();         // every warp has read op
    keep(acc, op, a.a0, r0, a.n, row0, col0, [&](int col, float* v) {
      v[0] = relu(v[0] + b0_s[col]);
      v[1] = relu(v[1] + b0_s[col + 1]);
    });
    acc.zero();
    product(ring, op, acc);  // a0·W1
    __syncthreads();
    keep(acc, op, a.a1, r0, a.n, row0, col0, [&](int col, float* v) {
      v[0] = relu(v[0] + b1_s[col]);
      v[1] = relu(v[1] + b1_s[col + 1]);
    });
    acc.zero();
    product(ring, op, acc);  // a1·W2
    float mu[Acc::MI][2], rs[Acc::MI][2];
#pragma unroll
    for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = r0 + row0 + 16 * mi + 8 * h;
        mu[mi][h] = 0.f;
#pragma unroll
        for (int nj = 0; nj < Acc::NTL; ++nj) {
          const int col = col0 + 8 * nj;
          float* v = &acc.v[mi][nj][2 * h];
          v[0] += b2_s[col];
          v[1] += b2_s[col + 1];
          if (a.y != nullptr && r < a.n) store2f(a.y + r * WIDTH + col, v[0], v[1]);
          mu[mi][h] += v[0] + v[1];
        }
      }
    row_sums(mu, red);
#pragma unroll
    for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mu[mi][h] *= 1.f / WIDTH;
        rs[mi][h] = 0.f;
#pragma unroll
        for (int nj = 0; nj < Acc::NTL; ++nj) {
          const float d0 = acc.v[mi][nj][2 * h] - mu[mi][h];
          const float d1 = acc.v[mi][nj][2 * h + 1] - mu[mi][h];
          rs[mi][h] += d0 * d0 + d1 * d1;
        }
      }
    row_sums(rs, red + TR * 4);
#pragma unroll
    for (int mi = 0; mi < Acc::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * mi + 8 * h;
        const int64_t r = r0 + row;
        rs[mi][h] = 1.f / sqrtf(rs[mi][h] * (1.f / WIDTH) + LN_EPS);
        if (r >= a.n) continue;
        const float m = mask_s[row];
#pragma unroll
        for (int nj = 0; nj < Acc::NTL; ++nj) {
          const int col = col0 + 8 * nj;
          const float* v = &acc.v[mi][nj][2 * h];
          const float o0 = fmaf((v[0] - mu[mi][h]) * rs[mi][h], gamma_s[col], beta_s[col]) * m;
          const float o1 =
              fmaf((v[1] - mu[mi][h]) * rs[mi][h], gamma_s[col + 1], beta_s[col + 1]) * m;
          store2f(a.e_new + r * WIDTH + col, o0, o1);
          const float2 ev = load2(a.e + r * WIDTH + col);
          store2f(a.e_sum + r * WIDTH + col, ev.x + o0, ev.y + o1);
        }
        if (a.mean != nullptr && col0 == 0) {
          a.mean[r] = mu[mi][h];
          a.rstd[r] = rs[mi][h];
        }
      }
  }
  cp_async_wait<0>();  // the ring's last chunks, issued for a tile that never came
}

int64_t sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

}  // namespace

extern "C" {

// Parts (CTAs) of a launch on the current device: one per SM; 0 on error.
int64_t pdg_mgn_edge_fwd_parts() { return sm_count(); }

// Launches the forward on `stream`. Pointers are device pointers, every
// float one fp32 and 16-byte aligned: ps, pr (n_nodes, L); e, e_new, e_sum
// (n, L); snd, rcv (n,) int32 node rows; mask (n,) fp32; w_e, w1, w2
// (L, L) as (in, out); b0, b1, b2, gamma, beta (L,); wsplit (3, 3, L, L)
// bf16 scratch. a0, a1, y (n, L) and mean, rstd (n,) are the backward's and
// all null where it needs none. L is 128. Returns a cudaError_t value (0 on
// success).
int pdg_mgn_edge_fwd(const void* ps, const void* pr, const void* e, const void* snd,
                     const void* rcv, const void* mask, const void* w_e, const void* b0,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gamma, const void* beta, void* e_new, void* e_sum, void* a0,
                     void* a1, void* y, void* mean, void* rstd, void* wsplit, int64_t n,
                     int64_t width, int64_t n_parts, void* stream) {
  const bool saves = a0 != nullptr;
  if (width != WIDTH || n < 1 || n_parts < 1 || wsplit == nullptr ||
      saves != (a1 != nullptr) || saves != (y != nullptr) || saves != (mean != nullptr) ||
      saves != (rstd != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  constexpr int SPLIT_THREADS = 256;
  mgn_split_weights_kernel<<<NWEIGHTS * WIDTH * WIDTH / SPLIT_THREADS, SPLIT_THREADS, 0, s>>>(
      static_cast<const float*>(w_e), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<uint16_t*>(wsplit));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const EdgeArgs args{static_cast<const float*>(ps), static_cast<const float*>(pr),
                      static_cast<const float*>(e), static_cast<const int32_t*>(snd),
                      static_cast<const int32_t*>(rcv), static_cast<const float*>(mask),
                      static_cast<const uint16_t*>(wsplit),
                      {static_cast<const float*>(b0), static_cast<const float*>(b1),
                       static_cast<const float*>(b2)},
                      static_cast<const float*>(gamma), static_cast<const float*>(beta),
                      static_cast<float*>(e_new), static_cast<float*>(e_sum),
                      static_cast<float*>(a0), static_cast<float*>(a1), static_cast<float*>(y),
                      static_cast<float*>(mean), static_cast<float*>(rstd), n};
  err = cudaFuncSetAttribute(mgn_edge_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (n + TR - 1) / TR, ctas = CTAS * n_parts;
  const unsigned grid = static_cast<unsigned>(n_tiles < ctas ? n_tiles : ctas);
  mgn_edge_fwd_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

const char* pdg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
