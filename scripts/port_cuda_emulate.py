"""Run the port's CUDA kernels on the CPU, without a card or nvcc.

    PYTHONPATH=. python scripts/port_cuda_emulate.py [--tiles 2] [--L 16]

Each ``p_div_gnn_tpu_torch/csrc/*.cu`` is compiled by the host C++ compiler
(g++, C++20) against a small emulation of the CUDA runtime: a CTA's threads
are host threads, ``__syncthreads`` is a barrier, dynamic shared memory is
a per-CTA buffer filled with garbage, launches run one CTA at a time. The
warp-level primitives exchange values among a warp's 32 threads between
two barriers of the warp: ``__shfl_sync``, ``__shfl_xor_sync``,
``__ballot_sync``, and ``csrc/mma_sm90.cuh``'s ``ldmatrix`` (x4, plain
and transposed) and ``mma.sync`` m16n8k16 (bf16, fp32 accumulation) with
the PTX ISA's fragment layouts; ``cp.async`` is a plain copy; an mbarrier
is a phase counter whose waits spin; ``wgmma`` m64n64k16 reads its
operands through their shared-memory descriptors (MN-major, 128-byte
swizzle), each thread summing its own accumulator fragment. The port's
own ctypes wrappers (``ops/fused_edge3.py``, ``ops/fused_edge.py`` with the
v2 and the pair-blocked fused2 steps, ``ops/scatter_csr.py``) then run on
CPU tensors against the emulated libraries (``ops/cuda_build.py::using``),
and each kernel is held against its plain version at small shapes, in both stream dtypes: the fused3
forward at each width it is built for, 64, 128 and 256, on a layout with a
tile of only padding, twice, the two calls bit-equal; the fused3 backward
at L = 64 and 256; the v2 (#6) and pair-blocked (#8) backwards at L = 64
and 128 on layouts with a tile of only padding (#6: a receiver run across a
part's nominal end; #8: receivers met in several runs of their tile, stray
endpoints), twice, bit-equal, their fp32 FMA-chain outputs (dg_v, dg_u;
dpre1, dpre2) equal to the plain version's; the v2 (#5) and pair-blocked
(#7) forwards at 64, 128 and 256 on the same layouts, twice, bit-equal,
their fp32 z_upd equal to the plain version's; the segment sum on both
callers' layouts, twice, bit-equal; then each fused kernel once (fp32) at a
width it is not built for, through the wrappers' zero padding; and
MeshGraphNets' edge update forward (``mgn_edge_fwd``, L = 128) on a layout
with a tile of only padding, over every slot and over a count that ends
inside a tile, twice, bit-equal (``--only mgn`` runs it alone).
Tolerances are ``chip_smoke.py``'s; the script exits 1 if one disagrees.
The emulated card has 5 SMs (the forwards' persistent grids).

It checks what a kernel computes (indexing, synchronization, the order of
its sums, the wrapper's argument list), not its speed, and not whether
nvcc accepts it: g++ takes what nvcc may refuse, and runs with
``-ffp-contract=off``, where nvcc contracts ``a*b + c`` into FMAs. The
libraries go to ``build/port_cuda_emulate/``.
"""

from __future__ import annotations

import argparse
import contextlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from p_div_gnn_tpu_torch.graphs.batching import build_sender_view  # noqa: E402
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE  # noqa: E402
from p_div_gnn_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    fused_edge,
    fused_edge3,
    mgn_edge,
    scatter_csr,
)
from test_torch_port_cuda import (  # noqa: E402
    _edge_problem,
    _longest_run,
    _mgn_edge_problem,
    _pair_problem,
    _segment_problem,
    _v2_problem,
)

OUT = ROOT / "build" / "port_cuda_emulate"

CUDA_RUNTIME_H = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <math.h>
#include <algorithm>
#include <barrier>
#include <cmath>
#include <deque>
#include <map>
#include <mutex>
#include <strings.h>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __noinline__
#define __grid_constant__
// CTAs run one at a time, so a function-scope static is one CTA's
// shared memory
#define __shared__ static
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct double2 { double x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local float4* emu_smem = nullptr;
inline thread_local std::barrier<>* emu_bar = nullptr;
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
// A warp's lanes exchange values through `words` between two barriers of
// the warp's 32 threads: each warp-collective call is made by all lanes.
struct EmuWarp {
  std::barrier<>* bar;
  uint64_t words[32][8];
  const void* ptrs[32];
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local unsigned emu_lane = 0;
inline uint64_t emu_exchange(uint64_t mine, unsigned src) {
  emu_warp->words[emu_lane][0] = mine;
  emu_warp->bar->arrive_and_wait();
  const uint64_t got = emu_warp->words[src % 32][0];
  emu_warp->bar->arrive_and_wait();
  return got;
}
inline int __shfl_sync(unsigned, int v, int src) {
  return static_cast<int>(emu_exchange(static_cast<uint32_t>(v), static_cast<unsigned>(src)));
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  emu_warp->words[emu_lane][0] = pred ? 1 : 0;
  emu_warp->bar->arrive_and_wait();
  unsigned m = 0;
  for (unsigned l = 0; l < 32; ++l) m |= static_cast<unsigned>(emu_warp->words[l][0]) << l;
  emu_warp->bar->arrive_and_wait();
  return m;
}
inline int __ffs(int x) { return ::ffs(x); }
inline double __shfl_xor_sync(unsigned, double v, int mask) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  u = emu_exchange(u, emu_lane ^ static_cast<unsigned>(mask));
  double d;
  std::memcpy(&d, &u, 8);
  return d;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
// the emulated card's SMs: a persistent grid gets a few CTAs at small shapes
constexpr int EMU_SMS = 5;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? EMU_SMS : 0;
  return 0;
}
#define EMU_STREAM reinterpret_cast<cudaStream_t>(0x5eed0000beefULL)
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t st) {
  if (st != EMU_STREAM) throw "memset on a stream the wrapper did not pass";
  std::memset(p, v, n);
  return 0;
}
template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->bar->arrive_and_wait(); }
struct EmuCfg { dim3 grid, block; size_t smem; };
// the wrappers pass EMU_STREAM; another value is an argument list that
// ctypes cut (a pointer passed as a 32-bit int)
inline EmuCfg emu_cfg(dim3 g, dim3 b, size_t s = 0, cudaStream_t st = EMU_STREAM) {
  if (st != EMU_STREAM) throw "launch on a stream the wrapper did not pass";
  return {g, b, s};
}
template <typename K, typename... A>
void emu_launch(EmuCfg cfg, K kernel, A... args) {
  const unsigned nt = cfg.block.x * cfg.block.y * cfg.block.z;
  std::vector<float4> smem(cfg.smem / sizeof(float4) + 1);
  for (unsigned bz = 0; bz < cfg.grid.z; ++bz)
    for (unsigned by = 0; by < cfg.grid.y; ++by)
      for (unsigned bx = 0; bx < cfg.grid.x; ++bx) {
        std::memset(smem.data(), 0xff, smem.size() * sizeof(float4));
        std::barrier<> bar(nt);
        const unsigned nw = (nt + 31) / 32;
        std::deque<std::barrier<>> warp_bars;
        std::vector<EmuWarp> warps(nw);
        for (unsigned w = 0; w < nw; ++w) {
          warp_bars.emplace_back(std::min<unsigned>(32, nt - 32 * w));
          warps[w].bar = &warp_bars[w];
        }
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            emu_warp = &warps[t / 32];
            emu_lane = t % 32;
            threadIdx = dim3(t % cfg.block.x, (t / cfg.block.x) % cfg.block.y,
                             t / (cfg.block.x * cfg.block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = cfg.block;
            gridDim = cfg.grid;
            emu_smem = smem.data();
            emu_bar = &bar;
            kernel(args...);
            bar.arrive_and_drop();
          });
        for (auto& th : threads) th.join();
      }
}
"""

CUDA_BF16_H = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<unsigned short>(u >> 16)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 p) {
  return {__bfloat162float(p.x), __bfloat162float(p.y)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
"""


# csrc/mma_sm90.cuh's PTX wrappers, emulated with the PTX fragment layouts
MMA_SM90_H = r"""
inline uint16_t emu_lane_half(unsigned lane, int reg, int half) {
  return static_cast<uint16_t>(emu_warp->words[lane][reg] >> (16 * half));
}
inline float emu_bf16(uint16_t bits) {
  uint32_t u = uint32_t(bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// lane l gets, for matrix j (rows from lanes 8j..8j+7), row l/4 and
// elements 2(l%4), 2(l%4)+1; transposed: column l/4, rows 2(l%4), 2(l%4)+1
inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  emu_warp->ptrs[emu_lane] = p;
  emu_warp->bar->arrive_and_wait();
  const unsigned l = emu_lane;
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (!trans) {
      const auto* row = static_cast<const uint16_t*>(emu_warp->ptrs[8 * j + l / 4]);
      lo = row[2 * (l % 4)];
      hi = row[2 * (l % 4) + 1];
    } else {
      lo = static_cast<const uint16_t*>(emu_warp->ptrs[8 * j + 2 * (l % 4)])[l / 4];
      hi = static_cast<const uint16_t*>(emu_warp->ptrs[8 * j + 2 * (l % 4) + 1])[l / 4];
    }
    r[j] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  emu_warp->bar->arrive_and_wait();
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, true); }
// d += a·b, m16n8k16: a_i / b_i / d_i of lane l as the PTX ISA lays them
// out (group g = l/4, t = l%4); products summed in fp32 in k order
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  uint64_t* w = emu_warp->words[emu_lane];
  for (int i = 0; i < 4; ++i) w[i] = a[i];
  w[4] = b0;
  w[5] = b1;
  emu_warp->bar->arrive_and_wait();
  const unsigned g = emu_lane / 4, t = emu_lane % 4;
  for (int e = 0; e < 4; ++e) {
    const unsigned row = g + (e >= 2 ? 8 : 0), col = 2 * t + (e % 2);
    float sum = d[e];
    for (unsigned k = 0; k < 16; ++k) {
      const float av = emu_bf16(emu_lane_half((row % 8) * 4 + (k % 8) / 2,
                                              (row >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0), k % 2));
      const float bv = emu_bf16(emu_lane_half(col * 4 + (k % 8) / 2, 4 + (k >= 8 ? 1 : 0),
                                              k % 2));
      sum += av * bv;
    }
    d[e] = sum;
  }
  emu_warp->bar->arrive_and_wait();
}
inline void cp_async16(void* smem, const void* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  if (valid) std::memcpy(smem, gmem, 16);
  else std::memset(smem, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
template <typename T> inline void cp_async_4_zfill(T* smem, const T* gmem, bool valid) {
  if (valid) std::memcpy(smem, gmem, 4 * sizeof(T));
  else std::memset(smem, 0, 4 * sizeof(T));
}
// shared-memory addresses: offsets into the CTA's buffer, so an alignment
// in them is one in the buffer (whose swizzle the wgmma decode applies)
inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(static_cast<const char*>(p) - reinterpret_cast<const char*>(emu_smem));
}
// mbarriers: a phase completes when its arrivals are in; the state lives
// beside the buffer, keyed by the barrier's address, and waits spin
struct EmuBar { int count = 0, pending = 0; unsigned phase = 0; };
inline std::mutex emu_bar_mu;
inline std::map<const void*, EmuBar> emu_bars;
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  emu_bars[bar] = EmuBar{count, count, 0};
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& b = emu_bars.at(bar);
  if (b.pending <= 0) throw "an mbarrier arrival beyond its count";
  if (--b.pending == 0) { b.phase ^= 1u; b.pending = b.count; }
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (;;) {
    {
      std::lock_guard<std::mutex> g(emu_bar_mu);
      if ((emu_bars.at(bar).phase & 1u) != (parity & 1u)) return;
    }
    std::this_thread::yield();
  }
}
inline void fence_proxy_async() {}
// wgmma m64n64k16 from MN-major, 128-byte-swizzled bf16 tiles: element
// (mn, k) of a tile at the descriptor's address lies at the unswizzled
// offset (mn/64)·LBO + (k/8)·SBO + (k%8)·128 + 2·(mn%64), whose bits 4-6
// are XORed with bits 7-9; each thread sums its own fragment's elements in
// fp32 in k order
inline uint64_t wgmma_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) |
         static_cast<uint64_t>(2048 >> 4) << 16 | static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}
inline float emu_desc_at(uint64_t d, int mn, int k) {
  if ((d >> 62) != 1) throw "a wgmma descriptor without the 128-byte swizzle";
  const uint32_t addr = static_cast<uint32_t>(d & 0x3fff) << 4;
  const uint32_t lbo = static_cast<uint32_t>((d >> 16) & 0x3fff) << 4;
  const uint32_t sbo = static_cast<uint32_t>((d >> 32) & 0x3fff) << 4;
  uint32_t u = addr + (mn / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 + 2 * (mn % 64);
  u ^= ((u >> 7) & 7u) << 4;
  uint16_t bits;
  std::memcpy(&bits, reinterpret_cast<const char*>(emu_smem) + u, 2);
  return emu_bf16(bits);
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
inline void wgmma_hold(float (&)[32]) {}
inline void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  const unsigned t = threadIdx.x % 128, g = (t % 32) / 4, q = t % 4;
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * static_cast<int>(t / 32) + static_cast<int>(g) + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * static_cast<int>(q) + i % 2;
    float sum = accumulate ? d[i] : 0.f;
    for (int k = 0; k < 16; ++k) sum += emu_desc_at(da, row, k) * emu_desc_at(db, col, k);
    d[i] = sum;
  }
}
"""
EMULATED_HEADERS = {"mma_sm90.cuh": MMA_SM90_H}


def build(name: str) -> Path:
    """Compile csrc/<name>.cu against the emulation; returns the library."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (OUT / "cuda_bf16.h").write_text(CUDA_BF16_H)
    source = cuda_build.CSRC_DIR / f"{name}.cu"
    src = source.read_text()
    for header in cuda_build.local_headers(source):  # inlined: it holds kernels too
        text = EMULATED_HEADERS.get(header.name) or header.read_text()
        src = src.replace(f'#include "{header.name}"', text.replace("#pragma once\n", ""))
    src = re.sub(r"extern __shared__ float4 (\w+)\[\];", r"float4* \1 = emu_smem;", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu_launch(emu_cfg(\2), \1, ", src,
                 flags=re.S)
    cpp = OUT / f"{name}.cpp"
    cpp.write_text(src)
    lib = OUT / f"{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", f"-I{OUT}", "-o", str(lib), str(cpp)],
                   check=True)
    return lib


def load_emulated(name: str, defines: tuple[str, ...] = ()) -> cuda_build.CudaLibrary:
    if defines:
        raise ValueError(f"{name}: the emulation builds no variant ({defines})")
    return cuda_build.open_library(build(name), name)


@contextlib.contextmanager
def emulated_kernels():
    """The wrappers' CUDA paths on CPU tensors, against emulated libraries
    (``cuda_build.using``): a launch runs on the CPU tensors' pointers and
    a stand-in stream, which the emulated runtime checks."""
    stream = type("Stream", (), {"cuda_stream": 0x5EED0000BEEF})()
    saved_cuda = (torch.cuda.device, torch.cuda.current_stream)
    torch.cuda.device = lambda dev: contextlib.nullcontext()
    torch.cuda.current_stream = lambda dev=None: stream
    try:
        with cuda_build.using(load_emulated):
            yield
    finally:
        torch.cuda.device, torch.cuda.current_stream = saved_cuda


T = torch.from_numpy
FWD_NAMES = ("z_upd", "R", "M")


def report(name: str, got, want, tol: float) -> float:
    a, b = got.float(), want.float()
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.dtype, want.dtype)
    share = float(((a - b).abs() / (tol * (1.0 + b.abs()))).max())
    print(f"{name}: max abs err {float((a - b).abs().max()):.3e}, "
          f"{share:.3f} of the allowance (rtol = atol = {tol:g})", flush=True)
    return share


def cotangents(seed: int, Ep: int, Np: int, L: int, dtype: torch.dtype):
    rng = np.random.default_rng(seed)
    dz = T(rng.normal(size=(Ep, L)).astype(np.float32)).to(dtype)
    return dz, T(rng.normal(size=(Np, L)).astype(np.float32)), T(
        rng.normal(size=(8, L)).astype(np.float32))


def pair_indices(idx: dict) -> tuple:
    """(receivers, senders, edge_gid, block_tile, block_snd_tile) of a
    ``_pair_problem`` as tensors."""
    return tuple(T(np.array(idx[k])) for k in ("receivers", "senders", "edge_gid",
                                                "block_tile", "block_snd_tile"))


def run_backward(name: str, sd_name: str, sd, make, L: int, call, plain, *, fwd_plain,
                 bit_equal: tuple[int, ...] = (), twice: bool = False) -> list[float]:
    """A backward kernel against its plain version on ``make(L)``'s
    problem: its outputs' shares of the allowance; with ``twice`` two calls
    bit-equal; in fp32 the outputs ``bit_equal`` (the FMA chains') equal the
    plain version's."""
    arrays, idx, ix = make(L)
    a = [T(v).to(sd) for v in arrays.values()]
    z = fwd_plain(a, ix)[0]
    cot = cotangents(7, z.shape[0], a[0].shape[0], L, sd)
    got = call(a, ix, z, cot)
    if twice:
        assert all(torch.equal(u, v) for u, v in zip(got, call(a, ix, z, cot))), \
            f"{name} L={L}: two calls differ"
    want = plain(a, ix, z, cot)
    if sd == torch.float32:
        for i in bit_equal:
            assert torch.equal(got[i], want[i]), f"{name} fp32 L={L}: output {i} not bit-equal"
    tol = chip_smoke.BWD_TOL[sd_name]
    return [report(f"{name} {sd_name} L={L} #{i}", x, y, tol)
            for i, (x, y) in enumerate(zip(got, want))]


def v2_case(L: int, n_tiles: int = 2):
    """The v2 problem; with several tiles its last one is empty (all
    padding) and a receiver run crosses a part's nominal end (512 slots)."""
    arrays, idx = _v2_problem(6, n_tiles, L, empty_tile=n_tiles - 1 if n_tiles > 1 else None)
    if n_tiles > 1:
        rcv = idx["receivers"]
        nominal = np.arange(1, -(-len(rcv) // 512)) * 512
        assert (rcv[nominal] == rcv[nominal - 1]).any(), "a run crosses a part's nominal end"
    return arrays, idx, tuple(T(idx[k]) for k in ("receivers", "edge_gid", "block_tile"))


def pair_case(L: int, n_tiles: int = 2):
    """The pair-blocked problem; with several tiles its last one is empty,
    with stray endpoints and receivers met in several runs of their tile."""
    arrays, idx = _pair_problem(6, n_tiles, L, empty_tile=n_tiles - 1 if n_tiles > 1 else None)
    return arrays, idx, pair_indices(idx)


def run_forward(name: str, sd_name: str, sd, make, L: int, call, plain) -> list[float]:
    """A v2 forward kernel against its plain version on ``make(L)``'s
    problem: two calls bit-equal, in fp32 z_upd bit-equal to the plain
    version; its outputs' shares of the allowance."""
    arrays, idx, ix = make(L)
    a = [T(v).to(sd) for v in arrays.values()]
    got = [call(a, ix) for _ in range(2)]
    assert all(torch.equal(u, v) for u, v in zip(*got)), f"{name} L={L}: two calls differ"
    want = plain(a, ix)
    if sd == torch.float32:
        assert torch.equal(got[0][0], want[0]), f"{name} fp32 L={L}: z_upd not bit-equal"
    ftol = chip_smoke.KERNEL_TOL[sd_name]
    return [report(f"{name} {sd_name} L={L} {n}", x, y, ftol[n])
            for n, x, y in zip(FWD_NAMES, got[0], want)]


def fused3_case(L: int, n_tiles: int = 2, degree: int = 6):
    arrays, idx = _edge_problem(6, n_tiles, L, degree=degree)
    return arrays, idx, tuple(T(idx[k]) for k in ("receivers", "edge_gid", "block_tile"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=2, help="node tiles of the edge problems")
    ap.add_argument("--L", type=int, default=16, help="width of the segment sums' rows")
    ap.add_argument("--only", choices=("wide", "sums", "mgn"),
                    help="run only the wide variants (L = 320), only the segment sums or only "
                         "MeshGraphNets' edge update")
    args = ap.parse_args()
    if args.only:
        only = {"wide": wide_cases, "sums": lambda: segment_sum_cases(args.tiles, args.L),
                "mgn": mgn_edge_cases}[args.only]
        with emulated_kernels():
            shares = only()
        worst = max(shares)
        print(f"largest share of an allowance: {worst:.3f}", flush=True)
        return 0 if worst <= 1.0 else 1
    shares = []
    f3_fwd = lambda a, ix: fused_edge3.fused_edge_step3_reference(*a, ix[0], ix[1], 1)  # noqa: E731
    v2_fwd = lambda a, ix: fused_edge.fused_edge_step_reference(*a, ix[0], ix[1], 1)  # noqa: E731
    p2_fwd = lambda a, ix: fused_edge.fused_edge_step2_reference(  # noqa: E731
        *a, *ix[:2], ix[2:], 1, NODE_TILE)
    v2_call = lambda a, ix: fused_edge._fused_edge_step_cuda(*a, *ix, 1, NODE_TILE)  # noqa: E731
    p2_call = lambda a, ix: fused_edge._fused_edge_step2_cuda(  # noqa: E731
        *a, *ix, 1, NODE_TILE)
    f3_bwd = (lambda a, ix, z, c: fused_edge3._fused_edge_step3_backward_cuda(
                  *a, *ix, 1, NODE_TILE, z, *c),
              lambda a, ix, z, c: fused_edge3.fused_edge_step3_backward_reference(
                  *a, ix[0], ix[1], 1, z, *c))
    v2_bwd = (lambda a, ix, z, c: fused_edge._fused_edge_step_backward_cuda(
                  *a, *ix, 1, NODE_TILE, z, *c),
              lambda a, ix, z, c: fused_edge.fused_edge_step_backward_reference(
                  *a, ix[0], ix[1], 1, z, *c))
    p2_bwd = (lambda a, ix, z, c: fused_edge._fused_edge2_bwd_cuda(*a, *ix, 1, NODE_TILE, z, *c),
              lambda a, ix, z, c: fused_edge.fused_edge2_bwd_reference(
                  *a, *ix[:2], ix[2:], 1, NODE_TILE, z, *c))
    with emulated_kernels():
        for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            ftol = chip_smoke.KERNEL_TOL[sd_name]
            # the fused3 forward at each of its widths; one node tile has no
            # real edge (its block is all padding)
            for L in fused_edge3.FWD_WIDTHS:
                arrays, idx = _edge_problem(5, args.tiles, L, empty_tile=args.tiles - 1)
                a = [T(v).to(sd) for v in arrays.values()]
                rcv, gid, bt = (T(idx[k]) for k in ("receivers", "edge_gid", "block_tile"))
                got = [fused_edge3._fused_edge_step3_cuda(*a, rcv, gid, bt, 1, NODE_TILE)
                       for _ in range(2)]
                assert all(torch.equal(u, v) for u, v in zip(*got)), \
                    f"fused_edge3_fwd L={L}: two calls differ"
                want = fused_edge3.fused_edge_step3_reference(*a, rcv, gid, 1)
                shares += [report(f"fused_edge3_fwd {sd_name} L={L} {n}", x, y, ftol[n])
                           for n, x, y in zip(FWD_NAMES, got[0], want)]
                if sd == torch.float32:  # the FMA chains keep the plain version's rounding
                    assert torch.equal(got[0][0], want[0]), \
                        f"fused_edge3_fwd fp32 L={L}: z_upd not bit-equal"

            # the fused3 backward at 64 (64-slot steps) and 256 (16-slot steps,
            # the split weights from a ring; a node degree of 1 keeps it short)
            for L, degree in ((64, 6), (256, 1)):
                shares += run_backward("fused_edge3_bwd", sd_name, sd,
                                       lambda L, d=degree: fused3_case(L, args.tiles, d), L,
                                       *f3_bwd, fwd_plain=f3_fwd)
            # the redesigned v2 (#6) and pair-blocked (#8) backwards: two calls
            # bit-equal, fp32 dg_v / dg_u and dpre1 / dpre2 bit-equal
            for L in (64, 128):
                shares += run_backward("fused_edge_bwd", sd_name, sd,
                                       lambda L: v2_case(L, args.tiles), L, *v2_bwd,
                                       fwd_plain=v2_fwd, bit_equal=(2, 3), twice=True)
                shares += run_backward("fused_edge2_bwd", sd_name, sd,
                                       lambda L: pair_case(L, args.tiles), L, *p2_bwd,
                                       fwd_plain=p2_fwd, bit_equal=(1, 2), twice=True)

            # the redesigned v2 (#5) and pair-blocked (#7) forwards at each of
            # their widths (bf16: the tensor cores at 64 and 128, the FMA
            # chains at 256)
            for L in fused_edge.FWD_WIDTHS:
                shares += run_forward("fused_edge_fwd", sd_name, sd,
                                      lambda L: v2_case(L, args.tiles), L, v2_call, v2_fwd)
                shares += run_forward("fused_edge2_fwd", sd_name, sd,
                                      lambda L: pair_case(L, args.tiles), L, p2_call, p2_fwd)

            shares += segment_sum_cases(args.tiles, args.L, (sd_name,))

        # one width each fused kernel is not built for, through the zero
        # padding (fp32, one node tile): 16 for fused3 and the backwards, 18
        # for the v2 forwards (each run at 64)
        sd_name, sd = "float32", torch.float32
        ftol = chip_smoke.KERNEL_TOL[sd_name]
        arrays, idx, ix = fused3_case(16, 1)
        a = [T(v).to(sd) for v in arrays.values()]
        got = fused_edge3._fused_edge_step3_cuda(*a, *ix, 1, NODE_TILE)
        shares += [report(f"fused_edge3_fwd padded L=16 {n}", x, y, ftol[n])
                   for n, x, y in zip(FWD_NAMES, got, f3_fwd(a, ix))]
        shares += run_backward("fused_edge3_bwd padded", sd_name, sd,
                               lambda L: fused3_case(L, 1), 16, *f3_bwd, fwd_plain=f3_fwd)
        shares += run_backward("fused_edge_bwd padded", sd_name, sd, lambda L: v2_case(L, 1),
                               16, *v2_bwd, fwd_plain=v2_fwd, bit_equal=(2, 3))
        shares += run_backward("fused_edge2_bwd padded", sd_name, sd,
                               lambda L: pair_case(L, 1), 16, *p2_bwd, fwd_plain=p2_fwd,
                               bit_equal=(1, 2))
        arrays, idx = _v2_problem(5, 1, 18)
        a = [T(v).to(sd) for v in arrays.values()]
        rcv, gid, bt = (T(idx[k]) for k in ("receivers", "edge_gid", "block_tile"))
        got = fused_edge._fused_edge_step_cuda(*a, rcv, gid, bt, 1, NODE_TILE)
        shares += [report(f"fused_edge_fwd padded L=18 {n}", x, y, ftol[n])
                   for n, x, y in zip(FWD_NAMES, got, v2_fwd(a, (rcv, gid)))]
        arrays, idx = _pair_problem(5, 1, 18)
        a = [T(v).to(sd) for v in arrays.values()]
        ix = pair_indices(idx)
        got = fused_edge._fused_edge_step2_cuda(*a, *ix, 1, NODE_TILE)
        shares += [report(f"fused_edge2_fwd padded L=18 {n}", x, y, ftol[n])
                   for n, x, y in zip(FWD_NAMES, got, p2_fwd(a, ix))]
        shares += wide_cases()
        shares += mgn_edge_cases()
    worst = max(shares)
    print(f"largest share of an allowance: {worst:.3f}", flush=True)
    return 0 if worst <= 1.0 else 1


def segment_sum_cases(n_tiles: int, L: int,
                      dtypes: tuple[str, ...] = ("float32", "bfloat16")) -> list[float]:
    """The segment sum (#3) and the pair sum (#4) on both callers' layouts,
    at L and at L + 2 (columns padded to a multiple of 4), twice,
    bit-equal."""
    shares = []
    n_nodes = n_tiles * NODE_TILE
    for sd_name in dtypes:
        sd = getattr(torch, sd_name)
        tol = chip_smoke.CSR_TOL[sd_name]
        for width in (L, L + 2):
            rows, layouts = _segment_problem(8, n_tiles, width)
            other = torch.flip(rows, (0,)).contiguous()
            for layout, (rcv, bt, perm) in layouts.items():
                got = [scatter_csr._csr_segment_sum_cuda(rows.to(sd), rcv, n_nodes, perm)
                       for _ in range(2)]
                assert torch.equal(got[0], got[1]), f"segment_sum_csr {layout}: two calls differ"
                want = scatter_csr.csr_segment_sum_reference(rows.to(sd), rcv, n_nodes, perm)
                shares.append(report(f"segment_sum_csr {sd_name} {layout} L={width} (longest "
                                     f"run {_longest_run(rcv)})", got[0], want, tol))
                want = scatter_csr.csr_segment_sum_pair_reference(rows.to(sd), other.to(sd), rcv,
                                                                  n_nodes, perm)
                got = [scatter_csr._csr_segment_sum_pair_cuda(
                    rows.to(sd), other.to(sd), rcv, bt, n_nodes, NODE_TILE, perm)
                    for _ in range(2)]
                assert all(torch.equal(u, v) for u, v in zip(*got)), \
                    f"segment_sum_csr_pair {layout}: two calls differ"
                shares += [report(f"segment_sum_csr_pair {sd_name} {layout} L={width} {i}",
                                  x, y, tol) for i, (x, y) in enumerate(zip(got[0], want))]
    return shares


MGN_EDGE_NAMES = ("e_new", "e_sum", "a0", "a1", "y", "mean", "rstd")


def mgn_edge_cases() -> list[float]:
    """MeshGraphNets' edge update forward (``mgn_edge_fwd``, L = 128)
    against its plain version on a layout with a node tile of only padding,
    over every slot and over a count that ends inside a 64-slot tile; two
    calls bit-equal, and the call that saves nothing for the backward
    bit-equal to the one that does."""
    shares = []
    tol = chip_smoke.MGN_EDGE_TOL
    args = _mgn_edge_problem(9)
    for n in (args[2].shape[0], args[2].shape[0] - 40):
        a = [t[:n] if i in (2, 8, 9, 10) else t for i, t in enumerate(args)]
        got = [mgn_edge._edge_update_cuda(*a, saves=True) for _ in range(2)]
        got = [(new, total, *saved) for new, total, saved in got]
        assert all(torch.equal(u, v) for u, v in zip(*got)), "mgn_edge_fwd: two calls differ"
        new, total, saved = mgn_edge._edge_update_cuda(*a, saves=False)
        assert saved is None and torch.equal(new, got[0][0]) and torch.equal(total, got[0][1])
        want = mgn_edge.edge_update_reference(*a)
        shares += [report(f"mgn_edge_fwd n={n} {name}", x, y, tol)
                   for name, x, y in zip(MGN_EDGE_NAMES, got[0], (*want[:2], *want[2]))]
    return shares


def wide_cases(L: int = 320) -> list[float]:
    """Each fused kernel's wide variant at L (and its wrapper's padding at
    L - 30) against its plain version, in both stream dtypes, on one node
    tile (fused3 and v2 with a receiver run of padding slots; fused2 with
    stray endpoints), twice, bit-equal."""
    shares = []
    f3 = lambda L: fused3_case(L, 1, 2)  # noqa: E731
    cases = {
        "fused_edge3_fwd": (f3, lambda a, ix: fused_edge3._fused_edge_step3_cuda(
            *a, *ix, 1, NODE_TILE), lambda a, ix: fused_edge3.fused_edge_step3_reference(
            *a, ix[0], ix[1], 1)),
        "fused_edge_fwd": (lambda L: v2_case(L, 1), lambda a, ix: fused_edge._fused_edge_step_cuda(
            *a, *ix, 1, NODE_TILE), lambda a, ix: fused_edge.fused_edge_step_reference(
            *a, ix[0], ix[1], 1)),
        "fused_edge2_fwd": (lambda L: pair_case(L, 2), lambda a, ix:
                            fused_edge._fused_edge_step2_cuda(*a, *ix, 1, NODE_TILE),
                            lambda a, ix: fused_edge.fused_edge_step2_reference(
                                *a, *ix[:2], ix[2:], 1, NODE_TILE)),
    }
    bwd = {
        "fused_edge3_bwd": (f3, "fused_edge3_fwd", lambda a, ix, z, c:
                            fused_edge3._fused_edge_step3_backward_cuda(
                                *a, *ix, 1, NODE_TILE, z, *c),
                            lambda a, ix, z, c: fused_edge3.fused_edge_step3_backward_reference(
                                *a, ix[0], ix[1], 1, z, *c)),
        "fused_edge_bwd": (lambda L: v2_case(L, 1), "fused_edge_fwd", lambda a, ix, z, c:
                           fused_edge._fused_edge_step_backward_cuda(*a, *ix, 1, NODE_TILE, z, *c),
                           lambda a, ix, z, c: fused_edge.fused_edge_step_backward_reference(
                               *a, ix[0], ix[1], 1, z, *c)),
        "fused_edge2_bwd": (lambda L: pair_case(L, 2), "fused_edge2_fwd", lambda a, ix, z, c:
                            fused_edge._fused_edge2_bwd_cuda(*a, *ix, 1, NODE_TILE, z, *c),
                            lambda a, ix, z, c: fused_edge.fused_edge2_bwd_reference(
                                *a, *ix[:2], ix[2:], 1, NODE_TILE, z, *c)),
    }
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ftol = chip_smoke.KERNEL_TOL[sd_name]
        for width in (L, L - 30):
            for name, (make, call, plain) in cases.items():
                arrays, idx, ix = make(width)
                a = [T(v).to(sd) for v in arrays.values()]
                got = [call(a, ix) for _ in range(2)]
                assert all(torch.equal(u, v) for u, v in zip(*got)), \
                    f"{name} wide: two calls differ"
                shares += [report(f"{name} wide {sd_name} L={width} {n}", x, y, ftol[n])
                           for n, x, y in zip(FWD_NAMES, got[0], plain(a, ix))]
            for name, (make, fwd, call, plain) in bwd.items():
                fwd_plain = cases[fwd][2]
                shares += run_backward(f"{name} wide", sd_name, sd, make, width, call, plain,
                                       fwd_plain=fwd_plain, twice=True)
    return shares


if __name__ == "__main__":
    sys.exit(main())
