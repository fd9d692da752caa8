// Tensor-core, copy and barrier primitives of the port's kernels, as inline
// PTX for sm_90a: ldmatrix, mma.sync m16n8k16 (bf16 operands, fp32
// accumulation) and cp.async; and Hopper's warpgroup MMA (wgmma m64n64k16,
// both operands in shared memory) and mbarriers for warp-specialized
// kernels. scripts/port_cuda_emulate.py gives the CPU
// emulation the same functions with the PTX fragment and descriptor
// layouts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the 16-byte rows of matrix j,
// register j gets lane l's fragment: row l/4, elements 2(l%4), 2(l%4)+1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldsm_x4, each matrix transposed: lane l gets column l/4, rows 2(l%4)
// and 2(l%4)+1.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a·b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B (column
// fragment), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

// As cp_async16, writing 16 zero bytes (reading nothing) where !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// 4 values of a stream (16 bytes in fp32, 8 in bf16) from global to shared
// memory, zeros where !valid.
template <typename T>
__device__ __forceinline__ void cp_async_4_zfill(T* smem, const T* gmem, bool valid) {
  if constexpr (sizeof(T) == 4)
    cp_async16_zfill(smem, gmem, valid);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the async proxy; a
// __syncthreads() then publishes them to the CTA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed (a barrier starts
// in phase 0; waiting on parity 1 first returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's shared-memory stores before later reads by the async
// proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warpgroup MMA ----

// The descriptor of a bf16 wgmma operand tile in shared memory, MN-major
// (the M or N index contiguous) with the 128-byte swizzle: 64 MN values
// (128 bytes) a row, one row per k, the 8 rows of a 1024-byte atom with
// their 16-byte chunks XOR-swizzled by the row (swz<64> of fused3_tile.cuh),
// atoms of 8 k rows 1024 bytes apart. `tile` is 1024-byte aligned.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) |
         static_cast<uint64_t>(2048 >> 4) << 16 |  // leading offset: next 64 MN values (unused)
         static_cast<uint64_t>(1024 >> 4) << 32 |  // stride offset: next 8 k rows
         static_cast<uint64_t>(1) << 62;           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void wgmma_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (= or +=, by `accumulate`) Aᵀ-style product of a warpgroup: d (64 x 64
// fp32) += A (64 x 16) · B (16 x 64), A and B bf16 tiles given by their
// MN-major descriptors (the transposed layouts: A's M index and B's N index
// contiguous). Thread t of the warpgroup holds rows 16·(t/32) + (t%32)/4
// (+8) and columns 8j + 2(t%4) (+1) of d, as mma.sync's fragments: d[4j],
// d[4j+1] in the first row, d[4j+2], d[4j+3] in the second.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
