// Hopper asynchronous-copy helpers of the block-sweep inverse: mbarriers in
// shared memory, tensor (TMA) copies between device and shared memory, and
// the proxy fences between them.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread initialises; fence_mbarrier_init() and a __syncthreads() make
// the barriers visible to every thread and to the async proxy.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive and announce `bytes` of copies that will complete on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (phase k of a
// barrier has parity k & 1; phase 0 is the first).  A wait that outlasts
// ~2^26 polls (seconds) traps, so that a barrier that can never complete
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (x, y, z) of a 3-D tensor map (a __grid_constant__ kernel
// parameter) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int x,
                                            int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// The box at (x, y, z) of a 3-D tensor map from shared memory to device
// memory, in this thread's bulk async-group.
__device__ __forceinline__ void tma_store_3d(const void* map, int x, int y,
                                             int z, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];" ::"l"(map),
      "r"(x), "r"(y), "r"(z), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Until this thread's bulk stores have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Order this thread's generic-proxy accesses to shared (or global) memory
// before later async-proxy ones (TMA, wgmma operand reads) and vice versa.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}
