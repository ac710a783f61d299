// hero_dma: the in-kernel half of the paper's DMA API (HEROv2 §2.4) for
// Hopper (sm_90a).
//
// Counterpart of src/repro/core/dma.py:128 copy_async, which starts
// pltpu.make_async_copy on the TPU's DMA engine and returns a handle whose
// .wait() waits on its semaphore. On Hopper the engine is the Tensor Memory
// Accelerator: one thread asks for a 1-D bulk copy from device memory into
// shared memory, the hardware moves the bytes and counts them against an
// mbarrier in shared memory, and every thread that needs the bytes waits on
// the barrier's phase. No thread spends registers or instructions on the
// copy while it is in flight.
//
//   __shared__ alignas(8) uint64_t bar;
//   if (threadIdx.x == 0) hero_dma::barrier_init(&bar, 1);
//   __syncthreads();
//   hero_dma::AsyncCopy cp{&bar, 0};
//   if (threadIdx.x == 0) cp = hero_dma::copy_async(smem, gmem, bytes, &bar, 0);
//   cp.wait();                       // every thread: the bytes are in smem
//
// A bulk copy needs its global and shared addresses 16-byte aligned and a
// byte count that is a multiple of 16 (below 2^20, the barrier's
// transaction count); the caller copies the rest by hand.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hero_dma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises the barrier for `count` arrivals and makes it
// visible to the async proxy (the TMA unit); __syncthreads() after it.
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The handle of one copy: wait() returns once the barrier's phase `phase`
// has completed, i.e. once every byte the copy announced has landed.
struct AsyncCopy {
  uint64_t* bar;
  uint32_t phase;

  __device__ __forceinline__ void wait() const {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done) : "r"(addr), "r"(phase) : "memory");
    } while (!done);
  }
};

// Start a bulk copy of `bytes` bytes from global `src` into shared `dst`
// (both 16-byte aligned, bytes a multiple of 16); one thread calls it. The
// barrier expects the bytes and completes its phase when they land.
__device__ __forceinline__ AsyncCopy copy_async(void* dst, const void* src,
                                                uint32_t bytes,
                                                uint64_t* bar,
                                                uint32_t phase) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
  return AsyncCopy{bar, phase};
}

}  // namespace hero_dma
