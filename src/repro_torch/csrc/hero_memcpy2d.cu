// hero_memcpy2d: the paper's 2-D scatter-gather copy for Hopper (sm_90a).
//
// Replaces: src/repro/core/dma.py:148 hero_memcpy2d, the in-kernel helper
// that copies `rows` sequences of `elems` elements with per-row strides,
// one DMA burst a row, in a sequential row loop: row i reads src[so + i*ss,
// + elems) and writes dst[do + i*ds, + elems). It reaches no pallas_call of
// its own; the reference runs it inside a kernel's body.
//
// Semantics kept exactly, overlap included: where destination rows overlap
// (ds < elems, or ds = 0) the later row wins, as in the sequential loop.
// So row i owns only the part of its span that no later row covers: its
// first min(ds, elems) elements, all `elems` for the last row. Those parts
// are disjoint and cover what the loop writes, so the rows copy in
// parallel with no order between them. Bytes are copied as they are (an
// element type of 1, 2, 4 or 8 bytes): the result equals the loop's bit
// for bit.
//
// What bounds it on the H100: device-memory bytes, each source byte read
// once and each destination byte written once (the tile gather of 4096 x
// 4096 f32: 134.2 MB, ~0.040 ms at 3.35 TB/s). No arithmetic.
//
// Design: a block takes one CHUNK of one row (grid: rows x chunks a row).
// The row's bytes from the first 16-byte aligned source address on, in
// whole 16-byte units, are staged through shared memory by one TMA bulk
// copy (hero_dma.cuh copy_async) on an mbarrier, and stored with 16-byte
// stores where the destination is 16-byte aligned at the same place, else
// element by element. The head before the aligned address and the tail
// after the last whole unit are copied element by element by the row's
// first block. A block of 256 threads uses 16 KB of shared memory, so 8
// fit an SM and ~17 MB of loads are in flight across the card.
#include <cstdint>
#include <cuda_runtime.h>

#include "hero_dma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 16384;   // bytes a block stages (< 2^20)

// the elements a row owns: the rest of its span a later row overwrites
__device__ __forceinline__ long long owned(long long i, long long rows,
                                           long long elems, long long ds) {
  return (i == rows - 1 || ds >= elems) ? elems : ds;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
memcpy2d_kernel(T* __restrict__ dst, const T* __restrict__ src,
                long long rows, long long elems, long long ss, long long ds,
                long long so, long long doff, long long chunks) {
  __shared__ alignas(128) unsigned char buf[CHUNK];
  __shared__ alignas(8) uint64_t bar;
  const long long i = blockIdx.x / chunks;
  const long long c = blockIdx.x % chunks;
  const long long n = owned(i, rows, elems, ds) * (long long)sizeof(T);
  if (n == 0) return;
  const unsigned char* s =
      reinterpret_cast<const unsigned char*>(src + so + i * ss);
  unsigned char* d = reinterpret_cast<unsigned char*>(dst + doff + i * ds);
  long long head = (16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15;
  if (head > n) head = n;
  const long long body = (n - head) & ~15LL;
  if (c == 0) {   // head and tail, element by element
    const long long hn = head / (long long)sizeof(T);
    const long long t0 = (head + body) / (long long)sizeof(T);
    const long long tn = n / (long long)sizeof(T) - t0;
    const T* st = reinterpret_cast<const T*>(s);
    T* dt = reinterpret_cast<T*>(d);
    for (long long k = threadIdx.x; k < hn + tn; k += THREADS) {
      const long long e = k < hn ? k : t0 + (k - hn);
      dt[e] = st[e];
    }
  }
  const long long lo = c * CHUNK;
  if (lo >= body) return;
  const uint32_t bytes =
      static_cast<uint32_t>(body - lo < CHUNK ? body - lo : CHUNK);
  if (threadIdx.x == 0) hero_dma::barrier_init(&bar, 1);
  __syncthreads();
  hero_dma::AsyncCopy cp{&bar, 0};
  if (threadIdx.x == 0) cp = hero_dma::copy_async(buf, s + head + lo, bytes,
                                                  &bar, 0);
  cp.wait();
  unsigned char* out = d + head + lo;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const uint4* from = reinterpret_cast<const uint4*>(buf);
    uint4* to = reinterpret_cast<uint4*>(out);
    for (uint32_t k = threadIdx.x; k < bytes / 16; k += THREADS)
      to[k] = from[k];
  } else {        // the destination is aligned to the element only
    const T* from = reinterpret_cast<const T*>(buf);
    T* to = reinterpret_cast<T*>(out);
    for (uint32_t k = threadIdx.x; k < bytes / sizeof(T); k += THREADS)
      to[k] = from[k];
  }
}

template <typename T>
int launch(void* dst, const void* src, long long rows, long long elems,
           long long ss, long long ds, long long so, long long doff,
           cudaStream_t stream) {
  const long long row_bytes = elems * (long long)sizeof(T);
  const long long chunks = (row_bytes + CHUNK - 1) / CHUNK;   // >= 1
  if (rows * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  memcpy2d_kernel<T><<<static_cast<unsigned>(rows * chunks), THREADS, 0,
                       stream>>>(static_cast<T*>(dst),
                                 static_cast<const T*>(src), rows, elems, ss,
                                 ds, so, doff, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dst[doff + i*ds + e] = src[so + i*ss + e] for rows i in order, e <
// elems, on 1-D buffers of `itemsize`-byte elements (1, 2, 4 or 8);
// offsets and strides in elements, >= 0, bounds checked by the caller.
// Returns a cudaError_t value: 0 on a launch that was accepted.
int hero_memcpy2d(void* dst, const void* src, long long rows,
                  long long elems, long long ss, long long ds, long long so,
                  long long doff, int itemsize, void* stream) {
  if (rows == 0 || elems == 0) return cudaSuccess;
  if (rows < 0 || elems < 0 || ss < 0 || ds < 0 || so < 0 || doff < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t>(dst, src, rows, elems, ss, ds, so, doff, s);
    case 2: return launch<uint16_t>(dst, src, rows, elems, ss, ds, so, doff, s);
    case 4: return launch<uint32_t>(dst, src, rows, elems, ss, ds, so, doff, s);
    case 8:
      return launch<unsigned long long>(dst, src, rows, elems, ss, ds, so,
                                        doff, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* hero_memcpy2d_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
