// Shared device code of the attention kernels: constants, page dtype ids,
// dtype conversions, warp reductions, and the merge of split partials that
// both paged kernels (paged_decode_attention.cu, paged_prefill_attention.cu)
// end with, and the tensor-core helpers (mma.sync, ldmatrix, cp.async) of
// the two mma kernels (paged_prefill_attention.cu, flash_attention.cu). The
// dense kernels (decode_attention.cu, flash_attention.cu) do not use the
// merge, since their masking rule differs: the paged kernels zero the
// probabilities of masked keys, so a row that sees no key at all ends as
// acc / max(l, 1e-30) = 0, never NaN.
//
// A split is a block's share of one output row's keys. It leaves the online
// softmax state of the row in f32:
//
//   m   row max of the logits it saw   (-inf: the split saw no key)
//   l   row sum of exp(s - m)          (0 with m = -inf)
//   acc row sum of exp(s - m) * V      [hd], not read where m = -inf
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged_attn {

constexpr float NEG = -1e30f;
constexpr int MAX_SMEM = 232448;     // bytes a block may use on sm_90

enum PageDtype { F32 = 0, BF16 = 1, F16 = 2, I8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// An f32 value rounded to the output's element type (f32 or bf16).
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Merge the splits of one output row (blockIdx.x = row of out [rows, hd]):
// part_m / part_l [rows][nsplit], part_acc [rows][nsplit][hd]. Splits are
// weighed by exp(m_j - max m); a split with m = -inf weighs 0 and its acc is
// not read, so a row whose splits all saw no key returns exactly 0 and
// exp(-inf - (-inf)) is never taken. A template, so that the dense kernels'
// libraries, which include this header, do not compile it.
template <typename Unused = void>
__global__ void __launch_bounds__(128)
    merge_splits(const float* __restrict__ part_m,
                 const float* __restrict__ part_l,
                 const float* __restrict__ part_acc, float* __restrict__ out,
                 int hd, int nsplit) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float mx = -INFINITY;
  for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, pm[j]);
  float l = 0.f;
  if (mx != -INFINITY)
    for (int j = 0; j < nsplit; ++j)
      if (pm[j] != -INFINITY) l += pl[j] * expf(pm[j] - mx);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    if (mx != -INFINITY)
      for (int j = 0; j < nsplit; ++j)
        if (pm[j] != -INFINITY)
          a += part_acc[(row * nsplit + j) * hd + d] * expf(pm[j] - mx);
    out[row * hd + d] = a * inv;
  }
}

// --- tensor-core helpers of the mma kernels (paged_prefill_attention.cu,
// flash_attention.cu): m16n8k16 products with f32 accumulators, ldmatrix
// fragment loads and 16-byte cp.async staging ---------------------------
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  // two f32 values as a pair of bf16 (first in the low half) and the pair
  // of what the rounding left out
  __device__ __forceinline__ static void split(float a, float b,
                                               uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 r = __floats2bfloat162_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  }
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  __device__ __forceinline__ static void split(float a, float b,
                                               uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 f = __half22float2(h);
    const __half2 r = __floats2half2_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  }
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace paged_attn
