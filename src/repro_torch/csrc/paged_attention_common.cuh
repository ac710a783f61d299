// Shared device code of the attention kernels: constants, page dtype ids,
// dtype conversions, warp reductions, and the merge of split partials that
// both paged kernels (paged_decode_attention.cu, paged_prefill_attention.cu)
// end with. The dense kernels (decode_attention.cu, flash_attention.cu) use
// only the constants, conversions and reductions, since their masking rule
// differs: the paged kernels zero the probabilities of masked keys, so a row
// that sees no key at all ends as acc / max(l, 1e-30) = 0, never NaN.
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

}  // namespace paged_attn
