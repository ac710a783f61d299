// Shared device code of the two paged attention kernels
// (paged_decode_attention.cu, paged_prefill_attention.cu).
//
// Both kernels walk one sequence's page table inside a thread block and keep
// an online softmax per query row in shared memory:
//
//   m   running row max          (starts at -inf)
//   l   running row sum of p     (starts at 0)
//   acc running row sum of p·V   [R, hd], f32
//
// A query row r sees key position kpos iff kpos < lim[r]; masked logits are
// NEG = -1e30 and their probabilities are exactly 0, so a row that sees no
// key at all ends as acc / max(l, 1e-30) = 0, never NaN. Pages are staged in
// shared memory as f32: bf16 / f16 / f32 are converted, int8 is multiplied by
// its per-(page, kv-head) scale.
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory carve-up for R query rows. K and q rows are padded to
// hd + 1 floats so that the score loop (threads on neighbouring keys, same
// feature) reads distinct banks.
struct Smem {
  float* q;      // [R, hd + 1]
  float* k;      // [pt, hd + 1]
  float* v;      // [pt, hd]
  float* s;      // [R, pt] logits, then probabilities
  float* acc;    // [R, hd]
  float* m;      // [R]
  float* l;      // [R]
  float* corr;   // [R]
  int* lim;      // [R] keys visible to the row: kpos < lim
};

__host__ __device__ inline size_t smem_bytes(int R, int pt, int hd) {
  size_t floats = (size_t)R * (hd + 1) + (size_t)pt * (hd + 1) +
                  (size_t)pt * hd + (size_t)R * pt + (size_t)R * hd +
                  3 * (size_t)R;
  return floats * sizeof(float) + (size_t)R * sizeof(int);
}

__device__ inline Smem carve(float* base, int R, int pt, int hd) {
  Smem sm;
  sm.q = base;
  sm.k = sm.q + R * (hd + 1);
  sm.v = sm.k + pt * (hd + 1);
  sm.s = sm.v + pt * hd;
  sm.acc = sm.s + R * pt;
  sm.m = sm.acc + R * hd;
  sm.l = sm.m + R;
  sm.corr = sm.l + R;
  sm.lim = reinterpret_cast<int*>(sm.corr + R);
  return sm;
}

__device__ inline void init_state(const Smem& sm, int R, int hd) {
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = -INFINITY;
    sm.l[r] = 0.f;
  }
}

// Stage page `pid`, kv-head `kh` of a [P, K, pt, hd] pool as f32 rows of
// stride `ld` (scale = 1 unless the pool is int8).
template <typename PageT>
__device__ inline void load_tile(const PageT* __restrict__ pages,
                                 const float* __restrict__ scales, int pid,
                                 int kh, int K, int pt, int hd, float* dst,
                                 int ld) {
  const size_t base = ((size_t)pid * K + kh) * (size_t)pt * hd;
  const float sc = scales ? scales[(size_t)pid * K + kh] : 1.f;
  for (int i = threadIdx.x; i < pt * hd; i += blockDim.x) {
    const int t = i / hd, d = i - t * hd;
    float x = to_f32(pages[base + i]);
    if (scales) x *= sc;
    dst[t * ld + d] = x;
  }
}

// One page of the online softmax for R rows: page j holds key positions
// j*pt .. j*pt+pt-1, already staged in sm.k / sm.v.
__device__ inline void page_step(const Smem& sm, int j, int R, int pt, int hd,
                                 float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // logits
  for (int i = threadIdx.x; i < R * pt; i += blockDim.x) {
    const int r = i / pt, t = i - r * pt;
    float s = NEG;
    if (j * pt + t < sm.lim[r]) {
      const float* qr = sm.q + r * (hd + 1);
      const float* kr = sm.k + t * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
    }
    sm.s[i] = s;
  }
  __syncthreads();
  // online-softmax row update: one warp per row, pt <= 64 keys per page
  for (int r = warp; r < R; r += nwarps) {
    float* sr = sm.s + r * pt;
    const int lim = sm.lim[r] - j * pt;       // keys of this page the row sees
    const float s0 = lane < pt ? sr[lane] : NEG;
    const float s1 = lane + 32 < pt ? sr[lane + 32] : NEG;
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
    const float p0 = (lane < pt && lane < lim) ? expf(s0 - m_new) : 0.f;
    const float p1 =
        (lane + 32 < pt && lane + 32 < lim) ? expf(s1 - m_new) : 0.f;
    const float psum = warp_sum(p0 + p1);
    if (lane < pt) sr[lane] = p0;
    if (lane + 32 < pt) sr[lane + 32] = p1;
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);   // 0 while m_prev is -inf
      sm.l[r] = sm.l[r] * corr + psum;
      sm.m[r] = m_new;
      sm.corr[r] = corr;
    }
  }
  __syncthreads();
  // acc = acc·corr + p·V
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const float* pr = sm.s + r * pt;
    float a = sm.acc[i] * sm.corr[r];
    for (int t = 0; t < pt; ++t) a = fmaf(pr[t], sm.v[t * hd + d], a);
    sm.acc[i] = a;
  }
  __syncthreads();
}

// Walk pages 0 .. n_pages-1 of one page-table row for kv-head kh.
template <typename PageT>
__device__ inline void walk_pages(const Smem& sm, const PageT* kp,
                                  const PageT* vp, const float* ks,
                                  const float* vs, const int* table_row,
                                  int n_pages, int kh, int K, int R, int pt,
                                  int hd, float scale) {
  for (int j = 0; j < n_pages; ++j) {
    // -1 entries never reach here (n_pages stops at the row's length); the
    // clamp mirrors the reference for a table that is shorter than its length
    const int pid = max(table_row[j], 0);
    load_tile(kp, ks, pid, kh, K, pt, hd, sm.k, hd + 1);
    load_tile(vp, vs, pid, kh, K, pt, hd, sm.v, hd);
    __syncthreads();
    page_step(sm, j, R, pt, hd, scale);
  }
}

}  // namespace paged_attn
