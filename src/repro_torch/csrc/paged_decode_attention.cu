// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py, paged_flash_decode
// (the Pallas TPU kernel, grid (B*K, max_pages) with the page axis as a
// sequential grid dimension carrying (m, l, acc) in VMEM scratch).
//
// Computes one-token GQA attention for B slots over a shared page pool
// k/v_pages [P, K, pt, hd] (bf16, f16, f32, or int8 with f32 [P, K] scales):
// slot b walks page_table[b] for ceil(len_b / pt) pages, query head
// h = k*G + g attends key positions < lengths[b], out [B, H, hd] f32.
//
// What bounds it on the H100: device-memory bytes. Per slot the kernel must
// read K*ceil(len/pt)*pt*hd*2*itemsize bytes of K and V and does only
// 4*G*hd flops per key read (about 7 flop/byte in bf16), far below the ~295
// flop/byte the card needs before its arithmetic becomes the limit. So the
// products stay f32 on CUDA cores, and the design is about keeping enough
// loads in flight.
//
// Design: flash decoding over the page table, two launches.
//
//   1. paged_decode_split: the page axis that was a sequential grid
//      dimension on the TPU is cut into splits of `pages_per_split` pages;
//      one block per (split, slot x kv head, group of <= 8 query rows).
//      The wrapper derives the split from the host int max_pages and the SM
//      count, about four blocks per SM (on the H100 four ran faster than
//      one, two, three, six or eight): B*K = 16 pairs give 32 splits of 4
//      pages, 512 blocks, at the serving shape. It never reads `lengths`,
//      which lives on the device: the launch needs no sync and can be
//      captured in a CUDA graph. A split that starts at or past
//      its slot's length writes m = -inf, l = 0 and exits without reading
//      its table entries. Inside a block each warp takes every fourth run
//      of keys: a key row is read by hd / 8 lanes (hd / 4 for f32) with one
//      16-byte load each (8 bytes for int8) straight into registers, no
//      shared-memory staging and no block barrier per page. Each warp keeps
//      the online softmax of the block's query rows over its own keys (row
//      max warp-uniform, sums per lane), and the warps merge once, through
//      shared memory, at the block's end. int8 is multiplied by its
//      per-(page, kv-head) scale: K's on the logit, V's on the probability.
//   2. merge_splits (paged_attention_common.cuh): one block per (slot,
//      query head) weighs the splits by exp(m_j - max m) and divides by
//      max(l, 1e-30); splits with m = -inf weigh 0, so a length-0 slot
//      returns exactly 0.
#include "paged_attention_common.cuh"

using namespace paged_attn;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 8;            // query rows of one kv head per block

// Elements one lane reads per key row: 16 bytes (8 bytes for int8, so that
// a lane's share of K and V stays 8 values).
template <typename T>
struct Lane {
  static constexpr int EPL = sizeof(T) == 4 ? 4 : 8;
};

__device__ __forceinline__ void load_row(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_row(const __half* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_row(const int8_t* p, float (&x)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// One block: split blockIdx.x of (slot, kv head) blockIdx.y, query rows
// g0 .. g0+R-1 of that kv head (g0 = 8 * blockIdx.z). Partials of query
// head h of slot b go to row b*H + h of part_m / part_l [B*H][nsplit] and
// part_acc [B*H][nsplit][HD].
template <typename PageT, int HD>
__global__ void __launch_bounds__(THREADS)
    paged_decode_split(const float* __restrict__ q,
                       const PageT* __restrict__ kp,
                       const PageT* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ part_m,
                       float* __restrict__ part_l,
                       float* __restrict__ part_acc, int H, int K, int pt,
                       int max_pages, int pages_per_split, float scale) {
  constexpr int EPL = Lane<PageT>::EPL;
  constexpr int LPR = HD / EPL;          // lanes that read one key row
  constexpr int KPW = 32 / LPR;          // keys a warp reads at once
  __shared__ __align__(16) float sq[ROWS * HD];
  __shared__ float wm[NWARPS][ROWS], wl[NWARPS][ROWS];
  __shared__ __align__(16) float wacc[NWARPS][ROWS * HD];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  const int g0 = blockIdx.z * ROWS, R = min(ROWS, G - g0);
  const size_t head0 = (size_t)b * H + (size_t)kh * G + g0;
  const int n = min(lengths[b], max_pages * pt);   // keys the slot has
  const int lo = split * pages_per_split * pt;
  const int hi = min(n, lo + pages_per_split * pt);
  if (hi <= lo) {  // past the slot's length: no key, no table read
    if (threadIdx.x < R) {
      part_m[(head0 + threadIdx.x) * nsplit + split] = -INFINITY;
      part_l[(head0 + threadIdx.x) * nsplit + split] = 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS)
    sq[i] = i < R * HD ? q[head0 * HD + i] * scale : 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = (lane % LPR) * EPL, kslot = lane / LPR;
  const int* trow = table + (size_t)b * max_pages;
  float m[ROWS], l[ROWS], acc[ROWS][EPL];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  // warp-uniform loop: every lane takes part in the shuffles
  for (int c0 = lo + warp * KPW; c0 < hi; c0 += NWARPS * KPW) {
    const int kpos = c0 + kslot;
    const bool valid = kpos < hi;
    float kf[EPL], vf[EPL];
    float ksc = 1.f, vsc = 1.f;
    if (valid) {
      const int pid = max(trow[kpos / pt], 0);
      const size_t off =
          (((size_t)pid * K + kh) * pt + kpos % pt) * HD + d0;
      load_row(kp + off, kf);
      load_row(vp + off, vf);
      if (ks != nullptr) {
        ksc = ks[(size_t)pid * K + kh];
        vsc = vs[(size_t)pid * K + kh];
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
    }
    float s[ROWS];
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(
            sq + g * HD + d0 + e);
        dot = fmaf(qv.x, kf[e], dot);
        dot = fmaf(qv.y, kf[e + 1], dot);
        dot = fmaf(qv.z, kf[e + 2], dot);
        dot = fmaf(qv.w, kf[e + 3], dot);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[g] = valid ? dot * ksc : NEG;
    }
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      if (g >= R) break;
      float mx = s[g];
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);     // finite: kslot 0 is valid
      const float corr = expf(m[g] - m_new);   // 0 while m is -inf
      const float p = valid ? expf(s[g] - m_new) : 0.f;
      l[g] = l[g] * corr + p;
      const float pv = p * vsc;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = fmaf(pv, vf[e], acc[g][e] * corr);
      m[g] = m_new;
    }
  }
  // sum each warp's key slots, then merge the warps once
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    if (lane < LPR) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) wacc[warp][g * HD + d0 + e] = acc[g][e];
    }
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, wm[w][g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      if (wm[w][g] == -INFINITY) continue;   // a warp that saw no key
      const float c = expf(wm[w][g] - mx);
      a = fmaf(wacc[w][i], c, a);
      lsum = fmaf(wl[w][g], c, lsum);
    }
    const size_t row = (head0 + g) * nsplit + split;
    part_acc[row * HD + d] = a;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = lsum;
    }
  }
}

template <typename PageT, int HD>
cudaError_t launch_hd(const float* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* table,
                      const int* lengths, float* out, float* pm, float* pl,
                      float* pa, int B, int H, int K, int pt, int max_pages,
                      int nsplit, int pps, cudaStream_t stream) {
  const int G = H / K;
  const dim3 grid(nsplit, B * K, (G + ROWS - 1) / ROWS);
  paged_decode_split<PageT, HD><<<grid, THREADS, 0, stream>>>(
      q, static_cast<const PageT*>(kp), static_cast<const PageT*>(vp), ks,
      vs, table, lengths, pm, pl, pa, H, K, pt, max_pages, pps,
      1.0f / sqrtf(static_cast<float>(HD)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_splits<void><<<B * H, 128, 0, stream>>>(pm, pl, pa, out, HD, nsplit);
  return cudaGetLastError();
}

template <typename PageT>
cudaError_t launch(int hd, const float* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, float* out, float* pm, float* pl,
                   float* pa, int B, int H, int K, int pt, int max_pages,
                   int nsplit, int pps, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_hd<PageT, 16>(q, kp, vp, ks, vs, table, lengths, out, pm,
                                  pl, pa, B, H, K, pt, max_pages, nsplit, pps,
                                  s);
    case 32:
      return launch_hd<PageT, 32>(q, kp, vp, ks, vs, table, lengths, out, pm,
                                  pl, pa, B, H, K, pt, max_pages, nsplit, pps,
                                  s);
    case 64:
      return launch_hd<PageT, 64>(q, kp, vp, ks, vs, table, lengths, out, pm,
                                  pl, pa, B, H, K, pt, max_pages, nsplit, pps,
                                  s);
    case 128:
      return launch_hd<PageT, 128>(q, kp, vp, ks, vs, table, lengths, out,
                                   pm, pl, pa, B, H, K, pt, max_pages, nsplit,
                                   pps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One-token attention over the page pool in `nsplit` splits of
// `pages_per_split` pages (nsplit * pages_per_split >= max_pages);
// part_ml holds 2 * B*H*nsplit floats, part_acc B*H*nsplit*hd. Returns a
// cudaError_t value: 0 on a launch that was accepted.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* lengths, void* out, void* part_ml,
                           void* part_acc, int B, int H, int K, int hd,
                           int pt, int max_pages, int nsplit,
                           int pages_per_split, int page_dtype,
                           void* stream) {
  if (B == 0) return cudaSuccess;
  if (K <= 0 || H % K || pt <= 0 || max_pages <= 0 || nsplit <= 0 ||
      pages_per_split <= 0 ||
      (long long)nsplit * pages_per_split < max_pages)
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  float* pm = static_cast<float*>(part_ml);
  float* pl = pm + (size_t)B * H * nsplit;
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case F32:
      return launch<float>(hd, qf, k_pages, v_pages, ks, vs, tbl, len, o, pm,
                           pl, pa, B, H, K, pt, max_pages, nsplit,
                           pages_per_split, s);
    case BF16:
      return launch<__nv_bfloat16>(hd, qf, k_pages, v_pages, ks, vs, tbl,
                                   len, o, pm, pl, pa, B, H, K, pt,
                                   max_pages, nsplit, pages_per_split, s);
    case F16:
      return launch<__half>(hd, qf, k_pages, v_pages, ks, vs, tbl, len, o,
                            pm, pl, pa, B, H, K, pt, max_pages, nsplit,
                            pages_per_split, s);
    case I8:
      return launch<int8_t>(hd, qf, k_pages, v_pages, ks, vs, tbl, len, o,
                            pm, pl, pa, B, H, K, pt, max_pages, nsplit,
                            pages_per_split, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
