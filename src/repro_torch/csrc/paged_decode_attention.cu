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
// 4*G*hd flops per key read, far below the ~295 flop/byte the card needs
// before its arithmetic becomes the limit.
//
// Design: one block per (slot b, kv-head k), so the page axis that was a
// sequential grid dimension on the TPU is a loop inside the block and the G
// query heads that share a kv head read each K/V page once. The loop runs
// only to ceil(len/pt), so -1 table entries are never read and a length-0
// slot reads nothing and writes zeros. Pages are staged through shared
// memory as f32 (int8 x scale dequantises there), scores and the online
// softmax stay in shared memory. This is the simple first version: no TMA,
// no wgmma, no split over the page axis (B*K blocks fill few of the 132 SMs
// at small batch; splitting the page walk is later work).
#include "paged_attention_common.cuh"

using namespace paged_attn;

namespace {

constexpr int THREADS = 128;

template <typename PageT>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const float* __restrict__ q,
                        const PageT* __restrict__ kp,
                        const PageT* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int H, int K, int hd, int pt,
                        int max_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int G = H / K, R = G;
  const Smem sm = carve(smem, R, pt, hd);
  const float* qb = q + ((size_t)b * H + (size_t)kh * G) * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    sm.q[r * (hd + 1) + d] = qb[i];
  }
  const int kv_len = lengths[b];
  for (int r = threadIdx.x; r < R; r += blockDim.x) sm.lim[r] = kv_len;
  init_state(sm, R, hd);
  const int n_pages = kv_len > 0 ? min((kv_len + pt - 1) / pt, max_pages) : 0;
  walk_pages(sm, kp, vp, ks, vs, table + (size_t)b * max_pages, n_pages, kh,
             K, R, pt, hd, scale);
  __syncthreads();
  float* ob = out + ((size_t)b * H + (size_t)kh * G) * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    ob[i] = sm.acc[i] / fmaxf(sm.l[r], 1e-30f);
  }
}

template <typename PageT>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, float* out, int B, int H, int K, int hd,
                   int pt, int max_pages, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = smem_bytes(G, pt, hd);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidConfiguration;
  auto kern = paged_decode_kernel<PageT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * K, THREADS, smem, stream>>>(
      q, static_cast<const PageT*>(kp), static_cast<const PageT*>(vp), ks, vs,
      table, lengths, out, H, K, hd, pt, max_pages,
      1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a launch that was accepted.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* lengths, void* out, int B, int H,
                           int K, int hd, int pt, int max_pages,
                           int page_dtype, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  switch (page_dtype) {
    case F32:
      return launch<float>(qf, k_pages, v_pages, ks, vs, tbl, len, o, B, H, K,
                           hd, pt, max_pages, s);
    case BF16:
      return launch<__nv_bfloat16>(qf, k_pages, v_pages, ks, vs, tbl, len, o,
                                   B, H, K, hd, pt, max_pages, s);
    case F16:
      return launch<__half>(qf, k_pages, v_pages, ks, vs, tbl, len, o, B, H,
                            K, hd, pt, max_pages, s);
    case I8:
      return launch<int8_t>(qf, k_pages, v_pages, ks, vs, tbl, len, o, B, H,
                            K, hd, pt, max_pages, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
