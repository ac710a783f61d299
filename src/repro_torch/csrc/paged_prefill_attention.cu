// Paged flash-prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_prefill_attention.py, paged_flash_prefill
// (the Pallas TPU kernel, grid (K, max_pages) over C*G flattened query rows,
// the page axis a sequential grid dimension carrying (m, l, acc) scratch).
//
// Computes a chunk of C queries of one sequence, at global positions
// start .. start+C-1, against the sequence's paged prefix (the chunk's own
// K/V already scattered in): query row r (chunk position c = r / G, head
// h = k*G + r % G) sees key positions kpos <= start + c. q [C, H, hd] f32,
// k/v_pages [P, K, pt, hd] (bf16, f16, f32, or int8 with f32 [P, K] scales),
// page_table [max_pages], out [C, H, hd] f32.
//
// What bounds it on the H100: device-memory bytes for short chunks (each
// block reads K*ceil((start+C)/pt)*pt*hd*2*itemsize bytes of pages and little
// else); at C = 256 the score and p*V work, 4*C*H*hd flops per key, grows to
// the point where CUDA-core arithmetic (no tensor cores in this version)
// takes over.
//
// Design: one block per (kv-head k, tile of R <= 64 of the C*G query rows),
// so every page a block reads serves R rows; the page walk is a loop inside
// the block that stops at the tile's causal frontier, ceil((start + c_last
// + 1) / pt) pages, so later tiles read more pages than earlier ones and no
// page past the frontier is read. `start` is a host int: the scheduler
// knows it. Pages are staged as f32 in shared memory (int8 x scale
// dequantises there). wgmma, TMA and a split over pages are later work.
#include "paged_attention_common.cuh"

using namespace paged_attn;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;

template <typename PageT>
__global__ void __launch_bounds__(THREADS)
    paged_prefill_kernel(const float* __restrict__ q,
                         const PageT* __restrict__ kp,
                         const PageT* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         float* __restrict__ out, int C, int H, int K, int hd,
                         int pt, int max_pages, int start, int rows,
                         float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x, G = H / K;
  const int r0 = blockIdx.y * rows;
  const int R = min(rows, C * G - r0);
  const Smem sm = carve(smem, rows, pt, hd);
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int rr = r0 + r, c = rr / G, g = rr - c * G;
    sm.q[r * (hd + 1) + d] = q[((size_t)c * H + (size_t)kh * G + g) * hd + d];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    sm.lim[r] = start + (r0 + r) / G + 1;
  init_state(sm, R, hd);
  const int frontier = start + (r0 + R - 1) / G + 1;   // keys the tile needs
  const int n_pages = min((frontier + pt - 1) / pt, max_pages);
  walk_pages(sm, kp, vp, ks, vs, table, n_pages, kh, K, R, pt, hd, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int rr = r0 + r, c = rr / G, g = rr - c * G;
    out[((size_t)c * H + (size_t)kh * G + g) * hd + d] =
        sm.acc[i] / fmaxf(sm.l[r], 1e-30f);
  }
}

template <typename PageT>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   float* out, int C, int H, int K, int hd, int pt,
                   int max_pages, int start, cudaStream_t stream) {
  const int G = H / K;
  const int rows = min(ROWS, C * G);
  const size_t smem = smem_bytes(rows, pt, hd);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidConfiguration;
  auto kern = paged_prefill_kernel<PageT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(K, (C * G + rows - 1) / rows);
  kern<<<grid, THREADS, smem, stream>>>(
      q, static_cast<const PageT*>(kp), static_cast<const PageT*>(vp), ks, vs,
      table, out, C, H, K, hd, pt, max_pages, start, rows,
      1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a launch that was accepted.
int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* page_table,
                            void* out, int C, int H, int K, int hd, int pt,
                            int max_pages, int start, int page_dtype,
                            void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(page_table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return cudaSuccess;
  switch (page_dtype) {
    case F32:
      return launch<float>(qf, k_pages, v_pages, ks, vs, tbl, o, C, H, K, hd,
                           pt, max_pages, start, s);
    case BF16:
      return launch<__nv_bfloat16>(qf, k_pages, v_pages, ks, vs, tbl, o, C, H,
                                   K, hd, pt, max_pages, start, s);
    case F16:
      return launch<__half>(qf, k_pages, v_pages, ks, vs, tbl, o, C, H, K, hd,
                            pt, max_pages, start, s);
    case I8:
      return launch<int8_t>(qf, k_pages, v_pages, ks, vs, tbl, o, C, H, K, hd,
                            pt, max_pages, start, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_prefill_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
