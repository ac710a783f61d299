// Dense flash-decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py:26 flash_decode (the
// Pallas TPU kernel, grid (B*K, S/block_k) with the key axis a sequential
// grid dimension carrying (m, l, acc) in VMEM scratch; pallas_call :85).
//
// Computes one-token GQA attention of q [B, H, hd] over a dense cache
// k/v [B, K, S, hd] (q, k, v f32 or bf16, one dtype): query head h = k*G + g
// of slot b attends key positions < lengths[b]; out [B, H, hd] in q's dtype.
// The numeric contract is the reference's, which differs from the paged
// kernels': masked logits are NEG = -1e30 and their probabilities are NOT
// zeroed, so a slot of length 0 (all keys masked) weighs all S positions
// equally and returns the mean of V over the whole cache, as the Pallas
// kernel and its oracle do. The paged kernels' header zeroes masked
// probabilities instead; only its constants, warp reductions and dtype
// conversions are shared here.
//
// What bounds it on the H100: device-memory bytes. The keys and values a
// slot needs are read once (K*len*hd*2*itemsize bytes per slot; V over all
// S for a length-0 slot) and each costs 4*G*hd flops, far below the ~295
// flop/byte the card needs before arithmetic limits it.
//
// Design: split-K ("flash decoding"). The key axis that was a sequential
// grid dimension on the TPU is cut into `chunk`-key splits, one block per
// (split, slot x kv head), so that B*K = 16 (slot, kv head) pairs still
// give a few hundred blocks on 132 SMs. A block stages its G query rows
// once and 64-key tiles of K and V as f32 in shared memory (16-byte loads),
// and keeps an online softmax for its G rows (logits one thread per (row,
// key), a warp per row for max and sum, p.V one thread per (row, feature)).
// It stops at min(split end, length): positions past a nonzero length
// would get probability exp(NEG - m) = 0 exactly, so they are not read; a
// length-0 slot reads no K (every logit is NEG) and all of V. Each block
// writes its (m, l, acc) partials; a second kernel merges the splits of
// each (slot, head) with the usual rescaling, exp(m_j - max_j m_j), and
// divides by max(l, 1e-30). The reference's block_k does not reach the
// kernel: only the sums' order depends on it.
#include "paged_attention_common.cuh"

// the shared header's constants, dtype ids and helpers (not its masking rule)
using paged_attn::BF16;
using paged_attn::F32;
using paged_attn::from_f32;
using paged_attn::MAX_SMEM;
using paged_attn::NEG;
using paged_attn::to_f32;
using paged_attn::warp_max;
using paged_attn::warp_sum;

namespace {

constexpr int THREADS = 128;
constexpr int TK = 64;             // keys staged per tile

__host__ __device__ inline size_t split_smem_bytes(int G, int hd) {
  const size_t floats = (size_t)G * (hd + 1) + (size_t)TK * (hd + 1) +
                        (size_t)TK * hd + (size_t)G * TK + (size_t)G * hd +
                        3 * (size_t)G;
  return floats * sizeof(float);
}

// Stage `rows` rows of hd elements, contiguous at `src` (16-byte aligned,
// hd a multiple of 16), as f32 rows of pitch `ld`.
template <typename T>
__device__ inline void stage(const T* __restrict__ src, int rows, int hd,
                             float* dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int nv = rows * hd / V;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int e = i * V, t = e / hd, d = e - t * hd;
    const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) dst[t * ld + d + j] = to_f32(x[j]);
  }
}

// One block: split blockIdx.x of slot x kv head blockIdx.y. Partials go to
// part_m / part_l [B*H][nsplit] and part_acc [B*H][nsplit][hd].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l,
                        float* __restrict__ part_acc, int H, int K, int S,
                        int hd, int chunk, float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  float* sq = smem;                       // [G, hd + 1]
  float* sk = sq + G * (hd + 1);          // [TK, hd + 1]
  float* sv = sk + TK * (hd + 1);         // [TK, hd]
  float* ss = sv + TK * hd;               // [G, TK] logits, then p
  float* acc = ss + G * TK;               // [G, hd]
  float* m = acc + G * hd;                // [G]
  float* l = m + G;                       // [G]
  float* corr = l + G;                    // [G]
  const int len = lengths[b];
  const int lo = split * chunk, end = min(S, lo + chunk);
  const int hi = len > 0 ? min(end, len) : end;   // positions this block reads
  const size_t head0 = (size_t)b * H + (size_t)kh * G;   // first query head
  if (hi <= lo) {  // past the slot's length: contributes nothing
    for (int i = threadIdx.x; i < G; i += blockDim.x) {
      part_m[(head0 + i) * nsplit + split] = -INFINITY;
      part_l[(head0 + i) * nsplit + split] = 0.f;
    }
    for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      part_acc[((head0 + g) * nsplit + split) * hd + d] = 0.f;
    }
    return;
  }
  if (len > 0) stage(q + head0 * hd, G, hd, sq, hd + 1);
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const size_t kv0 = ((size_t)b * K + kh) * (size_t)S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t0 = lo; t0 < hi; t0 += TK) {
    const int n = min(TK, hi - t0);
    if (len > 0) stage(k + (kv0 + t0) * hd, n, hd, sk, hd + 1);
    stage(v + (kv0 + t0) * hd, n, hd, sv, hd);
    __syncthreads();
    // logits: every position of a length-0 slot is masked
    for (int i = threadIdx.x; i < G * n; i += blockDim.x) {
      const int g = i / n, t = i - g * n;
      float s = NEG;
      if (len > 0) {
        const float* qr = sq + g * (hd + 1);
        const float* kr = sk + t * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      ss[g * TK + t] = s;
    }
    __syncthreads();
    // online softmax, a warp per query row; masked logits are not zeroed
    for (int g = warp; g < G; g += nwarps) {
      float* sr = ss + g * TK;
      const float s0 = lane < n ? sr[lane] : -INFINITY;
      const float s1 = lane + 32 < n ? sr[lane + 32] : -INFINITY;
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));  // finite
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      if (lane < n) sr[lane] = p0;
      if (lane + 32 < n) sr[lane + 32] = p1;
      if (lane == 0) {
        const float c = expf(m_prev - m_new);  // 0 while m_prev is -inf
        l[g] = l[g] * c + psum;
        m[g] = m_new;
        corr[g] = c;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      const float* pr = ss + g * TK;
      float a = acc[i] * corr[g];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], sv[t * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    part_m[(head0 + g) * nsplit + split] = m[g];
    part_l[(head0 + g) * nsplit + split] = l[g];
  }
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    part_acc[((head0 + g) * nsplit + split) * hd + d] = acc[i];
  }
}

// Merge the splits of one (slot, query head): blockIdx.x = b*H + h.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_combine_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          T* __restrict__ out, int hd, int nsplit) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  float mx = -INFINITY;
  for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, pm[j]);  // split 0: finite
  float l = 0.f;
  for (int j = 0; j < nsplit; ++j) l += pl[j] * expf(pm[j] - mx);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < nsplit; ++j)
      a += part_acc[(bh * nsplit + j) * hd + d] * expf(pm[j] - mx);
    out[bh * hd + d] = from_f32<T>(a * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_m,
                   float* part_l, float* part_acc, int B, int H, int K, int S,
                   int hd, int nsplit, int chunk, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = split_smem_bytes(G, hd);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidConfiguration;
  auto split = decode_split_kernel<T>;
  static size_t opted_in = 48 * 1024;  // set once, so launches can be graphed
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  split<<<dim3(nsplit, B * K), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_m, part_l, part_acc, H, K, S,
      hd, chunk, 1.0f / sqrtf(static_cast<float>(hd)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<B * H, THREADS, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), hd, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One-token attention of q [B, H, hd] over k/v [B, K, S, hd] in `nsplit`
// splits of `chunk` keys (chunk a multiple of 64, nsplit * chunk >= S);
// part_ml holds 2 * B*H*nsplit floats, part_acc B*H*nsplit*hd. Returns a
// cudaError_t value: 0 on a launch that was accepted.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* part_ml,
                     void* part_acc, int B, int H, int K, int S, int hd,
                     int nsplit, int chunk, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (K <= 0 || H % K || S <= 0 || nsplit <= 0 || chunk % TK ||
      (long long)nsplit * chunk < S || hd <= 0 || hd % 16)
    return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_ml);
  float* pl = pm + (size_t)B * H * nsplit;
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch<float>(q, k, v, len, out, pm, pl, pa, B, H, K, S, hd,
                           nsplit, chunk, s);
    case BF16:
      return launch<__nv_bfloat16>(q, k, v, len, out, pm, pl, pa, B, H, K, S,
                                   hd, nsplit, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
