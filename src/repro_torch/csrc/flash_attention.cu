// Dense flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:55 flash_attention (the
// Pallas TPU kernel, grid (B*H, L/block_q, Lk/block_k) with the key axis a
// sequential grid dimension carrying (m, l, acc) in VMEM scratch; causal
// block skip; pallas_call :129).
//
// Computes out = softmax(mask(cap(q k^T / sqrt(hd)))) v per (batch, head) for
// q [B*H, L, hd], k/v [B*H, Lk, hd] (one dtype, f32 or bf16; out in it),
// with the reference's masking exactly (flash_attention.py:84-101):
// softcap s = tanh(s / c) * c before the mask, when c != 0; the mask
// keeps kpos <= qpos when causal and kpos > qpos - window when a window is
// given (causal or not); masked logits are NEG = -1e30 and their
// probabilities are not zeroed. A row that sees a key ends as the softmax
// over the keys it sees. A row that sees none (a window past the end of a
// shorter key sequence) ends, in the reference, as the mean of V over the
// keys of the blocks it ran - for causal, the k blocks up to its q block's
// end, in units of (block_q, block_k) - so the kernel takes the reference's
// block sizes and excludes (probability 0) exactly the keys past that
// run limit, and past Lk.
//
// What bounds it on the H100: operations. 4*hd flops per visible (query,
// key) pair (q.k and p.v) against 989 TFLOP/s for bf16 inputs (67 TFLOP/s
// for f32); bytes (q, k, v, out once) are far below that at these shapes.
//
// Design: one block per (64-row query tile, batch x head), 256 threads, a
// loop over 64-key tiles inside (the TPU's sequential grid axis). Q, K and
// V tiles are staged as f32 in shared memory (16-byte loads); each thread
// computes a 4 x 4 register tile of the logits from float4 reads (row
// pitch hd + 4: conflict-free), a warp per row runs the online softmax, and
// each thread keeps a 4-row x hd/16-column slice of the output in
// registers across the key loop. The key range is cut to what can change
// the result: where every row of the tile sees a key, keys before the
// first row's window and after the last row's causal frontier are skipped
// (in the reference they get probability exp(NEG - m) = 0 exactly, or are
// wiped by a factor exp(NEG - m) = 0); otherwise the tile walks every key
// below the run limit, as the reference does. Products run on CUDA cores
// in f32 (no mma / wgmma yet): a first, simple version, far from the
// tensor cores' rate.
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

constexpr int BQ = 64, BK = 64;      // query rows and keys of a tile
constexpr int THREADS = 256;         // 16 x 16: 4 x 4 logits each
constexpr int LDS = BK + 4;          // logit row pitch (floats)

// The reference's mask and block structure, for one call.
struct Mask {
  int L, Lk, causal, has_window, window, block_q, block_k;
  float scale, softcap;

  // keys of the k blocks the reference runs for query position qpos
  __device__ int run_limit(int qpos) const {
    if (!causal) return Lk;
    const int qend = (qpos / block_q) * block_q + block_q - 1;
    return min(Lk, (qend / block_k + 1) * block_k);
  }
  __device__ bool visible(int qpos, int kpos) const {
    return (!causal || kpos <= qpos) && (!has_window || kpos > qpos - window);
  }
  __device__ bool sees_a_key(int qpos) const {
    const int lo = has_window ? max(0, qpos - window + 1) : 0;
    const int hi = causal ? min(qpos, Lk - 1) : Lk - 1;
    return lo <= hi;
  }
};

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return ((size_t)(BQ + BK) * (HD + 4) + (size_t)BK * HD + (size_t)BQ * LDS +
          3 * (size_t)BQ) * sizeof(float) + (size_t)BQ * sizeof(int);
}

// Stage rows [0, n) of `rows` rows of HD elements contiguous at `src`
// (16-byte aligned) as f32 rows of pitch ld; rows n.. are zero.
template <typename T, int HD>
__device__ inline void stage(const T* __restrict__ src, int n, int rows,
                             float* dst, int ld) {
  constexpr int V = 16 / sizeof(T), PER = HD / V;
  for (int i = threadIdx.x; i < rows * PER; i += blockDim.x) {
    const int t = i / PER, d = (i - t * PER) * V;
    float* o = dst + t * ld + d;
    if (t < n) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)t * HD + d);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = to_f32(x[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = 0.f;
    }
  }
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, const Mask mk) {
  constexpr int LD = HD + 4;               // q / k row pitch (floats)
  constexpr int VW = HD >= 64 ? 4 : 2;     // output columns per vector
  constexpr int NV = HD / (16 * VW);       // vectors per thread and row
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                        // [BQ][LD]
  float* sk = sq + BQ * LD;                // [BK][LD]
  float* sv = sk + BK * LD;                // [BK][HD]
  float* ss = sv + BK * HD;                // [BQ][LDS] logits, then p
  float* sm = ss + BQ * LDS;               // [BQ] running max
  float* sl = sm + BQ;                     // [BQ] running sum
  float* sc = sl + BQ;                     // [BQ] rescale of this tile
  int* slim = reinterpret_cast<int*>(sc + BQ);   // [BQ] run limit

  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const int rows = min(BQ, mk.L - q0);
  const T* kb = k + bh * (size_t)mk.Lk * HD;
  const T* vb = v + bh * (size_t)mk.Lk * HD;
  stage<T, HD>(q + (bh * mk.L + q0) * HD, rows, BQ, sq, LD);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    sm[r] = -INFINITY;
    sl[r] = 0.f;
    slim[r] = mk.run_limit(q0 + r);
  }
  const int last = q0 + rows - 1;
  int k_begin = 0, k_end = mk.run_limit(last);
  if (mk.sees_a_key(q0) && mk.sees_a_key(last)) {
    if (mk.has_window) k_begin = max(0, q0 - mk.window + 1) / BK * BK;
    if (mk.causal) k_end = min(mk.Lk, last + 1);
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float o[4][NV][VW] = {};
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, mk.Lk - k0);
    stage<T, HD>(kb + (size_t)k0 * HD, nk, BK, sk, LD);
    stage<T, HD>(vb + (size_t)k0 * HD, nk, BK, sv, HD);
    __syncthreads();
    // logits: rows 4*ty + i, keys tx + 16*j
    float s[4][4] = {};
    for (int d = 0; d < HD; d += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(sq + (4 * ty + i) * LD + d, a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_vec(sk + (tx + 16 * j) * LD + d, b[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, qpos = q0 + r, lim = slim[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x;
        if (kpos >= lim) {
          x = -INFINITY;                    // not in a block the row runs
        } else if (!mk.visible(qpos, kpos)) {
          x = NEG;
        } else {
          x = s[i][j] * mk.scale;
          if (mk.softcap != 0.f) x = tanhf(x / mk.softcap) * mk.softcap;
        }
        ss[r * LDS + tx + 16 * j] = x;
      }
    }
    __syncthreads();
    // online softmax, a warp per row
    for (int r = warp; r < BQ; r += THREADS / 32) {
      float* sr = ss + r * LDS;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(s0 - mu), p1 = expf(s1 - mu);
      const float psum = warp_sum(p0 + p1);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) {
        const float c = expf(m_prev - mu);   // 0 while m_prev is -inf
        sl[r] = sl[r] * c + psum;
        sm[r] = m_new;
        sc[r] = c;
      }
    }
    __syncthreads();
    // out = out * c + p . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sc[4 * ty + i];
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VW; ++e) o[i][n][e] *= c;
    }
    for (int t = 0; t < BK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(4 * ty + i) * LDS + t];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float vv[VW];
        load_vec(sv + t * HD + n * 16 * VW + tx * VW, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e) o[i][n][e] = fmaf(p[i], vv[e], o[i][n][e]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(sl[r], 1e-30f);
    T* orow = out + (bh * mk.L + q0 + r) * HD;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[n * 16 * VW + tx * VW + e] = from_f32<T>(o[i][n][e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, const Mask& mk, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= (size_t)MAX_SMEM, "flash tile past shared memory");
  auto kern = flash_kernel<T, HD>;
  static bool opted_in = false;  // set once, so launches can be graphed
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((mk.L + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), mk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int BH, int hd, const Mask& mk, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, BH, mk, s);
    case 64: return launch<T, 64>(q, k, v, out, BH, mk, s);
    case 128: return launch<T, 128>(q, k, v, out, BH, mk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Attention of q [BH, L, hd] over k/v [BH, Lk, hd]. block_q / block_k are
// the reference's block sizes (they decide which keys a row that sees none
// averages); softcap 0 means none. Returns a cudaError_t value: 0 on a
// launch that was accepted.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int BH, int L, int Lk, int hd, int causal, int has_window,
                    int window, int block_q, int block_k, int dtype,
                    float softcap, void* stream) {
  if (BH == 0 || L == 0) return cudaSuccess;
  if (Lk <= 0 || block_q <= 0 || block_k <= 0 || BH > 65535)
    return cudaErrorInvalidValue;
  const Mask mk{L, Lk, causal, has_window, window, block_q, block_k,
                1.0f / sqrtf(static_cast<float>(hd)), softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return dispatch<float>(q, k, v, out, BH, hd, mk, s);
    case BF16: return dispatch<__nv_bfloat16>(q, k, v, out, BH, hd, mk, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
