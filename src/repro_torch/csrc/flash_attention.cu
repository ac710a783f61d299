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
// end, in units of (block_q, block_k) - so the kernels take the reference's
// block sizes and exclude (probability 0) exactly the keys past that run
// limit, and past Lk.
//
// What bounds it on the H100: operations. 4*hd flops per visible (query,
// key) pair (q.k and p.v) against 989 TFLOP/s for bf16 inputs (67 TFLOP/s
// for f32); bytes (q, k, v, out once) are far below that at these shapes.
//
// Both kernels cut the key range to what can change the result: where every
// row of a tile sees a key, keys before the first row's window and after
// the last row's causal frontier are skipped (in the reference they get
// probability exp(NEG - m) = 0 exactly, or are wiped by a factor
// exp(NEG - m) = 0 once the row meets a key it sees); otherwise the tile
// walks every key below the run limit, as the reference does.
//
// Two kernels, chosen by the dtype:
//
// * bf16: flash_mma, tensor cores, in the FlashAttention-2 shape. A block
//   is 4 warps of 16 query rows each (on the H100, 64-row blocks ran faster
//   at every hd than 128-row ones, of 8 warps of 16 rows or of 4 warps of
//   32 rows whose K and V fragments fed two products). The block's
//   Q tile is staged once by 16-byte cp.async and each warp keeps its Q
//   fragments in registers (ldmatrix). K and V tiles of 64 keys are staged
//   as bf16 by 16-byte cp.async into a ring of STAGES buffers, the
//   next tiles in flight while the tensor cores work on this one, one block
//   barrier a tile, rows padded by 16 bytes so that
//   ldmatrix is free of bank conflicts; keys at or past the block's end of
//   range are zero-filled (cp.async of 0 source bytes), so a masked
//   probability meets V = 0 and never stale shared memory. S = Q K^T is
//   mma.sync.m16n8k16 bf16 with f32 accumulators: q and k are exact in
//   bf16, so the products are exact and only the order of the f32 sum
//   differs from the reference's f32 dot. Scale, softcap (tanhf), mask and
//   the online softmax run in the accumulator layout, in registers, with
//   the logits in log2 units (exp(s - m) as exp2f of s log2(e) - m log2(e));
//   a tile whose every key every row of the warp sees skips the mask. P is
//   f32 and not exact in bf16: it is fed to P.V as a hi + lo pair of bf16
//   values, two mma.sync into one f32 accumulator (one bf16 rounding of P
//   would move a short row by ~4e-3), with V fragments from ldmatrix.trans.
//   A warp skips the tiles wholly outside its own 16 rows' range (under the
//   same every-row-sees-a-key rule). The output goes through shared memory
//   and leaves in 16-byte stores. Blocks take the query tiles last first,
//   so that under a causal mask the longest start first.
// * f32: flash_kernel, CUDA cores, the first design, kept because
//   f32 inputs are not exact in bf16 (hd 16, 32, 64 and 128; the
//   tensor-core kernel takes hd 32, 64 and 128). One block per (64-row query tile,
//   batch x head), 256 threads, a loop over 64-key tiles inside. Q, K and V
//   tiles are staged as f32 in shared memory (16-byte loads); each thread
//   computes a 4 x 4 register tile of the logits from float4 reads (row
//   pitch hd + 4: conflict-free), a warp per row runs the online softmax,
//   and each thread keeps a 4-row x hd/16-column slice of the output in
//   registers across the key loop.
//
// Launch shapes come from host ints only (L, hd, the dtype), so a call can
// be captured in a CUDA graph; each instance opts into more than 48 KB of
// shared memory once, on its first (eager) call.
#include "paged_attention_common.cuh"

// the shared header's constants, dtype ids and helpers (not its masking rule)
using paged_attn::BF16;
using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::F32;
using paged_attn::from_f32;
using paged_attn::ldmatrix_x4;
using paged_attn::ldmatrix_x4_trans;
using paged_attn::MAX_SMEM;
using paged_attn::Mma;
using paged_attn::NEG;
using paged_attn::smem_addr;
using paged_attn::to_f32;
using paged_attn::warp_max;
using paged_attn::warp_sum;

namespace {

// ---------------------------------------------------------------------------
// the mask, and f32: CUDA cores
// ---------------------------------------------------------------------------
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
  // every row of [q0, last] sees a key (the rule is monotone in qpos)
  __device__ bool trims(int q0, int last) const {
    return sees_a_key(q0) && sees_a_key(last);
  }
  // [begin, end) of the keys rows [q0, last] walk: cut to the window and
  // the causal frontier when `trim`, else every key below the run limit
  __device__ void key_range(int q0, int last, bool trim, int& begin,
                            int& end) const {
    begin = 0;
    end = run_limit(last);
    if (!trim) return;
    if (has_window) begin = max(0, q0 - window + 1) / 64 * 64;
    if (causal) end = min(Lk, last + 1);
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
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, const Mask mk) {
  constexpr int LD = HD + 4;               // q / k row pitch (floats)
  constexpr int VW = HD >= 64 ? 4 : HD >= 32 ? 2 : 1;  // output columns a
                                                       // vector
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
  int k_begin, k_end;
  mk.key_range(q0, last, mk.trims(q0, last), k_begin, k_end);
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_BK = 64;            // keys of a K / V tile

constexpr int MMA_ROWS = 64;          // query rows of a block: 4 warps x 16
constexpr int MMA_THREADS = 128;

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }  // row pitch

// K / V tiles in flight: tile t + STAGES - 1 loads while tile t computes
// (on the H100 three or four stages ran no faster than two)
constexpr int STAGES = 2;

// Q tile [64][LD], then K and V x STAGES buffers [64][LD], bf16
template <int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)(MMA_ROWS + 2 * STAGES * MMA_BK) * mma_ld<HD>() * 2;
}

using bf16 = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              const Mask mask) {
  const Mask mk = mask;                  // in registers, not param space
  constexpr int LD = mma_ld<HD>();
  constexpr int KS = HD / 16;            // k-steps of Q.K^T
  constexpr int NV = HD / 8;             // 8-wide blocks of the output
  constexpr int CPR = HD / 8;            // 16-byte chunks per row
  constexpr int ROWS = MMA_ROWS, THREADS_ = MMA_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);     // [ROWS][LD]
  bf16* sk = sq + ROWS * LD;                        // [STAGES][MMA_BK][LD]
  bf16* sv = sk + STAGES * MMA_BK * LD;             // [STAGES][MMA_BK][LD]

  // the last query tiles (under a causal mask, the longest) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const size_t bh = blockIdx.y;
  const int rows = min(ROWS, mk.L - q0);
  const int last = q0 + rows - 1;
  const bf16* kb = k + bh * (size_t)mk.Lk * HD;
  const bf16* vb = v + bh * (size_t)mk.Lk * HD;
  const bf16* qb = q + (bh * mk.L + q0) * HD;
  const bool trim = mk.trims(q0, last);
  int k_begin, k_end;
  mk.key_range(q0, last, trim, k_begin, k_end);
  const int ntiles = (k_end - k_begin + MMA_BK - 1) / MMA_BK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid4 = lane & 3;
  const int wq0 = q0 + warp * 16, wlast = min(wq0 + 15, last);
  const bool has_rows = wq0 <= last;
  int w_begin = k_begin, w_end = k_end;   // this warp's keys
  if (trim && has_rows) mk.key_range(wq0, wlast, true, w_begin, w_end);
  const int qa = wq0 + gid, qb_ = qa + 8;
  const int lim_a = mk.run_limit(qa), lim_b = mk.run_limit(qb_);
  // a tile whose every key every row of the warp sees needs no mask: keys
  // [k0, k0 + 64) below the first row's run limit, its causal frontier,
  // and past the last row's window
  const int open_end = min(mk.run_limit(wq0), mk.causal ? wq0 + 1 : mk.Lk);
  const int open_begin = mk.has_window ? wlast - mk.window + 1 : 0;
  // logits in log2 units: p = exp2(s log2(e) - m) = exp(s - m / log2(e))
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale2 = mk.scale * LOG2E;

  // the Q tile (rows past L zero), in the first cp.async group
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS_) {
    const int r = i / CPR, ch = i - r * CPR;
    const uint32_t dst = smem_addr(sq + r * LD + ch * 8);
    if (r < rows) cp_async16(dst, qb + (size_t)r * HD + ch * 8, 16);
    else cp_async16(dst, q, 0);
  }
  // stage key tile t into buffer `buf`: keys at or past k_end are zeros
  auto load_tile = [&](int t, int buf) {
    const int k0 = k_begin + t * MMA_BK;
    const uint32_t dk = smem_addr(sk + buf * MMA_BK * LD);
    const uint32_t dv = smem_addr(sv + buf * MMA_BK * LD);
    for (int i = threadIdx.x; i < MMA_BK * CPR; i += THREADS_) {
      const int key = i / CPR, ch = i - key * CPR;
      const uint32_t off = (uint32_t)(key * LD + ch * 8) * sizeof(bf16);
      if (k0 + key < k_end) {
        const size_t src = (size_t)(k0 + key) * HD + ch * 8;
        cp_async16(dk + off, kb + src, 16);
        cp_async16(dv + off, vb + src, 16);
      } else {
        cp_async16(dk + off, kb, 0);
        cp_async16(dv + off, vb, 0);
      }
    }
  };

  uint32_t qf[KS][4];
  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // one cp.async group per tile (empty past the last), the Q tile in the
  // first: tile t has landed when at most STAGES - 2 groups are pending
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + STAGES - 1 < ntiles)    // into the buffer tile t - 1 held
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    if (t == 0) {   // Q fragments (A operand, 16 x HD), kept in registers
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], smem_addr(sq + (warp * 16 + (lane & 15)) * LD +
                                      ks * 16 + (lane >> 4) * 8));
    }
    const int k0 = k_begin + t * MMA_BK;
    if (has_rows && k0 < w_end && k0 + MMA_BK > w_begin) {
      const bf16* kt = sk + (t % STAGES) * MMA_BK * LD;
      const bf16* vt = sv + (t % STAGES) * MMA_BK * LD;
      // S = Q K^T: 8 blocks of 8 keys, two at a time from one ldmatrix.x4
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int mat = lane >> 3;
          const int key = np * 16 + (mat >> 1) * 8 + (lane & 7);
          const int dim = ks * 16 + (mat & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(kt + key * LD + dim));
          Mma<bf16>::mma(s[2 * np], qf[ks], b[0], b[1]);
          Mma<bf16>::mma(s[2 * np + 1], qf[ks], b[2], b[3]);
        }
      }
      // scale, softcap, mask, in log2 units; c0, c1 belong to row a, c2,
      // c3 to row b
      const bool open = k0 >= open_begin && k0 + MMA_BK <= open_end;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x;
          if (mk.softcap != 0.f) {
            x = tanhf(s[j][i] * mk.scale / mk.softcap) * mk.softcap * LOG2E;
          } else {
            x = s[j][i] * scale2;
          }
          if (!open) {
            const int kpos = k0 + j * 8 + tid4 * 2 + (i & 1);
            if (kpos >= (i < 2 ? lim_a : lim_b))
              x = -INFINITY;                // not in a block the row runs
            else if (!mk.visible(i < 2 ? qa : qb_, kpos))
              x = NEG * LOG2E;
          }
          s[j][i] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float corr_a = exp2f(m_a - mu_a), corr_b = exp2f(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mu_a);
        s[j][1] = exp2f(s[j][1] - mu_a);
        s[j][2] = exp2f(s[j][2] - mu_b);
        s[j][3] = exp2f(s[j][3] - mu_b);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        o[j][0] *= corr_a;
        o[j][1] *= corr_a;
        o[j][2] *= corr_b;
        o[j][3] *= corr_b;
      }
      // O += P V: P re-packed from the S accumulators (hi + lo), V through
      // ldmatrix.trans, 16 keys by 16 features at a time
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        Mma<bf16>::split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        Mma<bf16>::split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        Mma<bf16>::split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        Mma<bf16>::split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < NV / 2; ++dp) {
          const int mat = lane >> 3;
          const int key = kk * 16 + (mat & 1) * 8 + (lane & 7);
          const int dim = dp * 16 + (mat >> 1) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vt + key * LD + dim));
          Mma<bf16>::mma(o[2 * dp], ph, b[0], b[1]);
          Mma<bf16>::mma(o[2 * dp], pl, b[0], b[1]);
          Mma<bf16>::mma(o[2 * dp + 1], ph, b[2], b[3]);
          Mma<bf16>::mma(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();     // the Q tile's rows take the output below

  // out = o / l, through this warp's rows of the Q tile
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  bf16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = j * 8 + tid4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(so + gid * LD + col) =
        __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(so + (gid + 8) * LD + col) =
        __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
  }
  __syncwarp();
  bf16* ob = out + (bh * mk.L + wq0) * HD;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, ch = i - r * CPR;
    if (wq0 + r <= last)
      *reinterpret_cast<uint4*>(ob + (size_t)r * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// Opt kernel `kern` into `smem` bytes of dynamic shared memory once (a
// static per instance, so later launches can be captured in a CUDA graph).
template <class Kern>
cudaError_t opt_in(Kern kern, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = e == cudaSuccess;
  return e;
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int BH, const Mask& mk, size_t smem,
                       cudaStream_t stream) {
  static_assert(smem_bytes<HD>() <= (size_t)MAX_SMEM, "tile past smem");
  if (smem != smem_bytes<HD>()) return cudaErrorInvalidValue;
  auto kern = flash_kernel<float, HD>;
  static bool opted_in = false;
  cudaError_t e = opt_in(kern, smem, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid((mk.L + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), mk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int BH, const Mask& mk, size_t smem,
                       cudaStream_t stream) {
  static_assert(mma_smem_bytes<HD>() <= (size_t)MAX_SMEM, "past smem");
  if (smem != mma_smem_bytes<HD>()) return cudaErrorInvalidValue;
  auto kern = flash_mma<HD>;
  static bool opted_in = false;
  cudaError_t e = opt_in(kern, smem, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid((mk.L + MMA_ROWS - 1) / MMA_ROWS, BH);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), mk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* out, int BH, const Mask& mk, int dtype,
                        int rows, size_t smem, cudaStream_t s) {
  if (dtype == F32 && rows == BQ)
    return launch_f32<HD>(q, k, v, out, BH, mk, smem, s);
  if (dtype == BF16 && rows == MMA_ROWS)
    return launch_mma<HD>(q, k, v, out, BH, mk, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Attention of q [BH, L, hd] over k/v [BH, Lk, hd]. block_q / block_k are
// the reference's block sizes (they decide which keys a row that sees none
// averages); softcap 0 means none. `rows` (query rows per block) and `smem`
// (dynamic shared memory bytes) are the launch the wrapper computed from
// host ints (flash_attention.launch_shape); a pair this source does not
// build is refused. Returns a cudaError_t value: 0 on a launch that was
// accepted.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int BH, int L, int Lk, int hd, int causal, int has_window,
                    int window, int block_q, int block_k, int dtype, int rows,
                    int smem, float softcap, void* stream) {
  if (BH == 0 || L == 0) return cudaSuccess;
  if (Lk <= 0 || block_q <= 0 || block_k <= 0 || BH > 65535 || smem < 0)
    return cudaErrorInvalidValue;
  const Mask mk{L, Lk, causal, has_window, window, block_q, block_k,
                1.0f / sqrtf(static_cast<float>(hd)), softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:   // f32 only (the smoke configurations' width)
      if (dtype != F32 || rows != BQ) return cudaErrorInvalidValue;
      return launch_f32<16>(q, k, v, out, BH, mk, smem, s);
    case 32: return dispatch_hd<32>(q, k, v, out, BH, mk, dtype, rows, smem, s);
    case 64: return dispatch_hd<64>(q, k, v, out, BH, mk, dtype, rows, smem, s);
    case 128:
      return dispatch_hd<128>(q, k, v, out, BH, mk, dtype, rows, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
