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
// What bounds it on the H100: at C = 256 the products, 4*C*H*hd flops per
// visible key (1.494 GFLOP at start 1500), which at the bf16 tensor-core
// rate take 0.0015 ms against 0.0008 ms for the bytes; short chunks are
// bound by the bytes of the pages.
//
// Two kernels, chosen by the page dtype:
//
// * bf16 / f16 pages: paged_prefill_mma, tensor cores. A block owns 64 of
//   the C*G query rows of one kv head, 16 per warp, in the FlashAttention-2
//   shape: Q.K^T and P.V are mma.sync.m16n8k16 with f32 accumulators, K and
//   V fragments come from shared memory through ldmatrix (V transposed), the
//   row max and sum stay in registers, and P is re-packed from the S
//   accumulators as the A operand of P.V without a trip through shared
//   memory. q arrives as f32 and P is f32, neither exact in 16 bits: each
//   is fed as a hi + lo pair of page-dtype values, two products into one
//   f32 accumulator (error about 2^-16 relative, where one bf16 product
//   would move a short row's output by ~5e-3). Key tiles are 64 keys, i.e.
//   64 / pt pages gathered through the table, staged by 16-byte cp.async
//   into two buffers (rows padded by 16 bytes so that ldmatrix is free of
//   bank conflicts), the next tile in flight while the tensor cores work on
//   this one. Keys at or past the block's causal frontier are not read
//   (their rows are zero-filled); keys past a row's own limit are masked
//   per row (the rows of one fragment span up to three chunk positions). A
//   warp skips tiles past its own rows' frontier.
//   Fill: 64-row tiles give K * ceil(C*G / 64) blocks, 56 at C 256 and 10
//   at C 37 (G 7, K 2), too few for 132 SMs, so the wrapper also splits the
//   key axis (host ints only: start, C, max_pages) into `nsplit` runs of
//   whole tiles, enough for two blocks per SM where the keys allow (on the
//   H100 two ran faster than one, four or eight): 5 splits of 6 tiles, 280
//   blocks at C 256 / start 1500; 3 splits of 1 tile, 30 blocks at C 37 /
//   start 100 (it has only 3 key tiles). With nsplit > 1 every block
//   writes its rows' (m, l, acc) and merge_splits
//   (paged_attention_common.cuh) combines them; with one split the kernel
//   writes the output itself.
// * f32 / int8 pages: paged_prefill_cuda_core, one block per (kv head, 64
//   rows), pages staged one at a time as f32 in shared memory (int8 x scale
//   dequantises there), products on CUDA cores. f32 pages are not exact in
//   16 bits, and int8 on tensor cores goes with int8 KV through the engine.
#include "paged_attention_common.cuh"

using namespace paged_attn;

namespace {

// ---------------------------------------------------------------------------
// bf16 / f16 pages: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;       // 4 warps x 16 query rows
constexpr int BM = 64;                 // query rows per block
constexpr int BN = 64;                 // keys per tile

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }  // row pitch

template <int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return 2 * 2 * (size_t)BN * mma_ld<HD>() * 2;   // K, V x two buffers
}

// Keys visible to query row rr: positions < lim (0 for rows past C*G).
__device__ __forceinline__ int row_lim(int rr, int NR, int G, int start,
                                       int S) {
  return rr < NR ? min(start + rr / G + 1, S) : 0;
}

// Index of query row rr's output row in out / the partials [C*H][...].
__device__ __forceinline__ size_t out_row(int rr, int G, int H, int kh) {
  const int c = rr / G, g = rr - c * G;
  return (size_t)c * H + (size_t)kh * G + g;
}

template <typename T, int HD>
__global__ void __launch_bounds__(MMA_THREADS)
    paged_prefill_mma(const float* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp,
                      const int* __restrict__ table, float* __restrict__ out,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int C, int H, int K,
                      int pt, int max_pages, int start, int tiles_per_split,
                      float scale) {
  constexpr int LD = mma_ld<HD>();
  constexpr int KS = HD / 16;            // k-steps of Q.K^T
  constexpr int NV = HD / 8;             // 8-wide blocks of the output
  constexpr int CPR = HD / 8;            // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);           // [2][BN][LD]
  T* sv = sk + 2 * BN * LD;                         // [2][BN][LD]

  const int kh = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int G = H / K, NR = C * G, S = max_pages * pt;
  const int r0 = blockIdx.x * BM;
  const int frontier = row_lim(min(r0 + BM, NR) - 1, NR, G, start, S);
  const int klo = split * tiles_per_split * BN;
  const int khi = min(frontier, klo + tiles_per_split * BN);
  if (khi <= klo) {  // this split lies past every row's frontier
    for (int i = threadIdx.x; i < BM && r0 + i < NR; i += MMA_THREADS) {
      const size_t row = out_row(r0 + i, G, H, kh) * nsplit + split;
      part_m[row] = -INFINITY;
      part_l[row] = 0.f;
    }
    return;
  }
  const int ntiles = (khi - klo + BN - 1) / BN;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid4 = lane & 3;
  const int ra = r0 + warp * 16 + gid, rb = ra + 8;
  const int lim_a = row_lim(ra, NR, G, start, S);
  const int lim_b = row_lim(rb, NR, G, start, S);
  const int warp_lim = row_lim(min(r0 + warp * 16 + 15, NR - 1), NR, G,
                               start, S);

  // Q fragments (A operand, row-major 16 x HD), scaled, as hi + lo pairs
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = (i & 1) ? rb : ra;
      const int col = ks * 16 + (i >> 1) * 8 + tid4 * 2;
      float2 x = make_float2(0.f, 0.f);
      if (rr < NR)
        x = *reinterpret_cast<const float2*>(
            q + out_row(rr, G, H, kh) * HD + col);
      Mma<T>::split(x.x * scale, x.y * scale, qh[ks][i], ql[ks][i]);
    }
  }

  // stage key tile t of this split into buffer `buf`
  auto load_tile = [&](int t, int buf) {
    const int kb = klo + t * BN;
    const uint32_t dk = smem_addr(sk + buf * BN * LD);
    const uint32_t dv = smem_addr(sv + buf * BN * LD);
    for (int i = threadIdx.x; i < BN * CPR; i += MMA_THREADS) {
      const int key = i / CPR, ch = i - key * CPR;
      const int kpos = kb + key;
      const uint32_t off = (uint32_t)(key * LD + ch * 8) * sizeof(T);
      if (kpos < khi) {
        const int pid = max(table[kpos / pt], 0);
        const size_t src =
            (((size_t)pid * K + kh) * pt + kpos % pt) * HD + ch * 8;
        cp_async16(dk + off, kp + src, 16);
        cp_async16(dv + off, vp + src, 16);
      } else {  // past the frontier: zeros, nothing read
        cp_async16(dk + off, kp, 0);
        cp_async16(dv + off, vp, 0);
      }
    }
  };

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kb = klo + t * BN;
    if (kb < warp_lim) {
      const T* kt = sk + (t & 1) * BN * LD;
      const T* vt = sv + (t & 1) * BN * LD;
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
          Mma<T>::mma(s[2 * np], qh[ks], b[0], b[1]);
          Mma<T>::mma(s[2 * np], ql[ks], b[0], b[1]);
          Mma<T>::mma(s[2 * np + 1], qh[ks], b[2], b[3]);
          Mma<T>::mma(s[2 * np + 1], ql[ks], b[2], b[3]);
        }
      }
      // mask per row, online softmax; c0,c1 belong to row a, c2,c3 to b
      float mx_a = NEG, mx_b = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = kb + j * 8 + tid4 * 2 + (i & 1);
          const bool vis = kpos < (i < 2 ? lim_a : lim_b);
          s[j][i] = vis ? s[j][i] : NEG;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool is_a = i < 2;
          const float p = s[j][i] == NEG
                              ? 0.f
                              : expf(s[j][i] - (is_a ? mn_a : mn_b));
          s[j][i] = p;
          if (is_a) sum_a += p; else sum_b += p;
        }
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
        Mma<T>::split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        Mma<T>::split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        Mma<T>::split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        Mma<T>::split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < NV / 2; ++dp) {
          const int mat = lane >> 3;
          const int key = kk * 16 + (mat & 1) * 8 + (lane & 7);
          const int dim = dp * 16 + (mat >> 1) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vt + key * LD + dim));
          Mma<T>::mma(o[2 * dp], ph, b[0], b[1]);
          Mma<T>::mma(o[2 * dp], pl, b[0], b[1]);
          Mma<T>::mma(o[2 * dp + 1], ph, b[2], b[3]);
          Mma<T>::mma(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = half ? rb : ra;
    if (rr >= NR) continue;
    const float l = half ? l_b : l_a;
    const size_t row = out_row(rr, G, H, kh);
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        *reinterpret_cast<float2*>(out + row * HD + j * 8 + tid4 * 2) =
            make_float2(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    } else {
      const size_t prow = row * nsplit + split;
      if (tid4 == 0) {   // a row that saw no key here weighs nothing
        part_m[prow] = l > 0.f ? (half ? m_b : m_a) : -INFINITY;
        part_l[prow] = l;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j)
        *reinterpret_cast<float2*>(part_acc + prow * HD + j * 8 +
                                   tid4 * 2) =
            make_float2(o[j][2 * half], o[j][2 * half + 1]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_mma_hd(const float* q, const void* kp, const void* vp,
                          const int* table, float* out, float* pm, float* pl,
                          float* pa, int C, int H, int K, int pt,
                          int max_pages, int start, int nsplit, int tps,
                          cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  auto kern = paged_prefill_mma<T, HD>;
  static bool opted_in = false;   // set once, so launches can be graphed
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int G = H / K;
  const dim3 grid((C * G + BM - 1) / BM, K, nsplit);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), table, out,
      pm, pl, pa, C, H, K, pt, max_pages, start, tps,
      1.0f / sqrtf(static_cast<float>(HD)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  merge_splits<void><<<C * H, 128, 0, stream>>>(pm, pl, pa, out, HD, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma(int hd, const float* q, const void* kp,
                       const void* vp, const int* table, float* out,
                       float* pm, float* pl, float* pa, int C, int H, int K,
                       int pt, int max_pages, int start, int nsplit, int tps,
                       cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_mma_hd<T, 16>(q, kp, vp, table, out, pm, pl, pa, C, H, K,
                                  pt, max_pages, start, nsplit, tps, s);
    case 32:
      return launch_mma_hd<T, 32>(q, kp, vp, table, out, pm, pl, pa, C, H, K,
                                  pt, max_pages, start, nsplit, tps, s);
    case 64:
      return launch_mma_hd<T, 64>(q, kp, vp, table, out, pm, pl, pa, C, H, K,
                                  pt, max_pages, start, nsplit, tps, s);
    case 128:
      return launch_mma_hd<T, 128>(q, kp, vp, table, out, pm, pl, pa, C, H,
                                   K, pt, max_pages, start, nsplit, tps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32 / int8 pages: CUDA cores
// ---------------------------------------------------------------------------
//
// One block walks the sequence's page table and keeps an online softmax per
// query row in shared memory (m, l, acc [R, hd] f32). A query row r sees key
// position kpos iff kpos < lim[r]; masked logits are NEG and their
// probabilities exactly 0. Pages are staged in shared memory as f32, int8
// multiplied by its per-(page, kv-head) scale.
constexpr int CORE_THREADS = 256;
constexpr int CORE_ROWS = 64;

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

template <typename PageT>
__global__ void __launch_bounds__(CORE_THREADS)
    paged_prefill_cuda_core(const float* __restrict__ q,
                            const PageT* __restrict__ kp,
                            const PageT* __restrict__ vp,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int* __restrict__ table,
                            float* __restrict__ out, int C, int H, int K,
                            int hd, int pt, int max_pages, int start,
                            int rows, float scale) {
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
cudaError_t launch_cuda_core(const float* q, const void* kp, const void* vp,
                             const float* ks, const float* vs,
                             const int* table, float* out, int C, int H,
                             int K, int hd, int pt, int max_pages, int start,
                             cudaStream_t stream) {
  const int G = H / K;
  const int rows = min(CORE_ROWS, C * G);
  const size_t smem = smem_bytes(rows, pt, hd);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidConfiguration;
  auto kern = paged_prefill_cuda_core<PageT>;
  static size_t opted_in = 48 * 1024;  // set once, so launches can be graphed
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid(K, (C * G + rows - 1) / rows);
  kern<<<grid, CORE_THREADS, smem, stream>>>(
      q, static_cast<const PageT*>(kp), static_cast<const PageT*>(vp), ks, vs,
      table, out, C, H, K, hd, pt, max_pages, start, rows,
      1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Chunk attention over the page pool. bf16 / f16 pages run on tensor cores
// in `nsplit` splits of `tiles_per_split` 64-key tiles (nsplit *
// tiles_per_split * 64 >= min(start + C, max_pages * pt)); with nsplit > 1
// part_ml holds 2 * C*H*nsplit floats and part_acc C*H*nsplit*hd. f32 /
// int8 pages take the CUDA-core kernel and need nsplit = 1 and no
// partials. Returns a cudaError_t value: 0 on a launch that was accepted.
int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* page_table,
                            void* out, void* part_ml, void* part_acc, int C,
                            int H, int K, int hd, int pt, int max_pages,
                            int start, int nsplit, int tiles_per_split,
                            int page_dtype, void* stream) {
  if (C == 0) return cudaSuccess;
  const long long keys = (long long)start + C < (long long)max_pages * pt
                            ? (long long)start + C
                            : (long long)max_pages * pt;
  if (K <= 0 || H % K || pt <= 0 || max_pages <= 0 || start < 0 ||
      nsplit <= 0 || tiles_per_split <= 0 ||
      (long long)nsplit * tiles_per_split * BN < keys)
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(page_table);
  float* o = static_cast<float*>(out);
  float* pm = static_cast<float*>(part_ml);
  float* pl = pm == nullptr ? nullptr : pm + (size_t)C * H * nsplit;
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit > 1 && (pm == nullptr || pa == nullptr))
    return cudaErrorInvalidValue;
  switch (page_dtype) {
    case BF16:
      return launch_mma<__nv_bfloat16>(hd, qf, k_pages, v_pages, tbl, o, pm,
                                       pl, pa, C, H, K, pt, max_pages, start,
                                       nsplit, tiles_per_split, s);
    case F16:
      return launch_mma<__half>(hd, qf, k_pages, v_pages, tbl, o, pm, pl, pa,
                                C, H, K, pt, max_pages, start, nsplit,
                                tiles_per_split, s);
    case F32:
      if (nsplit != 1) return cudaErrorInvalidValue;
      return launch_cuda_core<float>(qf, k_pages, v_pages, ks, vs, tbl, o, C,
                                     H, K, hd, pt, max_pages, start, s);
    case I8:
      if (nsplit != 1) return cudaErrorInvalidValue;
      return launch_cuda_core<int8_t>(qf, k_pages, v_pages, ks, vs, tbl, o, C,
                                      H, K, hd, pt, max_pages, start, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_prefill_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
