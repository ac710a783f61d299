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
// kernel and its oracle do. Only the shared header's constants, warp
// reductions and dtype conversions are used here, not its merge.
//
// What bounds it on the H100: device-memory bytes. The keys and values a
// slot needs are read once (K*len*hd*2*itemsize bytes per slot; V over all
// S for a length-0 slot) and each costs 4*G*hd flops, far below the ~295
// flop/byte the card needs before arithmetic limits it. At the serving
// decode shape that is ~4 MB, ~1.2 us at 3.35 TB/s: the time goes to
// latency (device memory, the launch, the merge), so the design keeps many
// loads in flight and makes one launch.
//
// Design: split-K ("flash decoding") in ONE launch.
//
//   * A block takes a split of `chunk` keys of one (slot, kv head) and up to
//     8 of its G query rows (grid (nsplit, B*K, ceil(G / 8)); the wrapper
//     derives nsplit from host ints only, so the launch can be captured in a
//     CUDA graph; at the serving decode shape 16 splits of 128 keys, 256
//     blocks: two, four and eight blocks an SM were timed, two was
//     fastest). It stops at min(split end, length): positions past a
//     nonzero length would get probability exp(NEG - m) = 0 exactly, so
//     they are not read; a length-0 slot reads no K (every logit is NEG)
//     and all of V.
//   * Key and value rows are read straight into registers, no staging and
//     no block barrier per tile. Each warp takes its own runs of keys and
//     starts all of a run's K and V loads (UNROLL 16-byte loads of K, hd/8
//     lanes a row in bf16 and hd/4 in f32; V with its features spread over
//     the lanes) before the dependent arithmetic; the first run's loads go
//     out before the block stages its query rows.
//   * Logits: the G query rows sit in shared memory as f32; a lane forms
//     the partial dot products of its key with all 8 rows, and one
//     transposed butterfly over the row's lanes (reduce_rows) leaves each
//     lane the full logits of its own row(s): 7 shuffles for 8 rows over 8
//     lanes where reducing each row would take 24, and the softmax state a
//     lane keeps is that of one row, not eight.
//   * Each warp keeps its own online softmax, one rescale per run; it hands
//     the run's probabilities and rescale factors to its V lanes through
//     shared memory (a __syncwarp, no block barrier). A V lane owns hd/32
//     features (4 bytes at least) of every row, so the f32 accumulators
//     are 8 x hd/32 a lane, not 8 x 8: with the logits' state that keeps
//     the kernel within 128 registers. The warps merge once, through
//     shared memory, at the block's end.
//   * The merge of the splits is folded into the same launch. Each block
//     writes its (m, l, acc) partials (m = -inf, l = 0 for a split that
//     starts past the slot's length), then __threadfence(), then one thread
//     adds one to the arrival counter of its (slot, kv head, row group).
//     The block that arrives last merges all nsplit partials of its rows IN
//     SPLIT ORDER, rescaling by exp(m_j - max m), divides by max(l, 1e-30),
//     writes out, and sets the counter back to 0 for the next call. The
//     order makes the result independent of which block came last, so
//     graph replays are bit for bit equal. It reads the other blocks'
//     partials with ld.global.cg (L2, coherent), never through the
//     read-only path: the weights of each row into shared memory (a warp a
//     row), then a thread per 4 features. The counters are a persistent
//     int32 buffer the wrapper zeroes once; calls must not overlap in time
//     on two streams.
#include "paged_attention_common.cuh"

// the shared header's constants, dtype ids and conversions (not its merge)
using paged_attn::BF16;
using paged_attn::F32;
using paged_attn::from_f32;
using paged_attn::NEG;
using paged_attn::warp_max;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 8;            // query rows of one kv head per block
constexpr int UNROLL = 4;          // 16-byte K loads a lane starts a run
constexpr int MAX_SPLITS = 256;    // the merge keeps its weights in smem

// One lane's 16 bytes of a key row.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int EPL = 4;    // elements a lane reads
  __device__ __forceinline__ static void to_f32(const uint4& r,
                                                float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int EPL = 8;
  __device__ __forceinline__ static void to_f32(const uint4& r,
                                                float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// A lane's VE features of a value row, VE * sizeof(T) bytes (4, 8 or 16):
// W = VE * sizeof(T) / 4 words, loaded raw and converted when used.
template <int W>
struct Words {
  unsigned int w[W];
};

template <typename T, int VE>
__device__ __forceinline__ Words<VE * sizeof(T) / 4> load_v(const T* p) {
  constexpr int W = VE * sizeof(T) / 4;
  Words<W> r;
  if constexpr (W == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
  } else if constexpr (W == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = x.x; r.w[1] = x.y;
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  return r;
}

template <typename T, int VE>
__device__ __forceinline__ void v_to_f32(const Words<VE * sizeof(T) / 4>& r,
                                         float (&x)[VE]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VE; ++e) x[e] = __uint_as_float(r.w[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VE; e += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&r.w[e / 2]));
      x[e] = f.x;
      x[e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Sum ROWS partial dot products over the LPR lanes that read one key row,
// transposed: each stage hands half of the rows still held to the partner
// lane, so every lane ends with the full sums of NV = max(1, ROWS / LPR)
// rows, lane_row0 .. lane_row0 + NV - 1, in d[0 .. NV - 1] (7 shuffles for
// 8 rows over 8 lanes, where a reduction of each row would take 24).
template <int LPR>
__device__ __forceinline__ void reduce_rows(float (&d)[ROWS], int lane) {
#pragma unroll
  for (int o = LPR / 2, n = ROWS; o > 0; o >>= 1) {
    const bool upper = lane & o;
    if (n > 1) {
      const int h = n / 2;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? d[i] : d[i + h];
        const float keep = upper ? d[i + h] : d[i];
        d[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      n = h;
    } else {
      d[0] += __shfl_xor_sync(0xffffffffu, d[0], o);
    }
  }
}

// The first row whose sums reduce_rows leaves a lane.
template <int LPR>
__device__ __forceinline__ int lane_row0(int lane) {
  int row0 = 0;
#pragma unroll
  for (int o = LPR / 2, n = ROWS; o > 0 && n > 1; o >>= 1, n /= 2)
    row0 += lane & o ? n / 2 : 0;
  return row0;
}

// One block: split blockIdx.x of (slot, kv head) blockIdx.y, query rows
// g0 .. g0+R-1 of that kv head (g0 = 8 * blockIdx.z). Partials of query
// head h of slot b go to row b*H + h of part_m / part_l [B*H][nsplit] and
// part_acc [B*H][nsplit][HD]; counters [B*K*gridDim.z] count arrivals.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 4)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  float* part_m, float* part_l, float* part_acc,
                  int* counters, T* __restrict__ out, int H, int K, int S,
                  int chunk, float scale) {
  constexpr int EPL = Vec<T>::EPL;
  constexpr int LPR = HD / EPL;          // lanes that read one key row
  constexpr int KPW = 32 / LPR;          // key rows a warp reads at once
  constexpr int RUN = UNROLL * KPW;      // keys of one run of a warp
  constexpr int NV = LPR >= ROWS ? 1 : ROWS / LPR;   // logit rows a lane has
  // value rows: VL lanes of VE features each (at least 4 bytes a lane)
  constexpr int VE = (HD / 32) * (int)sizeof(T) >= 4 ? HD / 32
                                                     : 4 / (int)sizeof(T);
  constexpr int VL = HD / VE;
  constexpr int VKPW = 32 / VL;          // value rows a warp reads at once
  constexpr int VLOADS = RUN / VKPW;
  __shared__ __align__(16) float sq[ROWS * HD];
  __shared__ __align__(16) float sp[NWARPS][RUN + 1][ROWS];  // p; last: corr
  __shared__ float wm[NWARPS][ROWS], wl[NWARPS][ROWS];
  __shared__ __align__(16) float wacc[NWARPS][ROWS * HD];
  __shared__ float sw[ROWS][MAX_SPLITS], sl[ROWS][MAX_SPLITS];
  __shared__ int last;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  const int g0 = blockIdx.z * ROWS, R = min(ROWS, G - g0);
  const size_t head0 = (size_t)b * H + (size_t)kh * G + g0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = lengths[b];
  const int lo = split * chunk, end = min(S, lo + chunk);
  const int hi = len > 0 ? min(end, len) : end;   // positions this block reads

  if (hi > lo) {
    const int d0 = (lane % LPR) * EPL, kslot = lane / LPR;
    const int vd0 = (lane % VL) * VE, vslot = lane / VL;
    const size_t kv0 = ((size_t)b * K + kh) * (size_t)S;
    const int row0 = lane_row0<LPR>(lane);
    uint4 kr[UNROLL];
    Words<VE * sizeof(T) / 4> vr[VLOADS];
    // start one run's K and V loads (zeros past hi; K only where the slot
    // has a length)
    auto fetch = [&](int c0) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kpos = c0 + u * KPW + kslot;
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (len > 0 && kpos < hi) kr[u] = load16(k + (kv0 + kpos) * HD + d0);
      }
#pragma unroll
      for (int j = 0; j < VLOADS; ++j) {
        const int vpos = c0 + j * VKPW + vslot;
        vr[j] = {};
        if (vpos < hi) vr[j] = load_v<T, VE>(v + (kv0 + vpos) * HD + vd0);
      }
    };
    int c0 = lo + warp * RUN;
    if (c0 < hi) fetch(c0);
    for (int i = threadIdx.x; i < ROWS * HD; i += THREADS)
      sq[i] = len > 0 && i < R * HD ? paged_attn::to_f32(q[head0 * HD + i])
                                    : 0.f;
    __syncthreads();
    float m[NV], l[NV], acc[ROWS][VE];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < ROWS; ++g)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
    // warp-uniform loop: every lane takes part in the shuffles; the run's
    // first key (u = 0, kslot 0) is valid, so each row max is finite
    while (c0 < hi) {
      float s[UNROLL][NV];
      if (len > 0) {
        float kf[UNROLL][EPL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) Vec<T>::to_f32(kr[u], kf[u]);
        float d[UNROLL][ROWS];
#pragma unroll
        for (int g = 0; g < ROWS; ++g) {
          float qg[EPL];
#pragma unroll
          for (int e = 0; e < EPL; e += 4) {
            const float4 x = *reinterpret_cast<const float4*>(
                sq + g * HD + d0 + e);
            qg[e] = x.x; qg[e + 1] = x.y; qg[e + 2] = x.z; qg[e + 3] = x.w;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot = fmaf(qg[e], kf[u][e], dot);
            d[u][g] = dot;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          reduce_rows<LPR>(d[u], lane);
          const bool valid = c0 + u * KPW + kslot < hi;
#pragma unroll
          for (int i = 0; i < NV; ++i) s[u][i] = valid ? d[u][i] * scale : NEG;
        }
      } else {   // a length-0 slot: every logit is NEG
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int i = 0; i < NV; ++i) s[u][i] = NEG;
      }
      // the online softmax of the lane's rows, over the run's keys
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float mx = s[0][i];
#pragma unroll
        for (int u = 1; u < UNROLL; ++u) mx = fmaxf(mx, s[u][i]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);    // 0 while m is -inf
        m[i] = m_new;
        l[i] *= corr;
        if (kslot == 0) sp[warp][RUN][row0 + i] = corr;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const bool valid = c0 + u * KPW + kslot < hi;
          const float p = valid ? expf(s[u][i] - m_new) : 0.f;
          l[i] += p;
          sp[warp][u * KPW + kslot][row0 + i] = p;   // same value per writer
        }
      }
      __syncwarp();
      // p.V: a lane's VE features of every row over the run's value rows
      {
        const float4 c0v = *reinterpret_cast<const float4*>(sp[warp][RUN]);
        const float4 c1v =
            *reinterpret_cast<const float4*>(sp[warp][RUN] + 4);
        const float cr[ROWS] = {c0v.x, c0v.y, c0v.z, c0v.w,
                                c1v.x, c1v.y, c1v.z, c1v.w};
#pragma unroll
        for (int g = 0; g < ROWS; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][e] *= cr[g];
      }
#pragma unroll
      for (int j = 0; j < VLOADS; ++j) {
        float vf[VE];
        v_to_f32<T, VE>(vr[j], vf);
        const float* pr = sp[warp][j * VKPW + vslot];
        const float4 p0 = *reinterpret_cast<const float4*>(pr);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
        const float p[ROWS] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < ROWS; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
      }
      __syncwarp();
      c0 += NWARPS * RUN;
      if (c0 < hi) fetch(c0);
    }
    // sum each warp's key slots, then merge the warps once
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
      if (kslot == 0) {
        wm[warp][row0 + i] = m[i];
        wl[warp][row0 + i] = l[i];
      }
    }
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
#pragma unroll
      for (int o = VL; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      if (vslot == 0) {
#pragma unroll
        for (int e = 0; e < VE; ++e) wacc[warp][g * HD + vd0 + e] = acc[g][e];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
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
  } else if (threadIdx.x < R) {   // past the slot's length: no key read
    part_m[(head0 + threadIdx.x) * nsplit + split] = -INFINITY;
    part_l[(head0 + threadIdx.x) * nsplit + split] = 0.f;
  }

  // arrive; the last block of the (slot, kv head, row group) merges
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)blockIdx.y * gridDim.z + blockIdx.z;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int g = warp; g < R; g += NWARPS) {
    const size_t row = (head0 + g) * nsplit;
    float mx = -INFINITY;
    for (int j = lane; j < nsplit; j += 32)
      mx = fmaxf(mx, __ldcg(part_m + row + j));
    mx = warp_max(mx);   // finite: split 0 reads a key (or V)
    for (int j = lane; j < nsplit; j += 32) {
      const float mj = __ldcg(part_m + row + j);
      sw[g][j] = mj == -INFINITY ? 0.f : expf(mj - mx);
      sl[g][j] = __ldcg(part_l + row + j);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * HD / 4; i += THREADS) {
    const int g = i / (HD / 4), d = (i % (HD / 4)) * 4;
    const size_t row = head0 + g;
    const float4* pa =
        reinterpret_cast<const float4*>(part_acc + row * nsplit * HD + d);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll 8
    for (int j = 0; j < nsplit; ++j) {   // in split order
      const float w = sw[g][j];
      const float4 x = __ldcg(pa + (size_t)j * (HD / 4));  // unwritten: w = 0
      lsum = fmaf(sl[g][j], w, lsum);
      if (w != 0.f) {
        a.x = fmaf(x.x, w, a.x);
        a.y = fmaf(x.y, w, a.y);
        a.z = fmaf(x.z, w, a.z);
        a.w = fmaf(x.w, w, a.w);
      }
    }
    const float den = fmaxf(lsum, 1e-30f);
    T* o = out + row * HD + d;
    o[0] = from_f32<T>(a.x / den);
    o[1] = from_f32<T>(a.y / den);
    o[2] = from_f32<T>(a.z / den);
    o[3] = from_f32<T>(a.w / den);
  }
  if (threadIdx.x == 0) *counter = 0;   // ready for the next call
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* lengths, void* out, float* pm, float* pl,
                      float* pa, int* counters, int B, int H, int K, int S,
                      int nsplit, int chunk, cudaStream_t stream) {
  const int G = H / K;
  const dim3 grid(nsplit, B * K, (G + ROWS - 1) / ROWS);
  decode_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, pm, pl, pa, counters,
      static_cast<T*>(out), H, K, S, chunk,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int hd, const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* pm, float* pl,
                   float* pa, int* counters, int B, int H, int K, int S,
                   int nsplit, int chunk, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, lengths, out, pm, pl, pa, counters, B,
                              H, K, S, nsplit, chunk, s);
    case 32:
      return launch_hd<T, 32>(q, k, v, lengths, out, pm, pl, pa, counters, B,
                              H, K, S, nsplit, chunk, s);
    case 64:
      return launch_hd<T, 64>(q, k, v, lengths, out, pm, pl, pa, counters, B,
                              H, K, S, nsplit, chunk, s);
    case 128:
      return launch_hd<T, 128>(q, k, v, lengths, out, pm, pl, pa, counters,
                               B, H, K, S, nsplit, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One-token attention of q [B, H, hd] over k/v [B, K, S, hd] in `nsplit`
// splits of `chunk` keys (nsplit * chunk >= S, nsplit <= 256), one launch;
// part_ml holds 2 * B*H*nsplit floats, part_acc B*H*nsplit*hd, counters
// B*K*ceil(G/8) int32 that are 0 on entry and are left 0. Returns a
// cudaError_t value: 0 on a launch that was accepted.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* part_ml,
                     void* part_acc, void* counters, int B, int H, int K,
                     int S, int hd, int nsplit, int chunk, int dtype,
                     void* stream) {
  if (B == 0) return cudaSuccess;
  if (K <= 0 || H % K || S <= 0 || nsplit <= 0 || nsplit > MAX_SPLITS ||
      chunk <= 0 || (long long)nsplit * chunk < S)
    return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_ml);
  float* pl = pm + (size_t)B * H * nsplit;
  float* pa = static_cast<float*>(part_acc);
  int* ctr = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch<float>(hd, q, k, v, len, out, pm, pl, pa, ctr, B, H, K,
                           S, nsplit, chunk, s);
    case BF16:
      return launch<__nv_bfloat16>(hd, q, k, v, len, out, pm, pl, pa, ctr, B,
                                   H, K, S, nsplit, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
