// The AutoDMA tiled-kernel builder for Hopper (sm_90a), with the bodies of
// gemm (three ISA-study variants), matvec and matvec_t.
//
// Replaces: src/repro/core/autodma.py:321 pallas_call (the builder) and the
// Pallas bodies it carries: src/repro/kernels/gemm.py:62 gemm (_body_mxu
// :26, _body_vpu :33, _body_loop :42), src/repro/kernels/polybench.py:31
// matvec and :39 matvec_t.
//
// What it computes. A Plan from the AutoDMA planner (core/autodma.py) tiles
// a loop nest of at most three axes: parallel axes, then one reduction axis.
// Each input array's block is cut by its per-dimension axis map (`dims`),
// and the body folds one reduction step into the resident output tile:
//   gemm      C = prev + alpha * (A_blk @ B_blk), A [M,K], B [K,N]
//   matvec    y = prev + A_blk @ x_blk,           A [M,N] dims (0,1)
//   matvec_t  y = prev + A_blk^T @ x_blk,         A [M,N] dims (1,0)
// with prev = 0 at reduction index 0 and the tile rounded to the dtype
// (f32 or bf16) after every step, as the JAX bodies keep their output block
// in VMEM in that dtype.
//
// Design. Tiles, grid and axis maps are runtime ints from the Plan (laid
// out by kernels/tiled.py), so one build serves every plan.
//   * One block per tile of the parallel axes (blockIdx.x, row-major over
//     them). The reduction axis, a sequential grid dimension on the TPU,
//     is a loop inside the block; the gemm output tile stays in registers
//     across it, the matvec output vector in shared memory.
//   * Each input block is staged from device memory into dynamic shared
//     memory at the offsets its dims give (blockIdx -> grid position ->
//     element origin per array dimension): this is AutoDMA's inferred
//     transfer schedule. Blocks move with 16-byte cp.async where rows are
//     16-byte aligned (else f32 element by element with 4-byte cp.async,
//     bf16 synchronously), double buffered when the plan counted two
//     buffers (step s+1 loads while step s computes). gemm blocks are
//     padded to 16 rows and 32 columns with zeros, so ragged edges (a tile
//     that does not divide the bound) cost no branch in the bodies; the
//     output store is masked.
//   * `unmodified` plans (one whole-array block, which shared memory cannot
//     hold) run unstaged: the kernel covers the output with its own grid of
//     blocks and every operand is read from device memory at each use, the
//     paper's SPM-less baseline.
//   * Bodies: gemm_mxu uses tensor cores, mma.sync m16n8k8 TF32 (f32
//     operands, rounded to TF32) or m16n8k16 bf16, f32 accumulation;
//     gemm_vpu multiplies and adds on CUDA cores with __fmul_rn/__fadd_rn,
//     which nvcc never contracts into FFMA (no MAC instruction); gemm_loop
//     runs FFMA in a k-loop over 8-deep slices kept rolled (#pragma unroll
//     1, a software loop); matvec/matvec_t reduce on CUDA cores (matvec a
//     warp per row; matvec_t lanes across columns, warps down the rows,
//     the warps' sums added in a fixed order). The gemm bodies share one
//     register layout: each warp owns 16x32 fragments of the output tile
//     in the mma accumulator layout; a tile of more fragments than 16
//     warps hold is covered in passes.
//
// What bounds it on the H100. gemm at the suite's shapes is bound by
// operations (2MNK flops against 495 TFLOP/s TF32; ~0.035 ms at 2048^3);
// matvec and matvec_t by bytes (the matrix read once at 3.35 TB/s). This
// first version loads mma fragments element by element from shared memory
// (no ldmatrix, no wgmma, no TMA) and so runs far from the tensor cores'
// rate; the matvec bodies stage x and A through shared memory although
// each element of A is used once (PERF.md has the times).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_SMEM = 232448;  // shared memory one block may use (H100)
constexpr int MAX_THREADS = 512;

enum BodyId { GEMM_MXU = 0, GEMM_VPU = 1, GEMM_LOOP = 2, MATVEC = 3,
              MATVEC_T = 4 };
enum DtypeId { F32 = 0, BF16 = 1 };

// The int fields laid out by kernels/tiled.py (FIELDS there), in order.
enum Field {
  F_BODY, F_DTYPE, F_STAGED, F_NBUF, F_STAGE_BYTES, F_OUT_OFF, F_SMEM,
  F_THREADS, F_BLOCKS, F_FPW, F_NPASS, F_NRG, F_NCG,
  F_BOUND, F_TILE = F_BOUND + 3, F_NTILE = F_TILE + 3,
  F_PAR0 = F_NTILE + 3, F_PAR1, F_RED, F_OUT_ROWS, F_OUT_COLS, F_OUT_AX0,
  F_OUT_AX1, F_IN0, F_IN_FIELDS = 8, F_COUNT = F_IN0 + 2 * F_IN_FIELDS
};

// One input array as 2-D (a 1-D array is one row, its row dim FULL = -1).
struct Arr {
  const void* ptr;
  int rows, cols;
  int ax0, ax1;     // grid axis of each dim, -1 = FULL (resident)
  int ld;           // staged row pitch, elements
  int prow, pcol;   // staged block rows / cols (zero padded)
  int soff;         // byte offset of the block in a stage buffer
};

struct Params {
  Arr in[2];
  void* out;
  int out_rows, out_cols, out_ax0, out_ax1;
  int bound[3], tile[3], ntile[3];
  int par0, par1, red;
  int staged, nbuf, stage_bytes, out_off;
  int nrg, ncg;     // gemm: 16-row x 32-col fragments of the output tile
  int npass;        // gemm: passes over the fragments (register capacity)
  float alpha;
};

// A block's grid position as element origins and extents per loop axis.
struct Ctx {
  int org[3], ext[3];
};

__device__ __forceinline__ Ctx at_step(const Params& P, Ctx c, int s) {
  const int r = P.red;
  c.org[r] = s * P.tile[r];
  c.ext[r] = min(P.tile[r], P.bound[r] - c.org[r]);
  return c;
}

__device__ __forceinline__ Ctx block_ctx(const Params& P) {
  Ctx c;
  int pos[3] = {0, 0, 0};
  const int n1 = P.par1 >= 0 ? P.ntile[P.par1] : 1;
  pos[P.par0] = blockIdx.x / n1;
  if (P.par1 >= 0) pos[P.par1] = blockIdx.x % n1;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c.org[a] = pos[a] * P.tile[a];
    c.ext[a] = min(P.tile[a], P.bound[a] - c.org[a]);
  }
  return at_step(P, c, 0);
}

// --- element access --------------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The output tile is kept in the dtype between reduction steps.
template <typename T>
__device__ __forceinline__ float in_dtype(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ uint16_t bits16(T v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// A staged block in shared memory (zero padded: no bounds to check).
template <typename T>
struct SView {
  const T* p;
  int ld;
  __device__ __forceinline__ float f(int r, int c) const {
    return to_f<T>(p[r * ld + c]);
  }
  __device__ __forceinline__ uint16_t raw(int r, int c) const {
    return bits16(p[r * ld + c]);
  }
};

// A block read straight from device memory (unmodified mode), masked.
template <typename T>
struct GView {
  const T* p;
  int ld, r0, c0, er, ec;
  __device__ __forceinline__ bool in(int r, int c) const {
    return r < er && c < ec;
  }
  __device__ __forceinline__ float f(int r, int c) const {
    return in(r, c) ? to_f<T>(p[(size_t)(r0 + r) * ld + c0 + c]) : 0.f;
  }
  __device__ __forceinline__ uint16_t raw(int r, int c) const {
    return in(r, c) ? bits16(p[(size_t)(r0 + r) * ld + c0 + c]) : 0;
  }
};

__device__ __forceinline__ int origin(int ax, const Ctx& c) {
  return ax < 0 ? 0 : c.org[ax];
}
__device__ __forceinline__ int extent(int ax, int full, const Ctx& c) {
  return ax < 0 ? full : c.ext[ax];
}

template <typename T>
__device__ __forceinline__ SView<T> sview(const Arr& a,
                                          const unsigned char* buf) {
  return {reinterpret_cast<const T*>(buf + a.soff), a.ld};
}

template <typename T>
__device__ __forceinline__ GView<T> gview(const Arr& a, const Ctx& c) {
  return {static_cast<const T*>(a.ptr), a.cols, origin(a.ax0, c),
          origin(a.ax1, c), extent(a.ax0, a.rows, c),
          extent(a.ax1, a.cols, c)};
}

// --- staging ---------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // src-size 0 fills the 4 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // copies `bytes` (0..16) and fills the rest of the 16 with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage both input blocks of grid position `c` into stage buffer `buf`.
template <typename T>
__device__ void stage(const Params& P, const Ctx& c, unsigned char* buf) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Arr& a = P.in[k];
    T* dst = reinterpret_cast<T*>(buf + a.soff);
    const T* src = static_cast<const T*>(a.ptr);
    const int r0 = origin(a.ax0, c), c0 = origin(a.ax1, c);
    const int er = extent(a.ax0, a.rows, c), ec = extent(a.ax1, a.cols, c);
    constexpr int V = 16 / sizeof(T);  // elements in one 16-byte copy
    if (a.pcol % V == 0 && a.ld % V == 0 && a.cols % V == 0 && c0 % V == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const int nv = a.pcol / V, n = a.prow * nv;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / nv, col = (i - r * nv) * V;
        const int valid = r < er ? max(0, min(V, ec - col)) : 0;
        const T* s = valid ? src + (size_t)(r0 + r) * a.cols + (c0 + col) : src;
        cp_async16(dst + r * a.ld + col, s, valid * (int)sizeof(T));
      }
      continue;
    }
    const int n = a.prow * a.pcol;  // unaligned rows: element by element
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / a.pcol, col = i - r * a.pcol;
      const bool ok = r < er && col < ec;
      const T* s = ok ? src + (size_t)(r0 + r) * a.cols + (c0 + col) : src;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(dst + r * a.ld + col, s, ok);
      } else {
        dst[r * a.ld + col] = ok ? *s : from_f<T>(0.f);
      }
    }
  }
}

// --- tensor-core products --------------------------------------------------
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// --- gemm bodies: one 16x32 fragment's product over one reduction step ----
// Lane (g = lane/4, q = lane%4) holds p[t][e] for row r0 + g + 8*(e/2),
// column c0 + 8t + 2q + e%2 (the mma.sync accumulator layout).
template <int ISA, typename T, class VA, class VB>
__device__ __forceinline__ void fragment_product(float (&p)[4][4],
                                                 const VA& A, const VB& B,
                                                 int r0, int c0, int kext,
                                                 int g, int q) {
  if constexpr (ISA == GEMM_MXU && std::is_same<T, float>::value) {
    for (int kk = 0; kk < kext; kk += 8) {
      const uint32_t a0 = tf32(A.f(r0 + g, kk + q));
      const uint32_t a1 = tf32(A.f(r0 + g + 8, kk + q));
      const uint32_t a2 = tf32(A.f(r0 + g, kk + q + 4));
      const uint32_t a3 = tf32(A.f(r0 + g + 8, kk + q + 4));
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = c0 + 8 * t + g;
        mma_tf32(p[t], a0, a1, a2, a3, tf32(B.f(kk + q, n)),
                 tf32(B.f(kk + q + 4, n)));
      }
    }
  } else if constexpr (ISA == GEMM_MXU) {
    for (int kk = 0; kk < kext; kk += 16) {
      const int k = kk + 2 * q;
      const uint32_t a0 = pack(A.raw(r0 + g, k), A.raw(r0 + g, k + 1));
      const uint32_t a1 = pack(A.raw(r0 + g + 8, k), A.raw(r0 + g + 8, k + 1));
      const uint32_t a2 = pack(A.raw(r0 + g, k + 8), A.raw(r0 + g, k + 9));
      const uint32_t a3 = pack(A.raw(r0 + g + 8, k + 8),
                               A.raw(r0 + g + 8, k + 9));
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = c0 + 8 * t + g;
        mma_bf16(p[t], a0, a1, a2, a3, pack(B.raw(k, n), B.raw(k + 1, n)),
                 pack(B.raw(k + 8, n), B.raw(k + 9, n)));
      }
    }
  } else if constexpr (ISA == GEMM_VPU) {
#pragma unroll 8
    for (int k = 0; k < kext; ++k) {
      const float lo = A.f(r0 + g, k), hi = A.f(r0 + g + 8, k);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = B.f(k, c0 + 8 * t + 2 * q + e);
          p[t][e] = __fadd_rn(p[t][e], __fmul_rn(lo, b));
          p[t][2 + e] = __fadd_rn(p[t][2 + e], __fmul_rn(hi, b));
        }
      }
    }
  } else {  // GEMM_LOOP
#pragma unroll 1
    for (int kk = 0; kk < kext; kk += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = kk + u;
        const float lo = A.f(r0 + g, k), hi = A.f(r0 + g + 8, k);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float b = B.f(k, c0 + 8 * t + 2 * q + e);
            p[t][e] = fmaf(lo, b, p[t][e]);
            p[t][2 + e] = fmaf(hi, b, p[t][2 + e]);
          }
        }
      }
    }
  }
}

// gemm: each warp owns FPW fragments of the output tile, in registers. An
// output tile of more than 16 warps x FPW fragments is covered in passes,
// each of which runs the whole reduction loop again.
template <int ISA, int FPW, typename T>
struct GemmBody {
  float c[FPW][4][4];
  int first;  // the pass's first fragment

  __device__ void init(const Params&, unsigned char*, int pass) {
    first = pass * (blockDim.x >> 5) * FPW;
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[f][t][e] = 0.f;
  }

  template <class VA, class VB>
  __device__ void step(const Params& P, const Ctx& cx, const VA& A,
                       const VB& B) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5, g = lane >> 2, q = lane & 3;
    const int er = cx.ext[P.out_ax0], ec = cx.ext[P.out_ax1];
    const int kext = cx.ext[P.red];
#pragma unroll
    for (int fi = 0; fi < FPW; ++fi) {
      const int f = first + warp + fi * nw;
      if (f >= P.nrg * P.ncg) continue;
      const int r0 = (f / P.ncg) * 16, c0 = (f % P.ncg) * 32;
      if (r0 >= er || c0 >= ec) continue;  // wholly past a ragged edge
      float p[4][4] = {};
      fragment_product<ISA, T>(p, A, B, r0, c0, kext, g, q);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[fi][t][e] = in_dtype<T>(
              __fadd_rn(c[fi][t][e], __fmul_rn(P.alpha, p[t][e])));
    }
  }

  __device__ void finish(const Params& P, const Ctx& cx) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5, g = lane >> 2, q = lane & 3;
    const int er = cx.ext[P.out_ax0], ec = cx.ext[P.out_ax1];
    const int or0 = cx.org[P.out_ax0], oc0 = cx.org[P.out_ax1];
    T* out = static_cast<T*>(P.out);
#pragma unroll
    for (int fi = 0; fi < FPW; ++fi) {
      const int f = first + warp + fi * nw;
      if (f >= P.nrg * P.ncg) continue;
      const int r0 = (f / P.ncg) * 16, c0 = (f % P.ncg) * 32;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1);
          const int col = c0 + 8 * t + 2 * q + (e & 1);
          if (r < er && col < ec)
            out[(size_t)(or0 + r) * P.out_cols + oc0 + col] =
                from_f<T>(c[fi][t][e]);
        }
    }
  }
};

// matvec / matvec_t: the resident y tile is f32 in shared memory.
template <bool TRANSPOSED, typename T>
struct MatvecBody {
  float* y;

  __device__ void init(const Params& P, unsigned char* smem, int) {
    y = reinterpret_cast<float*>(smem + P.out_off);
    for (int i = threadIdx.x; i < P.tile[P.out_ax1]; i += blockDim.x)
      y[i] = 0.f;
  }

  template <class VA, class VX>
  __device__ void step(const Params& P, const Ctx& cx, const VA& A,
                       const VX& X) {
    const int ni = cx.ext[P.out_ax1], kext = cx.ext[P.red];
    if constexpr (!TRANSPOSED) {  // A block [i, j]: a warp per row
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int r = warp; r < ni; r += blockDim.x >> 5) {
        float s = 0.f;
        for (int j = lane; j < kext; j += 32) s = fmaf(A.f(r, j), X.f(0, j), s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) y[r] = in_dtype<T>(y[r] + s);
      }
    } else {  // A block [j, i]: lanes across 32 columns, warps down rows
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int nw = blockDim.x >> 5;
      float* part = y + ((P.tile[P.out_ax1] + 31) & ~31);  // [nw][32]
      for (int i0 = 0; i0 < ni; i0 += 32) {
        const int i = i0 + lane;
        float s = 0.f;
        if (i < ni)
          for (int j = warp; j < kext; j += nw) s = fmaf(A.f(j, i), X.f(0, j), s);
        part[warp * 32 + lane] = s;
        __syncthreads();
        if (warp == 0 && i < ni) {  // the warps' sums in a fixed order
          float t = 0.f;
          for (int w = 0; w < nw; ++w) t += part[w * 32 + lane];
          y[i] = in_dtype<T>(y[i] + t);
        }
        __syncthreads();
      }
    }
  }

  __device__ void finish(const Params& P, const Ctx& cx) {
    __syncthreads();
    T* out = static_cast<T*>(P.out);
    const int o = cx.org[P.out_ax1];
    for (int i = threadIdx.x; i < cx.ext[P.out_ax1]; i += blockDim.x)
      out[o + i] = from_f<T>(y[i]);
  }
};

// One pass of a block: the reduction loop over the staged (or, unmodified,
// the device-memory) blocks, then the output tile's store.
template <class Body, typename T>
__device__ void run_pass(const Params& P, const Ctx& cx, unsigned char* smem,
                         int pass) {
  const int nk = P.ntile[P.red];
  Body body;
  body.init(P, smem, pass);
  __syncthreads();
  if (P.staged) {
    stage<T>(P, cx, smem);
    cp_async_commit();
    for (int s = 0; s < nk; ++s) {
      const Ctx cs = at_step(P, cx, s);
      if (P.nbuf == 2 && s + 1 < nk) {  // load step s+1 while s computes
        stage<T>(P, at_step(P, cx, s + 1),
                 smem + ((s + 1) & 1) * P.stage_bytes);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* buf = smem + (P.nbuf == 2 ? (s & 1) : 0) *
                                            P.stage_bytes;
      body.step(P, cs, sview<T>(P.in[0], buf), sview<T>(P.in[1], buf));
      __syncthreads();
      if (P.nbuf == 1 && s + 1 < nk) {
        stage<T>(P, at_step(P, cx, s + 1), smem);
        cp_async_commit();
      }
    }
  } else {
    for (int s = 0; s < nk; ++s) {
      const Ctx cs = at_step(P, cx, s);
      body.step(P, cs, gview<T>(P.in[0], cs), gview<T>(P.in[1], cs));
    }
  }
  body.finish(P, cx);
  __syncthreads();  // a next pass restages the buffers
}

template <class Body, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    tiled_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Ctx cx = block_ctx(P);
  for (int pass = 0; pass < P.npass; ++pass)
    run_pass<Body, T>(P, cx, smem, pass);
}

template <class Body, typename T>
cudaError_t launch(const Params& P, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  auto kern = tiled_kernel<Body, T>;
  static int opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {            // (set once, so launches can be graphed)
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  kern<<<blocks, threads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <int ISA, typename T>
cudaError_t launch_gemm(const Params& P, int fpw, int blocks, int threads,
                        int smem, cudaStream_t s) {
  switch (fpw) {
    case 1: return launch<GemmBody<ISA, 1, T>, T>(P, blocks, threads, smem, s);
    case 2: return launch<GemmBody<ISA, 2, T>, T>(P, blocks, threads, smem, s);
    case 4: return launch<GemmBody<ISA, 4, T>, T>(P, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Params& P, const int* f, cudaStream_t s) {
  const int blocks = f[F_BLOCKS], threads = f[F_THREADS], smem = f[F_SMEM];
  switch (f[F_BODY]) {
    case GEMM_MXU:
      return launch_gemm<GEMM_MXU, T>(P, f[F_FPW], blocks, threads, smem, s);
    case GEMM_VPU:
      return launch_gemm<GEMM_VPU, T>(P, f[F_FPW], blocks, threads, smem, s);
    case GEMM_LOOP:
      return launch_gemm<GEMM_LOOP, T>(P, f[F_FPW], blocks, threads, smem, s);
    case MATVEC:
      return launch<MatvecBody<false, T>, T>(P, blocks, threads, smem, s);
    case MATVEC_T:
      return launch<MatvecBody<true, T>, T>(P, blocks, threads, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch one planned kernel. `f` holds F_COUNT ints in the order of Field
// (kernels/tiled.py lays them out). Returns a cudaError_t value: 0 on a
// launch that was accepted.
int autodma_tiled(const void* in0, const void* in1, void* out, const int* f,
                  int n_fields, float alpha, void* stream) {
  if (n_fields != F_COUNT) return cudaErrorInvalidValue;
  if (f[F_SMEM] > MAX_SMEM || f[F_THREADS] > MAX_THREADS ||
      f[F_THREADS] % 32 != 0 || f[F_RED] < 0)
    return cudaErrorInvalidConfiguration;
  if (f[F_BLOCKS] == 0) return cudaSuccess;
  Params P;
  const void* ptrs[2] = {in0, in1};
  for (int k = 0; k < 2; ++k) {
    const int* a = f + F_IN0 + k * F_IN_FIELDS;
    P.in[k] = {ptrs[k], a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]};
  }
  P.out = out;
  P.out_rows = f[F_OUT_ROWS];
  P.out_cols = f[F_OUT_COLS];
  P.out_ax0 = f[F_OUT_AX0];
  P.out_ax1 = f[F_OUT_AX1];
  for (int a = 0; a < 3; ++a) {
    P.bound[a] = f[F_BOUND + a];
    P.tile[a] = f[F_TILE + a];
    P.ntile[a] = f[F_NTILE + a];
  }
  P.par0 = f[F_PAR0];
  P.par1 = f[F_PAR1];
  P.red = f[F_RED];
  P.staged = f[F_STAGED];
  P.nbuf = f[F_NBUF];
  P.stage_bytes = f[F_STAGE_BYTES];
  P.out_off = f[F_OUT_OFF];
  P.nrg = f[F_NRG];
  P.ncg = f[F_NCG];
  P.npass = f[F_NPASS];
  P.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f[F_DTYPE]) {
    case F32: return dispatch<float>(P, f, s);
    case BF16: return dispatch<__nv_bfloat16>(P, f, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* autodma_tiled_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
