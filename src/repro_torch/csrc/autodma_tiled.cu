// The AutoDMA tiled-kernel builder for Hopper (sm_90a), with the bodies of
// gemm (three ISA-study variants), matvec, matvec_t and covar's two passes.
//
// Replaces: src/repro/core/autodma.py:321 pallas_call (the builder) and the
// Pallas bodies it carries: src/repro/kernels/gemm.py:62 gemm (_body_mxu
// :26, _body_vpu :33, _body_loop :42), src/repro/kernels/polybench.py:31
// matvec, :39 matvec_t, and :142 covar (center_body :150, gram_body :167).
//
// What it computes. A Plan from the AutoDMA planner (core/autodma.py) tiles
// a loop nest of at most three axes: parallel axes, then one reduction axis.
// Each input array's block is cut by its per-dimension axis map (`dims`),
// and the body folds one reduction step into the resident output tile:
//   gemm      C = prev + alpha * (A_blk @ B_blk), A [M,K], B [K,N]
//   gram      S = prev + alpha * (A_blk^T @ B_blk), A, B [M,N] dims (2,0),
//             (2,1); covar's Dc^T Dc with alpha = 1/(M-1)
//   matvec    y = prev + A_blk @ x_blk,           A [M,N] dims (0,1)
//   matvec_t  y = prev + A_blk^T @ x_blk,         A [M,N] dims (1,0)
//   center    y = x0_blk - x1_blk                 (no reduction axis)
// with prev = 0 at reduction index 0 and the tile rounded to the dtype
// (f32 or bf16) after every step, as the JAX bodies keep their output block
// in VMEM in that dtype. A spec without a reduction axis (center) runs as
// one step over a virtual third axis of bound 1.
//
// Design. Tiles, grid and axis maps are runtime ints from the Plan (laid
// out by kernels/tiled.py), so one build serves every plan.
//   * gemm and center: one block per tile of the parallel axes (blockIdx.x,
//     row-major over them). The reduction axis, a sequential grid dimension
//     on the TPU, is a loop inside the block; the gemm output tile stays in
//     registers across it.
//   * matvec and matvec_t: a plan tile's reduction steps are spread over
//     the `ks` (<= 8) blocks of one thread-block cluster (blockIdx.x / ks is
//     the tile, blockIdx.x % ks the block's rank). Block c runs steps
//     c*per .. c*per + per - 1 (per = ceil(nk / ks)) in order and writes
//     the f32 partial of each, unrounded, through distributed shared memory
//     into slot s of block 0's shared memory; after a cluster barrier,
//     block 0 folds the slots in step order 0 .. nk-1, y = in_dtype(y +
//     p_s), so the reference's rounding after every step is kept, and
//     stores y. (Writing into block 0, rather than block 0 reading every
//     block's slots, lets the other blocks leave at the barrier: one
//     cluster barrier at the end, not two; it was the faster of the two on
//     the H100.) No atomics, no global scratch: the result is the same run
//     to run and under CUDA-graph replay. One launch (cudaLaunchKernelEx
//     with a cluster dimension).
//   * Each input block is staged from device memory into dynamic shared
//     memory at the offsets its dims give (blockIdx -> grid position ->
//     element origin per array dimension): this is AutoDMA's inferred
//     transfer schedule. Blocks move with 16-byte cp.async where rows are
//     16-byte aligned (else f32 element by element with 4-byte cp.async,
//     bf16 synchronously), double buffered when the plan counted two
//     buffers and the block runs more than one step (step s+1 loads while
//     step s computes). gemm blocks are padded to 16 rows and 32 columns
//     with zeros, so ragged edges (a tile that does not divide the bound)
//     cost no branch in the bodies; the output store is masked.
//   * `unmodified` plans (one whole-array block, which shared memory cannot
//     hold) run unstaged: the kernel covers the output with its own grid of
//     blocks and every operand is read from device memory at each use, the
//     paper's SPM-less baseline. matvec_t's own grid also splits the rows
//     (its reduction) over a cluster; those chunks make up one plan step,
//     so block 0 adds them in f32 and rounds once.
//   * Bodies: gemm_mxu uses tensor cores, mma.sync m16n8k8 TF32 (f32
//     operands, rounded to TF32) or m16n8k16 bf16, f32 accumulation;
//     gemm_vpu multiplies and adds on CUDA cores with __fmul_rn/__fadd_rn,
//     which nvcc never contracts into FFMA (no MAC instruction); gemm_loop
//     runs FFMA in a k-loop over 8-deep slices kept rolled (#pragma unroll
//     1, a software loop); gram is gemm_mxu reading its A fragments through
//     a transposed view of the staged [k, m] block (no transpose pass; the
//     block's row pitch is skewed for that access); matvec / matvec_t read
//     16 bytes a lane (4 f32 or 8 bf16) and keep kLoads = 8 such loads in
//     flight per lane, staged or not (matvec: a warp per row, one shuffle
//     reduction; matvec_t: lanes across column vectors, row groups down
//     the rows, the groups' sums added in a fixed order, one barrier pair
//     per step); center subtracts element by element and stores.
//   * The gemm bodies (mxu, vpu, loop, gram) share one register-blocked
//     warp layout: each warp owns a sub-tile of WR (1, 2 or 4) fragments of
//     16 rows by one of 32 columns in the mma accumulator layout, so each A
//     fragment feeds four products and each B fragment WR; kernels/tiled.py
//     picks WR and the warp count from the plan's output tile (fields fpw,
//     threads, npass) so that no instance spills, and a tile of more
//     sub-tiles than the block's warps is covered in passes. mxu loads its
//     fragments from the staged blocks with ldmatrix (A for TF32 and bf16,
//     B and gram's transposed A with ldmatrix.trans for bf16; TF32 B and
//     gram's TF32 A a 32-bit element a lane from a conflict-free pitch) and
//     rounds each f32 element to TF32 once per load. The same layout runs
//     unstaged from device memory in unmodified mode, and vpu / loop differ
//     from mxu only in the instruction that forms the products. The output
//     tile is scaled by alpha and rounded to the dtype once per plan
//     reduction step; the plan's tiles and bytes are not changed.
//
// What bounds it on the H100. gemm at the suite's shapes is bound by
// operations (2MNK flops against 495 TFLOP/s TF32; ~0.035 ms at 2048^3);
// matvec, matvec_t and center by bytes (each array once at 3.35 TB/s:
// 16.8 MB, 0.0050 ms, for matvec at 2048^2 f32). mma.sync (no wgmma, no
// TMA) and one block per SM at the plans' shared memory keep gemm from the
// tensor cores' rate. matvec / matvec_t use each element of A once, so
// only bytes in flight matter: the plans' 16-32 tiles at 2048^2 would leave
// most SMs idle with one block per tile, so their steps are spread over
// clusters (128-256 blocks at 2048^2 in every mode) and read 16 bytes a
// lane (PERF.md has the times).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_SMEM = 232448;  // shared memory one block may use (H100)
constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

enum BodyId { GEMM_MXU = 0, GEMM_VPU = 1, GEMM_LOOP = 2, MATVEC = 3,
              MATVEC_T = 4, CENTER = 5, GRAM = 6 };
enum DtypeId { F32 = 0, BF16 = 1 };

// The int fields laid out by kernels/tiled.py (FIELDS there), in order.
enum Field {
  F_BODY, F_DTYPE, F_STAGED, F_NBUF, F_STAGE_BYTES, F_OUT_OFF, F_SMEM,
  F_THREADS, F_BLOCKS, F_KS, F_FPW, F_NPASS, F_NRG, F_NCG,
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
  int ks;           // blocks (one cluster) a plan tile's steps are spread over
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

// (the block's plan tile is blockIdx.x / ks: a cluster's blocks share one)
__device__ __forceinline__ Ctx block_ctx(const Params& P) {
  Ctx c;
  int pos[3] = {0, 0, 0};
  const int n1 = P.par1 >= 0 ? P.ntile[P.par1] : 1;
  const int tile = blockIdx.x / P.ks;
  pos[P.par0] = tile / n1;
  if (P.par1 >= 0) pos[P.par1] = tile % n1;
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

// 16 bytes of a row, as V = 16 / sizeof(T) elements, and their f32 values
// (bf16 to f32 is exact: the bits move up by 16)
template <typename T>
__device__ __forceinline__ void unpack(uint4 u, float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// A staged block in shared memory (zero padded: no bounds to check).
template <typename T>
struct SView {
  static constexpr int kStaged = 1;
  const T* p;
  int ld;
  __device__ __forceinline__ float f(int r, int c) const {
    return to_f<T>(p[r * ld + c]);
  }
  __device__ __forceinline__ uint16_t raw(int r, int c) const {
    return bits16(p[r * ld + c]);
  }
  // the 16 bytes from column c (a multiple of 16 / sizeof(T)); staged rows
  // are 16-byte aligned and zero padded
  __device__ __forceinline__ uint4 vec(int r, int c) const {
    return *reinterpret_cast<const uint4*>(p + r * ld + c);
  }
};

// A block read straight from device memory (unmodified mode), masked.
template <typename T>
struct GView {
  static constexpr int kStaged = 0;
  static constexpr int V = 16 / sizeof(T);
  const T* p;
  int ld, r0, c0, er, ec;
  bool v16;  // rows start 16-byte aligned at c0: whole vectors load at once
  __device__ __forceinline__ bool in(int r, int c) const {
    return r < er && c < ec;
  }
  __device__ __forceinline__ float f(int r, int c) const {
    return in(r, c) ? to_f<T>(p[(size_t)(r0 + r) * ld + c0 + c]) : 0.f;
  }
  __device__ __forceinline__ uint16_t raw(int r, int c) const {
    return in(r, c) ? bits16(p[(size_t)(r0 + r) * ld + c0 + c]) : 0;
  }
  // the 16 bytes from column c (a multiple of V) of row r < er: one load,
  // or, for a ragged last vector or unaligned rows, element by element
  // with zeros past ec
  __device__ __forceinline__ uint4 vec(int r, int c) const {
    const T* q = p + (size_t)(r0 + r) * ld + c0 + c;
    if (v16 && c + V <= ec) return __ldg(reinterpret_cast<const uint4*>(q));
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (c + i < ec) {
        if constexpr (std::is_same<T, float>::value)
          w[i] = __float_as_uint(q[i]);
        else
          w[i >> 1] |= static_cast<uint32_t>(bits16(q[i])) << (16 * (i & 1));
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A view read transposed: gram's A block is staged as [k, m] and read as
// [m, k] by the gemm fragment loaders.
template <class V>
struct TView {
  static constexpr int kStaged = V::kStaged == 1 ? 2 : 0;
  V v;
  __device__ __forceinline__ float f(int r, int c) const { return v.f(c, r); }
  __device__ __forceinline__ uint16_t raw(int r, int c) const {
    return v.raw(c, r);
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
  const int c0 = origin(a.ax1, c);
  return {static_cast<const T*>(a.ptr), a.cols, origin(a.ax0, c), c0,
          extent(a.ax0, a.rows, c), extent(a.ax1, a.cols, c),
          a.cols % GView<T>::V == 0 && c0 % GView<T>::V == 0 &&
              reinterpret_cast<uintptr_t>(a.ptr) % 16 == 0};
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
__device__ __forceinline__ void stage(const Params& P, const Ctx& c,
                                      unsigned char* buf) {
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
      // chunk i = r * nv + j of the block, walked by stepping (r, j) by the
      // block's threads, without a division per chunk
      const int nv = a.pcol / V;
      const int dr = blockDim.x / nv, dj = blockDim.x - dr * nv;
      int r = threadIdx.x / nv, j = threadIdx.x - r * nv;
      for (; r < a.prow; r += dr, j += dj) {
        if (j >= nv) {
          j -= nv;
          if (++r >= a.prow) break;
        }
        const int col = j * V;
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
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half of the 13 dropped bits added to the magnitude, then cut),
// in two integer operations: the conversion instruction runs on a slower
// pipe (on the H100 it cost up to a quarter of gemm 2048^3's time)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
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

// --- fragment loaders ------------------------------------------------------
// A warp's mma operands for one k-step: an A fragment (16 rows of the
// output tile, row-major over k) and the B fragments of 32 columns (four
// n8 blocks), in the mma.sync register layouts (lane g = lane/4, q = lane%4).
// Staged blocks are read with ldmatrix where the element layout allows it:
// A row-major (reduction along its rows) for TF32 and bf16 alike (a 32-bit
// element is two b16 halves of an 8x8 b16 matrix), B and gram's transposed A
// (reduction down their columns) with ldmatrix.trans for bf16. TF32 B and
// gram's TF32 A are read one 32-bit element a lane: ldmatrix.trans cannot
// transpose 32-bit elements, and their row pitch (skewed by 8 words,
// kernels/tiled.py) puts the 32 lanes' (k = q, n = g) reads in 32 banks.
// Unstaged views (device memory, unmodified mode) are read element by
// element, masked. Each f32 element is rounded to TF32 (cvt.rna) once per
// load into registers, where the register blocking below reuses it.
__device__ __forceinline__ uint32_t ldsm_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ldsm_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ldsm_addr(p)));
}
__device__ __forceinline__ uint32_t tf32_bits(uint32_t x) {
  return tf32(__uint_as_float(x));
}

template <typename T>
__host__ __device__ constexpr int k_step() {
  return std::is_same<T, float>::value ? 8 : 16;
}

// A fragment of rows r0.., k-step at k
template <typename T, class V>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const V& A, int r0,
                                       int k, int lane) {
  const int g = lane >> 2, q = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V::kStaged == 1) {      // row-major in shared memory
      ldsm_x4(a, A.p + (r0 + (lane & 15)) * A.ld + k + (lane >> 4) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = tf32_bits(a[i]);
    } else {
      a[0] = tf32(A.f(r0 + g, k + q));
      a[1] = tf32(A.f(r0 + g + 8, k + q));
      a[2] = tf32(A.f(r0 + g, k + q + 4));
      a[3] = tf32(A.f(r0 + g + 8, k + q + 4));
    }
  } else if constexpr (V::kStaged == 1) {
    ldsm_x4(a, A.p + (r0 + (lane & 15)) * A.ld + k + (lane >> 4) * 8);
  } else if constexpr (V::kStaged == 2) { // gram: stored [k][m]
    const int mat = lane >> 3;
    ldsm_x4_trans(a, A.v.p + (k + (lane & 7) + (mat >> 1) * 8) * A.v.ld +
                         r0 + (mat & 1) * 8);
  } else {
    const int kk = k + 2 * q;
    a[0] = pack(A.raw(r0 + g, kk), A.raw(r0 + g, kk + 1));
    a[1] = pack(A.raw(r0 + g + 8, kk), A.raw(r0 + g + 8, kk + 1));
    a[2] = pack(A.raw(r0 + g, kk + 8), A.raw(r0 + g, kk + 9));
    a[3] = pack(A.raw(r0 + g + 8, kk + 8), A.raw(r0 + g + 8, kk + 9));
  }
}

// B fragments of columns c0 .. c0+31, k-step at k
template <typename T, class V>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4][2], const V& B,
                                       int k, int c0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      b[t][0] = tf32(B.f(k + q, c0 + 8 * t + g));
      b[t][1] = tf32(B.f(k + q + 4, c0 + 8 * t + g));
    }
  } else if constexpr (V::kStaged == 1) {  // [k][n] in shared memory
    const int mat = lane >> 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];
      ldsm_x4_trans(r, B.p + (k + (mat & 1) * 8 + (lane & 7)) * B.ld + c0 +
                           16 * h + (mat >> 1) * 8);
      b[2 * h][0] = r[0];
      b[2 * h][1] = r[1];
      b[2 * h + 1][0] = r[2];
      b[2 * h + 1][1] = r[3];
    }
  } else {
    const int kk = k + 2 * q;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int n = c0 + 8 * t + g;
      b[t][0] = pack(B.raw(kk, n), B.raw(kk + 1, n));
      b[t][1] = pack(B.raw(kk + 8, n), B.raw(kk + 9, n));
    }
  }
}

// --- gemm bodies: a warp's WR x 1 fragments over one reduction step ------
// The warp's sub-tile is WR row fragments of 16 rows by one column fragment
// of 32 (four n8 blocks): rows r0 .. r0 + 16 WR - 1 (the first `nrf` of its
// fragments hold rows of the tile), columns c0 .. c0 + 31. Lane (g, q) holds
// p[i][t][e] for row r0 + 16 i + g + 8 (e / 2), column c0 + 8 t + 2 q + e % 2
// (the mma.sync accumulator layout). Every A fragment feeds four products,
// every B fragment WR. The three ISA bodies share this layout; only the
// instruction that forms the products differs.
template <int ISA, int WR, typename T, class VA, class VB>
__device__ __forceinline__ void warp_product(float (&p)[WR][4][4],
                                             const VA& A, const VB& B,
                                             int r0, int c0, int nrf,
                                             int kext) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (ISA == GEMM_MXU) {
    // U k-steps at a time: every fragment of the U steps is loaded before
    // their products, so that the loads' latency overlaps (the padding of
    // the staged blocks holds zeros up to whole k-steps)
    constexpr int KS = k_step<T>();
    constexpr int U = WR == 4 ? 1 : 4;   // WR = 4 has 16 products a k-step
    auto ksteps = [&](auto n_steps, int kk) {
      constexpr int N = decltype(n_steps)::value;
      uint32_t b[N][4][2], a[N][WR][4];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        frag_b<T>(b[u], B, kk + u * KS, c0, lane);
#pragma unroll
        for (int i = 0; i < WR; ++i)
          if (i < nrf) frag_a<T>(a[u][i], A, r0 + 16 * i, kk + u * KS, lane);
      }
#pragma unroll
      for (int u = 0; u < N; ++u)
#pragma unroll
        for (int i = 0; i < WR; ++i) {
          if (i >= nrf) break;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if constexpr (std::is_same<T, float>::value)
              mma_tf32(p[i][t], a[u][i][0], a[u][i][1], a[u][i][2],
                       a[u][i][3], b[u][t][0], b[u][t][1]);
            else
              mma_bf16(p[i][t], a[u][i][0], a[u][i][1], a[u][i][2],
                       a[u][i][3], b[u][t][0], b[u][t][1]);
          }
        }
    };
    const int kpad = (kext + KS - 1) / KS * KS;
    int kk = 0;
#pragma unroll 1
    for (; kk + U * KS <= kpad; kk += U * KS)
      ksteps(std::integral_constant<int, U>{}, kk);
#pragma unroll 1
    for (; kk < kpad; kk += KS) ksteps(std::integral_constant<int, 1>{}, kk);
  } else {
    // CUDA cores: per k, the lane's 2 WR values of A and 8 of B, then
    // 8 WR products; vpu multiplies and adds without FMA, loop runs FFMA
    // in a rolled loop over 8-deep slices
    auto slice = [&](int k) {
      float bv[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) bv[t][e] = B.f(k, c0 + 8 * t + 2 * q + e);
#pragma unroll
      for (int i = 0; i < WR; ++i) {
        if (i >= nrf) break;
        const float lo = A.f(r0 + 16 * i + g, k);
        const float hi = A.f(r0 + 16 * i + g + 8, k);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (ISA == GEMM_VPU) {
              p[i][t][e] = __fadd_rn(p[i][t][e], __fmul_rn(lo, bv[t][e]));
              p[i][t][2 + e] =
                  __fadd_rn(p[i][t][2 + e], __fmul_rn(hi, bv[t][e]));
            } else {
              p[i][t][e] = fmaf(lo, bv[t][e], p[i][t][e]);
              p[i][t][2 + e] = fmaf(hi, bv[t][e], p[i][t][2 + e]);
            }
          }
      }
    };
    if constexpr (ISA == GEMM_VPU) {
#pragma unroll 4
      for (int k = 0; k < kext; ++k) slice(k);
    } else {  // GEMM_LOOP: the padding holds zeros
#pragma unroll 1
      for (int kk = 0; kk < kext; kk += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) slice(kk + u);
      }
    }
  }
}

// gemm: each warp owns WR fragments of the output tile in registers (its
// sub-tile; kernels/tiled.py chooses WR and at most 8 warps, so that a
// thread may hold 255 registers and nothing spills). An output tile of
// more sub-tiles than the block's warps is covered in passes, each of
// which runs the whole reduction loop again. TA: A is read transposed
// (gram).
template <int ISA, int WR, typename T, bool TA = false>
struct GemmBody {
  static constexpr int kMaxThreads = 256;   // up to 255 registers a thread
  static constexpr int kMinBlocks = 1;
  static constexpr int kStaged = -1;        // staged or not: P.staged
  static constexpr bool kCluster = false;
  float c[WR][4][4];
  int wt;  // this warp's sub-tile in this pass

  __device__ __forceinline__ void init(const Params&, unsigned char*,
                                       int pass) {
    wt = pass * (blockDim.x >> 5) + (threadIdx.x >> 5);
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][t][e] = 0.f;
  }

  // the sub-tile's origin and row fragments inside the tile (nrf <= 0:
  // no sub-tile, or one wholly past a ragged edge)
  __device__ __forceinline__ void origin(const Params& P, const Ctx& cx,
                                         int& r0, int& c0,
                                         int& nrf) const {
    const int nwr = (P.nrg + WR - 1) / WR;
    nrf = 0;
    r0 = c0 = 0;
    if (wt >= nwr * P.ncg) return;
    const int wrow = wt / P.ncg;
    r0 = wrow * WR * 16;
    c0 = (wt - wrow * P.ncg) * 32;
    if (c0 >= cx.ext[P.out_ax1]) return;
    nrf = min(min(WR, P.nrg - wrow * WR),
              (cx.ext[P.out_ax0] - r0 + 15) / 16);
  }

  template <class VA, class VB>
  __device__ __forceinline__ void step(const Params& P, const Ctx& cx,
                                       const VA& A, const VB& B) {
    int r0, c0, nrf;
    origin(P, cx, r0, c0, nrf);
    if (nrf <= 0) return;
    float p[WR][4][4];
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][t][e] = 0.f;
    const int kext = cx.ext[P.red];
    if constexpr (TA)
      warp_product<ISA, WR, T>(p, TView<VA>{A}, B, r0, c0, nrf, kext);
    else
      warp_product<ISA, WR, T>(p, A, B, r0, c0, nrf, kext);
    // alpha and the rounding to the dtype: once per plan reduction step
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[i][t][e] = in_dtype<T>(
              __fadd_rn(c[i][t][e], __fmul_rn(P.alpha, p[i][t][e])));
  }

  __device__ __forceinline__ void finish(const Params& P, const Ctx& cx) {
    int r0, c0, nrf;
    origin(P, cx, r0, c0, nrf);
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int er = cx.ext[P.out_ax0], ec = cx.ext[P.out_ax1];
    const int or0 = cx.org[P.out_ax0], oc0 = cx.org[P.out_ax1];
    T* out = static_cast<T*>(P.out);
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      if (i >= nrf) break;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 16 * i + g + 8 * (e >> 1);
          const int col = c0 + 8 * t + 2 * q + (e & 1);
          if (r < er && col < ec)
            out[(size_t)(or0 + r) * P.out_cols + oc0 + col] =
                from_f<T>(c[i][t][e]);
        }
    }
  }
};

// The reduction steps a block of a cluster runs, when a plan tile's nk steps
// are spread over P.ks blocks: per = ceil(nk / ks) each, in step order.
__device__ __forceinline__ int steps_per_block(const Params& P) {
  return (P.ntile[P.red] + P.ks - 1) / P.ks;
}

template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 x, float s) {
  float af[16 / sizeof(T)], xf[16 / sizeof(T)];
  unpack<T>(a, af);
  unpack<T>(x, xf);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) s = fmaf(af[e], xf[e], s);
  return s;
}

// matvec / matvec_t: step s's f32 partial of the output tile goes,
// unrounded, to slot s of block 0's shared memory ([nk][tout] floats at
// out_off in every block; block 0's are used); finish() folds them there in
// step order. Loads are 16 bytes a lane, kLoads of them issued before they
// are used. STAGED: an instance for staged plans and one for unmodified
// ones (fewer registers each).
template <bool TRANSPOSED, typename T, bool STAGED>
struct MatvecBody {
  static constexpr int kMaxThreads = 256;
  static constexpr int kStaged = STAGED;
  // 3 blocks an SM (85 registers a thread): at 2, at most 30 clusters of
  // 8 were resident on the H100, and autodma's 32 at 2048^2 took 2 waves;
  // unstaged matvec (ks = 1) keeps 2, for the registers of its 8 + 8
  // loads of A and x a lane
  static constexpr int kMinBlocks = TRANSPOSED || STAGED ? 3 : 2;
  static constexpr bool kCluster = true;
  static constexpr int V = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int kLoads = 8;           // 16-byte loads in flight a lane
  float* part;   // [nk][tout]: every step's partial (block 0's are read)
  float* red;    // matvec_t: [row groups][columns] of one step's sums
  int tout, slot, first;

  __device__ void init(const Params& P, unsigned char* smem, int) {
    tout = (P.tile[P.out_ax1] + 3) & ~3;
    part = reinterpret_cast<float*>(smem + P.out_off);
    red = part + P.ntile[P.red] * tout;
    first = slot = blockIdx.x % P.ks * steps_per_block(P);
    // the cluster's blocks have started before any writes into block 0's
    // shared memory: arrive here, wait before the first step's partial
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // matvec: RB = kLoads / U rows of the warp at a time (rows r0 + nw b),
  // each lane U vectors of each (vectors j0 + 32 u): kLoads 16-byte loads
  // of A in flight a lane, then each x vector, used by the RB rows
  template <int U, class VA, class VX>
  __device__ __forceinline__ void rows(const VA& A, const VX& X, float* y,
                                       int ni, int nv) {
    constexpr int RB = kLoads / U;
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int r0 = threadIdx.x >> 5; r0 < ni; r0 += nw * RB) {
      float s[RB][U];
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int u = 0; u < U; ++u) s[b][u] = 0.f;
      for (int j0 = lane; j0 < nv; j0 += 32 * U) {
        uint4 a[RB][U];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            const int r = r0 + nw * b, j = j0 + 32 * u;
            a[b][u] = r < ni && j < nv ? A.vec(r, j * V)
                                       : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + 32 * u;
          const uint4 x = j < nv ? X.vec(0, j * V) : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int b = 0; b < RB; ++b) s[b][u] = dot16<T>(a[b][u], x, s[b][u]);
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {  // a lane's U sums, then the warp's
        float t = s[b][0];
#pragma unroll
        for (int u = 1; u < U; ++u) t += s[b][u];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (lane == 0 && r0 + nw * b < ni) y[r0 + nw * b] = t;
      }
    }
  }

  template <class VA, class VX>
  __device__ void step(const Params& P, const Ctx& cx, const VA& A,
                       const VX& X) {
    const int ni = cx.ext[P.out_ax1], kext = cx.ext[P.red];
    if (slot == first)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // step s's partial goes to slot s of block 0's shared memory
    float* y = cg::this_cluster().map_shared_rank(part, 0) + slot++ * tout;
    if constexpr (!TRANSPOSED) {
      // A block [i, j]: a warp per row; u vectors a lane cover a row in
      // one pass of 32 lanes (the fewest, a power of 2 up to kLoads), and
      // kLoads / u of the warp's rows go at once
      const int nv = (kext + V - 1) / V;
      if (nv <= 32)
        rows<1>(A, X, y, ni, nv);
      else if (nv <= 64)
        rows<2>(A, X, y, ni, nv);
      else if (nv <= 128)
        rows<4>(A, X, y, ni, nv);
      else
        rows<8>(A, X, y, ni, nv);
    } else {  // A block [j, i]: lanes across column vectors, groups down rows
      const int nvo = (ni + V - 1) / V;
      const int nvb = min(nvo, (int)blockDim.x);  // column vectors a pass
      const int groups = blockDim.x / nvb;
      const int cv = threadIdx.x % nvb, rg = threadIdx.x / nvb;
      // where nvb divides 32, a warp's 32 / nvb row groups are added by
      // shuffles first, and the block adds its warps' sums
      const bool in_warp = nvb < 32 && 32 % nvb == 0;
      const int ng = in_warp ? blockDim.x >> 5 : groups;
      for (int v0 = 0; v0 < nvo; v0 += nvb) {
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        const int c = (v0 + cv) * V;
        if (rg < groups && v0 + cv < nvo) {
          for (int r0 = rg; r0 < kext; r0 += groups * kLoads) {
            uint4 a[kLoads];
            float xs[kLoads];
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              const int r = r0 + groups * u;
              a[u] = make_uint4(0, 0, 0, 0);
              xs[u] = 0.f;
              if (r < kext) {
                a[u] = A.vec(r, c);
                xs[u] = X.f(0, r);
              }
            }
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              float af[V];
              unpack<T>(a[u], af);
#pragma unroll
              for (int e = 0; e < V; ++e) acc[e] = fmaf(af[e], xs[u], acc[e]);
            }
          }
        }
        if (in_warp) {
          for (int o = nvb; o < 32; o <<= 1)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        }
        if (in_warp ? (threadIdx.x & 31) < nvb : rg < groups) {
          const int g = in_warp ? threadIdx.x >> 5 : rg;
#pragma unroll
          for (int e = 0; e < V; ++e) red[(g * nvb + cv) * V + e] = acc[e];
        }
        __syncthreads();
        for (int k = threadIdx.x; k < nvb * V; k += blockDim.x) {
          if (v0 * V + k < ni) {  // the groups' sums in a fixed order
            float t = 0.f;
            for (int g = 0; g < ng; ++g) t += red[g * nvb * V + k];
            y[v0 * V + k] = t;
          }
        }
        __syncthreads();
      }
    }
  }

  // Block 0 of the cluster folds the partials of steps 0 .. nk-1, which
  // every block wrote into its shared memory, in step order: staged,
  // y = in_dtype(y + p_s) (the plan's steps); unstaged matvec_t, the row
  // chunks of its one plan step, added in f32 and rounded once. The other
  // blocks arrive at the cluster barrier (release: their writes are seen
  // after block 0's wait) and leave: no block reads their shared memory.
  __device__ void finish(const Params& P, const Ctx& cx) {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    if (blockIdx.x % P.ks != 0) return;
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const int ni = cx.ext[P.out_ax1], nk = P.ntile[P.red];
    T* out = static_cast<T*>(P.out) + cx.org[P.out_ax1];
    for (int i = threadIdx.x; i < ni; i += blockDim.x) {
      float y = 0.f;
      for (int s = 0; s < nk; ++s) {
        const float p = part[s * tout + i];
        y = STAGED ? in_dtype<T>(y + p) : y + p;
      }
      out[i] = from_f<T>(y);
    }
  }
};

// center: y = x0 - x1 over the block, stored straight to device memory
// (its one reduction step is the virtual axis of bound 1).
template <typename T>
struct CenterBody {
  static constexpr int kMaxThreads = MAX_THREADS;
  static constexpr int kMinBlocks = 1;
  static constexpr int kStaged = -1;
  static constexpr bool kCluster = false;
  __device__ void init(const Params&, unsigned char*, int) {}

  template <class VA, class VB>
  __device__ void step(const Params& P, const Ctx& cx, const VA& A,
                       const VB& B) {
    const int er = cx.ext[P.out_ax0], ec = cx.ext[P.out_ax1];
    const int or0 = cx.org[P.out_ax0], oc0 = cx.org[P.out_ax1];
    T* out = static_cast<T*>(P.out);
    for (int i = threadIdx.x; i < er * ec; i += blockDim.x) {
      const int r = i / ec, c = i - r * ec;
      out[(size_t)(or0 + r) * P.out_cols + oc0 + c] =
          from_f<T>(A.f(r, c) - B.f(r, c));
    }
  }

  __device__ void finish(const Params&, const Ctx&) {}
};

// One pass of a block: the reduction loop over the staged (or, unmodified,
// the device-memory) blocks, then the output tile's store. A block runs
// every step of its tile, or, where a tile's steps are spread over a
// cluster (matvec family), its share of them in order.
template <class Body, typename T>
__device__ __forceinline__ void run_pass(const Params& P, const Ctx& cx,
                                         unsigned char* smem, int pass) {
  const int per = steps_per_block(P);
  const int s0 = blockIdx.x % P.ks * per;
  const int s1 = min(P.ntile[P.red], s0 + per);
  Body body;
  body.init(P, smem, pass);
  __syncthreads();
  if (Body::kStaged < 0 ? P.staged : Body::kStaged) {
    stage<T>(P, at_step(P, cx, s0), smem);
    cp_async_commit();
    for (int s = s0; s < s1; ++s) {
      const Ctx cs = at_step(P, cx, s);
      if (P.nbuf == 2 && s + 1 < s1) {  // load step s+1 while s computes
        stage<T>(P, at_step(P, cx, s + 1),
                 smem + ((s + 1 - s0) & 1) * P.stage_bytes);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* buf = smem + (P.nbuf == 2 ? ((s - s0) & 1) : 0) *
                                            P.stage_bytes;
      body.step(P, cs, sview<T>(P.in[0], buf), sview<T>(P.in[1], buf));
      __syncthreads();
      if (P.nbuf == 1 && s + 1 < s1) {
        stage<T>(P, at_step(P, cx, s + 1), smem);
        cp_async_commit();
      }
    }
  } else {
    for (int s = s0; s < s1; ++s) {
      const Ctx cs = at_step(P, cx, s);
      body.step(P, cs, gview<T>(P.in[0], cs), gview<T>(P.in[1], cs));
    }
  }
  body.finish(P, cx);
  __syncthreads();  // a next pass restages the buffers
}

// (gemm: min. 1 block an SM: without it ptxas held some instances to 80 or
// 128 registers and spilled; matvec: Body::kMinBlocks)
template <class Body, typename T>
__global__ void __launch_bounds__(Body::kMaxThreads, Body::kMinBlocks)
    tiled_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Ctx cx = block_ctx(P);
  for (int pass = 0; pass < P.npass; ++pass)
    run_pass<Body, T>(P, cx, smem, pass);
}

template <class Body, typename T>
cudaError_t launch(const Params& P, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  if (threads > Body::kMaxThreads) return cudaErrorInvalidConfiguration;
  auto kern = tiled_kernel<Body, T>;
  static int opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {            // (set once, so launches can be graphed)
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  if constexpr (Body::kCluster) {  // a cluster of P.ks blocks a plan tile
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks * P.ks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P.ks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kern, P);
    if (e != cudaSuccess) return e;
  } else {
    kern<<<blocks, threads, smem, stream>>>(P);
  }
  return cudaGetLastError();
}

// fpw: the row fragments of a warp's sub-tile (kernels/tiled.py)
template <int ISA, typename T, bool TA = false>
cudaError_t launch_gemm(const Params& P, int fpw, int blocks, int threads,
                        int smem, cudaStream_t s) {
  switch (fpw) {
    case 1:
      return launch<GemmBody<ISA, 1, T, TA>, T>(P, blocks, threads, smem, s);
    case 2:
      return launch<GemmBody<ISA, 2, T, TA>, T>(P, blocks, threads, smem, s);
    case 4:
      return launch<GemmBody<ISA, 4, T, TA>, T>(P, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool TRANSPOSED, typename T>
cudaError_t launch_matvec(const Params& P, int blocks, int threads, int smem,
                          cudaStream_t s) {
  if (P.staged)
    return launch<MatvecBody<TRANSPOSED, T, true>, T>(P, blocks, threads,
                                                      smem, s);
  return launch<MatvecBody<TRANSPOSED, T, false>, T>(P, blocks, threads, smem,
                                                     s);
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
      return launch_matvec<false, T>(P, blocks, threads, smem, s);
    case MATVEC_T:
      return launch_matvec<true, T>(P, blocks, threads, smem, s);
    case CENTER:
      return launch<CenterBody<T>, T>(P, blocks, threads, smem, s);
    case GRAM:
      return launch_gemm<GEMM_MXU, T, true>(P, f[F_FPW], blocks, threads,
                                            smem, s);
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
      f[F_THREADS] % 32 != 0 || f[F_RED] < 0 || f[F_KS] < 1 ||
      f[F_KS] > MAX_CLUSTER)
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
  P.ks = f[F_KS];
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
