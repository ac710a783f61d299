// The 3x3 stencil of the paper's kernel suite (conv2d) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/polybench.py:94 conv2d (its own pallas_call,
// :121; row tiles of bh rows, halo rows taken from the +-1 neighbour blocks
// bound as extra inputs, zero rows at the top and bottom edges, zero
// columns at both sides, f32 accumulation in the order di, then dj).
//
// Computes B[i, j] = sum_{di, dj} c[di][dj] * A[i + di - 1, j + dj - 1] over
// A [H, W] (f32 or bf16, zero outside), c [3, 3] f32, B in A's dtype. Each
// product and sum is rounded on its own (__fmul_rn, __fadd_rn: no FFMA), as
// the reference and the plain PyTorch version (kernels/polybench.py
// conv2d_plain) compute them, so f32 results agree bit for bit. Every
// output is the same nine products in the same order whatever the tiling,
// so the kernel walks bands of its own height, not the reference's row
// tile.
//
// What bounds it on the H100: device-memory bytes. A is read once and B
// written once (32 MB at 2048^2 f32: ~0.010 ms at 3.35 TB/s); its 18 flops
// per point (~0.0011 ms at 67 TFLOP/s f32) are far below that. Reaching the
// byte rate takes ~18 KB of loads in flight on each SM (3.35 TB/s x ~0.7 us
// of latency over 132 SMs).
//
// Design: 16-byte bands with loads in flight, no shared memory.
//
//   * A warp owns a segment of 32 x VEC columns and walks a band of `band`
//     rows down it; a block is WARPS such warps side by side along the row
//     (grid: column segments / WARPS, row bands). Each lane owns VEC
//     consecutive columns (4 f32 or 8 bf16, one 16-byte load and one
//     16-byte store a row); it gets the column left of its first and right
//     of its last from its neighbour lanes with __shfl_up_sync /
//     __shfl_down_sync, and lanes 0 and 31 load the one column beyond the
//     warp's segment themselves (zero past the edges).
//   * Walking down the band, a lane keeps three rows in registers (the
//     rows above, at and below its output row) and DEPTH rows loaded ahead
//     of them, raw, in a ring of registers that the unrolled loop indexes
//     with constants: it converts a row and refills its slot with the row
//     DEPTH further down before computing, so DEPTH loads are in flight
//     while it computes. No integer divide or modulo per element.
//   * VEC = 1 is the same kernel's scalar path, for rows that are not whole
//     16-byte vectors (W not a multiple of VEC, or a base address that is
//     not 16-byte aligned): a lane then owns one column.
//   * Halo rows are read by the two bands that meet there (2 of every
//     `band` + 2 rows read, mostly from L2), halo columns by the two warps
//     that meet there (2 scalars a warp row).
//
// A ring of rows staged in shared memory by 16-byte cp.async was not built:
// the registers hold DEPTH rows ahead without a barrier, neighbours'
// columns come by shuffle, and this design came within ~20 % of the byte
// bound at 2048^2 f32 in check calls. Check calls also set the constants:
// DEPTH 4 over 2 and 8, WARPS 4 over 2 and 8, and bands of 16 rows for
// f32 (over 8, 32, 64 and 128) and 8 for bf16 (over 16 and 32: its lanes
// cover twice the columns, so half as many warps share the rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;           // warps of a block, side by side
constexpr int DEPTH = 4;           // rows a lane has loaded ahead
constexpr int MAX_GRID_Y = 65535;

enum DtypeId { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void put(float* p, float y) { *p = y; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16(y);
}

// A lane's VEC columns of one row: loaded raw, converted to f32 when used,
// and stored from f32 (rounded to nearest for bf16).
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void to_f32(const Raw& r, float* x) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* y) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void to_f32(const Raw& r, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* y) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw zero() { return T(0.f); }
  __device__ __forceinline__ static Raw load(const T* p) { return __ldg(p); }
  __device__ __forceinline__ static void to_f32(const Raw& r, float* x) {
    x[0] = to_f(r);
  }
  __device__ __forceinline__ static void store(T* p, const float* y) {
    put(p, y[0]);
  }
};

// One row of a lane, raw: its VEC columns and, for lanes 0 and 31, the
// column beyond the warp's segment.
template <typename T, int VEC>
struct RawRow {
  typename Vec<T, VEC>::Raw x;
  T edge;
};

template <typename T, int VEC>
__device__ __forceinline__ RawRow<T, VEC> load_row(const T* A, int r,
                                                   bool ok, int W, int col,
                                                   bool in, int edge_col,
                                                   bool has_edge) {
  RawRow<T, VEC> row;
  row.x = Vec<T, VEC>::zero();
  row.edge = T(0.f);
  if (ok) {
    const T* p = A + (size_t)r * W;
    if (in) row.x = Vec<T, VEC>::load(p + col);
    if (has_edge) row.edge = __ldg(p + edge_col);
  }
  return row;
}

// A raw row as f32 columns col - 1 .. col + VEC, the outer two from the
// neighbour lanes (or the lane's own edge column).
template <typename T, int VEC>
__device__ __forceinline__ void expand(const RawRow<T, VEC>& row, int lane,
                                       float (&x)[VEC + 2]) {
  Vec<T, VEC>::to_f32(row.x, x + 1);
  const float up = __shfl_up_sync(0xffffffffu, x[VEC], 1);
  const float down = __shfl_down_sync(0xffffffffu, x[1], 1);
  x[0] = lane == 0 ? to_f(row.edge) : up;
  x[VEC + 1] = lane == 31 ? to_f(row.edge) : down;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
    conv2d_band(const T* __restrict__ A, const float* __restrict__ c,
                T* __restrict__ out, int H, int W, int band) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = (blockIdx.x * WARPS + warp) * 32 * VEC;  // first column
  if (seg >= W) return;                                    // warp-uniform
  const int col = seg + lane * VEC;
  const bool in = col < W;   // VEC divides W: a lane is all in or all out
  const int edge_col = lane == 0 ? seg - 1 : seg + 32 * VEC;
  const bool has_edge = (lane == 0 && seg > 0) ||
                        (lane == 31 && edge_col < W);
  const int r0 = blockIdx.y * band, r_end = min(H, r0 + band);
  float k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = c[t];
  // rows r0 - 1 .. r_end are read; zeros outside A
  auto row_ok = [&](int r) { return r >= 0 && r <= r_end && r < H; };
  RawRow<T, VEC> ring[DEPTH];
  const RawRow<T, VEC> above = load_row<T, VEC>(
      A, r0 - 1, row_ok(r0 - 1), W, col, in, edge_col, has_edge);
  const RawRow<T, VEC> at = load_row<T, VEC>(A, r0, row_ok(r0), W, col, in,
                                             edge_col, has_edge);
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    ring[d] = load_row<T, VEC>(A, r0 + 1 + d, row_ok(r0 + 1 + d), W, col,
                               in, edge_col, has_edge);
  float prev[VEC + 2], cur[VEC + 2], next[VEC + 2];
  expand(above, lane, prev);
  expand(at, lane, cur);
  for (int r = r0; r < r_end; r += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int i = r + d;   // the output row; slot d holds row i + 1
      if (i >= r_end) break;                               // warp-uniform
      expand(ring[d], lane, next);
      const int ahead = i + 1 + DEPTH;
      ring[d] = load_row<T, VEC>(A, ahead, row_ok(ahead), W, col, in,
                                 edge_col, has_edge);
      float y[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          acc = __fadd_rn(acc, __fmul_rn(k[dj], prev[j + dj]));
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          acc = __fadd_rn(acc, __fmul_rn(k[3 + dj], cur[j + dj]));
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          acc = __fadd_rn(acc, __fmul_rn(k[6 + dj], next[j + dj]));
        y[j] = acc;
      }
      if (in) Vec<T, VEC>::store(out + (size_t)i * W + col, y);
#pragma unroll
      for (int j = 0; j < VEC + 2; ++j) {
        prev[j] = cur[j];
        cur[j] = next[j];
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* A, const float* c, void* out, int H,
                       int W, int band, cudaStream_t stream) {
  const int cols = WARPS * 32 * VEC;
  const dim3 grid((W + cols - 1) / cols, (H + band - 1) / band);
  conv2d_band<T, VEC><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(A), c, static_cast<T*>(out), H, W, band);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* A, const float* c, void* out, int H, int W,
                   int band, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec == 1) return launch_vec<T, 1>(A, c, out, H, W, band, stream);
  if (vec != V || W % V || reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  return launch_vec<T, V>(A, c, out, H, W, band, stream);
}

}  // namespace

extern "C" {

// B = 3x3 stencil of A [H, W] with zero borders, in bands of `band` rows (a
// multiple of DEPTH); vec is 1 (the scalar path) or 16 / itemsize (W a
// multiple of it, A and B 16-byte aligned). Returns a cudaError_t value: 0
// on a launch that was accepted.
int conv2d_3x3(const void* A, const void* c, void* out, int H, int W,
               int band, int vec, int dtype, void* stream) {
  if (H == 0 || W == 0) return cudaSuccess;
  if (H < 0 || W < 0 || band <= 0 || band % DEPTH ||
      (H + band - 1) / band > MAX_GRID_Y)
    return cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch<float>(A, cf, out, H, W, band, vec, s);
    case BF16: return launch<__nv_bfloat16>(A, cf, out, H, W, band, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* conv2d_3x3_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
