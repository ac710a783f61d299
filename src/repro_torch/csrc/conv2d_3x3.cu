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
// conv2d_plain) compute them, so f32 results agree bit for bit.
//
// What bounds it on the H100: device-memory bytes. A is read once and B
// written once (32 MB at 2048^2 f32: ~0.010 ms at 3.35 TB/s); its 18 flops
// per point (~0.0011 ms at 67 TFLOP/s f32) are far below that.
//
// Design: one block per row tile x column tile. The row tile is the
// reference's bh (kernels/polybench.py conv2d_row_tile), so the grid keeps
// its row tiles; the column tile tw (256 columns, fewer where shared memory
// would not hold the block) splits each row tile further, because on the
// TPU one row tile was one VMEM block while here a block's shared memory
// is 227 KB and many blocks must be in flight (bh = 8 at W = 2048 gives
// 256 x 8 blocks). The block stages its (bh + 2) x (tw + 2) window - halo
// rows from the neighbouring row tiles, halo columns from the neighbouring
// column tiles, zeros past the edges - into shared memory as f32 with
// coalesced loads, then each thread computes outputs from it, neighbouring
// threads on neighbouring columns. Halo rows and columns are read twice
// from device memory (by both neighbours), mostly out of L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // shared memory one block may use (H100)
constexpr int MAX_GRID_Y = 65535;

enum DtypeId { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv2d_kernel(const T* __restrict__ A, const float* __restrict__ c,
                  T* __restrict__ out, int H, int W, int bh, int tw) {
  extern __shared__ float xs[];  // [(bh + 2) x (tw + 2)]
  const int r0 = blockIdx.y * bh, c0 = blockIdx.x * tw;
  const int ld = tw + 2, n = (bh + 2) * ld;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ld, col = i - r * ld;
    const int gr = r0 - 1 + r, gc = c0 - 1 + col;
    xs[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                ? to_f(A[(size_t)gr * W + gc])
                : 0.f;
  }
  float k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = c[t];
  __syncthreads();
  const int ncols = min(tw, W - c0);
  for (int i = threadIdx.x; i < bh * tw; i += blockDim.x) {
    const int r = i / tw, col = i - r * tw;
    if (col >= ncols) continue;
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc = __fadd_rn(acc,
                        __fmul_rn(k[di * 3 + dj], xs[(r + di) * ld + col + dj]));
    out[(size_t)(r0 + r) * W + c0 + col] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* A, const float* c, void* out, int H, int W,
                   int bh, int tw, cudaStream_t stream) {
  const size_t smem = (size_t)(bh + 2) * (tw + 2) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidConfiguration;
  auto kern = conv2d_kernel<T>;
  static size_t opted_in = 48 * 1024;  // set once, so launches can be graphed
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid((W + tw - 1) / tw, H / bh);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(A), c,
                                        static_cast<T*>(out), H, W, bh, tw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B = 3x3 stencil of A [H, W] with zero borders; bh divides H (the row
// tile), tw is the column tile. Returns a cudaError_t value: 0 on a launch
// that was accepted.
int conv2d_3x3(const void* A, const void* c, void* out, int H, int W, int bh,
               int tw, int dtype, void* stream) {
  if (H == 0 || W == 0) return cudaSuccess;
  if (bh <= 0 || tw <= 0 || H % bh || H / bh > MAX_GRID_Y)
    return cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch<float>(A, cf, out, H, W, bh, tw, s);
    case BF16: return launch<__nv_bfloat16>(A, cf, out, H, W, bh, tw, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* conv2d_3x3_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
