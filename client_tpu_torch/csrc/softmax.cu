// Row softmax for Hopper (sm_90a): probabilities over the last axis.
//
// Replaces the Pallas TPU kernel of client_tpu/ops/__init__.py,
// _softmax_kernel (softmax_probabilities): per row, x upcast to fp32,
// m = max(x), e = exp(x - m), out = e / sum(e), written as fp32. expf and
// IEEE division (no __expf, no __fdividef, no fast-math flags) keep the
// result within rtol 1e-5 of the plain version. A row that is all -inf
// gives NaN, as in JAX: nothing is special-cased.
//
// Bound on the H100: bytes (a few operations per element; the row is read
// from device memory once and written once). A row is owned by one warp when
// it is short (<= kWarpCols columns: a classifier's 1000 logits) and by one
// 256-thread block otherwise; each loops over its row, so any length works.
// Three sweeps: the max, the sum of exp(x - m), then the write. The second
// and third re-read the row from L1/L2, not from device memory. Reductions
// go through warp shuffles, and across the block's warps through shared
// memory. The host entry point returns the launch's cudaError_t; it takes the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kWarpsPerBlock = kBlockThreads / 32;
constexpr long long kWarpCols = 2048;
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row: blockDim (32, kWarpsPerBlock), rows walked grid-stride.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
softmax_warp_rows(const T* __restrict__ x, float* __restrict__ out, long long rows,
                  long long cols) {
  const int lane = threadIdx.x;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.y; r < rows;
       r += (long long)gridDim.x * kWarpsPerBlock) {
    const T* row = x + r * cols;
    float* dst = out + r * cols;
    float m = -INFINITY;
    for (long long c = lane; c < cols; c += 32) m = fmaxf(m, to_f32(row[c]));
    m = warp_max(m);
    float s = 0.f;
    for (long long c = lane; c < cols; c += 32) s += expf(to_f32(row[c]) - m);
    s = warp_sum(s);
    for (long long c = lane; c < cols; c += 32) dst[c] = expf(to_f32(row[c]) - m) / s;
  }
}

// The block's reduction of one value per thread; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by the previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kWarpsPerBlock ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

// One block per row: blockDim kBlockThreads, rows walked grid-stride.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
softmax_block_rows(const T* __restrict__ x, float* __restrict__ out, long long rows,
                   long long cols) {
  __shared__ float scratch[kWarpsPerBlock];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* row = x + r * cols;
    float* dst = out + r * cols;
    float m = -INFINITY;
    for (long long c = threadIdx.x; c < cols; c += kBlockThreads) m = fmaxf(m, to_f32(row[c]));
    m = block_reduce<true>(m, scratch);
    float s = 0.f;
    for (long long c = threadIdx.x; c < cols; c += kBlockThreads) s += expf(to_f32(row[c]) - m);
    s = block_reduce<false>(s, scratch);
    for (long long c = threadIdx.x; c < cols; c += kBlockThreads) {
      dst[c] = expf(to_f32(row[c]) - m) / s;
    }
  }
}

template <typename T>
int launch(const void* x, float* out, long long rows, long long cols, cudaStream_t s) {
  const T* src = static_cast<const T*>(x);
  if (cols <= kWarpCols) {
    long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
    softmax_warp_rows<T><<<(int)blocks, dim3(32, kWarpsPerBlock), 0, s>>>(src, out, rows, cols);
  } else {
    const long long blocks = rows > kMaxBlocks ? kMaxBlocks : rows;
    softmax_block_rows<T><<<(int)blocks, kBlockThreads, 0, s>>>(src, out, rows, cols);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows x cols, row-major, fp32 (dtype 0) or bf16 (dtype 1); out: rows x
// cols fp32. Returns a cudaError_t (0 = launched).
extern "C" int softmax_launch(const void* x, void* out, long long rows, long long cols,
                              int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(out);
  switch (dtype) {
    case 0: return launch<float>(x, dst, rows, cols, s);
    case 1: return launch<__nv_bfloat16>(x, dst, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
