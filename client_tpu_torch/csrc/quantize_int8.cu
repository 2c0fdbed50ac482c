// Symmetric int8 wire quantization for Hopper (sm_90a): two entry points.
//
// Replaces the Pallas TPU kernels of client_tpu/ops/__init__.py:
// - _quantize_kernel (quantize_int8): q = clip(round(f32(x) * inv_scale),
//   -127, 127) as int8, where inv_scale is float32(1.0 / scale) computed by
//   the caller in double precision, as JAX folds it in Python. The kernel
//   multiplies by it (it never divides by scale: element-exact agreement
//   depends on that) and rounds with rintf, half to even like jnp.round.
// - _dequantize_kernel (dequantize_int8): out = f32(q) * f32(scale), cast to
//   the output dtype (fp32, or bf16 rounded to nearest even).
//
// Bound on the H100: bytes. Each element is read once and written once with
// one or two flops between, far below the card's balance point, so the least
// time is the bytes moved over 3.35 TB/s. Each thread moves 16 bytes of
// input per load (4 fp32, 8 bf16 or 16 int8 elements) in a grid-stride loop,
// and the few elements past the last whole vector are done one by one.
// The host entry points return the launch's cudaError_t; they take the
// caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ int8_t quantize_one(float x, float inv_scale) {
  const float r = rintf(__fmul_rn(x, inv_scale));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, long long n,
                float inv_scale) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long vecs = n / kVec;
  for (long long i = first; i < vecs; i += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    T vals[kVec];
    memcpy(vals, &raw, sizeof(raw));
    int8_t packed[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) packed[e] = quantize_one(to_f32(vals[e]), inv_scale);
    if constexpr (kVec == 4) {
      uint32_t word;
      memcpy(&word, packed, sizeof(word));
      reinterpret_cast<uint32_t*>(q)[i] = word;
    } else {
      uint2 word;
      memcpy(&word, packed, sizeof(word));
      reinterpret_cast<uint2*>(q)[i] = word;
    }
  }
  for (long long i = vecs * kVec + first; i < n; i += stride) {
    q[i] = quantize_one(to_f32(x[i]), inv_scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, T* __restrict__ out, long long n, float scale) {
  constexpr int kVec = 16;                               // int8 elements per load
  constexpr int kStores = kVec * (int)sizeof(T) / 16;    // 16-byte stores per load
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long vecs = n / kVec;
  for (long long i = first; i < vecs; i += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(q)[i];
    int8_t vals[kVec];
    memcpy(vals, &raw, sizeof(raw));
    T res[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) from_f32(__fmul_rn((float)vals[e], scale), &res[e]);
    uint4* dst = reinterpret_cast<uint4*>(out + i * kVec);
#pragma unroll
    for (int w = 0; w < kStores; ++w) {
      uint4 word;
      memcpy(&word, reinterpret_cast<const unsigned char*>(res) + 16 * w, sizeof(word));
      dst[w] = word;
    }
  }
  for (long long i = vecs * kVec + first; i < n; i += stride) {
    from_f32(__fmul_rn((float)q[i], scale), &out[i]);
  }
}

int blocks_for(long long n, int per_thread) {
  const long long vecs = (n + per_thread - 1) / per_thread;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

}  // namespace

// x: n elements, fp32 (dtype 0) or bf16 (dtype 1), 16-byte aligned; q: n
// int8. Returns a cudaError_t (0 = launched).
extern "C" int quantize_int8_launch(const void* x, void* q, long long n, int dtype,
                                    float inv_scale, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      quantize_kernel<float><<<blocks_for(n, 4), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q), n, inv_scale);
      break;
    case 1:
      quantize_kernel<__nv_bfloat16><<<blocks_for(n, 8), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), n, inv_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// q: n int8, 16-byte aligned; out: n elements, fp32 (dtype 0) or bf16
// (dtype 1), 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int dequantize_int8_launch(const void* q, void* out, long long n, int dtype,
                                      float scale, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      dequantize_kernel<float><<<blocks_for(n, 16), kThreads, 0, s>>>(
          static_cast<const int8_t*>(q), static_cast<float*>(out), n, scale);
      break;
    case 1:
      dequantize_kernel<__nv_bfloat16><<<blocks_for(n, 16), kThreads, 0, s>>>(
          static_cast<const int8_t*>(q), static_cast<__nv_bfloat16*>(out), n, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
