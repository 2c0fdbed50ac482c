// Symmetric int8 wire quantization for Hopper (sm_90a): two entry points.
//
// Replaces the Pallas TPU kernels of client_tpu/ops/__init__.py:
// - _quantize_kernel (quantize_int8): q = clip(round(f32(x) * inv_scale),
//   -127, 127) as int8, where inv_scale is float32(1.0 / scale) computed by
//   the caller in double precision, as JAX folds it in Python. The kernel
//   multiplies by it (it never divides by scale: element-exact agreement
//   depends on that) and rounds with rintf, half to even like jnp.round.
// - _dequantize_kernel (dequantize_int8): out = f32(q) * f32(scale), cast to
//   the output dtype (fp32, or bf16 / fp16 rounded to nearest even).
// Both take every input type of dispatch_input (elementwise.cuh): fp32,
// bf16, fp16, uint8, int8, int16, int32 and bool, as the JAX kernels do;
// int8 is dequantize's wire type.
//
// Bound on the H100: bytes. Each element is read once and written once with
// one or two flops between, far below the card's balance point, so the least
// time is the bytes moved over 3.35 TB/s.
// - quantize narrows (or, from 1-byte input, keeps the width): a thread
//   loads 16 bytes of input (4 fp32 or int32, 8 bf16, fp16 or int16, 16
//   1-byte elements) and stores 4, 8 or 16 bytes of int8, in a grid-stride
//   loop over at most 4096 blocks.
// - dequantize widens from int8, and runs the word loop of elementwise.cuh
//   (the one normalize_image runs): a lane per 16-byte output word, which is
//   one 4-byte load of 4 int8 values for fp32 out, or one 8-byte load of 8
//   for bf16 and fp16 out (a wider input moves whole words on its side), so
//   each store instruction of a warp writes 512 contiguous bytes; the grid is a thread per word up to 128 blocks a SM
//   (dequantize_plan in ops/quantize.py). Sixteen int8 values a thread,
//   stored as four 16-byte words 64 bytes apart across the lanes of a warp,
//   reach only half the bytes bound at 64 MiB on the H100 (PERF.md).
// The few elements past the last whole vector or word are done one by one;
// where the input or output is not 16-byte aligned (a view into a larger
// tensor), every element is. The host entry points return the launch's
// cudaError_t; they take the caller's stream and allocate nothing.

#include "elementwise.cuh"

namespace {

using namespace elementwise;

constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ int8_t quantize_one(float x, float inv_scale) {
  const float r = rintf(__fmul_rn(x, inv_scale));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, long long n,
                float inv_scale) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if constexpr (kVectorized) {
    const long long vecs = n / kVec;
    for (long long i = first; i < vecs; i += stride) {
      const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
      T vals[kVec];
      memcpy(vals, &raw, sizeof(raw));
      int8_t packed[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) packed[e] = quantize_one(to_f32(vals[e]), inv_scale);
      using Packed = typename Word<kVec>::type;
      Packed word;
      memcpy(&word, packed, sizeof(word));
      reinterpret_cast<Packed*>(q)[i] = word;
    }
    done = vecs * kVec;
  }
  for (long long i = done + first; i < n; i += stride) {
    q[i] = quantize_one(to_f32(x[i]), inv_scale);
  }
}

struct Scale {
  float scale;
  __device__ __forceinline__ float operator()(float x) const { return __fmul_rn(x, scale); }
};

template <typename In, typename Out, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const In* __restrict__ q, Out* __restrict__ out, long long n, float scale) {
  map_words<In, Out, kVectorized>(q, out, n, Scale{scale});
}

int blocks_for(long long n, int per_thread) {
  const long long vecs = (n + per_thread - 1) / per_thread;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

template <typename T>
int quantize(const void* x, void* q, long long n, float inv_scale, cudaStream_t s) {
  const T* src = static_cast<const T*>(x);
  int8_t* dst = static_cast<int8_t*>(q);
  if (aligned16(x, q)) {
    quantize_kernel<T, true><<<blocks_for(n, 16 / sizeof(T)), kThreads, 0, s>>>(
        src, dst, n, inv_scale);
  } else {
    quantize_kernel<T, false><<<blocks_for(n, 1), kThreads, 0, s>>>(src, dst, n, inv_scale);
  }
  return (int)cudaGetLastError();
}

template <typename In, typename Out>
int dequantize(const void* q, void* out, long long n, float scale, int blocks,
               cudaStream_t s) {
  const In* src = static_cast<const In*>(q);
  Out* dst = static_cast<Out*>(out);
  if (aligned16(q, out)) {
    dequantize_kernel<In, Out, true><<<blocks, kThreads, 0, s>>>(src, dst, n, scale);
  } else {
    dequantize_kernel<In, Out, false><<<blocks, kThreads, 0, s>>>(src, dst, n, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: n elements of the input code `dtype` (dispatch_input in
// elementwise.cuh: fp32, bf16, fp16, uint8, int8, int16, int32 or bool); q:
// n int8. Returns a cudaError_t (0 = launched).
extern "C" int quantize_int8_launch(const void* x, void* q, long long n, int dtype,
                                    float inv_scale, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_input(dtype, [&](auto tag) {
    return quantize<typename decltype(tag)::type>(x, q, n, inv_scale, s);
  });
}

// q: n elements of the input code `in_dtype` (as quantize's x; int8 on the
// wire path); out: n elements, fp32 (out_dtype 0), bf16 (1) or fp16 (2);
// `blocks` blocks of 256 threads. Returns a cudaError_t (0 = launched).
extern "C" int dequantize_int8_launch(const void* q, void* out, long long n, int in_dtype,
                                      int out_dtype, float scale, int blocks, void* stream) {
  if (n <= 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_input(in_dtype, [&](auto tag) {
    using In = typename decltype(tag)::type;
    switch (out_dtype) {
      case 0: return dequantize<In, float>(q, out, n, scale, blocks, s);
      case 1: return dequantize<In, __nv_bfloat16>(q, out, n, scale, blocks, s);
      case 2: return dequantize<In, __half>(q, out, n, scale, blocks, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
