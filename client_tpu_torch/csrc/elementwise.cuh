// Shared by the elementwise kernels (normalize_image.cu, quantize_int8.cu,
// softmax.cu): the input element types by the code the wrappers pass
// (dispatch_input), element types to and from fp32, and the word loop of
// the kernels that map one element to one element (normalize_image and
// dequantize_int8).
//
// The word loop: a thread takes kElems = 16 / max(in size, out size)
// elements at a time, so the wider side moves whole 16-byte words. On a
// widening path (uint8 -> fp32, int8 -> bf16, fp16 -> fp32, ...) a thread
// loads 4 or 8 bytes and stores one 16-byte word, and each store instruction
// of a warp writes 512 contiguous bytes; a narrowing path (fp32 -> bf16)
// loads 16 bytes and stores 8. The grid is sized on the host (a thread for
// each word, up to 128 blocks a SM, past which the threads walk the rest
// grid-stride): normalize_plan in ops/normalize.py, which dequantize_plan in
// ops/quantize.py calls. The few elements past the last whole word are done
// one by one; where the input or output is not 16-byte aligned (a view into
// a larger tensor) every element goes the scalar way (kVectorized false).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace elementwise {

constexpr int kThreads = 256;

template <int kBytes> struct Word;
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// every type here but int32 converts to fp32 exactly; int32 rounds to
// nearest even, as a float32 cast does in XLA and PyTorch. A bool is read
// as its byte (uint8_t), which PyTorch and XLA hold at 0 or 1.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(int16_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(int32_t x) { return __int2float_rn(x); }

template <typename T>
struct Tag {
  using type = T;
};

// fn(Tag<In>{}) for the input element type of `code`, the codes of
// ELEMENT_CODES in ops/_kernels.py: 0 fp32, 1 bf16, 2 fp16 (the output
// codes too), 3 uint8, 4 int8, 5 int16, 6 int32, 7 bool (read as uint8)
template <typename Fn>
int dispatch_input(int code, const Fn& fn) {
  switch (code) {
    case 0: return fn(Tag<float>{});
    case 1: return fn(Tag<__nv_bfloat16>{});
    case 2: return fn(Tag<__half>{});
    case 3:
    case 7: return fn(Tag<uint8_t>{});
    case 4: return fn(Tag<int8_t>{});
    case 5: return fn(Tag<int16_t>{});
    case 6: return fn(Tag<int32_t>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 to the output type, rounded to nearest even
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void from_f32(float x, __half* out) { *out = __float2half_rn(x); }

__host__ __device__ constexpr int word_elems(int in_size, int out_size) {
  return 16 / (in_size > out_size ? in_size : out_size);
}

inline bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

// One word of kElems inputs to one word of outputs, op(fp32) per element.
// The word is taken by value, so the caller's load is one wide load (a
// memcpy from a reference into device memory compiles to byte loads).
template <typename In, typename Out, int kElems, typename InWord, typename OutWord, typename Op>
__device__ __forceinline__ OutWord convert(const InWord raw, const Op& op) {
  In vals[kElems];
  memcpy(vals, &raw, sizeof(raw));
  Out res[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) from_f32(op(to_f32(vals[e])), &res[e]);
  OutWord word;
  memcpy(&word, res, sizeof(word));
  return word;
}

// out[i] = op(x[i] as fp32), rounded to Out, for i < n: whole words
// (kVectorized; x and out 16-byte aligned) then the tail one by one, a
// thread a word, grid-stride.
template <typename In, typename Out, bool kVectorized, typename Op>
__device__ __forceinline__ void map_words(const In* __restrict__ x, Out* __restrict__ out,
                                          long long n, const Op& op) {
  constexpr int kElems = word_elems(sizeof(In), sizeof(Out));
  using InWord = typename Word<kElems * sizeof(In)>::type;
  using OutWord = typename Word<kElems * sizeof(Out)>::type;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if constexpr (kVectorized) {
    const long long words = n / kElems;
    const InWord* src = reinterpret_cast<const InWord*>(x);
    OutWord* dst = reinterpret_cast<OutWord*>(out);
    for (long long i = first; i < words; i += stride) {
      dst[i] = convert<In, Out, kElems, InWord, OutWord>(src[i], op);
    }
    done = words * kElems;
  }
  for (long long i = done + first; i < n; i += stride) from_f32(op(to_f32(x[i])), &out[i]);
}

}  // namespace elementwise
