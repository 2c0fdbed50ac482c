// Fused image normalisation for Hopper (sm_90a): out = x * scale + shift.
//
// Replaces the Pallas TPU kernel of client_tpu/ops/__init__.py,
// _normalize_kernel (normalize_image): x * scale + shift cast to the output
// dtype. Each element is f32(x) (fp32, bf16 or uint8 in: all exact in fp32)
// times f32(scale) plus f32(shift) with ONE rounding, by an explicit
// __fmaf_rn, so the result does not hang on nvcc's -fmad contraction; the
// JAX kernel rounds once too (XLA fuses the multiply-add). bf16 output is
// that fp32 value rounded to nearest even.
//
// Bound on the H100: bytes. One FMA per element against 2-8 bytes moved, far
// below the card's balance point, so the least time is the bytes over
// 3.35 TB/s. A thread takes kElems = 16 / max(in size, out size) elements at
// a time, so the wider side moves whole 16-byte words: a widening path
// (uint8 -> fp32, uint8 -> bf16, bf16 -> fp32) loads 4 or 8 bytes and
// stores one 16-byte word, and each store instruction of a warp writes 512
// contiguous bytes; fp32 in loads 16 bytes and stores 16 (fp32) or 8 (bf16).
// The grid is sized on the host (normalize_plan in ops/normalize.py): a
// thread for each word, so the 224x224x3 image gives all the SMs work, up
// to 128 blocks a SM, past which the threads walk the rest grid-stride. On
// the H100 a word a thread in many blocks moved 64 MiB no slower than a
// grid of one wave with 4 or 8 words in flight a thread (PERF.md), so the
// loop is not unrolled. The few elements past the last whole word are done
// one by one; where the input or output is not 16-byte aligned (a view
// into a larger tensor) every element goes the scalar way. The host entry
// point returns the launch's cudaError_t; it takes the caller's stream and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

template <int kBytes> struct Word;
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return (float)x; }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// One word of kElems inputs to one word of outputs. The word is taken by
// value, so the caller's load is one wide load (a memcpy from a reference
// into device memory compiles to byte loads).
template <typename In, typename Out, int kElems, typename InWord, typename OutWord>
__device__ __forceinline__ OutWord convert(const InWord raw, float scale, float shift) {
  In vals[kElems];
  memcpy(vals, &raw, sizeof(raw));
  Out res[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) from_f32(__fmaf_rn(to_f32(vals[e]), scale, shift), &res[e]);
  OutWord word;
  memcpy(&word, res, sizeof(word));
  return word;
}

template <typename In, typename Out, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const In* __restrict__ x, Out* __restrict__ out, long long n, float scale,
                 float shift) {
  constexpr int kElems = 16 / (sizeof(In) > sizeof(Out) ? sizeof(In) : sizeof(Out));
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
      dst[i] = convert<In, Out, kElems, InWord, OutWord>(src[i], scale, shift);
    }
    done = words * kElems;
  }
  for (long long i = done + first; i < n; i += stride) {
    from_f32(__fmaf_rn(to_f32(x[i]), scale, shift), &out[i]);
  }
}

template <typename In, typename Out>
int launch(const void* x, void* out, long long n, float scale, float shift, int blocks,
           cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const In* src = static_cast<const In*>(x);
  Out* dst = static_cast<Out*>(out);
  if (aligned) {
    normalize_kernel<In, Out, true><<<blocks, kThreads, 0, s>>>(src, dst, n, scale, shift);
  } else {
    normalize_kernel<In, Out, false><<<blocks, kThreads, 0, s>>>(src, dst, n, scale, shift);
  }
  return (int)cudaGetLastError();
}

template <typename In>
int launch_out(const void* x, void* out, long long n, int out_dtype, float scale, float shift,
               int blocks, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch<In, float>(x, out, n, scale, shift, blocks, s);
    case 1: return launch<In, __nv_bfloat16>(x, out, n, scale, shift, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: n elements, fp32 (in_dtype 0), bf16 (1) or uint8 (2); out: n elements,
// fp32 (out_dtype 0) or bf16 (1); `blocks` blocks of 256 threads. Returns a
// cudaError_t (0 = launched).
extern "C" int normalize_image_launch(const void* x, void* out, long long n, int in_dtype,
                                      int out_dtype, float scale, float shift, int blocks,
                                      void* stream) {
  if (n <= 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_out<float>(x, out, n, out_dtype, scale, shift, blocks, s);
    case 1: return launch_out<__nv_bfloat16>(x, out, n, out_dtype, scale, shift, blocks, s);
    case 2: return launch_out<uint8_t>(x, out, n, out_dtype, scale, shift, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
