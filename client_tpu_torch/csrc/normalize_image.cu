// Fused image normalisation for Hopper (sm_90a): out = x * scale + shift.
//
// Replaces the Pallas TPU kernel of client_tpu/ops/__init__.py,
// _normalize_kernel (normalize_image): x * scale + shift cast to the output
// dtype. Each element is f32(x) (fp32, bf16, fp16, uint8, int8, int16 and
// bool in: all exact in fp32; int32 rounded to nearest) times f32(scale)
// plus f32(shift) with ONE rounding, by an explicit __fmaf_rn, so the result
// does not hang on nvcc's -fmad contraction; the JAX kernel rounds once too
// (XLA fuses the multiply-add). bf16 and fp16 output is that fp32 value
// rounded to nearest even.
//
// Bound on the H100: bytes. One FMA per element against 2-8 bytes moved, far
// below the card's balance point, so the least time is the bytes over
// 3.35 TB/s. The word loop of elementwise.cuh moves whole 16-byte words on
// the wider side (a lane per output word on the widening paths, so a warp's
// store covers 512 contiguous bytes), with a grid of a thread per word from
// normalize_plan (ops/normalize.py), so the 224x224x3 image gives all the
// SMs work. On the H100 a word a thread in many blocks moved 64 MiB no
// slower than a grid of one wave with 4 or 8 words in flight a thread
// (PERF.md), so the loop is not unrolled. The host entry point returns the
// launch's cudaError_t; it takes the caller's stream and allocates nothing.

#include "elementwise.cuh"

namespace {

using namespace elementwise;

struct ScaleShift {
  float scale, shift;
  __device__ __forceinline__ float operator()(float x) const {
    return __fmaf_rn(x, scale, shift);
  }
};

template <typename In, typename Out, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const In* __restrict__ x, Out* __restrict__ out, long long n, float scale,
                 float shift) {
  map_words<In, Out, kVectorized>(x, out, n, ScaleShift{scale, shift});
}

template <typename In, typename Out>
int launch(const void* x, void* out, long long n, float scale, float shift, int blocks,
           cudaStream_t s) {
  const In* src = static_cast<const In*>(x);
  Out* dst = static_cast<Out*>(out);
  if (aligned16(x, out)) {
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
    case 2: return launch<In, __half>(x, out, n, scale, shift, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: n elements of the input code in_dtype (dispatch_input in
// elementwise.cuh: fp32, bf16, fp16, uint8, int8, int16, int32 or bool);
// out: n elements, fp32 (out_dtype 0), bf16 (1) or fp16 (2); `blocks`
// blocks of 256 threads. Returns a cudaError_t (0 = launched).
extern "C" int normalize_image_launch(const void* x, void* out, long long n, int in_dtype,
                                      int out_dtype, float scale, float shift, int blocks,
                                      void* stream) {
  if (n <= 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_input(in_dtype, [&](auto tag) {
    using In = typename decltype(tag)::type;
    return launch_out<In>(x, out, n, out_dtype, scale, shift, blocks, s);
  });
}
