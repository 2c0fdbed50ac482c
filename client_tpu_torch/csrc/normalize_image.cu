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
// 3.35 TB/s. Each thread loads 16 bytes of input at a time (4 fp32, 8 bf16
// or 16 uint8 elements) in a grid-stride loop and stores the results as
// whole 16-byte words; the few elements past the last whole vector are done
// one by one. Where the input or output is not 16-byte aligned (a view into
// a larger tensor) every element goes the scalar way. The host entry point
// returns the launch's cudaError_t; it takes the caller's stream and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return (float)x; }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <typename In, typename Out, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const In* __restrict__ x, Out* __restrict__ out, long long n,
                 float scale, float shift) {
  constexpr int kVec = 16 / sizeof(In);                // elements per load
  constexpr int kOutBytes = kVec * (int)sizeof(Out);   // 8 (fp32 -> bf16) to 64 bytes
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if constexpr (kVectorized) {
    const long long vecs = n / kVec;
    for (long long i = first; i < vecs; i += stride) {
      const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
      In vals[kVec];
      memcpy(vals, &raw, sizeof(raw));
      Out res[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) from_f32(__fmaf_rn(to_f32(vals[e]), scale, shift), &res[e]);
      if constexpr (kOutBytes >= 16) {
        uint4* dst = reinterpret_cast<uint4*>(out + i * kVec);
#pragma unroll
        for (int w = 0; w < kOutBytes / 16; ++w) {
          uint4 word;
          memcpy(&word, reinterpret_cast<const unsigned char*>(res) + 16 * w, sizeof(word));
          dst[w] = word;
        }
      } else {
        uint2 word;
        memcpy(&word, res, sizeof(word));
        reinterpret_cast<uint2*>(out)[i] = word;
      }
    }
    done = vecs * kVec;
  }
  for (long long i = done + first; i < n; i += stride) {
    from_f32(__fmaf_rn(to_f32(x[i]), scale, shift), &out[i]);
  }
}

template <typename In, typename Out>
int launch(const void* x, void* out, long long n, float scale, float shift, cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long per_thread = aligned ? 16 / (long long)sizeof(In) : 1;
  const long long work = (n + per_thread - 1) / per_thread;
  long long blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  const In* src = static_cast<const In*>(x);
  Out* dst = static_cast<Out*>(out);
  if (aligned) {
    normalize_kernel<In, Out, true><<<(int)blocks, kThreads, 0, s>>>(src, dst, n, scale, shift);
  } else {
    normalize_kernel<In, Out, false><<<(int)blocks, kThreads, 0, s>>>(src, dst, n, scale, shift);
  }
  return (int)cudaGetLastError();
}

template <typename In>
int launch_out(const void* x, void* out, long long n, int out_dtype, float scale, float shift,
               cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch<In, float>(x, out, n, scale, shift, s);
    case 1: return launch<In, __nv_bfloat16>(x, out, n, scale, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: n elements, fp32 (in_dtype 0), bf16 (1) or uint8 (2); out: n elements,
// fp32 (out_dtype 0) or bf16 (1). Returns a cudaError_t (0 = launched).
extern "C" int normalize_image_launch(const void* x, void* out, long long n, int in_dtype,
                                      int out_dtype, float scale, float shift, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_out<float>(x, out, n, out_dtype, scale, shift, s);
    case 1: return launch_out<__nv_bfloat16>(x, out, n, out_dtype, scale, shift, s);
    case 2: return launch_out<uint8_t>(x, out, n, out_dtype, scale, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
