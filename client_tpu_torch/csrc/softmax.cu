// Row softmax for Hopper (sm_90a): probabilities over the last axis.
//
// Replaces the Pallas TPU kernel of client_tpu/ops/__init__.py,
// _softmax_kernel (softmax_probabilities): per row, x (fp32, bf16, fp16,
// uint8, int8, int16, int32 or bool, as dispatch_input in elementwise.cuh
// reads them) upcast to fp32,
// m = max(x), e = exp(x - m), out = e / sum(e), written as fp32. expf and
// IEEE division (no __expf, no __fdividef, no fast-math flags) keep the
// result within rtol 1e-5 of the plain version. A row that is all -inf
// gives NaN, as in JAX: nothing is special-cased.
//
// Bound on the H100: bytes (a few operations per element; each logit is read
// once and each probability written once). The design reads every row from
// device memory exactly once where it can:
//
// - registers (softmax_registers_kernel): a group of 1, 2, 4 or 8 warps owns
//   a row and holds all of it in registers, V 16-byte vectors a thread (4 fp32
//   or int32, 8 bf16, fp16 or int16, or 16 of a 1-byte type each),
//   neighbouring threads on neighbouring vectors. The max, the exponentials
//   and their sum come from the registers; each element's expf runs once,
//   and the row is written once with 16-byte stores. Up to 8192 columns
//   (256 threads x 32 values: 8 vectors of 4-byte values, 4 of 2-byte, 2 of
//   1-byte).
// - two passes (softmax_two_pass_kernel<T, true>): longer rows. An online
//   (max, sum) pass with 16-byte loads, then one pass that writes.
// - scalar (softmax_two_pass_kernel<T, false>): rows that are not 16-byte
//   aligned (a row length in bytes or a base address that is not a multiple
//   of 16). The two passes with 4- or 2-byte loads: slow but right.
//
// How many warps share a row is chosen on the host (softmax_plan in
// ops/softmax.py): one warp per row when the rows fill the card, up to a
// block of 8 warps (reduced through shared memory) when they are few, as the
// classifier's single row of 1000 logits is. A 256-thread block holds 8 /
// warps rows; blocks walk the rows grid-stride. The host entry point returns
// the launch's cudaError_t; it takes the caller's stream and allocates
// nothing.

#include <math.h>

#include "elementwise.cuh"

namespace {

using elementwise::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The kElems values of one 16-byte vector of T, as fp32. The vector is taken
// by value: the caller's load is one 16-byte load (a memcpy from a reference
// into device memory compiles to 16 byte loads).
template <typename T>
__device__ __forceinline__ void unpack(const uint4 raw, float* v) {
  constexpr int kElems = 16 / sizeof(T);
  T vals[kElems];
  memcpy(vals, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < kElems; ++e) v[e] = to_f32(vals[e]);
}

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

// Max (kMax) or sum of one value per thread over the `warps` warps that own a
// row; every thread of the group gets the result. Called by every thread of
// the block (it synchronises the block when warps > 1).
template <bool kMax>
__device__ __forceinline__ float group_reduce(float v, int warps, float* scratch) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if (warps == 1) return v;
  const int warp = threadIdx.x / 32;
  __syncthreads();  // scratch may still be read by the previous reduction
  if (threadIdx.x % 32 == 0) scratch[warp] = v;
  __syncthreads();
  const int first = warp - warp % warps;
  v = scratch[first];
  for (int w = 1; w < warps; ++w) {
    v = kMax ? fmaxf(v, scratch[first + w]) : v + scratch[first + w];
  }
  return v;
}

// Whole rows in registers: V vectors of kElems a thread, `warps` warps a row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
softmax_registers_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows,
                         int cols, int warps) {
  constexpr int kElems = 16 / sizeof(T);
  __shared__ float scratch[kWarps];
  const int group_threads = 32 * warps;
  const int per_block = kWarps / warps;
  const int t = threadIdx.x % group_threads;
  const int vecs = cols / kElems;
  for (long long base = (long long)blockIdx.x * per_block; base < rows;
       base += (long long)gridDim.x * per_block) {
    const long long r = base + threadIdx.x / group_threads;
    const bool live = r < rows;
    const uint4* src = reinterpret_cast<const uint4*>(x + (live ? r : 0) * cols);
    float v[V][kElems];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = t + k * group_threads;
      if (live && j < vecs) {
        unpack<T>(src[j], v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) v[k][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e) m = fmaxf(m, v[k][e]);
    }
    m = group_reduce<true>(m, warps, scratch);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool valid = live && t + k * group_threads < vecs;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        v[k][e] = valid ? expf(v[k][e] - m) : 0.f;
        s += v[k][e];
      }
    }
    s = group_reduce<false>(s, warps, scratch);
    if (!live) continue;
    float4* dst = reinterpret_cast<float4*>(out + r * cols);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = t + k * group_threads;
      if (j < vecs) {
#pragma unroll
        for (int q = 0; q < kElems / 4; ++q) {
          dst[j * (kElems / 4) + q] = make_float4(v[k][4 * q] / s, v[k][4 * q + 1] / s,
                                                  v[k][4 * q + 2] / s, v[k][4 * q + 3] / s);
        }
      }
    }
  }
}

// Fold the values of one chunk (a vector, or one element) into the running
// (m, s): s is the sum of exp(x - m) over the elements seen. A -inf element
// adds 0 (while m is still -inf, exp(-inf - -inf) would be NaN); a NaN
// element makes s NaN, as it makes the plain version's sum NaN.
template <int kN>
__device__ __forceinline__ void online(const float* v, float& m, float& s) {
  float cm = v[0];
#pragma unroll
  for (int e = 1; e < kN; ++e) cm = fmaxf(cm, v[e]);
  if (cm > m) {
    s *= expf(m - cm);
    m = cm;
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) s += v[e] == -INFINITY ? 0.f : expf(v[e] - m);
}

// (m, s) merged with (om, os): a part whose max is -inf weighs 0.
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  s = s * (m == -INFINITY ? 0.f : expf(m - nm)) + os * (om == -INFINITY ? 0.f : expf(om - nm));
  m = nm;
}

// Rows too long for registers (kVector) or not 16-byte aligned (!kVector):
// an online (max, sum) pass, then one pass that writes.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
softmax_two_pass_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows,
                        long long cols, int warps) {
  constexpr int kElems = kVector ? 16 / sizeof(T) : 1;
  __shared__ float scratch_m[kWarps];
  __shared__ float scratch_s[kWarps];
  const int group_threads = 32 * warps;
  const int per_block = kWarps / warps;
  const int t = threadIdx.x % group_threads;
  const int warp = threadIdx.x / 32;
  const long long units = cols / kElems;
  for (long long base = (long long)blockIdx.x * per_block; base < rows;
       base += (long long)gridDim.x * per_block) {
    const long long r = base + threadIdx.x / group_threads;
    const bool live = r < rows;
    const T* row = x + (live ? r : 0) * cols;
    float m = -INFINITY, s = 0.f;
    for (long long j = live ? t : units; j < units; j += group_threads) {
      float v[kElems];
      if constexpr (kVector) {
        unpack<T>(reinterpret_cast<const uint4*>(row)[j], v);
      } else {
        v[0] = to_f32(row[j]);
      }
      online<kElems>(v, m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const float os = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, om, os);
    }
    if (warps > 1) {
      __syncthreads();  // the scratch of the previous row may still be read
      if (threadIdx.x % 32 == 0) {
        scratch_m[warp] = m;
        scratch_s[warp] = s;
      }
      __syncthreads();
      const int first = warp - warp % warps;
      m = scratch_m[first];
      s = scratch_s[first];
      for (int w = 1; w < warps; ++w) merge(m, s, scratch_m[first + w], scratch_s[first + w]);
    }
    if (!live) continue;
    float* dst = out + r * cols;
    for (long long j = t; j < units; j += group_threads) {
      if constexpr (kVector) {
        float v[kElems];
        unpack<T>(reinterpret_cast<const uint4*>(row)[j], v);
#pragma unroll
        for (int q = 0; q < kElems / 4; ++q) {
          reinterpret_cast<float4*>(dst)[j * (kElems / 4) + q] = make_float4(
              expf(v[4 * q] - m) / s, expf(v[4 * q + 1] - m) / s, expf(v[4 * q + 2] - m) / s,
              expf(v[4 * q + 3] - m) / s);
        }
      } else {
        dst[j] = expf(to_f32(row[j]) - m) / s;
      }
    }
  }
}

template <typename T, int V>
int launch_registers(const T* x, float* out, long long rows, long long cols, int warps,
                     int blocks, cudaStream_t s) {
  softmax_registers_kernel<T, V><<<blocks, kThreads, 0, s>>>(x, out, rows, (int)cols, warps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, float* out, long long rows, long long cols, int variant, int warps,
           int vectors, int blocks, cudaStream_t s) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kMaxVectors = 32 / kElems;  // 32 fp32 values a thread
  const T* src = static_cast<const T*>(x);
  if (warps != 1 && warps != 2 && warps != 4 && warps != 8) return (int)cudaErrorInvalidValue;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0
                       && cols % kElems == 0;
  switch (variant) {
    case 0: {  // registers
      if (!aligned || vectors > kMaxVectors || cols / kElems > 32LL * warps * vectors) {
        return (int)cudaErrorInvalidValue;
      }
      // only the vector counts that keep a thread at 32 values or fewer are
      // instantiated
      switch (vectors) {
        case 1: return launch_registers<T, 1>(src, out, rows, cols, warps, blocks, s);
        case 2:
          if constexpr (kMaxVectors >= 2) {
            return launch_registers<T, 2>(src, out, rows, cols, warps, blocks, s);
          }
          return (int)cudaErrorInvalidValue;
        case 4:
          if constexpr (kMaxVectors >= 4) {
            return launch_registers<T, 4>(src, out, rows, cols, warps, blocks, s);
          }
          return (int)cudaErrorInvalidValue;
        case 8:
          if constexpr (kMaxVectors >= 8) {
            return launch_registers<T, 8>(src, out, rows, cols, warps, blocks, s);
          }
          return (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
      }
    }
    case 1:  // two passes, 16-byte loads
      if (!aligned) return (int)cudaErrorInvalidValue;
      softmax_two_pass_kernel<T, true><<<blocks, kThreads, 0, s>>>(src, out, rows, cols, warps);
      return (int)cudaGetLastError();
    case 2:  // two passes, scalar loads
      softmax_two_pass_kernel<T, false><<<blocks, kThreads, 0, s>>>(src, out, rows, cols, warps);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: rows x cols, row-major, of the input code `dtype` (dispatch_input in
// elementwise.cuh: fp32, bf16, fp16, uint8, int8, int16, int32 or bool);
// out: rows x cols fp32. variant 0 (registers, `vectors` 16-byte vectors a thread), 1
// (two passes, 16-byte loads) or 2 (two passes, scalar); `warps` (1, 2, 4 or
// 8) warps a row; `blocks` blocks of 256 threads. Returns a cudaError_t (0 =
// launched).
extern "C" int softmax_launch(const void* x, void* out, long long rows, long long cols,
                              int dtype, int variant, int warps, int vectors, int blocks,
                              void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(out);
  return elementwise::dispatch_input(dtype, [&](auto tag) {
    return launch<typename decltype(tag)::type>(x, dst, rows, cols, variant, warps, vectors,
                                                blocks, s);
  });
}
