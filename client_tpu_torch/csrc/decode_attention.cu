// Single-query decode attention over a static KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel client_tpu/ops/decode_attention.py
// (_decode_kernel, launched by decode_attention). What it computes:
//   q [B,H,D], k/v [B,H,M,D], pos [B] int32. Cache slots j <= pos[b] attend:
//   out[b,h] = softmax_j(q.k_j * D^-0.5) . v_j, in q's dtype; fp32 or bf16
//   inputs, fp32 accumulation throughout.
//
// Bound on the H100: memory. One decode step reads each live cache row once
// (B*H*(pos+1)*D*2*itemsize bytes of K and V) and does 4 flops per element
// read, far below the card's ~295 flop/byte balance point, so the least time
// is those bytes over 3.35 TB/s.
//
// Design (simple first; split-K across M, TMA and wgmma are later work):
// - one block per (b, h); its 8 warps stride over cache slots (warp w takes
//   slots w, w+8, ...), each lane holding D/32 contiguous elements of q, k
//   and v, so a warp reads one whole cache row per load instruction;
// - each warp keeps an online softmax (running max, running sum, fp32
//   accumulator) in registers; a warp issues the loads of 4 slots before it
//   uses them, to keep more bytes in flight;
// - the loop stops at pos[b], read on the device (no host sync): slots above
//   it are never read, which is the TPU kernel's block skip, and a ragged M
//   needs no padding;
// - the 8 partial states are merged through shared memory at the end.
// The host entry point returns the launch's cudaError_t; it takes the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // slots a warp loads before it uses them

// N consecutive elements at p (aligned to their total size) as floats
template <int N>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* __restrict__ p, float (&out)[N]) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, sizeof(lo));
    memcpy(&hi, &raw.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int heads, int max_len, float scale) {
  constexpr int E = D / 32;  // elements per lane
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // slots <= pos attend; the cache holds max_len of them
  const int last = min(pos[bh / heads], max_len - 1);

  float qf[E];
  load_f32<E>(q + (size_t)bh * D + lane * E, qf);
  const T* kb = k + (size_t)bh * max_len * D + lane * E;
  const T* vb = v + (size_t)bh * max_len * D + lane * E;

  float m = -INFINITY;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int j0 = warp; j0 <= last; j0 += kWarps * kUnroll) {
    float kf[kUnroll][E];
    float vf[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j <= last) {  // uniform across the warp
        load_f32<E>(kb + (size_t)j * D, kf[u]);
        load_f32<E>(vb + (size_t)j * D, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j <= last) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qf[e] * kf[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
        const float m_new = fmaxf(m, s);
        const float corr = expf(m - m_new);  // 0 on the first slot (m = -inf)
        const float p = expf(s - m_new);
        l = l * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] * corr + p * vf[u][e];
        m = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float total = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no slot holds m = -inf and contributes nothing
      const float c = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
      total += sm_l[w] * c;
      o += sm_acc[w][d] * c;
    }
    store_f32(out + (size_t)bh * D + d, o / fmaxf(total, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   void* out, int batch, int heads, int max_len, float scale,
                   cudaStream_t stream) {
  decode_attention_kernel<T, D><<<batch * heads, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<T*>(out), heads, max_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const void* pos,
                         void* out, int batch, int heads, int max_len, int dim,
                         float scale, cudaStream_t stream) {
  switch (dim) {
    case 32: return launch<T, 32>(q, k, v, pos, out, batch, heads, max_len, scale, stream);
    case 64: return launch<T, 64>(q, k, v, pos, out, batch, heads, max_len, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pos, out, batch, heads, max_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int batch, int heads,
                                       int max_len, int dim, int dtype, float scale,
                                       void* stream) {
  if (batch <= 0 || heads <= 0 || max_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<float>(q, k, v, pos, out, batch, heads, max_len, dim, scale, s);
    case 1:
      return (int)dispatch_dim<__nv_bfloat16>(q, k, v, pos, out, batch, heads, max_len, dim,
                                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
