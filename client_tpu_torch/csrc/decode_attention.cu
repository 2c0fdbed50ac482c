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
// is those bytes over 3.35 TB/s. What the design does about it is keep
// enough bytes in flight on every SM:
//
// - split-K over the cache: phase 1 runs a grid of (b*h, split) blocks; the
//   wrapper picks the split count from the shapes alone
//   (ops/decode_attention.py:split_plan) so that small B*H still fills the
//   132 SMs. Split i covers slots [i*M/splits, (i+1)*M/splits), clipped on
//   the device to pos[b] (no host sync): slots above it are never read,
//   which is the TPU kernel's block skip, and a ragged M needs no padding;
// - 16-byte loads: a row of the cache is read by D*itemsize/16 lanes (a
//   half-warp per bf16 row at D = 128, so a warp reads two rows per load),
//   and each lane group issues the loads of 4 slots before it uses them:
//   4 KB of K and V in flight per warp at every D and dtype (one split over
//   a cache that fewer loads cover unrolls only as far as it reaches);
// - every lane group keeps an online softmax (running max, sum and fp32
//   accumulator) in registers; the groups of a warp merge by shuffles and
//   the 8 warps through shared memory;
// - with one split the block writes the output itself (no scratch, one
//   launch: the decoder's served shape). With more, each block writes its
//   partial (m, l, acc[D]) in fp32 to the wrapper's scratch and phase 2, a
//   second small kernel (one block per (b, h)), merges the partials by
//   log-sum-exp. A partial that saw no slot (its range starts past pos[b])
//   holds m = -inf, l = 0, acc = 0 and carries zero weight: no
//   exp(-inf - -inf) is ever taken.
// The host entry point returns the first launch error (cudaError_t); it
// takes the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // slots a lane group loads before it uses them (at most)

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte load
  static constexpr int kLanes = D / kVec;           // lanes per cache row
  static constexpr int kRowsPerWarp = 32 / kLanes;  // rows a warp reads per load
  static constexpr int kGroups = kWarps * kRowsPerWarp;
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  memcpy(out, &raw, sizeof(raw));
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  __nv_bfloat162 h[4];
  memcpy(h, &raw, sizeof(raw));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// weight of a softmax state with running max m against the merged max
// (0 for a state that saw no slot)
__device__ __forceinline__ float weight(float m, float merged) {
  return m == -INFINITY ? 0.f : expf(m - merged);
}

// Phase 1: block (bh, split) over its slot range, U slots per lane group
// loaded before they are used. partial == nullptr means one split: the
// block writes the normalized output.
template <typename T, int D, int U>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ pos,
                              T* __restrict__ out, float* __restrict__ partial, int heads,
                              int max_len, int splits, float scale) {
  using L = Layout<T, D>;
  constexpr int VE = L::kVec;
  constexpr int LANES = L::kLanes;
  constexpr int RPW = L::kRowsPerWarp;
  constexpr int STEP = L::kGroups * U;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;  // which 16 bytes of a row this lane reads
  // this warp's first slot in an iteration, and this lane group's offset
  const int warp_slot = warp * RPW;
  const int slot = warp_slot + lane / LANES;

  // this split's slots, clipped to those <= pos (the cache holds max_len);
  // one split skips the 64-bit divisions, on the short caches' critical path
  const int begin = splits == 1 ? 0 : (int)((long long)split * max_len / splits);
  const int stop = splits == 1 ? max_len : (int)((long long)(split + 1) * max_len / splits);
  const int end = min(stop, min(pos[bh / heads], max_len - 1) + 1);

  float qf[VE];
  unpack(__ldg(reinterpret_cast<const uint4*>(q + (size_t)bh * D + sub * VE)), qf);
  const T* kb = k + (size_t)bh * max_len * D + sub * VE;
  const T* vb = v + (size_t)bh * max_len * D + sub * VE;

  float m = -INFINITY;
  float l = 0.f;
  float acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;

  // the loop bound is uniform across the warp (the shuffles below need every
  // lane); a lane group past `end` computes a masked score
  for (int b = begin; b + warp_slot < end; b += STEP) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b + slot + u * L::kGroups;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (j < end) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)j * D));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)j * D));
      }
    }
    float s[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VE];
      unpack(kr[u], kf);
      float d0 = 0.f, d1 = 0.f;  // two chains: half the latency of one
#pragma unroll
      for (int e = 0; e < VE; e += 2) {
        d0 = fmaf(qf[e], kf[e], d0);
        d1 = fmaf(qf[e + 1], kf[e + 1], d1);
      }
      float dot = d0 + d1;
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool live = b + slot + u * L::kGroups < end;
      s[u] = live ? dot * scale : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    // no live slot for this group yet: p = 0 and the correction is 0
    const float m_use = mx == -INFINITY ? 0.f : mx;
    const float corr = expf(m - m_use);
    l *= corr;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - m_use);  // 0 for a masked slot
      float vf[VE];
      unpack(vr[u], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = mx;
  }

  // merge the lane groups of the warp: the warp's max first, then each
  // group's state rescaled to it once, then plain sums (one exp on the
  // path, not one per round)
  float mw = m;
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1)
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  const float c = weight(m, mw);
  l *= c;
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] *= c;
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  m = mw;

  // merge the warps
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < LANES) {
#pragma unroll
    for (int e = 0; e < VE; ++e) sm_acc[warp][sub * VE + e] = acc[e];
  }
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float total = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = weight(sm_m[w], mx);
      total += sm_l[w] * c;
      o += sm_acc[w][d] * c;
    }
    if (partial == nullptr) {
      store_f32(out + (size_t)bh * D + d, o / fmaxf(total, 1e-30f));
    } else {
      // partial (acc[D], m, l) of (bh, split); an empty split writes
      // acc = 0, m = -inf, l = 0
      float* dst = partial + ((size_t)bh * splits + split) * (D + 2);
      dst[d] = o;
      if (d == 0) {
        dst[D] = mx;
        dst[D + 1] = total;
      }
    }
  }
}

// Phase 2: one block of D threads per (b, h) merges its splits' partials.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_attention_merge_kernel(const float* __restrict__ partial, T* __restrict__ out, int splits) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* src = partial + (size_t)bh * splits * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, src[s * (D + 2) + D]);
  float total = 0.f;
  float o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = src + s * (D + 2);
    const float c = weight(p[D], mx);  // an empty split weighs 0
    total += p[D + 1] * c;
    o += p[d] * c;
  }
  store_f32(out + (size_t)bh * D + d, o / fmaxf(total, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   void* partial, int batch, int heads, int max_len, int splits,
                   float scale, cudaStream_t stream) {
  const int bh = batch * heads;
  float* scratch = splits > 1 ? static_cast<float*>(partial) : nullptr;
  // one split over a short cache unrolls only as far as the cache reaches:
  // a smaller body, and no slots past the cache to compute
  constexpr int G = Layout<T, D>::kGroups;
  auto* kernel = decode_attention_split_kernel<T, D, kUnroll>;
  if (splits == 1 && max_len <= G) {
    kernel = decode_attention_split_kernel<T, D, 1>;
  } else if (splits == 1 && max_len <= 2 * G) {
    kernel = decode_attention_split_kernel<T, D, 2>;
  }
  kernel<<<dim3(bh, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<T*>(out), scratch, heads, max_len, splits,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || scratch == nullptr) return err;
  decode_attention_merge_kernel<T, D><<<bh, D, 0, stream>>>(scratch, static_cast<T*>(out), splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const void* pos,
                         void* out, void* partial, int batch, int heads, int max_len,
                         int dim, int splits, float scale, cudaStream_t stream) {
  switch (dim) {
    case 32:
      return launch<T, 32>(q, k, v, pos, out, partial, batch, heads, max_len, splits, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, out, partial, batch, heads, max_len, splits, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, out, partial, batch, heads, max_len, splits, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. splits >= 1 (at most max_len and
// 65535); with splits > 1, partial is fp32 scratch of
// batch * heads * splits * (dim + 2) elements. Returns a cudaError_t
// (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* partial, int batch,
                                       int heads, int max_len, int dim, int dtype,
                                       int splits, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || max_len <= 0 || splits < 1 || splits > max_len ||
      splits > 65535 || (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<float>(q, k, v, pos, out, partial, batch, heads, max_len, dim,
                                      splits, scale, s);
    case 1:
      return (int)dispatch_dim<__nv_bfloat16>(q, k, v, pos, out, partial, batch, heads,
                                              max_len, dim, splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
