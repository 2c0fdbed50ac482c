// Single-query decode attention over a static KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel client_tpu/ops/decode_attention.py
// (_decode_kernel, launched by decode_attention). What it computes:
//   q [B,H,D], k/v [B,H,M,D], pos [B] int32. Cache slots j <= pos[b] attend:
//   out[b,h] = softmax_j(q.k_j * D^-0.5) . v_j, in q's dtype; fp32, bf16 or
//   fp16 inputs, any D from 1 to 256, fp32 accumulation throughout.
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
// - 16-byte loads: the kernel is instantiated for a padded width DP (16,
//   32, 64, 128 or 256; the smallest that holds D) and a row of it is read
//   by min(32, DP*itemsize/16) lanes, each taking DP*itemsize/16/lanes
//   16-byte vectors (two a lane for fp32 at DP = 256; a half-warp per bf16
//   row at D = 128, so a warp reads two rows per load), and each lane group
//   issues the loads of 4 slots before it uses them: 4 KB of K and V in
//   flight per warp at every D and dtype (one split over a cache that fewer
//   loads cover unrolls only as far as it reaches). Vectors at or past the
//   real D are zero and never read; where D * itemsize is not a multiple of
//   16 (bf16 D = 10) or a tensor is not 16-byte aligned, the vectors are
//   read element by element. A D that fills its padded width in aligned
//   rows (32, 64 and 128 in the decoders) runs an instantiation of its own
//   in which D is a constant and no load is checked;
// - every lane group keeps an online softmax (running max, sum and fp32
//   accumulator) in registers; the groups of a warp merge by shuffles and
//   the 8 warps through shared memory;
// - with one split the block writes the output itself (no scratch, one
//   launch: the decoder's served shape). With more, each block writes its
//   partial (m, l, acc[D]) in fp32 to the wrapper's scratch and phase 2, a
//   second small kernel (one block of D threads per (b, h)), merges the
//   partials by log-sum-exp. A partial that saw no slot (its range starts
//   past pos[b]) holds m = -inf, l = 0, acc = 0 and carries zero weight: no
//   exp(-inf - -inf) is ever taken.
// The host entry point returns the first launch error (cudaError_t); it
// takes the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // slots a lane group loads before it uses them (at most)
constexpr int kMaxDim = 256;

template <typename T, int DP>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte load
  static constexpr int kVecs = DP / kVec;           // 16-byte vectors per cache row
  static constexpr int kLanes = kVecs < 32 ? kVecs : 32;  // lanes per cache row
  static constexpr int kPerLane = kVecs / kLanes;   // vectors a lane reads per row
  static constexpr int kRowsPerWarp = 32 / kLanes;  // rows a warp reads per load
  static constexpr int kGroups = kWarps * kRowsPerWarp;
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  memcpy(out, &raw, sizeof(raw));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h[4];
    memcpy(h, &raw, sizeof(raw));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    __nv_bfloat162 h[4];
    memcpy(h, &raw, sizeof(raw));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void unpack_as(const uint4& raw, float (&out)[N]) {
  if constexpr (sizeof(T) == 4) {
    unpack(raw, out);
  } else {
    unpack<T>(raw, out);
  }
}

// the 16-byte vector of a row starting at column c: one load when the row
// holds whole aligned vectors (`whole`, and always with FULL: dim is the
// padded width), else element by element; zero at or past dim (nothing
// past dim is read)
template <bool FULL, typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int c, int dim, bool whole) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if constexpr (FULL) return __ldg(reinterpret_cast<const uint4*>(row + c));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (c >= dim) return r;
  if (whole) return __ldg(reinterpret_cast<const uint4*>(row + c));
  using Raw = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned int>::type;
  const Raw* src = reinterpret_cast<const Raw*>(row);
  Raw vals[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) vals[e] = c + e < dim ? __ldg(src + c + e) : Raw(0);
  memcpy(&r, vals, sizeof(r));
  return r;
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_f32(__half* p, float x) { *p = __float2half_rn(x); }

// weight of a softmax state with running max m against the merged max
// (0 for a state that saw no slot)
__device__ __forceinline__ float weight(float m, float merged) {
  return m == -INFINITY ? 0.f : expf(m - merged);
}

// Phase 1: block (bh, split) over its slot range, U slots per lane group
// loaded before they are used. partial == nullptr means one split: the
// block writes the normalized output. FULL: dim == DP and whole rows, so
// every row offset and load is fixed at compile time (the served head dims
// 32, 64 and 128 run so); otherwise dim and `whole` are read at run time.
template <typename T, int DP, int U, bool FULL>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ pos,
                              T* __restrict__ out, float* __restrict__ partial, int heads,
                              int max_len, int dim, int splits, float scale, int whole) {
  if constexpr (FULL) dim = DP;
  using L = Layout<T, DP>;
  constexpr int VE = L::kVec;
  constexpr int LANES = L::kLanes;
  constexpr int NV = L::kPerLane;
  constexpr int RPW = L::kRowsPerWarp;
  constexpr int STEP = L::kGroups * U;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;  // which vectors of a row this lane reads
  // this warp's first slot in an iteration, and this lane group's offset
  const int warp_slot = warp * RPW;
  const int slot = warp_slot + lane / LANES;

  // this split's slots, clipped to those <= pos (the cache holds max_len);
  // one split skips the 64-bit divisions, on the short caches' critical path
  const int begin = splits == 1 ? 0 : (int)((long long)split * max_len / splits);
  const int stop = splits == 1 ? max_len : (int)((long long)(split + 1) * max_len / splits);
  const int end = min(stop, min(pos[bh / heads], max_len - 1) + 1);

  // vector n of this lane starts at column (sub + LANES * n) * VE
  float qf[NV][VE];
#pragma unroll
  for (int n = 0; n < NV; ++n)
    unpack_as<T>(load_vec<FULL>(q + (size_t)bh * dim, (sub + LANES * n) * VE, dim, whole), qf[n]);
  const T* kb = k + (size_t)bh * max_len * dim;
  const T* vb = v + (size_t)bh * max_len * dim;

  float m = -INFINITY;
  float l = 0.f;
  float acc[NV][VE];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[n][e] = 0.f;

  // the loop bound is uniform across the warp (the shuffles below need every
  // lane); a lane group past `end` computes a masked score
  for (int b = begin; b + warp_slot < end; b += STEP) {
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b + slot + u * L::kGroups;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        kr[u][n] = make_uint4(0u, 0u, 0u, 0u);
        vr[u][n] = kr[u][n];
        if (j < end) {
          const int c = (sub + LANES * n) * VE;
          kr[u][n] = load_vec<FULL>(kb + (size_t)j * dim, c, dim, whole);
          vr[u][n] = load_vec<FULL>(vb + (size_t)j * dim, c, dim, whole);
        }
      }
    }
    float s[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d0 = 0.f, d1 = 0.f;  // two chains: half the latency of one
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float kf[VE];
        unpack_as<T>(kr[u][n], kf);
#pragma unroll
        for (int e = 0; e < VE; e += 2) {
          d0 = fmaf(qf[n][e], kf[e], d0);
          d1 = fmaf(qf[n][e + 1], kf[e + 1], d1);
        }
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
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[n][e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - m_use);  // 0 for a masked slot
      l += p;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float vf[VE];
        unpack_as<T>(vr[u][n], vf);
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[n][e] = fmaf(p, vf[e], acc[n][e]);
      }
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
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[n][e] *= c;
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[n][e] += __shfl_xor_sync(0xffffffffu, acc[n][e], off);
  }
  m = mw;

  // merge the warps
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][DP];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < LANES) {
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VE; ++e) sm_acc[warp][(sub + LANES * n) * VE + e] = acc[n][e];
  }
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  for (int d = threadIdx.x; d < dim; d += kThreads) {
    float total = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = weight(sm_m[w], mx);
      total += sm_l[w] * c;
      o += sm_acc[w][d] * c;
    }
    if (partial == nullptr) {
      store_f32(out + (size_t)bh * dim + d, o / fmaxf(total, 1e-30f));
    } else {
      // partial (acc[D], m, l) of (bh, split); an empty split writes
      // acc = 0, m = -inf, l = 0
      float* dst = partial + ((size_t)bh * splits + split) * (dim + 2);
      dst[d] = o;
      if (d == 0) {
        dst[dim] = mx;
        dst[dim + 1] = total;
      }
    }
  }
}

// Phase 2: one block of dim threads per (b, h) merges its splits'
// partials (dim == DP with FULL).
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(DP)
decode_attention_merge_kernel(const float* __restrict__ partial, T* __restrict__ out, int dim,
                              int splits) {
  if constexpr (FULL) dim = DP;
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* src = partial + (size_t)bh * splits * (dim + 2);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, src[s * (dim + 2) + dim]);
  float total = 0.f;
  float o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = src + s * (dim + 2);
    const float c = weight(p[dim], mx);  // an empty split weighs 0
    total += p[dim + 1] * c;
    o += p[d] * c;
  }
  store_f32(out + (size_t)bh * dim + d, o / fmaxf(total, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* pos;
  void* out;
  void* partial;
  int batch, heads, max_len, dim, splits;
  float scale;
  int whole;  // 1: rows of whole, 16-byte aligned vectors
  cudaStream_t stream;
};

template <typename T, int DP, bool FULL>
cudaError_t launch(const Args& a) {
  const int bh = a.batch * a.heads;
  float* scratch = a.splits > 1 ? static_cast<float*>(a.partial) : nullptr;
  // one split over a short cache unrolls only as far as the cache reaches:
  // a smaller body, and no slots past the cache to compute
  constexpr int G = Layout<T, DP>::kGroups;
  auto* kernel = decode_attention_split_kernel<T, DP, kUnroll, FULL>;
  if (a.splits == 1 && a.max_len <= G) {
    kernel = decode_attention_split_kernel<T, DP, 1, FULL>;
  } else if (a.splits == 1 && a.max_len <= 2 * G) {
    kernel = decode_attention_split_kernel<T, DP, 2, FULL>;
  }
  kernel<<<dim3(bh, a.splits), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.pos), static_cast<T*>(a.out), scratch, a.heads, a.max_len,
      a.dim, a.splits, a.scale, a.whole);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || scratch == nullptr) return err;
  decode_attention_merge_kernel<T, DP, FULL><<<bh, a.dim, 0, a.stream>>>(
      scratch, static_cast<T*>(a.out), a.dim, a.splits);
  return cudaGetLastError();
}

// rows that fill the padded width in whole aligned vectors take the
// compile-time path
template <typename T, int DP>
cudaError_t launch_padded(const Args& a) {
  return a.dim == DP && a.whole ? launch<T, DP, true>(a) : launch<T, DP, false>(a);
}

template <typename T>
cudaError_t dispatch_dim(const Args& a) {
  int dp = 0;
  for (int width : {16, 32, 64, 128, kMaxDim}) {
    if (a.dim <= width) {
      dp = width;
      break;
    }
  }
  switch (dp) {
    case 16: return launch_padded<T, 16>(a);
    case 32: return launch_padded<T, 32>(a);
    case 64: return launch_padded<T, 64>(a);
    case 128: return launch_padded<T, 128>(a);
    case kMaxDim: return launch_padded<T, kMaxDim>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; dim from 1 to 256. splits
// >= 1 (at most max_len and 65535); with splits > 1, partial is fp32
// scratch of batch * heads * splits * (dim + 2) elements. Returns a
// cudaError_t (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* partial, int batch,
                                       int heads, int max_len, int dim, int dtype,
                                       int splits, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || max_len <= 0 || dim <= 0 || dim > kMaxDim || splits < 1 ||
      splits > max_len || splits > 65535 || (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int itemsize = dtype == 0 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int whole = (bases % 16 == 0 && (dim * itemsize) % 16 == 0) ? 1 : 0;
  const Args a{q, k, v, pos, out, partial, batch, heads, max_len, dim, splits, scale, whole,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_dim<float>(a);
    case 1: return (int)dispatch_dim<__nv_bfloat16>(a);
    case 2: return (int)dispatch_dim<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
