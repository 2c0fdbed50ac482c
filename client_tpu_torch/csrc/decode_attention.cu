// Single-query decode attention over a static KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel client_tpu/ops/decode_attention.py
// (_decode_kernel, launched by decode_attention). What it computes:
//   q [B,H,D], k/v [B,H,M,D], pos [B] int32. Cache slots j <= pos[b] attend:
//   out[b,h] = softmax_j(q.k_j * D^-0.5) . v_j, in q's dtype; every dtype
//   of ops.PLAIN_DTYPES and any D >= 1, fp32 accumulation throughout.
//
// Bound on the H100: memory. One decode step reads each live cache row once
// (B*H*(pos+1)*D*2*itemsize bytes of K and V) and does 4 flops per element
// read, far below the card's ~295 flop/byte balance point, so the least time
// is those bytes over 3.35 TB/s. Two kernels:
//
// decode_attention_split_kernel, fp32 / bf16 / fp16 at any D. What the
// design does about the bound is keep enough bytes in flight on every SM:
//
// - split-K over the cache: phase 1 runs a grid of (b*h, split) blocks; the
//   wrapper picks the split count from the shapes alone
//   (ops/decode_attention.py:split_plan) so that small B*H still fills the
//   132 SMs. Split i covers slots [i*M/splits, (i+1)*M/splits), clipped on
//   the device to pos[b] (no host sync): slots above it are never read,
//   which is the TPU kernel's block skip, and a ragged M needs no padding;
// - 16-byte loads: the kernel is instantiated for a padded width DP (16,
//   32, 64, 128, 256, 512 or 1024; the smallest that holds D) and a row of
//   it is read by min(32, DP*itemsize/16) lanes, each taking
//   DP*itemsize/16/lanes 16-byte vectors (two a lane for fp32 at DP = 256,
//   eight at 1024; a half-warp per bf16 row at D = 128, so a warp reads two
//   rows per load), and up to DP = 256 each lane group issues the loads of
//   4 slots before it uses them: 4 KB of K and V in flight per warp at every
//   D and dtype (one split over a cache that fewer loads cover unrolls only
//   as far as it reaches). At DP = 512 and 1024 a row alone is 1-4 KB a
//   warp, so a lane group loads one slot at a time, and a lane holds D/32
//   fp32 accumulators (32 at 1024). Past 1024 the output's columns are
//   split across blocks, slabs of 1024 (grid.z): each block still takes
//   the scores over the whole D, 1024 columns at a time, so K is read once
//   per slab (D / 1024 times) and V once. Vectors at or past the real D
//   are zero and never read; where D * itemsize is not a multiple of 16
//   (bf16 D = 10) or a tensor is not 16-byte aligned, the vectors are read
//   element by element. A D that fills its padded width in aligned
//   rows (32, 64 and 128 in the decoders) runs an instantiation of its own
//   in which D is a constant and no load is checked;
// - every lane group keeps an online softmax (running max, sum and fp32
//   accumulator) in registers; the groups of a warp merge by shuffles and
//   the 8 warps through shared memory;
// - with one split the block writes the output itself (no scratch, one
//   launch: the decoder's served shape). With more, each block writes its
//   partial (m, l, acc[D]) in fp32 to the wrapper's scratch and phase 2, a
//   second small kernel (one block of D threads per (b, h), a thread a
//   column; past 1024, 1024 threads each looping over its columns), merges
//   the partials by log-sum-exp. A partial that saw no slot (its range
//   starts past pos[b]) holds m = -inf, l = 0, acc = 0 and carries zero
//   weight: no exp(-inf - -inf) is ever taken.
//
// decode_attention_tiled_kernel, integer and bool caches at any D. JAX's
// kernel rounds p to the cache's dtype per tile of min(block_k, M) slots
// before the PV product, and for an integer dtype that truncation makes
// the result depend on the tiles (tiled_attention.cuh): this kernel walks
// those tiles in order, so split-K does not apply. One block of 256
// threads per (b, h, slab of 1024 output columns): for each tile, each
// warp takes slots of the tile and scores them over the whole D (a warp a
// slot, lanes along D), the block reduces the tile's max, the threads take
// p = expf(s - m) of a slot each and round it, then each thread
// accumulates p . v for its columns of the slab (skipping p = 0: for an
// integer dtype every slot but the tile's maxima). The scores of a tile
// wait in shared memory, 1024 slots at a time; a longer tile has them
// recomputed for its second pass. Every element is read through the
// run-time element code (one instantiation for every dtype). Past 1024
// columns the slabs are blocks of their own, as in the split kernel. Its
// arithmetic is decode_attention_tiled_reference's, one rounding an
// operation (tiled_attention.cuh); CUDA-core FMAs, no tensor cores.
//
// The host entry points return the first launch error (cudaError_t); they
// take the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>
#include <type_traits>

#include "tiled_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // slots a lane group loads before it uses them (at most)
constexpr int kUnrolledDim = 256;  // the widest padded width that unrolls kUnroll slots
constexpr int kMaxDim = 1024;      // the widest padded width; past it, slabs of it

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
// SLABS (dim > DP = 1024): block (bh, split, slab) owns output columns
// [slab * DP, slab * DP + DP) and takes each score over the whole D, DP
// columns at a time (the same order in every slab, so every slab holds
// the same m and l).
template <typename T, int DP, int U, bool FULL, bool SLABS = false>
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
  const int col0 = SLABS ? blockIdx.z * DP : 0;  // this block's first output column

  // this split's slots, clipped to those <= pos (the cache holds max_len);
  // one split skips the 64-bit divisions, on the short caches' critical path
  const int begin = splits == 1 ? 0 : (int)((long long)split * max_len / splits);
  const int stop = splits == 1 ? max_len : (int)((long long)(split + 1) * max_len / splits);
  const int end = min(stop, min(pos[bh / heads], max_len - 1) + 1);

  // vector n of this lane starts at column (sub + LANES * n) * VE (of the
  // block's slab); with SLABS q is read at each score, chunk by chunk
  float qf[SLABS ? 1 : NV][VE];
  if constexpr (!SLABS) {
#pragma unroll
    for (int n = 0; n < NV; ++n)
      unpack_as<T>(load_vec<FULL>(q + (size_t)bh * dim, (sub + LANES * n) * VE, dim, whole),
                   qf[n]);
  }
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
    uint4 vr[U][NV];
    float s[U];
    float mx = m;
    if constexpr (SLABS) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = b + slot + u * L::kGroups;
        const bool live = j < end;
        float d0 = 0.f, d1 = 0.f;
        for (int c0 = 0; c0 < dim; c0 += DP) {
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const int c = c0 + (sub + LANES * n) * VE;
            float qv[VE], kf[VE];
            unpack_as<T>(load_vec<false>(q + (size_t)bh * dim, c, dim, whole), qv);
            unpack_as<T>(live ? load_vec<false>(kb + (size_t)j * dim, c, dim, whole)
                              : make_uint4(0u, 0u, 0u, 0u), kf);
#pragma unroll
            for (int e = 0; e < VE; e += 2) {
              d0 = fmaf(qv[e], kf[e], d0);
              d1 = fmaf(qv[e + 1], kf[e + 1], d1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          vr[u][n] = live ? load_vec<false>(vb + (size_t)j * dim, col0 + (sub + LANES * n) * VE,
                                            dim, whole)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
        float dot = d0 + d1;
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = live ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
    } else {
      uint4 kr[U][NV];
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
  // this block's columns: d of the slab is column col0 + d
  const int cols = SLABS ? min(DP, dim - col0) : dim;
  for (int d = threadIdx.x; d < cols; d += kThreads) {
    float total = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = weight(sm_m[w], mx);
      total += sm_l[w] * c;
      o += sm_acc[w][d] * c;
    }
    if (partial == nullptr) {
      store_f32(out + (size_t)bh * dim + col0 + d, o / fmaxf(total, 1e-30f));
    } else {
      // partial (acc[D], m, l) of (bh, split); an empty split writes
      // acc = 0, m = -inf, l = 0
      float* dst = partial + ((size_t)bh * splits + split) * (dim + 2);
      dst[col0 + d] = o;
      if (col0 + d == 0) {
        dst[dim] = mx;
        dst[dim + 1] = total;
      }
    }
  }
}

// Phase 2: one block of dim threads per (b, h) merges its splits'
// partials (dim == DP with FULL). LOOP (dim > DP = 1024, the slabs): one
// block of DP threads, each thread looping over its columns.
template <typename T, int DP, bool FULL, bool LOOP = false>
__global__ void __launch_bounds__(DP)
decode_attention_merge_kernel(const float* __restrict__ partial, T* __restrict__ out, int dim,
                              int splits) {
  if constexpr (FULL) dim = DP;
  const int bh = blockIdx.x;
  const float* src = partial + (size_t)bh * splits * (dim + 2);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, src[s * (dim + 2) + dim]);
  if constexpr (LOOP) {
    float total = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* p = src + (size_t)s * (dim + 2);
      total += p[dim + 1] * weight(p[dim], mx);
    }
    for (int d = threadIdx.x; d < dim; d += DP) {
      float o = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float* p = src + (size_t)s * (dim + 2);
        o += p[d] * weight(p[dim], mx);  // an empty split weighs 0
      }
      store_f32(out + (size_t)bh * dim + d, o / fmaxf(total, 1e-30f));
    }
  } else {
    const int d = threadIdx.x;
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
  // past kUnrolledDim a row alone keeps 1-4 KB a warp in flight: one slot
  auto* kernel = decode_attention_split_kernel<T, DP, DP <= kUnrolledDim ? kUnroll : 1, FULL>;
  if constexpr (DP <= kUnrolledDim) {
    if (a.splits == 1 && a.max_len <= G) {
      kernel = decode_attention_split_kernel<T, DP, 1, FULL>;
    } else if (a.splits == 1 && a.max_len <= 2 * G) {
      kernel = decode_attention_split_kernel<T, DP, 2, FULL>;
    }
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

// dim > kMaxDim: blocks (bh, split, slab of kMaxDim columns), then the
// looping merge
template <typename T>
cudaError_t launch_slabs(const Args& a) {
  const int bh = a.batch * a.heads;
  const int slabs = (a.dim + kMaxDim - 1) / kMaxDim;
  if (slabs > 65535) return cudaErrorInvalidValue;
  float* scratch = a.splits > 1 ? static_cast<float*>(a.partial) : nullptr;
  decode_attention_split_kernel<T, kMaxDim, 1, false, true>
      <<<dim3(bh, a.splits, slabs), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<const int*>(a.pos), static_cast<T*>(a.out), scratch, a.heads, a.max_len,
          a.dim, a.splits, a.scale, a.whole);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || scratch == nullptr) return err;
  decode_attention_merge_kernel<T, kMaxDim, false, true><<<bh, kMaxDim, 0, a.stream>>>(
      scratch, static_cast<T*>(a.out), a.dim, a.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const Args& a) {
  if (a.dim > kMaxDim) return launch_slabs<T>(a);
  int dp = 0;
  for (int width : {16, 32, 64, 128, 256, 512, kMaxDim}) {
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
    case 256: return launch_padded<T, 256>(a);
    case 512: return launch_padded<T, 512>(a);
    case kMaxDim: return launch_padded<T, kMaxDim>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the tiled kernel: JAX's tiles in order, every dtype by its element code
// ---------------------------------------------------------------------------

constexpr int kTiledWarps = 8;
constexpr int kTiledThreads = kTiledWarps * 32;
constexpr int kChunk = 1024;  // slots of a tile whose scores wait in shared memory
constexpr int kSlab = 1024;   // output columns of a block
constexpr int kCols = kSlab / kTiledThreads;  // output columns of a thread

// the block's max or sum of x, in a fixed order: the same bits in every
// thread. The first barrier also orders the block's shared-memory reads
// before it against its writes after.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kTiledWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = tiled::warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kTiledWarps; ++w) r += red[w];
  return r;
}

// block (bh, slab): tiles [t0, t0 + tile) of the slots <= pos[b], in order
__global__ void __launch_bounds__(kTiledThreads)
decode_attention_tiled_kernel(const void* __restrict__ q, const void* __restrict__ k,
                              const void* __restrict__ v, const int* __restrict__ pos,
                              void* __restrict__ out, int heads, int max_len, int dim,
                              int tile, int code, float scale) {
  __shared__ float sc[kChunk];  // a chunk's scores, then its rounded p
  __shared__ float red[kTiledWarps];
  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * kSlab;
  const int warp = threadIdx.x >> 5;
  const long long q_off = (long long)bh * dim;
  const long long kv_off = (long long)bh * max_len * dim;
  // slots [0, end) attend; none for a negative pos (the output is 0)
  const int end = min(pos[bh / heads], max_len - 1) + 1;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < end; t0 += tile) {
    const int t1 = min(end, t0 + tile);  // this tile's live slots: [t0, t1)
    const bool held = t1 - t0 <= kChunk;  // its scores all wait in sc
    float mx = -INFINITY;
    for (int c0 = t0; c0 < t1; c0 += kChunk) {
      const int n = min(kChunk, t1 - c0);
      for (int j = warp; j < n; j += kTiledWarps) {
        const float s = tiled::warp_score(q, q_off, k, kv_off + (long long)(c0 + j) * dim, dim,
                                          code, scale);
        if (held && (threadIdx.x & 31) == 0) sc[j] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = block_max(mx, red);
    const float m_new = fmaxf(m, mx);
    // no live slot yet: p = 0 and the correction is 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(__fsub_rn(m, m_use));
    float psum = 0.f;
    float pv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) pv[i] = 0.f;
    for (int c0 = t0; c0 < t1; c0 += kChunk) {
      const int n = min(kChunk, t1 - c0);
      if (!held) {
        __syncthreads();  // the last chunk's p are read
        for (int j = warp; j < n; j += kTiledWarps) {
          const float s = tiled::warp_score(q, q_off, k, kv_off + (long long)(c0 + j) * dim, dim,
                                            code, scale);
          if ((threadIdx.x & 31) == 0) sc[j] = s;
        }
      }
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kTiledThreads) {
        const float p = expf(__fsub_rn(sc[j], m_use));
        psum += p;
        sc[j] = tiled::round_p(p, code);
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float r = sc[j];
        if (r == 0.f) continue;  // the same in every thread
        const long long row = kv_off + (long long)(c0 + j) * dim;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int d = col0 + threadIdx.x + i * kTiledThreads;
          if (d < dim) pv[i] = fmaf(r, tiled::load_f32(v, row + d, code), pv[i]);
        }
      }
    }
    l = __fadd_rn(__fmul_rn(l, corr), block_sum(psum, red));
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], corr), pv[i]);
    m = m_new;
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int d = col0 + threadIdx.x + i * kTiledThreads;
    if (d < dim) tiled::store_f32(out, q_off + d, acc[i] / den, code);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; any dim >= 1. splits >= 1
// (at most max_len and 65535); with splits > 1, partial is fp32 scratch of
// batch * heads * splits * (dim + 2) elements. Returns a cudaError_t (0 =
// launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* partial, int batch,
                                       int heads, int max_len, int dim, int dtype,
                                       int splits, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || max_len <= 0 || dim <= 0 || splits < 1 ||
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

// The tiled kernel, for integer and bool caches: code is the element code
// of q, k, v and out (ELEMENT_CODES: 3-7; 0-2 compute the same tiles in
// fp32, bf16 and fp16), any dim >= 1, tile = min(block_k, max_len) >= 1
// slots. Returns a cudaError_t (0 = launched).
extern "C" int decode_attention_tiled_launch(const void* q, const void* k, const void* v,
                                             const void* pos, void* out, int batch, int heads,
                                             int max_len, int dim, int code, int tile,
                                             float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  const long long slabs = ((long long)dim + kSlab - 1) / kSlab;
  if (batch <= 0 || heads <= 0 || max_len <= 0 || dim <= 0 || tile <= 0 || code < 0 ||
      code > 7 || bh > 0x7fffffffLL || slabs > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  decode_attention_tiled_kernel<<<dim3((unsigned)bh, (unsigned)slabs), kTiledThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      q, k, v, static_cast<const int*>(pos), out, heads, max_len, dim, tile, code, scale);
  return (int)cudaGetLastError();
}
