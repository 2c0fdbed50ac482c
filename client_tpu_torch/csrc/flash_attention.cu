// Blocked online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel client_tpu/ops/flash_attention.py
// (_flash_kernel, launched by flash_attention). What it computes:
//   q, k, v [B,S,H,D] in one dtype (fp32 or bf16), scale D^-0.5,
//   out[b,i,h] = softmax_j(q_i.k_j * scale) . v_j in q's dtype, with keys
//   j > i masked when causal. Scores and the output accumulate in fp32. As
//   the Pallas kernel does, QK^T takes the operands in their own dtype (a
//   bf16 x bf16 product is exact in fp32) and the probabilities are rounded
//   to v's dtype before the PV product; fp32 runs in full fp32 FMA, no TF32.
//
// Bound on the H100: operations. The work is 4*B*H*S^2*D flops (about half
// with causal masking) over 4*B*S*H*D elements moved, so at the served and
// benchmark shapes the flops over the card's peak are the least time. This
// first kernel does them on the CUDA cores in fp32 (the tensor cores, by
// mma.sync or wgmma, and TMA-fed tiles are later work), so it stays well
// above that bound; what the design does is keep the S x S scores out of
// device memory and read each K/V tile once per query tile.
//
// Design:
// - one block of 256 threads per (b*h, 64-row query tile), walking 64-key
//   tiles in order with the running (max, sum, acc) state in registers, as
//   the Pallas grid walks its "arbitrary" key axis; a causal block stops at
//   the diagonal tile, which is the Pallas block skip;
// - the [B,S,H,D] layout is indexed with strides in the kernel, so no
//   transpose copy surrounds it; tiles are read with 16-byte loads into
//   shared memory (rows padded to an odd word count: conflict-free reads);
// - keys >= S are masked in the kernel and their K/V rows zero-filled, so a
//   ragged S is never padded in memory; query rows >= S are not stored;
// - thread (ty, tx) of the 16 x 16 grid owns query rows 4*ty..4*ty+3: their
//   scores at keys tx + 16*j and their outputs at columns tx + 16*e; a row's
//   max and sum are reduced across its 16 threads with warp shuffles;
// - a row with no live key yet keeps p = 0 and a correction of 0 (never
//   exp(-inf - -inf)); the final divide is by max(l, 1e-30), as in Pallas.
// The host entry point returns the launch's cudaError_t; it takes the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per tile
constexpr int kThreads = 256; // a 16 x 16 grid
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kKeys = kBlockK / 16;  // keys per thread in a score tile
constexpr int kLdP = kBlockK + 1;    // padded row of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// p rounded to the value dtype, as the Pallas kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// rows [row0, row0 + rows) of one (b, h) slice into a shared tile with row
// stride LD; rows >= seq are zero-filled
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ src, int row0,
                                          int rows, int seq, long long stride_s) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) {
      raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_s + c);
    }
    T vals[kVec];
    memcpy(vals, &raw, sizeof(raw));
#pragma unroll
    for (int e = 0; e < kVec; ++e) tile[r * LD + c + e] = vals[e];
  }
}

template <typename T, int D>
struct Smem {
  static constexpr int kLd = D + 4 / (int)sizeof(T);  // odd word count per row
  static constexpr size_t kQ = (size_t)kBlockQ * kLd * sizeof(T);
  static constexpr size_t kK = (size_t)kBlockK * kLd * sizeof(T);
  static constexpr size_t kV = (size_t)kBlockK * D * sizeof(T);
  static constexpr size_t kP = (size_t)kBlockQ * kLdP * sizeof(float);
  static constexpr size_t kBytes = kQ + kK + kV + kP;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int seq, int heads,
                       int q_tiles, long long stride_b, long long stride_s,
                       long long stride_h, float scale, int causal) {
  using S = Smem<T, D>;
  constexpr int LD = S::kLd;
  constexpr int E = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + S::kQ);
  T* sv = reinterpret_cast<T*>(smem + S::kQ + S::kK);
  float* sp = reinterpret_cast<float*>(smem + S::kQ + S::kK + S::kV);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<T, D, LD>(sq, q + base, q0, kBlockQ, seq, stride_s);

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  // causal: key tiles past the diagonal contribute nothing
  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D, LD>(sk, k + base, k0, kBlockK, seq, stride_s);
    load_tile<T, D, D>(sv, v + base, k0, kBlockK, seq, stride_s);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = to_f32(sq[(ty * kRows + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = to_f32(sk[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < seq && (!causal || col <= row);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no live key for this row yet: p = 0 and the correction is 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_use);
        sum += p;
        sp[(ty * kRows + i) * kLdP + tx + 16 * j] = round_as(p, T());
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = to_f32(sv[j * D + tx + 16 * e]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = sp[(ty * kRows + i) * kLdP + j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row < seq) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* dst = out + base + (long long)row * stride_s;
#pragma unroll
      for (int e = 0; e < E; ++e) store(dst + tx + 16 * e, acc[i][e] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int seq,
                   int heads, long long stride_b, long long stride_s, long long stride_h,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::kBytes;
  const auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const long long blocks = (long long)q_tiles * batch * heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), seq, heads, q_tiles, stride_b, stride_s, stride_h, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* out, int batch,
                         int seq, int heads, int dim, long long sb, long long ss, long long sh,
                         float scale, int causal, cudaStream_t stream) {
  switch (dim) {
    case 16: return launch<T, 16>(q, k, v, out, batch, seq, heads, sb, ss, sh, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, batch, seq, heads, sb, ss, sh, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, batch, seq, heads, sb, ss, sh, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, batch, seq, heads, sb, ss, sh, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v and out share the [B,S,H,D] shape and the element strides
// (stride_b, stride_s, stride_h; the last dimension is contiguous).
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int seq, int heads, int dim,
                                      long long stride_b, long long stride_s,
                                      long long stride_h, int dtype, float scale, int causal,
                                      void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<float>(q, k, v, out, batch, seq, heads, dim, stride_b, stride_s,
                                      stride_h, scale, causal, s);
    case 1:
      return (int)dispatch_dim<__nv_bfloat16>(q, k, v, out, batch, seq, heads, dim, stride_b,
                                              stride_s, stride_h, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
