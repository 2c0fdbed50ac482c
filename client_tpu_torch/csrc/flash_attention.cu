// Blocked online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel client_tpu/ops/flash_attention.py
// (_flash_kernel, launched by flash_attention). What it computes:
//   q, k, v [B,S,H,D] in one dtype (any of ops.PLAIN_DTYPES), any D >= 1,
//   scale D^-0.5, out[b,i,h] = softmax_j(q_i.k_j * scale) . v_j in q's
//   dtype, with keys j > i masked when causal. Scores and the output
//   accumulate in fp32. As the Pallas kernel does, QK^T takes the operands
//   in their own dtype (a bf16 x bf16 or fp16 x fp16 product is exact in
//   fp32) and the probabilities are rounded to v's dtype before the PV
//   product; fp32 runs in full fp32 FMA, no TF32.
//
// Bound on the H100: operations. The work is 4*B*H*S^2*D flops (about half
// with causal masking) over 4*B*S*H*D elements moved, so at the served and
// benchmark shapes the flops over the card's peak are the least time: the
// tensor-core peak for bf16 and fp16, the fp32 CUDA-core peak for fp32.
//
// Every kernel here gives a block a (b*h, query tile) and walks the key
// tiles in order with the running (max, sum, acc) state in registers, as
// the Pallas grid walks its "arbitrary" key axis; a causal block stops at
// the diagonal tile and only the diagonal tile (and a ragged last one) is
// masked. The [B,S,H,D] layout is indexed with strides (no transposes);
// keys >= S are masked and their K/V rows zero-filled, so a ragged S is never
// padded in memory; query rows >= S are not stored. A row with no live key
// yet keeps p = 0 and a correction of 0 (never exp(-inf - -inf)); the final
// divide is by max(l, 1e-30), as in Pallas. The two newer kernels take the
// softmax in log2 units (exp2, with scale * log2(e) folded into the score
// scaling, or into Q for fp32).
//
// Head dims up to 256: each kernel is instantiated for a padded width DP (16,
// 32, 64, 96, 128 or 256; the smallest that holds D) and takes the real D at run
// time. Loads zero-fill the columns at or beyond D, so they add nothing to a
// score and give output columns that are never stored; stores write the
// columns below D only; the scale is the real D's. A D that fills its padded
// width in 16-byte aligned rows (16, 32, 64 and 128 in the served models,
// 96 and 256 in the wide encoder) runs an instantiation of its own in which
// D, the copy width and the paired stores are constants. A row of D elements is
// copied in the widest of 16, 8, 4 or 2 bytes that divides D * itemsize and
// the tensors' alignment (bf16 D = 10 takes 4-byte copies; cp.async takes 4,
// 8 or 16 bytes, so an odd D in 2-byte types is copied element by element).
// Past 256 the float kernels have wide forms (below). Six kernels:
//
// - bf16 and fp16, any D (flash_attention_mma_kernel): a FlashAttention-2
//   layout on the tensor cores. 4 warps own 16 rows each of a 64-row query
//   tile. Each warp loads its Q fragments with ldmatrix and, up to DP = 128,
//   keeps them in registers (at DP = 256 they are read from shared memory at
//   each k-step, which leaves the registers to the 128 fp32 O accumulators a
//   thread holds there); QK^T is mma.sync m16n8k16 (bf16 or fp16) -> fp32;
//   the online softmax runs on the accumulator fragments (row max by quad
//   shuffles, each thread summing its own columns until the end); P is
//   rounded to the input type in registers and used directly as the A
//   operand of the PV mma (no P tile in shared memory). K/V tiles of 64 keys
//   are double-buffered with cp.async (rows >= S zero-filled), so the next
//   tile's copy overlaps this one's math. Shared rows are padded by 16
//   bytes: ldmatrix reads are conflict-free. A row whose max did not move
//   skips the accumulator's rescale (its correction is exactly 1). At DP =
//   256 the five tiles take 165 KB of shared memory: one block an SM.
// - fp32, D <= 32 (flash_attention_f32_small_kernel): CUDA-core FMAs. Thread
//   (ty, tx) of a 16 x 16 grid owns 64/DP query rows, held in registers for
//   the whole loop, and the keys tx + 16j of each 128-key tile (the
//   per-tile softmax bookkeeping spread over 8 keys a thread). Its PV
//   accumulator sums over ITS OWN keys across the whole loop (the rescale
//   by corr is uniform along a row, so this is exact); the 16 lanes of a row
//   are reduced once, at the end. So P never goes through shared memory.
//   K/V tiles are double-buffered with cp.async as above.
// - fp32, D > 32 (flash_attention_f32_kernel): the first design, kept. Thread
//   (ty, tx) owns 4 query rows; scores at keys tx + 16j go through a shared
//   P tile into the PV product at columns tx + 16e. At DP = 256 its tiles
//   take 209 KB of shared memory.
// - D > 256 (flash_attention_mma_wide_kernel for bf16 and fp16,
//   flash_attention_f32_wide_kernel for fp32): a block owns a (query tile x
//   256 columns) slab of O, so its accumulators are those of DP = 256 at
//   any D (grid.z = the slabs). For each key tile it builds S = QK^T over
//   the whole D from 64-column chunks of Q and K staged through shared
//   memory (cp.async, double-buffered, in the mma kernel; plain loads in
//   the fp32 one, as its DP kernel), then multiplies P by its slab of V.
//   So each slab recomputes the QK^T product and rereads Q and K: D / 256
//   times the QK^T work of one pass (2x at D = 512, 4x at 1024), the cost
//   of this simple design. The last slab and chunk are zero-padded past D.
//   Shared memory: 69 KB (mma), 113 KB (fp32).
// - integer and bool inputs at any D (flash_attention_tiled_kernel): JAX's
//   kernel rounds p to the input dtype per key tile of min(block_k, S)
//   keys, which truncates it to 0 or 1, so the result depends on the tiles
//   (tiled_attention.cuh): the wrapper hands block_k in, and this kernel
//   walks those tiles in order. One block per (b*h, 8 query rows, slab of
//   256 output columns), a warp a row: for each tile the warp scores its
//   keys over the whole D (lanes along D), takes the tile's max, p =
//   expf(s - m) of a key a lane, rounded, then p . v for its columns,
//   skipping p = 0. Its arithmetic is flash_attention_tiled_reference's,
//   one rounding an operation (s * scale and s - m by __fmul_rn and
//   __fsub_rn: no FMA contraction); every element is read through the
//   run-time element code, one instantiation for every dtype; CUDA-core
//   FMAs, no tensor cores. A causal row stops at its own key.
// The host entry points return the launch's cudaError_t; they take the
// caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

#include "tiled_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using half = __half;

constexpr int kBlockK = 64;  // keys per tile (every kernel)
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// cp.async, ldmatrix and mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// VB (4, 8 or 16) bytes from global to shared; with live = false the bytes
// are zeroed (src-size 0: nothing is read)
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool live) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(live ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(VB), "r"(live ? VB : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The tensor-core types: c[16x8] += a[16x16] . b[16x8] with fp32
// accumulators, two floats rounded to the type (p.astype(v.dtype)) with lo
// in the low half, and one pair or one element stored
template <typename T> struct Mma;

template <> struct Mma<bf16> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &h, sizeof(r));
    return r;
  }
  static __device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
};

template <> struct Mma<half> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &h, sizeof(r));
    return r;
  }
  static __device__ __forceinline__ void store2(half* p, float lo, float hi) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ void store1(half* p, float x) { *p = __float2half_rn(x); }
};

// rows [row0, row0 + ROWS) of one (b, h) slice into a shared tile with row
// stride LD, DP columns of which the first `dim` are read, by VB-byte
// copies; rows >= seq and columns >= dim are zero-filled. VB = 2 (2-byte
// types whose rows are not 4-byte aligned) is a plain element copy.
template <typename T, int DP, int LD, int ROWS, int THREADS, int VB>
__device__ __forceinline__ void load_tile_vec(T* tile, const T* __restrict__ src, int row0,
                                              int seq, long long stride_s, int dim) {
  constexpr int kVec = VB / (int)sizeof(T);
  constexpr int kPerRow = DP / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool live = row0 + r < seq && (dim == DP || c < dim);  // c < DP always
    const T* g = live ? src + (long long)(row0 + r) * stride_s + c : src;
    if constexpr (VB >= 4) {
      cp_async<VB>(tile + r * LD + c, g, live);
    } else {
      static_assert(sizeof(T) == 2, "element copies are for 2-byte types");
      const unsigned short bits = live ? *reinterpret_cast<const unsigned short*>(g) : 0;
      *reinterpret_cast<unsigned short*>(tile + r * LD + c) = bits;
    }
  }
}

// load_tile_vec with the copy width chosen at run time (uniform over the
// block): vec is 16, 8, 4 or (2-byte types) 2 bytes
template <typename T, int DP, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* tile, const T* __restrict__ src, int row0,
                                                int seq, long long stride_s, int dim, int vec) {
  if (vec == 16) {
    load_tile_vec<T, DP, LD, ROWS, THREADS, 16>(tile, src, row0, seq, stride_s, dim);
  } else if (vec == 8) {
    load_tile_vec<T, DP, LD, ROWS, THREADS, 8>(tile, src, row0, seq, stride_s, dim);
  } else if (vec == 4 || sizeof(T) == 4) {
    load_tile_vec<T, DP, LD, ROWS, THREADS, 4>(tile, src, row0, seq, stride_s, dim);
  } else {
    if constexpr (sizeof(T) == 2) {
      load_tile_vec<T, DP, LD, ROWS, THREADS, 2>(tile, src, row0, seq, stride_s, dim);
    }
  }
}

// whether key tile [k0, k0 + BK) has a masked entry for a query block
// starting at q0: keys past the sequence, or (causal) keys past the block's
// first row
template <int BK>
__device__ __forceinline__ bool tile_needs_mask(int k0, int q0, int seq, int causal) {
  return k0 + BK > seq || (causal && k0 + BK - 1 > q0);
}

// ---------------------------------------------------------------------------
// bf16 and fp16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlockQ = kMmaWarps * 16;  // each warp owns 16 query rows

template <int DP>
struct MmaSmem {
  static constexpr int kLd = DP + 8;  // 16 bytes of padding: conflict-free ldmatrix
  static constexpr int kTile = 64 * kLd;
  static constexpr size_t kBytes = 5 * kTile * 2;  // Q, K x 2, V x 2 of 2-byte values
};

template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int seq, int heads,
                           int dim, long long stride_b, long long stride_s, long long stride_h,
                           float scale, int causal, int vec, int pairs) {
  if constexpr (FULL) {
    dim = DP;
    vec = 16;
    pairs = 1;
  }
  static_assert(kMmaBlockQ == kBlockK, "the diagonal tile is the block's own");
  using M = Mma<T>;
  constexpr int LD = MmaSmem<DP>::kLd;
  constexpr int TILE = MmaSmem<DP>::kTile;
  constexpr int KSTEPS = DP / 16;    // k-steps of QK^T
  constexpr int NT = kBlockK / 8;    // 8-key n-tiles of S
  constexpr int DT = DP / 8;         // 8-column n-tiles of O
  // Q fragments in registers for the whole loop up to DP = 128; at 256 the
  // O accumulators need those registers, and Q is read at each k-step
  constexpr bool kQRegs = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + TILE;      // two buffers
  T* sv = sk + 2 * TILE;  // two buffers

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBlockQ;  // longest causal blocks first
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  // scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  const float scale_log2 = scale * kLog2e;
  // this warp's Q fragment rows in the shared tile
  const int q_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int q_col = (lane >> 4) * 8;

  const int k_end = causal ? min(seq, q0 + kMmaBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  load_tile_async<T, DP, LD, kMmaBlockQ, kMmaThreads>(sq, q + base, q0, seq, stride_s, dim, vec);
  load_tile_async<T, DP, LD, kBlockK, kMmaThreads>(sk, k + base, 0, seq, stride_s, dim, vec);
  load_tile_async<T, DP, LD, kBlockK, kMmaThreads>(sv, v + base, 0, seq, stride_s, dim, vec);
  cp_async_commit();

  uint32_t qa[kQRegs ? KSTEPS : 1][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's columns only, until the end

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      // the buffer it fills was last read in iteration it - 1, which ended
      // with a barrier
      load_tile_async<T, DP, LD, kBlockK, kMmaThreads>(sk + (buf ^ 1) * TILE, k + base,
                                                       k0 + kBlockK, seq, stride_s, dim, vec);
      load_tile_async<T, DP, LD, kBlockK, kMmaThreads>(sv + (buf ^ 1) * TILE, v + base,
                                                       k0 + kBlockK, seq, stride_s, dim, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qa[kk], sq + q_row * LD + kk * 16 + q_col);
      }
    }
    const T* kt = sk + buf * TILE;
    const T* vt = sv + buf * TILE;

    // S = Q K^T: 16 rows x 64 keys per warp, fp32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t(&a)[4] = qa[kQRegs ? kk : 0];
      if constexpr (!kQRegs) ldmatrix_x4(a, sq + q_row * LD + kk * 16 + q_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b, kt + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        M::mma(s[2 * np], a, b[0], b[1]);
        M::mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    if (tile_needs_mask<kBlockK>(k0, q0, seq, causal)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + j * 8 + 2 * t + (c & 1);
          const int row = c < 2 ? row0 : row1;
          const bool live = key < seq && (!causal || key <= row);
          s[j][c] = live ? s[j][c] * scale_log2 : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] *= scale_log2;
    }

    // online softmax on the fragments: c = 0, 1 are row g; c = 2, 3 row g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // no live key for this row yet: p = 0 and the correction is 0
      const float m_use = mx == -INFINITY ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_use);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_use);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      if (mx != m[r]) {  // else the correction is exactly 1
        const float corr = exp2f(m[r] - m_use);
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][2 * r] *= corr;
          o[j][2 * r + 1] *= corr;
        }
      }
      l[r] += sum;
      m[r] = mx;
    }

    // O += P V, P rounded to the input type in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {M::pack(s[2 * kk][0], s[2 * kk][1]),
                              M::pack(s[2 * kk][2], s[2 * kk][3]),
                              M::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              M::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, vt + key * LD + dp * 16 + (lane >> 4) * 8);
        M::mma(o[2 * dp], pa, b[0], b[1]);
        M::mma(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this tile's buffers are refilled in the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f);
  const float den1 = fmaxf(l[1], 1e-30f);
  // columns below dim only: in pairs where the rows are 4-byte aligned
  // (`pairs`: an even dim and strides), else one by one
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= dim) continue;
    T* dst0 = out + base + (long long)row0 * stride_s + col;
    T* dst1 = out + base + (long long)row1 * stride_s + col;
    if (pairs) {
      if (row0 < seq) M::store2(dst0, o[j][0] / den0, o[j][1] / den0);
      if (row1 < seq) M::store2(dst1, o[j][2] / den1, o[j][3] / den1);
    } else {
      const bool second = col + 1 < dim;
      if (row0 < seq) {
        M::store1(dst0, o[j][0] / den0);
        if (second) M::store1(dst0 + 1, o[j][1] / den0);
      }
      if (row1 < seq) {
        M::store1(dst1, o[j][2] / den1);
        if (second) M::store1(dst1 + 1, o[j][3] / den1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16 past D = 256: a slab of 256 output columns a block
// ---------------------------------------------------------------------------

constexpr int kSlab = 256;   // output columns of a wide block
constexpr int kChunkD = 64;  // columns of a Q or K chunk of the QK^T product

struct MmaWideSmem {
  static constexpr int kLdC = kChunkD + 8;  // 16 bytes of padding: conflict-free ldmatrix
  static constexpr int kLdV = kSlab + 8;
  static constexpr int kChunk = 64 * kLdC;  // one Q or one K chunk
  static constexpr int kV = 64 * kLdV;
  static constexpr size_t kBytes = (4 * kChunk + kV) * 2;  // (Q, K) x 2 buffers, V
};

template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out, int seq, int heads,
                                int dim, long long stride_b, long long stride_s,
                                long long stride_h, float scale, int causal, int vec, int pairs) {
  using M = Mma<T>;
  using W = MmaWideSmem;
  constexpr int LDC = W::kLdC;
  constexpr int LDV = W::kLdV;
  constexpr int KSTEPS = kChunkD / 16;  // k-steps of a chunk
  constexpr int NT = kBlockK / 8;       // 8-key n-tiles of S
  constexpr int DT = kSlab / 8;         // 8-column n-tiles of the O slab
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);  // two buffers
  T* sk = sq + 2 * W::kChunk;          // two buffers
  T* sv = sk + 2 * W::kChunk;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBlockQ;  // longest causal blocks first
  const int col0 = blockIdx.z * kSlab;                       // this block's columns of O
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;
  const int q_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int q_col = (lane >> 4) * 8;

  const int k_end = causal ? min(seq, q0 + kMmaBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int n_chunks = (dim + kChunkD - 1) / kChunkD;

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's columns only, until the end

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    // the tile's V slab first (its group completes before the chunks'),
    // then the first chunk of Q and K; every buffer was last read before
    // the previous tile's closing barrier
    load_tile_async<T, kSlab, LDV, kBlockK, kMmaThreads>(sv, v + base + col0, k0, seq, stride_s,
                                                        dim - col0, vec);
    cp_async_commit();
    load_tile_async<T, kChunkD, LDC, kMmaBlockQ, kMmaThreads>(sq, q + base, q0, seq, stride_s,
                                                             dim, vec);
    load_tile_async<T, kChunkD, LDC, kBlockK, kMmaThreads>(sk, k + base, k0, seq, stride_s, dim,
                                                          vec);
    cp_async_commit();

    // S = Q K^T over the whole D, chunk by chunk: 16 rows x 64 keys a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int buf = ch & 1;
      if (ch + 1 < n_chunks) {
        // the buffer it fills was last read in chunk ch - 1, which ended
        // with a barrier
        const int c1 = (ch + 1) * kChunkD;
        load_tile_async<T, kChunkD, LDC, kMmaBlockQ, kMmaThreads>(
            sq + (buf ^ 1) * W::kChunk, q + base + c1, q0, seq, stride_s, dim - c1, vec);
        load_tile_async<T, kChunkD, LDC, kBlockK, kMmaThreads>(
            sk + (buf ^ 1) * W::kChunk, k + base + c1, k0, seq, stride_s, dim - c1, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* qt = sq + buf * W::kChunk;
      const T* kt = sk + buf * W::kChunk;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qt + q_row * LDC + kk * 16 + q_col);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(b, kt + key * LDC + kk * 16 + ((lane >> 3) & 1) * 8);
          M::mma(s[2 * np], a, b[0], b[1]);
          M::mma(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // this chunk's buffers are refilled two chunks on
    }

    if (tile_needs_mask<kBlockK>(k0, q0, seq, causal)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + j * 8 + 2 * t + (c & 1);
          const int row = c < 2 ? row0 : row1;
          const bool live = key < seq && (!causal || key <= row);
          s[j][c] = live ? s[j][c] * scale_log2 : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] *= scale_log2;
    }

    // online softmax on the fragments, as flash_attention_mma_kernel
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_use = mx == -INFINITY ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_use);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_use);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      if (mx != m[r]) {
        const float corr = exp2f(m[r] - m_use);
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][2 * r] *= corr;
          o[j][2 * r + 1] *= corr;
        }
      }
      l[r] += sum;
      m[r] = mx;
    }

    // O slab += P V slab, P rounded to the input type in registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {M::pack(s[2 * kk][0], s[2 * kk][1]),
                              M::pack(s[2 * kk][2], s[2 * kk][3]),
                              M::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              M::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, sv + key * LDV + dp * 16 + (lane >> 4) * 8);
        M::mma(o[2 * dp], pa, b[0], b[1]);
        M::mma(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this tile's V slab and chunks are refilled in the next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f);
  const float den1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col >= dim) continue;
    T* dst0 = out + base + (long long)row0 * stride_s + col;
    T* dst1 = out + base + (long long)row1 * stride_s + col;
    if (pairs) {
      if (row0 < seq) M::store2(dst0, o[j][0] / den0, o[j][1] / den0);
      if (row1 < seq) M::store2(dst1, o[j][2] / den1, o[j][3] / den1);
    } else {
      const bool second = col + 1 < dim;
      if (row0 < seq) {
        M::store1(dst0, o[j][0] / den0);
        if (second) M::store1(dst0 + 1, o[j][1] / den0);
      }
      if (row1 < seq) {
        M::store1(dst1, o[j][2] / den1);
        if (second) M::store1(dst1 + 1, o[j][3] / den1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, D <= 32: Q and the PV partial sums in registers
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid (both fp32 kernels)

template <int DP>
struct SmallF32 {
  static constexpr int kRows = 64 / DP;         // query rows per thread
  static constexpr int kBlockQ = 16 * kRows;    // query rows per block
  static constexpr int kBlockK = 128;           // keys per tile
  static constexpr int kLd = DP + 4;            // padded row: conflict-free float4 reads
  static constexpr int kTile = kBlockK * kLd;
  static constexpr size_t kBytes = 4 * kTile * sizeof(float);  // K x 2, V x 2
};

// four floats of one row from columns [d, d + 4) (d < DP), zero at or beyond
// dim; one 16-byte load when the row's copies are 16 bytes wide
template <int DP>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int d, int dim, int vec) {
  if (vec == 16) {
    return dim == DP || d < dim ? *reinterpret_cast<const float4*>(row + d)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = d + e < dim ? row[d + e] : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

template <int DP, bool FULL>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ out, int seq,
                                 int heads, int dim, long long stride_b, long long stride_s,
                                 long long stride_h, float scale, int causal, int vec, int) {
  if constexpr (FULL) {
    dim = DP;
    vec = 16;
  }
  using S = SmallF32<DP>;
  constexpr int R = S::kRows;
  constexpr int LD = S::kLd;
  constexpr int TILE = S::kTile;
  constexpr int BK = S::kBlockK;
  constexpr int KEYS = BK / 16;  // keys per thread in a tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);  // two buffers
  float* sv = sk + 2 * TILE;                   // two buffers

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::kBlockQ;  // longest causal blocks first
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  const int k_end = causal ? min(seq, q0 + S::kBlockQ) : seq;
  const int n_tiles = (k_end + BK - 1) / BK;
  load_tile_async<float, DP, LD, BK, kThreads>(sk, k + base, 0, seq, stride_s, dim, vec);
  load_tile_async<float, DP, LD, BK, kThreads>(sv, v + base, 0, seq, stride_s, dim, vec);
  cp_async_commit();

  // this thread's query rows, for the whole loop (rows >= seq and columns
  // >= dim are zero), times scale * log2(e): the scores come out in log2
  // units, for exp2
  const float scale_log2 = scale * kLog2e;
  float qr[R][DP];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < seq) x = load4<DP>(q + base + (long long)row * stride_s, d, dim, vec);
      qr[i][d] = x.x * scale_log2;
      qr[i][d + 1] = x.y * scale_log2;
      qr[i][d + 2] = x.z * scale_log2;
      qr[i][d + 3] = x.w * scale_log2;
    }
  }

  float m[R], l[R], acc[R][DP];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // over this thread's keys only, until the end
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[i][d] = 0.f;  // likewise
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<float, DP, LD, BK, kThreads>(sk + (buf ^ 1) * TILE, k + base, k0 + BK,
                                                   seq, stride_s, dim, vec);
      load_tile_async<float, DP, LD, BK, kThreads>(sv + (buf ^ 1) * TILE, v + base, k0 + BK,
                                                   seq, stride_s, dim, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + buf * TILE;
    const float* vt = sv + buf * TILE;

    float s[R][KEYS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const float* krow = kt + (tx + 16 * j) * LD;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          s[i][j] = fmaf(qr[i][d], kv.x, s[i][j]);
          s[i][j] = fmaf(qr[i][d + 1], kv.y, s[i][j]);
          s[i][j] = fmaf(qr[i][d + 2], kv.z, s[i][j]);
          s[i][j] = fmaf(qr[i][d + 3], kv.w, s[i][j]);
        }
      }
    }

    const bool masked = tile_needs_mask<BK>(k0, q0, seq, causal);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = !masked || (col < seq && (!causal || col <= row));
        s[i][j] = live ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // no live key for this row yet: p = 0 and the correction is 0
      const float m_use = mx == -INFINITY ? 0.f : mx;
      // (unconditional: this kernel ran slower on the H100 with a branch that
      // skips it when the max did not move, as the mma kernel does)
      const float corr = exp2f(m[i] - m_use);
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[i][d] *= corr;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        l[i] += s[i][j];
      }
      m[i] = mx;
    }

    // PV over this thread's own keys
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const float* vrow = vt + (tx + 16 * j) * LD;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][d] = fmaf(s[i][j], vv.x, acc[i][d]);
          acc[i][d + 1] = fmaf(s[i][j], vv.y, acc[i][d + 1]);
          acc[i][d + 2] = fmaf(s[i][j], vv.z, acc[i][d + 2]);
          acc[i][d + 3] = fmaf(s[i][j], vv.w, acc[i][d + 3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled in the next iteration
  }

  // reduce the 16 lanes of each row once; lane tx stores columns tx + 16e
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], off);
    }
    const int row = q0 + ty * R + i;
    if (row < seq) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* dst = out + base + (long long)row * stride_s;
#pragma unroll
      for (int d = 0; d < DP; ++d)
        if ((d & 15) == tx && d < dim) dst[d] = acc[i][d] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, D > 32: P through shared memory
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;          // query rows per block
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kKeys = kBlockK / 16;  // keys per thread in a score tile
constexpr int kLdP = kBlockK + 1;    // padded row of the probability tile

// rows [row0, row0 + rows) of one (b, h) slice into a shared tile with row
// stride LD, DP columns of which the first dim are read; rows >= seq and
// columns >= dim are zero-filled
template <int DP, int LD>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int row0,
                                          int rows, int seq, long long stride_s, int dim,
                                          int vec) {
  constexpr int kPerRow = DP / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq) x = load4<DP>(src + (long long)(row0 + r) * stride_s, c, dim, vec);
    float* dst = tile + r * LD + c;
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
}

template <int DP>
struct F32Smem {
  static constexpr int kLd = DP + 1;  // odd word count per row
  static constexpr size_t kQ = (size_t)kBlockQ * kLd * sizeof(float);
  static constexpr size_t kK = (size_t)kBlockK * kLd * sizeof(float);
  static constexpr size_t kV = (size_t)kBlockK * DP * sizeof(float);
  static constexpr size_t kP = (size_t)kBlockQ * kLdP * sizeof(float);
  static constexpr size_t kBytes = kQ + kK + kV + kP;
};

template <int DP, bool FULL>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int seq, int heads,
                           int dim, long long stride_b, long long stride_s, long long stride_h,
                           float scale, int causal, int vec, int) {
  if constexpr (FULL) {
    dim = DP;
    vec = 16;
  }
  using S = F32Smem<DP>;
  constexpr int LD = S::kLd;
  constexpr int E = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = reinterpret_cast<float*>(smem + S::kQ);
  float* sv = reinterpret_cast<float*>(smem + S::kQ + S::kK);
  float* sp = reinterpret_cast<float*>(smem + S::kQ + S::kK + S::kV);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest causal blocks first
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<DP, LD>(sq, q + base, q0, kBlockQ, seq, stride_s, dim, vec);

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
    load_tile<DP, LD>(sk, k + base, k0, kBlockK, seq, stride_s, dim, vec);
    load_tile<DP, DP>(sv, v + base, k0, kBlockK, seq, stride_s, dim, vec);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    // the columns past dim are zero: the product stops at dim
#pragma unroll 8
    for (int d = 0; d < dim; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sq[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = sk[(tx + 16 * j) * LD + d];
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
        sp[(ty * kRows + i) * kLdP + tx + 16 * j] = p;
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
      for (int e = 0; e < E; ++e) vv[e] = sv[j * DP + tx + 16 * e];
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
      float* dst = out + base + (long long)row * stride_s;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (tx + 16 * e < dim) dst[tx + 16 * e] = acc[i][e] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 past D = 256: a slab of 256 output columns a block, P through
// shared memory
// ---------------------------------------------------------------------------

struct F32WideSmem {
  static constexpr int kLdC = kChunkD + 1;  // odd word count per row
  static constexpr size_t kQ = (size_t)kBlockQ * kLdC * sizeof(float);
  static constexpr size_t kK = (size_t)kBlockK * kLdC * sizeof(float);
  static constexpr size_t kV = (size_t)kBlockK * kSlab * sizeof(float);
  static constexpr size_t kP = (size_t)kBlockQ * kLdP * sizeof(float);
  static constexpr size_t kBytes = kQ + kK + kV + kP;
};

__global__ void __launch_bounds__(kThreads)
flash_attention_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out, int seq,
                                int heads, int dim, long long stride_b, long long stride_s,
                                long long stride_h, float scale, int causal, int vec, int) {
  using S = F32WideSmem;
  constexpr int LDC = S::kLdC;
  constexpr int E = kSlab / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = reinterpret_cast<float*>(smem + S::kQ);
  float* sv = reinterpret_cast<float*>(smem + S::kQ + S::kK);
  float* sp = reinterpret_cast<float*>(smem + S::kQ + S::kK + S::kV);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest causal blocks first
  const int col0 = blockIdx.z * kSlab;                    // this block's columns of O
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    // S = Q K^T over the whole D, chunk by chunk
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < dim; c0 += kChunkD) {
      __syncthreads();  // the last chunk (and the last tile's V and P) are no longer read
      load_tile<kChunkD, LDC>(sq, q + base + c0, q0, kBlockQ, seq, stride_s, dim - c0, vec);
      load_tile<kChunkD, LDC>(sk, k + base + c0, k0, kBlockK, seq, stride_s, dim - c0, vec);
      if (c0 == 0) {
        load_tile<kSlab, kSlab>(sv, v + base + col0, k0, kBlockK, seq, stride_s, dim - col0, vec);
      }
      __syncthreads();
      const int n = min(kChunkD, dim - c0);
#pragma unroll 8
      for (int d = 0; d < n; ++d) {
        float qv[kRows], kv[kKeys];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = sq[(ty * kRows + i) * LDC + d];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) kv[j] = sk[(tx + 16 * j) * LDC + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // online softmax, as flash_attention_f32_kernel
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
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_use);
        sum += p;
        sp[(ty * kRows + i) * kLdP + tx + 16 * j] = p;
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
      for (int e = 0; e < E; ++e) vv[e] = sv[j * kSlab + tx + 16 * e];
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
      float* dst = out + base + (long long)row * stride_s;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int col = col0 + tx + 16 * e;
        if (col < dim) dst[col] = acc[i][e] / denom;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// integer and bool: JAX's key tiles in order, every dtype by its element code
// ---------------------------------------------------------------------------

constexpr int kTiledRows = 8;                // query rows of a block, a warp each
constexpr int kTiledThreads = kTiledRows * 32;
constexpr int kTiledChunk = 256;             // keys of a tile whose scores wait in shared memory
constexpr int kTiledCols = kSlab / 32;       // output columns of a lane

__global__ void __launch_bounds__(kTiledThreads)
flash_attention_tiled_kernel(const void* __restrict__ q, const void* __restrict__ k,
                             const void* __restrict__ v, void* __restrict__ out, int seq,
                             int heads, int dim, long long stride_b, long long stride_s,
                             long long stride_h, int code, float scale, int causal, int tile) {
  __shared__ float sc_rows[kTiledRows][kTiledChunk];  // a chunk's scores, then its rounded p
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kTiledRows + warp;
  if (row >= seq) return;  // the whole warp; no block barrier follows
  float* sc = sc_rows[warp];
  const int bh = blockIdx.x;
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const long long q_off = base + (long long)row * stride_s;
  const int col0 = blockIdx.z * kSlab;
  // keys [0, k_end) attend: a causal row stops at its own key (the tiles
  // past it add nothing: their p are 0 and their correction 1)
  const int k_end = causal ? row + 1 : seq;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kTiledCols];
#pragma unroll
  for (int i = 0; i < kTiledCols; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < k_end; t0 += tile) {
    const int t1 = min(k_end, t0 + tile);  // this tile's live keys: [t0, t1)
    const bool held = t1 - t0 <= kTiledChunk;  // its scores all wait in sc
    float mx = -INFINITY;
    for (int c0 = t0; c0 < t1; c0 += kTiledChunk) {
      const int n = min(kTiledChunk, t1 - c0);
      for (int j = 0; j < n; ++j) {
        const float s = tiled::warp_score(q, q_off, k, base + (long long)(c0 + j) * stride_s, dim,
                                          code, scale);
        if (held && lane == 0) sc[j] = s;
        mx = fmaxf(mx, s);
      }
    }
    const float m_new = fmaxf(m, mx);
    // no live key yet: p = 0 and the correction is 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(__fsub_rn(m, m_use));
    float psum = 0.f;
    float pv[kTiledCols];
#pragma unroll
    for (int i = 0; i < kTiledCols; ++i) pv[i] = 0.f;
    for (int c0 = t0; c0 < t1; c0 += kTiledChunk) {
      const int n = min(kTiledChunk, t1 - c0);
      if (!held) {
        for (int j = 0; j < n; ++j) {
          const float s = tiled::warp_score(q, q_off, k, base + (long long)(c0 + j) * stride_s,
                                            dim, code, scale);
          if (lane == 0) sc[j] = s;
        }
      }
      __syncwarp();
      for (int j = lane; j < n; j += 32) {
        const float p = expf(__fsub_rn(sc[j], m_use));
        psum += p;
        sc[j] = tiled::round_p(p, code);
      }
      __syncwarp();
      for (int j = 0; j < n; ++j) {
        const float r = sc[j];
        if (r == 0.f) continue;  // the same in every lane
        const long long v_off = base + (long long)(c0 + j) * stride_s;
#pragma unroll
        for (int i = 0; i < kTiledCols; ++i) {
          const int d = col0 + lane + 32 * i;
          if (d < dim) pv[i] = fmaf(r, tiled::load_f32(v, v_off + d, code), pv[i]);
        }
      }
      __syncwarp();  // sc is rewritten next
    }
    l = __fadd_rn(__fmul_rn(l, corr), tiled::warp_sum(psum));
#pragma unroll
    for (int i = 0; i < kTiledCols; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], corr), pv[i]);
    m = m_new;
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kTiledCols; ++i) {
    const int d = col0 + lane + 32 * i;
    if (d < dim) tiled::store_f32(out, q_off + d, acc[i] / den, code);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int batch, seq, heads, dim;
  long long stride_b, stride_s, stride_h;
  float scale;
  int causal;
  int vec;    // bytes a row copy moves: 16, 8, 4 or 2
  int pairs;  // 1: two outputs are stored together (4-byte aligned pairs)
  cudaStream_t stream;
};

// grid (b*h, query tiles, slabs): slabs of kSlab output columns for the
// wide kernels, 1 for the others
template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int block_q, const Args& a,
                   int slabs = 1) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long bh = (long long)a.batch * a.heads;
  const int q_tiles = (a.seq + block_q - 1) / block_q;
  if (bh > INT_MAX || q_tiles > 65535 || slabs > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)bh, (unsigned)q_tiles, (unsigned)slabs), threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.seq, a.heads, a.dim, a.stride_b, a.stride_s, a.stride_h,
      a.scale, a.causal, a.vec, a.pairs);
  return cudaGetLastError();
}

// rows that fill the padded width and copy in 16 bytes (stores in pairs)
// take the instantiation where dim, vec and pairs are constants
template <int DP>
bool full_rows(const Args& a) {
  return a.dim == DP && a.vec == 16 && a.pairs;
}

template <typename T, int DP>
cudaError_t launch_mma(const Args& a) {
  return full_rows<DP>(a)
             ? launch<T>(flash_attention_mma_kernel<T, DP, true>, MmaSmem<DP>::kBytes,
                         kMmaThreads, kMmaBlockQ, a)
             : launch<T>(flash_attention_mma_kernel<T, DP, false>, MmaSmem<DP>::kBytes,
                         kMmaThreads, kMmaBlockQ, a);
}

template <int DP>
cudaError_t launch_f32_small(const Args& a) {
  return full_rows<DP>(a)
             ? launch<float>(flash_attention_f32_small_kernel<DP, true>, SmallF32<DP>::kBytes,
                             kThreads, SmallF32<DP>::kBlockQ, a)
             : launch<float>(flash_attention_f32_small_kernel<DP, false>, SmallF32<DP>::kBytes,
                             kThreads, SmallF32<DP>::kBlockQ, a);
}

template <int DP>
cudaError_t launch_f32(const Args& a) {
  return full_rows<DP>(a) ? launch<float>(flash_attention_f32_kernel<DP, true>,
                                          F32Smem<DP>::kBytes, kThreads, kBlockQ, a)
                          : launch<float>(flash_attention_f32_kernel<DP, false>,
                                          F32Smem<DP>::kBytes, kThreads, kBlockQ, a);
}

// slabs of kSlab output columns a wide kernel's grid holds
int slabs(int dim) { return (dim + kSlab - 1) / kSlab; }

// the padded width a head dim runs at: the smallest instantiated one that
// holds it (0 past 256, where the wide kernels run)
int padded_dim(int dim) {
  if (dim < 1) return 0;
  for (int dp : {16, 32, 64, 96, 128, 256})
    if (dim <= dp) return dp;
  return 0;
}

template <typename T>
cudaError_t dispatch_mma(const Args& a) {
  switch (padded_dim(a.dim)) {
    case 16: return launch_mma<T, 16>(a);
    case 32: return launch_mma<T, 32>(a);
    case 64: return launch_mma<T, 64>(a);
    case 96: return launch_mma<T, 96>(a);
    case 128: return launch_mma<T, 128>(a);
    case 256: return launch_mma<T, 256>(a);
    default:
      return launch<T>(flash_attention_mma_wide_kernel<T>, MmaWideSmem::kBytes, kMmaThreads,
                       kMmaBlockQ, a, slabs(a.dim));
  }
}

cudaError_t dispatch_f32(const Args& a) {
  switch (padded_dim(a.dim)) {
    case 16: return launch_f32_small<16>(a);
    case 32: return launch_f32_small<32>(a);
    case 64: return launch_f32<64>(a);
    case 96: return launch_f32<96>(a);
    case 128: return launch_f32<128>(a);
    case 256: return launch_f32<256>(a);
    default:
      return launch<float>(flash_attention_f32_wide_kernel, F32WideSmem::kBytes, kThreads,
                           kBlockQ, a, slabs(a.dim));
  }
}

// the widest copy (16, 8, 4 or 2 bytes) that divides every row's start: the
// base addresses, the strides and the row's own bytes
int row_copy_bytes(const Args& a, int itemsize) {
  const unsigned long long bits =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | (unsigned long long)(a.stride_b * itemsize) |
      (unsigned long long)(a.stride_s * itemsize) | (unsigned long long)(a.stride_h * itemsize) |
      (unsigned long long)(a.dim * itemsize);
  for (int vec : {16, 8, 4})
    if (bits % vec == 0) return vec;
  return 2;
}

}  // namespace

// Dynamic shared memory per block of the kernel that runs for (dtype, dim)
// (0 for an unsupported pair): ptxas reports static shared memory only.
extern "C" int flash_attention_smem_bytes(int dtype, int dim) {
  if (dim < 1) return 0;
  const int dp = padded_dim(dim);
  if (dtype == 1 || dtype == 2) {
    switch (dp) {
      case 16: return (int)MmaSmem<16>::kBytes;
      case 32: return (int)MmaSmem<32>::kBytes;
      case 64: return (int)MmaSmem<64>::kBytes;
      case 96: return (int)MmaSmem<96>::kBytes;
      case 128: return (int)MmaSmem<128>::kBytes;
      case 256: return (int)MmaSmem<256>::kBytes;
      default: return (int)MmaWideSmem::kBytes;
    }
  } else if (dtype == 0) {
    switch (dp) {
      case 16: return (int)SmallF32<16>::kBytes;
      case 32: return (int)SmallF32<32>::kBytes;
      case 64: return (int)F32Smem<64>::kBytes;
      case 96: return (int)F32Smem<96>::kBytes;
      case 128: return (int)F32Smem<128>::kBytes;
      case 256: return (int)F32Smem<256>::kBytes;
      default: return (int)F32WideSmem::kBytes;
    }
  }
  return 0;
}

// q, k, v and out share the [B,S,H,D] shape and the element strides
// (stride_b, stride_s, stride_h; the last dimension is contiguous), any D
// >= 1. dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int seq, int heads, int dim,
                                      long long stride_b, long long stride_s,
                                      long long stride_h, int dtype, float scale, int causal,
                                      void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, out, batch, seq, heads, dim, stride_b, stride_s, stride_h, scale, causal,
         0, 0, static_cast<cudaStream_t>(stream)};
  const int itemsize = dtype == 0 ? 4 : 2;
  a.vec = row_copy_bytes(a, itemsize);
  a.pairs = (reinterpret_cast<uintptr_t>(out) % 4 == 0 && dim % 2 == 0 && stride_b % 2 == 0 &&
             stride_s % 2 == 0 && stride_h % 2 == 0) ? 1 : 0;
  switch (dtype) {
    case 0: return (int)dispatch_f32(a);
    case 1: return (int)dispatch_mma<bf16>(a);
    case 2: return (int)dispatch_mma<half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiled kernel, for integer and bool inputs: code is the element code
// of q, k, v and out (ELEMENT_CODES: 0-7), any dim >= 1, tile =
// min(block_k, seq) >= 1 keys. Strides as flash_attention_launch. Returns
// a cudaError_t (0 = launched).
extern "C" int flash_attention_tiled_launch(const void* q, const void* k, const void* v,
                                            void* out, int batch, int seq, int heads, int dim,
                                            long long stride_b, long long stride_s,
                                            long long stride_h, int code, float scale,
                                            int causal, int tile, void* stream) {
  const long long bh = (long long)batch * heads;
  const long long row_blocks = ((long long)seq + kTiledRows - 1) / kTiledRows;
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0 || tile <= 0 || code < 0 || code > 7 ||
      bh > INT_MAX || row_blocks > 65535 || slabs(dim) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  flash_attention_tiled_kernel<<<dim3((unsigned)bh, (unsigned)row_blocks, (unsigned)slabs(dim)),
                                 kTiledThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, seq, heads, dim, stride_b, stride_s, stride_h, code, scale, causal, tile);
  return (int)cudaGetLastError();
}
