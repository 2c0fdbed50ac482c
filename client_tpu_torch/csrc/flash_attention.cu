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
// benchmark shapes the flops over the card's peak are the least time: the
// bf16 tensor-core peak for bf16, the fp32 CUDA-core peak for fp32.
//
// Every kernel here gives a block a (b*h, query tile) and walks the key
// tiles in order with the running (max, sum, acc) state in registers, as
// the Pallas grid walks its "arbitrary" key axis; a causal block stops at
// the diagonal tile and only the diagonal tile (and a ragged last one) is
// masked. The [B,S,H,D] layout is indexed with strides (no transposes);
// keys >= S are masked and their K/V rows zero-filled, so a ragged S is never
// padded in memory; query rows >= S are not stored. A row with no live key
// yet keeps p = 0 and a correction of 0 (never exp(-inf - -inf)); the final
// divide is by max(l, 1e-30), as in Pallas. The two new kernels take the
// softmax in log2 units (exp2, with scale * log2(e) folded into the score
// scaling, or into Q for fp32). Three kernels:
//
// - bf16, any D (flash_attention_mma_kernel): a FlashAttention-2 layout on the tensor
//   cores. 4 warps own 16 rows each of a 64-row query tile. Each warp loads
//   its Q fragments once with ldmatrix and keeps them in registers; QK^T is
//   mma.sync m16n8k16 bf16 -> fp32; the online softmax runs on the
//   accumulator fragments (row max by quad shuffles, each thread summing its
//   own columns until the end); P is rounded to bf16 in registers and used
//   directly as the A operand of the PV mma (no P tile in shared memory).
//   K/V tiles of 64 keys are double-buffered with cp.async (16-byte copies,
//   rows >= S zero-filled), so the next tile's copy overlaps this one's
//   math. Shared rows are padded by 16 bytes: ldmatrix reads are
//   conflict-free. A row whose max did not move skips the accumulator's
//   rescale (its correction is exactly 1).
// - fp32, D <= 32 (flash_attention_f32_small_kernel): CUDA-core FMAs. Thread
//   (ty, tx) of a 16 x 16 grid owns 64/D query rows, held in registers for
//   the whole loop, and the keys tx + 16j of each 128-key tile (the
//   per-tile softmax bookkeeping spread over 8 keys a thread). Its PV
//   accumulator sums over ITS OWN keys across the whole loop (the rescale
//   by corr is uniform along a row, so this is exact); the 16 lanes of a row
//   are reduced once, at the end. So P never goes through shared memory.
//   K/V tiles are double-buffered with cp.async as above.
// - fp32, D >= 64 (flash_attention_f32_kernel): the first design, kept. Thread
//   (ty, tx) owns 4 query rows; scores at keys tx + 16j go through a shared
//   P tile into the PV product at columns tx + 16e.
// The host entry point returns the launch's cudaError_t; it takes the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockK = 64;  // keys per tile (every kernel)
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// cp.async, ldmatrix and mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with live = false the 16 bytes are zeroed
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
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

// c[16x8] += a[16x16] . b[16x8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (p.astype(bf16)), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &h, sizeof(r));
  return r;
}

// rows [row0, row0 + ROWS) of one (b, h) slice into a shared tile with row
// stride LD, by 16-byte cp.async; rows >= seq are zero-filled
template <typename T, int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* tile, const T* __restrict__ src, int row0,
                                                int seq, long long stride_s) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool live = row0 + r < seq;
    const T* g = live ? src + (long long)(row0 + r) * stride_s + c : src;
    cp_async16(tile + r * LD + c, g, live);
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
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlockQ = kMmaWarps * 16;  // each warp owns 16 query rows

template <int D>
struct MmaSmem {
  static constexpr int kLd = D + 8;  // 16 bytes of padding: conflict-free ldmatrix
  static constexpr int kTile = 64 * kLd;
  static constexpr size_t kBytes = 5 * kTile * sizeof(bf16);  // Q, K x 2, V x 2
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int seq, int heads,
                           long long stride_b, long long stride_s, long long stride_h, float scale,
                           int causal) {
  static_assert(kMmaBlockQ == kBlockK, "the diagonal tile is the block's own");
  constexpr int LD = MmaSmem<D>::kLd;
  constexpr int TILE = MmaSmem<D>::kTile;
  constexpr int KSTEPS = D / 16;     // k-steps of QK^T
  constexpr int NT = kBlockK / 8;    // 8-key n-tiles of S
  constexpr int DT = D / 8;          // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + TILE;      // two buffers
  bf16* sv = sk + 2 * TILE;  // two buffers

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

  const int k_end = causal ? min(seq, q0 + kMmaBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  load_tile_async<bf16, D, LD, kMmaBlockQ, kMmaThreads>(sq, q + base, q0, seq, stride_s);
  load_tile_async<bf16, D, LD, kBlockK, kMmaThreads>(sk, k + base, 0, seq, stride_s);
  load_tile_async<bf16, D, LD, kBlockK, kMmaThreads>(sv, v + base, 0, seq, stride_s);
  cp_async_commit();

  uint32_t qa[KSTEPS][4];
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
      load_tile_async<bf16, D, LD, kBlockK, kMmaThreads>(sk + (buf ^ 1) * TILE, k + base,
                                                         k0 + kBlockK, seq, stride_s);
      load_tile_async<bf16, D, LD, kBlockK, kMmaThreads>(sv + (buf ^ 1) * TILE, v + base,
                                                         k0 + kBlockK, seq, stride_s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      // this warp's Q fragments, kept in registers for the whole loop
      const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qa[kk], sq + r * LD + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = sk + buf * TILE;
    const bf16* vt = sv + buf * TILE;

    // S = Q K^T: 16 rows x 64 keys per warp, fp32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b, kt + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
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

    // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, vt + key * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
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
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t;
    if (row0 < seq) {
      *reinterpret_cast<__nv_bfloat162*>(out + base + (long long)row0 * stride_s + col) =
          __floats2bfloat162_rn(o[j][0] / den0, o[j][1] / den0);
    }
    if (row1 < seq) {
      *reinterpret_cast<__nv_bfloat162*>(out + base + (long long)row1 * stride_s + col) =
          __floats2bfloat162_rn(o[j][2] / den1, o[j][3] / den1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, D <= 32: Q and the PV partial sums in registers
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid (both fp32 kernels)

template <int D>
struct SmallF32 {
  static constexpr int kRows = 64 / D;          // query rows per thread
  static constexpr int kBlockQ = 16 * kRows;    // query rows per block
  static constexpr int kBlockK = 128;           // keys per tile
  static constexpr int kLd = D + 4;             // padded row: conflict-free float4 reads
  static constexpr int kTile = kBlockK * kLd;
  static constexpr size_t kBytes = 4 * kTile * sizeof(float);  // K x 2, V x 2
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ out, int seq,
                                 int heads, long long stride_b, long long stride_s, long long stride_h,
                                 float scale, int causal) {
  using S = SmallF32<D>;
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
  load_tile_async<float, D, LD, BK, kThreads>(sk, k + base, 0, seq, stride_s);
  load_tile_async<float, D, LD, BK, kThreads>(sv, v + base, 0, seq, stride_s);
  cp_async_commit();

  // this thread's query rows, for the whole loop (rows >= seq are zero),
  // times scale * log2(e): the scores come out in log2 units, for exp2
  const float scale_log2 = scale * kLog2e;
  float qr[R][D];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < seq) x = *reinterpret_cast<const float4*>(q + base + (long long)row * stride_s + d);
      qr[i][d] = x.x * scale_log2;
      qr[i][d + 1] = x.y * scale_log2;
      qr[i][d + 2] = x.z * scale_log2;
      qr[i][d + 3] = x.w * scale_log2;
    }
  }

  float m[R], l[R], acc[R][D];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // over this thread's keys only, until the end
#pragma unroll
    for (int d = 0; d < D; ++d) acc[i][d] = 0.f;  // likewise
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<float, D, LD, BK, kThreads>(sk + (buf ^ 1) * TILE, k + base,
                                                       k0 + BK, seq, stride_s);
      load_tile_async<float, D, LD, BK, kThreads>(sv + (buf ^ 1) * TILE, v + base,
                                                       k0 + BK, seq, stride_s);
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
      for (int d = 0; d < D; d += 4) {
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
      // skips it when the max did not move, as the bf16 kernel does)
      const float corr = exp2f(m[i] - m_use);
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[i][d] *= corr;
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
      for (int d = 0; d < D; d += 4) {
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
      for (int d = 0; d < D; ++d) acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], off);
    }
    const int row = q0 + ty * R + i;
    if (row < seq) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* dst = out + base + (long long)row * stride_s;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if ((d & 15) == tx) dst[d] = acc[i][d] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, D >= 64: P through shared memory
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;          // query rows per block
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kKeys = kBlockK / 16;  // keys per thread in a score tile
constexpr int kLdP = kBlockK + 1;    // padded row of the probability tile

// rows [row0, row0 + rows) of one (b, h) slice into a shared tile with row
// stride LD; rows >= seq are zero-filled
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int row0,
                                          int rows, int seq, long long stride_s) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq) x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * stride_s + c);
    float* dst = tile + r * LD + c;
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
}

template <int D>
struct F32Smem {
  static constexpr int kLd = D + 1;  // odd word count per row
  static constexpr size_t kQ = (size_t)kBlockQ * kLd * sizeof(float);
  static constexpr size_t kK = (size_t)kBlockK * kLd * sizeof(float);
  static constexpr size_t kV = (size_t)kBlockK * D * sizeof(float);
  static constexpr size_t kP = (size_t)kBlockQ * kLdP * sizeof(float);
  static constexpr size_t kBytes = kQ + kK + kV + kP;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int seq, int heads,
                           long long stride_b, long long stride_s, long long stride_h, float scale,
                           int causal) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd;
  constexpr int E = D / 16;  // output columns per thread
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

  load_tile<D, LD>(sq, q + base, q0, kBlockQ, seq, stride_s);

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
    load_tile<D, LD>(sk, k + base, k0, kBlockK, seq, stride_s);
    load_tile<D, D>(sv, v + base, k0, kBlockK, seq, stride_s);
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
      for (int e = 0; e < E; ++e) vv[e] = sv[j * D + tx + 16 * e];
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
      for (int e = 0; e < E; ++e) dst[tx + 16 * e] = acc[i][e] / denom;
    }
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
  int batch, seq, heads;
  long long stride_b, stride_s, stride_h;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int block_q, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long bh = (long long)a.batch * a.heads;
  const int q_tiles = (a.seq + block_q - 1) / block_q;
  if (bh > INT_MAX || q_tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)bh, (unsigned)q_tiles), threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.seq, a.heads, a.stride_b, a.stride_s, a.stride_h, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  return launch<bf16>(flash_attention_mma_kernel<D>, MmaSmem<D>::kBytes, kMmaThreads, kMmaBlockQ, a);
}

template <int D>
cudaError_t launch_f32_small(const Args& a) {
  return launch<float>(flash_attention_f32_small_kernel<D>, SmallF32<D>::kBytes, kThreads,
                       SmallF32<D>::kBlockQ, a);
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  return launch<float>(flash_attention_f32_kernel<D>, F32Smem<D>::kBytes, kThreads, kBlockQ, a);
}

}  // namespace

// Dynamic shared memory per block of the kernel that runs for (dtype, dim)
// (0 for an unsupported pair): ptxas reports static shared memory only.
extern "C" int flash_attention_smem_bytes(int dtype, int dim) {
  if (dtype == 1) {
    switch (dim) {
      case 16: return (int)MmaSmem<16>::kBytes;
      case 32: return (int)MmaSmem<32>::kBytes;
      case 64: return (int)MmaSmem<64>::kBytes;
      case 128: return (int)MmaSmem<128>::kBytes;
    }
  } else if (dtype == 0) {
    switch (dim) {
      case 16: return (int)SmallF32<16>::kBytes;
      case 32: return (int)SmallF32<32>::kBytes;
      case 64: return (int)F32Smem<64>::kBytes;
      case 128: return (int)F32Smem<128>::kBytes;
    }
  }
  return 0;
}

// q, k, v and out share the [B,S,H,D] shape and the element strides
// (stride_b, stride_s, stride_h; the last dimension is contiguous).
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int seq, int heads, int dim,
                                      long long stride_b, long long stride_s,
                                      long long stride_h, int dtype, float scale, int causal,
                                      void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, batch, seq, heads, stride_b, stride_s, stride_h, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    switch (dim) {
      case 16: return (int)launch_bf16<16>(a);
      case 32: return (int)launch_bf16<32>(a);
      case 64: return (int)launch_bf16<64>(a);
      case 128: return (int)launch_bf16<128>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (dim) {
      case 16: return (int)launch_f32_small<16>(a);
      case 32: return (int)launch_f32_small<32>(a);
      case 64: return (int)launch_f32<64>(a);
      case 128: return (int)launch_f32<128>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
