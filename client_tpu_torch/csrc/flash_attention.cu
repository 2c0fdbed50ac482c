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
//   product. fp32 keeps fp32 precision: FMAs on the CUDA cores at D <= 32
//   and past 256, 3xTF32 on the tensor cores at D 33-256 (below); never
//   one-pass TF32, which keeps about three decimal digits.
//
// Bound on the H100: operations. The work is 4*B*H*S^2*D flops (about half
// with causal masking) over 4*B*S*H*D elements moved, so at the served and
// benchmark shapes the flops over the card's peak are the least time: the
// tensor-core peak for bf16 and fp16; for fp32 the CUDA cores' FMA peak (67
// TFLOP/s), and at head dims 33-256, which run in 3xTF32, three TF32
// products a product over the TF32 tensor-core peak (495 TFLOP/s).
//
// Every kernel here gives a block a (b*h, query tile) and walks the key
// tiles in order with the running (max, sum, acc) state in registers, as
// the Pallas grid walks its "arbitrary" key axis; a causal block stops at
// the diagonal tile and only the diagonal tile (and a ragged last one) is
// masked. The [B,S,H,D] layout is indexed with strides (no transposes);
// keys >= S are masked and their K/V rows zero-filled, so a ragged S is never
// padded in memory; query rows >= S are not stored. A row with no live key
// yet keeps p = 0 and a correction of 0 (never exp(-inf - -inf)); the final
// divide is by max(l, 1e-30), as in Pallas. The float kernels take the
// softmax in log2 units (exp2, with scale * log2(e) folded into the score
// scaling, or into Q in the fp32 kernel for D <= 32).
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
// - fp32, D 33-256 (flash_attention_f32_tc_kernel): 3xTF32 on the tensor
//   cores. It took the place of the first fp32 design (CUDA-core FMAs, a
//   thread 4 query rows, P through a shared tile, plain loads between two
//   barriers), whose limits the parts below answer one by one. Bound:
//   operations, three TF32 products for each product, 3 * 4*B*H*S^2*D
//   flops over the 495 TFLOP/s TF32 peak (the fp32 FMA bound, 4*B*H*S^2*D
//   over 67 TFLOP/s, is 2.5x that). Each fp32 operand x of QK^T and PV is
//   split into big = rna(x) and small = rna(x - big), TF32 values (rna: to
//   nearest, ties away, as cvt.rna.tf32.f32 rounds, done in integer ops:
//   cvt compiles to a compare and a select more a value), and a product is
//   small.big + big.small + big.big, each term exact in fp32, summed in the
//   fp32 accumulators of mma.sync m16n8k8 tf32: the error of fp32, where
//   one-pass TF32 misses the 2e-5 gate (flash_attention_3xtf32_reference in
//   ops/flash_attention.py is the plain form). The FlashAttention-2 layout
//   of the bf16 kernel: 4 warps own 16 query rows each of a 64-row tile, and
//   the online softmax runs on the accumulator fragments.
//   (1) CUDA-core FMAs: the products run on the tensor cores.
//   (2) Loops bound by shared-memory reads: a thread's A fragment takes
//   columns 2t and 2t + 1 of a row as the step's k-indices t and t + 4
//   (QK^T's depth is walked in that order), so a fragment of Q or K is one
//   float2 read a row, rows padded by 8 floats (no bank conflict); a K
//   fragment feeds 3 mma of 16 x 8 x 8.
//   (3) No overlap: K and V are copied by cp.async into one tile each, rows
//   >= S zero-filled, K(t + 1) during the softmax and PV of tile t, V(t + 1)
//   during QK^T of tile t + 1 (three barriers a tile; two buffers of each
//   would halve the blocks an SM).
//   (4) P through shared memory: the S accumulator gives a thread keys 2t
//   and 2t + 1 of each 8-key n-tile, which PV's A operand takes as its
//   k-indices t and t + 4, V's rows 2t and 2t + 1 read to match (V's rows
//   padded by 4 floats: no bank conflict), so P stays in registers and no
//   value moves between lanes. PV sums each tile in fresh accumulators and
//   adds them to O in fp32: the tensor core's own fp32 sums over a whole
//   sequence drifted by up to 1.6e-5 at S = 8192 on the H100, 1e-6 this way.
//   (5) Shared memory and registers: Q, K and V take 64 rows each of DP +
//   8, DP + 8 and DP + 4 floats, 54, 79 and 103 KB a block at DP = 64, 96
//   and 128 (168, 213 and 237 registers a thread): three, two and two
//   blocks, 12, 8 and 8 warps an SM. At DP = 256 they take 202 KB (one
//   block an SM) and O 128 registers a thread, so 8 warps share the work:
//   the two warps of each 16 rows own half of O's columns each and half of
//   QK^T's depth each, their partial S summed through a 4 KB shared slot a
//   pair (two named barriers a tile; both warps get the same bits), 218 KB,
//   239 registers, no spill.
// - D > 256 (flash_attention_mma_wide_kernel for bf16 and fp16,
//   flash_attention_f32_wide_kernel for fp32): a thread-block cluster of n
//   blocks (at most 8, the portable size; grid.z = n * groups, clusters of
//   (1, 1, n) launched by cudaLaunchKernelEx) covers one (b*h, query tile).
//   D is cut evenly into n * groups slabs of whole 8-column units, at most
//   kWideWidth = 128 columns each (the last ends at D and is zero-padded in
//   shared memory): D = 257 gives three slabs of 88 / 88 / 81, D = 512 four
//   of 128. Block r of cluster group g owns output slab g * n + r, and its
//   share of QK^T's depth is slabs j * n + r (j < groups): with one group
//   (every D up to 8 * 128 = 1024) the two are the same span, so every
//   byte of Q, K and V is read once a query tile and QK^T is computed once,
//   split across the cluster. Past 1024, each of the ceil(D / 1024) groups
//   computes the whole QK^T again (groups x the QK^T work and the Q and K
//   reads of one pass) and restages its Q chunks for each key tile; with one
//   group Q stays in shared memory for the whole loop. The key tile's scores
//   are exchanged inside the cluster as a reduce-scatter and an all-gather
//   over distributed shared memory, in stores only (every block pulling
//   every partial over DSMEM took most of the kernel's time on the H100:
//   PERF.md): row r of the query tile belongs to block r % n. Each block
//   stores its partial S (fp32) of each row into the owner's receive tile;
//   after a cluster barrier each owner sums its rows' n partials in rank
//   order (so every group sums the same ones in the same order), runs the
//   online softmax on them (the dense kernels' masks, m_use and correction
//   of 0 for a row with no live key yet) and stores the rows' P (rounded to
//   the input type in bf16 / fp16, as the dense kernel does) and
//   corrections into every block; after a second barrier every block
//   rescales its O slab and adds P times its V slab. So every block holds
//   the same bits of P and of each row's correction, and the slabs share
//   one normalisation (at the end the owners store each row's l into every
//   block). The loop is ordered so that the stores land while the block
//   computes: tile t's partials go out, PV of tile t - 1 runs, barrier, the
//   owners' softmax of tile t (P out), QK^T of tile t + 1, barrier; P and
//   the corrections alternate between two buffers. K chunks are
//   double-buffered with cp.async (a tile's first chunk prefetched during
//   the tile before); V (the block's own slab) is loaded right after the PV
//   that read the buffer last, a whole key tile before its own. Per key
//   tile: two cluster barriers and, a block, stores of (n - 1) / n x 16 KB
//   of partials and (n - 1) / n of the P tile, against the 2 x 64 x 64 x
//   128 MACs of its products. bf16 / fp16: 4 warps of 16 query rows,
//   mma.sync m16n8k16 as the dense kernel, Q fragments by ldmatrix from the
//   resident Q at each k-step, P fragments by ldmatrix from the exchange, 64
//   fp32 O accumulators a thread; 107 KB of shared memory (124 KB with two Q
//   buffers), two blocks an SM. fp32: 8 warps over query tiles of 80 rows
//   where Q stays resident (one cluster group; 64 past it, where Q's second
//   buffer leaves no room): at the served (1, 1024, 4, 512) that makes 52
//   clusters of 4, two waves of the 30 the card holds at one block an SM,
//   where 64-row tiles make 64 clusters, three waves. Each thread owns a 5 x
//   4 register tile of S (float4 loads along D from row-major Q and K: 80
//   FMAs for nine 16-byte loads) and a 5 x 8 tile of O (per 4 keys, 160
//   FMAs for 13 loads of P and V), full fp32 FMA (no TF32); 211 KB of
//   shared memory (222 KB at 64 rows with two Q buffers), one block an SM.
//   Every cluster holds 3 blocks or more, so an owner's rows fit its
//   threads. A kernel checks that its cluster has the plan's n blocks (else
//   it traps), and the launch asks cudaOccupancyMaxActiveClusters once per
//   configuration and refuses one that cannot be scheduled.
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

#include <atomic>
#include <initializer_list>
#include <type_traits>

#include <cooperative_groups.h>

#include "tiled_attention.cuh"

namespace {

namespace cg = cooperative_groups;

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
// fp32, D <= 32: Q and the PV partial sums in registers
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid

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
// fp32, D 33-256: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // query rows a block (this kernel; the fp32 wide kernel past one group)
constexpr int kTf32RowWarps = kBlockQ / 16;  // warps of distinct rows: 16 query rows each
static_assert(kBlockQ == kBlockK, "the diagonal tile is the block's own");

// fp32 to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest, ties
// away from zero: half a TF32 ulp added to the magnitude bits, the 13 low
// bits cleared; tf32_round in ops/flash_attention.py). cvt.rna itself
// compiles to a compare and a select more a value (its inf and NaN cases):
// the kernel ran 17-24% slower with it on the H100 (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, each a TF32 value; x - big is exact in fp32
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c[16x8] += a[16x8] . b[8x8], TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32: small.big + big.small + big.big, each product
// exact in fp32, summed in the fp32 accumulators; b0 and b1 (the step's
// k-indices t and t + 4 of column g) are split here
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t b_big[2], b_small[2];
  tf32_split(b0, b_big[0], b_small[0]);
  tf32_split(b1, b_big[1], b_small[1]);
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// the A fragment of one m16n8k8 step, split: lo (row g) and hi (row g + 8)
// hold the step's k-indices t and t + 4 in .x and .y
__device__ __forceinline__ void split_a(float2 lo, float2 hi, uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  tf32_split(lo.x, big[0], small[0]);
  tf32_split(hi.x, big[1], small[1]);
  tf32_split(lo.y, big[2], small[2]);
  tf32_split(hi.y, big[3], small[3]);
}

template <int DP>
struct Tf32Plan {
  // O's columns split over kColSplit warps of the same 16 rows (at DP =
  // 256: 64 accumulators a thread, not 128, and 8 warps an SM where the
  // tiles leave room for one block)
  static constexpr int kColSplit = DP == 256 ? 2 : 1;
  // and QK^T's depth split between them, each half's partial S summed
  // through shared memory (a 4 KB slot a pair)
  static constexpr bool kDepthSplit = kColSplit == 2;
  static constexpr int kWarps = kTf32RowWarps * kColSplit;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kMinBlocks = DP == 64 ? 3 : DP == 256 ? 1 : 2;  // blocks an SM
  static constexpr int kQkUnroll = 2;  // QK^T k-steps unrolled
  static constexpr int kPvGroup = 4;   // O's n-tiles summed together in PV (fresh accumulators)
  static constexpr int kLdK = DP + 8;  // row of Q and K: float2 fragment reads conflict-free
  static constexpr int kLdV = DP + 4;  // row of V: the reads of rows 2t and 2t + 1 conflict-free
  static constexpr int kTileQ = kBlockQ * kLdK;
  static constexpr int kTileK = kBlockK * kLdK;
  static constexpr int kTileV = kBlockK * kLdV;
  static constexpr int kTileX = kDepthSplit ? kTf32RowWarps * (kBlockK / 8) * 4 * 32 : 0;
  static constexpr size_t kBytes = (size_t)(kTileQ + kTileK + kTileV + kTileX) * sizeof(float);
};

// the two warps of rows r (named barrier 1 + r, 64 threads)
__device__ __forceinline__ void pair_sync(int r) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + r) : "memory");
}

template <int DP, bool FULL>
__global__ void __launch_bounds__(Tf32Plan<DP>::kThreads, Tf32Plan<DP>::kMinBlocks)
flash_attention_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out, int seq,
                              int heads, int dim, long long stride_b, long long stride_s,
                              long long stride_h, float scale, int causal, int vec, int) {
  if constexpr (FULL) {
    dim = DP;
    vec = 16;
  }
  using P = Tf32Plan<DP>;
  constexpr int LDK = P::kLdK;
  constexpr int LDV = P::kLdV;
  constexpr int THREADS = P::kThreads;
  constexpr int KSTEPS = DP / 8;                  // k-steps of QK^T
  constexpr int NT = kBlockK / 8;                 // 8-key n-tiles of S (and k-steps of PV)
  constexpr int DT = DP / 8 / P::kColSplit;       // 8-column n-tiles of O a warp
  constexpr int KS = P::kDepthSplit ? KSTEPS / 2 : KSTEPS;  // QK^T k-steps a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + P::kTileQ;
  float* sv = sk + P::kTileK;
  float* sx = sv + P::kTileV;  // the partial S slots (depth split)

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest causal blocks first
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int warp = threadIdx.x >> 5;
  const int rows = warp % kTf32RowWarps;  // this warp's 16 query rows
  const int half = warp / kTf32RowWarps;   // its share of O's columns (and QK^T's depth)
  const int col0 = half * DT * 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int row0 = q0 + rows * 16 + g;
  const int row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;  // scores in log2 units, for exp2

  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  load_tile_async<float, DP, LDK, kBlockQ, THREADS>(sq, q + base, q0, seq, stride_s, dim, vec);
  load_tile_async<float, DP, LDK, kBlockK, THREADS>(sk, k + base, 0, seq, stride_s, dim, vec);
  cp_async_commit();
  load_tile_async<float, DP, LDV, kBlockK, THREADS>(sv, v + base, 0, seq, stride_s, dim, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // this thread's A fragments of Q: rows g and g + 8 at columns 8kk + 2t and
  // 8kk + 2t + 1, taken as step kk's k-indices t and t + 4 (QK^T's depth is
  // walked in that order, so one float2 a row reads both)
  const int d0 = P::kDepthSplit ? half * KS * 8 : 0;
  const float* q_lo = sq + (rows * 16 + g) * LDK + d0 + 2 * t;
  const float* q_hi = q_lo + 8 * LDK;
  const float* k_frag = sk + g * LDK + d0 + 2 * t;

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's columns only, until the end

  // one K and one V tile: K(it + 1) is copied during the softmax and PV of
  // tile it, V(it + 1) during QK^T of tile it + 1
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    const bool next = it + 1 < n_tiles;

    // S = Q K^T: 16 rows x 64 keys a warp, fp32 (K(it) is in place)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll P::kQkUnroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a_big[4], a_small[4];
      split_a(*reinterpret_cast<const float2*>(q_lo + kk * 8),
              *reinterpret_cast<const float2*>(q_hi + kk * 8), a_big, a_small);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(k_frag + j * 8 * LDK + kk * 8);
        mma_3xtf32(s[j], a_big, a_small, b.x, b.y);
      }
    }
    if constexpr (P::kDepthSplit) {
      // S = the two halves' sum, the same bits in both warps: half 0 stores
      // its partial; half 1 takes it, stores its own in its place (each lane
      // its own words) and adds; half 0 takes that and adds
      float* slot = sx + rows * NT * 4 * 32 + lane;
      if (half == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) slot[(j * 4 + c) * 32] = s[j][c];
        pair_sync(rows);
        pair_sync(rows);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] += slot[(j * 4 + c) * 32];
      } else {
        pair_sync(rows);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float other = slot[(j * 4 + c) * 32];
            slot[(j * 4 + c) * 32] = s[j][c];
            s[j][c] = other + s[j][c];
          }
        }
        pair_sync(rows);
      }
    }
    __syncthreads();  // every warp is done with K(it)
    if (next) {
      load_tile_async<float, DP, LDK, kBlockK, THREADS>(sk, k + base, k0 + kBlockK, seq,
                                                        stride_s, dim, vec);
      cp_async_commit();
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
    // P as A fragments, split: the accumulator gives this thread keys 2t and
    // 2t + 1 of n-tile kk, which PV's step kk takes as its k-indices t and t
    // + 4 (V's rows 2t and 2t + 1 are read to match), so no value moves
    // between lanes
    uint32_t p_big[NT][4], p_small[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
      split_a(make_float2(s[kk][0], s[kk][1]), make_float2(s[kk][2], s[kk][3]), p_big[kk],
              p_small[kk]);

    if (next) {
      cp_async_wait<1>();  // V(it); K(it + 1) may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // V(it) is in place

    // O += P V, a tile's product summed in fresh accumulators and added to O
    // in fp32 (round to nearest): the tensor core's own fp32 sums then run
    // over 64 keys, not the whole sequence
    const float* v_frag = sv + 2 * t * LDV + col0 + g;
    constexpr int JG = P::kPvGroup;
#pragma unroll
    for (int j0 = 0; j0 < DT; j0 += JG) {
      float acc[JG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[jj][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          const float* v0 = v_frag + kk * 8 * LDV + (j0 + jj) * 8;
          mma_3xtf32(acc[jj], p_big[kk], p_small[kk], v0[0], v0[LDV]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[j0 + jj][c] += acc[jj][c];
    }
    if (next) {
      cp_async_wait<0>();  // K(it + 1)
      __syncthreads();     // every warp is done with V(it); K(it + 1) is in place
      load_tile_async<float, DP, LDV, kBlockK, THREADS>(sv, v + base, k0 + kBlockK, seq,
                                                        stride_s, dim, vec);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f);
  const float den1 = fmaxf(l[1], 1e-30f);
  // this warp's columns below dim only
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col >= dim) continue;
    const bool second = col + 1 < dim;
    if (row0 < seq) {
      float* dst = out + base + (long long)row0 * stride_s + col;
      dst[0] = o[j][0] / den0;
      if (second) dst[1] = o[j][1] / den0;
    }
    if (row1 < seq) {
      float* dst = out + base + (long long)row1 * stride_s + col;
      dst[0] = o[j][2] / den1;
      if (second) dst[1] = o[j][3] / den1;
    }
  }
}

// ---------------------------------------------------------------------------
// past D = 256: a cluster of blocks over one (b*h, query tile)
// ---------------------------------------------------------------------------

constexpr int kWideWidth = 128;     // the widest slab of D a wide block owns (both wide kernels)
constexpr int kWideCluster = 8;     // blocks of a cluster at most: the portable maximum
constexpr int kWideThreads = 128;   // threads of a bf16 / fp16 wide block: 4 warps
constexpr int kLdS = kBlockK + 8;   // row of an fp32 score tile (partials, fp32 P)
constexpr int kLdP16 = kBlockK + 8; // row of a 2-byte P tile: conflict-free ldmatrix
static_assert(kMmaBlockQ == 64 && kBlockK == 64, "the wide tiles below");

// the rows of partials a block of a BQ-row query tile receives: n * ceil(BQ /
// n) at most over the cluster sizes, in whole 8-row groups
constexpr int recv_rows(int bq) {
  int rows = 0;
  for (int n = 2; n <= kWideCluster; ++n) {
    const int r = n * ((bq + n - 1) / n);
    rows = r > rows ? r : rows;
  }
  return (rows + 7) / 8 * 8;
}

// The slabs of a wide launch: n blocks a cluster (grid.z = n * groups), D
// cut into n * groups slabs of whole 8-column units spread evenly (the
// first units % slabs slabs take one more), the last ending at D, as
// ops/flash_attention.py's wide_plan cuts it. Block `rank` of cluster group
// g owns output slab g * n + rank, and computes the QK^T partial over slabs
// j * n + rank (j < groups, its "chunks"): every group sums the same
// partials in the same order.
struct WideSlabs {
  int dim, n, rank, base, rem;
  __device__ __forceinline__ WideSlabs(int dim_, int n_, int groups, int rank_)
      : dim(dim_), n(n_), rank(rank_) {
    const int units = (dim + 7) / 8;
    base = units / (n * groups);
    rem = units % (n * groups);
  }
  __device__ __forceinline__ int slab_col(int s) const {
    return min(dim, 8 * (s * base + min(s, rem)));
  }
  __device__ __forceinline__ int col(int j) const { return slab_col(j * n + rank); }
  __device__ __forceinline__ int width(int j) const {
    return slab_col(j * n + rank + 1) - slab_col(j * n + rank);
  }
};

// Rows [row0, row0 + ROWS) of `width` columns into a shared tile of
// kWideWidth columns (row stride LD), zero past `width` and past seq: with
// 16-byte copies a thread keeps one column of 16 bytes and walks the rows
// (an address add a copy); other widths take load_tile_async.
template <typename T, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(T* tile, const T* __restrict__ src, int row0, int seq,
                                          long long stride_s, int width, int vec) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = kWideWidth / kVec;  // 16-byte copies a row
  constexpr int kStep = THREADS / kPerRow;    // rows a pass
  static_assert(THREADS % kPerRow == 0 && ROWS % kStep == 0, "whole rows a pass");
  if (vec != 16) {
    load_tile_async<T, kWideWidth, LD, ROWS, THREADS>(tile, src, row0, seq, stride_s, width, vec);
    return;
  }
  const int c = (threadIdx.x % kPerRow) * kVec;
  const bool col_live = c < width;
  int r = threadIdx.x / kPerRow;
  const T* g = src + (long long)(row0 + r) * stride_s + c;
  T* d = tile + r * LD + c;
#pragma unroll 4
  for (; r < ROWS; r += kStep) {
    const bool live = col_live && row0 + r < seq;
    cp_async<16>(d, live ? g : src, live);
    g += kStep * stride_s;
    d += kStep * LD;
  }
}

// A block's shared memory for the cluster's exchange over a BQ-row query
// tile: the partial score rows it owns as every block of the cluster sent
// them (row r of the query tile is owned by block r % n, at row (src *
// ceil(BQ / n) + r / n) of `recv`), and two tiles each (alternating by key
// tile) of P and of each row's correction as the owners sent them; `l`
// takes each row's final sum.
template <typename PT, int BQ>
struct Exchange {
  static constexpr int kLd = sizeof(PT) == 2 ? kLdP16 : kLdS;
  static constexpr int kP = BQ * kLd;
  static constexpr size_t kRecvBytes = (size_t)recv_rows(BQ) * kLdS * sizeof(float);
  static constexpr size_t kPBytes = (size_t)2 * kP * sizeof(PT);
  unsigned char* base;
  static constexpr size_t bytes() { return kRecvBytes + kPBytes + 3 * BQ * sizeof(float); }
  // [recv_rows(BQ)][kLdS] fp32
  __device__ __forceinline__ float* recv() const { return reinterpret_cast<float*>(base); }
  // [2][BQ][kLd]
  __device__ __forceinline__ PT* p() const { return reinterpret_cast<PT*>(base + kRecvBytes); }
  // [2][BQ]
  __device__ __forceinline__ float* corr() const {
    return reinterpret_cast<float*>(base + kRecvBytes + kPBytes);
  }
  // [BQ]
  __device__ __forceinline__ float* l() const { return corr() + 2 * BQ; }
};

template <typename T>
__device__ __forceinline__ T* in_block(cg::cluster_group& cluster, T* p, int dst, int rank) {
  return dst == rank ? p : cluster.map_shared_rank(p, dst);
}

// The softmax of this block's rows of key tile `tile`, once every block's
// partial scores are in the owners' `recv` (after the cluster barrier):
// THREADS / 32 threads a row (up to 32 rows), row = lr * n + rank. The n
// partials are summed in rank order, scaled to log2 units and masked, the
// online softmax runs on them (m, l: this thread's row's; a row with no live
// key yet keeps p = 0 and a correction of 0), and P (rounded to PT: the
// input type for bf16 / fp16) and the row's correction go to every block of
// the cluster, into the tile's buffer (tile & 1). Returns whether this
// thread holds a row.
template <int THREADS, typename PT, int BQ>
__device__ __forceinline__ bool own_rows(cg::cluster_group& cluster, const Exchange<PT, BQ>& x,
                                         int n, int rank, int tile, int q0, int k0, int seq,
                                         int causal, float scale_log2, float& m, float& l) {
  constexpr int TPR = THREADS / 32;  // threads a row: 32 rows at most
  constexpr int KPT = kBlockK / TPR;  // keys a thread
  static_assert(TPR == 4 || TPR == 8, "the shuffles below");
  static_assert((BQ + 2) / 3 <= 32, "32 rows a block at most (n >= 3)");
  const int rows_per = (BQ + n - 1) / n;
  const int owned = (BQ - rank + n - 1) / n;  // rows r with r % n == rank
  const int lr_raw = threadIdx.x / TPR;
  const bool active = lr_raw < owned;
  const int lr = active ? lr_raw : 0;  // an idle thread computes on row 0 and stores nothing
  const int kq = (threadIdx.x % TPR) * KPT;
  const int row = lr * n + rank;
  float s[KPT];
  for (int r = 0; r < n; ++r) {
    const float* src = x.recv() + (r * rows_per + lr) * kLdS + kq;
#pragma unroll
    for (int f = 0; f < KPT; f += 4) {
      const float4 y = *reinterpret_cast<const float4*>(src + f);
      s[f] = r == 0 ? y.x : s[f] + y.x;
      s[f + 1] = r == 0 ? y.y : s[f + 1] + y.y;
      s[f + 2] = r == 0 ? y.z : s[f + 2] + y.z;
      s[f + 3] = r == 0 ? y.w : s[f + 3] + y.w;
    }
  }
  const bool masked = tile_needs_mask<kBlockK>(k0, q0, seq, causal);
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int key = k0 + kq + e;
    const bool live = !masked || (key < seq && (!causal || key <= q0 + row));
    s[e] = live ? s[e] * scale_log2 : -INFINITY;
    mx = fmaxf(mx, s[e]);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_new = fmaxf(m, mx);
  const float m_use = m_new == -INFINITY ? 0.f : m_new;
  const float corr = exp2f(m - m_use);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    s[e] = exp2f(s[e] - m_use);
    sum += s[e];
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  l = l * corr + sum;
  m = m_new;
  if (active) {
    // P as 16-byte words: 2-byte types rounded here (p.astype(v.dtype))
    constexpr int kWords = KPT * (int)sizeof(PT) / 16;
    uint4 w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (sizeof(PT) == 2) {
        w[i] = make_uint4(Mma<PT>::pack(s[8 * i], s[8 * i + 1]),
                          Mma<PT>::pack(s[8 * i + 2], s[8 * i + 3]),
                          Mma<PT>::pack(s[8 * i + 4], s[8 * i + 5]),
                          Mma<PT>::pack(s[8 * i + 6], s[8 * i + 7]));
      } else {
        w[i] = make_uint4(__float_as_uint(s[4 * i]), __float_as_uint(s[4 * i + 1]),
                          __float_as_uint(s[4 * i + 2]), __float_as_uint(s[4 * i + 3]));
      }
    }
    const int buf = tile & 1;
    for (int dst = 0; dst < n; ++dst) {
      uint4* gp = reinterpret_cast<uint4*>(in_block(cluster, x.p(), dst, rank) +
                                           buf * x.kP + row * x.kLd + kq);
#pragma unroll
      for (int i = 0; i < kWords; ++i) gp[i] = w[i];
      if (kq == 0) in_block(cluster, x.corr(), dst, rank)[buf * BQ + row] = corr;
    }
  }
  return active;
}

// Each row's final l from its owner into every block, then a full cluster
// barrier: after it no block stores into another, and every block can leave.
template <int THREADS>
__device__ __forceinline__ void share_l(cg::cluster_group& cluster, float* gl, bool owner, int n,
                                        int rank, float l) {
  constexpr int TPR = THREADS / 32;
  if (owner && threadIdx.x % TPR == 0) {
    const int row = (int)(threadIdx.x / TPR) * n + rank;
    for (int dst = 0; dst < n; ++dst) in_block(cluster, gl, dst, rank)[row] = l;
  }
  cluster.sync();
}

// The key-tile loop both wide kernels run, two cluster barriers a tile,
// ordered so that each barrier's stores land while the block computes and
// the fewest registers are live at each phase:
//   prologue: QK^T(0)
//   tile t:   partials(t) to their owners
//             PV(t - 1), then V(t) into the V buffer PV(t - 1) read
//             barrier (every partial of tile t is with its owner)
//             the owners' softmax of tile t, P(t) to every block
//             QK^T(t + 1) (its chunks' cp.async double-buffered)
//             barrier (P(t) and its corrections are in every block)
//   after:    PV(last)
// P and the corrections alternate between two buffers by tile; a block's
// receive tile is rewritten only after the second barrier of the tile
// before. The kernel supplies load_step(t, j, buf) (the chunks of (key tile
// t, chunk j) into buffer buf), qk(j, buf) (chunk j of QK^T into its score
// registers), store_partials(), own(t), pv(t) (O = O * corr + P V for tile
// t) and load_v(t).
template <typename LoadStep, typename Qk, typename Store, typename Own, typename Pv,
          typename LoadV>
__device__ __forceinline__ void wide_loop(int n_tiles, int groups, LoadStep load_step, Qk qk,
                                          Store store_partials, Own own, Pv pv, LoadV load_v) {
  int step = 0;  // (key tile, chunk) steps in order: step s reads buffers s & 1
  auto qk_tile = [&](int t) {
    for (int j = 0; j < groups; ++j, ++step) {
      const bool last = j + 1 == groups;
      if (!last || t + 1 < n_tiles) {
        load_step(last ? t + 1 : t, last ? 0 : j + 1, (step + 1) & 1);
      }
      cp_async_commit();  // (empty past the last step: the group count stays uniform)
      // this step's group: after it only the next step's and, for a tile's
      // first chunk past tile 0, the V group committed after it
      if (j == 0 && t > 0) {
        cp_async_wait<2>();
      } else {
        cp_async_wait<1>();
      }
      __syncthreads();
      qk(j, step & 1);
      __syncthreads();  // the buffers of this step are refilled by the next step's prefetch
    }
  };
  qk_tile(0);
  load_v(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    store_partials();
    if (t >= 1) {
      cp_async_wait<1>();  // V(t - 1): only the next tile's first chunk may be in flight
      __syncthreads();
      pv(t - 1);
      __syncthreads();  // the V buffer is free
      load_v(t);
    }
    cp_async_commit();
    cg::this_cluster().sync();  // every partial of tile t is with its owner
    own(t);
    if (t + 1 < n_tiles) qk_tile(t + 1);
    cg::this_cluster().sync();  // P(t) and its corrections are in every block
  }
  cp_async_wait<0>();
  __syncthreads();
  pv(n_tiles - 1);
}

// bf16 and fp16: 4 warps, 16 query rows each, mma.sync as the dense kernel
struct MmaWideSmem {
  static constexpr int kLd = kWideWidth + 8;  // 16 bytes of padding: conflict-free ldmatrix
  static constexpr int kTile = 64 * kLd;      // one Q, K or V tile of 2-byte values
  // K x 2, V, Q (two buffers where it is restaged), then the exchange
  __host__ __device__ static constexpr size_t tiles_bytes(int groups) {
    return (size_t)(3 + (groups > 1 ? 2 : 1)) * kTile * 2;
  }
  template <typename T>
  static constexpr size_t bytes(int groups) {
    return tiles_bytes(groups) + Exchange<T, kMmaBlockQ>::bytes();
  }
};

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
flash_attention_mma_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out, int seq, int heads,
                                int dim, long long stride_b, long long stride_s,
                                long long stride_h, float scale, int causal, int vec, int pairs,
                                int n, int groups) {
  using M = Mma<T>;
  using W = MmaWideSmem;
  constexpr int LD = W::kLd;
  constexpr int KSTEPS = kWideWidth / 16;  // k-steps of a whole chunk
  constexpr int NT = kBlockK / 8;          // 8-key n-tiles of S
  constexpr int DT = kWideWidth / 8;       // 8-column n-tiles of the O slab
  static_assert(kMmaThreads == kWideThreads, "");
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() != (unsigned)n) __trap();  // launched on another cluster than the plan's
  const int rank = (int)cluster.block_rank();
  const WideSlabs sl(dim, n, groups, rank);
  const int group = blockIdx.z / n;
  const bool resident = groups == 1;  // Q's one chunk stays in shared memory for the whole loop
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);  // two buffers
  T* sv = sk + 2 * W::kTile;
  T* sq = sv + W::kTile;               // one buffer, or two where restaged
  const Exchange<T, kMmaBlockQ> ex{smem + W::tiles_bytes(groups)};

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBlockQ;  // longest causal blocks first
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's fragment rows in the tile: r0 and r0 + 8
  const int r1 = r0 + 8;
  const float scale_log2 = scale * kLog2e;
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix A rows
  const int a_col = (lane >> 4) * 8;
  const int rows_per = (kMmaBlockQ + n - 1) / n;
  const int o0 = sl.col(group);  // this block's slab of O: chunk `group` of its share
  const int ow = sl.width(group);
  const int npairs = (ow + 15) / 16;

  const int k_end = causal ? min(seq, q0 + kMmaBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m = -INFINITY;  // the softmax state of the row this thread owns (own_rows)
  float l = 0.f;
  bool owner = false;
  float s[NT][4];

  auto load_step = [&](int t, int j, int buf) {
    if (!resident) {
      load_rows<T, LD, kMmaBlockQ, kWideThreads>(sq + buf * W::kTile, q + base + sl.col(j), q0,
                                                 seq, stride_s, sl.width(j), vec);
    }
    load_rows<T, LD, kBlockK, kWideThreads>(sk + buf * W::kTile, k + base + sl.col(j),
                                            t * kBlockK, seq, stride_s, sl.width(j), vec);
  };
  auto qk = [&](int j, int buf) {
    const T* qt = sq + (resident ? 0 : buf * W::kTile);
    const T* kt = sk + buf * W::kTile;
    if (j == 0) {
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[jj][c] = 0.f;
    }
    const int ksteps = (sl.width(j) + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4];
        ldmatrix_x4(a, qt + a_row * LD + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(b, kt + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
          M::mma(s[2 * np], a, b[0], b[1]);
          M::mma(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  };
  auto store_partials = [&]() {
    // this thread's partial rows to their owners' receive tiles
    float* d0 = in_block(cluster, ex.recv(), r0 % n, rank) + (rank * rows_per + r0 / n) * kLdS;
    float* d1 = in_block(cluster, ex.recv(), r1 % n, rank) + (rank * rows_per + r1 / n) * kLdS;
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      *reinterpret_cast<float2*>(d0 + jj * 8 + 2 * t4) = make_float2(s[jj][0], s[jj][1]);
      *reinterpret_cast<float2*>(d1 + jj * 8 + 2 * t4) = make_float2(s[jj][2], s[jj][3]);
    }
  };
  auto own = [&](int t) {
    owner = own_rows<kWideThreads, T>(cluster, ex, n, rank, t, q0, t * kBlockK, seq, causal,
                                      scale_log2, m, l);
  };
  auto pv = [&](int t) {
    // O slab = O slab * corr + P V slab, P by ldmatrix from the exchange
    const int buf = t & 1;
    const float c0 = ex.corr()[buf * kMmaBlockQ + r0];
    const float c1 = ex.corr()[buf * kMmaBlockQ + r1];
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) {
      o[jj][0] *= c0;
      o[jj][1] *= c0;
      o[jj][2] *= c1;
      o[jj][3] *= c1;
    }
    const T* pt = ex.p() + buf * ex.kP;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, pt + a_row * kLdP16 + kk * 16 + a_col);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        if (dp < npairs) {
          uint32_t b[4];
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(b, sv + key * LD + dp * 16 + (lane >> 4) * 8);
          M::mma(o[2 * dp], pa, b[0], b[1]);
          M::mma(o[2 * dp + 1], pa, b[2], b[3]);
        }
      }
    }
  };
  auto load_v = [&](int t) {
    load_rows<T, LD, kBlockK, kWideThreads>(sv, v + base + o0, t * kBlockK, seq, stride_s, ow,
                                            vec);
  };

  // the first step's chunks: Q (for the whole loop where it stays resident) and K
  if (resident) {
    load_rows<T, LD, kMmaBlockQ, kWideThreads>(sq, q + base + sl.col(0), q0, seq, stride_s,
                                               sl.width(0), vec);
  }
  load_step(0, 0, 0);
  cp_async_commit();
  wide_loop(n_tiles, groups, load_step, qk, store_partials, own, pv, load_v);
  share_l<kWideThreads>(cluster, ex.l(), owner, n, rank, l);

  const float den0 = fmaxf(ex.l()[r0], 1e-30f);
  const float den1 = fmaxf(ex.l()[r1], 1e-30f);
  const int row0 = q0 + r0;
  const int row1 = q0 + r1;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t4;  // within the slab
    if (col >= ow) continue;
    T* dst0 = out + base + (long long)row0 * stride_s + o0 + col;
    T* dst1 = out + base + (long long)row1 * stride_s + o0 + col;
    if (pairs) {
      if (row0 < seq) M::store2(dst0, o[j][0] / den0, o[j][1] / den0);
      if (row1 < seq) M::store2(dst1, o[j][2] / den1, o[j][3] / den1);
    } else {
      const bool second = col + 1 < ow;
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

// fp32: 8 warps, register tiles on the CUDA cores, query tiles of BQ rows:
// 80 where Q stays resident (one cluster group), so that the served (1, 1024,
// 4, 512) makes 52 clusters of 4, two waves of the 30 the card holds at one
// block an SM (64-row tiles make 64: three waves); 64 where Q is restaged
// (its second buffer leaves no room for 80)
constexpr int kF32WideThreads = 256;
constexpr int kF32WideBlockQ = 80;

template <int BQ>
struct F32WideSmem {
  static constexpr int kLd = kWideWidth + 4;  // float4 rows: conflict-free reads
  static constexpr int kTileQ = BQ * kLd;     // the Q tile
  static constexpr int kTile = kBlockK * kLd;  // one K or V tile (64 rows)
  // K x 2, V, Q (two buffers where it is restaged), then the exchange
  __host__ __device__ static constexpr size_t tiles_bytes(int groups) {
    return ((size_t)3 * kTile + (size_t)(groups > 1 ? 2 : 1) * kTileQ) * sizeof(float);
  }
  static constexpr size_t bytes(int groups) {
    return tiles_bytes(groups) + Exchange<float, BQ>::bytes();
  }
};

template <int BQ>
__global__ void __launch_bounds__(kF32WideThreads, 1)
flash_attention_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out, int seq,
                                int heads, int dim, long long stride_b, long long stride_s,
                                long long stride_h, float scale, int causal, int vec, int,
                                int n, int groups) {
  using S = F32WideSmem<BQ>;
  constexpr int LD = S::kLd;
  constexpr int TH = kF32WideThreads;
  constexpr int RT = BQ / 16;  // query rows a thread
  static_assert(BQ % 16 == 0 && BQ % (TH / 32) == 0, "the thread grid below");
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() != (unsigned)n) __trap();  // launched on another cluster than the plan's
  const int rank = (int)cluster.block_rank();
  const WideSlabs sl(dim, n, groups, rank);
  const int group = blockIdx.z / n;
  const bool resident = groups == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);  // two buffers
  float* sv = sk + 2 * S::kTile;
  float* sq = sv + S::kTile;                   // one buffer, or two where restaged
  const Exchange<float, BQ> ex{smem + S::tiles_bytes(groups)};

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal blocks first
  const long long base = (long long)(bh / heads) * stride_b + (long long)(bh % heads) * stride_h;
  // thread (ty, tx) of a 16 x 16 grid owns the rows ty + 16i (i < RT); of S
  // the keys tx + 16j (j < 4), of O the columns 4 tx + c and 64 + 4 tx + c
  // (c < 4)
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const float scale_log2 = scale * kLog2e;
  const int rows_per = (BQ + n - 1) / n;
  const int o0 = sl.col(group);
  const int ow = sl.width(group);

  const int k_end = causal ? min(seq, q0 + BQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  float m = -INFINITY;  // the softmax state of the row this thread owns (own_rows)
  float l = 0.f;
  bool owner = false;
  float s[RT][4];

  auto load_step = [&](int t, int j, int buf) {
    if (!resident) {
      load_rows<float, LD, BQ, TH>(sq + buf * S::kTileQ, q + base + sl.col(j), q0, seq, stride_s,
                                   sl.width(j), vec);
    }
    load_rows<float, LD, kBlockK, TH>(sk + buf * S::kTile, k + base + sl.col(j), t * kBlockK,
                                      seq, stride_s, sl.width(j), vec);
  };
  auto qk = [&](int j, int buf) {
    // RT rows x 4 keys a thread, float4 along d (the columns past the
    // chunk's width are zero): 4 RT FMAs a 16-byte load of RT + 4
    const float* qt = sq + (resident ? 0 : buf * S::kTileQ);
    const float* kt = sk + buf * S::kTile;
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    }
    const int d_end = (sl.width(j) + 3) & ~3;
#pragma unroll 4
    for (int d = 0; d < d_end; d += 4) {
      float4 a[RT], b[4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        a[i] = *reinterpret_cast<const float4*>(qt + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(kt + (tx + 16 * jj) * LD + d);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x = fmaf(a[i].x, b[jj].x, s[i][jj]);
          x = fmaf(a[i].y, b[jj].y, x);
          x = fmaf(a[i].z, b[jj].z, x);
          s[i][jj] = fmaf(a[i].w, b[jj].w, x);
        }
      }
    }
  };
  auto store_partials = [&]() {
    // row ty + 16i goes to block (ty + 16i) % n, at row rank * rows_per + (ty + 16i) / n
    int dst = ty % n;
    int lr = ty / n;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* d = in_block(cluster, ex.recv(), dst, rank) + (rank * rows_per + lr) * kLdS;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) d[tx + 16 * jj] = s[i][jj];
      dst += 16;
      while (dst >= n) {
        dst -= n;
        ++lr;
      }
    }
  };
  auto own = [&](int t) {
    owner = own_rows<TH, float, BQ>(cluster, ex, n, rank, t, q0, t * kBlockK, seq, causal,
                                    scale_log2, m, l);
  };
  auto pv = [&](int t) {
    // O slab = O slab * corr + P V slab: RT rows x 8 columns a thread, 8 RT
    // FMAs a 16-byte load of RT + 8 (the columns past the slab's width are
    // zero in V)
    const int buf = t & 1;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float c = ex.corr()[buf * BQ + ty + 16 * i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= c;
    }
    const float* pt = ex.p() + buf * ex.kP;
    const float* vcol = sv + 4 * tx;
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        p[i] = *reinterpret_cast<const float4*>(pt + (ty + 16 * i) * kLdS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v0 = *reinterpret_cast<const float4*>(vcol + (kk + e) * LD);
        const float4 v1 = *reinterpret_cast<const float4*>(vcol + (kk + e) * LD + 64);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
          acc[i][0] = fmaf(pe, v0.x, acc[i][0]);
          acc[i][1] = fmaf(pe, v0.y, acc[i][1]);
          acc[i][2] = fmaf(pe, v0.z, acc[i][2]);
          acc[i][3] = fmaf(pe, v0.w, acc[i][3]);
          acc[i][4] = fmaf(pe, v1.x, acc[i][4]);
          acc[i][5] = fmaf(pe, v1.y, acc[i][5]);
          acc[i][6] = fmaf(pe, v1.z, acc[i][6]);
          acc[i][7] = fmaf(pe, v1.w, acc[i][7]);
        }
      }
    }
  };
  auto load_v = [&](int t) {
    load_rows<float, LD, kBlockK, TH>(sv, v + base + o0, t * kBlockK, seq, stride_s, ow, vec);
  };

  if (resident) {
    load_rows<float, LD, BQ, TH>(sq, q + base + sl.col(0), q0, seq, stride_s, sl.width(0), vec);
  }
  load_step(0, 0, 0);
  cp_async_commit();
  wide_loop(n_tiles, groups, load_step, qk, store_partials, own, pv, load_v);
  share_l<TH>(cluster, ex.l(), owner, n, rank, l);

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= seq) continue;
    const float den = fmaxf(ex.l()[r], 1e-30f);
    float* dst = out + base + (long long)(q0 + r) * stride_s + o0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = 4 * tx + 64 * (e >> 2) + (e & 3);
      if (col < ow) dst[col] = acc[i][e] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// integer and bool: JAX's key tiles in order, every dtype by its element code
// ---------------------------------------------------------------------------

constexpr int kSlab = 256;                   // output columns of a tiled block
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
  int cluster, groups;  // the wide kernels' plan (D > 256): blocks a cluster, cluster groups
  cudaStream_t stream;
};

// grid (b*h, query tiles): the dense kernels
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
      static_cast<T*>(a.out), a.seq, a.heads, a.dim, a.stride_b, a.stride_s, a.stride_h,
      a.scale, a.causal, a.vec, a.pairs);
  return cudaGetLastError();
}

// the clusters the card can hold at once for a wide launch, asked of
// cudaOccupancyMaxActiveClusters at the first launch of each (device,
// kernel: bf16, fp16, fp32 at 80 or 64 query rows; cluster size; Q
// buffers) and kept (stored + 1: 0 = not asked yet)
constexpr int kDevices = 16;
std::atomic<int> g_active[kDevices][4][kWideCluster + 1][2];
// the last wide launch's cluster size, groups and active clusters, read by
// flash_attention_last_wide_launch
std::atomic<int> g_last_wide[3];

// grid (b*h, query tiles, n * groups) in clusters of (1, 1, n): the wide
// kernels, on the plan wide_plan makes (ops/flash_attention.py). A plan
// whose slabs do not cover dim in whole units of at most kWideWidth columns
// is refused, and so is a cluster the card cannot schedule (no fallback).
template <typename T, typename Kernel>
cudaError_t launch_wide(Kernel kernel, int kind, size_t smem, int threads, int block_q,
                        const Args& a) {
  const int n = a.cluster;
  const long long slabs = (long long)n * a.groups;
  const long long units = (a.dim + 7) / 8;
  const long long bh = (long long)a.batch * a.heads;
  const int q_tiles = (a.seq + block_q - 1) / block_q;
  // (n >= 3: every plan past D = 256 has three slabs or more a group, and an
  // owner's rows, ceil(block_q / n), must fit its threads)
  if (n < 3 || n > kWideCluster || a.groups < 1 || slabs > units ||
      units > slabs * (kWideWidth / 8) || slabs > 65535 || bh > INT_MAX || q_tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bh, (unsigned)q_tiles, (unsigned)slabs);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int restaged = a.groups > 1 ? 1 : 0;
  int active = device < kDevices ? g_active[device][kind][n][restaged].load() - 1 : -1;
  if (active < 0) {
    err = cudaOccupancyMaxActiveClusters(&active, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (device < kDevices) g_active[device][kind][n][restaged].store(active + 1);
  }
  if (active < 1) return cudaErrorInvalidConfiguration;  // no cluster of n fits an SM group
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                           static_cast<const T*>(a.v), static_cast<T*>(a.out), a.seq, a.heads,
                           a.dim, a.stride_b, a.stride_s, a.stride_h, a.scale, a.causal, a.vec,
                           a.pairs, n, a.groups);
  if (err != cudaSuccess) return err;
  g_last_wide[0].store(n);
  g_last_wide[1].store(a.groups);
  g_last_wide[2].store(active);
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
  return full_rows<DP>(a) ? launch<float>(flash_attention_f32_tc_kernel<DP, true>,
                                          Tf32Plan<DP>::kBytes, Tf32Plan<DP>::kThreads, kBlockQ, a)
                          : launch<float>(flash_attention_f32_tc_kernel<DP, false>,
                                          Tf32Plan<DP>::kBytes, Tf32Plan<DP>::kThreads, kBlockQ, a);
}

// slabs of kSlab output columns a tiled kernel's grid holds
int slabs(int dim) { return (dim + kSlab - 1) / kSlab; }

// the cluster groups of the default plan: ceil(dim / (kWideCluster *
// kWideWidth)), as wide_plan gives them
int wide_groups(int dim) {
  return (dim + kWideCluster * kWideWidth - 1) / (kWideCluster * kWideWidth);
}

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
      return launch_wide<T>(flash_attention_mma_wide_kernel<T>,
                            std::is_same<T, half>::value ? 1 : 0,
                            MmaWideSmem::bytes<T>(a.groups), kWideThreads, kMmaBlockQ, a);
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
      return a.groups == 1
                 ? launch_wide<float>(flash_attention_f32_wide_kernel<kF32WideBlockQ>, 2,
                                      F32WideSmem<kF32WideBlockQ>::bytes(1), kF32WideThreads,
                                      kF32WideBlockQ, a)
                 : launch_wide<float>(flash_attention_f32_wide_kernel<kBlockQ>, 3,
                                      F32WideSmem<kBlockQ>::bytes(a.groups), kF32WideThreads,
                                      kBlockQ, a);
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
      default: return (int)MmaWideSmem::bytes<bf16>(wide_groups(dim));
    }
  } else if (dtype == 0) {
    switch (dp) {
      case 16: return (int)SmallF32<16>::kBytes;
      case 32: return (int)SmallF32<32>::kBytes;
      case 64: return (int)Tf32Plan<64>::kBytes;
      case 96: return (int)Tf32Plan<96>::kBytes;
      case 128: return (int)Tf32Plan<128>::kBytes;
      case 256: return (int)Tf32Plan<256>::kBytes;
      default:
        return wide_groups(dim) == 1 ? (int)F32WideSmem<kF32WideBlockQ>::bytes(1)
                                     : (int)F32WideSmem<kBlockQ>::bytes(wide_groups(dim));
    }
  }
  return 0;
}

// q, k, v and out share the [B,S,H,D] shape and the element strides
// (stride_b, stride_s, stride_h; the last dimension is contiguous), any D
// >= 1. dtype: 0 = float32, 1 = bfloat16, 2 = float16. cluster and groups
// are the wide kernels' plan (wide_plan in ops/flash_attention.py: blocks a
// cluster, cluster groups) for D > 256; below they are not read. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int seq, int heads, int dim,
                                      long long stride_b, long long stride_s,
                                      long long stride_h, int dtype, float scale, int causal,
                                      int cluster, int groups, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, out, batch, seq, heads, dim, stride_b, stride_s, stride_h, scale, causal,
         0, 0, cluster, groups, static_cast<cudaStream_t>(stream)};
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

// The last wide launch of this process (any thread): its cluster size,
// cluster groups and the clusters the card holds at once for it
// (cudaOccupancyMaxActiveClusters). Returns 0, or 1 before any wide launch.
extern "C" int flash_attention_last_wide_launch(int* cluster, int* groups, int* active) {
  *cluster = g_last_wide[0].load();
  *groups = g_last_wide[1].load();
  *active = g_last_wide[2].load();
  return *cluster > 0 ? 0 : 1;
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
