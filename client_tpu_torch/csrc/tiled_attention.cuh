// Shared by the tiled attention kernels (decode_attention.cu's
// decode_attention_tiled_kernel, flash_attention.cu's
// flash_attention_tiled_kernel): the elements of q, k, v and out read and
// written by a run-time element code, so one instantiation serves every
// dtype of ops.PLAIN_DTYPES; the probabilities rounded to v's dtype; one
// score by a warp.
//
// These kernels follow the Pallas kernels' key tiles (min(block_k, M or S)
// keys, walked in order), where the result depends on them: rounding
// p = exp(s - m) to an integer dtype truncates it to 1 at the tile's
// running maximum and 0 elsewhere (bool: p != 0). So the arithmetic is
// the tiled plain versions' (ops/decode_attention.py:
// decode_attention_tiled_reference, ops/flash_attention.py:
// flash_attention_tiled_reference), one rounding an operation: the score
// is fl(dot * scale) and the exponent fl(s - m) with __fmul_rn and
// __fsub_rn (no FMA contraction, which nvcc would otherwise make, as XLA's
// CPU does: tests/test_torch_flash_attention.py, integer_flash_explained),
// l and acc are fl(fl(x * corr) + y), exp is expf (not __expf), the divide
// is IEEE. Integer dots are exact in fp32 while |dot| < 2^24, so their
// order does not matter; the sum of p over a tile (l) is taken in another
// order than PyTorch's, which may move l by an ulp.

#pragma once

#include "elementwise.cuh"

namespace tiled {

// element i of `base` as fp32, by the codes of ELEMENT_CODES in
// ops/_kernels.py (dispatch_input in elementwise.cuh): 0 fp32, 1 bf16,
// 2 fp16, 3 uint8, 4 int8, 5 int16, 6 int32, 7 bool (read as its byte)
__device__ __forceinline__ float load_f32(const void* base, long long i, int code) {
  using elementwise::to_f32;
  switch (code) {
    case 0: return static_cast<const float*>(base)[i];
    case 1: return to_f32(static_cast<const __nv_bfloat16*>(base)[i]);
    case 2: return to_f32(static_cast<const __half*>(base)[i]);
    case 4: return to_f32(static_cast<const int8_t*>(base)[i]);
    case 5: return to_f32(static_cast<const int16_t*>(base)[i]);
    case 6: return to_f32(static_cast<const int32_t*>(base)[i]);
    default: return to_f32(static_cast<const uint8_t*>(base)[i]);  // 3, 7
  }
}

// x written to element i of `base` in the dtype of `code`: floats rounded
// to nearest even, integers truncated (PyTorch's and XLA's cast), bool
// x != 0
__device__ __forceinline__ void store_f32(void* base, long long i, float x, int code) {
  switch (code) {
    case 0: static_cast<float*>(base)[i] = x; break;
    case 1: static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x); break;
    case 2: static_cast<__half*>(base)[i] = __float2half_rn(x); break;
    case 3: static_cast<uint8_t*>(base)[i] = static_cast<uint8_t>(x); break;
    case 4: static_cast<int8_t*>(base)[i] = static_cast<int8_t>(x); break;
    case 5: static_cast<int16_t*>(base)[i] = static_cast<int16_t>(x); break;
    case 6: static_cast<int32_t*>(base)[i] = static_cast<int32_t>(x); break;
    default: static_cast<uint8_t*>(base)[i] = x != 0.f ? 1 : 0;  // 7
  }
}

// p (in [0, 1]) rounded to v's dtype and back, as p.astype(v.dtype) in
// the Pallas kernels
__device__ __forceinline__ float round_p(float p, int code) {
  switch (code) {
    case 0: return p;
    case 1: return __bfloat162float(__float2bfloat16_rn(p));
    case 2: return __half2float(__float2half_rn(p));
    case 7: return p != 0.f ? 1.f : 0.f;
    default: return truncf(p);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return __shfl_sync(0xffffffffu, x, 0);  // lane 0's: every lane holds the same bits
}

// fl(q_row . k_row * scale) by one warp: lane d, d + 32, ... of the
// rows of `dim` elements at element offsets q_off and k_off, the same
// value in every lane
__device__ __forceinline__ float warp_score(const void* q, long long q_off, const void* k,
                                            long long k_off, int dim, int code, float scale) {
  float dot = 0.f;
  for (int d = threadIdx.x & 31; d < dim; d += 32)
    dot = fmaf(load_f32(q, q_off + d, code), load_f32(k, k_off + d, code), dot);
  return __fmul_rn(warp_sum(dot), scale);
}

}  // namespace tiled
