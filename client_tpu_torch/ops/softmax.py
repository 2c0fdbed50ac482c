"""Row softmax with float32 output: ``softmax_probabilities``.

Replaces the Pallas TPU kernel of ``client_tpu/ops/__init__.py``
(``_softmax_kernel`` behind ``softmax_probabilities``) with a CUDA C++
kernel for Hopper, ``client_tpu_torch/csrc/softmax.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

``softmax_probabilities(logits)``: softmax over the last axis, computed in
float32 (max-subtract, exp, normalise) and returned as float32. The kernel,
and on the CPU the plain version, take logits of every dtype of
``ops.PLAIN_DTYPES``, as the JAX kernel does (it casts the logits to
float32 first; a bool is 0 or 1). Leading axes are rows; 1-D logits are one row
and come back 1-D, as in JAX.

Bound on the H100: bytes (each logit read once, each probability written
once). The kernel reads a row once where it can: :func:`softmax_plan`
picks, from the shapes alone, whether a row is held in registers (up to
``REGISTER_COLS`` columns, 16-byte loads), walked in two passes (longer
rows) or read element by element (rows that are not 16-byte aligned), and
how many warps share a row: one when the rows fill the card, up to a
block of 8 when they are few. The wrapper launches the kernel for CUDA
tensors on the current stream and raises if the launch fails; for CPU
tensors it computes ``softmax_probabilities_reference``, the plain version
beside it. There is no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LaunchCounter, _kernels, check_plain_dtype

# softmax_launch(x, out, rows, cols, dtype_code, variant, warps, vectors,
#                blocks, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)

# the kernel's variants (their codes in the source), block size (kThreads),
# the 16-byte vectors a thread may hold (the instantiated V) and the fp32
# values it holds at most (8 float4, 4 vectors of 8 bf16, or 2 of 16 uint8:
# 0 spills)
VARIANTS = ("registers", "two_pass", "scalar")
THREADS = 256
WARPS_PER_BLOCK = THREADS // 32
VECTORS = (1, 2, 4, 8)
MAX_VALUES = 32
# the widest row held in registers, in either dtype: 256 threads x 32 values
REGISTER_COLS = THREADS * MAX_VALUES
# the rows fill the card when they give each SM this many warps; a grid
# holds at most MAX_BLOCKS_PER_SM blocks per SM (the rest walk grid-stride)
WARPS_PER_SM = 8
MAX_BLOCKS_PER_SM = 32

# kernel launches made by softmax_probabilities (CPU calls do not count)
LAUNCHES = LaunchCounter()


class SoftmaxPlan(NamedTuple):
    variant: str  # one of VARIANTS
    warps: int  # warps that share a row: 1, 2, 4 or 8
    vectors: int  # 16-byte vectors a thread holds (registers; else 1)
    blocks: int  # blocks of THREADS threads, WARPS_PER_BLOCK // warps rows each


# a pure function of its arguments, called on every launch: cached, so a
# call at a shape seen before costs a lookup (a few microseconds less of host
# time per call)
@functools.lru_cache(maxsize=256)
def softmax_plan(rows: int, cols: int, dtype, aligned: bool,
                 sms: int = _kernels.H100_SMS) -> SoftmaxPlan:
    """How the kernel takes ``rows`` rows of ``cols`` logits of ``dtype``
    (``aligned``: input and output start on 16 bytes), from the shapes
    alone:

    - the variant: "registers" when the rows are 16-byte aligned (the base
      addresses and ``cols`` times the element size) and a block's
      registers hold a row (``cols <= REGISTER_COLS``), "two_pass" when
      they are aligned and longer, "scalar" when they are not aligned;
    - the warps per row: the fewest (1, 2, 4, 8) that give the card
      ``WARPS_PER_SM`` warps per SM, no more than the row has vectors (or
      elements) for 32 threads each, and enough for the registers to hold
      the row;
    - the vectors a thread holds: the fewest of ``VECTORS`` that cover the
      row."""
    if min(rows, cols, sms) < 1:
        raise ValueError(f"softmax_plan needs rows, cols and sms >= 1, got {rows}, {cols}, {sms}")
    elements = 16 // dtype.itemsize
    if aligned and cols % elements == 0:
        units = cols // elements
        variant = "registers" if cols <= REGISTER_COLS else "two_pass"
    else:
        units, variant = cols, "scalar"
    warps = 1
    while warps < WARPS_PER_BLOCK and 32 * warps < units and rows * warps < WARPS_PER_SM * sms:
        warps *= 2
    vectors = 1
    if variant == "registers":
        max_vectors = MAX_VALUES // elements
        while 32 * warps * max_vectors < units:
            warps *= 2
        vectors = next(v for v in VECTORS if 32 * warps * v >= units)
    per_block = WARPS_PER_BLOCK // warps
    return SoftmaxPlan(variant, warps, vectors, min(-(-rows // per_block), MAX_BLOCKS_PER_SM * sms))


def softmax_probabilities_reference(logits):
    """Plain version, as ``_softmax_kernel`` spells it: fp32 max, exp of the
    difference, divided by its sum."""
    x = logits.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def softmax_probabilities(logits):
    """Numerically stable softmax over the last axis, float32 out. CUDA
    tensors run the Hopper kernel; CPU tensors the plain version."""
    if logits.dim() == 0 or logits.shape[-1] == 0:
        raise ValueError(
            f"softmax_probabilities needs a non-empty last axis, got {list(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("softmax_probabilities takes a contiguous tensor")
    if logits.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"softmax_probabilities runs on cuda or cpu tensors, not {logits.device.type}")
    check_plain_dtype("softmax_probabilities", logits.dtype)
    if not logits.is_cuda:
        return softmax_probabilities_reference(logits)
    out = torch.empty_like(logits, dtype=torch.float32)
    cols = logits.shape[-1]
    rows = logits.numel() // cols
    if rows == 0:
        return out
    src, dst = logits.data_ptr(), out.data_ptr()
    plan = softmax_plan(rows, cols, logits.dtype, (src | dst) % 16 == 0,
                        _kernels.sm_count(logits.get_device()))
    _kernels.launch(_kernels.function("softmax", "softmax_launch", _ARGTYPES), LAUNCHES, logits,
                    src, dst, rows, cols, _kernels.ELEMENT_CODES[logits.dtype],
                    VARIANTS.index(plan.variant), plan.warps,
                    plan.vectors, plan.blocks)
    return out
