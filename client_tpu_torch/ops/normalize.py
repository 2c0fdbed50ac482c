"""Fused image normalisation: ``normalize_image``.

Replaces the Pallas TPU kernel of ``client_tpu/ops/__init__.py``
(``_normalize_kernel`` behind ``normalize_image``) with a CUDA C++ kernel
for Hopper, ``client_tpu_torch/csrc/normalize_image.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

``normalize_image(x, scale, shift, out_dtype)``: ``x * scale + shift`` cast
to ``out_dtype`` (float32, bfloat16 or float16), for ``x`` of any shape. Each
element is ``f32(x) * f32(scale) + f32(shift)`` rounded ONCE to float32 (a
fused multiply-add, as XLA computes the JAX kernel), then, for bfloat16 or
float16 output, rounded to nearest even. A separate multiply and add in
float32 would round twice and miss the JAX result by an ulp. The kernel,
and on the CPU the plain version, take ``x`` of every dtype of
``ops.PLAIN_DTYPES`` (a bool is 0 or 1).

For integer, bool and float32 ``x`` this is the JAX result bit for bit. For
float16 and bfloat16 ``x`` JAX computes in the input's own type: it rounds
``scale`` and ``shift`` to it, and rounds its result to it before the cast
(in bfloat16 the product too). The port keeps the kernel's single rounding
in float32, in the kernel and in the plain version alike, so the two agree
within an ulp or two of the input type at the magnitude of ``x * scale``
and ``shift`` (the tests state the bound).

Bound on the H100: bytes (each element read once and written once). A
thread of the kernel takes ``16 / max(in size, out size)`` elements at a
time, so the wider side moves whole 16-byte words; :func:`normalize_plan`
sizes its grid from the element count and the card's SM count. The
wrapper launches the kernel for CUDA tensors on the current stream and
raises if the launch fails; for CPU tensors it computes
``normalize_image_reference``, the plain version beside it. There is no
fallback from the one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import LaunchCounter, _kernels, check_plain_dtype

_OUT_CODES = _kernels.FLOAT_CODES
# normalize_image_launch(x, out, n, in_code, out_code, scale, shift, blocks,
# stream); ctypes rounds scale and shift to float32 (to nearest, as
# np.float32 does)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)

# the kernel's block size (kThreads in the source), and the most blocks a
# grid has per SM (a thread per word up to 64 MiB of fp32 on the H100)
THREADS = 256
BLOCKS_PER_SM = 128

# kernel launches made by normalize_image (CPU calls do not count)
LAUNCHES = LaunchCounter()


class NormalizePlan(NamedTuple):
    elements: int  # elements a thread takes at a time (1: the scalar path)
    blocks: int  # blocks of THREADS threads


# a pure function of its arguments, called on every launch: cached, so a
# call at a shape seen before costs a lookup
@functools.lru_cache(maxsize=256)
def normalize_plan(n: int, in_dtype, out_dtype, aligned: bool,
                   sms: int = _kernels.H100_SMS) -> NormalizePlan:
    """The kernel's grid for ``n`` elements: one thread per
    ``16 / max(in size, out size)`` elements (one element when input or
    output is not 16-byte ``aligned``), as many blocks as that takes, at
    most ``BLOCKS_PER_SM`` per SM (the threads then walk the rest
    grid-stride)."""
    if min(n, sms) < 1:
        raise ValueError(f"normalize_plan needs n >= 1 and sms >= 1, got {n}, {sms}")
    elements = 16 // max(in_dtype.itemsize, out_dtype.itemsize) if aligned else 1
    work = -(-n // elements)
    return NormalizePlan(elements, min(-(-work // THREADS), BLOCKS_PER_SM * sms))


def _f32(value: float) -> float:
    """``value`` rounded to float32 (returned as a Python float)."""
    return float(np.float32(value))


def _fma_f32(x: torch.Tensor, scale: float, shift: float) -> torch.Tensor:
    """``x * scale + shift`` over float32 values, rounded once to float32.

    The product of two float32 numbers is exact in float64; the sum with
    ``shift`` is rounded to float64 with the exact remainder kept (Knuth's
    two-sum), and the float64 result is then rounded to odd (its last bit
    set when it was inexact, on the side of the remainder). Rounding that
    round-to-odd value to float32 is the single rounding of the exact value
    (53 bits >= 24 + 2), so no rare double rounding on a float32 midpoint."""
    p = x.double() * scale
    c = torch.tensor(shift, dtype=torch.float64, device=x.device)
    r = p + c
    back = r - p
    err = (p - (r - back)) + (c - back)
    bits = r.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(r)
    # the neighbour of r toward the exact value p + c: one ulp up in magnitude
    # when err has r's sign, one down otherwise
    step = torch.where((err > 0) == (r > 0), 1, -1)
    odd = torch.where(fix, bits + step, bits).view(torch.float64)
    return odd.float()


def normalize_image_reference(x, scale: float = 1.0, shift: float = 0.0,
                              out_dtype=torch.bfloat16):
    """Plain version: ``f32(x) * f32(scale) + f32(shift)`` rounded once to
    float32, then cast to ``out_dtype``."""
    return _fma_f32(x.float(), _f32(scale), _f32(shift)).to(out_dtype)


def normalize_image(x, scale: float = 1.0, shift: float = 0.0, out_dtype=torch.bfloat16):
    """Fused ``x * scale + shift`` cast to ``out_dtype``.

    image_client scaling modes map directly: INCEPTION => scale=2/255,
    shift=-1; NONE => scale=1, shift=0 (a pure cast). CUDA tensors run the
    Hopper kernel; CPU tensors the plain version."""
    out_code = _OUT_CODES.get(out_dtype)
    if out_code is None:
        raise TypeError(f"normalize_image writes float32, bfloat16 or float16, not {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("normalize_image takes a contiguous tensor")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"normalize_image runs on cuda or cpu tensors, not {x.device.type}")
    check_plain_dtype("normalize_image", x.dtype)
    if not x.is_cuda:
        return normalize_image_reference(x, scale, shift, out_dtype)
    out = torch.empty_like(x, dtype=out_dtype)
    n = x.numel()
    if n == 0:
        return out
    src, dst = x.data_ptr(), out.data_ptr()
    plan = normalize_plan(n, x.dtype, out_dtype, (src | dst) % 16 == 0,
                          _kernels.sm_count(x.get_device()))
    _kernels.launch(_kernels.function("normalize_image", "normalize_image_launch", _ARGTYPES),
                    LAUNCHES, x, src, dst, n, _kernels.ELEMENT_CODES[x.dtype], out_code, scale,
                    shift, plan.blocks)
    return out
