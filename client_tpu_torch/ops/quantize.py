"""Symmetric int8 wire quantization: ``quantize_int8`` / ``dequantize_int8``.

Replaces the Pallas TPU kernels of ``client_tpu/ops/__init__.py``
(``_quantize_kernel`` and ``_dequantize_kernel``) with one CUDA C++ source
for Hopper, ``client_tpu_torch/csrc/quantize_int8.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

- ``quantize_int8(x, scale)``: ``clip(round(f32(x) * f32(1/scale)), -127,
  127)`` as int8. The inverse scale is computed in double precision and
  rounded to float32, as JAX folds ``1.0 / scale`` in Python; rounding is
  half to even.
- ``dequantize_int8(q, scale, out_dtype)``: ``f32(q) * f32(scale)`` cast to
  float32, bfloat16 or float16.

The kernels, and on the CPU the plain versions, take ``x`` and ``q`` of
every dtype of ``ops.PLAIN_DTYPES``, as the JAX kernels do (``f32(x)`` of a
bool is 0 or 1). Bound on the H100: bytes (each element read once and
written once). Dequantize runs normalize_image's word loop (a lane per
16-byte word of the wider side: the output, from the wire's int8), with its
grid from :func:`dequantize_plan`; quantize narrows, a thread per 16 bytes
of input. Input or output that is not 16-byte aligned (a view such as
``x[1:]``) takes the kernels' scalar way. The wrappers launch the kernels
for CUDA tensors on the current stream and raise if a launch fails; for CPU
tensors they compute the plain versions beside them. There is no fallback
from the one to the other.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import LaunchCounter, _kernels, check_plain_dtype
from .normalize import NormalizePlan, normalize_plan

# dequantize's output dtypes
_OUT_CODES = _kernels.FLOAT_CODES
# quantize_int8_launch(x, q, n, dtype_code, inv_scale, stream) and
# dequantize_int8_launch(q, out, n, in_code, out_code, scale, blocks, stream);
# ctypes rounds the factor to float32 (to nearest, as np.float32 does)
_QUANTIZE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p)
_DEQUANTIZE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)

# kernel launches made by quantize_int8 / dequantize_int8 (CPU calls do not count)
QUANTIZE_LAUNCHES = LaunchCounter()
DEQUANTIZE_LAUNCHES = LaunchCounter()


def dequantize_plan(n: int, out_dtype, aligned: bool, sms: int = _kernels.H100_SMS,
                    in_dtype=torch.int8) -> NormalizePlan:
    """The dequantize kernel's grid for ``n`` elements of ``in_dtype``
    (int8 on the wire): normalize's word loop, so a thread per 16-byte word
    of the wider side (from int8: 4 elements for float32 out, 8 for
    bfloat16 and float16; one element when input or output is not 16-byte
    ``aligned``), at most ``normalize.BLOCKS_PER_SM`` blocks per SM."""
    return normalize_plan(n, in_dtype, out_dtype, aligned, sms)


def _f32(value: float) -> float:
    """``value`` rounded to float32 (returned as a Python float)."""
    return float(np.float32(value))


def _check_scale(scale) -> float:
    scale = float(scale)
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"scale must be a positive finite number, got {scale}")
    return scale


def quantize_int8_reference(x, scale: float):
    """Plain version: ``clip(round(f32(x) * f32(1/scale)), -127, 127)``."""
    inv = _f32(1.0 / scale)
    return torch.round(x.float() * inv).clamp(-127.0, 127.0).to(torch.int8)


def dequantize_int8_reference(q, scale: float, out_dtype=torch.float32):
    """Plain version: ``f32(q) * f32(scale)`` cast to ``out_dtype``."""
    return (q.float() * _f32(scale)).to(out_dtype)


def _check_tensor(t, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device.type}")


def quantize_int8(x, scale: float):
    """Symmetric int8 quantization ``round(x / scale)`` clipped to
    [-127, 127] (computed as ``x * f32(1/scale)``, as the JAX kernel does).
    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    scale = _check_scale(scale)
    _check_tensor(x, "quantize_int8")
    check_plain_dtype("quantize_int8", x.dtype)
    if not x.is_cuda:
        return quantize_int8_reference(x, scale)
    out = torch.empty_like(x, dtype=torch.int8)
    if x.numel() == 0:
        return out
    _kernels.launch(
        _kernels.function("quantize_int8", "quantize_int8_launch", _QUANTIZE_ARGTYPES),
        QUANTIZE_LAUNCHES, x, x.data_ptr(), out.data_ptr(), x.numel(),
        _kernels.ELEMENT_CODES[x.dtype], 1.0 / scale)
    return out


def dequantize_int8(q, scale: float, out_dtype=torch.float32):
    """Inverse of :func:`quantize_int8`: ``f32(q) * f32(scale)`` as
    ``out_dtype`` (float32, bfloat16 or float16). CUDA tensors run the
    Hopper kernel; CPU tensors the plain version."""
    code = _OUT_CODES.get(out_dtype)
    if code is None:
        raise TypeError(f"dequantize_int8 writes float32, bfloat16 or float16, not {out_dtype}")
    scale = _check_scale(scale)
    _check_tensor(q, "dequantize_int8")
    check_plain_dtype("dequantize_int8", q.dtype)
    if not q.is_cuda:
        return dequantize_int8_reference(q, scale, out_dtype)
    out = torch.empty_like(q, dtype=out_dtype)
    n = q.numel()
    if n == 0:
        return out
    src, dst = q.data_ptr(), out.data_ptr()
    plan = dequantize_plan(n, out_dtype, (src | dst) % 16 == 0,
                           _kernels.sm_count(q.get_device()), q.dtype)
    _kernels.launch(
        _kernels.function("quantize_int8", "dequantize_int8_launch", _DEQUANTIZE_ARGTYPES),
        DEQUANTIZE_LAUNCHES, q, src, dst, n, _kernels.ELEMENT_CODES[q.dtype], code, scale,
        plan.blocks)
    return out
