"""Symmetric int8 wire quantization: ``quantize_int8`` / ``dequantize_int8``.

Replaces the Pallas TPU kernels of ``client_tpu/ops/__init__.py``
(``_quantize_kernel`` and ``_dequantize_kernel``) with one CUDA C++ source
for Hopper, ``client_tpu_torch/csrc/quantize_int8.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

- ``quantize_int8(x, scale)``: ``clip(round(f32(x) * f32(1/scale)), -127,
  127)`` as int8, for float32 or bfloat16 ``x``. The inverse scale is
  computed in double precision and rounded to float32, as JAX folds
  ``1.0 / scale`` in Python; rounding is half to even.
- ``dequantize_int8(q, scale, out_dtype)``: ``f32(q) * f32(scale)`` cast to
  float32 or bfloat16.

Bound on the H100: bytes (each element read once and written once). The
wrappers launch the kernels for CUDA tensors on the current stream and raise
if a launch fails; for CPU tensors they compute the plain versions beside
them. There is no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import LaunchCounter, _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by quantize_int8 / dequantize_int8 (CPU calls do not count)
QUANTIZE_LAUNCHES = LaunchCounter()
DEQUANTIZE_LAUNCHES = LaunchCounter()


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


def _launch(name: str, src, out, code: int, factor: float, counter: LaunchCounter):
    if src.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte-aligned input and output")
    fn = getattr(_kernels.load("quantize_int8"), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), out.data_ptr(), src.numel(), code, factor, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    counter.add()
    return out


def quantize_int8(x, scale: float):
    """Symmetric int8 quantization ``round(x / scale)`` clipped to
    [-127, 127] (computed as ``x * f32(1/scale)``, as the JAX kernel does).
    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize_int8 takes float32 or bfloat16, got {x.dtype}")
    scale = _check_scale(scale)
    _check_tensor(x, "quantize_int8")
    if x.device.type == "cpu":
        return quantize_int8_reference(x, scale)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    return _launch("quantize_int8", x, out, _DTYPE_CODES[x.dtype], _f32(1.0 / scale),
                   QUANTIZE_LAUNCHES)


def dequantize_int8(q, scale: float, out_dtype=torch.float32):
    """Inverse of :func:`quantize_int8`: ``f32(q) * f32(scale)`` as
    ``out_dtype`` (float32 or bfloat16). CUDA tensors run the Hopper kernel;
    CPU tensors the plain version."""
    if q.dtype != torch.int8:
        raise TypeError(f"dequantize_int8 takes int8, got {q.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"dequantize_int8 writes float32 or bfloat16, not {out_dtype}")
    scale = _check_scale(scale)
    _check_tensor(q, "dequantize_int8")
    if q.device.type == "cpu":
        return dequantize_int8_reference(q, scale, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if q.numel() == 0:
        return out
    return _launch("dequantize_int8", q, out, _DTYPE_CODES[out_dtype], _f32(scale),
                   DEQUANTIZE_LAUNCHES)
