"""Fused image normalisation: ``normalize_image``.

Replaces the Pallas TPU kernel of ``client_tpu/ops/__init__.py``
(``_normalize_kernel`` behind ``normalize_image``) with a CUDA C++ kernel
for Hopper, ``client_tpu_torch/csrc/normalize_image.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

``normalize_image(x, scale, shift, out_dtype)``: ``x * scale + shift`` cast
to ``out_dtype`` (float32 or bfloat16), for float32, bfloat16 or uint8 ``x``
of any shape. Each element is ``f32(x) * f32(scale) + f32(shift)`` rounded
ONCE to float32 (a fused multiply-add, as XLA computes the JAX kernel), then,
for bfloat16 output, rounded to nearest even. A separate multiply and add in
float32 would round twice and miss the JAX result by an ulp.

Bound on the H100: bytes (each element read once and written once). The
wrapper launches the kernel for CUDA tensors on the current stream and
raises if the launch fails; for CPU tensors it computes
``normalize_image_reference``, the plain version beside it. There is no
fallback from the one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LaunchCounter, _kernels

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# normalize_image_launch(x, out, n, in_code, out_code, scale, shift, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p)

# kernel launches made by normalize_image (CPU calls do not count)
LAUNCHES = LaunchCounter()


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
    if x.dtype not in _IN_CODES:
        raise TypeError(f"normalize_image takes float32, bfloat16 or uint8, got {x.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"normalize_image writes float32 or bfloat16, not {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("normalize_image takes a contiguous tensor")
    device = x.device.type
    if device == "cpu":
        return normalize_image_reference(x, scale, shift, out_dtype)
    if device != "cuda":
        raise ValueError(f"normalize_image runs on cuda or cpu tensors, not {device}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = _kernels.function("normalize_image", "normalize_image_launch", _ARGTYPES)
    with _kernels.on_device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), _IN_CODES[x.dtype],
                 _OUT_CODES[out_dtype], _f32(scale), _f32(shift),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalize_image kernel launch failed: cudaError_t {err}")
    LAUNCHES.add()
    return out
