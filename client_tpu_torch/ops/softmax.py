"""Row softmax with float32 output: ``softmax_probabilities``.

Replaces the Pallas TPU kernel of ``client_tpu/ops/__init__.py``
(``_softmax_kernel`` behind ``softmax_probabilities``) with a CUDA C++
kernel for Hopper, ``client_tpu_torch/csrc/softmax.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

``softmax_probabilities(logits)``: softmax over the last axis of float32 or
bfloat16 logits, computed in float32 (max-subtract, exp, normalise) and
returned as float32. Leading axes are rows; 1-D logits are one row and come
back 1-D, as in JAX.

Bound on the H100: bytes (each logit read once, each probability written
once). The wrapper launches the kernel for CUDA tensors on the current
stream and raises if the launch fails; for CPU tensors it computes
``softmax_probabilities_reference``, the plain version beside it. There is
no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# softmax_launch(x, out, rows, cols, dtype_code, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p)

# kernel launches made by softmax_probabilities (CPU calls do not count)
LAUNCHES = LaunchCounter()


def softmax_probabilities_reference(logits):
    """Plain version, as ``_softmax_kernel`` spells it: fp32 max, exp of the
    difference, divided by its sum."""
    x = logits.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def softmax_probabilities(logits):
    """Numerically stable softmax over the last axis, float32 out. CUDA
    tensors run the Hopper kernel; CPU tensors the plain version."""
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"softmax_probabilities takes float32 or bfloat16, got {logits.dtype}")
    if logits.dim() == 0 or logits.shape[-1] == 0:
        raise ValueError(
            f"softmax_probabilities needs a non-empty last axis, got {list(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("softmax_probabilities takes a contiguous tensor")
    device = logits.device.type
    if device == "cpu":
        return softmax_probabilities_reference(logits)
    if device != "cuda":
        raise ValueError(f"softmax_probabilities runs on cuda or cpu tensors, not {device}")
    out = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    cols = logits.shape[-1]
    rows = logits.numel() // cols
    if rows == 0:
        return out
    fn = _kernels.function("softmax", "softmax_launch", _ARGTYPES)
    with _kernels.on_device(logits.device):
        err = fn(logits.data_ptr(), out.data_ptr(), rows, cols, _DTYPE_CODES[logits.dtype],
                 torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmax_probabilities kernel launch failed: cudaError_t {err}")
    LAUNCHES.add()
    return out
