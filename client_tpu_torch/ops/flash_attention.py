"""Blocked online-softmax attention (flash attention) over [B,S,H,D].

Replaces the Pallas TPU kernel ``client_tpu/ops/flash_attention.py``
(``_flash_kernel`` behind ``flash_attention``) with a CUDA C++ kernel for
Hopper, ``client_tpu_torch/csrc/flash_attention.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

q, k, v: [batch, seq, heads, dim], one dtype (float32 or bfloat16), dim in
{16, 32, 64, 128}, any seq >= 1; softmax scale ``dim**-0.5``; optional causal
mask; output in q's dtype. Scores and the output accumulate in fp32; with
bf16 inputs the probabilities are rounded to bf16 before the PV product, as
the Pallas kernel does. The kernel masks keys past the sequence itself, so a
ragged length is never padded in memory, and it reads the [B,S,H,D] layout
with strides (no transpose copies around it).

Bound on the H100: operations (4*B*H*S^2*D flops, about half when causal,
against 4*B*S*H*D elements moved). The kernel keeps the S x S scores out of
device memory, as the Pallas kernel keeps them out of HBM.

``flash_attention`` launches the kernel for CUDA tensors on the current
stream and raises if the launch fails; for CPU tensors it computes
``flash_attention_reference``, the dense plain version beside it. There is
no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _kernels

SUPPORTED_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by flash_attention (CPU calls do not count)
LAUNCHES = LaunchCounter()


def flash_attention_reference(q, k, v, causal: bool = False):
    """Dense fp32 attention over [B,S,H,D] (the counterpart of
    ``client_tpu.parallel.ring.full_attention``), in q's dtype. Any S: the
    dense form needs no padding."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        seq = q.shape[1]
        keep = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v, block_q, block_k) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k and v must share a dtype (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4:
        raise ValueError(f"expected q, k, v [B,S,H,D]; got q {list(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k and v must share a shape; got q {list(q.shape)}, k {list(k.shape)}, "
            f"v {list(v.shape)}")
    batch, seq, heads, dim = q.shape
    if min(batch, seq, heads) < 1:
        raise ValueError(f"batch, seq and heads must be >= 1, got {list(q.shape)}")
    if dim not in SUPPORTED_DIMS:
        raise ValueError(f"head dim {dim} not supported (one of {SUPPORTED_DIMS})")
    for name, block in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(block, int) or block < 1:
            raise ValueError(f"{name} must be a positive int, got {block!r}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v must share a device, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous tensors")


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention needs 16-byte-aligned q, k and v")
    lib = _kernels.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    batch, seq, heads, dim = q.shape
    out = torch.empty_like(q)
    stride_b, stride_s, stride_h, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 batch, seq, heads, dim, stride_b, stride_s, stride_h,
                 _DTYPE_CODES[q.dtype], dim ** -0.5, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES.add()
    return out


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128, block_k: int = 128):
    """Blocked attention. q, k, v: [batch, seq, heads, dim] -> the same
    shape, in q's dtype.

    ``block_q`` and ``block_k`` keep the JAX signature and are checked, but
    the result does not depend on them: the Hopper kernel tiles by 64 x 64
    (the TPU's block sizes follow its VMEM and its 128-wide MXU), and the
    plain version is dense. CUDA tensors run the Hopper kernel; CPU tensors
    the plain version."""
    _check(q, k, v, block_q, block_k)
    device = q.device.type
    if device == "cuda":
        return _launch(q, k, v, causal)
    if device == "cpu":
        return flash_attention_reference(q, k, v, causal)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {device}")
