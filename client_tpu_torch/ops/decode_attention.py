"""Single-query KV-cache attention (flash decoding): the decode hot op.

Replaces the Pallas TPU kernel ``client_tpu/ops/decode_attention.py``
(``_decode_kernel`` behind ``decode_attention``) with a CUDA C++ kernel for
Hopper, ``client_tpu_torch/csrc/decode_attention.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

One query vector per (sequence, head) attends over its static KV cache:
q [B,H,D], k/v [B,H,M,D], pos [B] int32 — cache slots ``<= pos[b]`` attend
(the decoder's position-based mask), softmax scale ``D**-0.5``, output
[B,H,D] in q's dtype. fp32 and bf16 inputs; fp32 accumulation; D in
{32, 64, 128}.

Bound on the H100: bytes. A step reads B*H*(pos+1)*D*2*itemsize bytes of
cache (plus q and the output), at the card's 3.35 TB/s; the arithmetic is
4 flops per cache element, far below the tensor cores' balance point. The
kernel reads only the live slots (its loop ends at ``pos[b]``, read on the
device), so its traffic is what the data needs, not the whole cache.

``decode_attention`` launches the kernel for CUDA tensors on the current
stream and raises if the launch fails; for CPU tensors it computes
``decode_attention_reference``, the plain PyTorch version beside it. There is
no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _kernels

SUPPORTED_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by decode_attention (CPU calls do not count)
LAUNCHES = LaunchCounter()


def decode_attention_reference(q, k, v, pos):
    """Dense fp32 plain version (the decoder's einsum path, batched)."""
    qf = q.float()
    kf = k.float()
    vf = v.float()
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhd,bhmd->bhm", qf, kf) * scale
    slots = torch.arange(k.shape[2], device=k.device)
    mask = slots[None, :] <= pos.to(slots.dtype)[:, None]  # [b, m]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhm,bhmd->bhd", p, vf).to(q.dtype)


def _check(q, k, v, pos) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k and v must share a dtype (got {q.dtype}, {k.dtype}, {v.dtype})")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(
            f"expected q [B,H,D] and k, v [B,H,M,D]; got q {list(q.shape)}, "
            f"k {list(k.shape)}")
    batch, heads, dim = q.shape
    if k.shape != v.shape or k.shape[:2] != (batch, heads) or k.shape[3] != dim:
        raise ValueError(
            f"k and v must be [{batch},{heads},M,{dim}]; got k {list(k.shape)}, "
            f"v {list(v.shape)}")
    if k.shape[2] < 1:
        raise ValueError("the KV cache must hold at least one slot")
    if pos.shape != (batch,):
        raise ValueError(f"pos must be [{batch}], got {list(pos.shape)}")
    if dim not in SUPPORTED_DIMS:
        raise ValueError(f"head dim {dim} not supported (one of {SUPPORTED_DIMS})")
    devices = {t.device for t in (q, k, v, pos)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and pos must share a device, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (q, k, v, pos)):
        raise ValueError("decode_attention takes contiguous tensors")


def _launch(q, k, v, pos) -> torch.Tensor:
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention needs 16-byte-aligned q, k and v")
    lib = _kernels.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    batch, heads, dim = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), batch, heads, k.shape[2], dim,
                 _DTYPE_CODES[q.dtype], dim ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES.add()
    return out


def decode_attention(q, k, v, pos):
    """One-step decode attention. q: [batch, heads, dim]; k, v:
    [batch, heads, max_len, dim]; pos: [batch] int32 — cache slots
    ``<= pos[b]`` attend. Returns [batch, heads, dim] in q's dtype.

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    _check(q, k, v, pos)
    device = q.device.type
    if device == "cuda":
        return _launch(q, k, v, pos)
    if device == "cpu":
        return decode_attention_reference(q, k, v, pos)
    raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {device}")
