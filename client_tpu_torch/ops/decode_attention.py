"""Single-query KV-cache attention (flash decoding): the decode hot op.

Replaces the Pallas TPU kernel ``client_tpu/ops/decode_attention.py``
(``_decode_kernel`` behind ``decode_attention``) with a CUDA C++ kernel for
Hopper, ``client_tpu_torch/csrc/decode_attention.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

One query vector per (sequence, head) attends over its static KV cache:
q [B,H,D], k/v [B,H,M,D], pos [B] int32 — cache slots ``<= pos[b]`` attend
(the decoder's position-based mask), softmax scale ``D**-0.5``, output
[B,H,D] in q's dtype. The kernels take every dtype of ``ops.PLAIN_DTYPES``
and any D, as the JAX function does, and accumulate in fp32. fp32, bf16
and fp16 run the split-K kernel below, built for padded widths 16, 32, 64,
128, 256, 512 and 1024 (the real D read at run time) and, past 1024, for
slabs of 1024 output columns a block; q, k or v that are not 16-byte
aligned (views into larger tensors) are copied into fresh tensors, which
the allocator aligns, and the same kernel runs on the copies (served
callers pass fresh tensors, so the served path never copies). An integer
or bool cache runs the tiled kernel: JAX's tiles of ``min(block_k, M)``
slots in order, a block per (b, h) and slab of 1024 output columns,
elements read by their dtype's code. The plain versions take the same on
the CPU.

Bound on the H100: bytes. A step reads B*H*(pos+1)*D*2*itemsize bytes of
cache (plus q and the output), at the card's 3.35 TB/s; the arithmetic is
4 flops per cache element, far below the tensor cores' balance point. The
kernel reads only the live slots (its loop ends at ``pos[b]``, read on the
device), so its traffic is what the data needs, not the whole cache.

The kernel splits the cache axis across blocks (split-K) so that a small
B*H still fills the card: :func:`split_plan` picks the split count from the
shapes alone, split i covers the slots of :func:`split_bounds`, and a
second small kernel merges the splits' partial softmax states by
log-sum-exp. :func:`decode_attention_split_reference` is the plain form of
exactly that computation. One split (the decoder's served shape) is a
single launch with no scratch.

``decode_attention`` launches a kernel for CUDA tensors on the current
stream and raises if the launch fails; for CPU tensors it computes
``decode_attention_reference``, the plain PyTorch version beside it, or, for
an integer or bool cache, ``decode_attention_tiled_reference`` (the Pallas
kernel rounds the probabilities to the cache's dtype before the PV product,
which truncates them to 0 or 1 there, so its result depends on its tiles;
the tiled kernel's arithmetic is this function's). There is no fallback
from the one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _kernels, check_plain_dtype

# decode_attention_launch(q, k, v, pos, out, partial, batch, heads, max_len,
#                         dim, dtype, splits, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])
# decode_attention_tiled_launch(q, k, v, pos, out, batch, heads, max_len,
#                               dim, code, tile, scale, stream)
_TILED_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])

# split_plan: the H100's SM count, the blocks aimed at (about two per SM)
# and the fewest cache slots a split walks (shorter splits cost more in
# partials and merging than they add in bytes in flight)
H100_SMS = _kernels.H100_SMS
BLOCKS_PER_SM = 2
MIN_SPLIT = 256

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


def decode_attention_tiled_reference(q, k, v, pos, block_k: int = 128, out_dtype=None):
    """The Pallas kernel's loop in plain PyTorch: cache tiles of
    ``min(block_k, M)`` slots walked in order with a running (max, sum, acc)
    per (b, h) in fp32, scores in fp32, slots past ``pos[b]`` masked, the
    probabilities rounded to v's dtype before the PV product
    (``p.astype(v.dtype)`` in the Pallas kernel), a row with no live slot
    yet kept at p = 0 with a correction of 0, and the final divide by
    ``max(l, 1e-30)``. Returns q's dtype, or ``out_dtype`` where given
    (``torch.float32``: the quotient before the cast)."""
    batch, heads, dim = q.shape
    max_len = k.shape[2]
    block = min(block_k, max_len)
    vf = v.float()
    s_all = torch.einsum("bhd,bhmd->bhm", q.float(), k.float()) * dim ** -0.5
    slots = torch.arange(max_len, device=k.device)
    live = slots[None, :] <= pos.to(slots.dtype)[:, None]  # [b, m]
    s_all = s_all.masked_fill(~live[:, None, :], float("-inf"))
    m = torch.full((batch, heads), float("-inf"), device=q.device)
    l = torch.zeros((batch, heads), device=q.device)
    acc = torch.zeros((batch, heads, dim), device=q.device)
    for k0 in range(0, max_len, block):
        s = s_all[:, :, k0:k0 + block]
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - m_use[..., None])
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhm,bhmd->bhd", p.to(v.dtype).float(), vf[:, :, k0:k0 + block])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(out_dtype or q.dtype)


def split_plan(batch: int, heads: int, max_len: int, sms: int = H100_SMS) -> int:
    """How many splits of the cache axis the kernel runs, from the shapes
    alone (``pos`` stays on the device): enough (b, h, split) blocks to give
    ``sms`` SMs about ``BLOCKS_PER_SM`` blocks each, and no split shorter
    than ``MIN_SPLIT`` slots. One split when B*H alone fills the card or the
    cache is short."""
    if min(batch, heads, max_len, sms) < 1:
        raise ValueError(f"split_plan needs positive sizes, got {(batch, heads, max_len, sms)}")
    wanted = -(-BLOCKS_PER_SM * sms // (batch * heads))
    return max(1, min(wanted, max_len // MIN_SPLIT))


def split_bounds(max_len: int, splits: int):
    """The kernel's slot ranges: split i covers
    ``[i * max_len // splits, (i + 1) * max_len // splits)``."""
    return [(i * max_len // splits, (i + 1) * max_len // splits) for i in range(splits)]


def decode_attention_split_reference(q, k, v, pos, splits: int):
    """The plain form of the kernel's two phases: per split of
    :func:`split_bounds`, the partial softmax state (m, l, acc) over its
    slots ``<= pos[b]`` in fp32 (m = -inf, l = 0, acc = 0 when the split
    starts past pos), then the log-sum-exp merge in which an empty split
    weighs 0 and the sum is divided by ``max(l, 1e-30)``. Returns
    [B,H,D] in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    batch, heads, dim = q.shape
    max_len = k.shape[2]
    s = torch.einsum("bhd,bhmd->bhm", qf, kf) * dim ** -0.5
    slots = torch.arange(max_len, device=k.device)
    live = (slots[None, :] <= pos.to(slots.dtype)[:, None])[:, None, :]  # [b, 1, m]
    ms, ls, accs = [], [], []
    for lo, hi in split_bounds(max_len, splits):
        part = s[:, :, lo:hi].masked_fill(~live[:, :, lo:hi], float("-inf"))
        m = part.amax(dim=-1)  # [b, h]; -inf for an empty split
        p = torch.exp(part - torch.where(m == float("-inf"), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhm,bhmd->bhd", p, vf[:, :, lo:hi]))
    m_all = torch.stack(ms)  # [splits, b, h]
    merged = m_all.amax(dim=0)
    weight = torch.where(m_all == float("-inf"), 0.0,
                         torch.exp(m_all - torch.where(merged == float("-inf"), 0.0, merged)))
    total = (torch.stack(ls) * weight).sum(0)
    out = (torch.stack(accs) * weight[..., None]).sum(0)
    return (out / total.clamp_min(1e-30)[..., None]).to(q.dtype)


def _check(q, k, v, pos, block_k) -> None:
    """What the JAX function refuses, on any device (the kernels take
    everything else)."""
    check_plain_dtype("decode_attention", q.dtype)
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
    # JAX fails on 0 (a division), on negatives and None (shapes), and on a
    # float wherever it sets the tiles
    if not isinstance(block_k, int) or block_k < 1:
        raise ValueError(f"block_k must be a positive int, got {block_k!r}")
    devices = {t.device for t in (q, k, v, pos)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and pos must share a device, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (q, k, v, pos)):
        raise ValueError("decode_attention takes contiguous tensors")


def _launch(q, k, v, pos, block_k: int) -> torch.Tensor:
    batch, heads, dim = q.shape
    max_len = k.shape[2]
    if not q.dtype.is_floating_point:
        # JAX's tiles in order: the result depends on them for an integer or
        # bool cache; elements are read one by one, so no alignment is needed
        out = torch.empty_like(q)
        _kernels.launch(
            _kernels.function("decode_attention", "decode_attention_tiled_launch",
                              _TILED_ARGTYPES), LAUNCHES,
            q, q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), batch,
            heads, max_len, dim, _kernels.ELEMENT_CODES[q.dtype], min(block_k, max_len),
            dim ** -0.5)
        return out
    # a view that is not 16-byte aligned is copied: the allocator aligns the copy
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    splits = split_plan(batch, heads, max_len, _kernels.sm_count(q.get_device()))
    out = torch.empty_like(q)
    partial = (torch.empty(batch * heads * splits * (dim + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    _kernels.launch(
        _kernels.function("decode_attention", "decode_attention_launch", _ARGTYPES), LAUNCHES,
        q, q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), batch, heads, max_len, dim,
        _kernels.FLOAT_CODES[q.dtype], splits, dim ** -0.5)
    return out


def decode_attention(q, k, v, pos, block_k: int = 128, interpret=None):
    """One-step decode attention. q: [batch, heads, dim]; k, v:
    [batch, heads, max_len, dim]; pos: [batch] int32 — cache slots
    ``<= pos[b]`` attend. Returns [batch, heads, dim] in q's dtype.

    ``block_k`` and ``interpret`` keep the JAX signature. ``block_k`` is
    checked (a positive int) and sets the tiles of ``min(block_k, M)``
    slots of an integer or bool cache, where the result depends on them, as
    in JAX (the tiled kernel and plain version); for a float cache the
    split-K kernel splits the cache by ``split_plan``. ``interpret`` changes nothing: the tensors'
    device decides what runs. CUDA tensors run a Hopper kernel (every dtype
    of ``ops.PLAIN_DTYPES``, any D); CPU tensors the plain version."""
    _check(q, k, v, pos, block_k)
    device = q.device.type
    if device == "cuda":
        return _launch(q, k, v, pos, block_k)
    if device == "cpu":
        if q.dtype.is_floating_point:
            return decode_attention_reference(q, k, v, pos)
        return decode_attention_tiled_reference(q, k, v, pos, block_k)
    raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {device}")
