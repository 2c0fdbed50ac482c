"""Blocked online-softmax attention (flash attention) over [B,S,H,D].

Replaces the Pallas TPU kernel ``client_tpu/ops/flash_attention.py``
(``_flash_kernel`` behind ``flash_attention``) with a CUDA C++ kernel for
Hopper, ``client_tpu_torch/csrc/flash_attention.cu``, built by nvcc and
called through ctypes (see ``ops._kernels``).

q, k, v: [batch, seq, heads, dim], one dtype, any seq >= 1; softmax scale
``dim**-0.5``; optional causal mask; output in q's dtype. The kernels take
every dtype of ``ops.PLAIN_DTYPES`` and any dim, as the JAX function does.
float32, bfloat16 and float16 run the float kernels, built for padded
widths (16, 32, 64, 96, 128, 256; the real dim read at run time) and, past
256, in wide forms on thread-block clusters (:func:`wide_plan`): a cluster
of up to 8 blocks covers one (batch x head, query tile), each block owns an
even slab of at most 128 columns of the dim, which is both its share of
QK^T's depth and its slab of the output; each query row's partial scores
are summed in rank order by one block of the cluster, which runs its
softmax and shares P back over distributed shared memory, so QK^T is
computed once for every dim up to 1024 (``groups`` times past that); q, k
or v that are not 16-byte aligned (views into larger tensors) are copied
into fresh tensors, which the allocator aligns, and the same kernel runs on the copies
(served callers pass fresh tensors, so the served path never copies).
Integer and bool inputs run the tiled kernel, which walks JAX's key tiles
of ``min(block_k, seq)`` keys in order (``block_k`` is handed to it),
elements read by their dtype's code. The plain versions take the same on
the CPU. Scores and the output accumulate in fp32; with bf16 or fp16
inputs the probabilities are rounded to the input dtype before the PV
product, as the Pallas kernel does. The kernels mask keys past the sequence
themselves, so a ragged length is never padded in memory, and they read the
[B,S,H,D] layout with strides (no transpose copies around them).

Bound on the H100: operations (4*B*H*S^2*D flops, about half when causal,
against 4*B*S*H*D elements moved). The kernel keeps the S x S scores out of
device memory, as the Pallas kernel keeps them out of HBM. bf16 and fp16
run on the tensor cores (``mma.sync``, FlashAttention-2 layout: Q fragments
and the probabilities stay in registers, K/V tiles double-buffered with
``cp.async``); fp32 keeps fp32 precision: FMAs on the CUDA cores at head
dims up to 32 and past 256, and at 33-256 3xTF32 on the tensor cores (each
operand split into TF32 big and small parts, three products summed in fp32:
:func:`flash_attention_3xtf32_reference` is its plain form). One-pass TF32
misses the 2e-5 tolerance.

``flash_attention_tiled_reference`` is the plain form of the kernel's loop
(64-key tiles, online softmax, p rounded to v's dtype before PV, as the
bf16 and fp16 kernel and the Pallas kernel do); ``flash_attention_reference``
is the dense version the kernel is held against.

``flash_attention`` launches a kernel for CUDA tensors on the current
stream and raises if the launch fails; for CPU tensors it computes
``flash_attention_reference``, the dense plain version beside it, or, for
integer or bool inputs, ``flash_attention_tiled_reference`` with JAX's key
tiles (rounding the probabilities to v's dtype truncates them to 0 or 1
there, so the result depends on the tiles; the tiled kernel's arithmetic is
this function's). There is no fallback from the one to the other. Both
refuse, on any device, the block sizes JAX's function refuses
(:func:`check_blocks`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import LaunchCounter, _kernels, check_plain_dtype

# flash_attention_launch(q, k, v, out, batch, seq, heads, dim, stride_b,
#                        stride_s, stride_h, dtype, scale, causal, cluster,
#                        groups, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
# flash_attention_tiled_launch(q, k, v, out, batch, seq, heads, dim,
#                              stride_b, stride_s, stride_h, code, scale,
#                              causal, tile, stream)
_TILED_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
# keys per tile of the kernel (and of the tiled plain version)
BLOCK_K = 64

# kernel launches made by flash_attention (CPU calls do not count)
LAUNCHES = LaunchCounter()

# the widest head dim of the dense float kernels; past it the wide kernels run
DENSE_MAX_DIM = 256
# the fp32 head dims of the 3xTF32 kernel (padded widths 64-256 in
# csrc/flash_attention.cu's dispatch_f32; padded widths 16 and 32 run fp32
# FMAs, and past DENSE_MAX_DIM the wide kernels run)
TF32_DIMS = range(33, DENSE_MAX_DIM + 1)
# the wide kernels' slab width at most, and the blocks of a cluster at most
# (the portable cluster size; csrc/flash_attention.cu's kWideWidth and
# kWideCluster)
WIDE_WIDTH = 128
WIDE_CLUSTER = 8


class WidePlan(NamedTuple):
    """How a wide kernel cuts a head dim past 256: ``cluster`` blocks a
    thread-block cluster, ``groups`` cluster groups in grid.z (each computes
    QK^T over the whole dim), slabs ``bounds`` = [(start, end), ...] of the
    dim, ``cluster * groups`` of them, each at most ``width`` columns; block
    r of group g owns output slab ``g * cluster + r`` and sums the partial
    scores of slabs ``j * cluster + r`` (j < groups); ``block_q`` query rows
    a cluster; ``smem_bytes`` is a block's dynamic shared memory."""
    cluster: int
    width: int
    bounds: Tuple[Tuple[int, int], ...]
    groups: int
    block_q: int
    smem_bytes: int


def wide_plan(dim: int, dtype) -> WidePlan:
    """The plan of the wide kernel for ``dim`` > 256 in ``dtype`` (float32,
    or bfloat16 / float16): ceil(dim / 128) slabs at most 128 wide, in
    ``groups = ceil(dim / (8 * 128))`` cluster groups of ``cluster`` blocks
    (at most 8), the dim cut evenly in whole 8-column units (the first
    ``units % slabs`` slabs one unit wider), the last slab ending at dim.
    D = 257 gives three slabs of 88, 88 and 81 columns in one cluster of 3."""
    if not isinstance(dim, int) or dim <= DENSE_MAX_DIM:
        raise ValueError(f"wide_plan takes a head dim past {DENSE_MAX_DIM}, got {dim!r}")
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"the wide kernels take float32, bfloat16 or float16, not {dtype}")
    needed = -(-dim // WIDE_WIDTH)
    groups = -(-needed // WIDE_CLUSTER)
    cluster = -(-needed // groups)
    slabs = cluster * groups
    base, rem = divmod(-(-dim // 8), slabs)
    cuts = [min(dim, 8 * (s * base + min(s, rem))) for s in range(slabs + 1)]
    # fp32 takes 80 query rows a cluster where Q stays resident (one group):
    # the served (1, 1024, 4, 512) then makes 52 clusters of 4, two waves of
    # the 30 an H100 holds at one block an SM, where 64 rows make three
    block_q = 80 if dtype == torch.float32 and groups == 1 else 64
    # the exchange: the partial score rows a block receives (n * ceil(block_q
    # / n) at most over the cluster sizes, in whole 8-row groups; 64 keys,
    # fp32, padded), two tiles of P (block_q x 64 in the input type, padded)
    # and three rows of block_q floats (two of corrections, the final l)
    recv_rows = -(-max(n * -(-block_q // n) for n in range(2, WIDE_CLUSTER + 1)) // 8) * 8
    itemsize = 4 if dtype == torch.float32 else 2
    exchange = recv_rows * 72 * 4 + 2 * block_q * 72 * itemsize + 3 * block_q * 4
    # K x 2 and V (64 rows), Q x 1 (resident) or 2 (restaged a key tile,
    # past one group) (block_q rows): rows of 128 + 4 floats or 128 + 8
    # 2-byte values
    q_buffers = 1 if groups == 1 else 2
    row_bytes = (WIDE_WIDTH + 4) * 4 if dtype == torch.float32 else (WIDE_WIDTH + 8) * 2
    smem = (3 * 64 + q_buffers * block_q) * row_bytes + exchange
    return WidePlan(cluster, WIDE_WIDTH, tuple(zip(cuts, cuts[1:])), groups, block_q, smem)


def runs_3xtf32(dim: int, dtype) -> bool:
    """Whether a CUDA launch at head dim ``dim`` in ``dtype`` runs the
    3xTF32 kernel (float32 at :data:`TF32_DIMS`)."""
    return dtype == torch.float32 and dim in TF32_DIMS


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the
    13 low mantissa bits dropped, to nearest with ties away from zero, by
    integer arithmetic on the int32 view (add half a TF32 ulp to the
    magnitude bits, clear the 13). A carry runs into the exponent, so the
    largest finite floats round to inf; subnormals round on the same grid;
    zeros and infinities are kept, and so are NaNs."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with big = tf32_round(x) and small = tf32_round(x -
    big): the 3xTF32 operands of x (x - big is exact in fp32)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def flash_attention_3xtf32_reference(q, k, v, causal: bool = False):
    """The dense plain version in the arithmetic of the fp32 kernel for
    head dims 33-256: each fp32 operand of QK^T and of PV split into TF32
    big and small parts (:func:`tf32_split`) and the product taken as
    small.big + big.small + big.big in fp32, as the kernel's three
    tensor-core products accumulate it (each product of two TF32 values is
    exact in fp32; only the sums round). The softmax between is the dense
    version's. float32 only; for tests and ``chip_smoke.py``, never a path
    of the wrapper."""
    if not all(t.dtype == torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention_3xtf32_reference takes float32 q, k and v")

    def product(spec, a, b):
        (a_big, a_small), (b_big, b_small) = tf32_split(a), tf32_split(b)
        return (torch.einsum(spec, a_small, b_big) + torch.einsum(spec, a_big, b_small)
                + torch.einsum(spec, a_big, b_big))

    s = product("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        seq = q.shape[1]
        keep = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return product("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def flash_attention_tiled_reference(q, k, v, causal: bool = False, block_k: int = BLOCK_K,
                                    out_dtype=None):
    """The kernel's loop in plain PyTorch: key tiles of ``block_k`` walked in
    order with a running (max, sum, acc) per query row in fp32, scores in
    fp32 from the operands in their own dtype, the probabilities rounded to
    v's dtype before the PV product (``p.astype(v.dtype)`` in the Pallas
    kernel; a no-op in fp32), a row with no live key yet kept at p = 0 with
    a correction of 0, and the final divide by ``max(l, 1e-30)``. Returns
    q's dtype, or ``out_dtype`` where given (``torch.float32``: the quotient
    before the cast)."""
    batch, seq, heads, dim = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = dim ** -0.5
    rows = torch.arange(seq, device=q.device)
    m = torch.full((batch, heads, seq), float("-inf"), device=q.device)
    l = torch.zeros((batch, heads, seq), device=q.device)
    acc = torch.zeros((batch, heads, seq, dim), device=q.device)
    for k0 in range(0, seq, block_k):
        k1 = min(seq, k0 + block_k)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k1]) * scale
        if causal:
            keys = torch.arange(k0, k1, device=q.device)
            s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - m_use[..., None])
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf[:, k0:k1])
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(out_dtype or q.dtype)


def check_blocks(seq: int, block_q: int, block_k: int) -> None:
    """Refuse what JAX's ``flash_attention`` refuses
    (``client_tpu/ops/flash_attention.py``): each block clamped to
    ``min(block, seq)``, the sequence padded to a multiple of the larger,
    that length must divide by both blocks. (130, 128, 64) pads to 256 and
    runs; (40, 128, 16) pads to 48, which 40 does not divide, and raises."""
    block_q, block_k = min(block_q, seq), min(block_k, seq)
    block = max(block_q, block_k)
    padded = -(-seq // block) * block
    if padded % block_q or padded % block_k:
        raise ValueError(f"seq {padded} must divide by blocks {block_q}/{block_k}")


def _check(q, k, v, block_q, block_k) -> None:
    """What the JAX function refuses, on any device (the kernels take
    everything else)."""
    check_plain_dtype("flash_attention", q.dtype)
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
    for name, block in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(block, int) or block < 1:
            raise ValueError(f"{name} must be a positive int, got {block!r}")
    check_blocks(seq, block_q, block_k)
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v must share a device, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous tensors")


def _launch(q, k, v, causal: bool, block_k: int) -> torch.Tensor:
    batch, seq, heads, dim = q.shape
    if not q.dtype.is_floating_point:
        # JAX's key tiles in order: the result depends on them for integer
        # or bool inputs; elements are read one by one, so no alignment is
        # needed
        out = torch.empty_like(q)
        stride_b, stride_s, stride_h, _ = q.stride()
        _kernels.launch(
            _kernels.function("flash_attention", "flash_attention_tiled_launch",
                              _TILED_ARGTYPES), LAUNCHES,
            q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, seq, heads, dim,
            stride_b, stride_s, stride_h, _kernels.ELEMENT_CODES[q.dtype], dim ** -0.5,
            int(causal), min(block_k, seq))
        return out
    # a view that is not 16-byte aligned is copied: the allocator aligns the copy
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    stride_b, stride_s, stride_h, _ = q.stride()
    plan = wide_plan(dim, q.dtype) if dim > DENSE_MAX_DIM else None
    _kernels.launch(
        _kernels.function("flash_attention", "flash_attention_launch", _ARGTYPES), LAUNCHES,
        q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, seq, heads, dim,
        stride_b, stride_s, stride_h, _kernels.FLOAT_CODES[q.dtype], dim ** -0.5, int(causal),
        plan.cluster if plan else 1, plan.groups if plan else 1)
    return out


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128, block_k: int = 128,
                    interpret=None):
    """Blocked attention. q, k, v: [batch, seq, heads, dim] -> the same
    shape, in q's dtype.

    ``block_q``, ``block_k`` and ``interpret`` keep the JAX signature. The
    blocks are checked as JAX checks them (:func:`check_blocks`). For float
    inputs the result does not depend on them: the float kernels tile keys
    by 64 and queries by 64 (fp32 at D <= 32: keys by 128, queries by 64 /
    32; fp32 past 256 in one cluster group: queries by 80); the TPU's block
    sizes follow its VMEM and its 128-wide MXU. The plain version is dense.
    Past a head dim of 256 a cluster of blocks shares each query tile
    (:func:`wide_plan`). For integer or bool inputs, the tiled kernel and
    the tiled plain version walk ``min(block_k, seq)`` keys a tile, as JAX's
    kernel does. ``interpret`` changes nothing: the tensors' device decides
    what runs. CUDA tensors run a Hopper kernel (every dtype of
    ``ops.PLAIN_DTYPES``, any D); CPU tensors the plain version."""
    _check(q, k, v, block_q, block_k)
    device = q.device.type
    if device == "cuda":
        return _launch(q, k, v, causal, block_k)
    if device == "cpu":
        if q.dtype.is_floating_point:
            return flash_attention_reference(q, k, v, causal)
        return flash_attention_tiled_reference(q, k, v, causal, min(block_k, q.shape[1]))
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {device}")
