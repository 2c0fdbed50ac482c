"""Ring attention: context parallelism for long sequences.

The counterpart of ``client_tpu.parallel.ring``. The sequence axis is split
over a mesh axis; each shard keeps its query block and the key/value blocks
travel one hop around the ring a step (:func:`~client_tpu_torch.parallel.ppermute`),
the softmax accumulated online in fp32 (running max ``m``, sum ``l`` and
output ``acc``), so no shard holds more than a ``[seq/n, seq/n]`` block of
scores. Exact: it equals :func:`full_attention` within float rounding.

The block products are plain PyTorch (``torch.einsum`` in fp32), as JAX
computes them with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from . import Mesh, Sharded, ppermute, shards_of, split


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Reference dense attention. q, k, v: [batch, seq, heads, dim]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        seq = q.shape[1]
        mask = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, float("-inf"))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def place_sharded(arr: torch.Tensor, mesh: Mesh, axis: str = "data") -> Sharded:
    """Split [batch, seq, ...] on the sequence dim over ``axis``."""
    return split(arr, mesh.axis_devices(axis), 1)


def ring_attention(q, k, v, mesh: Mesh, axis: str = "data", causal: bool = False) -> Sharded:
    """Exact attention with the sequence axis split over ``axis``.

    q, k, v: [batch, seq, heads, dim], whole tensors or :class:`Sharded`
    along the sequence (:func:`place_sharded`); seq must divide by the axis
    size. Returns the output sharded the same way. Hop 0 is each shard's own
    (diagonal) block, then the K/V blocks rotate ``n - 1`` times, none after
    the last block. ``causal`` masks by global position: after ``hop`` hops
    shard i holds the block that started on shard ``(i - hop) mod n``."""
    n = mesh.shape[axis]
    seq = q.shape[1]
    if seq % n != 0:
        raise ValueError(f"seq {seq} must divide by mesh axis size {n}")
    devices = mesh.axis_devices(axis)
    qs = shards_of(q, devices, 1)
    k_cur = [t.float() for t in shards_of(k, devices, 1)]
    v_cur = [t.float() for t in shards_of(v, devices, 1)]
    batch, sq, heads, dim = qs[0].shape
    scale = dim ** -0.5
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = [torch.zeros((batch, heads, sq, dim), dtype=torch.float32, device=d) for d in devices]
    m = [torch.full((batch, heads, sq), float("-inf"), device=d) for d in devices]
    l = [torch.zeros((batch, heads, sq), dtype=torch.float32, device=d) for d in devices]
    for hop in range(n):
        if hop > 0:
            k_cur = ppermute(k_cur, perm, devices)
            v_cur = ppermute(v_cur, perm, devices)
        for i in range(n):
            s = torch.einsum("bqhd,bkhd->bhqk", qs[i].float(), k_cur[i]) * scale
            if causal:
                offsets = torch.arange(sq, device=devices[i])
                q_pos = i * sq + offsets
                k_pos = ((i - hop) % n) * sq + offsets
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, float("-inf"))
            m_new = torch.maximum(m[i], s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            correction = torch.exp(m[i] - m_new)
            l[i] = l[i] * correction + p.sum(-1)
            acc[i] = acc[i] * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur[i])
            m[i] = m_new
    # every query sees at least its diagonal block, so l > 0; the guard
    # stays for rounding, as in JAX
    return Sharded([(a / torch.clamp(li, min=1e-30)[..., None]).transpose(1, 2).to(qb.dtype)
                    for a, li, qb in zip(acc, l, qs)], 1)
