"""Ulysses sequence parallelism: all-to-all head/sequence repartition.

The counterpart of ``client_tpu.parallel.ulysses``. Where the ring
(:mod:`.ring`) rotates K/V blocks, Ulysses re-partitions q, k and v with
one tiled :func:`~client_tpu_torch.parallel.all_to_all` each, so every shard
holds the FULL sequence for a slice of the heads, runs dense attention on
it, and a fourth all-to-all re-partitions the output back by sequence.
Heads must divide by the axis (the ring needs only the sequence to), and
each shard holds its heads' whole ``[seq, seq]`` scores. Both are exact.
"""

from __future__ import annotations

from . import Mesh, Sharded, all_to_all, shards_of
from .ring import full_attention, ring_attention

# auto's limit on one shard's Ulysses scores and probabilities
AUTO_SCORE_BYTES = 1 << 30


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = "data", causal: bool = False) -> Sharded:
    """Exact attention with the sequence axis split over ``axis``.

    q, k, v: [batch, seq, heads, dim], whole or :class:`Sharded` along the
    sequence; heads and seq must divide by the axis size. Returns the
    output sharded along the sequence. ``causal`` is the ordinary lower
    triangle: after the all-to-all each shard holds the whole sequence."""
    n = mesh.shape[axis]
    batch, seq, heads, dim = q.shape
    if seq % n != 0:
        raise ValueError(f"seq {seq} must divide by mesh axis size {n}")
    if heads % n != 0:
        raise ValueError(f"heads {heads} must divide by mesh axis size {n}")
    devices = mesh.axis_devices(axis)

    def scatter_heads(x):  # [b, seq/n, h, d] -> [b, seq, h/n, d] a shard
        return all_to_all(shards_of(x, devices, 1), 2, 1, devices)

    outs = [full_attention(qf, kf, vf, causal=causal)
            for qf, kf, vf in zip(scatter_heads(q), scatter_heads(k), scatter_heads(v))]
    return Sharded(all_to_all(outs, 1, 2, devices), 1)


def sequence_parallel_attention(q, k, v, mesh: Mesh, axis: str = "data", mode: str = "auto",
                                causal: bool = False) -> Sharded:
    """Ring or Ulysses by ``mode``: "ring", "ulysses", or "auto", which takes
    Ulysses when the heads divide the axis and one shard's scores and
    probabilities (``2 * batch * heads/n * seq**2`` fp32) stay under 1 GiB,
    else the ring, as JAX's rule."""
    n = mesh.shape[axis]
    if mode == "ring":
        return ring_attention(q, k, v, mesh, axis, causal=causal)
    if mode == "ulysses":
        return ulysses_attention(q, k, v, mesh, axis, causal=causal)
    if mode != "auto":
        raise ValueError(f"unknown sequence-parallel mode {mode!r}")
    if auto_mode(q.shape, n) == "ulysses":
        return ulysses_attention(q, k, v, mesh, axis, causal=causal)
    return ring_attention(q, k, v, mesh, axis, causal=causal)


def auto_mode(shape, n: int) -> str:
    """What "auto" runs for q of ``shape`` [batch, seq, heads, dim] over an
    axis of ``n`` shards: "ulysses" or "ring"."""
    batch, seq, heads = shape[0], shape[1], shape[2]
    score_bytes = 2 * batch * (heads // max(n, 1)) * seq ** 2 * 4
    return "ulysses" if heads % n == 0 and score_bytes < AUTO_SCORE_BYTES else "ring"
