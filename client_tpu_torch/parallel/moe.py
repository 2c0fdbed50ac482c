"""Expert parallelism: a top-1 mixture-of-experts FFN with token dispatch.

The counterpart of ``client_tpu.parallel.moe``. Expert weights are split
over a mesh axis and tokens travel to their expert's shard: route, scatter
into ``[E, C, d]`` capacity buffers, tiled
:func:`~client_tpu_torch.parallel.all_to_all`, the resident experts'
batched products, the inverse all-to-all, combine. Exact against
:func:`dense_moe_reference` when the capacity admits every routed token; a
token past its expert's capacity is dropped to a zero row.
"""

from __future__ import annotations

import torch

from . import Mesh, Sharded, all_to_all, move, shards_of


def dense_moe_reference(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
                        w2: torch.Tensor) -> torch.Tensor:
    """Top-1 MoE on one device. x: [T, d]; gate_w: [d, E]; w1: [E, d, h];
    w2: [E, h, d]."""
    scores = x @ gate_w
    expert = scores.argmax(-1)
    gate = scores.float().gather(1, expert[:, None])[:, 0]
    out = torch.zeros_like(x)
    for e in range(w1.shape[0]):
        y = torch.relu(x @ w1[e]) @ w2[e]
        out = out + torch.where((expert == e)[:, None], y, 0.0)
    return out * gate[:, None]


def moe_ffn(x, gate_w: torch.Tensor, w1, w2, mesh: Mesh, axis: str = "model",
            capacity: int = 0) -> Sharded:
    """Top-1 MoE FFN with the experts split over ``axis``.

    x: [T, d] (whole, or :class:`Sharded` on the token dim); gate_w [d, E]
    replicated; w1 [E, d, h] and w2 [E, h, d] whole or sharded on the
    expert dim. T and E must divide by the axis size. ``capacity`` is the
    per-(shard, expert) token budget; 0 means the local token count
    (lossless). Returns [T, d] sharded on the token dim."""
    n = mesh.shape[axis]
    tokens, d = x.shape
    n_experts = w1.shape[0]
    if tokens % n != 0:
        raise ValueError(f"tokens {tokens} must divide by mesh axis size {n}")
    if n_experts % n != 0:
        raise ValueError(f"experts {n_experts} must divide by mesh axis size {n}")
    cap = capacity or tokens // n
    per_shard = n_experts // n
    devices = mesh.axis_devices(axis)
    xs = shards_of(x, devices, 0)
    w1s = shards_of(w1, devices, 0)
    w2s = shards_of(w2, devices, 0)

    routes, sends = [], []
    for x_blk, dev in zip(xs, devices):
        scores = x_blk @ move(gate_w, dev)                       # [T/n, E]
        expert = scores.argmax(-1)                               # first index on ties
        gate = scores.float().gather(1, expert[:, None])[:, 0]
        # each token's place in its expert's buffer: the running count
        one_hot = (expert[:, None] == torch.arange(n_experts, device=dev)).int()
        slot = (one_hot.cumsum(0) - 1).gather(1, expert[:, None])[:, 0]
        keep = slot < cap
        send = torch.zeros((n_experts, cap, d), dtype=x_blk.dtype, device=dev)
        # a dropped token adds zeros at slot 0, as JAX's .at[].add
        send.index_put_((expert, torch.where(keep, slot, 0)),
                        torch.where(keep[:, None], x_blk, 0.0), accumulate=True)
        routes.append((expert, slot, keep, gate))
        sends.append(send.reshape(n, per_shard, cap, d))
    # received[j]: [n, E/n, C, d], every shard's tokens for shard j's experts
    results = []
    for got, w1_blk, w2_blk in zip(all_to_all(sends, 0, 0, devices), w1s, w2s):
        flat = got.transpose(0, 1).reshape(per_shard, n * cap, d)
        hidden = torch.relu(torch.einsum("ekd,edh->ekh", flat, w1_blk))
        result = torch.einsum("ekh,ehd->ekd", hidden, w2_blk)
        results.append(result.reshape(per_shard, n, cap, d).transpose(0, 1))
    outs = []
    for back, x_blk, (expert, slot, keep, gate) in zip(
            all_to_all(results, 0, 0, devices), xs, routes):
        back = back.reshape(n_experts, cap, d)
        # a dropped token's slot may lie past the buffer: clamp it, as JAX's
        # gather clamps, and keep zeroes the row
        out = back[expert, slot.clamp(max=cap - 1)] * keep[:, None]
        outs.append((out * gate[:, None]).to(x_blk.dtype))
    return Sharded(outs, 0)
