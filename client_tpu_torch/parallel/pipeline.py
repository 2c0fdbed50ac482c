"""Pipeline parallelism: GPipe-style microbatches streamed over a mesh axis.

The counterpart of ``client_tpu.parallel.pipeline``. Stage s of an MLP lives
on shard s of the axis; microbatches enter at shard 0 and each step's
activations hop one shard onward (:func:`~client_tpu_torch.parallel.ppermute`).
JAX's schedule: ``S + M - 1`` steps, shard ``S - 1`` emitting microbatch m
at step ``S - 1 + m``. Exact: the result equals :func:`sequential_mlp`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import Mesh, move, ppermute


def mlp_stage_params(seed: int, n_stages: int, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked stage weights (W [S, dim, dim], b [S, dim]) in float32 from
    ``np.random.default_rng(seed)``, scaled as JAX's draw (``sqrt(2/dim)``
    and 0.01). JAX draws with ``jax.random``, which torch cannot reproduce:
    pass its arrays through numpy to run both on the same weights."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n_stages, dim, dim)).astype(np.float32) * np.float32(
        (2.0 / dim) ** 0.5)
    b = rng.standard_normal((n_stages, dim)).astype(np.float32) * np.float32(0.01)
    return torch.from_numpy(w), torch.from_numpy(b)


def sequential_mlp(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reference: every stage in order on one device."""
    h = x
    for s in range(w.shape[0]):
        h = torch.relu(h @ w[s] + b[s])
    return h


def pipeline_forward(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, mesh: Mesh,
                     axis: str = "model", n_microbatches: int = 4) -> torch.Tensor:
    """The stacked-stage MLP as a pipeline over ``axis``.

    w: [S, dim, dim], b: [S, dim] with S the axis size; x: [batch, dim] with
    batch divisible by ``n_microbatches``. Returns [batch, dim] on the last
    stage's device, equal to ``sequential_mlp(w, b, x)``."""
    n_stages = mesh.shape[axis]
    if w.shape[0] != n_stages:
        raise ValueError(f"need {n_stages} stages for mesh axis '{axis}', got {w.shape[0]}")
    batch, dim = x.shape
    if batch % n_microbatches != 0:
        raise ValueError(f"batch {batch} must divide by n_microbatches {n_microbatches}")
    devices = mesh.axis_devices(axis)
    stages = [(move(w[s], dev), move(b[s], dev))
              for s, dev in enumerate(devices)]
    x_mb = x.reshape(n_microbatches, batch // n_microbatches, dim).to(devices[0])
    # one hop toward the next stage; the wrap link's payload is ignored
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = [torch.zeros_like(x_mb[0], device=dev) for dev in devices]
    emitted = []
    for t in range(n_stages + n_microbatches - 1):
        ys = []
        for s, (stage_w, stage_b) in enumerate(stages):
            feed = x_mb[min(t, n_microbatches - 1)] if s == 0 else buf[s]
            ys.append(torch.relu(feed @ stage_w + stage_b))
        emitted.append(ys[-1])
        buf = ppermute(ys, perm, devices)
    return torch.stack(emitted[n_stages - 1:]).reshape(batch, dim)
