"""Device meshes: one model served over several devices by one process.

The counterpart of ``client_tpu.parallel``. The JAX package runs a mesh
program as one SPMD computation over a ``jax.sharding.Mesh``: ``shard_map``
bodies, and collectives that XLA inserts or ``lax`` names. The port keeps
the single-controller design (one server process drives every shard) and
makes each part explicit:

- :class:`Mesh`: named axes over a grid of ``torch.device``\\ s. A device may
  repeat; its shards then share it, as the JAX tests' shards share one CPU.
- :class:`Sharded`: one tensor split along one dim over a mesh axis, block
  ``i`` on the axis' device ``i`` (a JAX global array whose
  ``PartitionSpec`` names that axis).
- :func:`ppermute`, :func:`all_to_all` and :func:`all_gather` on per-shard
  lists: a body runs once per shard, in a loop, and a collective moves the
  blocks between the shards' devices with :func:`move`, which moves no
  bytes between two shards of one device.

``ring``, ``ulysses``, ``moe`` and ``pipeline`` hold the sequence-, expert-
and pipeline-parallel algorithms. The training step and the multi-process
bootstrap (``client_tpu.parallel.multihost``) are not ported yet
(ROADMAP.md A9b).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the JAX tests' virtual CPU devices (--xla_force_host_platform_device_count=8)
CPU_DEVICES = 8


def local_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh may use on this host: one per visible card for
    ``cuda``; for ``cpu`` eight entries of the one CPU, so that sizes such as
    ``tp=4`` mean on the CPU what they mean in ``client_tpu``'s tests."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    raise ValueError(f"no mesh devices of type {kind!r} (cuda or cpu)")


def take_devices(n_devices: Optional[int], device="cuda") -> List[torch.device]:
    """The first ``n_devices`` of :func:`local_devices` (0 or None: all of
    them); JAX's ``ValueError`` when there are fewer."""
    devices = local_devices(device)
    n = n_devices or len(devices)
    if n > len(devices) or n < 1:
        raise ValueError(f"requested {n} devices but only {len(devices)} available")
    return devices[:n]


def move(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: asynchronous onto a card (work queued after it on
    that card sees the data), blocking onto the host, so that the CPU never
    reads a copy from a card that has not landed yet."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card, so
    that shards compare equal however their device was named."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Named axes over a grid of devices.

    ``devices``: a nested sequence (or numpy array) of ``torch.device`` or
    device strings, one dimension per name of ``axis_names``. ``shape`` maps
    each axis name to its size, in order, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        raw = np.asarray(devices, dtype=object)
        grid = np.empty(raw.shape, dtype=object)
        for index, dev in np.ndenumerate(raw):
            grid[index] = _indexed(dev)
        names = tuple(axis_names)
        if grid.ndim != len(names) or grid.size == 0:
            raise ValueError(f"a mesh of shape {list(grid.shape)} needs {grid.ndim} axis "
                             f"names and at least one device, got {list(names)}")
        self.devices = grid
        self.axis_names = names
        self.shape: "OrderedDict[str, int]" = OrderedDict(zip(names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where a
        body over that axis runs (the other axes hold its replicas)."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes {list(self.axis_names)})")
        index = [0] * len(self.axis_names)
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("data", "model"), device="cuda") -> Mesh:
    """A 2-D (data x model) mesh over the first ``n_devices`` of
    :func:`local_devices`, factorised as JAX's: tp is the first of 4 and 2
    that divides n (else 1), dp = n / tp."""
    devices = take_devices(n_devices, device)
    n = len(devices)
    tp = next((cand for cand in (4, 2) if n % cand == 0), 1)
    grid = np.empty((n // tp, tp), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // tp, i % tp] = dev
    return Mesh(grid, axis_names)


class Sharded:
    """One tensor split along ``dim``: ``shards[i]`` is block ``i``, on the
    device of the mesh axis' shard ``i``."""

    def __init__(self, shards: Sequence[torch.Tensor], dim: int):
        self.shards = list(shards)
        self.dim = dim

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.shards[0].shape)
        shape[self.dim] = sum(s.shape[self.dim] for s in self.shards)
        return tuple(shape)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: shard 0's)."""
        device = self.shards[0].device if device is None else torch.device(device)
        return torch.cat([move(s, device) for s in self.shards], self.dim)

    def numpy(self) -> np.ndarray:
        return self.full("cpu").numpy()


def split(x: torch.Tensor, devices: Sequence[torch.device], dim: int) -> Sharded:
    """``x`` in ``len(devices)`` equal blocks along ``dim``, block i on
    ``devices[i]`` (a view where the device is already x's)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {list(x.shape)} must divide by {n} shards")
    return Sharded([move(blk, dev)
                    for blk, dev in zip(torch.chunk(x, n, dim), devices)], dim)


def shards_of(x, devices: Sequence[torch.device], dim: int) -> List[torch.Tensor]:
    """The per-shard blocks of ``x`` over ``devices``: a :class:`Sharded`
    already split that way as it is, a whole tensor split by :func:`split`."""
    if isinstance(x, Sharded):
        if x.dim != dim or x.devices != [_indexed(d) for d in devices]:
            raise ValueError(f"sharded along dim {x.dim} over {x.devices}; this needs dim "
                             f"{dim} over {list(devices)}")
        return x.shards
    return split(x, devices, dim).shards


# -- collectives on per-shard lists ------------------------------------------


def ppermute(shards: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s block for each
    ``(src, dst)`` of ``perm``; a shard that receives nothing gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = move(shards[src], devices[dst])
    return [torch.zeros_like(s) if o is None else o for o, s in zip(out, shards)]


def all_to_all(shards: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)``: each shard's block is cut in n
    along ``split_axis``; shard j receives piece j of every shard,
    concatenated along ``concat_axis`` in shard order."""
    n = len(shards)
    for s in shards:
        if s.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {list(s.shape)} must divide "
                             f"by {n} shards")
    pieces = [torch.chunk(s, n, split_axis) for s in shards]
    return [torch.cat([move(pieces[i][j], devices[j]) for i in range(n)],
                      concat_axis) for j in range(n)]


def all_gather(shards: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard receives the blocks concatenated along ``dim``; shards of
    one device share one copy."""
    gathered: Dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in gathered:
            gathered[dev] = torch.cat([move(s, dev) for s in shards], dim)
    return [gathered[dev] for dev in devices]


# -- tensor- and data-parallel placement ---------------------------------------


def _tree_map(fn: Callable[[Any], Any], tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_params(params, mesh: Mesh):
    """Place a parameter tree (dicts, lists and tuples of tensors or numpy
    arrays) on the mesh, by JAX's rule: the last (output-feature) axis of
    each tensor of two or more dims is split over ``model`` when it divides
    (a :class:`Sharded`); every other leaf is replicated, one copy on the
    axis' first device."""
    devices = mesh.axis_devices("model")

    def place(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.array(leaf))
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.ndim >= 2 and leaf.shape[-1] % len(devices) == 0:
            return split(leaf, devices, leaf.ndim - 1)
        return leaf.to(devices[0])

    return _tree_map(place, params)


def sharded_forward(fn: Callable[[Any, torch.Tensor], torch.Tensor], mesh: Mesh):
    """``run(params, batch)``: the batch split over ``data`` (dim 0), each
    block moved to its data shard's device and passed to ``fn(params,
    block)``, the outputs concatenated on the first data shard's device.
    Parameters stay where :func:`shard_params` (or the model) put them."""
    rows = mesh.axis_devices("data")

    def run(params, batch: torch.Tensor) -> torch.Tensor:
        outs = [fn(params, block) for block in split(batch, rows, 0).shards]
        return Sharded(outs, 0).full(rows[0])

    return run


def sharded_train_step(module_apply, optimizer, mesh):
    """The dp + tp training step of ``client_tpu.parallel`` (behind
    ``__graft_entry__.dryrun_multichip``): not ported yet."""
    raise NotImplementedError(
        "sharded_train_step is not ported yet (ROADMAP.md A9b: the training step and "
        "multihost on torch.distributed)")


__all__ = [
    "CPU_DEVICES",
    "Mesh",
    "Sharded",
    "all_gather",
    "all_to_all",
    "local_devices",
    "make_mesh",
    "move",
    "ppermute",
    "shard_params",
    "sharded_forward",
    "sharded_train_step",
    "shards_of",
    "split",
    "take_devices",
]
