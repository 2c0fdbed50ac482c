"""Device meshes: one model over several devices, in one process or several.

The counterpart of ``client_tpu.parallel``. The JAX package runs a mesh
program as one SPMD computation over a ``jax.sharding.Mesh``: ``shard_map``
bodies, and collectives that XLA inserts or ``lax`` names. The port keeps
a single-controller design within each process (one process drives every
shard of its own) and makes each part explicit:

- :class:`Mesh`: named axes over a grid of ``torch.device``\\ s. A device may
  repeat; its shards then share it, as the JAX tests' shards share one CPU.
  A mesh from :mod:`.multihost` spans processes: it records the process
  that owns each position, and a position of another process is the
  ``meta`` device, so a body over its block computes shapes only.
- :class:`Sharded`: one tensor split along one dim over a mesh axis, block
  ``i`` on the axis' device ``i`` (a JAX global array whose
  ``PartitionSpec`` names that axis).
- :func:`ppermute`, :func:`all_to_all`, :func:`all_gather` and :func:`psum`
  on per-shard lists: a body runs once per shard, in a loop, and a
  collective moves the blocks between the shards' devices with
  :func:`move`, which moves no bytes between two shards of one device.
  Blocks whose positions lie in different processes travel through the
  ``torch.distributed`` process group (point-to-point sends,
  ``all_to_all_single``, ``all_gather``, ``all_reduce``).
- :func:`sharded_train_step`: the dp + tp training step.

``ring``, ``ulysses``, ``moe`` and ``pipeline`` hold the sequence-, expert-
and pipeline-parallel algorithms; ``multihost`` the process bootstrap and
the meshes that span processes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


REMOTE = torch.device("meta")  # a position that another process owns


def process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group (0
    when none is initialised)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class AxisDevices(list):
    """The devices of one mesh axis (a list), with the process that owns
    each position (``processes``) and this process's rank (``rank``)."""

    def __init__(self, devices, processes: Sequence[int], rank: int):
        super().__init__(devices)
        self.processes = list(processes)
        self.rank = rank

    def local(self, i: int) -> bool:
        return self.processes[i] == self.rank


class Mesh:
    """Named axes over a grid of devices.

    ``devices``: a nested sequence (or numpy array) of ``torch.device`` or
    device strings, one dimension per name of ``axis_names``. ``shape`` maps
    each axis name to its size, in order, as ``jax.sharding.Mesh.shape``.
    ``processes``: the rank owning each position, in the devices' shape
    (default: all this process's); a position of another rank holds
    :data:`REMOTE`."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        raw = np.asarray(devices, dtype=object)
        grid = np.empty(raw.shape, dtype=object)
        for index, dev in np.ndenumerate(raw):
            grid[index] = _indexed(dev)
        names = tuple(axis_names)
        if grid.ndim != len(names) or grid.size == 0:
            raise ValueError(f"a mesh of shape {list(grid.shape)} needs {grid.ndim} axis "
                             f"names and at least one device, got {list(names)}")
        self.rank = process_index()
        if processes is None:
            procs = np.full(grid.shape, self.rank, dtype=np.int64)
        else:
            procs = np.asarray(processes, dtype=np.int64)
            if procs.shape != grid.shape:
                raise ValueError(f"processes of shape {list(procs.shape)} for a mesh of "
                                 f"shape {list(grid.shape)}")
        if (procs == self.rank).sum() == 0:
            raise ValueError(f"process {self.rank} owns no position of the mesh")
        self.devices = grid
        self.processes = procs
        self.axis_names = names
        self.shape: "OrderedDict[str, int]" = OrderedDict(zip(names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return bool((self.processes != self.rank).any())

    def axis_devices(self, axis: str) -> AxisDevices:
        """The devices along ``axis`` through this process's first position
        (index 0 of every other axis in a mesh of one process): where a
        body over that axis runs (the other axes hold its replicas)."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes {list(self.axis_names)})")
        index = list(np.argwhere(self.processes == self.rank)[0])
        index[self.axis_names.index(axis)] = slice(None)
        return AxisDevices(self.devices[tuple(index)], self.processes[tuple(index)], self.rank)

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

    @property
    def addressable_shards(self) -> List[Tuple[int, torch.Tensor]]:
        """``(i, block)`` of the blocks this process holds (JAX's
        ``addressable_shards``): all of them unless the axis spans
        processes."""
        return [(i, s) for i, s in enumerate(self.shards) if s.device != REMOTE]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: shard 0's); every block
        must be this process's."""
        if len(self.addressable_shards) != len(self.shards):
            raise ValueError("blocks of this tensor lie in other processes: gather them "
                             "with all_gather")
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
#
# ``devices`` is the axis' device list; an :class:`AxisDevices` whose
# positions lie in several processes routes the blocks between processes
# through the default process group, which every process of the mesh must
# call the collective in, in the same order. A block of another process is
# a ``meta`` tensor: its shape and dtype size what is received.


def _check_group(processes) -> None:
    """Positions of several processes need the default process group to be
    exactly their ranks."""
    ranks = sorted(set(int(p) for p in processes))
    if not dist.is_initialized() or ranks != list(range(dist.get_world_size())):
        raise ValueError(f"a collective over processes {ranks} needs a process group of "
                         "exactly those ranks (multihost.initialize)")


def _ranks(devices) -> Optional[List[int]]:
    """The owner of each position when ``devices`` spans processes, else
    None (every block is this process's)."""
    procs = getattr(devices, "processes", None)
    if procs is None or all(p == devices.rank for p in procs):
        return None
    _check_group(procs)
    return procs


def _remote_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=REMOTE)


def _local_device(devices, ranks: List[int]) -> torch.device:
    """The device of this process's first position on the axis."""
    return devices[ranks.index(devices.rank)]


def ppermute(shards: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s block for each
    ``(src, dst)`` of ``perm``; a shard that receives nothing gets zeros.
    Across processes a block is one send and one receive
    (``batch_isend_irecv``, tagged by its place in ``perm``)."""
    ranks = _ranks(devices)
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    ops = []
    for tag, (src, dst) in enumerate(perm):
        if ranks is None or ranks[src] == ranks[dst]:
            out[dst] = (move(shards[src], devices[dst]) if ranks is None or devices.local(dst)
                        else _remote_like(shards[src]))
        elif devices.local(src):
            ops.append(dist.P2POp(dist.isend, shards[src].contiguous(), ranks[dst], tag=tag))
        elif devices.local(dst):
            out[dst] = torch.empty(shards[src].shape, dtype=shards[src].dtype,
                                   device=devices[dst])
            ops.append(dist.P2POp(dist.irecv, out[dst], ranks[src], tag=tag))
        else:
            out[dst] = _remote_like(shards[src])
    for request in dist.batch_isend_irecv(ops) if ops else ():
        request.wait()
    return [torch.zeros_like(s) if o is None else o for o, s in zip(out, shards)]


def all_to_all(shards: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)``: each shard's block is cut in n
    along ``split_axis``; shard j receives piece j of every shard,
    concatenated along ``concat_axis`` in shard order. Across processes
    the pieces travel in one ``all_to_all_single``, each process's pieces
    for another packed in (receiver, sender) position order."""
    n = len(shards)
    for s in shards:
        if s.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {list(s.shape)} must divide "
                             f"by {n} shards")
    pieces = [torch.chunk(s, n, split_axis) for s in shards]
    ranks = _ranks(devices)
    if ranks is None:
        return [torch.cat([move(pieces[i][j], devices[j]) for i in range(n)],
                          concat_axis) for j in range(n)]
    rank, world = devices.rank, dist.get_world_size()
    home = _local_device(devices, ranks)

    def pairs(src_rank, dst_rank):  # (sender i, receiver j), receiver-major
        return [(i, j) for j in range(n) if ranks[j] == dst_rank
                for i in range(n) if ranks[i] == src_rank]

    send = [[pieces[i][j] for i, j in pairs(rank, q)] if q != rank else [] for q in range(world)]
    recv_pairs = [pairs(q, rank) if q != rank else [] for q in range(world)]
    flat_in = torch.cat([move(t.reshape(-1), home) for ts in send for t in ts]
                        or [torch.empty(0, dtype=shards[0].dtype, device=home)])
    out_sizes = [sum(pieces[i][j].numel() for i, j in ps) for ps in recv_pairs]
    flat_out = torch.empty(sum(out_sizes), dtype=shards[0].dtype, device=home)
    dist.all_to_all_single(flat_out, flat_in, out_sizes,
                           [sum(t.numel() for t in ts) for ts in send])
    got: Dict[Tuple[int, int], torch.Tensor] = {}
    offset = 0
    for ps in recv_pairs:
        for i, j in ps:
            size = pieces[i][j].numel()
            got[i, j] = flat_out[offset:offset + size].view(pieces[i][j].shape)
            offset += size
    return [torch.cat([move(got.get((i, j), pieces[i][j]), devices[j]) if devices.local(j)
                       else pieces[i][j].to(REMOTE) for i in range(n)], concat_axis)
            for j in range(n)]


def all_gather(shards: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard receives the blocks concatenated along ``dim``; shards of
    one device share one copy. Across processes each process's blocks
    travel in one ``all_gather`` (padded to the largest process's)."""
    ranks = _ranks(devices)
    blocks = list(shards)
    if ranks is not None:
        world = dist.get_world_size()
        home = _local_device(devices, ranks)
        sizes = [sum(blocks[i].numel() for i in range(len(blocks)) if ranks[i] == q)
                 for q in range(world)]
        mine = [move(blocks[i].reshape(-1), home) for i in range(len(blocks))
                if devices.local(i)]
        padded = torch.zeros(max(sizes), dtype=blocks[0].dtype, device=home)
        padded[:sizes[devices.rank]] = torch.cat(mine)
        parts = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(parts, padded)
        offsets = [0] * world
        for i, b in enumerate(blocks):
            q = ranks[i]
            blocks[i] = parts[q][offsets[q]:offsets[q] + b.numel()].view(b.shape)
            offsets[q] += b.numel()
    gathered: Dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in gathered:
            gathered[dev] = torch.cat([b.to(REMOTE) if dev == REMOTE else move(b, dev)
                                       for b in blocks], dim)
    return [gathered[dev] for dev in devices]


def psum(values, axes, mesh: Mesh) -> np.ndarray:
    """``lax.psum`` over the named ``axes``: ``values`` holds one tensor a
    mesh position (nested lists or an object array of the mesh's shape; a
    position of another process may hold anything, a ``meta`` tensor by
    convention). Returns an object array of the same shape whose every
    position holds the sum over its group (the positions that differ only
    along ``axes``) on its device, :data:`REMOTE` for another process's.
    Across processes every group's partial sum goes into one
    ``all_reduce``, zeros where this process holds none of the group."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for axis in axes:
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes {list(mesh.axis_names)})")
    grid = np.empty(mesh.devices.shape, dtype=object)
    for index in np.ndindex(grid.shape):
        value = values
        for k in index:
            value = value[k]
        grid[index] = value
    mine = [index for index in np.ndindex(grid.shape) if mesh.processes[index] == mesh.rank]
    like = grid[mine[0]]
    home = mesh.devices[mine[0]]
    keep = [k for k, name in enumerate(mesh.axis_names) if name not in axes]

    def group(index):
        return tuple(index[k] for k in keep)

    keys = sorted({group(index) for index in np.ndindex(grid.shape)})
    partial = {key: torch.zeros(like.shape, dtype=like.dtype, device=home) for key in keys}
    for index in mine:
        partial[group(index)] = partial[group(index)] + move(grid[index], home)
    if mesh.spans_processes:
        _check_group(mesh.processes.flat)
        stacked = torch.stack([partial[key] for key in keys])
        dist.all_reduce(stacked)
        partial = dict(zip(keys, stacked.unbind(0)))
    out = np.empty(grid.shape, dtype=object)
    for index in np.ndindex(grid.shape):
        total = partial[group(index)]
        out[index] = (move(total, mesh.devices[index]) if mesh.processes[index] == mesh.rank
                      else _remote_like(total))
    return out


# -- tensor- and data-parallel placement ---------------------------------------


def _tree_map(fn: Callable[[Any], Any], tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaf(t: torch.Tensor, requires_grad: bool) -> torch.Tensor:
    """``t`` as a leaf tensor of its own when it must be trained (a block of
    a leaf is a view, and a moved leaf a copy in its graph)."""
    if not requires_grad:
        return t
    return t.detach().clone().requires_grad_(True)


def shard_params(params, mesh: Mesh):
    """Place a parameter tree (dicts, lists and tuples of tensors or numpy
    arrays) on the mesh, by JAX's rule: the last (output-feature) axis of
    each tensor of two or more dims is split over ``model`` when it divides
    (a :class:`Sharded`); every other leaf is replicated, one copy on the
    axis' first device. A tensor that requires grad gives leaf tensors of
    its own that require grad (each block, or the copy), so that an
    optimizer over :func:`train_leaves` sees every shard."""
    devices = mesh.axis_devices("model")

    def place(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.array(leaf))
        if not isinstance(leaf, torch.Tensor):
            return leaf
        grad = leaf.requires_grad
        if leaf.ndim >= 2 and leaf.shape[-1] % len(devices) == 0:
            placed = split(leaf.detach(), devices, leaf.ndim - 1)
            placed.shards = [_leaf(s, grad) for s in placed.shards]
            return placed
        moved = leaf.to(devices[0])
        return moved if moved is leaf else _leaf(moved, grad)

    return _tree_map(place, params)


def train_leaves(params) -> List[torch.Tensor]:
    """Every tensor of a parameter tree that requires grad, a
    :class:`Sharded` leaf's blocks each, in tree order."""
    out: List[torch.Tensor] = []

    def visit(leaf):
        for t in leaf.shards if isinstance(leaf, Sharded) else [leaf]:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                out.append(t)
        return leaf

    _tree_map(visit, params)
    return out


def sharded_forward(module_apply: Callable[[Any, torch.Tensor], torch.Tensor], mesh: Mesh):
    """``run(params, batch)``: the batch split over ``data`` (dim 0), each
    block moved to its data shard's device and passed to
    ``module_apply(params, block)``, the outputs concatenated on the first
    data shard's device. Parameters stay where :func:`shard_params` (or the
    model) put them."""
    rows = mesh.axis_devices("data")

    def run(params, batch: torch.Tensor) -> torch.Tensor:
        outs = [module_apply(params, block) for block in split(batch, rows, 0).shards]
        return Sharded(outs, 0).full(rows[0])

    return run


def sharded_train_step(module_apply: Callable[[Any, torch.Tensor], torch.Tensor],
                       optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                       mesh: Mesh):
    """The dp + tp training step of ``client_tpu.parallel.sharded_train_step``.

    ``module_apply(params, images)`` gives logits; ``optimizer`` builds a
    ``torch.optim`` optimizer over a list of leaves (the port's
    ``optax.sgd(1e-3)`` is ``functools.partial(torch.optim.SGD, lr=1e-3)``).
    Returns ``run(params, opt_state, images, labels) -> (params, opt_state,
    loss)``: ``opt_state`` is None on the first step (the optimizer is built
    over :func:`train_leaves`) and the optimizer it returned after.

    The loss is the mean over the global batch of the cross-entropy of
    ``log_softmax`` of the fp32 logits. The batch is split over ``data``
    (dim 0, equal rows) and this process runs its own rows: each row's mean
    loss, divided by the data axis' size, takes its backward at once, so
    the rows' gradients accumulate on the shared leaves into their average.
    When ``data`` spans processes, one ``all_reduce`` (a sum) a leaf adds
    the other processes' rows, and one more the loss. The update is in
    place. ``model`` must lie within each process (``multihost.global_mesh``
    puts it there)."""
    model = mesh.axis_devices("model")
    if any(p != model.rank for p in model.processes):
        raise ValueError("the model axis spans processes: the training step needs each "
                         "process's model shards in that process")
    rows = mesh.axis_devices("data")
    across = _ranks(rows) is not None
    mine = [i for i in range(len(rows)) if not across or rows.local(i)]

    def run(params, opt_state, images: torch.Tensor, labels: torch.Tensor):
        if images.shape[0] % len(rows):
            raise ValueError(f"global batch {images.shape[0]} must divide by the data "
                             f"axis ({len(rows)})")
        leaves = train_leaves(params)
        opt = opt_state if opt_state is not None else optimizer(leaves)
        opt.zero_grad(set_to_none=True)
        image_blocks = torch.chunk(images, len(rows), 0)
        label_blocks = torch.chunk(labels, len(rows), 0)
        total = None
        for i in mine:
            logits = module_apply(params, move(image_blocks[i], rows[i]))
            logp = torch.log_softmax(logits.float(), dim=-1)
            target = move(label_blocks[i], logp.device).long()
            loss = -logp.gather(1, target[:, None]).mean() / len(rows)
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + move(loss, total.device)
        if across:
            for leaf in leaves:
                if leaf.grad is None:
                    leaf.grad = torch.zeros_like(leaf)
                dist.all_reduce(leaf.grad)
            dist.all_reduce(total)
        opt.step()
        return params, opt, total

    return run


__all__ = [
    "AxisDevices",
    "CPU_DEVICES",
    "Mesh",
    "REMOTE",
    "Sharded",
    "all_gather",
    "all_to_all",
    "local_devices",
    "make_mesh",
    "move",
    "ppermute",
    "process_count",
    "process_index",
    "psum",
    "shard_params",
    "sharded_forward",
    "sharded_train_step",
    "shards_of",
    "split",
    "take_devices",
    "train_leaves",
]
