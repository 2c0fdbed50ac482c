"""Multi-process runtime: the process group and the meshes that span it.

The counterpart of ``client_tpu.parallel.multihost`` on ``torch.distributed``.
Every process calls :func:`initialize`, which joins one process group: NCCL
for the card (one rank a card: NCCL puts no two ranks on one card), gloo
for the CPU. :func:`global_mesh` and :func:`hybrid_mesh` then lay every
process's devices out in one :class:`~client_tpu_torch.parallel.Mesh`,
process-major, and the collectives of :mod:`client_tpu_torch.parallel`
carry the blocks between processes through the group. As in JAX, the
data-parallel axes go outermost, so that only gradient-sized traffic
crosses processes and the tensor-parallel collectives stay in one.

One launcher serves both packages: the coordinator, the process count and
the process id come from the arguments or from ``CLIENT_TPU_COORDINATOR``
(``host:port`` of rank 0), ``CLIENT_TPU_NPROCS`` and ``CLIENT_TPU_PROC_ID``.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import CPU_DEVICES, REMOTE, Mesh, process_count, process_index

# what initialize() chose: the device type and this process's device ids
_LOCAL: dict = {}


def free_address() -> str:
    """``127.0.0.1:PORT`` of a free local port, for a coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, device="cuda") -> None:
    """Join (or form) the process group. Idempotent: a second call is a
    no-op.

    The arguments default to ``CLIENT_TPU_COORDINATOR`` /
    ``CLIENT_TPU_NPROCS`` / ``CLIENT_TPU_PROC_ID``; with neither, a group of
    one process on a free local port. ``device="cuda"``: NCCL, this rank on
    card ``local_device_ids[process_id % len(local_device_ids)]`` (default:
    every visible card), the process's one mesh device; it raises where
    there is no card and never falls back to gloo. ``device="cpu"``: gloo,
    and ``len(local_device_ids)`` mesh positions on the CPU (default
    :data:`~client_tpu_torch.parallel.CPU_DEVICES`)."""
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process group for devices of type {kind!r} (cuda or cpu)")
    coordinator_address = coordinator_address or os.environ.get("CLIENT_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("CLIENT_TPU_NPROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("CLIENT_TPU_PROC_ID", "0"))
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a coordinator_address "
                             "(or CLIENT_TPU_COORDINATOR)")
        coordinator_address = free_address()
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') needs a CUDA device")
        ids = list(local_device_ids if local_device_ids is not None
                   else range(torch.cuda.device_count()))
        ids = [ids[process_id % len(ids)]]
        torch.cuda.set_device(ids[0])
        backend = "nccl"
    else:
        ids = list(local_device_ids if local_device_ids is not None else range(CPU_DEVICES))
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _LOCAL.update(kind=kind, ids=ids)


def _process_devices(device) -> List[torch.device]:
    """This process's mesh devices of type ``device``."""
    kind = torch.device(device).type
    if not _LOCAL:
        from . import local_devices

        return local_devices(kind)
    if _LOCAL["kind"] != kind:
        raise ValueError(f"the process group was initialised for {_LOCAL['kind']}, "
                         f"not {kind}")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in _LOCAL["ids"]]
    return [torch.device("cpu")] * len(_LOCAL["ids"])


def _global_devices(device) -> Tuple[List[torch.device], List[int]]:
    """Every process's devices in process-major order (another process's as
    :data:`REMOTE`) and the rank owning each."""
    mine = _process_devices(device)
    counts = [len(mine)]
    if process_count() > 1:
        counts = [None] * process_count()
        dist.all_gather_object(counts, len(mine))
    devices, owners = [], []
    for rank, count in enumerate(counts):
        devices += mine if rank == process_index() else [REMOTE] * count
        owners += [rank] * count
    return devices, owners


def global_mesh(axis_names: Tuple[str, str] = ("data", "model"),
                data_parallel: Optional[int] = None, device="cuda") -> Mesh:
    """A 2-D mesh over every process's devices. The ``data`` axis defaults
    to the number of processes, so each process's devices lie along
    ``model``; ``data_parallel`` overrides it when a process's devices
    should split across both axes."""
    devices, owners = _global_devices(device)
    n = len(devices)
    dp = data_parallel or max(process_count(), 1)
    if n % dp != 0:
        raise ValueError(f"{n} global devices do not divide into data_parallel={dp}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, n // dp), axis_names,
                processes=np.asarray(owners).reshape(dp, n // dp))


def hybrid_mesh(dcn_axes: Tuple[int, ...], ici_axes: Tuple[int, ...],
                axis_names: Tuple[str, ...], device="cuda") -> Mesh:
    """The axes that cross processes (``dcn_axes``) outermost, then the
    axes within one (``ici_axes``): JAX's off-TPU layout, a process-major
    reshape of every process's devices."""
    shape = tuple(dcn_axes) + tuple(ici_axes)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} axis sizes vs {len(axis_names)} names")
    devices, owners = _global_devices(device)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} devices, "
                         f"have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names, processes=np.asarray(owners).reshape(shape))


def process_local_batch(global_batch: int) -> int:
    """This process's share of a global batch (data split over processes)."""
    count = max(process_count(), 1)
    if global_batch % count != 0:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{count} processes")
    return global_batch // count


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL.clear()


__all__ = ["free_address", "global_mesh", "hybrid_mesh", "initialize", "process_local_batch",
           "shutdown"]
