"""The cross-process checks of the multihost runtime, one process of many.

The port's run of the JAX package's two-process test (a global mesh, psum,
a data-parallel step, ring and Ulysses with the sequence across processes),
plus :func:`~client_tpu_torch.parallel.sharded_train_step` across processes.
Launch one process a rank through the ``CLIENT_TPU_*`` variables::

    CLIENT_TPU_COORDINATOR=127.0.0.1:29500 CLIENT_TPU_NPROCS=2 CLIENT_TPU_PROC_ID=0 \\
        python -m client_tpu_torch.parallel.multihost_check --device cpu --local-devices 4 &
    CLIENT_TPU_COORDINATOR=127.0.0.1:29500 CLIENT_TPU_NPROCS=2 CLIENT_TPU_PROC_ID=1 \\
        python -m client_tpu_torch.parallel.multihost_check --device cpu --local-devices 4

Each process prints ``WORKER_OK <rank>`` when every check held; ``--out DIR``
also writes its results to ``DIR/rank<rank>.npz``. On one card:
``python -m client_tpu_torch.parallel.multihost_check`` (NCCL at world size
one).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from . import (REMOTE, Mesh, all_gather, multihost, process_count, process_index, psum,
               shard_params, sharded_train_step, split)
from .ring import full_attention, place_sharded, ring_attention
from .ulysses import ulysses_attention

LR = 0.1


def _values(mesh: Mesh, local_value) -> list:
    """One value a mesh position: ``local_value(index)`` for this process's
    positions, a ``meta`` scalar for another's."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for index in np.ndindex(out.shape):
        out[index] = (local_value(index) if mesh.processes[index] == mesh.rank
                      else torch.empty((), device=REMOTE))
    return out


def _local(sharded, seq: int):
    """(lo, hi, block) of the sequence blocks this process holds."""
    n = len(sharded.shards)
    per = seq // n
    return [(i * per, (i + 1) * per, block) for i, block in sharded.addressable_shards]


def run_checks(device: str) -> Dict[str, np.ndarray]:
    """The checks, each asserted here at the JAX test's tolerance; returns
    what this process computed, for a caller to hold against the JAX
    package."""
    nprocs, rank = process_count(), process_index()
    mesh = multihost.global_mesh(("data", "model"), device=device)
    local_n = mesh.shape["model"]
    assert tuple(mesh.devices.shape) == (nprocs, local_n), mesh
    results: Dict[str, np.ndarray] = {}
    home = mesh.devices[np.argwhere(mesh.processes == rank)[0][0], 0]

    # the process group itself carries a sum (NCCL on the card, gloo here)
    ones = torch.ones(1, device=home)
    dist.all_reduce(ones)
    assert float(ones) == nprocs, float(ones)

    # 1) psum over both axes
    x = torch.arange(8.0, device=home)
    total = psum(_values(mesh, lambda index: x.to(mesh.devices[index])), ("data", "model"), mesh)
    for index in np.ndindex(total.shape):
        if mesh.processes[index] == rank:
            got = (total[index] / (local_n * nprocs)).cpu().numpy()
            np.testing.assert_allclose(got, np.arange(8.0), rtol=1e-6)
    results["psum"] = got

    # 2) the data-parallel global sum: each process holds its data rows
    assert multihost.process_local_batch(8 * nprocs) == 8
    global_shape = (8 * nprocs, 16)
    full = np.arange(np.prod(global_shape), dtype=np.float32).reshape(global_shape)
    rows = split(torch.from_numpy(full).to(home), mesh.axis_devices("data"), 0)
    sums = psum(_values(mesh, lambda index: rows.shards[index[0]].sum().to(mesh.devices[index])),
                "data", mesh)
    mine = [sums[i] for i in np.ndindex(sums.shape) if mesh.processes[i] == rank]
    np.testing.assert_allclose(float(mine[0]), float(full.sum()), rtol=1e-5)
    results["global_sum"] = np.float64(float(mine[0]))

    # 3) the data-parallel step of the JAX test: each data row's gradient of
    #    its block's mean squared error, psum'd over data; the updated
    #    weights equal the full-batch numpy step
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((16, 4)).astype(np.float32)
    targets = rng.standard_normal((global_shape[0], 4)).astype(np.float32)
    ys = split(torch.from_numpy(targets).to(home), mesh.axis_devices("data"), 0)
    n_rows = mesh.shape["data"]

    def row_grad(index):
        w = torch.from_numpy(w0).to(mesh.devices[index]).requires_grad_(True)
        xb = rows.shards[index[0]].to(mesh.devices[index])
        yb = ys.shards[index[0]].to(mesh.devices[index])
        (grad,) = torch.autograd.grad(torch.mean((xb @ w - yb) ** 2), w)
        return grad / n_rows

    grads = psum(_values(mesh, row_grad), "data", mesh)
    mine = next(grads[i] for i in np.ndindex(grads.shape) if mesh.processes[i] == rank)
    w1 = w0 - LR * mine.cpu().numpy()
    pred = full @ w0
    grad = 2.0 * full.T @ (pred - targets) / (global_shape[0] * 4)
    np.testing.assert_allclose(w1, w0 - LR * grad, rtol=2e-4)
    results["dp_step"] = w1

    # 4) sharded_train_step over the global mesh: a linear classifier with
    #    its classes split over this process's model shards and the batch
    #    over the processes (then, where the devices split, over two rows a
    #    process), against the one-process full-batch step
    classes = 4 * local_n
    wc = rng.standard_normal((16, classes)).astype(np.float32) * np.float32(0.1)
    labels = rng.integers(0, classes, global_shape[0])
    w_ref = torch.from_numpy(wc).requires_grad_(True)
    ref_loss = torch.nn.functional.cross_entropy(torch.from_numpy(full) / full.size @ w_ref,
                                                 torch.from_numpy(labels))
    ref_loss.backward()
    meshes = [mesh] + ([multihost.global_mesh(data_parallel=2 * nprocs, device=device)]
                       if local_n % 2 == 0 else [])
    for train_mesh in meshes:
        params = shard_params({"w": torch.from_numpy(wc).to(home).requires_grad_(True)},
                              train_mesh)
        step = sharded_train_step(lambda p, xb: xb @ p["w"].full(xb.device),
                                  functools.partial(torch.optim.SGD, lr=LR), train_mesh)
        params, _, loss = step(params, None, torch.from_numpy(full).to(home) / full.size,
                               torch.from_numpy(labels).to(home))
        got = params["w"].full("cpu").detach().numpy()
        np.testing.assert_allclose(got, wc - LR * w_ref.grad.numpy(), rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(float(loss), float(ref_loss.detach()), rtol=2e-5)
        if train_mesh is mesh:
            results["train_step"] = got
            results["train_loss"] = np.float64(float(loss))

    # 5) ring attention with the sequence across processes; 6) Ulysses
    seq_mesh = Mesh(mesh.devices.reshape(-1), ("seq",), processes=mesh.processes.reshape(-1))
    rng2 = np.random.default_rng(7)
    for name, heads in (("ring", 2), ("ulysses", local_n * nprocs)):
        shape = (1, 8 * nprocs * local_n, heads, 8)
        qkv = [rng2.standard_normal(shape).astype(np.float32) for _ in range(3)]
        placed = [place_sharded(torch.from_numpy(a).to(home), seq_mesh, "seq") for a in qkv]
        fn = ring_attention if name == "ring" else ulysses_attention
        out = fn(*placed, seq_mesh, axis="seq")
        ref = full_attention(*(torch.from_numpy(a) for a in qkv)).numpy()
        for lo, hi, block in _local(out, shape[1]):
            np.testing.assert_allclose(block.cpu().numpy(), ref[:, lo:hi], rtol=2e-4, atol=2e-5)
            results[f"{name}_{lo}_{hi}"] = block.cpu().numpy()
        # every position gathers the whole output across the processes
        devices = seq_mesh.axis_devices("seq")
        for i, whole in enumerate(all_gather(out.shards, 1, devices)):
            if devices.local(i):
                np.testing.assert_allclose(whole.cpu().numpy(), ref, rtol=2e-4, atol=2e-5)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--local-devices", type=int, default=None,
                        help="mesh positions of this process on the CPU (default 8)")
    parser.add_argument("--out", default=None, help="write rank<N>.npz here")
    args = parser.parse_args(argv)
    ids = None if args.local_devices is None else list(range(args.local_devices))
    t0 = time.perf_counter()
    multihost.initialize(local_device_ids=ids, device=args.device)
    rank = process_index()
    multihost.initialize(process_id=rank + 1, device=args.device)  # a no-op once joined
    assert process_index() == rank
    try:
        results = run_checks(args.device)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.savez(os.path.join(args.out, f"rank{process_index()}.npz"), **results)
        print(f"WORKER_OK {process_index()} world={process_count()} "
              f"backend={dist.get_backend()} seconds={time.perf_counter() - t0:.3f}", flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
