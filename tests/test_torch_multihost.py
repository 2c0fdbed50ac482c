"""``client_tpu_torch.parallel.multihost`` against ``client_tpu.parallel.multihost``.

Two real OS processes, each with four CPU mesh positions, join one gloo
process group through the ``CLIENT_TPU_*`` variables and run
``python -m client_tpu_torch.parallel.multihost_check``: the five checks of
tests/test_multihost.py at its tolerances (psum over both axes, the
data-parallel global sum, the data-parallel step against numpy at rtol
2e-4, ring and Ulysses with the sequence across the processes at rtol 2e-4,
atol 2e-5), plus ``sharded_train_step`` across the processes against the
one-process full-batch step. Each worker asserts them itself and writes
what it computed; this file then holds those results against the JAX
package on the same numpy inputs. Every wait has JAX's 180 s limit.

In one process (no group): ``global_mesh``, ``hybrid_mesh`` and
``process_local_batch`` against JAX's on its eight virtual devices, with
JAX's errors, and ``initialize(device="cuda")`` raising where there is no
card.
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from client_tpu.parallel import make_mesh as jax_make_mesh
from client_tpu.parallel import multihost as jax_multihost
from client_tpu.parallel import ring as jax_ring
from client_tpu.parallel import sharded_train_step as jax_train_step
from client_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parent.parent
NPROCS, LOCAL = 2, 4
WAIT_S = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    """Run the two workers once; their per-rank results."""
    out = tmp_path_factory.mktemp("multihost")
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("CLIENT_TPU_")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.parallel.multihost_check", "--device", "cpu",
         "--local-devices", str(LOCAL), "--out", str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, CLIENT_TPU_COORDINATOR=coord, CLIENT_TPU_NPROCS=str(NPROCS),
                 CLIENT_TPU_PROC_ID=str(i), OMP_NUM_THREADS="1"))
        for i in range(NPROCS)]
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=WAIT_S)
            outs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=WAIT_S)
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{text[-3000:]}"
        assert f"WORKER_OK {i} world={NPROCS} backend=gloo" in text, text[-3000:]
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(NPROCS)]


def test_workers_pass_the_five_checks(worker_results):
    """Both ranks ran every check (each asserted in the worker) and agree on
    the psum, the global sum and the two steps."""
    for key in ("psum", "global_sum", "dp_step", "train_step", "train_loss"):
        np.testing.assert_array_equal(worker_results[0][key], worker_results[1][key])
    np.testing.assert_allclose(worker_results[0]["psum"], np.arange(8.0), rtol=1e-6)


def test_dp_step_equals_numpy_full_batch(worker_results):
    """Check 3 of the JAX test: the updated weights equal the full-batch
    numpy step on every rank (rtol 2e-4)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((16, 4)).astype(np.float32)
    full = np.arange(8 * NPROCS * 16, dtype=np.float32).reshape(8 * NPROCS, 16)
    targets = rng.standard_normal((full.shape[0], 4)).astype(np.float32)
    grad = 2.0 * full.T @ (full @ w0 - targets) / (full.shape[0] * 4)
    for res in worker_results:
        np.testing.assert_allclose(res["dp_step"], w0 - 0.1 * grad, rtol=2e-4)
        np.testing.assert_allclose(float(res["global_sum"]), float(full.sum()), rtol=1e-5)


def test_train_step_across_processes_equals_jax(worker_results):
    """The port's ``sharded_train_step`` over two processes (batch split over
    them, classes over each one's four model shards) against JAX's
    ``sharded_train_step`` on its eight devices, same numpy inputs."""
    rng = np.random.default_rng(0)
    rng.standard_normal((16, 4))
    full = np.arange(8 * NPROCS * 16, dtype=np.float32).reshape(8 * NPROCS, 16)
    rng.standard_normal((full.shape[0], 4))
    classes = 4 * LOCAL
    wc = rng.standard_normal((16, classes)).astype(np.float32) * np.float32(0.1)
    labels = rng.integers(0, classes, full.shape[0])
    opt = optax.sgd(0.1)
    params = {"w": jnp.asarray(wc)}
    step = jax_train_step(lambda p, x: x @ p["w"], opt, jax_make_mesh(8))
    new, _, loss = step(params, opt.init(params), jnp.asarray(full / full.size),
                        jnp.asarray(labels, jnp.int32))
    for res in worker_results:
        np.testing.assert_allclose(res["train_step"], np.asarray(new["w"]), rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(float(res["train_loss"]), float(loss), rtol=2e-5)


@pytest.mark.parametrize("name,heads", [("ring", 2), ("ulysses", LOCAL * NPROCS)])
def test_sequence_across_processes_equals_jax(worker_results, name, heads):
    """Checks 4 and 5: every block each rank holds against JAX's dense
    ``full_attention`` on the same numpy q, k, v (rtol 2e-4, atol 2e-5);
    together the ranks hold every block."""
    rng2 = np.random.default_rng(7)
    draws = {}
    for kind, h in (("ring", 2), ("ulysses", LOCAL * NPROCS)):
        shape = (1, 8 * NPROCS * LOCAL, h, 8)
        draws[kind] = [rng2.standard_normal(shape).astype(np.float32) for _ in range(3)]
    q, k, v = draws[name]
    ref = np.asarray(jax_ring.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    seen = []
    for rank, res in enumerate(worker_results):
        keys = sorted((int(key.split("_")[1]), int(key.split("_")[2])) for key in res
                      if key.startswith(name + "_"))
        assert len(keys) == LOCAL, keys
        for lo, hi in keys:
            np.testing.assert_allclose(res[f"{name}_{lo}_{hi}"], ref[:, lo:hi], rtol=2e-4,
                                       atol=2e-5)
        seen += keys
    assert sorted(seen) == [(i * 8, (i + 1) * 8) for i in range(NPROCS * LOCAL)]
    assert q.shape[2] == heads


def test_one_process_meshes_equal_jax():
    """With no group: JAX's eight virtual devices against the port's eight
    CPU positions: the same shapes and the same errors."""
    assert multihost.global_mesh(device="cpu").devices.shape == \
        jax_multihost.global_mesh().devices.shape == (1, 8)
    assert multihost.global_mesh(data_parallel=2, device="cpu").devices.shape == (2, 4)
    with pytest.raises(ValueError) as ours:
        multihost.global_mesh(data_parallel=3, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_multihost.global_mesh(data_parallel=3)
    assert str(ours.value) == str(theirs.value)
    mesh = multihost.hybrid_mesh((2,), (4,), ("data", "model"), device="cpu")
    assert mesh.devices.shape == jax_multihost.hybrid_mesh((2,), (4,), ("data", "model")) \
        .devices.shape == (2, 4)
    assert not mesh.spans_processes
    for args in (((2,), (4,), ("data",)), ((2,), (2,), ("data", "model"))):
        with pytest.raises(ValueError) as ours:
            multihost.hybrid_mesh(*args, device="cpu")
        with pytest.raises(ValueError) as theirs:
            jax_multihost.hybrid_mesh(*args)
        assert str(ours.value) == str(theirs.value)
    assert multihost.process_local_batch(8) == jax_multihost.process_local_batch(8) == 8


def test_initialize_cuda_raises_without_a_card(monkeypatch):
    """No fallback: NCCL on a host with no card raises and forms no group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        multihost.initialize(coordinator_address="127.0.0.1:1", num_processes=1,
                             process_id=0, device="cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")


def test_process_group_needs_the_whole_world():
    """A mesh naming another process, in a process with no group, cannot
    carry a collective: the error names multihost.initialize."""
    from client_tpu_torch import parallel

    mesh = parallel.Mesh([["cpu", "meta"]], ("data", "model"), processes=[[0, 1]])
    assert mesh.spans_processes
    devices = mesh.axis_devices("model")
    with pytest.raises(ValueError, match="multihost.initialize"):
        parallel.ppermute([torch.zeros(2), torch.empty(2, device="meta")], [(0, 1)], devices)
    step = functools.partial(parallel.sharded_train_step, lambda p, x: x, None)
    with pytest.raises(ValueError, match="model axis spans processes"):
        step(mesh)
