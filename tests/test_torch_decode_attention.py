"""The port's decode attention against the JAX package's.

``client_tpu_torch.ops.decode_attention`` launches a CUDA kernel for CUDA
tensors and computes its plain PyTorch version for CPU tensors. Here, on the
CPU, the plain version is held against the JAX Pallas kernel (interpret mode
off-TPU, as the JAX package's own tests run it) and against the JAX dense
reference on the same numpy-seeded inputs, at the reference test's shapes
and tolerances (1e-5 in fp32, 2e-2 in bf16). The kernel itself runs on the
card only (chip_smoke.py). The wrapper's argument checks, the build step
and the import without a compiler are tested here too.
"""

import os
import stat
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from client_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_reference as jax_reference,
)
from client_tpu_torch.ops import _kernels
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.utils import numpy_to_tensor

REPO = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [  # (batch, heads, max_len, dim, the reference test's positions)
    (1, 4, 128, 32, [5]),
    (3, 2, 200, 64, [0, 99, 199]),
    (2, 8, 384, 128, [100, 383]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(batch, heads, max_len, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((batch, heads, dim), (batch, heads, max_len, dim),
                        (batch, heads, max_len, dim))]
    if dtype == "bfloat16":
        arrays = [a.astype(ml_dtypes.bfloat16) for a in arrays]
    return arrays


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["zero", "last", "mixed"])
@pytest.mark.parametrize("batch,heads,max_len,dim,mixed", SHAPES,
                         ids=["fixture", "ragged", "multiblock"])
def test_plain_matches_pallas_and_reference(batch, heads, max_len, dim, mixed, which, dtype):
    positions = {"zero": [0] * batch, "last": [max_len - 1] * batch, "mixed": mixed}[which]
    q, k, v = _inputs(batch, heads, max_len, dim, dtype, seed=max_len)
    pos = np.asarray(positions, np.int32)

    out = da.decode_attention(*(numpy_to_tensor(a, "cpu") for a in (q, k, v)),
                              torch.from_numpy(pos))
    assert out.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert out.shape == (batch, heads, dim)
    jq, jk, jv, jpos = (jnp.asarray(a) for a in (q, k, v, pos))
    pallas = jax_decode_attention(jq, jk, jv, jpos)
    dense = jax_reference(jq, jk, jv, jpos)
    assert np.max(np.abs(_f32(out) - _f32(pallas))) < TOL[dtype]
    assert np.max(np.abs(_f32(out) - _f32(dense))) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_tail_is_ignored(dtype):
    """Junk in unwritten cache slots (> pos) must not leak into the output."""
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs(1, 2, 96, 32, dtype, seed=3))
    pos = torch.tensor([40], dtype=torch.int32)
    base = da.decode_attention(q, k, v, pos)
    k_junk, v_junk = k.clone(), v.clone()
    k_junk[:, :, 41:] = 1e6
    v_junk[:, :, 41:] = -1e6
    junk = da.decode_attention(q, k_junk, v_junk, pos)
    np.testing.assert_allclose(_f32(base), _f32(junk), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pos_zero_attends_single_slot(dtype):
    """pos=0 reduces to 'output = v[:, :, 0]' (softmax over one slot)."""
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs(1, 2, 64, 32, dtype, seed=2))
    out = da.decode_attention(q, k, v, torch.zeros(1, dtype=torch.int32))
    np.testing.assert_allclose(_f32(out), _f32(v[:, :, 0]), rtol=1e-5, atol=1e-6)


def _good(batch=2, heads=4, max_len=16, dim=32, dtype=torch.float32):
    return (torch.zeros(batch, heads, dim, dtype=dtype),
            torch.zeros(batch, heads, max_len, dim, dtype=dtype),
            torch.zeros(batch, heads, max_len, dim, dtype=dtype),
            torch.zeros(batch, dtype=torch.int32))


def _bad_case(name):
    q, k, v, pos = _good()
    if name == "fp16":
        return (*(t.half() for t in (q, k, v)), pos), TypeError
    if name == "int32_q":
        return (q.int(), k, v, pos), TypeError
    if name == "mixed_dtypes":
        return (q, k.bfloat16(), v, pos), TypeError
    if name == "int64_pos":
        return (q, k, v, pos.long()), TypeError
    if name.startswith("dim"):
        dim = int(name[3:])
        return _good(dim=dim), ValueError
    if name == "head_mismatch":
        return (q, k[:, :2].contiguous(), v[:, :2].contiguous(), pos), ValueError
    if name == "kv_shape_mismatch":
        return (q, k, v[:, :, :8].contiguous(), pos), ValueError
    if name == "pos_shape":
        return (q, k, v, torch.zeros(3, dtype=torch.int32)), ValueError
    if name == "q_rank":
        return (q[None], k, v, pos), ValueError
    if name == "empty_cache":
        return (q, k[:, :, :0], v[:, :, :0], pos), ValueError
    if name == "non_contiguous":
        return (q, k.transpose(2, 3).contiguous().transpose(2, 3), v, pos), ValueError
    if name == "meta_device":
        return tuple(t.to("meta") for t in (q, k, v, pos)), ValueError
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "fp16", "int32_q", "mixed_dtypes", "int64_pos", "dim16", "dim48", "dim256",
    "head_mismatch", "kv_shape_mismatch", "pos_shape", "q_rank", "empty_cache",
    "non_contiguous", "meta_device",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    args, exc = _bad_case(name)
    with pytest.raises(exc):
        da.decode_attention(*args)


@pytest.mark.parametrize("dim", da.SUPPORTED_DIMS)
def test_cpu_path_is_the_plain_version_and_launches_nothing(dim):
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs(2, 2, 40, dim, "float32", seed=dim))
    pos = torch.tensor([3, 39], dtype=torch.int32)
    before = da.LAUNCHES.count
    out = da.decode_attention(q, k, v, pos)
    assert torch.equal(out, da.decode_attention_reference(q, k, v, pos))
    assert da.LAUNCHES.count == before
    assert "decode_attention" not in _kernels.loaded()


def test_module_imports_without_a_compiler(tmp_path):
    """No nvcc on PATH: the module imports and the CPU path runs."""
    script = (
        "import torch\n"
        "from client_tpu_torch.ops import _kernels, decode_attention as da\n"
        "q = torch.ones(1, 1, 32); k = torch.ones(1, 1, 4, 32)\n"
        "out = da.decode_attention(q, k, k, torch.zeros(1, dtype=torch.int32))\n"
        "assert torch.equal(out, q) and _kernels.loaded() == []\n"
        "try:\n"
        "    _kernels.nvcc()\n"
        "    print('HAS_NVCC')\n"
        "except RuntimeError:\n"
        "    print('NO_NVCC')\n"
        "print('IMPORT_OK')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORT_OK" in proc.stdout
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        assert "NO_NVCC" in proc.stdout


def _fake_compiler(tmp_path, body):
    path = tmp_path / "fake_nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_all_runs_one_compiler_per_source(tmp_path, monkeypatch):
    # writes the -o target and reports like ptxas; the build moves it in place
    fake = _fake_compiler(tmp_path, (
        'while [ "$1" != "-o" ]; do shift; done; touch "$2"; '
        'echo "ptxas info    : Used 40 registers"\n'))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "nvcc", lambda: fake)
    logs = _kernels.build_all()
    assert set(logs) == set(_kernels.sources()) == {
        "decode_attention", "flash_attention", "normalize_image", "quantize_int8", "softmax"}
    for name in logs:
        assert "registers" in logs[name]
        target = _kernels.library_path(name)
        assert target.exists() and target.parent == tmp_path / "build"
    assert "sm_90a" in " ".join(_kernels.NVCC_FLAGS)
    assert _kernels.build_all() == {}  # up to date: nothing rebuilds


def test_build_all_raises_on_a_failed_compile(tmp_path, monkeypatch):
    fake = _fake_compiler(tmp_path, 'echo "error: no such intrinsic"; exit 2\n')
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "nvcc", lambda: fake)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _kernels.build_all()
    assert list((tmp_path / "build").iterdir()) == []
