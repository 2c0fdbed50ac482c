"""The port's decode attention against the JAX package's.

``client_tpu_torch.ops.decode_attention`` launches a CUDA kernel for CUDA
tensors and computes its plain PyTorch version for CPU tensors. Here, on the
CPU, the plain version is held against the JAX Pallas kernel (interpret mode
off-TPU, as the JAX package's own tests run it) and against the JAX dense
reference on the same numpy-seeded inputs, at the reference test's shapes
and tolerances (1e-5 in fp32, 2e-2 in bf16), at the head dims and dtypes
the kernel took when it took every float dtype and every head dim up to
256 (D = 8, 24, 80, 96, 256 in fp32, bf16 and fp16), and at head dims past
256 (D = 300, 512) and integer and bool caches at JAX's tiles (block_k 16
and 48), which the kernels take since. The kernels themselves run on the
card only (chip_smoke.py); here the CUDA path is driven up to the launch
with the launch faked, to show which kernel, element code, tile and dim
each dtype and head dim reaches. The wrapper's argument checks, the
reference's ``block_k`` and ``interpret`` keywords, the build step and the
import without a compiler are tested here too.
"""

import ctypes
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
from client_tpu_torch.ops import LaunchCounter, _kernels
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.utils import numpy_to_tensor

REPO = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the head dims of the kernel's first instantiations; the cases over them
# keep their names
DIMS = (32, 64, 128)
# the head dims the kernel took once it took every dim up to 256
NEW_DIMS = (8, 24, 80, 96, 256)
# head dims past 256: past one 16-byte padded width (300 in the split
# kernel's 512) and a padded width itself (512)
WIDE_DIMS = (300, 512)
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
    elif dtype == "float16":
        arrays = [a.astype(np.float16) for a in arrays]
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
    rng = np.random.default_rng(dim)
    return (torch.from_numpy(rng.standard_normal((batch, heads, dim), np.float32)).to(dtype),
            torch.from_numpy(rng.standard_normal((batch, heads, max_len, dim), np.float32)).to(
                dtype),
            torch.from_numpy(rng.standard_normal((batch, heads, max_len, dim), np.float32)).to(
                dtype),
            torch.tensor([3, 15][:batch], dtype=torch.int32))


# the float16 plain version (dense, fp32) against the Pallas kernel, which
# rounds p to float16 before the PV product (2^-11 relative) and its output
# to float16 (half an ulp, as the port does): 3 * 2^-11 * max|v| < 2^-9 * max|v|
FP16_ATOL = 2.0 ** -9


def _bad_case(name):
    """(args, expected): an exception, or "jax" where the JAX function
    computes the case and the port's plain version must agree with it
    (a float16 cache, head dims the kernel does not take)."""
    q, k, v, pos = _good()
    if name == "fp16":
        return (*(t.half() for t in (q, k, v)), pos), "jax"
    if name == "int32_q":
        return (q.int(), k, v, pos), TypeError
    if name == "mixed_dtypes":
        return (q, k.bfloat16(), v, pos), TypeError
    if name == "int64_pos":
        return (q, k, v, pos.long()), TypeError
    if name.startswith("dim"):
        return _good(dim=int(name[3:])), "jax"
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
    """Mixed dtypes, bad shapes, layouts and devices raise, on any device,
    as they fail in JAX. What the kernel once did not take (float16, D =
    16, 48, 256) runs on the card too, as every dtype and head dim does
    now; here the plain version computes it, as the JAX function does, and
    agrees with the Pallas kernel."""
    args, expected = _bad_case(name)
    if expected != "jax":
        with pytest.raises(expected):
            da.decode_attention(*args)
        return
    out = da.decode_attention(*args)
    q, k, v, pos = (a.numpy() for a in args)
    want = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)))
    assert out.dtype == args[0].dtype and out.shape == want.shape
    atol = FP16_ATOL * np.abs(v).max() if name == "fp16" else TOL["float32"]
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=0, atol=atol)


@pytest.mark.parametrize("which", ["zero", "last", "mixed"])
@pytest.mark.parametrize("dim", [16, 8, 48])
def test_plain_matches_pallas_at_head_dims_the_kernel_does_not_take(dim, which):
    """The plain version takes any D, as the JAX function does: D = 16 (and
    8, 48) against the Pallas kernel in interpret mode and the dense JAX
    reference, at the fp32 tolerance."""
    batch, heads, max_len = 3, 2, 200
    positions = {"zero": [0] * batch, "last": [max_len - 1] * batch, "mixed": [0, 99, 199]}[which]
    q, k, v = _inputs(batch, heads, max_len, dim, "float32", seed=dim)
    pos = np.asarray(positions, np.int32)
    out = da.decode_attention(*(numpy_to_tensor(a, "cpu") for a in (q, k, v)),
                              torch.from_numpy(pos))
    assert out.shape == (batch, heads, dim)
    jq, jk, jv, jpos = (jnp.asarray(a) for a in (q, k, v, pos))
    assert np.max(np.abs(_f32(out) - _f32(jax_decode_attention(jq, jk, jv, jpos)))) < TOL[
        "float32"]
    assert np.max(np.abs(_f32(out) - _f32(jax_reference(jq, jk, jv, jpos)))) < TOL["float32"]


@pytest.mark.parametrize("interpret", [None, True, False])
@pytest.mark.parametrize("block_k", [128, 8, 5, 200, True])
def test_block_k_and_interpret_keywords(block_k, interpret):
    """The reference's keywords are accepted; for a float cache the result
    does not depend on them (JAX's own answer at each block_k agrees, in
    interpret mode, the one it takes on the CPU)."""
    q, k, v = _inputs(1, 2, 128, 32, "float32", seed=21)
    pos = np.asarray([100], np.int32)
    args = [numpy_to_tensor(a, "cpu") for a in (q, k, v)] + [torch.from_numpy(pos)]
    out = da.decode_attention(*args, block_k=block_k, interpret=interpret)
    assert torch.equal(out, da.decode_attention(*args))
    want = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)), block_k=block_k,
                                interpret=True)
    assert np.max(np.abs(_f32(out) - _f32(want))) < TOL["float32"]


@pytest.mark.parametrize("block_k", [0, -1, None, 64.0, "128"])
def test_block_k_refused_where_jax_fails(block_k):
    """JAX fails on 0 (a division), on negatives and None (shapes), and on a
    float wherever it sets the tiles; the port checks first."""
    q, k, v, pos = _good()
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, pos, block_k=block_k)


def test_integer_cache_follows_the_pallas_tiles():
    """Rounding p to an integer cache's dtype truncates it to 0 or 1, so the
    result depends on the tiles; the CPU path walks JAX's (min(block_k, M)
    slots) in decode_attention_tiled_reference, which equals the dense
    plain version for a float cache."""
    rng = np.random.default_rng(30)
    q, k, v = (rng.integers(-3, 4, s).astype(np.int8) for s in ((2, 2, 16), (2, 2, 300, 16),
                                                                 (2, 2, 300, 16)))
    pos = np.asarray([40, 299], np.int32)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    for block_k in (128, 64):
        out = da.decode_attention(tq, tk, tv, tpos, block_k=block_k)
        assert out.dtype == torch.int8
        assert torch.equal(out, da.decode_attention_tiled_reference(tq, tk, tv, tpos, block_k))
        want = np.asarray(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)),
                                               block_k=block_k))
        np.testing.assert_array_equal(out.numpy(), want)
    f = [t.float() for t in (tq, tk, tv)]
    np.testing.assert_allclose(da.decode_attention_tiled_reference(*f, tpos, 64).numpy(),
                               da.decode_attention_reference(*f, tpos).numpy(), atol=1e-5)


@pytest.mark.parametrize("dim", DIMS + NEW_DIMS)
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


# ---------------------------------------------------------------------------
# split-K: the plain form of the kernel's two phases, and the split plan
# ---------------------------------------------------------------------------

SPLITS = (1, 2, 3, 8)


def _positions(which, batch, max_len, splits, mixed):
    """zero, mid, the last slot of the second-to-last split (so the last
    split is empty; the middle slot with one split), the last slot, and the
    reference test's mixed positions."""
    bounds = da.split_bounds(max_len, splits)
    edge = bounds[-1][0] - 1 if splits > 1 else max_len // 2
    return {"zero": [0] * batch, "mid": [max_len // 2] * batch, "edge": [edge] * batch,
            "last": [max_len - 1] * batch, "mixed": mixed}[which]


_PALLAS = {}


def _pallas(q, k, v, pos):
    """The Pallas kernel in interpret mode, once per input and positions."""
    key = (q.dtype.name, q.shape, k.shape, tuple(pos.tolist()))
    if key not in _PALLAS:
        _PALLAS[key] = _f32(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos))))
    return _PALLAS[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("which", ["zero", "mid", "edge", "last", "mixed"])
@pytest.mark.parametrize("batch,heads,max_len,dim,mixed", SHAPES,
                         ids=["fixture", "ragged", "multiblock"])
def test_split_reference_matches_pallas_and_dense(batch, heads, max_len, dim, mixed, which,
                                                  splits, dtype):
    """Per-split partials (empty ones included) merged by log-sum-exp give
    the dense plain version and the Pallas kernel, at the reference test's
    tolerances."""
    positions = _positions(which, batch, max_len, splits, mixed)
    q, k, v = _inputs(batch, heads, max_len, dim, dtype, seed=max_len)
    pos = np.asarray(positions, np.int32)
    tq, tk, tv = (numpy_to_tensor(a, "cpu") for a in (q, k, v))
    out = da.decode_attention_split_reference(tq, tk, tv, torch.from_numpy(pos), splits)
    assert out.dtype == tq.dtype and out.shape == (batch, heads, dim)
    dense = da.decode_attention_reference(tq, tk, tv, torch.from_numpy(pos))
    assert np.max(np.abs(_f32(out) - _f32(dense))) < TOL[dtype]
    assert np.max(np.abs(_f32(out) - _pallas(q, k, v, pos))) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 5, 96])
def test_split_reference_empty_splits_weigh_nothing(splits, dtype):
    """pos inside the first split: every later partial is empty (m = -inf,
    l = 0) and the output is the first slots' attention, exactly as with
    one split; pos 0 gives v[:, :, 0]."""
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs(2, 2, 96, 32, dtype, seed=4))
    for positions in ([0, 0], [0, 1]):
        pos = torch.tensor(positions, dtype=torch.int32)
        out = da.decode_attention_split_reference(q, k, v, pos, splits)
        assert torch.isfinite(out.float()).all()
        np.testing.assert_allclose(
            _f32(out), _f32(da.decode_attention_split_reference(q, k, v, pos, 1)),
            rtol=1e-6, atol=1e-6)
    out = da.decode_attention_split_reference(q, k, v, torch.zeros(2, dtype=torch.int32), splits)
    np.testing.assert_allclose(_f32(out), _f32(v[:, :, 0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("splits", [2, 3, 8])
def test_split_reference_ignores_the_cache_tail(splits):
    """Junk past pos, in the live split and in the empty ones, changes
    nothing."""
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs(1, 2, 96, 32, "float32", seed=3))
    pos = torch.tensor([40], dtype=torch.int32)
    base = da.decode_attention_split_reference(q, k, v, pos, splits)
    k_junk, v_junk = k.clone(), v.clone()
    k_junk[:, :, 41:] = 1e6
    v_junk[:, :, 41:] = -1e6
    assert torch.equal(base, da.decode_attention_split_reference(q, k_junk, v_junk, pos, splits))


def test_split_plan_is_one_split_at_the_decoder_shape():
    assert da.split_plan(1, 4, 128) == 1


@pytest.mark.parametrize("batch,heads", [(33, 8), (64, 16), (132, 2)])
def test_split_plan_is_one_split_when_batch_and_heads_fill_the_card(batch, heads):
    assert da.split_plan(batch, heads, 8192) == 1


@pytest.mark.parametrize("batch,heads,max_len", [
    (8, 8, 8192), (16, 8, 4096), (8, 8, 2048), (1, 1, 1 << 17), (2, 4, 32768), (4, 8, 16384)])
def test_split_plan_fills_the_card_at_large_shapes(batch, heads, max_len):
    splits = da.split_plan(batch, heads, max_len)
    assert batch * heads * splits >= da.BLOCKS_PER_SM * da.H100_SMS
    # and not far past it: at most one split more than that needs
    assert batch * heads * (splits - 1) < da.BLOCKS_PER_SM * da.H100_SMS


@pytest.mark.parametrize("max_len", [1, 7, 128, 255, 256, 257, 1000, 4099, 8192, 70000])
@pytest.mark.parametrize("batch,heads", [(1, 1), (1, 4), (8, 8), (64, 8)])
def test_split_plan_covers_every_slot_once_and_no_split_is_short(batch, heads, max_len):
    splits = da.split_plan(batch, heads, max_len)
    assert 1 <= splits <= 65535
    bounds = da.split_bounds(max_len, splits)
    covered = [j for lo, hi in bounds for j in range(lo, hi)]
    assert covered == list(range(max_len))
    if splits > 1:
        assert min(hi - lo for lo, hi in bounds) >= da.MIN_SPLIT


@pytest.mark.parametrize("sms", [1, 66, 132, 264])
def test_split_plan_follows_the_sm_count(sms):
    splits = da.split_plan(2, 2, 1 << 20, sms)
    assert splits == -(-da.BLOCKS_PER_SM * sms // 4)


@pytest.mark.parametrize("args", [(0, 1, 8), (1, 0, 8), (1, 1, 0), (1, 1, 8, 0)])
def test_split_plan_rejects_empty_sizes(args):
    with pytest.raises(ValueError):
        da.split_plan(*args)


def test_function_sets_the_signature_once(monkeypatch):
    """Wrappers reach their entry point through _kernels.function: the
    library is loaded and the ctypes signature set on the first call only."""
    libc = ctypes.CDLL(None)
    loads = []
    monkeypatch.setattr(_kernels, "load", lambda name: loads.append(name) or libc)
    monkeypatch.setattr(_kernels, "_functions", {})
    fn = _kernels.function("libc", "abs", (ctypes.c_int,))
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert fn(-3) == 3
    assert _kernels.function("libc", "abs", (ctypes.c_int,)) is fn
    assert loads == ["libc"]


class _OnDevice:
    """A stand-in for a CUDA tensor on device ``index``."""

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


def _fake_cuda(monkeypatch, current=0):
    """torch.cuda as the launch path sees it, on a machine with no card:
    device ``current`` is current, raw streams are 1000 + the device index,
    and entering a device is recorded."""
    entered = []

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    return entered


def _entry(result=0):
    calls = []

    def fn(*args):
        calls.append(args)
        return result

    fn.__name__ = "fake_launch"
    return fn, calls


def test_on_device_enters_nothing_for_the_current_device(monkeypatch):
    """A tensor on the current device: launch calls the entry point with
    the device's raw stream last, enters no device, counts one launch."""
    entered = _fake_cuda(monkeypatch, current=0)
    fn, calls = _entry()
    counter = LaunchCounter()
    _kernels.launch(fn, counter, _OnDevice(0), 7, 8.5)
    assert calls == [(7, 8.5, 1000)] and entered == [] and counter.count == 1


def test_launch_enters_the_device_of_the_tensor(monkeypatch):
    entered = _fake_cuda(monkeypatch, current=0)
    fn, calls = _entry()
    counter = LaunchCounter()
    _kernels.launch(fn, counter, _OnDevice(1), 3)
    assert calls == [(3, 1001)] and entered == [1] and counter.count == 1


def test_launch_raises_on_an_error_and_counts_nothing(monkeypatch):
    _fake_cuda(monkeypatch)
    fn, _ = _entry(result=700)
    counter = LaunchCounter()
    with pytest.raises(RuntimeError, match="fake_launch failed: cudaError_t 700"):
        _kernels.launch(fn, counter, _OnDevice(0))
    assert counter.count == 0


def test_sm_count_reads_each_device_once(monkeypatch):
    reads = []

    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(_kernels, "_sm_counts", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: reads.append(i) or _Props())
    assert [_kernels.sm_count(i) for i in (0, 0, 1, 0)] == [132] * 4
    assert reads == [0, 1]


# ---------------------------------------------------------------------------
# every float dtype and the head dims up to 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dim", NEW_DIMS)
def test_new_head_dims_match_pallas(dim, dtype):
    """D = 8, 24, 80, 96 and 256 in every float dtype at the reference
    test's ragged shape (3, 2, 200) and mixed positions (0, 99, 199; two
    Pallas tiles): the dense plain version and the split plain version (3
    splits, the kernel's two phases) against the Pallas kernel in interpret
    mode, fp32 within 1e-5, bf16 within 2e-2, fp16 within FP16_ATOL *
    max|v| (the Pallas kernel rounds p to fp16 before PV)."""
    q, k, v = _inputs(3, 2, 200, dim, dtype, seed=dim)
    pos = np.asarray([0, 99, 199], np.int32)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = da.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert out.dtype == tq.dtype and out.shape == (3, 2, dim)
    split = da.decode_attention_split_reference(tq, tk, tv, torch.from_numpy(pos), 3)
    pallas = _pallas(q, k, v, pos)
    atol = FP16_ATOL * np.abs(v.astype(np.float32)).max() if dtype == "float16" else TOL[dtype]
    for got in (out, split):
        assert np.max(np.abs(_f32(got) - pallas)) < atol


@pytest.mark.parametrize("dim", [1, 8, 96, 256, 264])
def test_head_dims_up_to_the_kernel_limit(dim):
    """The kernels have no head-dim limit any more (the split kernel's
    padded widths end at 1024 and past it it takes slabs of 1024 columns):
    every dim passes the wrapper's checks and, on the CPU, computes the
    plain version, as the JAX function does (D = 264 runs on the card too:
    chip_smoke.py checks D = 257 to 2048)."""
    q, k, v, pos = _good(dim=dim)
    out = da.decode_attention(q, k, v, pos)
    assert out.shape == q.shape
    assert torch.equal(out, da.decode_attention_reference(q, k, v, pos))
    assert not hasattr(da, "MAX_DIM")


# ---------------------------------------------------------------------------
# head dims past 256 and integer and bool caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["mixed", "last"])
@pytest.mark.parametrize("dim", WIDE_DIMS)
def test_plain_matches_pallas_at_wide_head_dims(dim, which):
    """D = 300 and 512 at a ragged cache (2, 2, 100; two Pallas tiles of
    64): the dense plain version (the CPU path) and the split plain version
    (the kernel's two phases at 3 splits) against the Pallas kernel in
    interpret mode within the reference test's 1e-5."""
    q, k, v = _inputs(2, 2, 100, dim, "float32", seed=dim)
    pos = np.asarray({"mixed": [37, 99], "last": [99, 99]}[which], np.int32)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    out = da.decode_attention(tq, tk, tv, tpos)
    want = _f32(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)), block_k=64))
    assert out.shape == (2, 2, dim)
    assert np.max(np.abs(_f32(out) - want)) < TOL["float32"]
    split = da.decode_attention_split_reference(tq, tk, tv, tpos, 3)
    assert np.max(np.abs(_f32(split) - want)) < TOL["float32"]


def _integer_array(dtype, shape, rng):
    """Seeded integers in -7..8 (uint8 0..8, bool 0/1), as chip_smoke.py's
    integer cases."""
    low, high = {"bool": (0, 2), "uint8": (0, 9)}.get(dtype, (-7, 9))
    return rng.integers(low, high, shape).astype(dtype)


@pytest.mark.parametrize("block_k", [16, 48])
@pytest.mark.parametrize("dtype", ["uint8", "int16", "bool"])
def test_integer_caches_follow_the_pallas_tiles(dtype, block_k):
    """uint8, int16 and bool caches at tiles of 16 and 48 slots (48 does
    not divide M = 100): the tiled plain version, which the tiled kernel's
    arithmetic follows, equals the Pallas kernel in interpret mode element
    for element (its mask stands between the score and the subtraction, so
    XLA contracts nothing)."""
    rng = np.random.default_rng(block_k)
    q, k, v = (_integer_array(dtype, s, rng) for s in ((2, 2, 16), (2, 2, 100, 16),
                                                       (2, 2, 100, 16)))
    pos = np.asarray([40, 99], np.int32)
    out = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, pos)), block_k=block_k)
    assert str(out.dtype) == f"torch.{dtype}"
    want = np.asarray(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)),
                                           block_k=block_k))
    assert want.dtype == dtype
    np.testing.assert_array_equal(out.numpy(), want)


class _FakeKernels:
    """``_kernels.function`` and ``_kernels.launch`` stood in for: records
    each launch's entry point and arguments, counts it, launches nothing;
    every plain version (``*_reference``) of ``module`` raises if called."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        monkeypatch.setattr(_kernels, "function",
                            lambda name, symbol, argtypes: (name, symbol, len(argtypes)))
        monkeypatch.setattr(_kernels, "launch", self._launch)
        monkeypatch.setattr(_kernels, "sm_count", lambda index: 132)

        def refuse(*args, **kwargs):
            raise AssertionError("the CUDA path ran a plain version")

        for name in dir(module):
            if name.endswith("_reference"):
                monkeypatch.setattr(module, name, refuse)

    def _launch(self, fn, counter, tensor, *args):
        self.calls.append((fn, args))
        counter.add()


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int16", "int32", "float32",
                                   "bfloat16", "float16"])
@pytest.mark.parametrize("dim", [16, 300, 1024, 1100])
def test_cuda_path_reaches_the_kernel_for_every_dtype_and_dim(monkeypatch, dtype, dim):
    """The CUDA path (``_launch``, what a CUDA tensor runs) up to the launch:
    an integer or bool cache reaches the tiled kernel with the dtype's
    element code, the tile min(block_k, M) and the dim; fp32, bf16 and fp16
    reach the split kernel with the dim, past 1024 too (its slabs). One
    launch is counted, no plain version runs."""
    fake = _FakeKernels(monkeypatch, da)
    torch_dtype = getattr(torch, dtype)
    q, k, v, pos = (t.to(torch_dtype) if t.dtype != torch.int32 else t
                    for t in _good(batch=2, heads=2, max_len=40, dim=dim))
    before = da.LAUNCHES.count
    out = da._launch(q, k, v, pos, 16)
    assert out.dtype == torch_dtype and out.shape == (2, 2, dim)
    assert da.LAUNCHES.count == before + 1 and len(fake.calls) == 1
    (lib, symbol, nargs), args = fake.calls[0]
    assert lib == "decode_attention"
    if torch_dtype.is_floating_point:
        assert (symbol, nargs) == ("decode_attention_launch", len(da._ARGTYPES))
        # q, k, v, pos, out, partial, batch, heads, max_len, dim, dtype, splits, scale
        assert args[6:11] == (2, 2, 40, dim, _kernels.FLOAT_CODES[torch_dtype])
    else:
        assert (symbol, nargs) == ("decode_attention_tiled_launch", len(da._TILED_ARGTYPES))
        # q, k, v, pos, out, batch, heads, max_len, dim, code, tile, scale
        assert args[5:11] == (2, 2, 40, dim, _kernels.ELEMENT_CODES[torch_dtype], 16)
    assert args[-1] == pytest.approx(dim ** -0.5)
