"""The port's flash attention against the JAX package's.

``client_tpu_torch.ops.flash_attention`` launches a CUDA kernel for CUDA
tensors and computes its dense plain version for CPU tensors. Here, on the
CPU, the plain version is held against the JAX Pallas kernel (interpret mode
off-TPU, as the JAX package's own tests run it) and against
``client_tpu.parallel.ring.full_attention`` on the same numpy-seeded inputs,
at every shape, block pair and causal setting of the JAX tests
(tests/test_utils.py and tests/test_models_parallel.py), within their
atol/rtol of 2e-5. bf16 inputs are held within atol/rtol 2e-2: the Pallas
kernel rounds the probabilities to bf16 before the PV product and both
outputs are rounded to bf16, while the plain version keeps fp32 throughout.
The kernel itself runs on the card only (chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from client_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from client_tpu.parallel.ring import full_attention
from client_tpu_torch import ops
from client_tpu_torch.ops import _kernels
from client_tpu_torch.ops import flash_attention as fa_function
from client_tpu_torch.ops.flash_attention import (
    LAUNCHES,
    SUPPORTED_DIMS,
    flash_attention,
    flash_attention_reference,
)
from client_tpu_torch.utils import numpy_to_tensor

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (shape, block_q, block_k): tests/test_utils.py's block pairs at (2,128,2,32)
# and tests/test_models_parallel.py's ragged (1,100,2,16) at 64 x 64
CASES = [((2, 128, 2, 32), bq, bk) for bq, bk in ((128, 128), (64, 32), (32, 64))] + [
    ((1, 100, 2, 16), 64, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        arrays = [a.astype(ml_dtypes.bfloat16) for a in arrays]
    return arrays


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _port(arrays, causal, **blocks):
    return flash_attention(*(numpy_to_tensor(a, "cpu") for a in arrays), causal=causal, **blocks)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,block_q,block_k", CASES,
                         ids=[f"{s[1]}x{s[3]}_b{bq}x{bk}" for s, bq, bk in CASES])
def test_plain_matches_pallas_and_dense(shape, block_q, block_k, causal):
    arrays = _inputs(shape, "float32", seed=shape[1] + block_q)
    out = _port(arrays, causal, block_q=block_q, block_k=block_k)
    assert out.dtype == torch.float32 and out.shape == shape
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, block_q=block_q, block_k=block_k)
    dense = full_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(_f32(out), _f32(dense), atol=TOL["float32"], rtol=TOL["float32"])
    # the block arguments change nothing
    assert torch.equal(out, _port(arrays, causal))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_self_attention_ragged_matches_dense(causal):
    """tests/test_models_parallel.py's case: q = k = v at a ragged length."""
    (x, _, _) = _inputs((1, 100, 2, 16), "float32", seed=13)
    out = _port([x, x, x], causal, block_q=64, block_k=64)
    jx = jnp.asarray(x)
    np.testing.assert_allclose(_f32(out), _f32(full_attention(jx, jx, jx, causal=causal)),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(2, 128, 2, 32), (1, 100, 2, 16)], ids=["128x32", "100x16"])
def test_bf16_matches_pallas(shape, causal):
    arrays = _inputs(shape, "bfloat16", seed=7)
    out = _port(arrays, causal, block_q=64, block_k=64)
    assert out.dtype == torch.bfloat16 and out.shape == shape
    pallas = jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                 block_q=64, block_k=64)
    assert pallas.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_first_row_is_the_first_value(dtype):
    """Row 0 attends key 0 alone: its output is v[:, 0]."""
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs((2, 37, 3, 16), dtype, seed=1))
    out = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_f32(out[:, 0]), _f32(v[:, 0]), rtol=1e-6, atol=1e-6)
    assert not np.allclose(_f32(out), _f32(flash_attention(q, k, v)), atol=1e-3)


@pytest.mark.parametrize("seq", [1, 63, 64, 65, 130])
def test_tile_edges_match_dense(seq):
    """Lengths around the kernel's 64-row tiles, and a single token."""
    arrays = _inputs((1, seq, 2, 32), "float32", seed=seq)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    for causal in (False, True):
        np.testing.assert_allclose(_f32(_port(arrays, causal)),
                                   _f32(full_attention(jq, jk, jv, causal=causal)),
                                   atol=TOL["float32"], rtol=TOL["float32"])


def _good(shape=(1, 8, 2, 32), dtype=torch.float32):
    return tuple(torch.zeros(shape, dtype=dtype) for _ in range(3))


def _bad_case(name):
    q, k, v = _good()
    if name == "fp16":
        return (q.half(), k.half(), v.half()), {}, TypeError
    if name == "int32":
        return (q.int(), k.int(), v.int()), {}, TypeError
    if name == "mixed_dtypes":
        return (q, k.bfloat16(), v), {}, TypeError
    if name == "rank3":
        return (q[0], k[0], v[0]), {}, ValueError
    if name == "kv_length_differs":
        return (q, k[:, :4].contiguous(), v[:, :4].contiguous()), {}, ValueError
    if name == "empty_seq":
        return _good((1, 0, 2, 32)), {}, ValueError
    if name == "empty_batch":
        return _good((0, 8, 2, 32)), {}, ValueError
    if name.startswith("dim"):
        return _good((1, 8, 2, int(name[3:]))), {}, ValueError
    if name == "block_q_zero":
        return (q, k, v), {"block_q": 0}, ValueError
    if name == "block_k_float":
        return (q, k, v), {"block_k": 64.0}, ValueError
    if name == "non_contiguous":
        return (q, k.transpose(1, 2).contiguous().transpose(1, 2), v), {}, ValueError
    if name == "meta_device":
        return tuple(t.to("meta") for t in (q, k, v)), {}, ValueError
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "fp16", "int32", "mixed_dtypes", "rank3", "kv_length_differs", "empty_seq",
    "empty_batch", "dim8", "dim48", "dim256", "block_q_zero", "block_k_float",
    "non_contiguous", "meta_device",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    args, kwargs, exc = _bad_case(name)
    with pytest.raises(exc):
        flash_attention(*args, **kwargs)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dim", SUPPORTED_DIMS)
def test_cpu_path_is_the_plain_version_and_launches_nothing(dim, causal):
    q, k, v = (numpy_to_tensor(a, "cpu") for a in _inputs((2, 40, 2, dim), "float32", seed=dim))
    before = LAUNCHES.count
    out = flash_attention(q, k, v, causal=causal)
    assert torch.equal(out, flash_attention_reference(q, k, v, causal=causal))
    assert LAUNCHES.count == before
    assert "flash_attention" not in _kernels.loaded()


def test_ops_package_exposes_the_function():
    """As client_tpu.ops does: ops.flash_attention is the function."""
    assert ops.flash_attention is flash_attention is fa_function
    assert "flash_attention" in _kernels.sources()
