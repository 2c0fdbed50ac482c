"""The port's int8 wire quantization against the JAX package's.

``client_tpu_torch.ops.quantize_int8`` / ``dequantize_int8`` launch a CUDA
kernel for CUDA tensors and compute their plain versions for CPU tensors.
Here, on the CPU, the plain versions are held against the JAX Pallas kernels
(interpret mode off-TPU) on numpy-seeded inputs: quantize must agree element
for element (int8), including exact half-steps (round half to even) and
values beyond +-127 scale (clipped), and dequantize must agree bit for bit.
The round-trip bound of tests/test_utils.py (error within half a step) holds.
The kernels themselves run on the card only (chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from client_tpu.ops import dequantize_int8 as jax_dequantize
from client_tpu.ops import quantize_int8 as jax_quantize
from client_tpu_torch import ops
from client_tpu_torch.ops import _kernels
from client_tpu_torch.ops.quantize import (
    DEQUANTIZE_LAUNCHES,
    QUANTIZE_LAUNCHES,
    dequantize_int8,
    dequantize_int8_reference,
    quantize_int8,
    quantize_int8_reference,
)
from client_tpu_torch.utils import numpy_to_tensor, tensor_to_numpy

SHAPES = [(1, 8192), (64, 64), (3, 5, 7)]
SCALES = {"unit": 1.0, "quarter": 0.25, "third": 1.0 / 3.0, "fit": None}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _values(shape, scale, seed):
    """Seeded normals spread past the clip range, with exact half-steps
    (k + 0.5) * scale, +-127.5 * scale, far-out values and signed zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(60 * scale)
    flat = x.reshape(-1)
    specials = np.concatenate([
        (np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)) * np.float32(scale),
        np.float32(scale) * np.array([127.5, -127.5, 1e4, -1e4, 0.0, -0.0], np.float32),
    ])
    n = min(len(specials), flat.size)
    flat[rng.permutation(flat.size)[:n]] = specials[:n]
    return x


@pytest.mark.parametrize("scale_name", list(SCALES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["wire", "square", "odd"])
def test_quantize_is_element_exact(shape, dtype, scale_name):
    scale = SCALES[scale_name]
    x = _values(shape, scale or 0.02, seed=len(shape))
    if scale is None:  # the example's scale: the largest magnitude over 127
        scale = float(np.abs(x).max() / 127.0)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    q = quantize_int8(numpy_to_tensor(x, "cpu"), scale)
    assert q.dtype == torch.int8 and q.shape == shape
    expected = np.asarray(jax_quantize(jnp.asarray(x), scale))
    assert expected.dtype == np.int8
    np.testing.assert_array_equal(tensor_to_numpy(q), expected)
    assert np.abs(expected.astype(np.int32)).max() <= 127


def test_half_steps_round_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5, 300.0])
    q = quantize_int8(x, 1.0)
    assert q.tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 127, 127]
    np.testing.assert_array_equal(
        tensor_to_numpy(q), np.asarray(jax_quantize(jnp.asarray(x.numpy()), 1.0)))


@pytest.mark.parametrize("scale", [0.37, 1.0 / 3.0, 2.0 ** -7], ids=["0.37", "third", "pow2"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["wire", "square", "odd"])
def test_dequantize_is_exact(shape, out_dtype, scale):
    q = np.random.default_rng(3).integers(-128, 128, size=shape, dtype=np.int8)
    torch_dtype = torch.float32 if out_dtype == "float32" else torch.bfloat16
    jax_dtype = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
    out = dequantize_int8(torch.from_numpy(q), scale, torch_dtype)
    assert out.dtype == torch_dtype and out.shape == shape
    expected = np.asarray(jax_dequantize(jnp.asarray(q), scale, jax_dtype))
    assert tensor_to_numpy(out).tobytes() == expected.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_within_half_a_step(dtype):
    """tests/test_utils.py's round trip: error within half a step."""
    x = np.random.default_rng(6).standard_normal((64, 64)).astype(np.float32)
    scale = float(np.abs(x).max() / 127.0)
    xt = torch.from_numpy(x).to(dtype)
    q = quantize_int8(xt, scale)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    back = dequantize_int8(q, scale)
    assert float((back - xt.float()).abs().max()) <= scale * 0.5 + 1e-7


def _bad_case(name):
    x = torch.zeros(4, 8)
    q = torch.zeros(4, 8, dtype=torch.int8)
    return {
        "quantize_int32": (lambda: quantize_int8(x.int(), 1.0), TypeError),
        "quantize_fp16": (lambda: quantize_int8(x.half(), 1.0), TypeError),
        "quantize_zero_scale": (lambda: quantize_int8(x, 0.0), ValueError),
        "quantize_negative_scale": (lambda: quantize_int8(x, -1.0), ValueError),
        "quantize_nan_scale": (lambda: quantize_int8(x, float("nan")), ValueError),
        "quantize_non_contiguous": (lambda: quantize_int8(x.t(), 1.0), ValueError),
        "quantize_meta": (lambda: quantize_int8(x.to("meta"), 1.0), ValueError),
        "dequantize_float": (lambda: dequantize_int8(x, 1.0), TypeError),
        "dequantize_fp16_out": (lambda: dequantize_int8(q, 1.0, torch.float16), TypeError),
        "dequantize_inf_scale": (lambda: dequantize_int8(q, float("inf")), ValueError),
        "dequantize_non_contiguous": (lambda: dequantize_int8(q.t(), 1.0), ValueError),
    }[name]


@pytest.mark.parametrize("name", [
    "quantize_int32", "quantize_fp16", "quantize_zero_scale", "quantize_negative_scale",
    "quantize_nan_scale", "quantize_non_contiguous", "quantize_meta", "dequantize_float",
    "dequantize_fp16_out", "dequantize_inf_scale", "dequantize_non_contiguous",
])
def test_wrappers_reject_what_the_kernels_do_not_take(name):
    call, exc = _bad_case(name)
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_the_plain_version_and_launches_nothing(dtype):
    x = torch.from_numpy(_values((5, 33), 0.1, seed=9)).to(dtype)
    before = (QUANTIZE_LAUNCHES.count, DEQUANTIZE_LAUNCHES.count)
    q = quantize_int8(x, 0.1)
    assert torch.equal(q, quantize_int8_reference(x, 0.1))
    out = dequantize_int8(q, 0.1, dtype)
    assert torch.equal(out, dequantize_int8_reference(q, 0.1, dtype))
    assert (QUANTIZE_LAUNCHES.count, DEQUANTIZE_LAUNCHES.count) == before
    assert "quantize_int8" not in _kernels.loaded()


def test_ops_package_exposes_the_functions():
    assert ops.quantize_int8 is quantize_int8 and ops.dequantize_int8 is dequantize_int8
    assert "quantize_int8" in _kernels.sources()
