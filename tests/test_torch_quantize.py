"""The port's int8 wire quantization against the JAX package's.

``client_tpu_torch.ops.quantize_int8`` / ``dequantize_int8`` launch a CUDA
kernel for CUDA tensors and compute their plain versions for CPU tensors.
Here, on the CPU, the plain versions are held against the JAX Pallas kernels
(interpret mode off-TPU) on numpy-seeded inputs: quantize must agree element
for element (int8), including exact half-steps (round half to even) and
values beyond +-127 scale (clipped), and dequantize must agree bit for bit.
The round-trip bound of tests/test_utils.py (error within half a step) holds.
Every dtype JAX computes is covered in tests/test_torch_parity.py; here the
float16 paths the kernels gained, unaligned views (the kernels' scalar way)
and ``dequantize_plan``. The kernels themselves run on the card only
(chip_smoke.py).
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
from client_tpu_torch.ops.normalize import BLOCKS_PER_SM, THREADS
from client_tpu_torch.ops.quantize import (
    DEQUANTIZE_LAUNCHES,
    QUANTIZE_LAUNCHES,
    dequantize_int8,
    dequantize_plan,
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["wire", "square", "odd"])
def test_quantize_is_element_exact(shape, dtype, scale_name):
    scale = SCALES[scale_name]
    x = _values(shape, scale or 0.02, seed=len(shape))
    if scale is None:  # the example's scale: the largest magnitude over 127
        scale = float(np.abs(x).max() / 127.0)
    if dtype != "float32":
        x = x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float16)
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
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["wire", "square", "odd"])
def test_dequantize_is_exact(shape, out_dtype, scale):
    q = np.random.default_rng(3).integers(-128, 128, size=shape, dtype=np.int8)
    torch_dtype, jax_dtype = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    out = dequantize_int8(torch.from_numpy(q), scale, torch_dtype)
    assert out.dtype == torch_dtype and out.shape == shape
    expected = np.asarray(jax_dequantize(jnp.asarray(q), scale, jax_dtype))
    assert tensor_to_numpy(out).tobytes() == expected.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
    """(call, expected): an exception, or the JAX call whose result the
    port's must equal element for element. JAX computes int32 and float16
    in, float in for dequantize and float16 out, so the plain versions
    compute them too."""
    x = torch.from_numpy(_values((4, 8), 0.25, seed=4))
    q = torch.from_numpy(np.random.default_rng(4).integers(-128, 128, (4, 8), dtype=np.int8))
    xi = (x * 40).int()
    return {
        "quantize_int32": (lambda: quantize_int8(xi, 1.0),
                           lambda: jax_quantize(jnp.asarray(xi.numpy()), 1.0)),
        "quantize_fp16": (lambda: quantize_int8(x.half(), 0.25),
                          lambda: jax_quantize(jnp.asarray(x.half().numpy()), 0.25)),
        "quantize_zero_scale": (lambda: quantize_int8(x, 0.0), ValueError),
        "quantize_negative_scale": (lambda: quantize_int8(x, -1.0), ValueError),
        "quantize_nan_scale": (lambda: quantize_int8(x, float("nan")), ValueError),
        "quantize_non_contiguous": (lambda: quantize_int8(x.t(), 1.0), ValueError),
        "quantize_meta": (lambda: quantize_int8(x.to("meta"), 1.0), ValueError),
        "dequantize_float": (lambda: dequantize_int8(x, 1.0 / 3.0),
                             lambda: jax_dequantize(jnp.asarray(x.numpy()), 1.0 / 3.0)),
        "dequantize_fp16_out": (lambda: dequantize_int8(q, 0.37, torch.float16),
                                lambda: jax_dequantize(jnp.asarray(q.numpy()), 0.37,
                                                       jnp.float16)),
        "dequantize_inf_scale": (lambda: dequantize_int8(q, float("inf")), ValueError),
        "dequantize_non_contiguous": (lambda: dequantize_int8(q.t(), 1.0), ValueError),
    }[name]


@pytest.mark.parametrize("name", [
    "quantize_int32", "quantize_fp16", "quantize_zero_scale", "quantize_negative_scale",
    "quantize_nan_scale", "quantize_non_contiguous", "quantize_meta", "dequantize_float",
    "dequantize_fp16_out", "dequantize_inf_scale", "dequantize_non_contiguous",
])
def test_wrappers_reject_what_the_kernels_do_not_take(name):
    """Bad scales, layouts and devices raise; a dtype JAX computes is
    computed, with JAX's output dtype and values (on a CUDA tensor the
    kernels take float32, bfloat16 and float16 in, and float16 out; any
    other dtype raises there, chip_smoke.py checks)."""
    call, expected = _bad_case(name)
    if isinstance(expected, type):
        with pytest.raises(expected):
            call()
        return
    got, want = tensor_to_numpy(call()), np.asarray(expected())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_dequantize_plan_is_a_thread_per_output_word(out_dtype):
    """normalize's word loop with int8 in: 16 bytes of output a thread (4
    int8 in for float32, 8 for the 2-byte types), the blocks those threads
    fill, at most BLOCKS_PER_SM a SM."""
    elements = 16 // out_dtype.itemsize
    for n in (1, elements - 1, elements, elements + 1, 8192, 8195, 16 * 2 ** 20, 2 ** 33):
        plan = dequantize_plan(n, out_dtype, True, sms=132)
        words = -(-n // elements)
        assert plan.elements == elements
        assert plan.blocks == min(-(-words // THREADS), BLOCKS_PER_SM * 132)
    # the served (1, 8192) fp32: 2048 words, 8 blocks of 256 threads
    assert dequantize_plan(8192, torch.float32, True) == (4, 8)
    # 64 MiB of fp32 out: a thread per word, 16384 blocks, within the cap
    assert dequantize_plan(16 * 2 ** 20, torch.float32, True, sms=132).blocks == 16384
    assert dequantize_plan(2 ** 33, out_dtype, True, sms=2).blocks == BLOCKS_PER_SM * 2


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_unaligned_views_take_the_scalar_way(out_dtype):
    """A view such as q[1:] is not 16-byte aligned: a thread per element,
    and the plain version (what the card is held to) computes the view as
    JAX computes a fresh array of its values."""
    plan = dequantize_plan(8191, out_dtype, False, sms=132)
    assert plan.elements == 1 and plan.blocks == -(-8191 // THREADS)
    base = np.random.default_rng(8).integers(-128, 128, 8193, dtype=np.int8)
    view = torch.from_numpy(base)[1:]
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    jax_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                 torch.float16: jnp.float16}[out_dtype]
    want = np.asarray(jax_dequantize(jnp.asarray(base[1:]), 0.37, jax_dtype))
    assert tensor_to_numpy(dequantize_int8(view, 0.37, out_dtype)).tobytes() == want.tobytes()
    x = torch.from_numpy(_values((8193,), 0.1, seed=8))[1:]
    np.testing.assert_array_equal(tensor_to_numpy(quantize_int8(x, 0.1)),
                                  np.asarray(jax_quantize(jnp.asarray(x.numpy()), 0.1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
