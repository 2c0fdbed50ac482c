"""Every dtype the JAX ops compute, through the port's plain versions.

The six ops that reach a Pallas kernel in ``client_tpu`` (normalize_image,
softmax_probabilities, quantize_int8, dequantize_int8, decode_attention,
flash_attention) each take bool, int8, uint8, int16, int32, float16,
bfloat16 and float32 input there (64-bit types are off in JAX), and
normalize_image and dequantize_int8 write float16, bfloat16 and float32.
On the CPU the port computes every one of those cases with JAX's output
dtype; each case is held against the JAX function (the Pallas kernels in
interpret mode, as the JAX package's tests run them) on the same
numpy-seeded inputs:

- quantize_int8, dequantize_int8, and normalize_image from integer, bool or
  float32 input: element for element;
- normalize_image from float16 or bfloat16 input: JAX computes in the
  input's own type (it rounds scale and shift to it, and its result; in
  bfloat16 also the product), the port rounds once in float32 as its kernel
  does. Each of those roundings is within half an ulp of the input type at
  M = max|x * scale| + |shift|, and scale's own rounding moves x * scale by
  at most that much again, so the two are within 2 ulps of the coarser of
  the input and output types at M;
- softmax_probabilities: within rtol 1e-5 (atol 1e-30), tests/test_utils.py's
  bound;
- decode_attention and flash_attention: float32 within 1e-5 / 2e-5 and
  bfloat16 within 2e-2 (the JAX tests' bounds); float16 within
  2^-9 * max|v| (the Pallas kernel rounds p to float16 before the PV
  product, 2^-11 relative, and both round the output to float16); bool
  inputs, and integer inputs to decode, element for element (rounding p
  to an integer dtype truncates it to 0 or 1, and the plain version walks
  JAX's tiles for that); integer inputs to flash row by row as
  test_torch_flash_attention.integer_flash_explained holds them: exact
  but for the score subtraction XLA on the CPU contracts where no mask
  stands before it, and the order of the softmax sum.

On a CUDA tensor the kernels take float32, bfloat16 and float16 (and uint8
and int32 for normalize_image; int8 for dequantize_int8); other dtypes
raise there. chip_smoke.py holds the kernels to these plain versions.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.ops as jax_ops
from client_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from client_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from client_tpu_torch import ops
from client_tpu_torch.ops import PLAIN_DTYPES
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.utils import numpy_to_tensor, tensor_to_numpy
from test_torch_flash_attention import integer_flash_explained

DTYPES = ["bool", "int8", "uint8", "int16", "int32", "float16", "bfloat16", "float32"]
OUTS = ["float16", "bfloat16", "float32"]
NP = {"bool": np.bool_, "int8": np.int8, "uint8": np.uint8, "int16": np.int16,
      "int32": np.int32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16,
      "float32": np.float32}
# the widest magnitude each integer type is drawn from (int32 past 2**24,
# where its float32 cast rounds)
INT_RANGE = {"int8": (-128, 128), "uint8": (0, 256), "int16": (-30000, 30000),
             "int32": (-2 ** 31, 2 ** 31 - 1)}
MANTISSA = {"float16": 10, "bfloat16": 7, "float32": 23}
ATTENTION_TOL = {"float32": {"decode": 1e-5, "flash": 2e-5}, "bfloat16": {"decode": 2e-2,
                                                                         "flash": 2e-2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _values(shape, dtype, seed, spread=100.0, ints=None):
    """Seeded values of ``dtype``: floats spread by ``spread``, integers
    over ``ints`` (default: the type's INT_RANGE), bools half true."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype in INT_RANGE:
        lo, hi = ints or INT_RANGE[dtype]
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(NP[dtype])
    return (rng.standard_normal(shape) * spread).astype(np.float32).astype(NP[dtype])


def _port(x):
    return numpy_to_tensor(x, "cpu")


def test_every_dtype_is_a_plain_dtype():
    assert [str(d).replace("torch.", "") for d in PLAIN_DTYPES] == DTYPES


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_int8_every_dtype(dtype):
    x = _values((4, 257), dtype, seed=1, spread=30.0)
    got = ops.quantize_int8(_port(x), 0.25)
    want = np.asarray(jax_ops.quantize_int8(jnp.asarray(x), 0.25))
    assert want.dtype == np.int8 and got.dtype == torch.int8
    np.testing.assert_array_equal(tensor_to_numpy(got), want)


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequantize_int8_every_dtype(dtype, out):
    q = _values((4, 257), dtype, seed=2)
    got = ops.dequantize_int8(_port(q), 0.37, getattr(torch, out))
    want = np.asarray(jax_ops.dequantize_int8(jnp.asarray(q), 0.37, getattr(jnp, out)))
    assert got.dtype == getattr(torch, out) and str(want.dtype) == out
    assert tensor_to_numpy(got).tobytes() == want.tobytes()


def _ulp(value: float, dtype: str) -> float:
    """One ulp of ``dtype`` at the magnitude ``value``."""
    return 2.0 ** (np.floor(np.log2(value)) - MANTISSA[dtype])


@pytest.mark.parametrize("mode", [(2.0 / 255.0, -1.0), (0.37, 0.5)], ids=["INCEPTION", "odd"])
@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_normalize_image_every_dtype(dtype, out, mode):
    scale, shift = mode
    x = _values((7, 13, 3), dtype, seed=3, spread=100.0)
    got = ops.normalize_image(_port(x), scale, shift, getattr(torch, out))
    want = np.asarray(jax_ops.normalize_image(jnp.asarray(x), scale=scale, shift=shift,
                                              out_dtype=getattr(jnp, out)))
    assert got.dtype == getattr(torch, out) and str(want.dtype) == out
    if dtype not in ("float16", "bfloat16"):
        assert tensor_to_numpy(got).tobytes() == want.tobytes()
        return
    m = float(np.abs(x.astype(np.float64) * scale).max() + abs(shift))
    coarser = dtype if MANTISSA[dtype] <= MANTISSA[out] else out
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=0,
                               atol=2 * _ulp(m, coarser))


@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_probabilities_every_dtype(dtype):
    logits = _values((3, 50), dtype, seed=4, spread=8.0, ints=(-20, 20))
    got = ops.softmax_probabilities(_port(logits))
    want = np.asarray(jax_ops.softmax_probabilities(jnp.asarray(logits)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-30)


def _attention_atol(dtype, op, v):
    """Float tolerances; bool and integer inputs are held exactly (flash's
    integer rows by integer_flash_explained)."""
    if dtype in ATTENTION_TOL:
        return ATTENTION_TOL[dtype][op]
    if dtype == "float16":
        return 2.0 ** -9 * float(np.abs(v.astype(np.float32)).max())
    return 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_every_dtype(dtype):
    q, k, v = (_values(s, dtype, seed=5 + i, spread=1.0, ints=(-3, 4))
               for i, s in enumerate(((2, 2, 32), (2, 2, 160, 32), (2, 2, 160, 32))))
    pos = np.asarray([17, 159], np.int32)
    got = da.decode_attention(_port(q), _port(k), _port(v), torch.from_numpy(pos))
    want = np.asarray(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos))))
    assert str(got.dtype).replace("torch.", "") == dtype and want.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=0,
                               atol=_attention_atol(dtype, "decode", v))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_every_dtype(dtype, causal):
    q, k, v = (_values((1, 100, 2, 16), dtype, seed=8 + i, spread=1.0, ints=(-3, 4))
               for i in range(3))
    got = ops.flash_attention(_port(q), _port(k), _port(v), causal=causal)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    assert str(got.dtype).replace("torch.", "") == dtype and want.dtype == q.dtype
    if dtype in INT_RANGE:
        integer_flash_explained(q, k, v, causal, got.numpy(), want)
        return
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=0,
                               atol=_attention_atol(dtype, "flash", v))


@pytest.mark.parametrize("op", ["quantize", "dequantize", "normalize", "softmax", "decode",
                                "flash"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.complex64])
def test_dtypes_jax_does_not_compute_raise(op, dtype):
    """64-bit and complex types never reach the JAX kernels (JAX narrows
    them or has no such op): the port refuses them on any device."""
    x = torch.zeros((2, 8), dtype=dtype)
    calls = {
        "quantize": lambda: ops.quantize_int8(x, 1.0),
        "dequantize": lambda: ops.dequantize_int8(x, 1.0),
        "normalize": lambda: ops.normalize_image(x),
        "softmax": lambda: ops.softmax_probabilities(x),
        "decode": lambda: da.decode_attention(torch.zeros((1, 1, 8), dtype=dtype),
                                              torch.zeros((1, 1, 4, 8), dtype=dtype),
                                              torch.zeros((1, 1, 4, 8), dtype=dtype),
                                              torch.zeros(1, dtype=torch.int32)),
        "flash": lambda: ops.flash_attention(*(torch.zeros((1, 4, 1, 8), dtype=dtype)
                                               for _ in range(3))),
    }
    with pytest.raises(TypeError):
        calls[op]()
