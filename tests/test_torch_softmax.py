"""``softmax_probabilities``: the kernel's launch plan and the wrapper at the
kernel's widths, against the JAX package.

``client_tpu_torch.ops.softmax_plan`` chooses, from the shapes alone, how
the Hopper kernel takes a batch of rows: whole rows in registers, two
passes for rows longer than a block's registers hold, or scalar loads for
rows that are not 16-byte aligned, and how many warps share a row. Here,
on the CPU, its choices are held to the rules the kernel relies on, and
the wrapper (its plain version, on CPU tensors) to the Pallas kernel in
interpret mode at widths that select every variant, within rtol 1e-5
(atol 1e-30: XLA flushes denormal probabilities), as tests/test_utils.py
holds it. The wrappers hand their float scalars to the kernels through
ctypes, which must round them to float32 as numpy does. The kernel itself
runs on the card only (chip_smoke.py).
"""

import ctypes
import ctypes.util

import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.ops as jax_ops
from client_tpu_torch import ops
from client_tpu_torch.ops import softmax as sm
from client_tpu_torch.ops.softmax import softmax_plan
from client_tpu_torch.utils import numpy_to_tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132
# widths around every boundary of the plan: a vector, a warp, the register
# width (8192 columns) and its next vector in either dtype
COLS = (1, 3, 8, 50, 1000, 1024, 2048, 2049, 4096, 5000, 8192, 8193, 8200)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _units(cols, dtype):
    """16-byte vectors of a row, or None when the row is not whole vectors."""
    elements = 16 // dtype.itemsize
    return cols // elements if cols % elements == 0 else None


# -- softmax_plan ------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", [1, 8, 16384])
def test_plan_keeps_the_kernels_rules(rows, cols, dtype):
    dtype = DTYPES[dtype]
    plan = softmax_plan(rows, cols, dtype, True, H100_SMS)
    units = _units(cols, dtype)
    if units is None:
        assert plan.variant == "scalar"
    else:
        assert plan.variant == ("registers" if cols <= sm.REGISTER_COLS else "two_pass")
    assert plan.warps in (1, 2, 4, 8)
    per_block = sm.WARPS_PER_BLOCK // plan.warps
    # every row has a group of warps: at once, or grid-stride past the cap
    assert 1 <= plan.blocks <= sm.MAX_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks * per_block >= rows or plan.blocks == sm.MAX_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks == -(-rows // per_block) or plan.blocks == sm.MAX_BLOCKS_PER_SM * H100_SMS
    if plan.variant == "registers":
        elements = 16 // dtype.itemsize
        # the registers hold the row, with the fewest vectors that do
        assert plan.vectors in sm.VECTORS and plan.vectors * elements <= sm.MAX_VALUES
        assert 32 * plan.warps * plan.vectors * elements >= cols
        smaller = [v for v in sm.VECTORS if v < plan.vectors]
        assert not smaller or 32 * plan.warps * smaller[-1] * elements < cols
    else:
        assert plan.vectors == 1


@pytest.mark.parametrize("variant,shape,dtype", [
    ("registers", (1, 1000), "float32"),
    ("registers", (16384, 1000), "bfloat16"),
    ("two_pass", (1, 8200), "float32"),
    ("two_pass", (16384, 8200), "bfloat16"),
    ("scalar", (3, 50), "float32"),
    ("scalar", (16384, 8193), "bfloat16"),
])
def test_plan_reaches_every_variant(variant, shape, dtype):
    assert softmax_plan(*shape, DTYPES[dtype], True, H100_SMS).variant == variant


@pytest.mark.parametrize("shape,want", [
    # the classifier's one row of 1000 logits: 8 warps, one float4 a thread
    ((1, 1000), ("registers", 8, 1, 1)),
    # rows that fill the card: a warp a row, 8 float4 a lane (250 of 256)
    ((16384, 1000), ("registers", 1, 8, 2048)),
])
def test_plan_at_the_timed_shapes(shape, want):
    assert tuple(softmax_plan(*shape, torch.float32, True, H100_SMS)) == want


@pytest.mark.parametrize("sms", [1, 66, 132, 264])
@pytest.mark.parametrize("share", [1, 2])
def test_plan_shares_a_row_among_warps_when_rows_are_fewer_than_the_sms(sms, share):
    rows = max(1, sms // share - 1) if sms > 1 else 1
    plan = softmax_plan(rows, 1000, torch.float32, True, sms)
    assert plan.warps > 1
    assert plan.blocks == -(-rows // (sm.WARPS_PER_BLOCK // plan.warps))


@pytest.mark.parametrize("sms", [66, 132, 264])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_gives_a_warp_a_row_when_rows_fill_the_card(sms, dtype):
    plan = softmax_plan(sm.WARPS_PER_SM * sms, 1000, DTYPES[dtype], True, sms)
    assert (plan.variant, plan.warps) == ("registers", 1)


@pytest.mark.parametrize("cols", [8, 1000, 4096, 8200])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_is_scalar_when_unaligned(cols, dtype):
    plan = softmax_plan(8, cols, DTYPES[dtype], False, H100_SMS)
    assert (plan.variant, plan.vectors) == ("scalar", 1)


def test_plan_is_scalar_for_a_bf16_row_that_is_not_whole_vectors():
    """A bf16 row is 16-byte aligned only when cols % 8 == 0."""
    assert softmax_plan(8, 1004, torch.bfloat16, True, H100_SMS).variant == "scalar"
    assert softmax_plan(8, 1004, torch.float32, True, H100_SMS).variant == "registers"


@pytest.mark.parametrize("args", [(0, 8), (8, 0), (8, 8, 0)])
def test_plan_rejects_empty_sizes(args):
    rows, cols, *sms = args
    with pytest.raises(ValueError):
        softmax_plan(rows, cols, torch.float32, True, *sms)


# -- the wrapper at the kernel's widths, against the Pallas kernel ----------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cols", [c for c in COLS if c != 50])
def test_softmax_matches_pallas_at_the_kernels_widths(cols, dtype):
    logits = np.random.default_rng(cols).standard_normal((3, cols)).astype(np.float32) * 8
    if dtype == "bfloat16":
        logits = logits.astype(ml_dtypes.bfloat16)
    got = ops.softmax_probabilities(numpy_to_tensor(logits, "cpu"))
    want = np.asarray(jax_ops.softmax_probabilities(logits))
    assert got.dtype == torch.float32 and tuple(got.shape) == logits.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-30)


# -- scalars through ctypes ---------------------------------------------------


EDGE_VALUES = [
    2.0 / 255.0, -1.0, 1.0 / 3.0, 0.1, 0.03 / 127,
    1 + 2.0 ** -24,                 # halfway: to even (1.0)
    1 + 3 * 2.0 ** -24,             # halfway: to even (1 + 2**-22)
    1 + 2.0 ** -24 + 2.0 ** -52,    # just past halfway: up
    -(1 + 2.0 ** -24),
    2.0 ** -149, 2.0 ** -150, 3 * 2.0 ** -150, 1.5e-39, -7e-46,  # subnormal
    3.4e38, -3.4e38, 3.4028234663852886e38, 0.0, -0.0,
]


@pytest.mark.parametrize("value", EDGE_VALUES, ids=[repr(v) for v in EDGE_VALUES])
def test_c_float_rounds_as_np_float32(value):
    """A float argument declared ctypes.c_float is rounded to float32 to
    nearest, ties to even, as np.float32 rounds it; so the wrappers pass
    Python floats to the kernels without numpy."""
    want = np.float32(value)
    assert ctypes.c_float(value).value == float(want)
    assert np.signbit(ctypes.c_float(value).value) == np.signbit(want)
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fabsf = libm.fabsf
    fabsf.argtypes, fabsf.restype = [ctypes.c_float], ctypes.c_float
    assert fabsf(value) == float(abs(want))
