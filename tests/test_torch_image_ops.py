"""The port's image and classification ops against the JAX package's.

``client_tpu_torch.ops.normalize_image`` and ``softmax_probabilities``
launch CUDA kernels for CUDA tensors and compute their plain versions for
CPU tensors. Here, on the CPU, the plain versions are held against the JAX
Pallas kernels (interpret mode off-TPU) on numpy-seeded inputs:

- normalize_image element for element for float32, uint8 and int32
  inputs, to float32, bfloat16 and float16, in image_client's INCEPTION and
  NONE modes; bfloat16 inputs to a bfloat16 tolerance (rtol 1e-2, as
  tests/test_models_parallel.py holds them), since XLA on the CPU rounds
  them at places of its own (float16 inputs: tests/test_torch_parity.py);
- softmax_probabilities within rtol 1e-5 (atol 1e-30: XLA flushes denormal
  probabilities), as tests/test_utils.py holds it;
- resize_nearest, preprocess_image, topk_classification (ties lowest index
  first, as ``jax.lax.top_k``) and the bf16 casts.

The kernels themselves run on the card only (chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.ops as jax_ops
from client_tpu_torch import ops
from client_tpu_torch.ops import _kernels
from client_tpu_torch.ops import normalize as normalize_module
from client_tpu_torch.ops import softmax as softmax_module
from client_tpu_torch.ops.normalize import normalize_image_reference
from client_tpu_torch.ops.softmax import softmax_probabilities_reference
from client_tpu_torch.utils import numpy_to_tensor, tensor_to_numpy

MODES = {"INCEPTION": (2.0 / 255.0, -1.0), "NONE": (1.0, 0.0)}
OUT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float16": (torch.float16, jnp.float16)}
SHAPES = {"lanes": (3, 8, 128), "image": (224, 224, 3), "ragged": (7, 13, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _image(shape, dtype, seed):
    x = np.random.default_rng(seed).uniform(0, 255, shape)
    return x.astype(dtype if dtype in ("uint8", "int32") else np.float32)


def _bits(t):
    return tensor_to_numpy(t).tobytes()


# -- normalize_image ---------------------------------------------------------


@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("in_dtype", ["float32", "uint8", "int32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_normalize_is_element_exact(shape, in_dtype, mode, out):
    scale, shift = MODES[mode]
    x = _image(SHAPES[shape], in_dtype, seed=len(shape) + len(mode))
    torch_out, jax_out = OUT[out]
    got = ops.normalize_image(torch.from_numpy(x), scale=scale, shift=shift, out_dtype=torch_out)
    want = np.asarray(jax_ops.normalize_image(x, scale=scale, shift=shift, out_dtype=jax_out))
    assert got.dtype == torch_out and tuple(got.shape) == x.shape
    assert _bits(got) == want.tobytes()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", ["lanes", "ragged"])
def test_normalize_bf16_input_within_bf16_tolerance(shape, mode):
    scale, shift = MODES[mode]
    x = _image(SHAPES[shape], "float32", seed=5).astype(ml_dtypes.bfloat16)
    got = ops.normalize_image(numpy_to_tensor(x, "cpu"), scale=scale, shift=shift,
                              out_dtype=torch.float32)
    want = np.asarray(jax_ops.normalize_image(x, scale=scale, shift=shift,
                                              out_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)


def test_normalize_rounds_once():
    """x * scale + shift where a float64 sum rounded again to float32 lands
    on a float32 midpoint: only a single rounding (the kernel's fmaf, XLA's
    fused multiply-add) gives 1 + 2**-23; rounding twice gives 1 + 2**-22."""
    x = np.full((8, 128), 1 + 2.0 ** -15, np.float32)
    scale = float(np.float32(2.0 ** -24 * (1 - 2.0 ** -15)))
    shift = float(np.float32(1 + 2.0 ** -23))
    want = np.asarray(jax_ops.normalize_image(x, scale=scale, shift=shift, out_dtype=jnp.float32))
    got = ops.normalize_image(torch.from_numpy(x), scale=scale, shift=shift,
                              out_dtype=torch.float32)
    assert float(got[0, 0]) == 1 + 2.0 ** -23
    assert _bits(got) == want.tobytes()
    twice = np.float32(np.float64(x[0, 0]) * scale + shift)
    assert float(twice) == 1 + 2.0 ** -22


def test_normalize_defaults_to_bf16_and_none_is_identity():
    x = _image((3, 8, 128), "float32", seed=1)
    out = ops.normalize_image(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    same = ops.normalize_image(torch.from_numpy(x), 1.0, 0.0, torch.float32)
    np.testing.assert_array_equal(same.numpy(), x)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.uint8, torch.bfloat16])
def test_normalize_empty(in_dtype):
    out = ops.normalize_image(torch.zeros((0, 3), dtype=in_dtype), 2.0 / 255.0, -1.0,
                              torch.float32)
    assert out.shape == (0, 3) and out.dtype == torch.float32


def test_normalize_special_values():
    x = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 255.0, 1e30])
    got = ops.normalize_image(x, 2.0 / 255.0, -1.0, torch.float32)
    want = np.asarray(jax_ops.normalize_image(x.numpy(), scale=2.0 / 255.0, shift=-1.0,
                                              out_dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


# -- normalize_plan: the kernel's grid -----------------------------------------


PATHS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.uint8, torch.float32), (torch.uint8, torch.bfloat16),
         (torch.float16, torch.float32), (torch.float16, torch.float16),
         (torch.uint8, torch.float16), (torch.int32, torch.float32),
         (torch.int32, torch.float16)]
PATH_IDS = [f"{str(a)[6:]}_to_{str(b)[6:]}" for a, b in PATHS]


@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
def test_normalize_plan_moves_whole_words_on_the_wider_side(path):
    """A thread takes 16 / max(in size, out size) elements: the widening
    paths store one 16-byte word per step."""
    in_dtype, out_dtype = path
    elements = normalize_module.normalize_plan(1000, in_dtype, out_dtype, True).elements
    assert elements * max(in_dtype.itemsize, out_dtype.itemsize) == 16
    assert normalize_module.normalize_plan(1000, in_dtype, out_dtype, False).elements == 1


@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32], ids=["uint8", "float32"])
def test_normalize_plan_fills_the_card_at_the_served_image(in_dtype):
    """The image_client's and the ensemble's (224, 224, 3) -> fp32 launch
    gives every one of the H100's 132 SMs a block."""
    plan = normalize_module.normalize_plan(224 * 224 * 3, in_dtype, torch.float32, True, 132)
    assert plan.blocks >= 132


@pytest.mark.parametrize("n", [1, 3, 15, 16, 17, 4 * 256 + 1, 150528, 1 << 24, 1 << 34])
@pytest.mark.parametrize("path", [PATHS[0], PATHS[4]], ids=[PATH_IDS[0], PATH_IDS[4]])
def test_normalize_plan_covers_every_element(n, path):
    """Enough threads for one step each, or the most blocks the card holds
    (the grid-stride loop takes the rest); never more blocks than work."""
    plan = normalize_module.normalize_plan(n, *path, True, 132)
    cap = normalize_module.BLOCKS_PER_SM * 132
    assert 1 <= plan.blocks <= cap
    assert plan.blocks == cap or plan.blocks * normalize_module.THREADS * plan.elements >= n
    assert (plan.blocks - 1) * normalize_module.THREADS * plan.elements < n


@pytest.mark.parametrize("sms", [1, 66, 132, 264])
def test_normalize_plan_follows_the_sm_count(sms):
    plan = normalize_module.normalize_plan(1 << 30, torch.uint8, torch.float32, True, sms)
    assert plan.blocks == normalize_module.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("args", [(0,), (16, 0)])
def test_normalize_plan_rejects_empty_sizes(args):
    n, *sms = args
    with pytest.raises(ValueError):
        normalize_module.normalize_plan(n, torch.uint8, torch.float32, True, *sms)


@pytest.mark.parametrize("words", [1, 2])
@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("path", [PATHS[0], PATHS[1], PATHS[4], PATHS[5]],
                         ids=[PATH_IDS[0], PATH_IDS[1], PATH_IDS[4], PATH_IDS[5]])
def test_normalize_is_element_exact_around_whole_words(path, delta, words):
    """Lengths one below and one above whole words of the kernel's threads,
    where its word loop meets the scalar tail."""
    in_dtype, out_dtype = path
    n = normalize_module.normalize_plan(1, in_dtype, out_dtype, True).elements * words + delta
    in_name = "uint8" if in_dtype == torch.uint8 else "float32"
    x = _image((n,), in_name, seed=n)
    scale, shift = MODES["INCEPTION"]
    out_name = "float32" if out_dtype == torch.float32 else "bfloat16"
    got = ops.normalize_image(torch.from_numpy(x), scale=scale, shift=shift, out_dtype=out_dtype)
    want = np.asarray(jax_ops.normalize_image(x, scale=scale, shift=shift,
                                              out_dtype=OUT[out_name][1]))
    assert _bits(got) == want.tobytes()


# -- softmax_probabilities ---------------------------------------------------


SOFTMAX_SHAPES = {"test_utils": (3, 50), "densenet": (1, 1000), "batch": (8, 1000),
                  "three_d": (2, 3, 17), "one_d": (1000,), "long_row": (2, 5000)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", list(SOFTMAX_SHAPES))
def test_softmax_matches_jax(shape, dtype):
    logits = np.random.default_rng(len(shape)).standard_normal(
        SOFTMAX_SHAPES[shape]).astype(np.float32) * 30  # stress stability
    if dtype != "float32":
        logits = logits.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float16)
    t = numpy_to_tensor(logits, "cpu")
    got = ops.softmax_probabilities(t)
    want = np.asarray(jax_ops.softmax_probabilities(logits))
    assert got.dtype == torch.float32 and got.shape == t.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(got.numpy().sum(axis=-1), 1.0, rtol=1e-5)


def test_softmax_one_d_is_the_first_row():
    logits = np.random.default_rng(5).standard_normal((3, 50)).astype(np.float32) * 30
    rows = ops.softmax_probabilities(torch.from_numpy(logits))
    one = ops.softmax_probabilities(torch.from_numpy(logits[0]))
    assert one.shape == (50,)
    np.testing.assert_allclose(one.numpy(), rows[0].numpy(), rtol=1e-6)


def test_softmax_all_minus_inf_row_is_nan():
    logits = np.array([[-np.inf] * 4, [0.0, 1.0, 2.0, 3.0]], np.float32)
    got = ops.softmax_probabilities(torch.from_numpy(logits)).numpy()
    want = np.asarray(jax_ops.softmax_probabilities(logits))
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


# -- the wrappers ------------------------------------------------------------


def _bad_case(name):
    """(call, expected): an exception, or the JAX call whose result the
    port's must equal bit for bit. JAX computes int32 and float16 inputs
    (NONE scaling, the default, is exact in float16 too), so the plain
    versions compute them; float16 softmax within tests/test_utils.py's
    rtol 1e-5."""
    x = torch.from_numpy(_image((4, 8), "float32", seed=12))
    jx = x.numpy()
    return {
        "normalize_int32": (lambda: ops.normalize_image(x.int()),
                            lambda: jax_ops.normalize_image(jx.astype(np.int32))),
        "normalize_fp16": (lambda: ops.normalize_image(x.half()),
                           lambda: jax_ops.normalize_image(jx.astype(np.float16))),
        "normalize_int8_out": (lambda: ops.normalize_image(x, out_dtype=torch.int8), TypeError),
        "normalize_non_contiguous": (lambda: ops.normalize_image(x.t()), ValueError),
        "normalize_meta": (lambda: ops.normalize_image(x.to("meta")), ValueError),
        "softmax_int64": (lambda: ops.softmax_probabilities(x.long()), TypeError),
        "softmax_fp16": (lambda: ops.softmax_probabilities(x.half() / 32),
                         lambda: jax_ops.softmax_probabilities((jx / 32).astype(np.float16))),
        "softmax_scalar": (lambda: ops.softmax_probabilities(torch.tensor(1.0)), ValueError),
        "softmax_empty_row": (lambda: ops.softmax_probabilities(torch.zeros(3, 0)), ValueError),
        "softmax_non_contiguous": (lambda: ops.softmax_probabilities(x.t()), ValueError),
        "softmax_meta": (lambda: ops.softmax_probabilities(x.to("meta")), ValueError),
    }[name]


@pytest.mark.parametrize("name", [
    "normalize_int32", "normalize_fp16", "normalize_int8_out", "normalize_non_contiguous",
    "normalize_meta", "softmax_int64", "softmax_fp16", "softmax_scalar", "softmax_empty_row",
    "softmax_non_contiguous", "softmax_meta",
])
def test_wrappers_reject_what_the_kernels_do_not_take(name):
    """Bad shapes, layouts and devices raise, and dtypes no JAX op here
    computes (int64, which JAX narrows to int32; int8 out, outside the float
    outputs the port writes); a dtype JAX computes is computed, with JAX's
    output dtype and values (on a CUDA tensor a dtype the kernel has no code
    for raises, chip_smoke.py checks)."""
    call, expected = _bad_case(name)
    if isinstance(expected, type):
        with pytest.raises(expected):
            call()
        return
    got, want = tensor_to_numpy(call()), np.asarray(expected())
    assert got.dtype == want.dtype and got.shape == want.shape
    if name.startswith("softmax"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    else:
        assert got.tobytes() == want.tobytes()


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    x = torch.from_numpy(_image((5, 33, 3), "uint8", seed=9))
    logits = torch.randn(4, 1000, generator=torch.Generator().manual_seed(0))
    before = (normalize_module.LAUNCHES.count, softmax_module.LAUNCHES.count)
    assert torch.equal(ops.normalize_image(x, 0.5, 0.25, torch.float32),
                       normalize_image_reference(x, 0.5, 0.25, torch.float32))
    assert torch.equal(ops.softmax_probabilities(logits),
                       softmax_probabilities_reference(logits))
    ops.preprocess_image(x, 16, 16)
    assert (normalize_module.LAUNCHES.count, softmax_module.LAUNCHES.count) == before
    assert not {"normalize_image", "softmax"} & set(_kernels.loaded())


def test_ops_package_exposes_the_functions():
    assert ops.normalize_image is normalize_module.normalize_image
    assert ops.softmax_probabilities is softmax_module.softmax_probabilities
    assert {"normalize_image", "softmax"} <= set(_kernels.sources())


# -- resize, preprocess, top-k, casts ---------------------------------------


RESIZES = [((300, 400), (224, 224)), ((100, 67), (224, 224)), ((224, 224), (224, 224)),
           ((7, 5), (13, 11)), ((1000, 31), (67, 100))]


@pytest.mark.parametrize("size,out", RESIZES, ids=[f"{s[0]}x{s[1]}_to_{o[0]}x{o[1]}"
                                                   for s, o in RESIZES])
def test_resize_nearest_is_exact(size, out):
    img = np.random.default_rng(size[0]).integers(0, 256, size + (3,)).astype(np.uint8)
    got = ops.resize_nearest(torch.from_numpy(img), *out)
    want = np.asarray(jax_ops.resize_nearest(img, *out))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [(300, 400), (224, 224), (61, 89)])
@pytest.mark.parametrize("in_dtype", ["uint8", "float32"])
def test_preprocess_image_matches_jax(size, in_dtype):
    img = _image(size + (3,), in_dtype, seed=size[1])
    got = ops.preprocess_image(torch.from_numpy(img))
    want = np.asarray(jax_ops.preprocess_image(img))
    assert got.dtype == torch.float32 and got.shape == (3, 224, 224) and got.is_contiguous()
    assert _bits(got) == want.tobytes()


def test_preprocess_image_other_size_and_dtype():
    img = _image((50, 40, 3), "uint8", seed=2)
    got = ops.preprocess_image(torch.from_numpy(img), 32, 24, scale=1.0, shift=0.0,
                               out_dtype=torch.bfloat16)
    want = np.asarray(jax_ops.preprocess_image(img, 32, 24, scale=1.0, shift=0.0,
                                               out_dtype=jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 32, 24)
    assert _bits(got) == want.tobytes()


# rows with ties: int32 and float, all equal, ties across k
TIED_ROWS = {
    "int32": np.array([[1, 3, 3, 1, 3], [2, 2, 0, 2, 2]], np.int32),
    "float": np.array([[0.5, 2.0, 0.5, 2.0, 2.0, -1.0], [1.0, 0.0, 1.0, 1.0, 0.0, 1.0]],
                      np.float32),
    "all_equal": np.zeros((3, 8), np.float32),
}


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", list(TIED_ROWS))
def test_topk_classification_ties_rank_as_lax_top_k(rows, k):
    """Ties lowest index first, as jax.lax.top_k ranks them (where k cuts
    through a tie, that also decides which classes are in): batched and one
    row alone."""
    x = TIED_ROWS[rows]
    values, indices = ops.topk_classification(torch.from_numpy(x), k)
    jv, ji = jax_ops.topk_classification(x, k)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    one_v, one_i = ops.topk_classification(torch.from_numpy(x[1]), k)
    np.testing.assert_array_equal(one_i.numpy(), np.asarray(ji)[1])
    np.testing.assert_array_equal(one_v.numpy(), np.asarray(jv)[1])


@pytest.mark.parametrize("k", [1, 3, 7])
def test_topk_classification_matches_jax(k):
    logits = np.random.default_rng(4).standard_normal((5, 100)).astype(np.float32)
    values, indices = ops.topk_classification(torch.from_numpy(logits), k)
    jv, ji = jax_ops.topk_classification(logits, k)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))


def test_bf16_casts_match_jax():
    x = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32) * 1e3
    b = ops.to_bf16(torch.from_numpy(x))
    assert b.dtype == torch.bfloat16
    assert _bits(b) == np.asarray(jax_ops.to_bf16(x)).tobytes()
    back = ops.from_bf16(b)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_ops.from_bf16(jax_ops.to_bf16(x))))


def test_stage_to_device():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = ops.stage_to_device(x, "cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x)
    assert ops.stage_to_device(t, "cpu") is t
