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
The head dims and dtypes the kernel took when it took every float dtype
and every head dim up to 256 (D = 8, 24, 80, 96, 256 in fp32, bf16 and
fp16) are held against the Pallas kernel too, as are head dims past 256
(D = 300, 512), integer and bool inputs at JAX's key tiles, the block
sizes JAX refuses and the ``interpret`` keyword, which the plain version
computes as JAX does. The kernels themselves run on the card only
(chip_smoke.py); here the CUDA path is driven up to the launch with the
launch faked, to show which kernel, element code, tile and dim each dtype
and head dim reaches.
"""

import itertools
import sys

import jax
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
    check_blocks,
    flash_attention,
    flash_attention_3xtf32_reference,
    flash_attention_reference,
    flash_attention_tiled_reference,
    runs_3xtf32,
    tf32_round,
    tf32_split,
)
from client_tpu_torch.utils import numpy_to_tensor
from test_torch_decode_attention import _FakeKernels, _integer_array

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the head dims of the kernel's first instantiations; the cases over them
# keep their names
DIMS = (16, 32, 64, 128)
# the head dims the kernel took once it took every dim up to 256:
# JAX's test width (8), Phi-3-mini's (96), Pythia's (80), Gemma-2B's (256)
# and one more that is no power of two (24)
NEW_DIMS = (8, 24, 80, 96, 256)
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
    elif dtype == "float16":
        arrays = [a.astype(np.float16) for a in arrays]
    return arrays


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _port(arrays, causal, **blocks):
    return flash_attention(*(numpy_to_tensor(a, "cpu") for a in arrays), causal=causal, **blocks)


def integer_flash_explained(q, k, v, causal, got, want):
    """Hold integer flash attention over one key tile (S <= block_k, so no
    padding) from the port (``got``) and the Pallas kernel in interpret mode
    (``want``) to the kernel's arithmetic, row by row.

    Rounding p to an integer dtype truncates it: exp(s - m) is 1 at the
    slots that hold the row's maximum score and truncates to 0 elsewhere,
    so a row is trunc(sum of v over the maximum's slots / l), l the sum of
    exp(s - m) over the live slots. Two things may move JAX's row off the
    port's, and nothing else:

    - XLA on the CPU contracts the kernel's ``dot * scale - m`` into one
      rounding where no mask stands between the product and the
      subtraction (non-causal, unpadded): a slot whose product
      fl(dot * scale) rounded then gets a residual of either sign, and
      exp(residual) < 1 truncates its p to 0
      (test_xla_contracts_the_unmasked_score_subtraction shows this);
      so JAX may drop any subset of those slots, and no other;
    - the two sum l in another order: the quotient is allowed l's
      rounding error, (live slots + 4) * 2^-23 relative, which moves the
      truncated value only where the quotient lies that close to an
      integer.

    The port's row must be the row with no slot dropped. Returns the number
    of rows where JAX dropped a slot."""
    batch, seq, heads, dim = q.shape
    scale = np.float32(dim ** -0.5)
    dot = np.einsum("bqhd,bkhd->bhqk", q.astype(np.int64), k.astype(np.int64))
    exact = dot * np.float64(scale)
    live = np.tril(np.ones((seq, seq), bool)) if causal else np.ones((seq, seq), bool)
    s = np.where(live, (dot.astype(np.float32) * scale).astype(np.float64), -np.inf)
    m = s.max(-1, keepdims=True)
    at_max = s == m
    droppable = at_max & (s != exact) & (not causal)
    l = np.exp(s - m).sum(-1)
    slack = (live.sum(-1) + 4) * 2.0 ** -23
    vf = v.astype(np.float64)
    dropped_rows = 0
    for b, h, i in np.ndindex(batch, heads, seq):
        slots = set(np.flatnonzero(at_max[b, h, i]).tolist())

        def holds(row, drop):
            a = vf[b, sorted(slots - set(drop)), h].sum(0)
            ends = np.trunc(a / (l[b, h, i] * (1 + slack[i]))), np.trunc(
                a / (l[b, h, i] * (1 - slack[i])))
            return bool(((np.minimum(*ends) <= row) & (row <= np.maximum(*ends))).all())

        where = f"row (b={b}, s={i}, h={h})"
        assert holds(got[b, i, h].astype(np.float64), ()), f"port {where} is not the kernel's"
        row = want[b, i, h].astype(np.float64)
        if holds(row, ()):
            continue
        candidates = np.flatnonzero(droppable[b, h, i]).tolist()
        assert len(candidates) <= 12, f"{where}: {len(candidates)} tied slots to try"
        assert any(holds(row, drop) for r in range(1, len(candidates) + 1)
                   for drop in itertools.combinations(candidates, r)), (
            f"JAX {where} = {row} is not the kernel's, with or without a rounded slot "
            "at the maximum dropped")
        dropped_rows += 1
    return dropped_rows


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
    rng = np.random.default_rng(shape[-1])
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                 for _ in range(3))


# the float16 plain version (dense, fp32) against the Pallas kernel, which
# rounds p to float16 before the PV product (2^-11 relative) and its output
# to float16 (half an ulp, as the port does): 3 * 2^-11 * max|v| < 2^-9 * max|v|
FP16_ATOL = 2.0 ** -9


def _bad_case(name):
    """(args, kwargs, expected): an exception, or "jax" where the JAX
    function computes the case and the port's plain version must agree
    with it (float16, int32, head dims the kernel does not take)."""
    q, k, v = _good()
    if name == "fp16":
        return (q.half(), k.half(), v.half()), {}, "jax"
    if name == "int32":
        return tuple((t * 2).round().int() for t in (q, k, v)), {}, "jax"
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
        return _good((1, 8, 2, int(name[3:]))), {}, "jax"
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
    """Mixed dtypes, bad shapes, blocks, layouts and devices raise, on any
    device, as they fail in JAX. What the kernels once did not take runs,
    on the card too: float16, int32 (the tiled kernel) and every head dim
    (chip_smoke.py checks); here the plain version computes each case, as
    the JAX function does, and agrees with the Pallas kernel: float16
    within FP16_ATOL * max|v|, int32 row by row as integer_flash_explained
    holds it, the head dims within the JAX tests' 2e-5."""
    args, kwargs, expected = _bad_case(name)
    if expected != "jax":
        with pytest.raises(expected):
            flash_attention(*args, **kwargs)
        return
    out = flash_attention(*args, **kwargs)
    want = jax_flash_attention(*(jnp.asarray(t.numpy()) for t in args))
    assert out.dtype == args[0].dtype and out.shape == want.shape
    if name == "int32":
        integer_flash_explained(*(t.numpy() for t in args), False, out.numpy(), np.asarray(want))
        return
    v_max = float(np.abs(args[2].float().numpy()).max())
    atol = FP16_ATOL * v_max if name == "fp16" else TOL["float32"]
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", [8, 100, 130])
@pytest.mark.parametrize("dim", [8, 48])
def test_plain_matches_pallas_at_head_dims_the_kernel_does_not_take(dim, seq, causal):
    """The plain version takes any D, as the JAX function does: D = 8 (and
    48) against the Pallas kernel in interpret mode and full_attention at
    the JAX tests' 2e-5."""
    arrays = _inputs((1, seq, 2, dim), "float32", seed=dim + seq)
    out = _port(arrays, causal)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    np.testing.assert_allclose(_f32(out), _f32(jax_flash_attention(jq, jk, jv, causal=causal)),
                               atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(_f32(out), _f32(full_attention(jq, jk, jv, causal=causal)),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("interpret", [None, True, False])
def test_interpret_keyword_changes_nothing(interpret):
    """The reference's keyword is accepted: the tensors' device decides what
    runs, so the result is the one without it."""
    arrays = _inputs((1, 64, 2, 16), "float32", seed=5)
    assert torch.equal(_port(arrays, True, interpret=interpret), _port(arrays, True))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_integer_inputs_follow_the_pallas_tiles(causal):
    """Rounding p to an integer dtype truncates it to 0 or 1, so the result
    depends on the key tiles: the CPU path walks JAX's (min(block_k, S)
    keys) in flash_attention_tiled_reference. A padded sequence (130 keys
    in tiles of 128 or 64) has JAX mask every score, so XLA does not
    contract the score subtraction (see integer_flash_explained): the two
    agree element for element."""
    rng = np.random.default_rng(31)
    arrays = [rng.integers(-3, 4, (1, 130, 2, 16)).astype(np.int8) for _ in range(3)]
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    for block_k in (128, 64):
        out = flash_attention(tq, tk, tv, causal=causal, block_k=block_k)
        assert out.dtype == torch.int8
        assert torch.equal(out, flash_attention_tiled_reference(tq, tk, tv, causal, block_k))
        want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                              block_k=block_k))
        assert want.dtype == np.int8 and want.shape == out.shape
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("dim", [8, 16, 32, 48, 64])
def test_xla_contracts_the_unmasked_score_subtraction(dim):
    """The cause integer_flash_explained allows for, shown in XLA itself:
    jitted on the CPU, ``exp(d * scale - m)`` with m = fl(d * scale) (the
    kernel's ``exp(s - m)`` at a slot holding the maximum, with no mask in
    between) is exp of the product's own rounding residual, not exp(0). It
    reads below 1 only where the product rounded up, above 1 only where it
    rounded down, and exactly 1 where the product is exact (every d at
    D = 16 and 64, whose scale is a power of two)."""
    scale = np.float32(dim ** -0.5)
    d = np.arange(-3000, 3000, dtype=np.float32)
    rounded = (d * scale).astype(np.float64)
    exact = d.astype(np.float64) * np.float64(scale)
    r = np.asarray(jax.jit(lambda d, m: jnp.exp(d * (dim ** -0.5) - m))(d, d * scale))
    assert (r[rounded == exact] == 1).all()
    assert (rounded[r < 1] > exact[r < 1]).all() and (rounded[r > 1] < exact[r > 1]).all()
    assert (r < 1).any() == (dim not in (16, 64))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
@pytest.mark.parametrize("dim", [8, 32, 48, 64])
def test_integer_one_tile_differs_from_pallas_only_where_explained(dim, dtype, causal):
    """Integer inputs at one key tile, against the Pallas kernel row by row
    (integer_flash_explained): exact but for the score subtraction XLA
    contracts (full attention at D = 8, 32, 48) and the order of l's sum."""
    rng = np.random.default_rng(dim)
    arrays = [rng.integers(0 if dtype == "uint8" else -7, 8, (1, 100, 2, dim)).astype(dtype)
              for _ in range(3)]
    out = flash_attention(*(torch.from_numpy(a) for a in arrays), causal=causal)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal))
    assert str(out.dtype) == f"torch.{dtype}" and want.dtype == dtype
    integer_flash_explained(*arrays, causal, out.numpy(), want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dim", DIMS + NEW_DIMS)
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


# ---------------------------------------------------------------------------
# the plain tiled version: the kernel's loop
# ---------------------------------------------------------------------------

# one bf16 ulp of the output, relative (2^-7): the tiled version and the
# Pallas kernel both round p to bf16 against a running max and round the
# output to bf16, so an output may land one ulp apart
TILED_BF16_TOL = 2.0 ** -7
TILE_SEQS = [1, 63, 64, 65, 130]


def _bf16_tensors(arrays):
    return [numpy_to_tensor(a, "cpu") for a in arrays]


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", TILE_SEQS)
def test_tiled_reference_matches_pallas_in_bf16(seq, causal, dim):
    """64-key tiles with p rounded to bf16 before PV, as the Pallas kernel
    at 64 x 64 blocks: within one bf16 ulp (tighter than the 2e-2 that the
    dense fp32 version needs)."""
    arrays = _inputs((1, seq, 2, dim), "bfloat16", seed=seq + dim)
    out = flash_attention_tiled_reference(*_bf16_tensors(arrays), causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == (1, seq, 2, dim)
    pallas = jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                 block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TILED_BF16_TOL,
                               rtol=TILED_BF16_TOL)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", TILE_SEQS)
def test_tiled_reference_matches_dense_in_fp32(seq, causal, dim):
    """In fp32 the rounding of p is a no-op: the tiled loop is the dense
    softmax within the JAX tests' 2e-5."""
    arrays = _inputs((2, seq, 2, dim), "float32", seed=seq * dim)
    tq, tk, tv = (numpy_to_tensor(a, "cpu") for a in arrays)
    out = flash_attention_tiled_reference(tq, tk, tv, causal=causal)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_reference(tq, tk, tv, causal)),
                               atol=TOL["float32"], rtol=TOL["float32"])
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    np.testing.assert_allclose(_f32(out), _f32(full_attention(jq, jk, jv, causal=causal)),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("block_k", [1, 16, 64, 200])
def test_tiled_reference_does_not_depend_on_the_tile(block_k):
    """Any key tile gives the dense result in fp32 (the kernel's 64 is a
    choice of speed, not of numbers)."""
    arrays = _inputs((1, 130, 2, 16), "float32", seed=block_k)
    tq, tk, tv = (numpy_to_tensor(a, "cpu") for a in arrays)
    for causal in (False, True):
        np.testing.assert_allclose(
            _f32(flash_attention_tiled_reference(tq, tk, tv, causal, block_k=block_k)),
            _f32(flash_attention_reference(tq, tk, tv, causal)),
            atol=TOL["float32"], rtol=TOL["float32"])


# ---------------------------------------------------------------------------
# every float dtype and the head dims up to 256
# ---------------------------------------------------------------------------

# one output ulp of each 2-byte dtype, relative and absolute: the tiled
# version and the Pallas kernel both round p to the dtype against a running
# max and round the output to it, so an output may land one ulp apart
TILED_TOL = {"float32": TOL["float32"], "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dim", NEW_DIMS)
def test_new_head_dims_match_pallas(dim, dtype, causal):
    """D = 8, 24, 80, 96 and 256 in every float dtype, at a ragged S of 70
    (two 64-key tiles, the second partial): the dense plain version against
    the Pallas kernel in interpret mode (fp32 within the JAX tests' 2e-5,
    bf16 within 2e-2, fp16 within FP16_ATOL * max|v|), and the tiled plain
    version (the kernel's loop: p rounded to the dtype before PV) against
    the Pallas kernel at 64 x 64 blocks within one ulp of the dtype."""
    arrays = _inputs((1, 70, 2, dim), dtype, seed=dim + 3 * len(dtype) + causal)
    tensors = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
               for a in arrays]
    out = flash_attention(*tensors, causal=causal)
    assert out.dtype == tensors[0].dtype and out.shape == (1, 70, 2, dim)
    pallas = jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                 block_q=64, block_k=64)
    assert str(pallas.dtype) == dtype
    v_max = float(np.abs(arrays[2].astype(np.float32)).max())
    atol = {"float32": TOL["float32"], "bfloat16": TOL["bfloat16"],
            "float16": FP16_ATOL * v_max}[dtype]
    rtol = {"float32": TOL["float32"], "bfloat16": TOL["bfloat16"], "float16": 0}[dtype]
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=atol, rtol=rtol)
    tiled = flash_attention_tiled_reference(*tensors, causal=causal)
    assert tiled.dtype == out.dtype
    np.testing.assert_allclose(_f32(tiled), _f32(pallas), atol=TILED_TOL[dtype],
                               rtol=TILED_TOL[dtype])


@pytest.mark.parametrize("dim", [1, 8, 96, 256, 264])
def test_head_dims_up_to_the_kernel_limit(dim):
    """The kernels have no head-dim limit any more (past 256 the wide
    kernels run on thread-block clusters, a block a slab of at most 128
    columns: ``wide_plan``): every dim passes the wrapper's checks and, on
    the CPU, computes the plain version, as the JAX function does (D = 264
    runs on the card too: chip_smoke.py checks D = 257 to 2304)."""
    q, k, v = _good((1, 8, 2, dim))
    out = flash_attention(q, k, v)
    assert out.shape == (1, 8, 2, dim)
    assert torch.equal(out, flash_attention_reference(q, k, v))
    assert not hasattr(sys.modules["client_tpu_torch.ops.flash_attention"], "MAX_DIM")


# ---------------------------------------------------------------------------
# the block sizes JAX refuses
# ---------------------------------------------------------------------------

# (seq, block_q, block_k): JAX clamps each block to min(block, seq), pads
# the sequence to a multiple of the larger and refuses where that length
# does not divide by both; the first two and the 40 / 100 / 64 / 70 / 24
# cases are refused, the rest run
BLOCK_CASES = [(40, 128, 16), (100, 64, 48), (130, 128, 64), (130, 64, 128), (48, 32, 16),
               (100, 128, 48), (300, 128, 48), (64, 48, 64), (70, 64, 48), (1, 128, 128),
               (65, 64, 64), (96, 32, 48), (24, 16, 24)]


@pytest.mark.parametrize("seq,block_q,block_k", BLOCK_CASES,
                         ids=[f"{s}_b{bq}x{bk}" for s, bq, bk in BLOCK_CASES])
def test_block_sizes_refused_where_jax_refuses(seq, block_q, block_k):
    """The port raises ValueError exactly where JAX's flash_attention does,
    with JAX's message, and where JAX runs, the port runs and agrees with
    it within the JAX tests' 2e-5."""
    arrays = _inputs((1, seq, 1, 8), "float32", seed=seq)
    try:
        want = jax_flash_attention(*(jnp.asarray(a) for a in arrays), block_q=block_q,
                                   block_k=block_k)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _port(arrays, False, block_q=block_q, block_k=block_k)
        assert str(got.value) == str(e)
        return
    out = _port(arrays, False, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("seq,block_q,block_k", [(40, 128, 16), (100, 64, 48), (130, 128, 64)])
def test_block_refusal_comes_before_any_device(seq, block_q, block_k, dtype):
    """check_blocks runs before the wrapper looks at the device: a tensor
    on the meta device (neither CPU nor CUDA) is refused for its blocks
    where JAX refuses them and for its device only where JAX runs, and
    nothing is launched either way (so a CUDA tensor is refused before any
    launch)."""
    q = torch.zeros((1, seq, 2, 16), dtype=dtype, device="meta")
    before = LAUNCHES.count
    try:
        check_blocks(seq, block_q, block_k)
        refused = None
    except ValueError as e:
        refused = str(e)
    with pytest.raises(ValueError) as got:
        flash_attention(q, q, q, block_q=block_q, block_k=block_k)
    if refused is None:
        assert "not meta" in str(got.value)
    else:
        assert str(got.value) == refused and "must divide by blocks" in refused
    assert LAUNCHES.count == before


# ---------------------------------------------------------------------------
# head dims past 256 and integer and bool inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dim", [300, 512])
def test_plain_matches_pallas_at_wide_head_dims(dim, causal):
    """D = 300 and 512 (the wide kernels' clusters of 3 and 4) at S = 40 in 16 x 16
    blocks (three tiles, the last padded): the dense plain version and the
    tiled one against the Pallas kernel in interpret mode within the JAX
    tests' 2e-5."""
    arrays = _inputs((1, 40, 2, dim), "float32", seed=dim + causal)
    tensors = [torch.from_numpy(a) for a in arrays]
    want = _f32(jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                    block_q=16, block_k=16))
    out = flash_attention(*tensors, causal=causal, block_q=16, block_k=16)
    assert out.shape == (1, 40, 2, dim)
    np.testing.assert_allclose(_f32(out), want, atol=TOL["float32"], rtol=TOL["float32"])
    tiled = flash_attention_tiled_reference(*tensors, causal=causal)
    np.testing.assert_allclose(_f32(tiled), want, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq,block_q,block_k", [(40, 16, 16), (100, 48, 48)],
                         ids=["40_b16", "100_b48"])
@pytest.mark.parametrize("dtype", ["uint8", "int16", "bool"])
def test_integer_inputs_follow_the_pallas_tiles_at_any_block(dtype, seq, block_q, block_k,
                                                            causal):
    """uint8, int16 and bool at key tiles of 16 and 48 (S = 40 and 100: JAX
    pads to 48 and 144, so it masks every score and XLA contracts nothing,
    see integer_flash_explained): the tiled plain version, which the tiled
    kernel's arithmetic follows, equals the Pallas kernel in interpret mode
    element for element."""
    rng = np.random.default_rng(seq + causal)
    arrays = [_integer_array(dtype, (1, seq, 2, 16), rng) for _ in range(3)]
    out = flash_attention(*(torch.from_numpy(a) for a in arrays), causal=causal,
                          block_q=block_q, block_k=block_k)
    assert str(out.dtype) == f"torch.{dtype}"
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                          block_q=block_q, block_k=block_k))
    assert want.dtype == dtype
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int16", "int32", "float32",
                                   "bfloat16", "float16"])
@pytest.mark.parametrize("dim", [16, 300])
def test_cuda_path_reaches_the_kernel_for_every_dtype_and_dim(monkeypatch, dtype, dim, causal):
    """The CUDA path (``_launch``, what a CUDA tensor runs) up to the launch:
    integer and bool inputs reach the tiled kernel with the dtype's element
    code, the tile min(block_k, S) and the dim; fp32, bf16 and fp16 reach
    the float kernels with the dim and, after the arguments of the first
    float kernels, at their positions, the wide plan's cluster size and
    groups (``wide_plan``: 3 and 1 at D = 300; 1 and 1, not read, at D =
    16). One launch is counted, no plain version runs."""
    module = sys.modules["client_tpu_torch.ops.flash_attention"]
    fake = _FakeKernels(monkeypatch, module)
    torch_dtype = getattr(torch, dtype)
    q, k, v = (t.to(torch_dtype) for t in _good((2, 40, 3, dim)))
    before = LAUNCHES.count
    out = module._launch(q, k, v, causal, 48)
    assert out.dtype == torch_dtype and out.shape == q.shape
    assert LAUNCHES.count == before + 1 and len(fake.calls) == 1
    (lib, symbol, nargs), args = fake.calls[0]
    assert lib == "flash_attention"
    # q, k, v, out, batch, seq, heads, dim, stride_b, stride_s, stride_h, ...
    assert args[4:11] == (2, 40, 3, dim, 40 * 3 * dim, 3 * dim, dim)
    if torch_dtype.is_floating_point:
        # ... dtype, scale, causal, cluster, groups (the stream is the launch's)
        assert (symbol, nargs) == ("flash_attention_launch", len(module._ARGTYPES))
        assert len(args) + 1 == nargs == 17
        assert args[11] == _kernels.FLOAT_CODES[torch_dtype] and args[13] == int(causal)
        plan = module.wide_plan(dim, torch_dtype) if dim > 256 else None
        assert args[14:] == ((plan.cluster, plan.groups) if plan else (1, 1))
        if plan:
            assert args[14:] == (3, 1)
    else:
        assert (symbol, nargs) == ("flash_attention_tiled_launch", len(module._TILED_ARGTYPES))
        # ... code, scale, causal, tile
        assert args[11] == _kernels.ELEMENT_CODES[torch_dtype]
        assert args[13:] == (int(causal), 40)
    assert args[12] == pytest.approx(dim ** -0.5)


# ---------------------------------------------------------------------------
# the wide kernels' plan: clusters of blocks over slabs of the head dim
# ---------------------------------------------------------------------------

WIDE_PLAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                    "float16": torch.float16}


@pytest.mark.parametrize("dtype", list(WIDE_PLAN_DTYPES))
@pytest.mark.parametrize("first", list(range(257, 4097, 960)),
                         ids=lambda d: f"from{d}")
def test_wide_plan_covers_every_dim(first, dtype):
    """``wide_plan`` for every D from 257 to 4096 (in four runs of 960): the
    slabs cover [0, D) once, in order, each starting on a multiple of 8,
    every one but the last a whole number of 8-column units, none wider
    than the plan's width (128) nor empty, and no two holding unit counts
    (the last one's partial unit counted whole) more than one apart;
    cluster * groups slabs, a cluster of 3 to 8 blocks (the kernels take
    no fewer); groups = ceil(D / (8 * 128)); a block's shared memory within
    the H100's 232,448 bytes, the same for every D of one group count, and
    two blocks an SM in bf16 and fp16 while Q stays resident."""
    module = sys.modules["client_tpu_torch.ops.flash_attention"]
    torch_dtype = WIDE_PLAN_DTYPES[dtype]
    smem_by_groups = {}
    for dim in range(first, min(first + 960, 4097)):
        plan = module.wide_plan(dim, torch_dtype)
        assert plan.width == module.WIDE_WIDTH == 128
        assert 3 <= plan.cluster <= module.WIDE_CLUSTER == 8
        assert plan.groups == -(-dim // (8 * 128))
        assert len(plan.bounds) == plan.cluster * plan.groups
        assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == dim
        widths = []
        for (start, end), (nxt, _) in zip(plan.bounds, plan.bounds[1:] + ((dim, None),)):
            assert end == nxt and start % 8 == 0 and 0 < end - start <= plan.width
            widths.append(end - start)
        assert all(w % 8 == 0 for w in widths[:-1])
        units = [-(-w // 8) for w in widths]
        assert max(units) - min(units) <= 1
        assert plan.smem_bytes <= 232448  # the H100's shared memory a block
        assert smem_by_groups.setdefault(plan.groups > 1, plan.smem_bytes) == plan.smem_bytes
        if dtype != "float32" and plan.groups == 1:
            # two blocks an SM while Q stays resident (228 KB an SM, 1 KB a
            # block reserved)
            assert 2 * (plan.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("dim,cluster,groups,widths", [
    (257, 3, 1, (88, 88, 81)),
    (300, 3, 1, (104, 104, 92)),
    (512, 4, 1, (128,) * 4),
    (576, 5, 1, (120, 120, 112, 112, 112)),
    (1024, 8, 1, (128,) * 8),
    (1025, 5, 2, (104,) * 9 + (89,)),
    (2048, 8, 2, (128,) * 16),
    (2304, 6, 3, (128,) * 18),
], ids=lambda x: str(x) if isinstance(x, int) else None)
def test_wide_plan_at_the_checked_dims(dim, cluster, groups, widths):
    """The plans of the head dims chip_smoke.py holds the wide kernels at:
    D = 257 splits evenly (three slabs of 88, 88 and 81 columns, not 256 +
    1); one cluster group up to 8 * 128 = 1024, two from 1025 (each group
    recomputes QK^T), three at 2304; the same plan in every float dtype,
    with a Q buffer more past one group (Q restaged a key tile): fp32 takes
    80 query rows a cluster in one group (211 KB of shared memory) and 64
    past it (222 KB), bf16 and fp16 64 rows (107 / 124 KB)."""
    module = sys.modules["client_tpu_torch.ops.flash_attention"]
    plans = {name: module.wide_plan(dim, t) for name, t in WIDE_PLAN_DTYPES.items()}
    for plan in plans.values():
        assert (plan.cluster, plan.groups) == (cluster, groups)
        assert tuple(end - start for start, end in plan.bounds) == widths
    assert plans["float32"].block_q == (80 if groups == 1 else 64)
    assert plans["bfloat16"].block_q == plans["float16"].block_q == 64
    assert plans["float32"].smem_bytes == (216000 if groups == 1 else 227328)
    assert plans["bfloat16"].smem_bytes == plans["float16"].smem_bytes == (
        109568 if groups == 1 else 126976)


@pytest.mark.parametrize("dim,dtype", [(256, torch.float32), (8, torch.bfloat16),
                                       (512, torch.float64), (512, torch.int8),
                                       (300.0, torch.float32)])
def test_wide_plan_refuses_what_no_wide_kernel_runs(dim, dtype):
    """Head dims up to 256 run the dense kernels, and only float32, bfloat16
    and float16 have wide kernels: ``wide_plan`` raises for the rest."""
    module = sys.modules["client_tpu_torch.ops.flash_attention"]
    with pytest.raises(ValueError):
        module.wide_plan(dim, dtype)


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic of the fp32 kernel for head dims 33-256
# ---------------------------------------------------------------------------

# (value, its cvt.rna.tf32 rounding), as float32 bit patterns reckoned by
# hand: TF32 keeps 10 mantissa bits, so its ulp at 1.0 is 2^-10 and half of
# it is the bit 0x1000
TF32_TABLE = [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (even would keep 1.0)
    (0x3F800FFF, 0x3F800000),  # just under the tie: down
    (0x3F803000, 0x3F804000),  # 1 + 3 * 2^-11, a tie: away, to 1 + 2^-9
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero on the negative side
    (0x3FFFFFFF, 0x40000000),  # 2 - 2^-23: the carry runs into the exponent
    (0x7F7FFFFF, 0x7F800000),  # the largest finite float rounds to inf
    (0x00000001, 0x00000000),  # the smallest subnormal rounds to +0
    (0x00001000, 0x00002000),  # a subnormal tie: away
    (0x00000FFF, 0x00000000),  # a subnormal under the tie: to +0
    (0x007FF000, 0x00800000),  # the largest subnormals' tie: to the smallest normal
    (0x80000000, 0x80000000),  # -0 stays -0
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
]


def _bits_to_f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def test_tf32_rounding_matches_the_hand_table():
    """``tf32_round`` rounds as ``cvt.rna.tf32.f32``: to nearest, ties away
    from zero, on the int32 view (ties, subnormals, the carry into the
    exponent, +-0 and +-inf); a NaN stays a NaN."""
    values = _bits_to_f32([b for b, _ in TF32_TABLE])
    got = tf32_round(values).numpy().view(np.uint32)
    assert [hex(b) for b in got] == [hex(want) for _, want in TF32_TABLE]
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    big, small = tf32_split(_bits_to_f32([0x3F801234]))
    assert big.view(torch.int32).item() == 0x3F802000
    # x - big = -0xDCC * 2^-23 has 11 significant bits: small holds it whole
    assert small.item() == -0xDCC * 2.0 ** -23
    assert (big + small).item() == _bits_to_f32([0x3F801234]).item()
    with pytest.raises(TypeError):
        tf32_round(torch.ones(2, dtype=torch.float64))


# the fp32 kernel's head dims for 3xTF32 (33-256; 40 and 80 run the padded
# widths 64 and 96 with columns zero-filled) at ragged lengths: one row, a
# partial second tile, three tiles
TF32_DIMS = (40, 64, 80, 96, 128, 256)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", [1, 65, 130])
@pytest.mark.parametrize("dim", TF32_DIMS)
def test_3xtf32_reference_matches_pallas(dim, seq, causal):
    """The 3xTF32 emulation of the fp32 kernel against the Pallas kernel in
    interpret mode within the fp32 gate, 2e-5, on the same inputs."""
    arrays = _inputs((2, seq, 2, dim), "float32", seed=dim + seq + causal)
    out = flash_attention_3xtf32_reference(
        *(numpy_to_tensor(a, "cpu") for a in arrays), causal=causal)
    assert out.dtype == torch.float32 and out.shape == (2, seq, 2, dim)
    pallas = jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                                 block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("heads,dim", [(32, 96), (8, 256)], ids=["phi3_mini", "gemma_2b"])
def test_3xtf32_reference_at_the_published_widths(heads, dim, causal):
    """Phi-3-mini's heads (32 of 96) and Gemma-2B's (8 of 256) at S = 256:
    the 3xTF32 emulation against the Pallas kernel within 2e-5."""
    arrays = _inputs((1, 256, heads, dim), "float32", seed=heads + dim + causal)
    out = flash_attention_3xtf32_reference(
        *(numpy_to_tensor(a, "cpu") for a in arrays), causal=causal)
    pallas = jax_flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_one_pass_tf32_misses_the_fp32_gate():
    """Why three products: one TF32 product a matmul (each operand rounded
    once) is off the Pallas kernel by more than the 2e-5 gate at Gemma-2B's
    head dim, where the 3xTF32 emulation is within it."""
    arrays = _inputs((1, 130, 2, 256), "float32", seed=5)
    q, k, v = (numpy_to_tensor(a, "cpu") for a in arrays)
    r = tf32_round
    s = torch.einsum("bqhd,bkhd->bhqk", r(q), r(k)) * 256 ** -0.5
    one_pass = torch.einsum("bhqk,bkhd->bqhd", r(torch.softmax(s, dim=-1)), r(v))
    pallas = _f32(jax_flash_attention(*(jnp.asarray(a) for a in arrays)))
    three = _f32(flash_attention_3xtf32_reference(q, k, v))
    gate = TOL["float32"] * (1 + np.abs(pallas))
    assert (np.abs(three - pallas) <= gate).all()
    assert (np.abs(_f32(one_pass) - pallas) > gate).any()


@pytest.mark.parametrize("dim,dtype,runs", [
    (32, torch.float32, False), (33, torch.float32, True), (96, torch.float32, True),
    (256, torch.float32, True), (257, torch.float32, False), (96, torch.bfloat16, False),
    (96, torch.float16, False)])
def test_runs_3xtf32_names_the_kernel_dims(dim, dtype, runs):
    """fp32 at head dims 33-256 (padded widths 64-256) runs the 3xTF32
    kernel; fp32 at 32 and below or past 256, and bf16 / fp16, do not."""
    assert runs_3xtf32(dim, dtype) is runs


def test_3xtf32_reference_takes_float32_only():
    q, k, v = _good((1, 8, 2, 64))
    with pytest.raises(TypeError):
        flash_attention_3xtf32_reference(q.bfloat16(), k.bfloat16(), v.bfloat16())

