"""The port's long-context encoder and int8 wire path against the JAX package's.

- The port's ``LongContextEncoderModel`` with the JAX model's weights (the
  JAX model's own ``jax.random`` draw, repeated here and loaded through
  ``load_jax_params``) against ``client_tpu``'s flash-mode model on the same
  sequence, within the JAX tests' atol/rtol of 2e-5, at their widths and at
  the model's default width (dim 64, heads 4).
- The port's own seeded weights against a dense numpy/JAX computation.
- The port's HTTP server serving ``long_context_encoder`` and
  ``identity_int8`` to the port's client and to ``client_tpu.http``, over
  the wire and (on the CPU device here) over colocated cuda shared memory.
- The mesh modes (ring, ulysses, auto) over four CPU shards against the
  JAX model in the same mode over four devices, within 2e-5.
"""

import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models.long_context import LongContextEncoderModel as JaxEncoder
from client_tpu.parallel.ring import full_attention
from client_tpu_torch.models import LongContextEncoder, LongContextEncoderModel
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.models.long_context import draw_params, load_jax_params
from client_tpu_torch.ops import dequantize_int8, quantize_int8
from client_tpu_torch.ops.flash_attention import LAUNCHES
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.utils import InferenceServerException, numpy_to_tensor
from client_tpu_torch.utils import cuda_shared_memory as cudashm

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_weights(dim, seed):
    """client_tpu/models/long_context.py's draw, line for line."""
    rng = jax.random.PRNGKey(seed)
    kq, kk, kv, ko = jax.random.split(rng, 4)
    scale = dim ** -0.5
    return {name: np.asarray(jax.random.normal(key, (dim, dim), jnp.float32) * scale)
            for name, key in zip(("wq", "wk", "wv", "wo"), (kq, kk, kv, ko))}


def _sequence(seq, dim, seed):
    return np.random.default_rng(seed).standard_normal((seq, dim)).astype(np.float32)


def _encoded(model, x):
    out = model.execute({"sequence": x}, {})["encoded"]
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


# (seq, dim, heads): the JAX tests' sequences at dim 32 with heads 2 and at
# their own width, heads 4 (head dim 8), and the model's default width
WIDTHS = [(128, 32, 2), (100, 32, 2), (128, 64, 4), (100, 64, 4), (1, 64, 4), (257, 128, 4),
          (128, 32, 4), (100, 32, 4)]


@pytest.mark.parametrize("seq,dim,heads", WIDTHS,
                         ids=[f"s{s}_d{d}_h{h}" for s, d, h in WIDTHS])
def test_jax_weights_match_the_jax_flash_model(seq, dim, heads):
    port = LongContextEncoderModel(dim=dim, heads=heads, device="cpu")
    load_jax_params(port, jax_weights(dim, seed=0))
    ref = JaxEncoder(dim=dim, heads=heads, seed=0, attention="flash", n_devices=1)
    x = _sequence(seq, dim, seed=seq + dim)
    got = _encoded(port, x)
    assert got.dtype == np.float32 and got.shape == (seq, dim)
    np.testing.assert_allclose(got, _encoded(ref, x), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_own_draw_matches_dense_attention(seed):
    """The port's numpy-seeded weights, held against the same projections
    around client_tpu.parallel.ring.full_attention."""
    dim, heads, seq = 64, 4, 100
    weights = draw_params(dim, seed)
    port = LongContextEncoderModel(dim=dim, heads=heads, seed=seed, device="cpu")
    x = _sequence(seq, dim, seed=1)

    def project(w):
        return jnp.asarray(x @ w).reshape(1, seq, heads, dim // heads)

    attn = full_attention(project(weights["wq"]), project(weights["wk"]), project(weights["wv"]))
    want = np.asarray(attn).reshape(seq, dim) @ weights["wo"]
    np.testing.assert_allclose(_encoded(port, x), want, atol=TOL, rtol=TOL)


def test_draw_params_is_seeded_and_scaled():
    a, b, c = draw_params(64, 0), draw_params(64, 0), draw_params(64, 1)
    assert list(a) == ["wq", "wk", "wv", "wo"]
    for name in a:
        assert a[name].dtype == np.float32 and a[name].shape == (64, 64)
        np.testing.assert_array_equal(a[name], b[name])
        assert not np.array_equal(a[name], c[name])
    # N(0, 1) draws times dim**-0.5
    assert 0.1 < float(np.std(a["wq"])) < 0.15
    assert not np.array_equal(a["wq"], a["wk"])


def test_encoder_module_holds_frozen_weights():
    enc = LongContextEncoder(dim=64, heads=4, device="cpu")
    assert [n for n, _ in enc.named_parameters()] == ["wq", "wk", "wv", "wo"]
    assert not any(p.requires_grad for p in enc.parameters())


@pytest.mark.parametrize("mode", ["ring", "ulysses", "auto"])
def test_mesh_modes_raise(mode):
    """The mesh modes, which raised until ``parallel/`` was ported, now run:
    JAX's weights over a (4, 1) mesh of CPU shards against the JAX model in
    the same mode over four devices, within 2e-5; a sequence that does not
    divide raises JAX's message."""
    port = LongContextEncoderModel(attention=mode, device="cpu", n_devices=4)
    assert dict(port.mesh.shape) == {"data": 4, "model": 1}
    load_jax_params(port, jax_weights(64, seed=0))
    ref = JaxEncoder(dim=64, heads=4, seed=0, attention=mode, n_devices=4)
    x = _sequence(64, 64, seed=7)
    np.testing.assert_allclose(_encoded(port, x), _encoded(ref, x), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="divide") as ours:
        port.execute({"sequence": x[:63]}, {})
    with pytest.raises(ValueError) as theirs:
        ref.execute({"sequence": x[:63]}, {})
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kwargs,exc", [
    ({"attention": "dense"}, ValueError),
    ({"dim": 32, "heads": 4}, None),         # head dim 8: served, as JAX serves it
    ({"dim": 64, "heads": 3}, ValueError),   # does not divide
    ({"dim": 512, "heads": 2}, None),        # head dim 256: served, as JAX serves it
], ids=["unknown_mode", "head_dim_8", "indivisible", "head_dim_256"])
def test_bad_configurations_raise(kwargs, exc):
    """An unknown mode and a dim that the heads do not divide raise (JAX's
    model fails on them too); any head dim the heads give is served (the
    port's model used to refuse head dims its kernel did not take): with
    JAX's weights the port's encoder is JAX's flash model within 2e-5."""
    if exc is not None:
        with pytest.raises(exc):
            LongContextEncoderModel(device="cpu", **kwargs)
        return
    dim, heads = kwargs["dim"], kwargs["heads"]
    port = LongContextEncoderModel(device="cpu", **kwargs)
    load_jax_params(port, jax_weights(dim, seed=0))
    ref = JaxEncoder(dim=dim, heads=heads, seed=0, attention="flash", n_devices=1)
    x = _sequence(40, dim, seed=dim)
    np.testing.assert_allclose(_encoded(port, x), _encoded(ref, x), atol=TOL, rtol=TOL)


# the published widths the kernel's head dims up to 256 admit: Phi-3-mini
# (microsoft/Phi-3-mini-4k-instruct: hidden_size 3072, 32 attention heads,
# head dim 96) and Gemma-2B (google/gemma-2b: hidden_size 2048, 8 heads,
# head dim 256), at S <= 64 on the CPU
PUBLISHED = {"phi3_mini": (3072, 32), "gemma_2b": (2048, 8)}


@pytest.mark.parametrize("seq", [64, 33])
@pytest.mark.parametrize("width", list(PUBLISHED))
def test_published_widths_match_the_jax_flash_model(width, seq):
    """The encoder at both published widths, JAX's weights carried across by
    load_jax_params, against JAX's flash model on the same sequence: within
    the JAX tests' 2e-5 (the same bound as at the narrow widths; the
    projections' sums run over dim terms either way)."""
    dim, heads = PUBLISHED[width]
    port = LongContextEncoderModel(dim=dim, heads=heads, device="cpu")
    load_jax_params(port, jax_weights(dim, seed=0))
    ref = JaxEncoder(dim=dim, heads=heads, seed=0, attention="flash", n_devices=1)
    x = _sequence(seq, dim, seed=seq)
    got = _encoded(port, x)
    assert got.shape == (seq, dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _encoded(ref, x), atol=TOL, rtol=TOL)


# widths whose head dims are past 256, the wide flash kernels' (no published
# model in the records has one): dim 1040 over 2 heads (head dim 520, past
# two slabs of 256 columns) and dim 2048 over 4 heads (512, the width
# chip_smoke.py's phase 15 serves), at S = 16 on the CPU
WIDE_HEADS = [(1040, 2), (2048, 4)]


@pytest.mark.parametrize("dim,heads", WIDE_HEADS, ids=["head_dim_520", "head_dim_512"])
def test_head_dims_past_256_match_the_jax_flash_model(dim, heads):
    """The encoder at head dims past 256, JAX's weights carried across by
    load_jax_params, against JAX's flash model (its Pallas kernel in
    interpret mode) on the same sequence: within the JAX tests' 2e-5."""
    port = LongContextEncoderModel(dim=dim, heads=heads, device="cpu")
    load_jax_params(port, jax_weights(dim, seed=0))
    ref = JaxEncoder(dim=dim, heads=heads, seed=0, attention="flash", n_devices=1)
    x = _sequence(16, dim, seed=dim)
    got = _encoded(port, x)
    assert got.shape == (16, dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _encoded(ref, x), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("change", ["shape", "dtype", "missing"])
def test_load_jax_params_checks_its_arrays(change):
    model = LongContextEncoderModel(device="cpu")
    params = draw_params(64, 0)
    if change == "shape":
        params["wk"] = params["wk"][:32]
    elif change == "dtype":
        params["wv"] = params["wv"].astype(np.float64)
    else:
        del params["wo"]
    with pytest.raises(KeyError if change == "missing" else ValueError):
        load_jax_params(model, params)


def test_not_in_the_default_zoo():
    names = [m.name for m in default_model_zoo("cpu")]
    assert "long_context_encoder" not in names and "identity_int8" in names


# -- served ------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder():
    model = LongContextEncoderModel(dim=64, heads=4, device="cpu")
    load_jax_params(model, jax_weights(64, seed=0))
    return model


@pytest.fixture(scope="module")
def port_server(encoder):
    core = ServerCore(default_model_zoo("cpu") + [encoder], device="cpu")
    server = HttpInferenceServer(core).start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_reference():
    return JaxEncoder(dim=64, heads=4, seed=0, attention="flash", n_devices=1)


@pytest.mark.parametrize("seq", [1, 100, 300])
@pytest.mark.parametrize("http", [port_http, jax_http], ids=["port_client", "jax_client"])
def test_served_encoder(port_server, encoder, jax_reference, http, seq):
    x = _sequence(seq, 64, seed=seq)
    client = http.InferenceServerClient(port_server.url)
    try:
        inp = http.InferInput("sequence", [seq, 64], "FP32").set_data_from_numpy(x)
        out = client.infer("long_context_encoder", [inp]).as_numpy("encoded")
    finally:
        client.close()
    assert out.dtype == np.float32 and out.shape == (seq, 64)
    np.testing.assert_array_equal(out, _encoded(encoder, x))
    np.testing.assert_allclose(out, _encoded(jax_reference, x), atol=TOL, rtol=TOL)


def test_served_encoder_over_colocated_cuda_shm(port_server, encoder):
    """The input tensor reaches the model as the client's own tensor and the
    output is pinned in the output region, never mirrored to the host."""
    seq, dim = 100, 64
    x = torch.from_numpy(_sequence(seq, dim, seed=4))
    nbytes = x.numel() * 4
    names = [f"lc_{tag}_{uuid.uuid4().hex[:12]}" for tag in ("in", "out")]
    regions = [cudashm.create_shared_memory_region(n, nbytes, device="cpu", colocated=True)
               for n in names]
    client = port_http.InferenceServerClient(port_server.url)
    try:
        cudashm.set_shared_memory_region_from_torch(regions[0], x)
        for name, region in zip(names, regions):
            client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)
        inp = port_http.InferInput("sequence", [seq, dim], "FP32").set_shared_memory(
            names[0], nbytes)
        out = port_http.InferRequestedOutput("encoded")
        out.set_shared_memory(names[1], nbytes)
        client.infer("long_context_encoder", [inp], outputs=[out])
        y = cudashm.get_contents_as_torch(regions[1], "FP32", [seq, dim])
        np.testing.assert_array_equal(y.numpy(), _encoded(encoder, x.numpy()))
        for region in regions:
            assert not np.frombuffer(region.host_buffer(), dtype=np.uint8).any()
    finally:
        client.unregister_cuda_shared_memory()
        client.close()
        for region in regions:
            cudashm.destroy_shared_memory_region(region)


def test_served_encoder_rejects_a_wrong_width(port_server):
    client = port_http.InferenceServerClient(port_server.url)
    try:
        x = _sequence(8, 32, seed=0)
        inp = port_http.InferInput("sequence", [8, 32], "FP32").set_data_from_numpy(x)
        with pytest.raises(InferenceServerException, match="shape"):
            client.infer("long_context_encoder", [inp])
    finally:
        client.close()


def test_cpu_served_path_launches_nothing(port_server):
    before = LAUNCHES.count
    client = port_http.InferenceServerClient(port_server.url)
    try:
        x = _sequence(10, 64, seed=2)
        inp = port_http.InferInput("sequence", [10, 64], "FP32").set_data_from_numpy(x)
        client.infer("long_context_encoder", [inp])
    finally:
        client.close()
    assert LAUNCHES.count == before


@pytest.mark.parametrize("http", [port_http, jax_http], ids=["port_client", "jax_client"])
def test_int8_wire_path(port_server, http):
    """examples/quantized_wire_client.py with the port's ops: quantize,
    INT8 through identity_int8, dequantize; error within half a step."""
    x = np.random.default_rng(11).standard_normal((1, 8192)).astype(np.float32)
    scale = float(np.abs(x).max() / 127.0)
    q = quantize_int8(torch.from_numpy(x), scale).numpy()
    client = http.InferenceServerClient(port_server.url)
    try:
        inp = http.InferInput("INPUT0", list(q.shape), "INT8").set_data_from_numpy(q)
        q_back = client.infer("identity_int8", [inp]).as_numpy("OUTPUT0")
    finally:
        client.close()
    assert q_back.dtype == np.int8
    np.testing.assert_array_equal(q_back, q)
    restored = dequantize_int8(numpy_to_tensor(q_back, "cpu"), scale).numpy()
    assert np.abs(restored - x).max() <= scale / 2 + 1e-6
    assert q.nbytes * 4 == x.nbytes
