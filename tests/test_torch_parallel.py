"""``client_tpu_torch.parallel`` against ``client_tpu.parallel``.

The port's mesh is a grid of ``torch.device``\\ s in one process; on the CPU
``local_devices("cpu")`` gives eight entries of the one CPU, as the JAX
tests' eight virtual devices (tests/conftest.py). The same inputs, drawn
from a numpy seed, go through both packages at the JAX tests' shapes
(tests/test_models_parallel.py) and tolerances:

- ``make_mesh`` shapes and its error;
- ring and Ulysses attention, causal and not, against JAX's and against
  both packages' ``full_attention`` (atol = rtol = 2e-5); the ``auto``
  dispatch; the indivisible cases raise JAX's messages;
- the collectives' block order (``all_to_all`` as ``lax.all_to_all``'s
  ``tiled=True`` inside ``shard_map``, ``ppermute``'s zeros);
- the pipeline against JAX's on JAX's own stage weights (1e-5);
- ``shard_params`` + ``sharded_forward`` of the densenet against the JAX
  module's unsharded forward (2e-2, JAX's bound);
- the encoder's mesh modes served over HTTP: each equal to JAX's model in
  that mode; an indivisible sequence a 400.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import client_tpu_torch.http as port_http
from client_tpu.models.long_context import LongContextEncoderModel as JaxEncoder
from client_tpu.models.vision import _build_flax_model
from client_tpu.parallel import make_mesh as jax_make_mesh
from client_tpu.parallel import pipeline as jax_pipeline
from client_tpu.parallel import ring as jax_ring
from client_tpu.parallel import ulysses as jax_ulysses
from client_tpu_torch import parallel
from client_tpu_torch.models import LongContextEncoderModel
from client_tpu_torch.models.long_context import load_jax_params
from client_tpu_torch.models.vision import DenseNetish
from client_tpu_torch.parallel import pipeline, ring, ulysses
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.utils import InferenceServerException
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


# -- meshes ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 2, 1, 6])
def test_make_mesh_shapes(n):
    ours = parallel.make_mesh(n, device="cpu")
    assert dict(ours.shape) == dict(jax_make_mesh(n).shape)
    assert list(ours.shape) == ["data", "model"] and ours.size == n
    assert set(ours.devices.flat) == {torch.device("cpu")}


def test_make_mesh_rejects_too_many_devices():
    with pytest.raises(ValueError) as ours:
        parallel.make_mesh(64, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_make_mesh(64)
    assert str(ours.value) == str(theirs.value) == "requested 64 devices but only 8 available"


def test_mesh_axes_and_local_devices():
    assert parallel.local_devices("cpu") == [torch.device("cpu")] * 8
    mesh = parallel.Mesh([["cpu", "cpu", "cpu"]], ("data", "model"))
    assert dict(mesh.shape) == {"data": 1, "model": 3}
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 3
    assert mesh.axis_devices("data") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("pipe")
    with pytest.raises(ValueError, match="axis names"):
        parallel.Mesh(["cpu", "cpu"], ("data", "model"))
    # the training step runs on this mesh: zero weights split over the three
    # model shards give the uniform loss log(3), and the update is the plain
    # full-batch gradient step
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 2, 1, 0])
    params = parallel.shard_params({"w": torch.zeros(4, 3, requires_grad=True)}, mesh)
    step = parallel.sharded_train_step(lambda p, xb: xb @ p["w"].full(),
                                       functools.partial(torch.optim.SGD, lr=0.5), mesh)
    params, opt, loss = step(params, None, x, labels)
    assert isinstance(opt, torch.optim.SGD)
    assert float(loss) == pytest.approx(np.log(3.0), rel=1e-6)
    grad = x.T @ (torch.full((6, 3), 1 / 3) - torch.eye(3)[labels]) / 6
    np.testing.assert_allclose(params["w"].full().detach().numpy(), -0.5 * grad.numpy(),
                               rtol=1e-5, atol=1e-7)


# -- collectives ------------------------------------------------------------------


@pytest.mark.parametrize("split_axis,concat_axis", [(2, 1), (1, 2), (0, 0), (1, 0)])
def test_all_to_all_is_lax_tiled(split_axis, concat_axis):
    """Four shards' blocks through the port's all_to_all and through
    ``lax.all_to_all(tiled=True)`` in a ``shard_map`` over four devices."""
    from jax import lax, shard_map

    n = 4
    x = np.random.default_rng(1).standard_normal((16, 8, 8, 3)).astype(np.float32)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("x",))
    want = shard_map(lambda b: lax.all_to_all(b, "x", split_axis, concat_axis, tiled=True),
                     mesh=jmesh, in_specs=P("x"), out_specs=P("x"))(jnp.asarray(x))
    devices = [torch.device("cpu")] * n
    blocks = list(torch.chunk(torch.from_numpy(x), n, 0))
    got = torch.cat(parallel.all_to_all(blocks, split_axis, concat_axis, devices), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ppermute_and_all_gather():
    devices = [torch.device("cpu")] * 3
    blocks = [torch.full((2,), float(i)) for i in range(3)]
    moved = parallel.ppermute(blocks, [(0, 1), (1, 2)], devices)
    assert [b.tolist() for b in moved] == [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]]
    gathered = parallel.all_gather(blocks, 0, devices)
    assert gathered[0] is gathered[2]  # shards of one device share one copy
    assert gathered[1].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]


def test_split_and_sharded():
    x = torch.arange(24.0).reshape(2, 12)
    sh = parallel.split(x, [torch.device("cpu")] * 4, 1)
    assert [s.shape for s in sh.shards] == [(2, 3)] * 4 and sh.shape == (2, 12)
    assert torch.equal(sh.full(), x) and np.array_equal(sh.numpy(), x.numpy())
    with pytest.raises(ValueError, match="divide"):
        parallel.split(x, [torch.device("cpu")] * 5, 1)
    with pytest.raises(ValueError, match="sharded along dim 1"):
        parallel.shards_of(sh, [torch.device("cpu")] * 4, 0)


# -- sequence parallelism -----------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_and_full_attention(causal):
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    (jq, jk, jv), (q, k, v) = _both(_qkv(0, (2, 32, 4, 16)))
    want = np.asarray(jax_ring.full_attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(ring.full_attention(q, k, v, causal=causal).numpy(), want,
                               atol=TOL, rtol=TOL)
    theirs = np.asarray(jax_ring.ring_attention(
        *(jax_ring.place_sharded(t, jmesh) for t in (jq, jk, jv)), jmesh, axis="data",
        causal=causal))
    got = ring.ring_attention(ring.place_sharded(q, mesh), k, v, mesh, axis="data",
                              causal=causal)
    assert isinstance(got, parallel.Sharded) and got.dim == 1 and len(got.shards) == 2
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), theirs, atol=TOL, rtol=TOL)


def test_ring_attention_rejects_indivisible_seq():
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    x = np.zeros((1, 7, 2, 4), np.float32)
    with pytest.raises(ValueError, match="divide") as ours:
        ring.ring_attention(*([torch.from_numpy(x)] * 3), mesh)
    with pytest.raises(ValueError) as theirs:
        jax_ring.ring_attention(*([jnp.asarray(x)] * 3), jmesh)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax_and_full_attention(causal):
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    n = mesh.shape["data"]
    shape = (2, (16 if causal else 8) * n, 2 * n, 16)
    (jq, jk, jv), (q, k, v) = _both(_qkv(7, shape))
    want = np.asarray(jax_ring.full_attention(jq, jk, jv, causal=causal))
    theirs = np.asarray(jax_ulysses.ulysses_attention(
        *(jax_ring.place_sharded(t, jmesh) for t in (jq, jk, jv)), jmesh, axis="data",
        causal=causal))
    got = ulysses.ulysses_attention(q, k, v, mesh, axis="data", causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, theirs, atol=TOL, rtol=TOL)
    if causal:  # position 0 attends to itself alone
        np.testing.assert_allclose(got[:, 0], v.numpy()[:, 0], atol=1e-6)


def test_sequence_parallel_dispatch():
    """auto takes the ring when the heads do not divide the axis (both
    exact); explicit Ulysses on such heads raises JAX's message."""
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    n = mesh.shape["data"]
    shape = (1, 8 * n, n + 1, 8)
    assert ulysses.auto_mode(shape, n) == "ring"
    assert ulysses.auto_mode((1, 8 * n, 2 * n, 8), n) == "ulysses"
    assert ulysses.auto_mode((1, 8192, 4, 16), 1) == "ring"  # 2 GiB of scores on one shard
    assert ulysses.auto_mode((1, 8192, 4, 16), 4) == "ulysses"
    q_np = _qkv(9, shape)[0]
    jq, q = jnp.asarray(q_np), torch.from_numpy(q_np)
    got = ulysses.sequence_parallel_attention(q, q, q, mesh, mode="auto").numpy()
    theirs = np.asarray(jax_ulysses.sequence_parallel_attention(
        *([jax_ring.place_sharded(jq, jmesh)] * 3), jmesh, mode="auto"))
    np.testing.assert_allclose(got, theirs, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ring.full_attention(q, q, q).numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="heads") as ours:
        ulysses.ulysses_attention(q, q, q, mesh)
    with pytest.raises(ValueError) as theirs_err:
        jax_ulysses.ulysses_attention(jq, jq, jq, jmesh)
    assert str(ours.value) == str(theirs_err.value)
    with pytest.raises(ValueError, match="unknown sequence-parallel mode"):
        ulysses.sequence_parallel_attention(q, q, q, mesh, mode="striped")


# -- pipeline -----------------------------------------------------------------------


def test_pipeline_parallel_matches_jax_and_sequential():
    """JAX's own stage weights, exported to numpy, through both pipelines
    over four stages (4 microbatches) and the port's sequential reference."""
    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    mesh = parallel.Mesh([["cpu"] * 4], ("data", "model"))
    jw, jb = jax_pipeline.mlp_stage_params(jax.random.PRNGKey(0), n_stages=4, dim=16)
    jx = jax.random.normal(jax.random.PRNGKey(1), (8, 16), jnp.float32)
    w, b, x = (torch.from_numpy(np.array(a)) for a in (jw, jb, jx))
    theirs = np.asarray(jax_pipeline.pipeline_forward(jw, jb, jx, jmesh, axis="model",
                                                      n_microbatches=4))
    want = pipeline.sequential_mlp(w, b, x).numpy()
    np.testing.assert_allclose(want, np.asarray(jax_pipeline.sequential_mlp(jw, jb, jx)),
                               atol=1e-5, rtol=1e-5)
    got = pipeline.pipeline_forward(w, b, x, mesh, axis="model", n_microbatches=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, theirs, atol=1e-5, rtol=1e-5)


def test_pipeline_parallel_validates_shapes():
    mesh = parallel.Mesh([["cpu"] * 4], ("data", "model"))
    w, b = pipeline.mlp_stage_params(0, n_stages=2, dim=8)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipeline_forward(w, b, torch.zeros((4, 8)), mesh)
    w, b = pipeline.mlp_stage_params(0, n_stages=4, dim=8)
    with pytest.raises(ValueError, match="n_microbatches"):
        pipeline.pipeline_forward(w, b, torch.zeros((6, 8)), mesh)
    assert w.dtype == torch.float32 and w.shape == (4, 8, 8) and b.shape == (4, 8)
    again = pipeline.mlp_stage_params(0, n_stages=4, dim=8)
    assert torch.equal(again[0], w) and torch.equal(again[1], b)


# -- tensor and data parallelism -------------------------------------------------------


def test_shard_params_rule():
    mesh = parallel.make_mesh(8, device="cpu")  # model axis of 4
    tree = {"a": torch.zeros(3, 8), "b": np.zeros((2, 6), np.float32), "c": torch.zeros(8),
            "d": [torch.zeros(2, 2, 12)]}
    placed = parallel.shard_params(tree, mesh)
    assert isinstance(placed["a"], parallel.Sharded) and placed["a"].dim == 1
    assert [s.shape for s in placed["a"].shards] == [(3, 2)] * 4
    assert isinstance(placed["b"], torch.Tensor)  # 6 does not divide by 4: replicated
    assert isinstance(placed["c"], torch.Tensor)  # 1-D: replicated
    assert placed["d"][0].dim == 2 and placed["d"][0].shape == (2, 2, 12)


def test_sharded_forward_matches_single_device():
    """The densenet of the JAX test (8 classes, width 8, 32 x 32 images in
    bf16): JAX's unsharded forward against the port's with the flax
    weights split by ``shard_params`` over the model axis (4) and the batch
    over the data axis (2), within JAX's 2e-2."""
    module = _build_flax_model(num_classes=8, width=8)
    rng = jax.random.PRNGKey(0)
    images = jax.random.normal(rng, (8, 32, 32, 3), jnp.bfloat16)
    params = jax.jit(module.init)(rng, images[:1])  # jitted: eager init takes ~30 s here
    expected = np.asarray(jax.jit(module.apply)(params, images))

    mesh = parallel.make_mesh(8, device="cpu")
    params_np = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    sharded = parallel.shard_params(params_np, mesh)
    net = DenseNetish(8, 8, device="cpu")
    net.load(params_np)
    net.shard(mesh)
    conv = sharded["params"]["Conv_0"]["kernel"]  # HWIO: the output channels split
    assert isinstance(conv, parallel.Sharded) and len(conv.shards) == 4
    assert torch.equal(net.stem_shards[0].shards[1], conv.shards[1].permute(3, 2, 0, 1)
                       .to(torch.bfloat16))
    run = parallel.sharded_forward(lambda model, block: model(block), mesh)
    nchw = torch.from_numpy(np.asarray(images.astype(jnp.float32))).permute(0, 3, 1, 2)
    got = run(net, nchw.contiguous())
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-2)


# -- the encoder's mesh modes, served ---------------------------------------------------


def _jax_weights(dim):
    """client_tpu/models/long_context.py's draw (seed 0), line for line."""
    kq, kk, kv, ko = jax.random.split(jax.random.PRNGKey(0), 4)
    return {name: np.asarray(jax.random.normal(key, (dim, dim), jnp.float32) * dim ** -0.5)
            for name, key in zip(("wq", "wk", "wv", "wo"), (kq, kk, kv, ko))}


@pytest.mark.parametrize("mode", ["ring", "ulysses", "auto"])
def test_encoder_mesh_mode_served(mode):
    """JAX's test shapes (seq 64, dim 32, 8 heads, eight devices): the
    port's model on JAX's weights served over HTTP equals JAX's model in
    that mode within 2e-5; 63 rows are a 400 naming the divisibility."""
    model = LongContextEncoderModel(dim=32, heads=8, attention=mode, device="cpu")
    assert dict(model.mesh.shape) == {"data": 8, "model": 1}
    load_jax_params(model, _jax_weights(32))
    ref = JaxEncoder(dim=32, heads=8, attention=mode)
    x = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(ref.execute({"sequence": x}, {})["encoded"])
    with HttpInferenceServer(ServerCore([model], device="cpu")) as server:
        with port_http.InferenceServerClient(server.url) as client:
            inp = port_http.InferInput("sequence", [64, 32], "FP32").set_data_from_numpy(x)
            got = client.infer("long_context_encoder", [inp]).as_numpy("encoded")
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
            again = client.infer("long_context_encoder", [inp]).as_numpy("encoded")
            np.testing.assert_array_equal(got, again)
            bad = port_http.InferInput("sequence", [63, 32], "FP32").set_data_from_numpy(x[:63])
            with pytest.raises(InferenceServerException, match="divide") as err:
                client.infer("long_context_encoder", [bad])
            assert err.value.status() == "400"
