"""Expert parallelism: ``client_tpu_torch.parallel.moe`` and ``moe_ffn``
against the JAX package's.

The same tokens and weights (drawn from a numpy seed, or JAX's own
``jax.random`` draw exported to numpy) through both packages on the CPU, at
the JAX tests' shapes (tests/test_models_parallel.py), the port's mesh over
CPU shards:

- the dispatch at full capacity against JAX's ``moe_ffn`` and both dense
  references (atol = rtol = 2e-5);
- with capacity drops: every row the dense row or exactly zero, the same
  rows dropped as JAX's;
- routing ties go to the first expert, as ``jnp.argmax``;
- the divisibility errors carry JAX's messages;
- ``moe_ffn`` served over HTTP (``n_devices`` pinned, since the expert
  count follows the mesh) on JAX's weights, equal to JAX's model; 63
  tokens a 400.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models.moe import MoEFFNModel as JaxMoE
from client_tpu.parallel import make_mesh as jax_make_mesh
from client_tpu.parallel import moe as jax_moe
from client_tpu_torch import parallel
from client_tpu_torch.models.moe import MoEFFNModel, draw_params, load_jax_params
from client_tpu_torch.parallel import moe
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


def _problem(seed, tokens, d, h, n_experts):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens, d)).astype(np.float32)
    gate_w = rng.standard_normal((d, n_experts)).astype(np.float32)
    w1 = (rng.standard_normal((n_experts, d, h)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((n_experts, h, d)) * 0.1).astype(np.float32)
    return x, gate_w, w1, w2


def _jax_moe(arrays, mesh, capacity=0):
    x, gate_w, w1, w2 = (jnp.asarray(a) for a in arrays)
    xs = jax.device_put(x, NamedSharding(mesh, P("model", None)))
    w1s = jax.device_put(w1, NamedSharding(mesh, P("model", None, None)))
    w2s = jax.device_put(w2, NamedSharding(mesh, P("model", None, None)))
    return np.asarray(jax_moe.moe_ffn(xs, gate_w, w1s, w2s, mesh, axis="model",
                                      capacity=capacity))


def test_moe_expert_parallel_matches_jax_and_dense():
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    n = mesh.shape["model"]
    arrays = _problem(3, 16 * n, 16, 32, 2 * n)
    want = np.asarray(jax_moe.dense_moe_reference(*(jnp.asarray(a) for a in arrays)))
    x, gate_w, w1, w2 = (torch.from_numpy(a) for a in arrays)
    np.testing.assert_allclose(moe.dense_moe_reference(x, gate_w, w1, w2).numpy(), want,
                               atol=TOL, rtol=TOL)
    got = moe.moe_ffn(x, gate_w, w1, w2, mesh, axis="model")
    assert isinstance(got, parallel.Sharded) and got.dim == 0 and len(got.shards) == n
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), _jax_moe(arrays, jmesh), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_moe_capacity_drops_are_bounded_not_wrong(capacity):
    """A token past its expert's capacity drops to a zero row, never to
    another token's result; the same rows drop as in JAX."""
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    n = mesh.shape["model"]
    arrays = _problem(5, 8 * n, 8, 16, n)
    x, gate_w, w1, w2 = (torch.from_numpy(a) for a in arrays)
    dense = moe.dense_moe_reference(x, gate_w, w1, w2).numpy()
    got = moe.moe_ffn(x, gate_w, w1, w2, mesh, axis="model", capacity=capacity).numpy()
    theirs = _jax_moe(arrays, jmesh, capacity=capacity)
    matches = np.isclose(got, dense, atol=TOL).all(axis=-1)
    zeros = (got == 0).all(axis=-1)
    assert (matches | zeros).all() and matches.sum() > 0 and zeros.sum() > 0
    np.testing.assert_array_equal(zeros, (theirs == 0).all(axis=-1))
    np.testing.assert_allclose(got, theirs, atol=TOL, rtol=TOL)


def test_routing_ties_go_to_the_first_expert():
    mesh = parallel.Mesh([["cpu"] * 2], ("data", "model"))
    x = torch.ones((4, 2))
    gate_w = torch.zeros((2, 4))  # every score ties
    w1 = torch.stack([torch.eye(2) * (e + 1) for e in range(4)])
    w2 = torch.stack([torch.eye(2)] * 4)
    got = moe.moe_ffn(x, gate_w, w1, w2, mesh).full()
    # gate 0: every row is zero, but routed to expert 0 (slots 0 and 1 of it)
    assert torch.equal(got, torch.zeros((4, 2)))
    gate_w = torch.tensor([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    got = moe.moe_ffn(x, gate_w, w1, w2, mesh).full()
    assert torch.equal(got, torch.ones((4, 2)))  # expert 0 (x 1), not expert 1 (x 2)


def test_moe_divisibility_errors_match_jax():
    mesh, jmesh = parallel.make_mesh(8, device="cpu"), jax_make_mesh(8)
    for tokens, experts in ((15, 8), (16, 6)):
        arrays = _problem(0, tokens, 4, 8, experts)
        with pytest.raises(ValueError) as ours:
            moe.moe_ffn(*(torch.from_numpy(a) for a in arrays), mesh)
        with pytest.raises(ValueError) as theirs:
            jax_moe.moe_ffn(*(jnp.asarray(a) for a in arrays), jmesh)
        assert str(ours.value) == str(theirs.value)


def _jax_model_weights(dim, hidden, n_experts, seed=0):
    """client_tpu/models/moe.py's draw, line for line."""
    kg, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    scale = dim ** -0.5
    return {
        "gate_w": np.asarray(jax.random.normal(kg, (dim, n_experts), jnp.float32) * scale),
        "w1": np.asarray(jax.random.normal(k1, (n_experts, dim, hidden), jnp.float32) * scale),
        "w2": np.asarray(jax.random.normal(k2, (n_experts, hidden, dim), jnp.float32) * scale),
    }


def test_model_draw_and_validation():
    model = MoEFFNModel(device="cpu", n_devices=4)
    assert dict(model.mesh.shape) == {"data": 1, "model": 4} and model.n_experts == 8
    assert [s.shape for s in model.w1.shards] == [(2, 32, 64)] * 4
    drawn = draw_params(32, 64, 8, 0)
    np.testing.assert_array_equal(model.gate_w.numpy(), drawn["gate_w"])
    assert MoEFFNModel(device="cpu").n_experts == 16  # 0: every local device
    with pytest.raises(ValueError, match="only 8 available"):
        MoEFFNModel(device="cpu", n_devices=9)
    with pytest.raises(ValueError, match="w1 must be float32"):
        load_jax_params(model, dict(drawn, w1=drawn["w1"][:4]))


def test_moe_ffn_served_matches_jax():
    """Both packages' models on JAX's weights over four devices, served over
    HTTP to both clients: the port's answer equals JAX's within 2e-5 and is
    deterministic; an indivisible token count is a 400."""
    dim, hidden = 16, 32
    port = MoEFFNModel(dim=dim, hidden=hidden, device="cpu", n_devices=4)
    load_jax_params(port, _jax_model_weights(dim, hidden, port.n_experts))
    theirs = JaxMoE(dim=dim, hidden=hidden, n_devices=4)
    tokens = np.random.default_rng(1).standard_normal((64, dim)).astype(np.float32)
    want = np.asarray(theirs.execute({"tokens": tokens}, {})["routed"])
    with HttpInferenceServer(ServerCore([port], device="cpu")) as server:
        for mod in (port_http, jax_http):
            with mod.InferenceServerClient(server.url) as client:
                assert client.get_model_metadata("moe_ffn")["platform"] == "pytorch_moe_ep"
                inp = mod.InferInput("tokens", [64, dim], "FP32")
                inp.set_data_from_numpy(tokens)
                out = client.infer("moe_ffn", [inp]).as_numpy("routed")
                np.testing.assert_allclose(out, want, atol=TOL, rtol=TOL)
                np.testing.assert_array_equal(
                    out, client.infer("moe_ffn", [inp]).as_numpy("routed"))
        with port_http.InferenceServerClient(server.url) as client:
            bad = port_http.InferInput("tokens", [63, dim], "FP32")
            bad.set_data_from_numpy(tokens[:63])
            with pytest.raises(InferenceServerException, match="divide") as err:
                client.infer("moe_ffn", [bad])
            assert err.value.status() == "400"
