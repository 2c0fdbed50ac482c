"""``client_tpu_torch.batch`` against ``client_tpu.batch``.

- ``plan_request``: the same seeded inputs and kwargs give the same plan
  in both packages (signature, rows, payload bytes, output signature and
  the canonical extra key), with and without a tenant; a tenant changes
  only the extra key, and the bypass cases are the same;
- the stacked request: the same queued calls stack into inputs whose HTTP
  infer body is byte-identical to the JAX stack's;
- the dispatcher: 8 threads against a full-batch cap coalesce into one
  wire request in each package (the cap ends the window, so no sleep
  decides it), every caller gets its own rows, and the result's
  ``as_torch`` holds them;
- the stacked request served by both packages' servers (``batched_matmul``
  on the CPU) returns each caller's rows within 1e-5 of a solo call.
"""

import threading

import numpy as np
import pytest
import torch

import client_tpu.batch as jax_batch
import client_tpu.http as jax_http
import client_tpu_torch.batch as port_batch
import client_tpu_torch.http as port_http
from client_tpu._base import InferenceServerClientBase as JaxBase
from client_tpu.http._utils import build_infer_body as jax_body
from client_tpu.models.batched import BatchedMatMulModel as JaxMatmul
from client_tpu.server import HttpInferenceServer as JaxServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch._base import InferenceServerClientBase as PortBase
from client_tpu_torch.http._utils import build_infer_body as port_body
from client_tpu_torch.models.batched import BatchedMatMulModel
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PKG = {
    "port": {"batch": port_batch, "http": port_http, "base": PortBase, "body": port_body},
    "jax": {"batch": jax_batch, "http": jax_http, "base": JaxBase, "body": jax_body},
}
DTYPES = [("FP32", np.float32), ("INT32", np.int32), ("FP16", np.float16),
          ("UINT8", np.uint8)]


def _inputs(mod, seed, rows=1, names=("X", "Z")):
    rng = np.random.default_rng(seed)
    out = []
    for k, name in enumerate(names):
        datatype, np_dtype = DTYPES[(seed + k) % len(DTYPES)]
        arr = (rng.standard_normal((rows, 3 + k)) * 10).astype(np_dtype)
        out.append(mod.InferInput(name, list(arr.shape), datatype).set_data_from_numpy(arr))
    return out


def _plan(pkg, seed, kwargs):
    plan = PKG[pkg]["batch"].plan_request(_inputs(PKG[pkg]["http"], seed), dict(kwargs))
    if plan is None:
        return None
    sig, rows, raw, out_sig, extra = plan
    return sig, rows, {k: bytes(v) for k, v in raw.items()}, out_sig, extra


KWARGS = [
    {},
    {"model_version": "2", "priority": 3},
    {"parameters": {"temperature": 0.5, "top_k": 4}},
    {"timeout": 1000, "request_id": "r1", "headers": {"a": "b"}},
    {"sequence_id": 7},  # sequences bypass
]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kwargs", KWARGS, ids=range(len(KWARGS)))
def test_plan_request_keys_match_jax(seed, kwargs):
    port = _plan("port", seed, kwargs)
    assert port == _plan("jax", seed, kwargs)
    tenant = _plan("port", seed, dict(kwargs, tenant="acme"))
    assert tenant == _plan("jax", seed, dict(kwargs, tenant="acme"))
    if port is not None:
        # the tenant is folded into the extra key and nowhere else
        assert tenant[:4] == port[:4] and tenant[4] != port[4]


def test_plan_request_bypasses_match_jax():
    for pkg in PKG:
        mod = PKG[pkg]["http"]
        plan = PKG[pkg]["batch"].plan_request
        assert plan([], {}) is None
        assert plan(_inputs(mod, 0), {"resilience": object()}) is None
        json_in = mod.InferInput("X", [1, 2], "FP32").set_data_from_numpy(
            np.ones((1, 2), np.float32), binary_data=False)
        assert plan([json_in], {}) is None
        ragged = _inputs(mod, 0) + [mod.InferInput("W", [2, 3], "FP32").set_data_from_numpy(
            np.ones((2, 3), np.float32))]
        assert plan(ragged, {}) is None


def _stacked_body(pkg, seeds, kwargs):
    mods = PKG[pkg]
    core = mods["batch"].BatchingClient(_Stub(mods["base"]), window_us=0)
    calls = []
    for seed in seeds:
        inputs = _inputs(mods["http"], seed % 2, rows=1 + seed % 3)
        key, rows, raw, sig = core._plan("m", inputs, dict(kwargs))
        calls.append(mods["batch"]._PendingCall(inputs, sig, raw, dict(kwargs), rows, None))
    inputs, kw, total = core._stack(calls)
    body, json_size = mods["body"](inputs, **{k: v for k, v in kw.items()
                                              if k in ("priority", "timeout", "parameters")})
    return body, json_size, total


@pytest.mark.parametrize("kwargs", KWARGS[:4], ids=range(4))
def test_stacked_http_body_is_byte_identical(kwargs):
    seeds = [0, 2, 4, 6]  # one signature (even seeds share dtypes), mixed rows
    port = _stacked_body("port", seeds, kwargs)
    assert port == _stacked_body("jax", seeds, kwargs)
    assert port[2] == sum(1 + s % 3 for s in seeds)


class _Result:
    def __init__(self, inputs):
        arr = np.frombuffer(bytes(inputs[0]._get_binary_data()), np.float32).reshape(
            inputs[0].shape())
        self._y = arr * 2.0
        self._response = {"model_name": "stub",
                          "outputs": [{"name": "Y", "datatype": "FP32",
                                       "shape": list(arr.shape)}]}

    def get_response(self):
        return self._response

    def get_output(self, name):
        return self._response["outputs"][0] if name == "Y" else None

    def as_numpy(self, name):
        return self._y if name == "Y" else None


def _Stub(base):
    class Stub(base):
        _FRONTEND = "stub"

        def __init__(self):
            super().__init__()
            self.calls = []

        def infer(self, model_name, inputs, **kwargs):
            self.calls.append([list(i.shape()) for i in inputs])
            return _Result(inputs)

        def close(self):
            pass

    return Stub()


def _coalesce(pkg, n=8):
    mods = PKG[pkg]
    inner = _Stub(mods["base"])
    # the cap equals the callers: the window ends when the batch is full
    client = mods["batch"].BatchingClient(inner, window_us=5e6, batch_max_rows=n)
    results = [None] * n

    def caller(i):
        x = np.full((1, 4), float(i), np.float32)
        inp = mods["http"].InferInput("X", [1, 4], "FP32").set_data_from_numpy(x)
        results[i] = client.infer("m", [inp])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    stats = client.stats()
    client.close()
    return inner.calls, results, stats


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_full_batch_coalesces_into_one_request(pkg):
    calls, results, stats = _coalesce(pkg)
    assert calls == [[[8, 4]]]
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.as_numpy("Y"), np.full((1, 4), 2.0 * i, np.float32))
    assert (stats["dispatches"], stats["coalesced_calls"]) == (1, 8)
    if pkg == "port":
        t = results[3].as_torch("Y", "cpu")
        assert t.dtype == torch.float32 and torch.equal(t, torch.full((1, 4), 6.0))


@pytest.fixture(scope="module")
def servers():
    made = [HttpInferenceServer(ServerCore([BatchedMatMulModel(device="cpu")],
                                           device="cpu")).start(),
            JaxServer(JaxCore([JaxMatmul()])).start()]
    yield [s.url for s in made]
    for s in made:
        s.stop()


@pytest.mark.parametrize("server", [0, 1], ids=["port_server", "jax_server"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_coalesced_rows_match_solo_calls(servers, pkg, server):
    mods = PKG[pkg]
    http = mods["http"]
    inner = http.InferenceServerClient(servers[server])
    md = inner.get_model_metadata("batched_matmul")
    name, width = md["inputs"][0]["name"], md["inputs"][0]["shape"][-1]
    out_name = md["outputs"][0]["name"]
    client = mods["batch"].BatchingClient(inner, window_us=5e6, batch_max_rows=8)
    rows = np.random.default_rng(3).standard_normal((8, width)).astype(np.float32)
    got = [None] * 8

    def caller(i):
        inp = http.InferInput(name, [1, width], "FP32").set_data_from_numpy(rows[i:i + 1])
        got[i] = client.infer("batched_matmul", [inp]).as_numpy(out_name)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert client.stats()["dispatches"] == 1
    for i in range(8):
        inp = http.InferInput(name, [1, width], "FP32").set_data_from_numpy(rows[i:i + 1])
        solo = inner.infer("batched_matmul", [inp]).as_numpy(out_name)
        np.testing.assert_allclose(got[i], solo, atol=1e-5, rtol=1e-5)
    client.close()
