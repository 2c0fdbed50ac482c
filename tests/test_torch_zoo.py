"""The port's default model zoo, its new fixtures and the dynamic batcher,
against the JAX package's.

- the zoo: the JAX zoo's models in its order, minus
  ``decoder_lm_tp_prefill``, which waits for a later ROADMAP item, each
  with the JAX model's wire signature;
- the fixtures (``simple_string``, ``simple_identity``,
  ``custom_identity_int32``, ``identity_fp16``, ``simple_sequence``,
  ``batched_matmul``, ``repeat_int32``) on the 2x2 client/server matrix of
  tests/test_torch_server.py, outputs equal to the JAX server's;
- the dynamic batcher against the JAX package's on the same submissions,
  and in the core over HTTP. Coalescing is made deterministic by a long
  window that closes when the declared batch fills.

Servers bind ephemeral ports; every wait has a timeout.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import urllib3

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.models.batched import BatchedMatMulModel as JaxBatchedMatMul
from client_tpu.models.simple import IdentityModel as JaxIdentity
from client_tpu.models.simple import RepeatModel as JaxRepeat
from client_tpu.models.simple import SequenceAccumulatorModel as JaxSequence
from client_tpu.models.simple import StringAddSubModel as JaxStringAddSub
from client_tpu.server import HttpInferenceServer as JaxServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu.server.batcher import DynamicBatcher as JaxBatcher
from client_tpu_torch.models import BatchedMatMulModel, IdentityModel, default_model_zoo
from client_tpu_torch.models.base import Model, TensorSpec
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.server.batcher import DynamicBatcher
from client_tpu_torch.server.core import InferError

WAIT_S = 60
# in the JAX zoo, not in the port's: none since decoder_lm_tp_prefill came
NOT_YET = set()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the zoo --------------------------------------------------------------------


def test_zoo_is_the_jax_zoo_minus_the_later_items():
    names = [m.name for m in default_model_zoo("cpu")]
    assert names == [m.name for m in jax_zoo() if m.name not in NOT_YET]
    assert NOT_YET <= {m.name for m in jax_zoo()}


def _signature(model):
    specs = [(t.name, t.datatype, list(t.shape), t.optional)
             for t in model.inputs() + model.outputs()]
    return specs, model.max_batch_size, model.decoupled, model.stateful


@pytest.mark.parametrize("name", [m.name for m in jax_zoo() if m.name not in NOT_YET])
def test_zoo_model_has_the_jax_signature(name):
    ours = {m.name: m for m in default_model_zoo("cpu")}[name]
    theirs = {m.name: m for m in jax_zoo()}[name]
    assert _signature(ours) == _signature(theirs)
    assert ours.platform == "pytorch"


def test_zoo_shares_one_decoder():
    zoo = {m.name: m for m in default_model_zoo("cpu")}
    decoder = zoo["decoder_lm"]
    for name in ("tiny_lm_generate", "decoder_lm_prefill", "decoder_lm_disagg_prefill",
                 "decoder_lm_kv_decode"):
        assert zoo[name]._decoder is decoder, name
    batched = zoo["decoder_lm_batched"]._decoder
    assert batched is not decoder and batched.device == decoder.device == torch.device("cpu")


# -- the fixtures on the 2x2 client/server matrix ---------------------------------


@pytest.fixture(scope="module")
def port_server():
    server = HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_server():
    core = JaxCore([JaxBatchedMatMul(), JaxStringAddSub(), JaxIdentity("simple_identity", "BYTES"),
                    JaxIdentity("custom_identity_int32", "INT32", delay_s=0.0),
                    JaxIdentity("identity_fp16", "FP16"), JaxSequence(), JaxRepeat()])
    server = JaxServer(core).start()
    yield server
    server.stop()


def _fixture_calls(http, client, model):
    """The model's requests through ``client``: {output name: array}."""
    def infer(inputs, **kwargs):
        ins = []
        for name, (datatype, arr) in inputs.items():
            ins.append(http.InferInput(name, list(arr.shape), datatype).set_data_from_numpy(arr))
        return client.infer(model, ins, **kwargs)

    if model == "simple_string":
        a = np.array([[str(i).encode() for i in range(16)]], dtype=np.object_)
        b = np.array([[str(3 - 2 * i).encode() for i in range(16)]], dtype=np.object_)
        r = infer({"INPUT0": ("BYTES", a), "INPUT1": ("BYTES", b)})
        return {n: r.as_numpy(n) for n in ("OUTPUT0", "OUTPUT1")}
    if model == "simple_identity":
        x = np.array([[b"a", b"", b"\x00bytes"], [b"x" * 40, b"y", b"z"]], dtype=np.object_)
        return {"OUTPUT0": infer({"INPUT0": ("BYTES", x)}).as_numpy("OUTPUT0")}
    if model == "custom_identity_int32":
        x = np.arange(-6, 6, dtype=np.int32).reshape(3, 4)
        return {"OUTPUT0": infer({"INPUT0": ("INT32", x)}).as_numpy("OUTPUT0")}
    if model == "identity_fp16":
        x = np.random.default_rng(8).standard_normal((2, 33)).astype(np.float16)
        return {"OUTPUT0": infer({"INPUT0": ("FP16", x)}).as_numpy("OUTPUT0")}
    if model == "simple_sequence":
        totals = []
        for i, value in enumerate((5, -2, 40)):
            r = infer({"INPUT": ("INT32", np.array([[value]], np.int32))},
                      sequence_id=4242, sequence_start=i == 0, sequence_end=i == 2)
            totals.append(r.as_numpy("OUTPUT"))
        return {"OUTPUT": np.concatenate(totals)}
    x = np.random.default_rng(9).standard_normal((3, 64)).astype(np.float32)
    return {"Y": infer({"X": ("FP32", x)}).as_numpy("Y")}


FIXTURES = ["simple_string", "simple_identity", "custom_identity_int32", "identity_fp16",
            "simple_sequence", "batched_matmul"]


@pytest.mark.parametrize("model", FIXTURES)
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_fixture_matrix(port_server, jax_server, client, server, model):
    """Every client against every server: the same outputs as the JAX client
    gets from the JAX server (batched_matmul within 1e-5: the two packages
    sum the fp32 products in their own orders)."""
    http = port_http if client == "port" else jax_http
    c = http.InferenceServerClient((port_server if server == "port" else jax_server).url)
    want_client = jax_http.InferenceServerClient(jax_server.url)
    try:
        got = _fixture_calls(http, c, model)
        want = _fixture_calls(jax_http, want_client, model)
    finally:
        c.close()
        want_client.close()
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape
        if model == "batched_matmul":
            np.testing.assert_allclose(got[name], arr, rtol=1e-5, atol=1e-5)
        else:
            assert got[name].tolist() == arr.tolist()
    if model == "simple_sequence":
        assert got["OUTPUT"].reshape(-1).tolist() == [5, 3, 43]


def _raw_stream(url, model, payload):
    host, port = url.split(":")
    pool = urllib3.HTTPConnectionPool(host, int(port), retries=False)
    try:
        resp = pool.request("POST", f"/v2/models/{model}/generate_stream", body=payload,
                            headers={"Content-Type": "application/json"})
        return resp.status, resp.headers.get("Content-Type"), resp.data
    finally:
        pool.close()


@pytest.mark.parametrize("payload", [
    b'{"IN": [4, 5, 6]}',
    b'{"IN": [7, -1], "DELAY": [1, 0], "WAIT": [1], "id": "r-1"}',
    b'{"IN": []}',
])
def test_repeat_stream_is_byte_identical(port_server, jax_server, payload):
    ours = _raw_stream(port_server.url, "repeat_int32", payload)
    assert ours == _raw_stream(jax_server.url, "repeat_int32", payload)
    assert ours[0] == 200


def test_repeat_through_the_core(port_server):
    core = port_server.core
    request = {"inputs": [{"name": "IN", "datatype": "INT32", "shape": [3],
                           "array": np.array([9, 8, 7], np.int32)}]}
    responses = list(core.infer_stream("repeat_int32", "", request))
    assert [r["outputs"][0]["array"].tolist() for r in responses] == [[9], [8], [7]]
    assert [r["outputs"][1]["array"].tolist() for r in responses] == [[0], [1], [2]]
    with pytest.raises(InferError, match="decoupled"):
        core.infer("repeat_int32", "", request)


def test_identity_delay_and_names():
    model = IdentityModel("custom_identity_int32", "INT32", input_name="IN", output_name="OUT",
                          delay_s=0.01, device="cpu")
    assert [t.name for t in model.inputs()] == ["IN"]
    out = model.execute({"IN": np.arange(4, dtype=np.int32).reshape(2, 2)}, {})
    assert isinstance(out["OUT"], torch.Tensor) and out["OUT"].tolist() == [[0, 1], [2, 3]]


def test_numeric_fixture_outputs_stay_tensors():
    zoo = {m.name: m for m in default_model_zoo("cpu")}
    x = torch.arange(6, dtype=torch.float16).reshape(2, 3)
    assert zoo["identity_fp16"].execute({"INPUT0": x}, {})["OUTPUT0"] is x
    y = zoo["batched_matmul"].execute({"X": np.ones((2, 64), np.float32)}, {})["Y"]
    assert isinstance(y, torch.Tensor) and tuple(y.shape) == (2, 16)


# -- the dynamic batcher ---------------------------------------------------------

# each script: (max_batch, [(rows, parameters)]) -> the rows of each execution
SCRIPTS = {
    "fills_the_batch": (4, [(1, {})] * 4, [4]),
    "mixed_rows": (4, [(1, {}), (1, {}), (2, {})], [4]),
    "parameters_split_groups": (4, [(1, {"a": 1}), (1, {"a": 2}), (1, {"a": 1}), (1, {})],
                                [2, 1, 1]),
    "overflow_carries": (4, [(3, {}), (2, {}), (2, {})], [3, 4]),
    "one_over_the_cap": (2, [(1, {}), (1, {}), (1, {}), (1, {})], [2, 2]),
}


def _run_script(batcher_cls, max_batch, items):
    executed = []
    w = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)

    def execute(inputs, parameters):
        x = np.asarray(inputs["X"])
        executed.append(int(x.shape[0]))
        return {"Y": x @ w}

    batcher = batcher_cls(execute, max_batch, max_delay_s=float(WAIT_S))
    xs = [np.full((rows, 64), i + 1, np.float32) for i, (rows, _) in enumerate(items)]
    futures = [batcher.submit({"X": x}, params) for x, (_, params) in zip(xs, items)]
    try:
        results = [f.result(timeout=WAIT_S)["Y"] for f in futures]
    finally:
        batcher.close()
    for x, y in zip(xs, results):  # a row of a stacked product (BLAS may sum apart)
        np.testing.assert_allclose(np.asarray(y), x @ w, rtol=1e-5, atol=1e-5)
    return executed


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_batcher_coalesces_as_the_jax_batcher(script):
    max_batch, items, want = SCRIPTS[script]
    assert _run_script(DynamicBatcher, max_batch, items) == want
    assert _run_script(JaxBatcher, max_batch, items) == want


def test_batcher_stacks_tensors_and_hands_back_row_views():
    seen = []

    def execute(inputs, parameters):
        seen.append(inputs["X"])
        return {"Y": inputs["X"] * 2}

    batcher = DynamicBatcher(execute, 3, max_delay_s=float(WAIT_S))
    xs = [torch.full((1, 4), float(i)) for i in range(3)]
    try:
        ys = [f.result(timeout=WAIT_S)["Y"] for f in
              [batcher.submit({"X": x}, {}) for x in xs]]
    finally:
        batcher.close()
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor) and seen[0].shape == (3, 4)
    base = ys[0].data_ptr()
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert torch.equal(y, x * 2)
        assert y.data_ptr() == base + i * 4 * y.element_size()  # a view of one output


def test_batcher_failure_reaches_every_caller_and_close_fails_the_rest():
    def execute(inputs, parameters):
        raise RuntimeError("model exploded")

    batcher = DynamicBatcher(execute, 2, max_delay_s=float(WAIT_S))
    futures = [batcher.submit({"X": np.zeros((1, 2), np.float32)}, {}) for _ in range(2)]
    for f in futures:
        with pytest.raises(RuntimeError, match="exploded"):
            f.result(timeout=WAIT_S)
    batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit({"X": np.zeros((1, 2), np.float32)}, {})


class _Probe(Model):
    name = "probe"
    max_batch_size = 8

    def inputs(self):
        return [TensorSpec("X", "FP32", [-1, 2])]

    def outputs(self):
        return [TensorSpec("Y", "FP32", [-1, 2])]

    def execute(self, inputs, parameters):
        return {"Y": inputs["X"]}


@pytest.mark.parametrize("case,batchable", [
    ("plain", True),
    ("sequence", False),
    ("shm_input", False),
    ("shm_output", False),
    ("decoupled", False),
    ("stateful", False),
    ("max_batch_1", False),
])
def test_core_decides_what_is_batched(case, batchable):
    model = _Probe()
    request = {"inputs": [{"name": "X", "array": np.zeros((1, 2), np.float32)}],
               "parameters": {}}
    if case == "sequence":
        request["parameters"] = {"sequence_id": 3}
    elif case == "shm_input":
        request["inputs"] = [{"name": "X", "shm": ("r", 8, 0)}]
    elif case == "shm_output":
        request["outputs"] = [{"name": "Y", "shm": ("r", 8, 0)}]
    elif case == "decoupled":
        model.decoupled = True
    elif case == "stateful":
        model.stateful = True
    elif case == "max_batch_1":
        model.config_override = {"max_batch_size": 1}
    assert ServerCore([model], device="cpu")._batchable(model, request) is batchable


@pytest.mark.parametrize("client", ["port", "jax"])
def test_batched_matmul_coalesces_over_http(client):
    """Four concurrent requests over HTTP: the core's batcher (declared batch
    4, a window long enough to fill it) runs them as one [4, 64] product,
    and each caller gets its own rows."""
    http = port_http if client == "port" else jax_http
    model = BatchedMatMulModel(device="cpu")
    model.config_override = {"max_batch_size": 4}
    core = ServerCore([model], device="cpu")
    core._batchers[model.name] = (4, DynamicBatcher(model.execute, 4, max_delay_s=float(WAIT_S)))
    server = HttpInferenceServer(core).start()
    xs = [np.random.default_rng(20 + i).standard_normal((1, 64)).astype(np.float32)
          for i in range(4)]

    def call(x):
        c = http.InferenceServerClient(server.url, network_timeout=WAIT_S)
        try:
            inp = http.InferInput("X", [1, 64], "FP32").set_data_from_numpy(x)
            return c.infer("batched_matmul", [inp]).as_numpy("Y")
        finally:
            c.close()

    try:
        with ThreadPoolExecutor(4) as pool:
            ys = list(pool.map(call, xs, timeout=WAIT_S))
    finally:
        server.stop()
        core._batchers[model.name][1].close()
    assert model.executed_batches == [4]
    for x, y in zip(xs, ys):
        np.testing.assert_allclose(y, x @ model._w_np, rtol=1e-5, atol=1e-5)


def test_batched_request_times_out_with_a_typed_504():
    release = threading.Event()

    class Slow(_Probe):
        def execute(self, inputs, parameters):
            release.wait(WAIT_S)
            return {"Y": inputs["X"]}

    model = Slow()
    core = ServerCore([model], device="cpu")
    core.batch_timeout_s = 0.1
    request = {"inputs": [{"name": "X", "datatype": "FP32", "shape": [1, 2],
                           "array": np.zeros((1, 2), np.float32)}]}
    try:
        with pytest.raises(InferError) as err:
            core.infer("probe", "", request)
        assert err.value.status == 504 and "batch_timeout_s" in str(err.value)
    finally:
        release.set()
        deadline = time.monotonic() + WAIT_S
        while core._batchers["probe"][1]._queue.qsize() and time.monotonic() < deadline:
            time.sleep(0.01)
        core._batchers["probe"][1].close()
