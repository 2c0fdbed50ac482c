"""The port's aiohttp frontend (``client_tpu_torch.server.http_server_aio``)
against the JAX package's.

- ``tests/test_http_e2e.py::test_aio_frontend_full_flow`` with the port and
  JAX sync HTTP clients against the port's aio server: health, inference,
  the admin surface, shared-memory registration over the system and cuda
  families (cuda regions on the CPU device here; the JAX client's region
  is a tpu_shared_memory host window), and error mapping;
- the 2x2 client/server matrix over the two packages' aio servers;
- raw requests to both aio servers, whose responses (status, content
  headers and bytes) must be identical: ``simple`` and the identity
  fixtures in JSON and binary, the generate route and its SSE stream, and
  the error bodies;
- the traceparent join, the ORCA header and ``/metrics``.

Servers bind ephemeral ports; every shm key is uuid-named and every region
is destroyed.
"""

import json
import uuid

import numpy as np
import pytest
import torch
import urllib3

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models.generate import TinyGenerateModel as JaxGenerate
from client_tpu.models.simple import AddSubModel as JaxAddSub
from client_tpu.models.simple import IdentityModel as JaxIdentity
from client_tpu.server import AioHttpInferenceServer as JaxAioServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu.utils import shared_memory as jax_shm
from client_tpu.utils import tpu_shared_memory as jax_tpushm
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.server import AioHttpInferenceServer, ServerCore
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as port_shm
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

IDENTITIES = [("identity_fp32", "FP32"), ("identity_fp16", "FP16"), ("identity_bf16", "BF16"),
              ("identity_int8", "INT8"), ("custom_identity_int32", "INT32"),
              ("simple_identity", "BYTES")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def port_server():
    server = AioHttpInferenceServer(
        ServerCore(default_model_zoo("cpu"), device="cpu")).start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_server():
    core = JaxCore([JaxAddSub(), *(JaxIdentity(n, d) for n, d in IDENTITIES),
                    JaxGenerate(seed=0)])
    server = JaxAioServer(core).start()
    yield server
    server.stop()


def _key(tag):
    return f"{tag}_{uuid.uuid4().hex[:12]}"


def _simple_inputs(http):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return a, b, [http.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                  http.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


# -- test_http_e2e.py::test_aio_frontend_full_flow, both clients ---------------


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_aio_frontend_full_flow(port_server, client_pkg):
    http, shm = (port_http, port_shm) if client_pkg == "port" else (jax_http, jax_shm)
    with http.InferenceServerClient(port_server.url) as client:
        assert client.is_server_live() and client.is_server_ready()
        assert client.is_model_ready("simple")
        a, b, inputs = _simple_inputs(http)
        result = client.infer("simple", inputs)
        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
        np.testing.assert_array_equal(result.as_numpy("OUTPUT1"), a - b)
        # the admin surface
        md = client.get_server_metadata()
        assert "cuda_shared_memory" in md["extensions"]
        all_stats = client.get_inference_statistics()
        assert any(m["name"] == "simple" for m in all_stats["model_stats"])
        assert client.get_model_config("simple")["backend"] == "pytorch"
        assert client.get_model_metadata("simple")["name"] == "simple"
        assert any(m["name"] == "simple" for m in client.get_model_repository_index())
        assert client.get_inference_statistics("simple")["model_stats"][0][
            "inference_count"] >= 1
        assert client.get_trace_settings()["trace_level"] == ["OFF"]
        assert client.get_log_settings()["log_info"] is True
        # system shm negotiation
        name = _key("aiofr")
        region = shm.create_shared_memory_region(name, "/" + name, 128)
        try:
            shm.set_shared_memory_region(region, [a, b])
            client.register_system_shared_memory(name, "/" + name, 128)
            i0 = http.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(name, 64)
            i1 = http.InferInput("INPUT1", [1, 16], "INT32").set_shared_memory(
                name, 64, offset=64)
            r = client.infer("simple", [i0, i1])
            np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), a + b)
            # the status GETs reach the action-less shm routes
            assert client.get_system_shared_memory_status()[0]["name"] == name
            assert client.get_cuda_shared_memory_status() == []
            client.unregister_system_shared_memory()
            assert client.get_system_shared_memory_status() == []
        finally:
            shm.destroy_shared_memory_region(region)
        # errors still map to the client's exception
        with pytest.raises(http.InferenceServerException, match="unknown model"):
            client.infer("missing", inputs)


@pytest.mark.parametrize("colocated", [True, False])
def test_cuda_shared_memory_with_the_port_client(port_server, colocated):
    x = torch.randn(3, 40)
    nbytes = x.numel() * 4
    names = (_key("acin"), _key("acout"))
    regions = [cudashm.create_shared_memory_region(n, nbytes, device="cpu", colocated=colocated)
               for n in names]
    with port_http.InferenceServerClient(port_server.url) as client:
        try:
            cudashm.set_shared_memory_region_from_torch(regions[0], x)
            for name, region in zip(names, regions):
                client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0,
                                                   nbytes)
            assert {r["name"] for r in client.get_cuda_shared_memory_status()} == set(names)
            assert client.get_cuda_shared_memory_status(names[0])[0]["byte_size"] == nbytes
            inp = port_http.InferInput("INPUT0", [3, 40], "FP32").set_shared_memory(
                names[0], nbytes)
            out = port_http.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(names[1], nbytes)
            result = client.infer("identity_fp32", [inp], outputs=[out])
            assert result.get_output("OUTPUT0")["parameters"] == {
                "shared_memory_region": names[1], "shared_memory_byte_size": nbytes}
            y = cudashm.get_contents_as_torch(regions[1], "FP32", [3, 40])
            # in one process the model gets the client's tensor itself
            assert y.data_ptr() == x.data_ptr() and torch.equal(y, x)
            np.testing.assert_array_equal(
                cudashm.get_contents_as_numpy(regions[1], "FP32", [3, 40]), x.numpy())
            client.unregister_cuda_shared_memory(names[0])
            assert [r["name"] for r in client.get_cuda_shared_memory_status()] == [names[1]]
        finally:
            client.unregister_cuda_shared_memory()
            for region in regions:
                cudashm.destroy_shared_memory_region(region)
        assert client.get_cuda_shared_memory_status() == []


def test_cuda_shared_memory_with_the_jax_client(port_server):
    """The JAX client registers its tpu_shared_memory host window with the
    cuda family; the port's aio server attaches it across the packages."""
    x = np.linspace(-1, 1, 48, dtype=np.float32).reshape(4, 12)
    region = jax_tpushm.create_shared_memory_region(_key("jaxtpu"), 2 * x.nbytes)
    name = _key("axpkg")
    with jax_http.InferenceServerClient(port_server.url) as client:
        try:
            jax_tpushm.set_shared_memory_region(region, [x])
            client.register_cuda_shared_memory(name, jax_tpushm.get_raw_handle(region), 0,
                                               2 * x.nbytes)
            inp = jax_http.InferInput("INPUT0", [4, 12], "FP32").set_shared_memory(
                name, x.nbytes)
            out = jax_http.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(name, x.nbytes, offset=x.nbytes)
            client.infer("identity_fp32", [inp], outputs=[out])
            got = np.frombuffer(bytes(region._shm.buf[x.nbytes:2 * x.nbytes]), np.float32)
            np.testing.assert_array_equal(got.reshape(4, 12), x)
        finally:
            client.unregister_cuda_shared_memory()
            jax_tpushm.destroy_shared_memory_region(region)


# -- the 2x2 matrix over the two aio servers ------------------------------------


@pytest.mark.parametrize("model", ["simple", "identity_fp32"])
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_client_server_matrix(port_server, jax_server, client_pkg, server, model):
    http = port_http if client_pkg == "port" else jax_http
    url = (port_server if server == "port" else jax_server).url
    with http.InferenceServerClient(url) as client:
        if model == "simple":
            a, b, inputs = _simple_inputs(http)
            result = client.infer("simple", inputs)
            got, want = result.as_numpy("OUTPUT0"), a + b
        else:
            want = np.random.default_rng(3).standard_normal((2, 129)).astype(np.float32)
            inp = http.InferInput("INPUT0", [2, 129], "FP32").set_data_from_numpy(want)
            got = client.infer("identity_fp32", [inp]).as_numpy("OUTPUT0")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- raw requests: the same bytes from both aio servers -------------------------


def _raw(url, method, path, body=None, headers=None):
    host, port = url.split(":")
    pool = urllib3.HTTPConnectionPool(host, int(port), retries=False)
    try:
        resp = pool.request(method, path, body=body, headers=headers or {})
        return (resp.status, resp.headers.get("Content-Type"),
                resp.headers.get("Inference-Header-Content-Length"), resp.data)
    finally:
        pool.close()


def _binary_body(inputs, outputs, binary_out):
    """A two-part infer body: the JSON header, then each input's bytes."""
    header = {"inputs": [], "outputs": [
        {"name": o, "parameters": {"binary_data": binary_out}} for o in outputs]}
    tail = b""
    for name, datatype, arr in inputs:
        if datatype == "BYTES":
            raw = b"".join(len(v).to_bytes(4, "little") + v for v in arr.reshape(-1))
        else:
            raw = arr.tobytes()
        header["inputs"].append({"name": name, "datatype": datatype, "shape": list(arr.shape),
                                 "parameters": {"binary_data_size": len(raw)}})
        tail += raw
    hj = json.dumps(header).encode()
    return hj + tail, {"Inference-Header-Content-Length": str(len(hj)),
                       "Content-Type": "application/octet-stream"}


def _identity_input(datatype):
    rng = np.random.default_rng(11)
    if datatype == "BYTES":
        return np.array([b"alpha", b"", b"\x00\xff", b"omega"], dtype=object).reshape(1, 4)
    if datatype == "BF16":
        # bf16 bit patterns as uint16 (the wire form), exact in fp32
        return (rng.integers(0, 2**15, (1, 8)).astype(np.uint16) & 0x7F80 | 0x3F00).astype(
            np.uint16)
    dtype = {"FP32": np.float32, "FP16": np.float16, "INT8": np.int8, "INT32": np.int32}[
        datatype]
    if dtype in (np.int8, np.int32):
        return rng.integers(-100, 100, (2, 5)).astype(dtype)
    return rng.standard_normal((2, 5)).astype(dtype)


@pytest.mark.parametrize("binary_out", [True, False], ids=["binary", "json"])
@pytest.mark.parametrize("model,datatype", IDENTITIES)
def test_identity_bytes_equal_the_jax_server(port_server, jax_server, model, datatype,
                                             binary_out):
    arr = _identity_input(datatype)
    body, headers = _binary_body([("INPUT0", datatype, arr)], ["OUTPUT0"], binary_out)
    ours = _raw(port_server.url, "POST", f"/v2/models/{model}/infer", body, headers)
    theirs = _raw(jax_server.url, "POST", f"/v2/models/{model}/infer", body, headers)
    assert ours == theirs
    assert ours[0] == 200


@pytest.mark.parametrize("case", ["json", "binary", "mixed"])
def test_simple_bytes_equal_the_jax_server(port_server, jax_server, case):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 7, dtype=np.int32)
    if case == "json":
        body = json.dumps({"id": "r1", "inputs": [
            {"name": n, "datatype": "INT32", "shape": [1, 16], "data": v.reshape(-1).tolist()}
            for n, v in (("INPUT0", a), ("INPUT1", b))]}).encode()
        headers = {"Content-Type": "application/json"}
    else:
        body, headers = _binary_body([("INPUT0", "INT32", a), ("INPUT1", "INT32", b)],
                                     ["OUTPUT0", "OUTPUT1"], case == "binary")
    ours = _raw(port_server.url, "POST", "/v2/models/simple/infer", body, headers)
    theirs = _raw(jax_server.url, "POST", "/v2/models/simple/infer", body, headers)
    assert ours == theirs
    assert ours[0] == 200


@pytest.mark.parametrize("payload", [
    b'{"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 4}',
    b'{"TOKENS": [[5, 6, 7]], "MAX_TOKENS": 5, "id": "req-9"}',
    b'{"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 8, "END_ID": 69, "parameters": {"chunk": 3}}',
])
def test_generate_stream_bytes_equal_the_jax_server(port_server, jax_server, payload):
    headers = {"Content-Type": "application/json"}
    path = "/v2/models/tiny_lm_generate/generate_stream"
    ours = _raw(port_server.url, "POST", path, payload, headers)
    theirs = _raw(jax_server.url, "POST", path, payload, headers)
    assert ours == theirs
    assert ours[0] == 200 and ours[1] == "text/event-stream"
    assert ours[3].startswith(b'data: {"model_name":"tiny_lm_generate"')


@pytest.mark.parametrize("payload", [
    b'{"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 1}',
    b'{"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 3}',
    b'{"TOKENS": [1, 2], "NOPE": 1}',
    b'[1, 2]',
    b'not json',
])
def test_generate_bytes_equal_the_jax_server(port_server, jax_server, payload):
    headers = {"Content-Type": "application/json"}
    path = "/v2/models/tiny_lm_generate/generate"
    ours = _raw(port_server.url, "POST", path, payload, headers)
    assert ours == _raw(jax_server.url, "POST", path, payload, headers)


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/v2/models/missing/infer", b'{"inputs": []}'),
    ("POST", "/v2/models/simple/infer", b'{"inputs": [{"name": "INPUT0"'),
    ("POST", "/v2/models/simple/infer", b'{"inputs": [{"name": "INPUT0", "datatype": "INT32"'
                                        b', "shape": [1, 16]}]}'),
    ("GET", "/v2/models/missing", None),
    ("GET", "/v2/models/missing/config", None),
    ("GET", "/v2/models/simple/ready", None),
    ("GET", "/v2/health/live", None),
    ("GET", "/v2/health/ready", None),
    ("GET", "/v2/trace/setting", None),
    ("GET", "/v2/logging", None),
    ("GET", "/v2/systemsharedmemory/status", None),
    ("GET", "/v2/systemsharedmemory/region/nowhere/status", None),
    ("POST", "/v2/systemsharedmemory/region/nowhere/unregister", b""),
    ("POST", "/v2/cudasharedmemory/unregister", b""),
    ("POST", "/v2/repository/models/missing/unload", b""),
])
def test_route_bytes_equal_the_jax_server(port_server, jax_server, method, path, body):
    ours = _raw(port_server.url, method, path, body)
    assert ours == _raw(jax_server.url, method, path, body)


# -- traceparent, ORCA and /metrics --------------------------------------------


def test_traceparent_joins_an_access_record(port_server):
    trace_id = uuid.uuid4().hex
    _, _, inputs = _simple_inputs(port_http)
    body, headers = _binary_body(
        [(i.name(), "INT32", np.arange(16, dtype=np.int32).reshape(1, 16)) for i in inputs],
        ["OUTPUT0"], True)
    headers["traceparent"] = f"00-{trace_id}-{'ab' * 8}-01"
    assert _raw(port_server.url, "POST", "/v2/models/simple/infer", body, headers)[0] == 200
    records = json.loads(_raw(port_server.url, "GET", "/v2/trace/access")[3])
    mine = [r for r in records if r["trace_id"] == trace_id]
    assert len(mine) == 1 and mine[0]["model_name"] == "simple"
    assert mine[0]["client_span_id"] == "ab" * 8
    assert records == port_server.core.access_records()[-len(records):]


@pytest.mark.parametrize("fmt", ["json", "text"])
def test_orca_header_as_the_jax_server(port_server, jax_server, fmt):
    body, headers = _binary_body(
        [("INPUT0", "INT32", np.zeros((1, 16), np.int32)),
         ("INPUT1", "INT32", np.ones((1, 16), np.int32))], ["OUTPUT0"], True)
    headers["endpoint-load-metrics-format"] = fmt
    reports = []
    for server in (port_server, jax_server):
        host, port = server.url.split(":")
        pool = urllib3.HTTPConnectionPool(host, int(port), retries=False)
        try:
            resp = pool.request("POST", "/v2/models/simple/infer", body=body, headers=headers)
            assert resp.status == 200
            reports.append(resp.headers["endpoint-load-metrics"])
        finally:
            pool.close()
    if fmt == "json":
        ours, theirs = (json.loads(r)["named_metrics"] for r in reports)
        assert set(ours) == set(theirs) and ours["inference_count"] >= 1
    else:
        assert [kv.split("=")[0] for kv in reports[0].split(", ")] == \
            [kv.split("=")[0] for kv in reports[1].split(", ")]


def test_metrics_scrape(port_server):
    status, content_type, _, body = _raw(port_server.url, "GET", "/metrics")
    assert status == 200 and content_type.startswith("text/plain")
    text = body.decode()
    assert "client_tpu_server_live 1" in text and "client_tpu_server_ready 1" in text
    assert 'client_tpu_server_inference_count{model="simple"}' in text


def test_frontend_is_exported_lazily():
    import subprocess
    import sys

    code = ("import sys, client_tpu_torch.server as s; "
            "assert 'aiohttp' not in sys.modules; "
            "assert 'client_tpu_torch.server.http_server_aio' not in sys.modules; "
            "s.AioHttpInferenceServer; assert 'aiohttp' in sys.modules; "
            "assert 'AioHttpInferenceServer' in s.__all__")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
