"""The port's asyncio clients (``http.aio`` and ``grpc.aio``) against the
port's and the JAX package's servers, in the patterns of
tests/test_aio_e2e.py (``asyncio.run``; no pytest-asyncio).

Each case runs through an aio client and through the port's sync client of
the same protocol, against both servers: all must agree (outputs, ids,
error messages and status codes). On capturing endpoints, the aio GRPC
client's frames equal the sync client's and the JAX aio client's byte for
byte, and the HTTP aio client's requests equal the JAX aio client's and the
sync client's (but for the content type aiohttp adds to a bytes body).
"""

import asyncio
import base64
import queue
import threading
import uuid
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc
import numpy as np
import pytest
import torch

import client_tpu.grpc.aio as jax_grpc_aio
import client_tpu.http.aio as jax_http_aio
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as grpc_aio
import client_tpu_torch.http as port_http
import client_tpu_torch.http.aio as http_aio
from client_tpu.models import simple as jax_simple
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import (
    AddSubModel,
    IdentityModel,
    RepeatModel,
    SequenceAccumulatorModel,
    TinyDecoderModel,
    TinyGenerateModel,
)
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils import cuda_shared_memory as cudashm

WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def servers():
    """Each package's HTTP and GRPC frontends over one core of its own."""
    decoder = TinyDecoderModel(device="cpu")
    port_core = ServerCore([AddSubModel(device="cpu"),
                            IdentityModel("identity_fp32", "FP32", device="cpu"),
                            SequenceAccumulatorModel(), RepeatModel(), decoder,
                            TinyGenerateModel(decoder=decoder)], device="cpu")
    jax_core = JaxCore([jax_simple.AddSubModel(), jax_simple.IdentityModel("identity_fp32", "FP32"),
                        jax_simple.SequenceAccumulatorModel(), jax_simple.RepeatModel()])
    started = {
        "port": (HttpInferenceServer(port_core).start(), GrpcInferenceServer(port_core).start()),
        "jax": (JaxHttpServer(jax_core).start(), JaxGrpcServer(jax_core).start()),
    }
    yield started
    for http, grpc_server in started.values():
        http.stop()
        grpc_server.stop()


def _simple_inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return a, b, [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                  mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


async def _error(awaitable):
    with pytest.raises(InferenceServerException) as err:
        await awaitable
    return err.value.status(), err.value.message()


class _Sync:
    """The sync client of a protocol behind the aio surface the cases use."""

    def __init__(self, client):
        self._client = client

    def __getattr__(self, name):
        fn = getattr(self._client, name)

        async def call(*args, **kwargs):
            return fn(*args, **kwargs)

        return call


def _client(kind, protocol, url):
    """(module, client) for an aio client or the sync twin of ``protocol``."""
    if protocol == "http":
        return ((http_aio, http_aio.InferenceServerClient(url)) if kind == "aio"
                else (port_http, _Sync(port_http.InferenceServerClient(url))))
    return ((grpc_aio, grpc_aio.InferenceServerClient(url)) if kind == "aio"
            else (port_grpc, _Sync(port_grpc.InferenceServerClient(url))))


async def _close(client):
    if isinstance(client, _Sync):
        client._client.close()
    else:
        await client.close()


# -- cases, each returning comparable values ---------------------------------------


async def case_surface(mod, client):
    a, b, inputs = _simple_inputs(mod)
    result = await client.infer("simple", inputs, request_id="aio1")
    many = await asyncio.gather(*[client.infer("simple", inputs) for _ in range(8)])
    bad = [mod.InferInput("INPUT0", [1, 4], "INT32").set_data_from_numpy(
        np.zeros((1, 4), np.int32))]
    return [await client.is_server_live(), await client.is_server_ready(),
            await client.is_model_ready("simple"), await client.is_model_ready("nope"),
            result.as_numpy("OUTPUT0").tolist(), result.get_response()["id"],
            [r.as_numpy("OUTPUT1").tolist() for r in many],
            await _error(client.infer("missing", inputs)),
            await _error(client.infer("simple", bad))]


async def case_identity_over_cuda_shm(mod, client):
    """identity_fp32 through CPU cuda regions, several requests at once."""
    x = np.linspace(-3, 3, 4 * 33, dtype=np.float32).reshape(4, 33)
    names = [f"aio_{i}_{uuid.uuid4().hex[:8]}" for i in range(6)]
    regions = [cudashm.create_shared_memory_region(n, x.nbytes, device="cpu") for n in names]
    try:
        for i, (name, region) in enumerate(zip(names, regions)):
            if i < 3:
                cudashm.set_shared_memory_region(region, [x * (i + 1)])
            await client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0,
                                                     x.nbytes)
        status = await client.get_cuda_shared_memory_status()

        async def one(i):
            inp = mod.InferInput("INPUT0", [4, 33], "FP32").set_shared_memory(names[i], x.nbytes)
            out = mod.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(names[i + 3], x.nbytes)
            r = await client.infer("identity_fp32", [inp], outputs=[out])
            return r.as_numpy("OUTPUT0")

        outs = await asyncio.gather(*[one(i) for i in range(3)])
        got = [cudashm.get_contents_as_numpy(regions[i + 3], "FP32", [4, 33]).tolist()
               for i in range(3)]
        await client.unregister_cuda_shared_memory()
        after = await client.get_cuda_shared_memory_status()
    finally:
        for region in regions:
            cudashm.destroy_shared_memory_region(region)
    return [len(status), outs, got, after, [(x * (i + 1)).tolist() for i in range(3)] == got]


async def case_admin(mod, client):
    stats = await client.get_inference_statistics("simple")
    entry = stats["model_stats"][0]
    index = await client.get_model_repository_index()
    await client.unload_model("simple_sequence")
    unloaded = await client.is_model_ready("simple_sequence")
    await client.load_model("simple_sequence")
    log = await client.update_log_settings({"log_verbose_level": 2})
    await client.update_log_settings({"log_verbose_level": 0})
    trace = await client.get_trace_settings()
    return [entry["name"], entry["inference_count"] >= 1,
            sorted(m["name"] for m in index if m["name"] in ("simple", "repeat_int32")),
            unloaded, await client.is_model_ready("simple_sequence"),
            log["log_verbose_level"], trace["trace_level"],
            await _error(client.get_inference_statistics("nope"))]


CASES = {"surface": case_surface, "identity_over_cuda_shm": case_identity_over_cuda_shm,
         "admin": case_admin}


def _run(case, kind, protocol, server):
    url = server[0 if protocol == "http" else 1].url

    async def go():
        mod, client = _client(kind, protocol, url)
        try:
            return await CASES[case](mod, client)
        finally:
            await _close(client)

    return asyncio.run(go())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_aio_matrix(servers, protocol, server, case):
    """The aio client gives what the sync client gives, against each server,
    and both give what they get from the JAX server."""
    got = _run(case, "aio", protocol, servers[server])
    assert _plain(got) == _plain(_run(case, "sync", protocol, servers[server]))
    assert _plain(got) == _plain(_run(case, "sync", protocol, servers["jax"]))


def _plain(value):
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tolist())
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


# -- grpc.aio streams ----------------------------------------------------------------


async def _stream(client, requests, stop_at_null=False):
    async def gen():
        for r in requests:
            yield r

    events = []
    stream = await client.stream_infer(gen())
    async for result, error in stream:
        if error is not None:
            events.append(("error", error.message()))
            break
        events.append(("result", result.get_response().get("id", ""),
                       {o["name"]: result.as_numpy(o["name"]).tolist()
                        for o in result.get_response().get("outputs", [])},
                       result.is_final_response()))
        if stop_at_null and result.is_null_response():
            break
    return events


def _sequence_requests(mod):
    out = []
    for i, (start, end) in enumerate([(True, False), (False, True)]):
        inp = mod.InferInput("INPUT", [1, 1], "INT32")
        inp.set_data_from_numpy(np.array([[3]], dtype=np.int32))
        out.append({"model_name": "simple_sequence", "inputs": [inp], "sequence_id": 31,
                    "sequence_start": start, "sequence_end": end, "request_id": f"q{i}"})
    return out


def _repeat_requests(mod):
    inp = mod.InferInput("IN", [2], "INT32").set_data_from_numpy(np.array([7, 8], np.int32))
    return [{"model_name": "repeat_int32", "inputs": [inp],
             "enable_empty_final_response": True}]


def _bad_requests(mod):
    inp = mod.InferInput("INPUT", [1, 1], "INT32")
    inp.set_data_from_numpy(np.array([[1]], dtype=np.int32))
    return [{"model_name": "simple_sequence", "inputs": [inp]}]  # no sequence id


def _sync_stream(url, requests, stop_at_null=False):
    """The same requests over the sync client's bidi stream."""
    events, q = [], queue.Queue()
    with port_grpc.InferenceServerClient(url) as client:
        client.start_stream(lambda r, e: q.put((r, e)))
        try:
            for r in requests:
                kwargs = dict(r)
                client.async_stream_infer(kwargs.pop("model_name"), kwargs.pop("inputs"),
                                          **kwargs)
            while True:
                result, error = q.get(timeout=WAIT_S)
                if error is not None:
                    events.append(("error", error.message()))
                    break
                events.append(("result", result.get_response().get("id", ""),
                               {o["name"]: result.as_numpy(o["name"]).tolist()
                                for o in result.get_response().get("outputs", [])},
                               result.is_final_response()))
                if (stop_at_null and result.is_null_response()) or (
                        not stop_at_null and len(events) == len(requests)):
                    break
        finally:
            client.stop_stream()
    return events


@pytest.mark.parametrize("kind", ["sequence", "repeat", "error"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_grpc_aio_stream(servers, server, kind):
    make, stop = {"sequence": (_sequence_requests, False), "repeat": (_repeat_requests, True),
                  "error": (_bad_requests, False)}[kind]
    url = servers[server][1].url

    async def go():
        async with grpc_aio.InferenceServerClient(url) as client:
            return await _stream(client, make(grpc_aio), stop_at_null=stop)

    got = asyncio.run(go())
    assert got == _sync_stream(url, make(port_grpc), stop_at_null=stop)
    assert got == _sync_stream(servers["jax"][1].url, make(port_grpc), stop_at_null=stop)
    if kind == "sequence":
        assert [e[2]["OUTPUT"] for e in got] == [[[3]], [[6]]]
    elif kind == "repeat":
        assert [e[2].get("OUT") for e in got] == [[7], [8], None] and got[-1][3]
    else:
        assert "sequence_id" in got[0][1]


def test_grpc_aio_stream_llm_generate(servers):
    """tiny_lm_generate over the aio stream: the tokens of the in-process
    decoupled path on the same server."""
    async def go():
        async with grpc_aio.InferenceServerClient(servers["port"][1].url) as client:
            tok = grpc_aio.InferInput("TOKENS", [1, 3], "INT32")
            tok.set_data_from_numpy(np.array([[9, 8, 7]], dtype=np.int32))
            mx = grpc_aio.InferInput("MAX_TOKENS", [1], "INT32")
            mx.set_data_from_numpy(np.array([5], dtype=np.int32))
            return await _stream(client, [{"model_name": "tiny_lm_generate",
                                           "inputs": [tok, mx],
                                           "enable_empty_final_response": True}],
                                 stop_at_null=True)

    events = asyncio.run(go())
    toks = [e[2]["NEXT_TOKEN"][0] for e in events if "NEXT_TOKEN" in e[2]]
    core = servers["port"][1].core
    want = [int(np.asarray(r["outputs"][0]["array"]).reshape(-1)[0])
            for r in core.infer_stream("tiny_lm_generate", "", {"inputs": [
                {"name": "TOKENS", "datatype": "INT32", "shape": [1, 3],
                 "array": np.array([[9, 8, 7]], np.int32)},
                {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
                 "array": np.array([5], np.int32)}]})]
    assert len(toks) == 5 and [t[0] if isinstance(t, list) else t for t in toks] == want


@pytest.mark.parametrize("client", ["port", "jax"])
def test_grpc_aio_stream_cancel(servers, client):
    """cancel() on the response iterator: the consumer's next read raises
    asyncio.CancelledError, from either package's aio client."""
    import client_tpu.grpc.aio as jax_grpc_aio

    mod = grpc_aio if client == "port" else jax_grpc_aio

    async def go():
        async with mod.InferenceServerClient(servers["port"][1].url) as c:
            async def never():
                await asyncio.sleep(WAIT_S)
                yield {}

            stream = await c.stream_infer(never())
            assert stream.cancel()
            with pytest.raises(asyncio.CancelledError):
                await stream.__anext__()
            return "cancelled"

    assert asyncio.run(go()) == "cancelled"


def test_grpc_aio_trace_settings_none_clears(servers):
    async def go():
        async with grpc_aio.InferenceServerClient(servers["port"][1].url) as client:
            await client.update_trace_settings(settings={"trace_rate": 9})
            cleared = await client.update_trace_settings(settings={"trace_rate": None})
            await client.update_trace_settings(settings={"trace_level": ["OFF"],
                                                         "trace_rate": 1000})
            return cleared

    assert asyncio.run(go())["trace_rate"] == []


# -- the aio clients' requests against the sync clients' ------------------------------


class _GrpcCapture(grpc.GenericRpcHandler):
    def __init__(self):
        self.seen = []

    def service(self, details):
        def unary(frame, context):
            metadata = sorted((k, v) for k, v in context.invocation_metadata()
                              if k != "user-agent")
            self.seen.append((details.method, bytes(frame), metadata))
            return b""

        return grpc.unary_unary_rpc_method_handler(unary)


@pytest.fixture(scope="module")
def grpc_capture():
    handler = _GrpcCapture()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    handler.url = f"127.0.0.1:{server.add_insecure_port('127.0.0.1:0')}"
    server.start()
    yield handler
    server.stop(0).wait()


GRPC_CALLS = {
    "infer": lambda mod, c: c.infer("m", _simple_inputs(mod)[2], request_id="r",
                                    sequence_id=3, parameters={"k": 1},
                                    headers={"x-a": "1"}),
    "config": lambda mod, c: c.get_model_config("simple", "1"),
    "statistics": lambda mod, c: c.get_inference_statistics("simple"),
    "load": lambda mod, c: c.load_model("simple", config="{}", files={"f": b"\x01"}),
    "unload": lambda mod, c: c.unload_model("simple", unload_dependents=True),
    "trace": lambda mod, c: c.update_trace_settings("simple", {"trace_level": ["OFF"]}),
    "log": lambda mod, c: c.update_log_settings({"log_info": True, "log_verbose_level": 1}),
    "register_cuda": lambda mod, c: c.register_cuda_shared_memory("c", "aGFuZGxl", 0, 64),
    "register_system": lambda mod, c: c.register_system_shared_memory("s", "/k", 64, 8),
}


def _capture_aio(mod, url, calls, op, auth):
    async def go():
        async with mod.InferenceServerClient(url) as c:
            c.register_plugin(auth)
            try:
                await calls[op](mod, c)
            except Exception:
                pass  # the capture's empty answers are not always a valid result

    asyncio.run(go())


@pytest.mark.parametrize("op", sorted(GRPC_CALLS))
def test_grpc_aio_frames_equal_the_sync_and_jax_clients(grpc_capture, op):
    """The port's grpc.aio client sends the sync client's frames and
    metadata, and the JAX grpc.aio client's."""
    grpc_capture.seen.clear()
    with port_grpc.InferenceServerClient(grpc_capture.url) as c:
        c.register_plugin(port_grpc.BasicAuth("u", "p"))
        try:
            GRPC_CALLS[op](port_grpc, c)
        except InferenceServerException:
            pass
    _capture_aio(grpc_aio, grpc_capture.url, GRPC_CALLS, op, port_grpc.BasicAuth("u", "p"))
    _capture_aio(jax_grpc_aio, grpc_capture.url, GRPC_CALLS, op,
                 port_grpc.BasicAuth("u", "p"))
    assert len(grpc_capture.seen) == 3
    assert grpc_capture.seen[0] == grpc_capture.seen[1] == grpc_capture.seen[2]


class _HttpCapture(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _record(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        # the transports' own headers differ (aiohttp vs urllib3)
        headers = {k.lower(): v for k, v in self.headers.items()
                   if k.lower() not in ("user-agent", "accept", "accept-encoding", "host",
                                        "connection", "content-length")}
        self.server.seen.append((self.command, self.path, headers, body))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    do_GET = do_POST = _record


@pytest.fixture(scope="module")
def http_capture():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _HttpCapture)
    server.seen = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()


HTTP_CALLS = {
    "infer": lambda mod, c: c.infer("m", _simple_inputs(mod)[2], request_id="r",
                                    sequence_id=3, parameters={"k": 1},
                                    headers={"x-a": "1"}, query_params={"q": "1"}),
    "live": lambda mod, c: c.is_server_live(),
    "stats": lambda mod, c: c.get_inference_statistics("simple", "2"),
    "index": lambda mod, c: c.get_model_repository_index(),
    "load": lambda mod, c: c.load_model("simple", config="{}", files={"f": b"\x01"}),
    "unload": lambda mod, c: c.unload_model("simple", unload_dependents=True),
    "trace": lambda mod, c: c.update_trace_settings("simple", {"trace_level": ["OFF"]}),
    "log": lambda mod, c: c.get_log_settings(),
    "register_cuda": lambda mod, c: c.register_cuda_shared_memory("c", "aGFuZGxl", 0, 64),
    "generate": lambda mod, c: c.generate("g", {"TOKENS": [1, 2]}, request_id="x"),
}


@pytest.mark.parametrize("op", sorted(HTTP_CALLS))
def test_http_aio_requests_equal_the_sync_and_jax_clients(http_capture, op):
    """The port's http.aio client sends what the JAX http.aio client sends,
    headers and all, and the sync client's method, path, body and headers
    but for those aiohttp adds itself (a ``content-type`` for a bytes
    body)."""
    url = f"127.0.0.1:{http_capture.server_address[1]}"
    http_capture.seen.clear()
    with port_http.InferenceServerClient(url) as c:
        c.register_plugin(port_http.BasicAuth("u", "p"))
        try:
            HTTP_CALLS[op](port_http, c)
        except InferenceServerException:
            pass
    _capture_aio(http_aio, url, HTTP_CALLS, op, port_http.BasicAuth("u", "p"))
    _capture_aio(jax_http_aio, url, HTTP_CALLS, op, port_http.BasicAuth("u", "p"))
    assert len(http_capture.seen) == 3
    sync, ours, theirs = http_capture.seen
    assert ours == theirs
    added = {k: v for k, v in ours[2].items() if k not in sync[2]}
    assert added in ({}, {"content-type": "application/octet-stream"}), added
    assert (sync[0], sync[1], sync[3]) == (ours[0], ours[1], ours[3])
    assert all(ours[2][k] == v for k, v in sync[2].items())
    expected = "Basic " + base64.b64encode(b"u:p").decode()
    assert ours[2]["authorization"] == expected


def test_http_aio_generate_stream(servers):
    async def go():
        async with http_aio.InferenceServerClient(servers["port"][0].url) as client:
            return [e async for e in client.generate_stream(
                "tiny_lm_generate", {"TOKENS": [1, 2, 3], "MAX_TOKENS": 4})]

    with port_http.InferenceServerClient(servers["port"][0].url) as sync:
        want = list(sync.generate_stream("tiny_lm_generate",
                                         {"TOKENS": [1, 2, 3], "MAX_TOKENS": 4}))
    assert asyncio.run(go()) == want and len(want) == 4


def test_http_aio_offline_marshaling_statics():
    a = np.arange(8, dtype=np.int32).reshape(1, 8)
    inp = http_aio.InferInput("X", [1, 8], "INT32").set_data_from_numpy(a)
    body, size = http_aio.InferenceServerClient.generate_request_body([inp])
    body2, size2 = port_http.InferenceServerClient.generate_request_body([inp])
    assert bytes(body) == bytes(body2) and size == size2
