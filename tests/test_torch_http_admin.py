"""The port's HTTP admin surface against the JAX package's: the sync client's
new calls and the server's new routes.

- request parity: the repository, statistics, trace-setting and logging
  calls send byte-identical requests (a capturing endpoint, as
  tests/test_torch_wire.py);
- the 2x2 matrix over HTTP on fresh servers: statistics (structure and
  counts; timing fields excluded), trace and log settings, the repository
  index, unload and load with a config override, and their errors, equal
  whichever client talks to whichever server;
- ``async_infer`` with ``InferAsyncRequest`` (result, non-blocking poll,
  cancel) as the JAX client's;
- the core: statistics under dynamic batching and for cancelled decoupled
  streams, and trace records (sampling, count, trace file), as the JAX
  core keeps them.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models import batched as jax_batched
from client_tpu.models import simple as jax_simple
from client_tpu.server import HttpInferenceServer as JaxServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import (
    AddSubModel,
    BatchedMatMulModel,
    RepeatModel,
    StringAddSubModel,
)
from client_tpu_torch.server import HttpInferenceServer, ServerCore


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_core():
    return ServerCore([AddSubModel(device="cpu"), StringAddSubModel(), RepeatModel(),
                       BatchedMatMulModel(device="cpu")], device="cpu")


def _jax_core():
    return JaxCore([jax_simple.AddSubModel(), jax_simple.StringAddSubModel(),
                    jax_simple.RepeatModel(), jax_batched.BatchedMatMulModel()])


def _server(kind):
    if kind == "port":
        return HttpInferenceServer(_port_core()).start()
    return JaxServer(_jax_core()).start()


MODS = {"port": port_http, "jax": jax_http}


def _simple_inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return a, b, [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                  mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


def _error(fn):
    with pytest.raises(Exception) as err:
        fn()
    assert type(err.value).__name__ == "InferenceServerException", err.value
    return err.value.status(), err.value.message()


def _untimed(stats):
    """Statistics with ``ns`` and ``last_inference`` set to whether they are
    nonzero."""
    if isinstance(stats, dict):
        return {k: (int(bool(v)) if k in ("ns", "last_inference") else _untimed(v))
                for k, v in stats.items()}
    if isinstance(stats, list):
        return [_untimed(v) for v in stats]
    return stats


# -- request parity ------------------------------------------------------------------


class _Capture(BaseHTTPRequestHandler):
    """Records every request and answers 400."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _record(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        self.server.seen.append((self.command, self.path, dict(self.headers), body))
        payload = b'{"error":"captured"}'
        self.send_response(400)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_POST = _record


@pytest.fixture(scope="module")
def capture():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Capture)
    server.seen = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


ADMIN_CALLS = {
    "repository_index": lambda c: c.get_model_repository_index(),
    "load": lambda c: c.load_model("simple"),
    "load_config_files": lambda c: c.load_model(
        "simple", config='{"max_batch_size": 4}', files={"1/model.bin": b"\x00\xff"}),
    "load_query": lambda c: c.load_model("a b", headers={"x": "1"}, query_params={"q": "2"}),
    "unload": lambda c: c.unload_model("simple"),
    "unload_dependents": lambda c: c.unload_model("simple", unload_dependents=True),
    "stats_all": lambda c: c.get_inference_statistics(),
    "stats_model": lambda c: c.get_inference_statistics("simple"),
    "stats_version": lambda c: c.get_inference_statistics("simple", "2"),
    "trace_get": lambda c: c.get_trace_settings(),
    "trace_get_model": lambda c: c.get_trace_settings("simple"),
    "trace_update": lambda c: c.update_trace_settings(
        settings={"trace_level": ["TIMESTAMPS"], "trace_rate": "2"}),
    "trace_update_model": lambda c: c.update_trace_settings("simple", {"trace_count": 3}),
    "trace_update_empty": lambda c: c.update_trace_settings(),
    "log_get": lambda c: c.get_log_settings(),
    "log_update": lambda c: c.update_log_settings({"log_info": False, "log_verbose_level": 1}),
}


@pytest.mark.parametrize("op", sorted(ADMIN_CALLS))
def test_admin_requests_are_byte_identical(capture, op):
    seen = []
    for mod in (jax_http, port_http):
        capture.seen.clear()
        client = mod.InferenceServerClient(f"127.0.0.1:{capture.server_address[1]}")
        try:
            with pytest.raises(Exception) as err:
                ADMIN_CALLS[op](client)
            assert "captured" in str(err.value)
        finally:
            client.close()
        assert len(capture.seen) == 1
        seen.append(capture.seen[0])
    assert seen[0] == seen[1]


def test_async_infer_request_is_byte_identical(capture):
    seen = []
    for mod in (jax_http, port_http):
        capture.seen.clear()
        client = mod.InferenceServerClient(f"127.0.0.1:{capture.server_address[1]}")
        try:
            _, _, inputs = _simple_inputs(mod)
            handle = client.async_infer("simple", inputs, request_id="a1", sequence_id=5,
                                        headers={"x": "y"})
            with pytest.raises(Exception) as err:
                handle.get_result(timeout=30)
            assert "captured" in str(err.value)
        finally:
            client.close()
        seen.append(capture.seen[0])
    assert seen[0] == seen[1]


# -- the 2x2 matrix over HTTP ---------------------------------------------------------


def _admin_run(mod, url):
    with mod.InferenceServerClient(url) as c:
        _, _, inputs = _simple_inputs(mod)
        for _ in range(3):
            c.infer("simple", inputs)
        bad = [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(
            np.zeros((1, 16), np.int32))]
        row = [_error(lambda: c.infer("simple", bad)),
               list(c.generate_stream("repeat_int32", {"IN": [4, 5]}))]
        row += [_untimed(c.get_inference_statistics()),
                _untimed(c.get_inference_statistics("simple")),
                _untimed(c.get_inference_statistics("simple", "1")),
                _error(lambda: c.get_inference_statistics("nope")),
                c.get_trace_settings(), c.get_trace_settings("simple"),
                c.update_trace_settings(settings={"trace_level": ["TIMESTAMPS"],
                                                  "trace_rate": "1"}),
                c.update_trace_settings("simple", {"trace_level": ["OFF"]}),
                c.get_log_settings(),
                c.update_log_settings({"log_verbose_level": 3, "log_info": False}),
                c.get_model_repository_index()]
        c.unload_model("simple_string")
        row += [c.is_model_ready("simple_string"), c.get_model_repository_index(),
                _error(lambda: c.infer("simple_string", inputs))]
        c.load_model("simple_string")
        row.append(c.is_model_ready("simple_string"))
        c.load_model("simple", config='{"max_batch_size": 8}')
        row.append(c.get_model_config("simple")["max_batch_size"])
        c.load_model("simple")
        row.append(c.get_model_config("simple")["max_batch_size"])
        row += [_error(lambda: c.load_model("simple", config='{"name": "x"}')),
                _error(lambda: c.load_model("simple", config="[1]")),
                _error(lambda: c.load_model("simple", config="{bad")),
                _error(lambda: c.load_model("nope")),
                _error(lambda: c.unload_model("nope"))]
    return row


@pytest.mark.parametrize("client", ["port", "jax"])
def test_admin_matrix(client):
    """Fresh servers of both packages, the same calls: equal answers (the
    statistics without their timing fields), and statistics counting what
    was sent."""
    rows = []
    for kind in ("port", "jax"):
        server = _server(kind)
        try:
            rows.append(_admin_run(MODS[client], server.url))
        finally:
            server.stop()
    for got, want in zip(rows[0], rows[1]):
        if isinstance(want, tuple) and want[1].startswith("invalid config override"):
            # json's own message: the same decoder in both packages
            assert got[0] == want[0] and got[1].startswith("invalid config override")
        else:
            assert got == want
    stats = rows[0][3]["model_stats"][0]
    assert stats["inference_count"] == 3 and stats["inference_stats"]["success"]["count"] == 3
    assert stats["inference_stats"]["fail"]["count"] == 1
    repeat = [r for r in rows[0][2]["model_stats"] if r["name"] == "repeat_int32"][0]
    assert repeat["inference_stats"]["success"]["count"] == 1
    assert rows[0][13] is False and rows[0][16] is True
    assert rows[0][17] == 8 and rows[0][18] == 0


@pytest.mark.parametrize("path", ["/v2/models/stats", "/v2/models/simple/stats",
                                  "/v2/trace/setting", "/v2/models/simple/trace/setting",
                                  "/v2/logging"])
def test_admin_get_routes_answer_alike(path):
    """The raw GET routes: the same JSON (statistics untimed) on both
    servers."""
    import urllib3

    bodies = []
    for kind in ("port", "jax"):
        server = _server(kind)
        try:
            host, port = server.url.split(":")
            pool = urllib3.HTTPConnectionPool(host, int(port), retries=False)
            resp = pool.request("GET", path)
            bodies.append((resp.status, resp.headers.get("Content-Type"),
                           _untimed(json.loads(resp.data))))
            pool.close()
        finally:
            server.stop()
    assert bodies[0] == bodies[1] and bodies[0][0] == 200


# -- async_infer ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_server():
    server = _server("port")
    yield server
    server.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_async_infer_results(port_server, client):
    mod = MODS[client]
    with mod.InferenceServerClient(port_server.url, concurrency=4) as c:
        a, b, inputs = _simple_inputs(mod)
        handles = [c.async_infer("simple", inputs, request_id=f"r{i}") for i in range(6)]
        results = [h.get_result(timeout=30) for h in handles]
        assert [r.get_response()["id"] for r in results] == [f"r{i}" for i in range(6)]
        assert all(r.as_numpy("OUTPUT0").tolist() == (a + b).tolist() for r in results)
        failed = c.async_infer("nope", inputs)
        status, message = _error(lambda: failed.get_result(timeout=30))
    assert status == "400" and "unknown model" in message


def test_async_infer_poll_and_cancel_as_jax():
    """A request that cannot start yet (one worker, held busy): the
    non-blocking poll raises and cancel() succeeds, in both packages."""
    outcomes = []
    for mod in (port_http, jax_http):
        gate = threading.Event()
        with mod.InferenceServerClient("127.0.0.1:1", concurrency=1) as c:
            c._executor_lock.acquire()
            try:
                if c._executor is None:
                    from concurrent.futures import ThreadPoolExecutor

                    c._executor = ThreadPoolExecutor(max_workers=1)
            finally:
                c._executor_lock.release()
            busy = c._executor.submit(gate.wait, 30)
            _, _, inputs = _simple_inputs(mod)
            handle = c.async_infer("simple", inputs)
            poll = _error(lambda: handle.get_result(block=False))
            cancelled = handle.cancel()
            gate.set()
            busy.result(timeout=30)
            outcomes.append((poll, cancelled))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == ((None, "inference request not yet completed"), True)


def test_async_infer_transport_failure_is_typed():
    with port_http.InferenceServerClient("127.0.0.1:1") as c:
        _, _, inputs = _simple_inputs(port_http)
        status, message = _error(lambda: c.async_infer("simple", inputs).get_result(30))
    assert "connection error" in message


# -- the core: batching statistics, cancels, trace records ------------------------------


def _core_request(arrays):
    return {"inputs": [{"name": n, "datatype": d, "shape": list(a.shape), "array": a}
                       for n, (d, a) in arrays.items()]}


def test_batched_statistics_as_jax():
    """batched_matmul through each core's dynamic batcher, one request a
    window: the same inference, execution and batch statistics."""
    rows = []
    for core in (_port_core(), _jax_core()):
        for n in (1, 3, 3, 2):
            x = np.ones((n, 64), np.float32)
            core.infer("batched_matmul", "", _core_request({"X": ("FP32", x)}))
        rows.append(_untimed(core.statistics("batched_matmul")))
        for _, batcher in core._batchers.values():
            batcher.close()
    assert rows[0] == rows[1]
    stats = rows[0]["model_stats"][0]
    assert stats["inference_count"] == 9 and stats["execution_count"] == 4
    assert [(b["batch_size"], b["compute_infer"]["count"]) for b in stats["batch_stats"]] == [
        (1, 1), (2, 1), (3, 2)]
    assert stats["inference_stats"]["queue"]["count"] == 4


def test_cancelled_stream_statistics_as_jax():
    """A decoupled stream abandoned after its first response counts as a
    cancel, not a success or a failure, in both cores."""
    rows = []
    for core in (_port_core(), _jax_core()):
        request = _core_request({"IN": ("INT32", np.array([1, 2, 3], np.int32))})
        stream = core.infer_stream("repeat_int32", "", request)
        next(stream)
        stream.close()
        rows.append(_untimed(core.statistics("repeat_int32")))
    assert rows[0] == rows[1]
    assert rows[0]["model_stats"][0]["inference_stats"]["cancel"]["count"] == 1


def test_trace_records_as_jax(tmp_path):
    """trace_level TIMESTAMPS with trace_rate 2 and trace_count 3: every
    other request traced, three at most, mirrored to trace_file; the same
    records (timestamps aside) as the JAX core."""
    rows = []
    for kind, core in (("port", _port_core()), ("jax", _jax_core())):
        trace_file = tmp_path / f"{kind}.jsonl"
        core.trace_settings.update(trace_level=["TIMESTAMPS"], trace_rate="2",
                                   trace_count="3", trace_file=str(trace_file))
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        for i in range(9):
            request = _core_request({"INPUT0": ("INT32", a), "INPUT1": ("INT32", a)})
            request["id"] = f"t{i}"
            core.infer("simple", "", request)
        records = core.recent_traces()
        for record in records:
            ts = record["timestamps"]
            assert (ts["request_start_ns"] <= ts["compute_start_ns"] <= ts["compute_end_ns"]
                    <= ts["request_end_ns"])
        lines = [json.loads(line) for line in trace_file.read_text().splitlines()]
        assert lines == records
        rows.append([{k: v for k, v in r.items() if k != "timestamps"} for r in records])
        core.trace_settings["trace_level"] = ["OFF"]
        core.infer("simple", "", _core_request({"INPUT0": ("INT32", a),
                                                 "INPUT1": ("INT32", a)}))
        assert len(core.recent_traces()) == len(records)
    assert rows[0] == rows[1]
    assert [r["request_id"] for r in rows[0]] == ["t0", "t2", "t4"]


def test_statistics_last_inference_is_wall_clock():
    core = _port_core()
    before = int(time.time() * 1000)
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    core.infer("simple", "", _core_request({"INPUT0": ("INT32", a), "INPUT1": ("INT32", a)}))
    stats = core.statistics("simple")["model_stats"][0]
    assert before <= stats["last_inference"] <= int(time.time() * 1000)
    assert stats["version"] == "1"
