"""``client_tpu_torch.testing.byzantine`` against ``client_tpu.testing.byzantine``.

Each package's ``ByzantineHttpServer`` serves its own zoo's ``simple`` and
``repeat_int32`` under the same seeded plan. For every fault kind, the raw
bodies of the same requests (unary with binary and with JSON outputs, and
the SSE stream of a generate session) must be byte-identical between the
two servers: the same responses corrupted, the same way. Both packages'
clients, on both servers, raise the same typed ``IntegrityError`` (its
kind, field, expected and actual values, and message, the url aside). The plan's validation, log and
stats equal JAX's, and the HTTP frontend's ``infer_request_encoding_prefs``
equals JAX's on the same parsed requests.
"""

import http.client
import json

import numpy as np
import pytest

import client_tpu.http as jax_http
import client_tpu.integrity as jax_integrity
import client_tpu.testing.byzantine as jax_byz
import client_tpu_torch.http as port_http
import client_tpu_torch.integrity as port_integrity
import client_tpu_torch.testing.byzantine as port_byz
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.server import ServerCore as JaxCore
from client_tpu.server.http_server import infer_request_encoding_prefs as jax_prefs
from client_tpu.server.http_server import parse_infer_request as jax_parse
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.server import ServerCore
from client_tpu_torch.server.http_server import infer_request_encoding_prefs as port_prefs
from client_tpu_torch.server.http_server import parse_infer_request as port_parse
from client_tpu_torch.testing import ByzantineHttpServer, ByzantinePlan
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

UNARY = ("shape_lie", "dtype_lie", "truncate", "bit_flip", "wrong_id", "garbage_json")
STREAM = ("dup_index", "drop_index")


@pytest.fixture(autouse=True)
def _fresh_default_policies(monkeypatch):
    """Each package's clients validate under its process-default policy,
    whose contract cache is keyed by model name: a ``simple`` contract
    cached by an earlier test would reorder one package's violations."""
    for mod in (port_integrity, jax_integrity):
        monkeypatch.setattr(mod, "_DEFAULT_POLICY", mod.IntegrityPolicy())


@pytest.fixture(scope="module")
def cores():
    return {"port": ServerCore(default_model_zoo("cpu"), device="cpu"), "jax": JaxCore(jax_zoo())}


def _servers(cores, **plan):
    return {"port": port_byz.ByzantineHttpServer(cores["port"], **plan).start(),
            "jax": jax_byz.ByzantineHttpServer(cores["jax"], **plan).start()}


def _stop(servers):
    for s in servers.values():
        s.stop()


def _post(url, path, body, headers):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()).get("Inference-Header-Content-Length"), \
            resp.read()
    finally:
        conn.close()


def _simple_body(binary, request_id="rq7"):
    a = list(range(16))
    doc = {"id": request_id, "inputs": [
        {"name": n, "shape": [1, 16], "datatype": "INT32", "data": a} for n in ("INPUT0",
                                                                               "INPUT1")],
           "outputs": [{"name": o, "parameters": {"binary_data": binary}}
                       for o in ("OUTPUT0", "OUTPUT1")]}
    return json.dumps(doc).encode()


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("kind", UNARY)
def test_unary_bodies_are_byte_identical(cores, kind, binary):
    servers = _servers(cores, kinds=(kind,), seed=7, every=2, limit=3)
    try:
        bodies = {pkg: [_post(s.url, "/v2/models/simple/infer", _simple_body(binary),
                              {"Content-Type": "application/json"}) for _ in range(8)]
                  for pkg, s in servers.items()}
        assert bodies["port"] == bodies["jax"]
        assert servers["port"].plan.log == servers["jax"].plan.log == [(2, kind), (4, kind),
                                                                         (6, kind)]
        assert servers["port"].plan.stats() == servers["jax"].plan.stats()
        honest = bodies["port"][0][2]
        assert all(b[2] != honest for b in bodies["port"][1:6:2])
    finally:
        _stop(servers)


def test_mixed_plan_draws_the_same_faults(cores):
    servers = _servers(cores, kinds=UNARY, seed=11, every=1)
    try:
        bodies = {pkg: [_post(s.url, "/v2/models/simple/infer", _simple_body(i % 2 == 0),
                              {"Content-Type": "application/json"}) for i in range(24)]
                  for pkg, s in servers.items()}
        assert bodies["port"] == bodies["jax"]
        assert servers["port"].plan.log == servers["jax"].plan.log
        assert len({k for _, k in servers["port"].plan.log}) >= 4
    finally:
        _stop(servers)


def _generate(url):
    body = json.dumps({"IN": [1, 2, 3, 4, 5], "DELAY": [0, 0, 0, 0, 0], "WAIT": [0]}).encode()
    return _post(url, "/v2/models/repeat_int32/generate_stream", body,
                 {"Content-Type": "application/json"})


@pytest.mark.parametrize("kind", STREAM)
def test_sse_streams_are_byte_identical(cores, kind):
    servers = _servers(cores, kinds=(kind,), seed=7, every=2)
    try:
        streams = {pkg: [_generate(s.url) for _ in range(2)] for pkg, s in servers.items()}
        assert streams["port"] == streams["jax"]
        assert servers["port"].plan.log == servers["jax"].plan.log
        assert servers["port"].plan.log and all(k == kind for _, k in servers["port"].plan.log)
        assert streams["port"][0][2].count(b"data:") == 5 + (
            len(servers["port"].plan.log) // 2 if kind == "dup_index" else
            -(len(servers["port"].plan.log) // 2))
    finally:
        _stop(servers)


def _typed(fn, url):
    try:
        fn()
        return ("ok",)
    except (port_integrity.IntegrityError, jax_integrity.IntegrityError) as e:
        return ("IntegrityError", e.kind, e.field, repr(e.expected), repr(e.actual),
                str(e).replace(url, "<endpoint>"))
    except Exception as e:
        return (type(e).__name__, str(e).replace(url, "<url>"))


def _client_infer(mod, url):
    client = mod.InferenceServerClient(url)
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    inputs = []
    for name in ("INPUT0", "INPUT1"):
        inp = mod.InferInput(name, [1, 16], "INT32")
        inp.set_data_from_numpy(a)
        inputs.append(inp)
    outputs = [mod.InferRequestedOutput(n, binary_data=True) for n in ("OUTPUT0", "OUTPUT1")]
    try:
        return client.infer("simple", inputs, outputs=outputs, request_id="rq7")
    finally:
        client.close()


@pytest.mark.parametrize("kind", ["shape_lie", "dtype_lie", "truncate", "wrong_id",
                                  "garbage_json"])
def test_both_clients_raise_the_same_integrity_error(cores, kind):
    seen = {}
    for server_pkg in ("port", "jax"):
        for client_pkg, mod in (("port", port_http), ("jax", jax_http)):
            servers = _servers(cores, kinds=(kind,), seed=7, every=1)
            try:
                url = servers[server_pkg].url
                seen[(server_pkg, client_pkg)] = _typed(lambda: _client_infer(mod, url), url)
            finally:
                _stop(servers)
    assert len(set(seen.values())) == 1, seen
    assert next(iter(seen.values()))[0] == "IntegrityError"


def test_bit_flip_passes_the_contract_in_both_clients(cores):
    """A flipped bit keeps every claim consistent: both clients return a
    result whose value differs from the honest one in one element."""
    values = {}
    for server_pkg in ("port", "jax"):
        for client_pkg, mod in (("port", port_http), ("jax", jax_http)):
            servers = _servers(cores, kinds=("bit_flip",), seed=7, every=1)
            try:
                result = _client_infer(mod, servers[server_pkg].url)
                values[(server_pkg, client_pkg)] = (result.as_numpy("OUTPUT0").tobytes(),
                                                    result.as_numpy("OUTPUT1").tobytes())
            finally:
                _stop(servers)
    assert len(set(values.values())) == 1
    honest = (np.arange(16, dtype=np.int32) * 2).tobytes()
    flipped = next(iter(values.values()))
    assert (flipped[0] != honest) != (flipped[1] != np.zeros(16, np.int32).tobytes())


@pytest.mark.parametrize("kind", STREAM)
def test_both_clients_see_the_same_stream_fault(cores, kind):
    seen = {}
    for server_pkg in ("port", "jax"):
        for client_pkg, mod in (("port", port_http), ("jax", jax_http)):
            servers = _servers(cores, kinds=(kind,), seed=7, every=2)
            url = servers[server_pkg].url
            client = mod.InferenceServerClient(url)
            try:
                def run():
                    return [json.dumps(e, sort_keys=True, default=str)
                            for e in client.generate_stream(
                                "repeat_int32", {"IN": [1, 2, 3, 4, 5],
                                                 "DELAY": [0, 0, 0, 0, 0], "WAIT": [0]})]
                seen[(server_pkg, client_pkg)] = _typed(run, url)
            finally:
                client.close()
                _stop(servers)
    assert len(set(seen.values())) == 1, seen


@pytest.mark.parametrize("kwargs", [{"kinds": ("nope",)}, {"every": 0}, {"kinds": ()},
                                    {"seed": 3, "every": 3, "limit": 1}])
def test_plan_validation_equals_jax_s(kwargs):
    def build(cls):
        try:
            plan = cls(**kwargs)
            return ("ok", plan.kinds, plan.every, plan.limit,
                    [plan.next_fault(UNARY) for _ in range(7)], plan.stats(), plan.log)
        except ValueError as e:
            return ("ValueError", str(e))

    assert build(ByzantinePlan) == build(jax_byz.ByzantinePlan)
    assert port_byz.FAULT_KINDS == jax_byz.FAULT_KINDS
    assert port_byz.__all__ == jax_byz.__all__


def test_testing_package_exports_the_byzantine_server():
    import client_tpu.testing as jax_testing
    import client_tpu_torch.testing as port_testing

    assert port_testing.__all__ == jax_testing.__all__
    assert port_testing.ByzantineHttpServer is ByzantineHttpServer


@pytest.mark.parametrize("binary", [True, False, None])
@pytest.mark.parametrize("default", [True, False])
def test_encoding_prefs_equal_jax_s(binary, default):
    doc = {"inputs": [{"name": "INPUT0", "shape": [1, 2], "datatype": "INT32", "data": [1, 2]}],
           "parameters": {"binary_data_output": default}}
    if binary is not None:
        doc["outputs"] = [{"name": "OUTPUT0", "parameters": {"binary_data": binary}}]
    body = json.dumps(doc).encode()
    assert port_prefs(port_parse(body, None)) == jax_prefs(jax_parse(body, None))
