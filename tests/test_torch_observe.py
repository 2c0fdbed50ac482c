"""The port's observability surface against the JAX package's.

- the same recorded events (spans and phases, errors by domain, retries,
  breaker transitions, streams and reconnects, SLOs, integrity counts, ORCA
  reports, data-plane ops) under the same injected clock and seeded rngs
  render byte-identical Prometheus text and equal snapshots and breakdowns;
- each frontend's span has JAX's phase names in JAX's order, and so do the
  stream spans;
- the ``traceparent`` joins a client span to the server's access record
  across the 2x2 matrix (a JAX client on the port's server, the port's
  client on a JAX server), on HTTP and GRPC;
- ``/metrics`` and ``/v2/trace/access`` of the port's HTTP server carry the
  JAX server's names, label sets and counts after the same requests;
- the port's ``cuda`` data-plane family counts what JAX's ``tpu`` family
  counts over the same op sequence (and ``system`` what ``system`` counts);
- ORCA in both formats over HTTP (a response header) and GRPC (trailing
  metadata), from either server to either client.
"""

import asyncio
import json
import random
import re
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import client_tpu.grpc as jax_grpc
import client_tpu.grpc.aio as jax_grpc_aio
import client_tpu.http as jax_http
import client_tpu.http.aio as jax_http_aio
import client_tpu.observe as jax_observe
import client_tpu.resilience as jax_res
import client_tpu.utils as jax_utils
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
import client_tpu_torch.http as port_http
import client_tpu_torch.http.aio as port_http_aio
import client_tpu_torch.observe as port_observe
import client_tpu_torch.resilience as port_res
import client_tpu_torch.utils as port_utils
from client_tpu.models import simple as jax_simple
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu.utils import shared_memory as jax_shm
from client_tpu.utils import tpu_shared_memory as jax_tpushm
from client_tpu_torch.models import AddSubModel, RepeatModel
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from client_tpu_torch.utils import cuda_shared_memory as port_cudashm
from client_tpu_torch.utils import shared_memory as port_shm
from test_torch_flight import FakeClock, _time_limit  # noqa: F401 (autouse)

CALL_S = 10.0
WAIT_S = 20

PKG = {
    "port": {"http": port_http, "grpc": port_grpc, "http_aio": port_http_aio,
             "grpc_aio": port_grpc_aio, "observe": port_observe, "res": port_res,
             "utils": port_utils},
    "jax": {"http": jax_http, "grpc": jax_grpc, "http_aio": jax_http_aio,
            "grpc_aio": jax_grpc_aio, "observe": jax_observe, "res": jax_res,
            "utils": jax_utils},
}


# -- the same events, the same exposition ---------------------------------------
def _events_telemetry(observe, res, utils, clock):
    tel = observe.Telemetry(rng=random.Random(21), sample="ratio", sample_ratio=0.5,
                            orca_format="json")
    policy = tel.attach(res.ResiliencePolicy(
        retry=res.RetryPolicy(max_attempts=3, initial_backoff_s=0.01,
                              rng=random.Random(22)),
        breaker=res.CircuitBreaker(window=4, min_calls=2, recovery_time_s=1.0,
                                   clock=clock.monotonic)))
    errors = [None, utils.InferenceServerException("x", status="503"),
              utils.InferenceServerException("Deadline Exceeded", status="499"),
              utils.InferenceServerException("bad", status="400"),
              utils.InferenceServerException("x", status="StatusCode.UNAVAILABLE"),
              res.CircuitOpenError()]
    for i in range(30):
        frontend = ("http", "grpc", "http_aio", "grpc_aio")[i % 4]
        span = tel.begin(frontend, ("simple", "identity_fp32")[i % 2])
        t = clock.perf_counter_ns()
        span.phase("serialize", span.start_ns, t)
        clock.advance(0.3 * (i % 5 + 1))
        t2 = clock.perf_counter_ns()
        span.phase("attempt", t, t2)
        span.phase("ttfb", t, t2)
        clock.advance(0.05 * (i % 3))
        span.phase("recv", t2, clock.perf_counter_ns())
        span.phase("deserialize", t2, clock.perf_counter_ns())
        tel.finish(span, error=errors[i % len(errors)])
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) % 3:
            raise utils.InferenceServerException("x", status="503")
        return "ok"

    for _ in range(4):
        try:
            policy.execute(flaky, sleep=clock.sleep)
        except utils.InferenceServerException:
            pass
    slo = tel.track_slo("ttft_p95", "ttft_ms", 3.0, objective=0.9)
    tel.track_slo("req_p99", "request_ms", 1.0, objective=0.99)
    for i in range(5):
        span = tel.begin_stream("grpc", "decoder_lm", "stream")
        for _ in range(3 + i):
            clock.advance(1.0 + i)
            span.mark()
        if i == 2:
            span.reconnect(abandoned=1, resent=1)
            span.mark()
            tel.on_stream_reconnect(res.StreamReconnected(1, ["a"], ["b"]))
        tel.finish_stream(span, abandoned=i == 4)
    tel.integrity_checked("contract", "h:1", 5)
    tel.integrity_violation("shape", "h:2")
    tel.ingest_endpoint_load(
        "h:1", '{"named_metrics":{"inference_count":4,"avg_compute_infer_us":12,'
               '"active_models":2}}')
    tel.ingest_endpoint_load(
        "h:2", "named_metrics.inference_count=9, named_metrics.active_models=3", "text")
    tel.ingest_endpoint_load("h:3", "garbage")
    return tel, slo


def _telemetry_views(pkg, monkeypatch):
    observe, res, utils = PKG[pkg]["observe"], PKG[pkg]["res"], PKG[pkg]["utils"]
    clock = FakeClock()
    monkeypatch.setattr(observe, "time", clock)
    monkeypatch.setattr(res, "time", clock)
    tel, slo = _events_telemetry(observe, res, utils, clock)
    return {
        "prometheus": tel.registry.prometheus_text(),
        "snapshot": tel.registry.snapshot(),
        "phases": tel.phase_breakdown(),
        "streams": tel.stream_breakdown(),
        "slo": tel.slo_report(),
        "traces": tel.recent_traces(),
        "chrome": tel.chrome_trace(),
        "loads": {u: (l.metrics, l.format) for u, l in tel.endpoint_loads().items()},
    }


def test_telemetry_exposition_identical(monkeypatch):
    ours = _telemetry_views("port", monkeypatch)
    theirs = _telemetry_views("jax", monkeypatch)
    for key in ours:
        assert ours[key] == theirs[key], key
    text = ours["prometheus"]
    for name in ("client_tpu_requests_total", "client_tpu_request_errors_total",
                 "client_tpu_phase_seconds_bucket", "client_tpu_retries_total",
                 "client_tpu_breaker_transitions_total", "client_tpu_stream_reconnects_total",
                 "client_tpu_slo_burn_rate", "client_tpu_integrity_violations_total",
                 "client_tpu_endpoint_load"):
        assert name in text, name


def _registry_text(observe):
    reg = observe.MetricsRegistry(max_series_per_metric=3)
    c = reg.counter("demo_total", "A counter with \\ and \n in help", ("route", "code"))
    for route in ('/v2/a"b', "/v2/c\\d", "/v2/e\nf", "/v2/g", "/v2/h"):
        c.labels(route, "200").inc(2)
    g = reg.gauge("demo_gauge", "A gauge")
    g.set(-3.25)
    h = reg.histogram("demo_seconds", "A histogram", ("op",))
    for i, v in enumerate([1e-5, 3e-4, 0.002, 0.04, 0.7, 3.0, 50.0]):
        h.labels("op%d" % (i % 2)).observe(v)
    reg.add_collector(lambda: g.set(7.5))
    return reg.prometheus_text(), reg.snapshot()


def test_registry_exposition_identical():
    assert _registry_text(port_observe) == _registry_text(jax_observe)


def test_traceparent_helpers_equal():
    for rng_seed in range(4):
        ours = port_observe.make_span_id(random.Random(rng_seed))
        theirs = jax_observe.make_span_id(random.Random(rng_seed))
        assert ours == theirs
        tid = port_observe.make_trace_id(random.Random(rng_seed))
        assert tid == jax_observe.make_trace_id(random.Random(rng_seed))
        value = port_observe.format_traceparent(tid, ours, rng_seed % 2 == 0)
        assert value == jax_observe.format_traceparent(tid, ours, rng_seed % 2 == 0)
        assert port_observe.parse_traceparent(value) == jax_observe.parse_traceparent(value)
    for bad in (None, "", "00-zz-yy-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                "01-" + "a" * 32 + "-" + "b" * 16 + "-01-extra", "garbage"):
        assert port_observe.parse_traceparent(bad) == jax_observe.parse_traceparent(bad)
    assert port_observe.REQUEST_PHASES == jax_observe.REQUEST_PHASES
    assert port_observe.SHM_FAMILIES == jax_observe.SHM_FAMILIES
    for header in ("TRACEPARENT_HEADER", "ENDPOINT_LOAD_HEADER",
                   "ENDPOINT_LOAD_FORMAT_HEADER"):
        assert getattr(port_observe, header) == getattr(jax_observe, header)


@pytest.mark.parametrize("value,fmt", [
    ('{"named_metrics":{"inference_count":3,"avg_compute_infer_us":40,"active_models":2}}',
     None),
    ("named_metrics.inference_count=3, named_metrics.active_models=2", None),
    ("named_metrics.inference_count=3, junk, x=nan", "text"),
    ('{"utilization":{"cpu":0.5},"rps":12}', "json"),
    ("{not json", None),
    ("", None),
])
def test_parse_endpoint_load_equal(value, fmt):
    ours = port_observe.parse_endpoint_load(value, fmt)
    theirs = jax_observe.parse_endpoint_load(value, fmt)
    if theirs is None:
        assert ours is None
    else:
        assert (ours.metrics, ours.format) == (theirs.metrics, theirs.format)


# -- live servers -------------------------------------------------------------
def _port_core():
    return ServerCore([AddSubModel(device="cpu"), RepeatModel()], device="cpu")


def _jax_core():
    return JaxCore([jax_simple.AddSubModel(), jax_simple.RepeatModel()])


@pytest.fixture(scope="module")
def servers():
    port_core, jax_core = _port_core(), _jax_core()
    started = {
        ("http", "port"): HttpInferenceServer(port_core).start(),
        ("grpc", "port"): GrpcInferenceServer(port_core, max_workers=16).start(),
        ("http", "jax"): JaxHttpServer(jax_core).start(),
        ("grpc", "jax"): JaxGrpcServer(jax_core, max_workers=16).start(),
    }
    started["cores"] = {"port": port_core, "jax": jax_core}
    yield started
    for key, server in started.items():
        if key != "cores":
            server.stop()


def _inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
            mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


def _infer(pkg, frontend, url, tel, **kw):
    """One traced ``simple`` infer from ``pkg``'s ``frontend`` client."""
    mod = PKG[pkg][frontend]
    if frontend.endswith("aio"):
        async def run():
            async with mod.InferenceServerClient(url) as client:
                client.configure_telemetry(tel)
                return await client.infer("simple", _inputs(mod), client_timeout=CALL_S, **kw)

        return asyncio.run(asyncio.wait_for(run(), WAIT_S))
    with mod.InferenceServerClient(url) as client:
        client.configure_telemetry(tel)
        return client.infer("simple", _inputs(mod), client_timeout=CALL_S, **kw)


def _shape(trace):
    return ([p["name"] for p in trace["phases"]], [e["name"] for e in trace["events"]],
            trace["frontend"], trace["op"], trace["error"] is None)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("frontend", ["http", "http_aio", "grpc", "grpc_aio"])
def test_phase_names_and_order_per_frontend(servers, frontend, server_pkg):
    url = servers[(frontend.split("_")[0], server_pkg)].url
    shapes = {}
    for pkg in ("port", "jax"):
        tel = PKG[pkg]["observe"].Telemetry(rng=random.Random(5))
        _infer(pkg, frontend, url, tel)
        [trace] = tel.recent_traces()
        shapes[pkg] = _shape(trace)
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][0][0] == "serialize"


def _stream_shapes(pkg, transport, url):
    mod = PKG[pkg][transport]
    tel = PKG[pkg]["observe"].Telemetry(rng=random.Random(6))
    if transport == "http":
        with mod.InferenceServerClient(url) as client:
            client.configure_telemetry(tel)
            events = list(client.generate_stream("repeat_int32", {"IN": [4, 5, 6]}))
            span = client.last_stream_span()
        count = len(events)
    else:
        import queue

        got: "queue.Queue" = queue.Queue()
        with mod.InferenceServerClient(url) as client:
            client.configure_telemetry(tel)
            client.start_stream(lambda r, e: got.put((r, e)))
            data = np.array([4, 5, 6], dtype=np.int32)
            inp = mod.InferInput("IN", [3], "INT32").set_data_from_numpy(data)
            client.async_stream_infer("repeat_int32", [inp])
            count = 0
            for _ in range(3):
                result, error = got.get(timeout=WAIT_S)
                assert error is None
                count += 1
            client.stop_stream()
            span = client.stream_span()
    d = span.as_dict()
    return (count, d["frontend"], d["op"], span.chunk_count, len(span.attempts),
            sorted(d), tel.registry.prometheus_text().count("client_tpu_streams_total{"))


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_stream_span_shape_equal(servers, transport, server_pkg):
    url = servers[(transport, server_pkg)].url
    assert _stream_shapes("port", transport, url) == _stream_shapes("jax", transport, url)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("frontend", ["http", "grpc"])
def test_traceparent_joins_access_record(servers, frontend, client_pkg, server_pkg):
    core = servers["cores"][server_pkg]
    tel = PKG[client_pkg]["observe"].Telemetry(rng=random.Random())
    rid = f"rq-{uuid.uuid4().hex[:8]}"
    _infer(client_pkg, frontend, servers[(frontend, server_pkg)].url, tel, request_id=rid)
    [trace] = tel.recent_traces()
    records = [r for r in core.access_records(1024) if r["trace_id"] == trace["trace_id"]]
    assert len(records) == 1
    record = records[0]
    assert record["client_span_id"] == trace["span_id"]
    assert record["model_name"] == "simple" and record["request_id"] == rid
    assert record["queue_ns"] >= 0 and record["compute_ns"] >= 0
    assert record["total_ns"] >= record["compute_ns"]


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_grpc_stream_traceparent_joins_every_request(servers, client_pkg, server_pkg):
    import queue

    core = servers["cores"][server_pkg]
    mod = PKG[client_pkg]["grpc"]
    tel = PKG[client_pkg]["observe"].Telemetry(rng=random.Random())
    got: "queue.Queue" = queue.Queue()
    with mod.InferenceServerClient(servers[("grpc", server_pkg)].url) as client:
        client.configure_telemetry(tel)
        client.start_stream(lambda r, e: got.put((r, e)))
        for i in range(3):
            client.async_stream_infer("simple", _inputs(mod), request_id=f"s{i}")
        for _ in range(3):
            assert got.get(timeout=WAIT_S)[1] is None
        client.stop_stream()
        span = client.stream_span()
    records = [r for r in core.access_records(1024) if r["trace_id"] == span.trace_id]
    assert sorted(r["request_id"] for r in records) == ["s0", "s1", "s2"]
    assert {r["client_span_id"] for r in records} == {span.span_id}


def _get(url, path):
    with urllib.request.urlopen(f"http://{url}/{path}", timeout=CALL_S) as resp:
        return resp.headers.get("Content-Type"), resp.read().decode()


def _drive_fresh_server(pkg):
    """The same requests on a fresh HTTP server of ``pkg``: 3 traced
    ``simple`` infers, 1 untraced, 1 failing, 1 traced generate stream."""
    core = _port_core() if pkg == "port" else _jax_core()
    server_cls = HttpInferenceServer if pkg == "port" else JaxHttpServer
    server = server_cls(core).start()
    try:
        mod = PKG[pkg]["http"]
        tel = PKG[pkg]["observe"].Telemetry(rng=random.Random(8))
        with mod.InferenceServerClient(server.url) as client:
            client.configure_telemetry(tel)
            for i in range(3):
                client.infer("simple", _inputs(mod), request_id=f"r{i}", client_timeout=CALL_S)
            list(client.generate_stream("repeat_int32", {"IN": [1, 2]}))
        with mod.InferenceServerClient(server.url) as client:
            client.infer("simple", _inputs(mod), client_timeout=CALL_S)
            bad = [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(
                np.zeros((1, 16), np.int32))]
            with pytest.raises(PKG[pkg]["utils"].InferenceServerException):
                client.infer("simple", bad, client_timeout=CALL_S)
        return _get(server.url, "metrics"), json.loads(_get(server.url, "v2/trace/access")[1])
    finally:
        server.stop()


_SECONDS = re.compile(r"^(client_tpu_server_(queue|compute)_seconds\{[^}]*\}) .*$", re.M)


def test_metrics_and_trace_access_equal_to_jax_server():
    (ours_type, ours_text), ours_access = _drive_fresh_server("port")
    (theirs_type, theirs_text), theirs_access = _drive_fresh_server("jax")
    assert ours_type == theirs_type
    # every line but the time sums is byte-identical: names, help, label
    # sets, the live/ready gauges and every count
    assert _SECONDS.sub(r"\1 T", ours_text) == _SECONDS.sub(r"\1 T", theirs_text)
    assert 'client_tpu_server_request_success_count{model="simple"} 4' in ours_text
    assert 'client_tpu_server_request_fail_count{model="simple"} 1' in ours_text
    assert "client_tpu_server_traced_requests 4" in ours_text

    def strip(records):
        return [(sorted(r), r["model_name"], r["request_id"], r["responses"],
                 "first_response_ns" in r) for r in records]

    assert strip(ours_access) == strip(theirs_access)
    assert len(ours_access) == 4


@pytest.mark.parametrize("fmt", ["json", "text"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("frontend", ["http", "grpc", "http_aio", "grpc_aio"])
def test_orca_report_both_formats(servers, frontend, server_pkg, fmt):
    url = servers[(frontend.split("_")[0], server_pkg)].url
    seen = {}
    for pkg in ("port", "jax"):
        observe = PKG[pkg]["observe"]
        tel = observe.Telemetry(rng=random.Random(9), orca_format=fmt)
        result = _infer(pkg, frontend, url, tel)
        header = result.get_response_header("endpoint-load-metrics")
        assert header is not None
        load = tel.endpoint_loads()[url]
        seen[pkg] = (re.sub(r"\d+", "N", header), sorted(load.metrics), load.format)
    assert seen["port"] == seen["jax"]
    if fmt == "json":
        assert seen["port"][0] == (
            '{"named_metrics":{"inference_count":N,"avg_compute_infer_us":N,'
            '"active_models":N}}')


def test_orca_report_text_equal_on_equal_state():
    ours, theirs = _port_core(), _jax_core()
    for fmt in ("json", "text"):
        assert ours.orca_report(fmt, "simple") == theirs.orca_report(fmt, "simple")
        assert ours.orca_report(fmt, "nope") == theirs.orca_report(fmt, "nope")


# -- the data-plane families ----------------------------------------------------
def _dataplane_ops(pkg, server):
    """One op sequence against ``server``: a system region and a device
    region (port: cuda on the CPU; JAX: tpu), each created, written, read,
    registered, used by an infer, unregistered and destroyed."""
    observe = PKG[pkg]["observe"]
    rec = observe.DataPlaneRecorder()
    previous = observe.install_dataplane(rec)
    mod = PKG[pkg]["http"]
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    nbytes = a.nbytes
    try:
        with mod.InferenceServerClient(server.url) as client:
            shm = port_shm if pkg == "port" else jax_shm
            key = f"/dp_{uuid.uuid4().hex[:10]}"
            sys_region = shm.create_shared_memory_region("sys_in", key, nbytes * 2)
            shm.set_shared_memory_region(sys_region, [a, a])
            shm.get_contents_as_numpy(sys_region, np.int32, [1, 16])
            client.register_system_shared_memory("sys_in", key, nbytes * 2)
            if pkg == "port":
                dev = port_cudashm.create_shared_memory_region(
                    "dev_in", nbytes * 2, device="cpu")
                port_cudashm.set_shared_memory_region(dev, [a])
                port_cudashm.set_shared_memory_region_from_torch(
                    dev, torch.from_numpy(a.copy()), offset=nbytes)
                port_cudashm.get_contents_as_numpy(dev, "INT32", [1, 16])
                client.register_cuda_shared_memory(
                    "dev_in", port_cudashm.get_raw_handle(dev), 0, nbytes * 2)
                family, register, unregister, destroy = (
                    "cuda", "register_cuda_shared_memory",
                    "unregister_cuda_shared_memory", port_cudashm.destroy_shared_memory_region)
            else:
                dev = jax_tpushm.create_shared_memory_region("dev_in", nbytes * 2)
                jax_tpushm.set_shared_memory_region(dev, [a])
                jax_tpushm.set_shared_memory_region(dev, [a], offset=nbytes)
                jax_tpushm.get_contents_as_numpy(dev, "INT32", [1, 16])
                client.register_tpu_shared_memory(
                    "dev_in", jax_tpushm.get_raw_handle(dev), 0, nbytes * 2)
                family, unregister, destroy = (
                    "tpu", "unregister_tpu_shared_memory",
                    jax_tpushm.destroy_shared_memory_region)
            in0 = mod.InferInput("INPUT0", [1, 16], "INT32")
            in0.set_shared_memory("dev_in", nbytes)
            in1 = mod.InferInput("INPUT1", [1, 16], "INT32")
            in1.set_shared_memory("sys_in", nbytes, offset=nbytes)
            out = client.infer("simple", [in0, in1], client_timeout=CALL_S)
            np.testing.assert_array_equal(out.as_numpy("OUTPUT0"), a + a)
            getattr(client, unregister)("dev_in")
            client.unregister_system_shared_memory("sys_in")
            destroy(dev)
            shm.destroy_shared_memory_region(sys_region)
        text = rec.registry.prometheus_text()
        snap = rec.snapshot()
    finally:
        observe.install_dataplane(previous)
    return family, text, snap


def _counts(text, family):
    """The ``system`` and ``family`` data-plane lines of ``text``, with
    ``family`` renamed ``dev``; the RPC latency histogram is reduced to its
    count."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or "_bucket{" in line or "_sum{" in line:
            continue
        if f'family="{family}"' in line or 'family="system"' in line:
            out.append(line.replace(f'family="{family}"', 'family="dev"'))
    return out


def test_cuda_family_counts_what_tpu_family_counts(servers):
    """The port's client against the port's server feeds family ``cuda``
    what JAX's client against JAX's server feeds family ``tpu`` (the JAX
    package's tpu rpcs are not the port's); ``system`` alike."""
    fam_ours, ours, snap_ours = _dataplane_ops("port", servers[("http", "port")])
    fam_theirs, theirs, snap_theirs = _dataplane_ops("jax", servers[("http", "jax")])
    assert sorted(_counts(ours, fam_ours)) == sorted(_counts(theirs, fam_theirs))
    assert 'client_tpu_shm_ops_total{family="cuda",op="create"} 1' in ours
    assert 'client_tpu_shm_regions{family="cuda"} 0' in ours
    assert snap_ours["families"]["cuda"] == snap_theirs["families"]["tpu"]
    assert snap_ours["families"]["system"] == snap_theirs["families"]["system"]
