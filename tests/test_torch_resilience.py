"""The port's resilience layer against the JAX package's.

- ``RetryPolicy``: the same seed gives the same backoff schedule, and the
  same domain gate decides the same retries;
- ``CircuitBreaker``: the same event sequence under the same injected clock
  gives the same transitions, fast-fails and retry-after values;
- ``classify_fault``: the same live failure (refused, reset at accept,
  reset mid-request, blackhole) gives the same fault domain and status for
  the port's client as for the JAX client, on HTTP and GRPC, against a
  server of either package, behind either package's ``ChaosProxy``;
- sequence requests are never re-sent (unary and on a reconnecting
  stream); ``start_stream(auto_reconnect=True)`` on the sync GRPC client;
  retries on both aio clients; the connect-only ``max_retries`` knob and
  ``probe=True`` health checks behave as the JAX clients'.

Every backoff draws from a seeded ``random.Random``; every socket call has
a client timeout and every wait a bound; each test runs under a time limit.
"""

import asyncio
import queue
import random
import socket
import time

import numpy as np
import pytest

import client_tpu.grpc as jax_grpc
import client_tpu.grpc.aio as jax_grpc_aio
import client_tpu.http as jax_http
import client_tpu.http.aio as jax_http_aio
import client_tpu.resilience as jax_res
import client_tpu.testing as jax_testing
import client_tpu.utils as jax_utils
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
import client_tpu_torch.http as port_http
import client_tpu_torch.http.aio as port_http_aio
import client_tpu_torch.resilience as port_res
import client_tpu_torch.testing as port_testing
import client_tpu_torch.utils as port_utils
from client_tpu.models import simple as jax_simple
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import AddSubModel
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

WAIT_S = 20
CALL_S = 10.0

PKG = {
    "port": {"http": port_http, "grpc": port_grpc, "http_aio": port_http_aio,
             "grpc_aio": port_grpc_aio, "res": port_res, "testing": port_testing,
             "utils": port_utils},
    "jax": {"http": jax_http, "grpc": jax_grpc, "http_aio": jax_http_aio,
            "grpc_aio": jax_grpc_aio, "res": jax_res, "testing": jax_testing,
            "utils": jax_utils},
}

# the channel must redial faster than the retry backoff, or every re-attempt
# fast-fails inside grpc's own (default ~1 s) reconnect backoff; a local
# subchannel pool keeps one client's dead connection attempt from being
# shared with the next client of the same target
FAST_REDIAL = [
    ("grpc.use_local_subchannel_pool", 1),
    ("grpc.initial_reconnect_backoff_ms", 50),
    ("grpc.min_reconnect_backoff_ms", 50),
    ("grpc.max_reconnect_backoff_ms", 100),
    ("grpc.max_send_message_length", 2**31 - 1),
    ("grpc.max_receive_message_length", 2**31 - 1),
]


@pytest.fixture(scope="module")
def cores():
    return {"port": ServerCore([AddSubModel(device="cpu")], device="cpu"),
            "jax": JaxCore([jax_simple.AddSubModel()])}


@pytest.fixture(scope="module")
def servers(cores):
    started = {
        ("http", "port"): HttpInferenceServer(cores["port"]).start(),
        ("grpc", "port"): GrpcInferenceServer(cores["port"], max_workers=16).start(),
        ("http", "jax"): JaxHttpServer(cores["jax"]).start(),
        ("grpc", "jax"): JaxGrpcServer(cores["jax"], max_workers=16).start(),
    }
    yield started
    for server in started.values():
        server.stop()


def _inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return a + b, [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                   mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


def _client(pkg, transport, url, **kw):
    mod = PKG[pkg][transport]
    if transport.startswith("grpc"):
        kw.setdefault("channel_args", FAST_REDIAL)
    return mod.InferenceServerClient(url, **kw)


# a mid-request reset: over GRPC past the ~160-byte h2 handshake (a reset
# there is a connect failure) and inside the ~600-byte infer exchange
MID_BYTES = {"http": 64, "grpc": 600}


def _policy(pkg, seed=0xC11E, breaker=None, **retry_kw):
    """A seeded policy; its re-attempts outlast grpc's channel redial
    (50-100 ms with FAST_REDIAL). An attempt over a faulted connection can
    stall under load (the proxy's reset not delivered; seen with either
    package's client): it is cut at 2 s and, if idempotent, re-attempted."""
    res = PKG[pkg]["res"]
    retry_kw.setdefault("max_attempts", 6)
    retry_kw.setdefault("initial_backoff_s", 0.05)
    retry_kw.setdefault("max_backoff_s", 0.4)
    retry_kw.setdefault("per_attempt_timeout_s", 2.0)
    retry_kw.setdefault("retry_timeouts", True)
    return res.ResiliencePolicy(
        retry=res.RetryPolicy(rng=random.Random(seed), **retry_kw), breaker=breaker)


def _success_count(core, model="simple") -> int:
    return core.statistics(model)["model_stats"][0]["inference_stats"]["success"]["count"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the policy engine ---------------------------------------------------------
RETRY_CONFIGS = [
    dict(),
    dict(initial_backoff_s=0.1, max_backoff_s=1.0, backoff_multiplier=3.0),
    dict(initial_backoff_s=0.01, max_backoff_s=0.05, jitter=False),
    dict(max_attempts=2, initial_backoff_s=0.5, max_backoff_s=0.6),
]


@pytest.mark.parametrize("seed", [0, 7, 0xC11E, 2**31 - 1])
@pytest.mark.parametrize("config", range(len(RETRY_CONFIGS)))
def test_retry_schedule_equal(seed, config):
    kw = RETRY_CONFIGS[config]
    ours = port_res.RetryPolicy(rng=random.Random(seed), **kw)
    theirs = jax_res.RetryPolicy(rng=random.Random(seed), **kw)
    assert [ours.backoff_s(k) for k in range(12)] == [theirs.backoff_s(k) for k in range(12)]
    for flags in [(True, True, False), (False, True, True), (True, False, True)]:
        gate = dict(zip(("retry_connect", "retry_transient", "retry_timeouts"), flags))
        a = port_res.RetryPolicy(**gate)
        b = jax_res.RetryPolicy(**gate)
        for domain in ("connect", "transient", "timeout", "fatal", "shed", "invalid"):
            for idem in (True, False):
                assert a.retries_domain(domain, idem) == b.retries_domain(domain, idem)


def test_domain_constants_and_status_sets_equal():
    for name in ("CONNECT", "TRANSIENT", "TIMEOUT", "FATAL", "SHED", "INVALID",
                 "RETRYABLE_HTTP_STATUSES"):
        assert getattr(port_res, name) == getattr(jax_res, name)


def _run_breaker(res, events, seed):
    """Drive a breaker through ``events`` under an injected clock; the
    trace of states, transitions and fast-fails it produced."""
    now = [0.0]
    breaker = res.CircuitBreaker(failure_threshold=0.5, window=6, min_calls=4,
                                 recovery_time_s=2.0, half_open_max_probes=2,
                                 clock=lambda: now[0])
    transitions = []
    breaker.on_transition = transitions.append
    trace = []
    for kind, arg in events:
        if kind == "advance":
            now[0] += arg
        elif kind == "allow":
            try:
                breaker.allow()
                trace.append(("admitted",))
            except res.CircuitOpenError as e:
                trace.append(("fast_fail", e.status(), round(e.retry_after_s, 9)))
        elif kind == "record":
            breaker.record(arg)
        elif kind == "abort":
            breaker.abort_probe()
        elif kind == "peek":
            trace.append(("would_admit", breaker.would_admit()))
        trace.append(("state", breaker.state))
    return trace, transitions


@pytest.mark.parametrize("seed", range(8))
def test_breaker_transitions_equal(seed):
    rng = random.Random(seed)
    events = []
    for _ in range(200):
        kind = rng.choice(["allow", "record", "record", "advance", "abort", "peek"])
        arg = None
        if kind == "record":
            arg = rng.random() < 0.45
        elif kind == "advance":
            arg = rng.choice([0.1, 0.5, 1.0, 2.5])
        events.append((kind, arg))
    ours = _run_breaker(port_res, events, seed)
    theirs = _run_breaker(jax_res, events, seed)
    assert ours == theirs
    assert {"open", "half_open", "closed"} & set(ours[1])


def _synthetic_faults(utils, res):
    exc = utils.InferenceServerException

    def wrapped(cause, **kw):
        try:
            raise cause
        except Exception as e:
            try:
                raise exc("connection error: x", **kw) from e
            except exc as out:
                return out

    class NewConnectionError(Exception):
        pass

    class ConnectTimeoutError(Exception):
        pass

    return [
        wrapped(NewConnectionError()), wrapped(ConnectTimeoutError()),
        wrapped(ConnectionRefusedError()), wrapped(ConnectionResetError()),
        wrapped(BrokenPipeError()), wrapped(TimeoutError()),
        exc("x", status="503"), exc("x", status="429"), exc("x", status="408"),
        exc("x", status="502"), exc("x", status="504"), exc("x", status="500"),
        exc("Deadline Exceeded", status="499"),
        exc("x", status="StatusCode.UNAVAILABLE"),
        exc("x", status="StatusCode.RESOURCE_EXHAUSTED"),
        exc("failed to connect to all addresses", status="StatusCode.UNAVAILABLE"),
        exc("DNS resolution failed", status="StatusCode.UNAVAILABLE"),
        exc("x", status="StatusCode.DEADLINE_EXCEEDED"),
        exc("x", status="StatusCode.INVALID_ARGUMENT"),
        exc("malformed generate_stream event"), exc("x", status="400"),
        exc("shed", status="ADMISSION_REJECTED"),
        exc("lie", status="INTEGRITY_VIOLATION"),
        res.CircuitOpenError(),
    ]


def test_classify_fault_synthetic_equal():
    ours = [port_res.classify_fault(e) for e in _synthetic_faults(port_utils, port_res)]
    theirs = [jax_res.classify_fault(e) for e in _synthetic_faults(jax_utils, jax_res)]
    assert ours == theirs
    assert set(ours) == {"connect", "transient", "timeout", "fatal", "shed", "invalid"}


# -- live failures: the same domain on either package -------------------------
FAULTS = {
    "reset_at_accept": dict(kind="reset", after_bytes=0),
    "reset_mid_request": dict(kind="reset"),  # after MID_BYTES[transport]
    "blackhole": dict(kind="blackhole"),
}


def _live_failure(pkg, transport, url, timeout=0.5):
    """(domain, status) of one failed infer from the ``pkg`` client."""
    _, inputs = _inputs(PKG[pkg][transport])
    with _client(pkg, transport, url) as client:
        with pytest.raises(PKG[pkg]["utils"].InferenceServerException) as err:
            client.infer("simple", inputs, client_timeout=timeout)
    return PKG[pkg]["res"].classify_fault(err.value), err.value.status()


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("proxy_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_classify_live_failure_equal(servers, transport, server_pkg, proxy_pkg, fault):
    server = servers[(transport, server_pkg)]
    testing = PKG[proxy_pkg]["testing"]
    kw = dict(FAULTS[fault])
    if fault == "reset_mid_request":
        kw["after_bytes"] = MID_BYTES[transport]
    seen = {}
    for pkg in ("port", "jax"):
        # a reset the proxy did not deliver within the deadline (a stall
        # under load) is not the failure under test: measured again, at
        # most three times
        for _ in range(3):
            with testing.ChaosProxy("127.0.0.1", server.port) as proxy:
                proxy.fault = testing.Fault(**kw)
                seen[pkg] = _live_failure(pkg, transport, proxy.url,
                                          0.5 if fault == "blackhole" else 5.0)
            if fault == "blackhole" or seen[pkg][0] != "timeout":
                break
    assert seen["port"] == seen["jax"]
    if fault == "blackhole" and transport == "http":
        # over GRPC the handshake never completes: a connect-domain failure
        assert seen["port"][0] == "timeout"


@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_classify_refused_equal(transport):
    url = f"127.0.0.1:{_free_port()}"
    seen = {pkg: _live_failure(pkg, transport, url) for pkg in ("port", "jax")}
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == "connect"


# -- retries, idempotency, sequences ------------------------------------------
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_midrequest_reset_retried_for_idempotent_only(servers, cores, transport, server_pkg):
    """A reset mid-request is retried for a plain infer; a sequence infer
    makes one attempt and raises — on either package's client, with the
    same policy statistics."""
    server = servers[(transport, server_pkg)]
    seen = {}
    for pkg in ("port", "jax"):
        mod = PKG[pkg][transport]
        expected, inputs = _inputs(mod)
        stats = []
        for sequence_id in (0, 77):
            # a fresh proxy and client each: the fault applies to connections
            # accepted while it is set
            with port_testing.ChaosProxy("127.0.0.1", server.port) as proxy:
                proxy.fault = port_testing.Fault(
                    "reset", after_bytes=MID_BYTES[transport], limit=1)
                policy = _policy(pkg)
                with _client(pkg, transport, proxy.url) as client:
                    client.configure_resilience(policy)
                    if sequence_id:
                        with pytest.raises(PKG[pkg]["utils"].InferenceServerException):
                            client.infer("simple", inputs, sequence_id=sequence_id,
                                         sequence_start=True, client_timeout=CALL_S)
                    else:
                        result = client.infer("simple", inputs, client_timeout=CALL_S)
                        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), expected)
                stats.append(policy.stats.as_dict())
        idem, seq = stats
        # the retry count of a recovered call rides on redial timing: held
        # as "retried", the sequence's single attempt exactly
        seen[pkg] = (idem["calls"], idem["retries"] >= 1, seq)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == (1, True, {"calls": 1, "attempts": 1, "retries": 0, "fast_fails": 0})


def test_engine_never_resends_a_sequence_on_transient():
    for res, utils in ((port_res, port_utils), (jax_res, jax_utils)):
        policy = res.ResiliencePolicy(retry=res.RetryPolicy(
            max_attempts=4, initial_backoff_s=0.0, rng=random.Random(1)))
        attempts = []

        def reset_op():
            attempts.append(1)
            try:
                raise ConnectionResetError("peer reset")
            except ConnectionResetError as e:
                raise utils.InferenceServerException("connection error: reset") from e

        with pytest.raises(utils.InferenceServerException):
            policy.execute(reset_op, idempotent=False)
        assert len(attempts) == 1
        attempts.clear()
        with pytest.raises(utils.InferenceServerException):
            policy.execute(reset_op, idempotent=True)
        assert len(attempts) == 4


def _stream_reconnect(client_pkg, server, core):
    """The JAX suite's reconnect scenario on the sync GRPC client: A answered,
    B (sequence) and D (idempotent) in flight when the stream dies, C after
    the reconnect. Returns (event, ids of the responses, executions)."""
    mod = PKG[client_pkg]["grpc"]
    events: "queue.Queue" = queue.Queue()
    before = _success_count(core)
    with port_testing.ChaosProxy("127.0.0.1", server.port) as proxy:
        with _client(client_pkg, "grpc", proxy.url) as client:
            client.configure_resilience(_policy(client_pkg))
            client.start_stream(lambda r, e: events.put((r, e)), auto_reconnect=True)
            _, inputs = _inputs(mod)
            ids = []
            client.async_stream_infer("simple", inputs, request_id="req-a")
            result, error = events.get(timeout=WAIT_S)
            assert error is None
            ids.append(result.get_response()["id"])
            proxy.pause_forwarding = True
            client.async_stream_infer("simple", inputs, request_id="seq-b",
                                      sequence_id=9001, sequence_start=True)
            client.async_stream_infer("simple", inputs, request_id="idem-d")
            time.sleep(0.2)  # both requests on the wire
            proxy.reset_active()
            proxy.pause_forwarding = False
            event, error = events.get(timeout=WAIT_S)
            assert error is None, f"stream died instead of reconnecting: {error}"
            result, error = events.get(timeout=WAIT_S)
            assert error is None
            ids.append(result.get_response()["id"])
            client.async_stream_infer("simple", inputs, request_id="req-c")
            result, error = events.get(timeout=WAIT_S)
            assert error is None
            ids.append(result.get_response()["id"])
            client.stop_stream()
    deadline = time.monotonic() + WAIT_S
    while _success_count(core) - before < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    return event, ids, _success_count(core) - before


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_stream_auto_reconnect_abandons_sequences(servers, cores, server_pkg):
    server, core = servers[("grpc", server_pkg)], cores[server_pkg]
    ours = _stream_reconnect("port", server, core)
    theirs = _stream_reconnect("jax", server, core)
    event, ids, executed = ours
    assert isinstance(event, port_res.StreamReconnected), event
    assert event.abandoned_request_ids == ["seq-b"]
    assert event.resent_request_ids == ["idem-d"]
    assert ids == ["req-a", "idem-d", "req-c"]
    assert executed == 3  # B never ran: A, D and C exactly once each
    assert (ours[1], ours[2], event.abandoned_request_ids, event.resent_request_ids) == (
        theirs[1], theirs[2], theirs[0].abandoned_request_ids,
        theirs[0].resent_request_ids)


def test_stream_auto_reconnect_needs_a_policy(servers):
    msgs = []
    for pkg in ("port", "jax"):
        with _client(pkg, "grpc", servers[("grpc", "port")].url) as client:
            with pytest.raises(PKG[pkg]["utils"].InferenceServerException) as err:
                client.start_stream(lambda r, e: None, auto_reconnect=True)
            msgs.append(err.value.message())
    assert msgs[0] == msgs[1]


# a stream whose proxied connection was reset and which has heard nothing
# by then never will: under load the reset can fail to reach the client, the
# proxy's pumps gone and the client's reader still waiting on the dead call.
# Both packages' clients stall alike, behind either package's proxy: beside
# 10 busy processes, 3 of 480 runs stalled with each client, 4 of 660
# behind the port's proxy and 2 of 300 behind the JAX package's
STALL_S = 8.0


def _stream_give_up(pkg, port):
    """(events seen, fault domain) of a reconnecting stream whose endpoint
    goes away for good; None when the reset never reached the stream.

    New connections are held (``blackhole``) and reset only once the
    stream has reported its reconnect: a reconnected call that failed at
    once could report its failure before the reconnecting thread counted
    the attempt, and so be counted a first failure again (both packages'
    ``_ReconnectingStream`` read the attempt count and the live call there
    without ordering), which made one client report two reconnects where
    the other reported one."""
    events: "queue.Queue" = queue.Queue()
    with port_testing.ChaosProxy("127.0.0.1", port) as proxy:
        with _client(pkg, "grpc", proxy.url) as client:
            client.configure_resilience(_policy(pkg, max_attempts=2))
            client.start_stream(lambda r, e: events.put((r, e)), auto_reconnect=True)
            _, inputs = _inputs(PKG[pkg]["grpc"])
            client.async_stream_infer("simple", inputs, request_id="a")
            assert events.get(timeout=WAIT_S)[1] is None
            proxy.fault = port_testing.Fault("blackhole")
            proxy.reset_active()
            seen = []
            while True:
                try:
                    result, error = events.get(timeout=STALL_S)
                except queue.Empty:
                    client.stop_stream(cancel_requests=True)
                    return None
                seen.append(type(result).__name__ if error is None else "error")
                if error is not None:
                    client.stop_stream()
                    return seen, PKG[pkg]["res"].classify_fault(error)
                proxy.reset_active()  # the reconnect is counted: now its call fails


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_stream_gives_up_after_max_attempts(servers, server_pkg):
    """With the endpoint gone for good the stream reports one terminal
    error after the policy's attempts, on both clients alike. A run whose
    reset never reached the stream is measured again, at most three times."""
    outcomes = {}
    for pkg in ("port", "jax"):
        for _ in range(3):
            outcomes[pkg] = _stream_give_up(pkg, servers[("grpc", server_pkg)].port)
            if outcomes[pkg] is not None:
                break
        assert outcomes[pkg] is not None, f"{pkg}: the reset never reached the stream"
    assert outcomes["port"] == outcomes["jax"]


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("transport", ["http_aio", "grpc_aio"])
def test_aio_retries_midrequest_reset(servers, transport, server_pkg):
    wire = transport.split("_")[0]
    server = servers[(wire, server_pkg)]
    seen = {}
    for pkg in ("port", "jax"):
        mod = PKG[pkg][transport]
        expected, inputs = _inputs(mod)
        policy = _policy(pkg)

        async def run():
            kw = {"channel_args": FAST_REDIAL} if wire == "grpc" else {}
            async with mod.InferenceServerClient(proxy.url, **kw) as client:
                client.configure_resilience(policy)
                return await client.infer("simple", inputs, client_timeout=CALL_S)

        with port_testing.ChaosProxy("127.0.0.1", server.port) as proxy:
            proxy.fault = port_testing.Fault("reset", after_bytes=MID_BYTES[wire], limit=1)
            result = asyncio.run(asyncio.wait_for(run(), WAIT_S))
        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), expected)
        stats = policy.stats.as_dict()
        seen[pkg] = (stats["calls"], stats["retries"] >= 1, stats["fast_fails"])
    assert seen["port"] == seen["jax"] == (1, True, 0)


@pytest.mark.parametrize("transport", ["http_aio", "grpc_aio"])
def test_aio_retry_span_events(servers, transport):
    """The retry events and attempt phases on a retried aio span equal the
    JAX aio client's for the same fault."""
    from client_tpu.observe import Telemetry as JaxTelemetry
    from client_tpu_torch.observe import Telemetry as PortTelemetry

    wire = transport.split("_")[0]
    shapes = {}
    for pkg, tel_cls in (("port", PortTelemetry), ("jax", JaxTelemetry)):
        mod = PKG[pkg][transport]
        _, inputs = _inputs(mod)
        tel = tel_cls(rng=random.Random(3))
        policy = _policy(pkg)

        async def run():
            kw = {"channel_args": FAST_REDIAL} if wire == "grpc" else {}
            async with mod.InferenceServerClient(proxy.url, **kw) as client:
                client.configure_resilience(policy)
                client.configure_telemetry(tel)
                return await client.infer("simple", inputs, client_timeout=CALL_S)

        with port_testing.ChaosProxy("127.0.0.1", servers[(wire, "port")].port) as proxy:
            proxy.fault = port_testing.Fault("reset", after_bytes=MID_BYTES[wire], limit=1)
            asyncio.run(asyncio.wait_for(run(), WAIT_S))
        [trace] = tel.recent_traces()
        # the names, not their counts: a stalled attempt adds a retry
        phases = {p["name"] for p in trace["phases"]}
        events = {e["name"] for e in trace["events"]}
        shapes[pkg] = (phases, events)
    assert shapes["port"] == shapes["jax"]
    phases, events = shapes["port"]
    assert {"serialize", "attempt", "ttfb", "deserialize"} <= phases and events == {"retry"}


# -- breaker on a live endpoint ----------------------------------------------
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_breaker_opens_fast_fails_and_probes_once(servers, transport):
    """Under a blackhole the breaker opens, fast-fails without touching the
    socket, and after the recovery window admits one half-open probe."""
    seen = {}
    for pkg in ("port", "jax"):
        res = PKG[pkg]["res"]
        now = [0.0]
        breaker = res.CircuitBreaker(failure_threshold=0.5, window=4, min_calls=4,
                                     recovery_time_s=5.0, clock=lambda: now[0])
        transitions = []
        breaker.on_transition = transitions.append
        policy = res.ResiliencePolicy(retry=None, breaker=breaker)
        with port_testing.ChaosProxy("127.0.0.1", servers[(transport, "port")].port) as proxy:
            proxy.fault = port_testing.Fault("blackhole")
            _, inputs = _inputs(PKG[pkg][transport])
            with _client(pkg, transport, proxy.url) as client:
                client.configure_resilience(policy)
                for _ in range(4):
                    with pytest.raises(PKG[pkg]["utils"].InferenceServerException):
                        client.infer("simple", inputs, client_timeout=0.3)
                assert breaker.state == "open"
                conns = proxy.stats["connections"]
                with pytest.raises(res.CircuitOpenError):
                    client.infer("simple", inputs, client_timeout=0.3)
                assert proxy.stats["connections"] == conns
            proxy.heal()
            proxy.reset_active()
            now[0] += 6.0
            # the probe, on a fresh channel (a GRPC channel still holds the
            # blackholed connection attempt)
            with _client(pkg, transport, proxy.url) as client:
                client.configure_resilience(policy)
                client.infer("simple", inputs, client_timeout=CALL_S)
                assert breaker.state == "closed"
        seen[pkg] = (transitions, policy.stats.as_dict())
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == ["open", "half_open", "closed"]


# -- the legacy knob and health probes ----------------------------------------
def test_max_retries_is_connect_only():
    url = f"127.0.0.1:{_free_port()}"
    seen = {}
    for pkg in ("port", "jax"):
        mod = PKG[pkg]["http"]
        _, inputs = _inputs(mod)
        with mod.InferenceServerClient(url, max_retries=2) as client:
            with pytest.raises(PKG[pkg]["utils"].InferenceServerException) as err:
                client.infer("simple", inputs, client_timeout=CALL_S)
            legacy = client._legacy_policy
            seen[pkg] = (legacy.stats.as_dict(), legacy.retry.max_attempts,
                         legacy.retry.retry_transient, legacy.retry_http_statuses,
                         PKG[pkg]["res"].classify_fault(err.value))
        with mod.InferenceServerClient(url) as client:
            assert client._legacy_policy is None
    assert seen["port"] == seen["jax"]
    assert seen["port"][0]["attempts"] == 3


@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_probe_health(servers, transport):
    dead = f"127.0.0.1:{_free_port()}"
    seen = {}
    for pkg in ("port", "jax"):
        res = PKG[pkg]["res"]
        with _client(pkg, transport, dead) as client:
            assert client.is_server_live(probe=True, client_timeout=CALL_S) is False
            assert client.is_server_ready(probe=True, client_timeout=CALL_S) is False
            with pytest.raises(PKG[pkg]["utils"].InferenceServerException) as err:
                client.is_server_live(client_timeout=CALL_S)
        # an open breaker does not answer for a probe: it bypasses the policy
        now = [0.0]
        breaker = res.CircuitBreaker(min_calls=1, window=1, clock=lambda: now[0])
        breaker.record(False)
        with _client(pkg, transport, servers[(transport, "port")].url) as client:
            client.configure_resilience(res.ResiliencePolicy(breaker=breaker))
            with pytest.raises(res.CircuitOpenError):
                client.is_server_live(client_timeout=CALL_S)
            assert client.is_server_live(probe=True, client_timeout=CALL_S) is True
        seen[pkg] = (res.classify_fault(err.value), err.value.status(), breaker.state)
    assert seen["port"] == seen["jax"]
