"""The port's flight recorder against the JAX package's.

The same recorded timelines — the same layer notes, span phases, stream
marks, errors and durations, under the same injected clock and the same
seeded rngs — give the same retained records, the same ``stats()``
snapshot, the same anomalies, tail-divergence verdict, Chrome trace and
JSONL dump, and the same flight gauges in the Prometheus text. Live: a
flapping endpoint's failures are each retained once, on either package's
client.
"""

import random
import signal
import threading

import numpy as np
import pytest

import client_tpu.flight as jax_flight
import client_tpu.http as jax_http
import client_tpu.observe as jax_observe
import client_tpu.resilience as jax_res
import client_tpu.utils as jax_utils
import client_tpu_torch.flight as port_flight
import client_tpu_torch.http as port_http
import client_tpu_torch.observe as port_observe
import client_tpu_torch.resilience as port_res
import client_tpu_torch.utils as port_utils
from client_tpu.models import simple as jax_simple
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import AddSubModel
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.testing import ChaosProxy, Fault

TEST_LIMIT_S = 60

PKGS = {
    "port": (port_flight, port_observe, port_res, port_utils),
    "jax": (jax_flight, jax_observe, jax_res, jax_utils),
}


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test ends within TEST_LIMIT_S or fails (SIGALRM, main thread).
    The other slice-5 test files import this fixture (and so run under it)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


class FakeClock:
    """A stand-in for the ``time`` module: every read advances the clock by
    ``step_ns``, and ``advance`` moves it on by a request's duration."""

    def __init__(self, step_ns: int = 1_000):
        self.ns = 10**12
        self.step_ns = step_ns

    def perf_counter_ns(self) -> int:
        self.ns += self.step_ns
        return self.ns

    def monotonic_ns(self) -> int:
        return self.perf_counter_ns()

    def perf_counter(self) -> float:
        return self.perf_counter_ns() * 1e-9

    def monotonic(self) -> float:
        return self.perf_counter()

    def time(self) -> float:
        return 1.7e9 + self.ns * 1e-9

    def time_ns(self) -> int:
        return int(1.7e18) + self.ns

    def sleep(self, seconds: float) -> None:
        self.ns += int(seconds * 1e9)

    def advance(self, ms: float) -> None:
        self.ns += int(ms * 1e6)


def _record(pkg, scenario, monkeypatch):
    """Run ``scenario`` on ``pkg``'s modules under a fresh fake clock and
    return everything the recorder can show about it."""
    flight, observe, res, utils = PKGS[pkg]
    clock = FakeClock()
    monkeypatch.setattr(flight, "time", clock)
    monkeypatch.setattr(observe, "time", clock)
    rec, tel = scenario(flight, observe, res, utils, clock)
    snapshot = {
        "retained": [t.as_dict() for t in rec.retained()],
        "stats": rec.stats(),
        "anomalies": rec.last_anomalies(),
        "divergence": rec.tail_divergence(),
        "chrome": rec.to_chrome_trace(),
        "jsonl": rec.dump_jsonl(),
    }
    if tel is not None:
        snapshot["prometheus"] = tel.registry.prometheus_text()
    return snapshot


def _verdicts(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(baseline_ratio=0.0, slo_ms=50.0,
                                threshold_min_samples=10**9, rng=random.Random(1))
    s = rec.begin("pool", "m")
    rec.commit(s, error=RuntimeError("boom"))
    s = rec.begin("pool", "m")
    rec.commit(s, error=utils.InferenceServerException("shed", status="ADMISSION_REJECTED"))
    s = rec.begin("pool", "m")
    rec.commit(s, error=res.CircuitOpenError())
    s = rec.begin("pool", "m")
    clock.advance(60.0)
    rec.commit(s)  # over the SLO
    s = rec.begin("pool", "m")
    rec.commit(s)  # fast and healthy: dropped
    s = rec.begin("pool", "m")
    rec.commit(s, error=utils.InferenceServerException("x", status="503"))
    assert rec.commit(s) is None  # a double commit is a counted no-op
    return rec, None


def _slow_tail(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(baseline_ratio=0.0, slow_quantile=0.9,
                                threshold_min_samples=64, rng=random.Random(2))
    durations = random.Random(3)
    for _ in range(200):
        s = rec.begin("pool", "m")
        flight.note("pool", "route", url="a:1")
        clock.advance(durations.uniform(0.5, 2.0))
        rec.commit(s)
    s = rec.begin("pool", "m")
    clock.advance(25.0)
    rec.commit(s)
    return rec, None


def _baseline_and_ring(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(capacity=8, baseline_ratio=0.3, rng=random.Random(4))
    for i in range(40):
        s = rec.begin("http", f"m{i % 3}")
        flight.note("cache", "lookup", hit=bool(i % 2))
        if i % 7 == 0:
            rec.commit(s, error=RuntimeError(str(i)))
        else:
            rec.commit(s)
    rec.mark("watch", "alert", state="firing")
    return rec, None


def _truncation(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(baseline_ratio=1.0, max_events=8, rng=random.Random(5))
    s = rec.begin("pool", "m")
    assert rec.begin("batch", "m") is None  # a nested layer only notes
    for i in range(50):
        flight.note("pool", "route", attempt=i)
    rec.commit(s)
    return rec, None


def _telemetry_spans(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(baseline_ratio=0.5, rng=random.Random(6))
    tel = observe.Telemetry(flight=rec, rng=random.Random(7))
    for i in range(12):
        span = tel.begin("http", "simple")
        rec.span_begin(span, "127.0.0.1:1")
        t = clock.perf_counter_ns()
        span.phase("serialize", span.start_ns, t)
        clock.advance(0.4 + 0.1 * i)
        span.phase("ttfb", t, clock.perf_counter_ns())
        if i % 4 == 3:
            span.event("retry", attempt=0, backoff_s=0.05, error="InferenceServerException")
        error = None
        if i % 5 == 4:
            error = utils.InferenceServerException("reset", status="503")
        tel.finish(span, error=error)
    return rec, tel


def _streams(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(baseline_ratio=0.5, rng=random.Random(8))
    tel = observe.Telemetry(flight=rec, rng=random.Random(9))
    for i in range(6):
        span = tel.begin_stream("grpc", "decoder_lm", "stream")
        for _ in range(4):
            clock.advance(1.5)
            span.mark()
        if i == 2:
            span.reconnect(abandoned=1, resent=2)
            clock.advance(3.0)
            span.mark()
        if i == 4:
            tel.finish_stream(span, error=utils.InferenceServerException(
                "gone", status="StatusCode.UNAVAILABLE"))
        elif i == 5:
            tel.finish_stream(span, abandoned=True)
        else:
            tel.finish_stream(span)
    return rec, tel


def _divergence(flight, observe, res, utils, clock):
    rec = flight.FlightRecorder(baseline_ratio=1.0, slow_quantile=0.5,
                                threshold_min_samples=8, rng=random.Random(10))
    for i in range(40):
        bad = i % 2 == 0
        s = rec.begin("pool", "m")
        url = "bad:1" if bad else "good:2"
        flight.note("pool", "route", url=url)
        clock.advance(0.1)
        flight.note("span", "begin", url=url)
        clock.advance(50.0 if bad else 2.0)
        rec.commit(s)
    return rec, None


SCENARIOS = {
    "verdicts": _verdicts,
    "slow_tail": _slow_tail,
    "baseline_and_ring": _baseline_and_ring,
    "truncation": _truncation,
    "telemetry_spans": _telemetry_spans,
    "streams": _streams,
    "divergence": _divergence,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_timelines_same_records(name, monkeypatch):
    ours = _record("port", SCENARIOS[name], monkeypatch)
    theirs = _record("jax", SCENARIOS[name], monkeypatch)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key] == theirs[key], key
    assert ours["stats"]["requests"] + ours["stats"]["retained"]["mark"] > 0


def test_scenarios_reach_every_verdict(monkeypatch):
    verdicts = set()
    for scenario in SCENARIOS.values():
        for t in _record("port", scenario, monkeypatch)["retained"]:
            verdicts.add(t["verdict"])
    assert verdicts == {"error", "shed", "slo_breach", "slow", "disrupted",
                        "baseline", "mark"}


def test_note_without_scratch_is_noop():
    for flight in (port_flight, jax_flight):
        assert flight.active_scratch() is None
        flight.note("pool", "route", url="u")
        assert flight.active_scratch() is None


def test_verdict_names_and_constants_equal():
    assert port_flight.FLIGHT_VERDICTS == jax_flight.FLIGHT_VERDICTS


# -- live: the failures of a flapping endpoint are each retained --------------
@pytest.fixture(scope="module")
def servers():
    started = {
        "port": HttpInferenceServer(ServerCore([AddSubModel(device="cpu")],
                                               device="cpu")).start(),
        "jax": JaxHttpServer(JaxCore([jax_simple.AddSubModel()])).start(),
    }
    yield started
    for server in started.values():
        server.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_flapping_failures_retained_once_each(servers, server_pkg):
    seen = {}
    for pkg, http in (("port", port_http), ("jax", jax_http)):
        flight, observe, _, utils = PKGS[pkg]
        rec = flight.FlightRecorder(baseline_ratio=0.0, rng=random.Random(11))
        tel = observe.Telemetry(flight=rec, rng=random.Random(12))
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        failures, trace_ids = 0, []
        with ChaosProxy("127.0.0.1", servers[server_pkg].port) as proxy:
            proxy.fault = Fault("flap", every=2)
            for _ in range(6):
                # a client a request: each one opens a connection of its own
                with http.InferenceServerClient(proxy.url) as client:
                    client.configure_telemetry(tel)
                    inputs = [http.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                              for n in ("INPUT0", "INPUT1")]
                    try:
                        client.infer("simple", inputs, client_timeout=10.0)
                    except utils.InferenceServerException:
                        failures += 1
                        trace_ids.append(tel.recent_traces()[-1]["trace_id"])
        stats = rec.stats()
        assert stats["retained"]["error"] == failures
        assert [rec.find(t).verdict for t in trace_ids] == ["error"] * failures
        seen[pkg] = (failures, stats["retained"], stats["requests"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 3
