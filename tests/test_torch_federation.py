"""``client_tpu_torch.federation`` against ``client_tpu.federation``.

Every scenario runs twice, once on each package's federation over that
package's pools of stub clients (``tests/test_federation.py``'s plumbing,
built on each package's client base class), and what each run observes is
held equal: the values the caller got, the calls each stub saw, the serve
order, the spills and their reasons, the typed events (their class and
fields), ``federation_stats()``, ``shadow_status()`` / ``canary_status()``
and the ``client_tpu_federation_*`` lines of the telemetry's Prometheus
text. The scenarios: home, saturated (admission sheds), down, a breaker
healed through its half-open probe, sequence pinning and abandonment,
stream pinning, shadow matched / diverged / compare off / bounded, canary
rollback and fallback with 0 caller errors, the flight timeline, sync and
aio. Then live: both packages' ``FederatedClient`` over both packages'
servers behind ``ChaosProxy`` (the 2x2 matrix), a blackholed home cell
spilling with 0 errors and healing, and ``perf.py``'s cells parser, which
moved here.
"""

import asyncio
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import client_tpu._base as jax_base
import client_tpu.admission as jax_admission
import client_tpu.federation as jax_fed
import client_tpu.flight as jax_flight
import client_tpu.http as jax_http
import client_tpu.observe as jax_observe
import client_tpu.pool as jax_pool
import client_tpu.resilience as jax_resilience
import client_tpu.testing as jax_testing
import client_tpu.utils as jax_utils
import client_tpu_torch._base as port_base
import client_tpu_torch.admission as port_admission
import client_tpu_torch.federation as port_fed
import client_tpu_torch.flight as port_flight
import client_tpu_torch.http as port_http
import client_tpu_torch.observe as port_observe
import client_tpu_torch.perf as port_perf
import client_tpu_torch.pool as port_pool
import client_tpu_torch.resilience as port_resilience
import client_tpu_torch.testing as port_testing
import client_tpu_torch.utils as port_utils
from client_tpu.models.simple import AddSubModel as JaxAddSub
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import AddSubModel
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PKGS = {
    "port": SimpleNamespace(
        name="port", fed=port_fed, pool=port_pool, base=port_base, adm=port_admission,
        observe=port_observe, resilience=port_resilience, flight=port_flight,
        exc=port_utils.InferenceServerException, http=port_http, testing=port_testing),
    "jax": SimpleNamespace(
        name="jax", fed=jax_fed, pool=jax_pool, base=jax_base, adm=jax_admission,
        observe=jax_observe, resilience=jax_resilience, flight=jax_flight,
        exc=jax_utils.InferenceServerException, http=jax_http, testing=jax_testing),
}


def seeded():
    return random.Random(0xFEDE)


# -- stub plumbing, one set per package ----------------------------------------
def _connect_error(P):
    try:
        raise ConnectionRefusedError("refused")
    except ConnectionRefusedError as e:
        raise P.exc("connection error: refused") from e


def _transient_error(P):
    try:
        raise ConnectionResetError("reset")
    except ConnectionResetError as e:
        raise P.exc("connection error: reset") from e


def _shed(P):
    raise P.adm.AdmissionRejected(P.adm.SHED_ENDPOINT_SATURATED, lane="endpoint")


class FakeResult:
    """Quacks like an InferResult for the shadow comparison path."""

    def __init__(self, value, name="OUT"):
        self.value = np.asarray(value)
        self.name = name

    def get_response(self):
        return {"outputs": [{"name": self.name}]}

    def as_numpy(self, name):
        return self.value if name == self.name else None


def _stub_classes(P):
    class StubClient(P.base.InferenceServerClientBase):
        def __init__(self, url, behavior=None):
            super().__init__()
            self.url = url
            self.behavior = behavior or (lambda **kw: "ok")
            self.calls = []

        def infer(self, model_name, inputs=None, **kwargs):
            self.calls.append(dict(kwargs))
            idempotent = kwargs.get("sequence_id", 0) == 0
            op = lambda: self.behavior(**kwargs)  # noqa: E731
            if self._resilience is not None:
                return self._resilience.execute(op, idempotent=idempotent)
            return op()

        def generate_stream(self, model_name, payload=None, **kwargs):
            self.calls.append({"stream": True, **kwargs})
            behavior = self.behavior

            def gen():
                for item in behavior(stream=True, **kwargs):
                    yield item

            return gen()

        def is_server_ready(self, probe=False, client_timeout=None, **kw):
            return True

        def close(self):
            pass

    class AioStubClient(P.base.InferenceServerClientBase):
        def __init__(self, url, behavior=None):
            super().__init__()
            self.url = url
            self.behavior = behavior or (lambda **kw: "ok")
            self.calls = []

        async def infer(self, model_name, inputs=None, **kwargs):
            self.calls.append(dict(kwargs))
            idempotent = kwargs.get("sequence_id", 0) == 0
            op = lambda: self.behavior(**kwargs)  # noqa: E731

            async def aop():
                return op()

            if self._resilience is not None:
                return await self._resilience.execute_async(aop, idempotent=idempotent)
            return op()

        async def is_server_ready(self, probe=False, client_timeout=None, **kw):
            return True

        async def close(self):
            pass

    return StubClient, AioStubClient


def _stub_pool(P, behaviors, aio=False, **kwargs):
    stubs = {}
    stub_cls = _stub_classes(P)[1 if aio else 0]

    def factory(url):
        stubs[url] = stub_cls(url, behaviors[url])
        return stubs[url]

    kwargs.setdefault("health_interval_s", None)
    kwargs.setdefault("rng", seeded())
    cls = P.pool.AioPoolClient if aio else P.pool.PoolClient
    return cls(list(behaviors), client_factory=factory, **kwargs), stubs


def _fed(P, cell_behaviors, aio=False, **fed_kwargs):
    """{cell: {url: behavior}} -> (FederatedClient, {cell: stubs})."""
    pools, stubs = {}, {}
    for name, behaviors in cell_behaviors.items():
        pools[name], stubs[name] = _stub_pool(P, behaviors, aio=aio)
    fed_kwargs.setdefault("rng", seeded())
    cls = P.fed.AioFederatedClient if aio else P.fed.FederatedClient
    return cls(pools, **fed_kwargs), stubs


# -- what a run observes ---------------------------------------------------------
def _event(e):
    """A typed event as (class, fields); a cause as its class and message."""
    fields = []
    for cls in type(e).__mro__:
        for name in getattr(cls, "__slots__", ()):
            value = getattr(e, name)
            if isinstance(value, BaseException):
                value = (type(value).__name__, str(value))
            fields.append((name, value))
    return (type(e).__name__, tuple(sorted(fields)))


def _counters(tel):
    if tel is None:
        return None
    return [line for line in tel.registry.prometheus_text().splitlines()
            if line.startswith("client_tpu_federation")]


def _call(kw):
    """A stub's call kwargs; a timeout is the budget left, so only its presence."""
    return sorted((k, "<timeout>" if k == "client_timeout" else v) for k, v in kw.items())


def _value(v):
    return v.value.tolist() if isinstance(v, FakeResult) else v


def _observed(fed, stubs, events, tel=None, results=()):
    return {
        "results": [_value(r) for r in results],
        "calls": {c: {u: [_call(kw) for kw in s.calls] for u, s in cell.items()}
                  for c, cell in stubs.items()},
        "order": fed.serve_order(),
        "spill_total": fed.spill_total(),
        "events": [_event(e) for e in events],
        "stats": fed.federation_stats(),
        "counters": _counters(tel),
    }


def _both(scenario):
    """The scenario's observations on each package, held equal."""
    seen = {pkg: scenario(P) for pkg, P in PKGS.items()}
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _outcome(fn):
    try:
        return ("ok", _value(fn()))
    except Exception as e:
        return ("raised", type(e).__name__, getattr(e, "status", lambda: None)())


# -- the cells parser (perf.py's --cells and --roles read it) ---------------------
@pytest.mark.parametrize("spec", [
    "a=h1:8000+h2:8000;b=h3:8000", " a = h1 ; b=h2+ h3 ;", "solo=h1",
    "nourls=", "a=h1;a=h2", "", ";;", "=h1", "noeq", "a=+;b=h1",
])
def test_parse_cells_spec_equals_jax_s(spec):
    def parse(fn):
        try:
            return ("ok", fn(spec))
        except Exception as e:
            return (type(e).__name__, str(e))

    assert parse(port_fed.parse_cells_spec) == parse(jax_fed.parse_cells_spec)


@pytest.mark.parametrize("flag", ["cells", "roles"])
def test_perf_reads_the_federation_s_parser(monkeypatch, flag):
    """``--cells`` and ``--roles`` are parsed by ``federation.parse_cells_spec``
    (perf.py keeps no copy), with its messages, before any connection."""
    assert not hasattr(port_perf, "_parse_roles_spec")
    seen = []

    def spy(spec):
        seen.append(spec)
        return parse(spec)

    parse = port_fed.parse_cells_spec
    monkeypatch.setattr(port_fed, "parse_cells_spec", spy)
    with pytest.raises(ValueError) as exc:
        port_perf.PerfRunner("127.0.0.1:1", **{flag: "a=h1;a=h2"})
    assert seen == ["a=h1;a=h2"] and str(exc.value) == "duplicate cell name 'a'"


def test_module_surface_equals_jax_s():
    assert port_fed.__all__ == jax_fed.__all__
    for name in ("SPILL_SATURATED", "SPILL_DOWN", "SPILL_ERROR", "ROLE_SERVE",
                 "ROLE_SHADOW", "ROLE_CANARY"):
        assert getattr(port_fed, name) == getattr(jax_fed, name)
    assert issubclass(port_fed.NoCellAvailableError, port_utils.InferenceServerException)
    assert port_fed.NoCellAvailableError().status() == jax_fed.NoCellAvailableError().status()


@pytest.mark.parametrize("case", ["home_unknown", "shadow_unknown", "shadow_is_home",
                                  "shadow_and_canary", "probe_ratio", "ratio", "pending"])
def test_config_validation_equals_jax_s(case):
    def build(P):
        pool_a, _ = _stub_pool(P, {"a1": lambda **kw: "ok"})
        pool_b, _ = _stub_pool(P, {"b1": lambda **kw: "ok"})
        kw = {"home_unknown": {"home": "nope"},
              "shadow_unknown": {"shadow": "zz"},
              "shadow_is_home": {"home": "b", "shadow": "b"},
              "shadow_and_canary": {"shadow": "b", "canary": "b"},
              "probe_ratio": {"spill_probe_ratio": 0.0}}.get(case, {})
        try:
            if case == "ratio":
                P.fed.ShadowPolicy("b", ratio=0.0)
            elif case == "pending":
                P.fed.ShadowPolicy("b", max_pending=0)
            else:
                if "shadow" in kw:
                    kw["shadow"] = P.fed.ShadowPolicy(kw["shadow"], ratio=1.0)
                if "canary" in kw:
                    kw["canary"] = P.fed.CanaryPolicy(kw["canary"])
                P.fed.FederatedClient({"a": pool_a, "b": pool_b}, **kw).close()
            return "built"
        except ValueError as e:
            return str(e)
        finally:
            pool_a.close()
            pool_b.close()

    assert build(PKGS["port"]) == build(PKGS["jax"]) != "built"


def test_configure_hooks_raise_as_jax_s():
    def run(P):
        fed, _ = _fed(P, {"a": {"a1": lambda **kw: "ok"}, "b": {"b1": lambda **kw: "ok"}})
        try:
            return [_outcome(lambda: fed.configure_resilience(None)),
                    _outcome(lambda: fed.configure_telemetry(None))]
        finally:
            fed.close()

    out = _both(run)
    assert all(o[0] == "raised" for o in out)


# -- locality & spillover --------------------------------------------------------
def test_home_serves_everything():
    def run(P):
        events = []
        tel = P.observe.Telemetry(sample="off")
        fed, stubs = _fed(P, {"a": {"a1": lambda **kw: "from-a"},
                              "b": {"b1": lambda **kw: "from-b"}},
                          home="a", telemetry=tel, on_event=events.append)
        try:
            results = [fed.infer("m", []) for _ in range(20)]
            return _observed(fed, stubs, events, tel, results)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["results"] == ["from-a"] * 20 and seen["spill_total"] == 0
    assert len(seen["calls"]["a"]["a1"]) == 20 and seen["calls"]["b"]["b1"] == []


def test_saturated_home_spills_and_releases():
    """Home sheds every request, then heals: the same spills, the same
    hysteresis, the same counters, in both packages."""
    def run(P):
        home_ok = {"value": False}

        def flappy_home(**kw):
            if not home_ok["value"]:
                _shed(P)
            return "from-a"

        events = []
        tel = P.observe.Telemetry(sample="off")
        fed, stubs = _fed(P, {"a": {"a1": flappy_home}, "b": {"b1": lambda **kw: "from-b"}},
                          home="a", telemetry=tel, on_event=events.append,
                          spill_min_samples=4, shed_window=8, spill_probe_ratio=0.5)
        try:
            results = [fed.infer("m", []) for _ in range(30)]
            engaged = fed.federation_stats()["cells"]["a"]["spill_active"]
            home_ok["value"] = True
            results += [fed.infer("m", []) for _ in range(90)]
            return dict(_observed(fed, stubs, events, tel, results), engaged=engaged)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["engaged"] is True
    assert seen["stats"]["cells"]["a"]["spill_active"] is False
    spills = [e for e in seen["events"] if e[0] == "CellSpill"]
    assert spills and dict(spills[0][1])["reason"] == "saturated"
    assert seen["stats"]["cells"]["b"]["spill_in"] == len(spills)
    assert seen["results"][-10:] == ["from-a"] * 10
    assert any(line.startswith("client_tpu_federation_spill_total") for line in seen["counters"])


def test_down_home_spills_with_reason_down():
    def run(P):
        events = []
        tel = P.observe.Telemetry(sample="off")
        fed, stubs = _fed(P, {"a": {"a1": lambda **kw: _connect_error(P)},
                              "b": {"b1": lambda **kw: "from-b"}},
                          home="a", telemetry=tel, on_event=events.append)
        try:
            results = [fed.infer("m", []) for _ in range(12)]
            return _observed(fed, stubs, events, tel, results)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["results"] == ["from-b"] * 12
    reasons = {dict(e[1])["reason"] for e in seen["events"] if e[0] == "CellSpill"}
    assert reasons == {"down"}


def test_fatal_answers_and_exhaustion_raise_as_jax_s():
    def run(P):
        def fatal(**kw):
            raise P.exc("bad input", status="400")

        out = []
        fed, stubs = _fed(P, {"a": {"a1": fatal}, "b": {"b1": lambda **kw: "from-b"}}, home="a")
        try:
            out.append(_outcome(lambda: fed.infer("m", [])))
            out.append(len(stubs["b"]["b1"].calls))
        finally:
            fed.close()
        fed, _ = _fed(P, {"a": {"a1": lambda **kw: _connect_error(P)},
                          "b": {"b1": lambda **kw: _connect_error(P)}}, home="a")
        try:
            out.append(_outcome(lambda: fed.infer("m", [])))
        finally:
            fed.close()
        return out

    out = _both(run)
    assert out[0][0] == "raised" and out[1] == 0 and out[2][0] == "raised"


def test_breaker_heals_through_its_half_open_probe():
    """A cell breaker opens on connect failures, the home cell comes back,
    and after the recovery time one half-open probe closes the breaker:
    the same transitions, spills and served counts in both packages."""
    def run(P):
        clock = [0.0]
        up = {"value": False}

        def home(**kw):
            if not up["value"]:
                _connect_error(P)
            return "from-a"

        events = []
        tel = P.observe.Telemetry(sample="off")
        fed, stubs = _fed(
            P, {"a": {"a1": home}, "b": {"b1": lambda **kw: "from-b"}}, home="a",
            telemetry=tel, on_event=events.append,
            cell_breaker_factory=lambda: P.resilience.CircuitBreaker(
                min_calls=2, window=4, recovery_time_s=5.0, clock=lambda: clock[0]))
        try:
            results = [fed.infer("m", []) for _ in range(6)]
            opened = fed.federation_stats()["cells"]["a"]["breaker_state"]
            up["value"] = True
            results += [fed.infer("m", []) for _ in range(3)]  # still open: spills
            clock[0] += 6.0
            results += [fed.infer("m", []) for _ in range(5)]  # the probe, then home
            return dict(_observed(fed, stubs, events, tel, results), opened=opened)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["opened"] == "open"
    assert seen["results"] == ["from-b"] * 9 + ["from-a"] * 5
    assert seen["stats"]["cells"]["a"]["served"] == 5
    assert seen["stats"]["cells"]["a"]["spill_out"] == {"down": 9}


# -- sequences and streams ---------------------------------------------------------
def test_sequence_pins_and_is_abandoned_never_re_sent():
    def run(P):
        flaky = {"fail": False}

        def home(**kw):
            if flaky["fail"]:
                _transient_error(P)
            return "a-seq"

        events = []
        tel = P.observe.Telemetry(sample="off")
        fed, stubs = _fed(P, {"a": {"a1": home}, "b": {"b1": lambda **kw: "b-seq"}},
                          home="a", telemetry=tel, on_event=events.append)
        try:
            results = [fed.infer("m", [], sequence_id=7, sequence_start=True),
                       fed.infer("m", [], sequence_id=7)]
            flaky["fail"] = True
            results.append(_outcome(lambda: fed.infer("m", [], sequence_id=7)))
            return _observed(fed, stubs, events, tel, results)
        finally:
            fed.close()

    seen = _both(run)
    abandoned = [dict(e[1]) for e in seen["events"] if e[0] == "CellSequenceAbandoned"]
    assert len(abandoned) == 1 and abandoned[0]["cell"] == "a"
    assert abandoned[0]["sequence_id"] == 7
    assert seen["calls"]["b"]["b1"] == []
    assert seen["stats"]["cells"]["a"]["sequence_abandoned"] == 1


def test_sequence_pin_moves_only_before_established():
    def run(P):
        fed, stubs = _fed(P, {"a": {"a1": lambda **kw: _connect_error(P)},
                              "b": {"b1": lambda **kw: "b-seq"}}, home="a")
        try:
            results = [fed.infer("m", [], sequence_id=9, sequence_start=True),
                       fed.infer("m", [], sequence_id=9),
                       fed.infer("m", [], sequence_id=9, sequence_end=True)]
            return _observed(fed, stubs, [], None, results)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["results"] == ["b-seq"] * 3


def test_sequence_workload_releases_hysteresis():
    def run(P):
        home_ok = {"value": False}

        def flappy_home(**kw):
            if not home_ok["value"]:
                _shed(P)
            return "a-seq"

        fed, stubs = _fed(P, {"a": {"a1": flappy_home}, "b": {"b1": lambda **kw: "b-seq"}},
                          home="a", spill_min_samples=4, shed_window=8, spill_probe_ratio=0.5)
        try:
            results = [fed.infer("m", []) for _ in range(12)]
            home_ok["value"] = True
            results += [fed.infer("m", [], sequence_id=sid, sequence_start=True,
                                  sequence_end=True) for sid in range(1, 90)]
            return _observed(fed, stubs, [], None, results)
        finally:
            fed.close()

    assert _both(run)["stats"]["cells"]["a"]["spill_active"] is False


def test_stream_pins_after_first_event():
    def run(P):
        def home_stream(stream=False, **kw):
            raise P.exc("boom 503", status="503")

        def half_stream(stream=False, **kw):
            def gen():
                yield "e1"
                _transient_error(P)
            return gen()

        events = []
        fed, stubs = _fed(P, {"a": {"a1": home_stream},
                              "b": {"b1": lambda stream=False, **kw: iter(["e1", "e2", "e3"])}},
                          home="a", on_event=events.append)
        try:
            out = list(fed.generate_stream("m", {"x": 1}))
            first = _observed(fed, stubs, events, None, out)
        finally:
            fed.close()
        fed, stubs = _fed(P, {"a": {"a1": half_stream},
                              "b": {"b1": lambda stream=False, **kw: iter(["never"])}}, home="a")
        try:
            it = fed.generate_stream("m", {"x": 1})
            got = [next(it), _outcome(lambda: list(it))]
            return first, _observed(fed, stubs, [], None, got)
        finally:
            fed.close()

    first, second = _both(run)
    assert first["results"] == ["e1", "e2", "e3"]
    assert [dict(e[1])["target"] for e in first["events"] if e[0] == "CellSpill"] == ["b"]
    assert second["results"][0] == "e1" and second["results"][1][0] == "raised"
    assert second["calls"]["b"]["b1"] == []


# -- shadow ---------------------------------------------------------------------
@pytest.mark.parametrize("shadow_value, compare", [([1, 2, 3], True), ([9, 9, 9], True),
                                                    ([2], False)])
def test_shadow_matched_diverged_and_uncompared(shadow_value, compare):
    def run(P):
        events = []
        tel = P.observe.Telemetry(sample="off", flight=True)
        fed, stubs = _fed(P, {"a": {"a1": lambda **kw: FakeResult([1, 2, 3])},
                              "s": {"s1": lambda **kw: FakeResult(shadow_value)}},
                          home="a", telemetry=tel, on_event=events.append,
                          shadow=P.fed.ShadowPolicy("s", ratio=1.0, compare=compare))
        try:
            results = [fed.infer("m", []) for _ in range(5)]
            assert fed.shadow_drain(10.0)
            shadow_lines = [t.verdict for t in tel.flight.retained() if t.op == "shadow"]
            return dict(_observed(fed, stubs, events, tel, results),
                        shadow=fed.shadow_status(), shadow_lines=shadow_lines)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["results"] == [[1, 2, 3]] * 5
    key = "uncompared" if not compare else "matched" if shadow_value == [1, 2, 3] else "diverged"
    assert seen["shadow"][key] == seen["shadow"]["sent"] == 5
    diverged = [e for e in seen["events"] if e[0] == "ShadowDiverged"]
    assert len(diverged) == (5 if key == "diverged" else 0)
    assert seen["shadow_lines"] == (["error"] * 5 if key == "diverged" else [])


def test_shadow_bounded_pending_skips_never_queues():
    def run(P):
        release = threading.Event()

        def stuck_shadow(**kw):
            release.wait(5.0)
            return FakeResult([1])

        fed, _ = _fed(P, {"a": {"a1": lambda **kw: FakeResult([1])}, "s": {"s1": stuck_shadow}},
                      home="a", shadow=P.fed.ShadowPolicy("s", ratio=1.0, max_pending=2))
        try:
            for _ in range(10):
                fed.infer("m", [])
            status = fed.shadow_status()
            return {"pending": status["pending"], "skipped": status["skipped"]}
        finally:
            release.set()
            fed.close()

    seen = _both(run)
    assert seen == {"pending": 2, "skipped": 8}


def test_shadow_never_billed_to_home_admission():
    def run(P):
        ctrl = P.adm.AdmissionController()
        pool_a, stubs_a = _stub_pool(P, {"a1": lambda **kw: FakeResult([1, 2, 3])},
                                     admission=ctrl)
        pool_s, stubs_s = _stub_pool(P, {"s1": lambda **kw: FakeResult([1, 2, 3])})
        fed = P.fed.FederatedClient({"a": pool_a, "s": pool_s}, home="a",
                                    shadow=P.fed.ShadowPolicy("s", ratio=1.0), rng=seeded())
        try:
            for _ in range(8):
                fed.infer("m", [])
            assert fed.shadow_drain(10.0)
            return ctrl.snapshot()["admitted_total"], len(stubs_s["s1"].calls)
        finally:
            fed.close()

    assert _both(run) == (8, 8)


# -- canary ---------------------------------------------------------------------
def test_canary_rolls_back_on_slo_burn_with_no_caller_error():
    def run(P):
        def slow_canary(**kw):
            time.sleep(0.02)
            return "from-canary"

        events = []
        tel = P.observe.Telemetry(sample="off")
        fed, stubs = _fed(P, {"a": {"a1": lambda **kw: "from-a"}, "c": {"c1": slow_canary}},
                          home="a", telemetry=tel, on_event=events.append,
                          canary=P.fed.CanaryPolicy("c", weight=1.0, slo="p95<5ms",
                                                    min_events=5))
        try:
            results = [_outcome(lambda: fed.infer("m", [])) for _ in range(30)]
            rolled = fed.canary_status()
            results += [_outcome(lambda: fed.infer("m", [])) for _ in range(10)]
            fed.canary_arm(0.5)
            return dict(_observed(fed, stubs, events, tel, results), rolled=rolled,
                        rearmed=fed.canary_status())
        finally:
            fed.close()

    seen = _both(run)
    assert all(r[0] == "ok" for r in seen["results"])
    assert seen["rolled"]["rolled_back"] is True and seen["rolled"]["weight"] == 0.0
    rollbacks = [dict(e[1]) for e in seen["events"] if e[0] == "CanaryRolledBack"]
    assert len(rollbacks) == 1 and rollbacks[0]["cell"] == "c" and rollbacks[0]["burn_rate"] > 1
    assert seen["results"][-10:] == [("ok", "from-a")] * 10
    assert seen["rearmed"]["weight"] == 0.5 and seen["rearmed"]["rolled_back"] is False


def test_canary_failure_falls_back_home():
    def run(P):
        events = []
        fed, stubs = _fed(P, {"a": {"a1": lambda **kw: "from-a"},
                              "c": {"c1": lambda **kw: _connect_error(P)}},
                          home="a", on_event=events.append,
                          canary=P.fed.CanaryPolicy("c", weight=1.0, slo="p95<100ms",
                                                    min_events=4))
        try:
            results = [fed.infer("m", []) for _ in range(20)]
            return _observed(fed, stubs, events, None, results)
        finally:
            fed.close()

    seen = _both(run)
    assert seen["results"] == ["from-a"] * 20
    canary = seen["stats"]["canary"]
    assert canary["rolled_back"] is True and canary["fallbacks"] == canary["routed"]


def test_canary_served_responses_never_mirrored_and_slo_specs():
    def run(P):
        fed, stubs = _fed(
            P, {"a": {"a1": lambda **kw: FakeResult([1])},
                "c": {"c1": lambda **kw: FakeResult([1])},
                "s": {"s1": lambda **kw: FakeResult([1])}},
            home="a", shadow=P.fed.ShadowPolicy("s", ratio=1.0),
            canary=P.fed.CanaryPolicy("c", weight=1.0, slo="p95<10s", min_events=1000))
        try:
            for _ in range(10):
                fed.infer("m", [])
            assert fed.shadow_drain(10.0)
            bad = _outcome(lambda: P.fed.CanaryPolicy("c", slo="ttft_p95<100ms").build_slo())
            slo = P.fed.CanaryPolicy("c", slo="p99<50ms").build_slo()
            return (fed.canary_status()["routed"], len(stubs["s"]["s1"].calls),
                    fed.shadow_status()["sent"], bad[0], slo.threshold_ms, slo.objective)
        finally:
            fed.close()

    assert _both(run) == (10, 0, 0, "raised", 50.0, 0.99)


def test_flight_timeline_carries_federation_events():
    def run(P):
        tel = P.observe.Telemetry(sample="off",
                                  flight=P.flight.FlightRecorder(baseline_ratio=1.0))
        fed, _ = _fed(P, {"a": {"a1": lambda **kw: _shed(P)}, "b": {"b1": lambda **kw: "from-b"}},
                      home="a", telemetry=tel)
        try:
            assert fed.infer("m", []) == "from-b"
            return [(layer, event, sorted(attrs.items())) for t in tel.flight.retained()
                    for _, layer, event, attrs in t.events if layer == "federation"]
        finally:
            fed.close()

    events = _both(run)
    assert ("route" in [e[1] for e in events]) and ("cell_spill" in [e[1] for e in events])


# -- asyncio ----------------------------------------------------------------------
def test_aio_spill_canary_and_shadow():
    def run(P):
        async def go():
            def slow_canary(**kw):
                time.sleep(0.02)
                return "from-canary"

            out = []
            events = []
            fed, stubs = _fed(P, {"a": {"a1": lambda **kw: _shed(P)},
                                  "b": {"b1": lambda **kw: "from-b"}},
                              aio=True, home="a", on_event=events.append)
            try:
                results = [await fed.infer("m", []) for _ in range(10)]
                out.append(_observed(fed, stubs, events, None, results))
            finally:
                await fed.close()
            events = []
            fed, stubs = _fed(P, {"a": {"a1": lambda **kw: "from-a"}, "c": {"c1": slow_canary}},
                              aio=True, home="a", on_event=events.append,
                              canary=P.fed.CanaryPolicy("c", weight=1.0, slo="p95<5ms",
                                                        min_events=5))
            try:
                results = [await fed.infer("m", []) for _ in range(20)]
                out.append(_observed(fed, stubs, events, None, results))
            finally:
                await fed.close()
            fed, stubs = _fed(P, {"a": {"a1": lambda **kw: FakeResult([5])},
                                  "s": {"s1": lambda **kw: FakeResult([5])}},
                              aio=True, home="a", shadow=P.fed.ShadowPolicy("s", ratio=1.0))
            try:
                results = [await fed.infer("m", []) for _ in range(6)]
                assert await fed.shadow_drain(10.0)
                out.append(_observed(fed, stubs, [], None, results))
            finally:
                await fed.close()
            return out

        return asyncio.run(go())

    spill, canary, shadow = _both(run)
    assert spill["results"] == ["from-b"] * 10
    assert sum(spill["stats"]["cells"]["a"]["spill_out"].values()) == 10
    assert canary["stats"]["canary"]["rolled_back"] is True
    assert [e[0] for e in canary["events"]].count("CanaryRolledBack") == 1
    assert shadow["stats"]["shadow"]["matched"] == 6


# -- live: the 2x2 matrix over both packages' servers -------------------------------
@pytest.fixture(scope="module")
def live_servers():
    made = {"port": [HttpInferenceServer(ServerCore([AddSubModel(device="cpu")],
                                                    device="cpu")).start() for _ in range(2)],
            "jax": [JaxHttpServer(JaxCore([JaxAddSub()])).start() for _ in range(2)]}
    yield made
    for servers in made.values():
        for server in servers:
            server.stop()


def _simple_inputs(P):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    inputs = []
    for name, value in (("INPUT0", a), ("INPUT1", np.ones_like(a))):
        inp = P.http.InferInput(name, [1, 16], "INT32")
        inp.set_data_from_numpy(value)
        inputs.append(inp)
    return inputs, a + 1


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_live_blackholed_home_spills_with_no_error_and_heals(live_servers, client_pkg,
                                                             server_pkg):
    """A two-cell fleet of one package's servers behind the client
    package's ``ChaosProxy``: the whole home cell blackholes mid-run, every
    request still succeeds, the spills are typed, and after the heal
    traffic returns home."""
    P = PKGS[client_pkg]
    servers = live_servers[server_pkg]
    proxies = [P.testing.ChaosProxy("127.0.0.1", s.port).start() for s in servers]
    cell_a = P.testing.ChaosCell([proxies[0]])
    events = []
    tel = P.observe.Telemetry(sample="off")
    fed = P.fed.FederatedClient(
        {"a": [proxies[0].url], "b": [proxies[1].url]}, home="a", protocol="http",
        telemetry=tel, on_event=events.append,
        cell_breaker_factory=lambda: P.resilience.CircuitBreaker(min_calls=2,
                                                                recovery_time_s=0.5),
        default_deadline_s=8.0, per_attempt_timeout_s=0.5, rng=seeded(),
        pool_kwargs={"health_interval_s": 0.1, "probe_timeout_s": 0.3, "rng": seeded()})
    inputs, expected = _simple_inputs(P)
    try:
        errors = []
        for i in range(30):
            if i == 8:
                cell_a.blackhole()
            if i == 20:
                cell_a.heal(reset_active=True)
            try:
                result = fed.infer("simple", inputs, client_timeout=8.0)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), expected)
            except Exception as e:  # pragma: no cover - assertion target
                errors.append(f"request {i}: {e}")
        assert errors == []
        stats = fed.federation_stats()
        assert sum(stats["cells"]["a"]["spill_out"].values()) > 0, stats
        reasons = {e.reason for e in events if isinstance(e, P.fed.CellSpill)}
        assert reasons and reasons <= {"down", "error"}
        assert any(line.startswith("client_tpu_federation_spill_total")
                   for line in _counters(tel))
        served = stats["cells"]["a"]["served"]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            fed.infer("simple", inputs, client_timeout=8.0)
            if fed.federation_stats()["cells"]["a"]["served"] > served:
                break
            time.sleep(0.05)
        assert fed.federation_stats()["cells"]["a"]["served"] > served
    finally:
        fed.close()
        for p in proxies:
            p.stop()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_live_shadow_matches_across_packages(live_servers, client_pkg, server_pkg):
    """Home on one package's server, the shadow on the other's: the
    outputs compare bit for bit."""
    P = PKGS[client_pkg]
    other = "jax" if server_pkg == "port" else "port"
    fed = P.fed.FederatedClient(
        {"a": [live_servers[server_pkg][0].url], "s": [live_servers[other][0].url]},
        home="a", protocol="http", shadow=P.fed.ShadowPolicy("s", ratio=1.0), rng=seeded(),
        pool_kwargs={"health_interval_s": None})
    inputs, expected = _simple_inputs(P)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(fed.infer("simple", inputs).as_numpy("OUTPUT0"),
                                          expected)
        assert fed.shadow_drain(10.0)
        status = fed.shadow_status()
        assert status["sent"] == status["matched"] == 5
        assert status["diverged"] == status["errors"] == 0
    finally:
        fed.close()
