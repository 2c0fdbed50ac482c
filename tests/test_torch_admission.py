"""The port's admission control against the JAX package's.

- ``AdaptiveLimiter``: the same seeded completions under the same injected
  clock give the same verdicts, limits and snapshots, in both modes, with
  and without a declared target;
- ``AdmissionController``: the same seeded acquire / release sequence
  (priorities, deadlines, forced admits, completions) gives the same admits,
  sheds, reasons, lanes and snapshot after every step, tenantless and under
  a tenancy policy; parked waiters drain in the same order (LIFO within a
  lane, lanes by rank, tenants weighted-fair); the queue-full and
  queue-timeout reasons, the async admit / timeout / cancel paths, a dead
  loop's waiter, double release and forced admits behave alike;
- ``AdmissionRejected`` is the ``SHED`` domain of the port's resilience
  engine (never retried, never a breaker outcome) and the port's perf
  runner counts it as a shed, not an error, as the JAX runner does;
- the port's ``Telemetry.attach_admission`` exports the same admission
  series; a tenancy spec string raises, naming ROADMAP A7.

Every clock is injected and every wait bounded; each test runs under a time
limit.
"""

import asyncio
import queue
import threading
import time

import numpy as np
import pytest

import client_tpu.admission as jax_adm
import client_tpu.observe as jax_observe
import client_tpu.perf as jax_perf
import client_tpu.resilience as jax_res
import client_tpu_torch.admission as port_adm
import client_tpu_torch.observe as port_observe
import client_tpu_torch.perf as port_perf
import client_tpu_torch.resilience as port_res
from client_tpu.models import simple as jax_simple
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu.tenancy import parse_tenancy_spec
from client_tpu_torch.models import AddSubModel
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PKG = {"port": {"adm": port_adm, "res": port_res, "observe": port_observe,
                "perf": port_perf},
       "jax": {"adm": jax_adm, "res": jax_res, "observe": jax_observe, "perf": jax_perf}}
WAIT_S = 5.0


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(run, *args, **kwargs):
    """``run(pkg, ...)`` for each package; asserts the two results equal and
    returns the port's."""
    out = {pkg: run(pkg, *args, **kwargs) for pkg in ("port", "jax")}
    assert out["port"] == out["jax"]
    return out["port"]


# -- AdaptiveLimiter ------------------------------------------------------------
LIMITER_CONFIGS = [
    {"initial_limit": 4, "target_ms": 50, "cooldown_s": 0.0},
    {"initial_limit": 8, "target_ms": None, "tolerance": 2.0, "cooldown_s": 0.0},
    {"initial_limit": 2, "min_limit": 2, "max_limit": 3, "target_ms": 100,
     "cooldown_s": 0.05},
    {"mode": "gradient", "initial_limit": 32, "target_ms": None, "cooldown_s": 0.0},
    {"mode": "gradient", "initial_limit": 16, "target_ms": 40, "cooldown_s": 0.02},
]


def _limiter_trace(pkg, config, seed):
    clock = FakeClock()
    lim = PKG[pkg]["adm"].AdaptiveLimiter(clock=clock, **config)
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(300):
        kind = rng.random()
        if kind < 0.05:
            verdict = lim.on_result(None, ok=bool(rng.random() < 0.5))
        else:
            # mostly fast, with slow spells that breach
            scale = 0.08 if rng.random() < 0.2 else 0.01
            verdict = lim.on_result(float(rng.exponential(scale)), ok=bool(rng.random() > 0.03))
        clock.t += float(rng.exponential(0.005))
        trace.append((verdict, lim.limit, lim.limit_int(), lim.eta_s(), lim.minrtt_ms(),
                      lim.would_admit(int(rng.integers(0, 8)))))
    return trace, lim.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("config", range(len(LIMITER_CONFIGS)))
def test_limiter_same_completions_same_limits(config, seed):
    trace, snap = _both(_limiter_trace, LIMITER_CONFIGS[config], seed)
    assert snap["good_total"] + snap["breach_total"] > 0


def test_limiter_aimd_grows_then_decays_multiplicatively():
    def run(pkg):
        lim = PKG[pkg]["adm"].AdaptiveLimiter(initial_limit=4, target_ms=50, cooldown_s=0.0)
        good = [lim.on_result(0.010) for _ in range(40)]
        grown = lim.limit
        bad = [lim.on_result(0.200) for _ in range(3)]
        return good, bad, grown, lim.limit, lim.snapshot()

    good, bad, grown, limit, snap = _both(run)
    assert all(good) and not any(bad) and grown > 4.0
    assert limit == pytest.approx(grown * 0.7 ** 3, rel=1e-6)
    assert (snap["decay_total"], snap["good_total"]) == (3, 40)


@pytest.mark.parametrize("priority", [None, -3, 0, 1, 2, 3, 7, 100])
def test_default_lane_map(priority):
    assert port_adm.default_lane_map(priority) == jax_adm.default_lane_map(priority)


def test_constants_and_spill_reasons():
    names = [n for n in dir(jax_adm) if n.startswith(("SHED_", "LANE_"))]
    assert names and {n: getattr(port_adm, n) for n in names} == \
        {n: getattr(jax_adm, n) for n in names}
    assert port_adm.SPILL_REASONS == jax_adm.SPILL_REASONS
    assert port_adm.ADMISSION_REJECTED_STATUS == jax_adm.ADMISSION_REJECTED_STATUS
    for reason in names:
        value = getattr(jax_adm, reason)
        assert (port_adm.is_spill_signal(port_adm.AdmissionRejected(value))
                == jax_adm.is_spill_signal(jax_adm.AdmissionRejected(value)))


# -- AdmissionController: seeded single-thread sequences -------------------------
CONTROLLER_CONFIGS = [
    {"limiter": {"initial_limit": 2, "max_limit": 4, "target_ms": 30}, "ctrl": {}},
    {"limiter": {"initial_limit": 1, "max_limit": 1}, "ctrl": {"eta_factor": 1.5}},
    {"limiter": {"mode": "gradient", "initial_limit": 3, "target_ms": None},
     "ctrl": {"shed_low_when_saturated": False}},
    {"limiter": {"initial_limit": 2, "max_limit": 6, "target_ms": 20},
     "ctrl": {}, "tenancy": "a,rate=40,burst=2,weight=2;b,rate=20,burst=1"},
]


def _controller_trace(pkg, config, seed):
    """max_queue=0: a request that would park sheds as queue_full at once, so
    the sequence never blocks and every step is decided by the seed."""
    adm = PKG[pkg]["adm"]
    clock = FakeClock()
    tenancy = (parse_tenancy_spec(config["tenancy"], clock=clock)
               if "tenancy" in config else None)
    ctrl = adm.AdmissionController(
        limiter=adm.AdaptiveLimiter(clock=clock, cooldown_s=0.01, **config["limiter"]),
        max_queue=0, clock=clock, tenancy=tenancy, **config["ctrl"])
    rng = np.random.default_rng(seed)
    tokens, trace = [], []
    for _ in range(250):
        if tokens and rng.random() < 0.45:
            tok = tokens.pop(int(rng.integers(len(tokens))))
            latency = None if rng.random() < 0.05 else float(rng.exponential(0.02))
            tok.release(latency, ok=bool(rng.random() > 0.05))
            trace.append(("release", tok.lane, tok.tenant))
        else:
            priority = int(rng.choice([0, 0, 0, 1, 2, 5]))
            deadline = (clock() + float(rng.uniform(0.001, 0.08))
                        if rng.random() < 0.3 else None)
            tenant = str(rng.choice(["a", "b", "c"])) if tenancy is not None else None
            try:
                tok = ctrl.acquire(priority, deadline=deadline,
                                   force=bool(rng.random() < 0.05), tenant=tenant)
                tokens.append(tok)
                trace.append(("admit", tok.lane, tok.tenant, tok.waited_s))
            except adm.AdmissionRejected as exc:
                trace.append(("shed", exc.reason, exc.lane, exc.tenant, exc.retry_after_s,
                              exc.status(), str(exc)))
        clock.t += float(rng.exponential(0.004))
        trace.append((ctrl.snapshot(), ctrl.watch_gauges(), ctrl.queue_depths()))
    for tok in tokens:
        tok.release(0.01)
    return trace, ctrl.snapshot()


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("config", range(len(CONTROLLER_CONFIGS)))
def test_controller_same_sequence_same_admits_and_sheds(config, seed):
    trace, final = _both(_controller_trace, CONTROLLER_CONFIGS[config], seed)
    kinds = {step[0] for step in trace if isinstance(step[0], str)}
    assert {"admit", "shed", "release"} <= kinds
    assert final["inflight"] == 0


def test_controller_sheds_low_lane_at_the_door():
    def run(pkg):
        adm, res = PKG[pkg]["adm"], PKG[pkg]["res"]
        ctrl = adm.AdmissionController(limiter=adm.AdaptiveLimiter(initial_limit=1))
        tok = ctrl.acquire()
        with pytest.raises(adm.AdmissionRejected) as exc:
            ctrl.acquire(priority=5)
        tok.release(0.01)
        return (exc.value.reason, exc.value.lane, res.classify_fault(exc.value),
                ctrl.snapshot()["shed_total"], ctrl.snapshot()["lanes"]["low"]["shed"])

    assert _both(run) == (jax_adm.SHED_SATURATED, jax_adm.LANE_LOW, jax_res.SHED, 1,
                          {jax_adm.SHED_SATURATED: 1})


def test_controller_deadline_shed_at_the_door_and_idle_admits_doomed():
    def run(pkg):
        adm = PKG[pkg]["adm"]
        clock = FakeClock()
        ctrl = adm.AdmissionController(
            limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1, clock=clock), clock=clock)
        ctrl.acquire().release(0.050)  # seeds the service estimate at ~50 ms
        tok = ctrl.acquire()
        with pytest.raises(adm.AdmissionRejected) as exc:
            ctrl.acquire(deadline=clock() + 0.005)
        tok.release(0.05)
        # idle: a deadline the estimate calls doomed is admitted all the same
        idle = ctrl.acquire(deadline=clock() + 0.001)
        idle.release(0.001)
        return exc.value.reason, exc.value.retry_after_s, ctrl.snapshot()

    reason, retry_after, snap = _both(run)
    assert reason == jax_adm.SHED_DEADLINE and snap["shed_total"] == 1


# -- parked waiters ---------------------------------------------------------------
def _drain_order(ctrl, held, parks):
    """Park each ``(tag, acquire kwargs)`` in turn (waiting until it is in a
    queue), then hand the held slot on release by release. Returns the order
    in which the waiters were admitted."""
    admitted: "queue.Queue" = queue.Queue()
    threads = []
    for tag, kwargs in parks:
        depth = sum(ctrl.queue_depths().values())
        thread = threading.Thread(
            target=lambda tag=tag, kwargs=kwargs: admitted.put((tag, ctrl.acquire(**kwargs))))
        thread.start()
        threads.append(thread)
        end = time.monotonic() + WAIT_S
        while sum(ctrl.queue_depths().values()) == depth:
            assert time.monotonic() < end, f"{tag} never parked"
            time.sleep(0.001)
    order, tok = [], held
    for _ in parks:
        tok.release(0.01)
        tag, tok = admitted.get(timeout=WAIT_S)
        order.append(tag)
    tok.release(0.01)
    for thread in threads:
        thread.join(WAIT_S)
    return order


DRAINS = {
    # fresh requests beat stale ones within a lane
    "lifo": (None, [("old", {}), ("new", {})], ["new", "old"]),
    # the high lane (priority 1) drains before the default lane
    "lanes": (None, [("default", {"priority": 0}), ("low", {"priority": 3}),
                     ("high", {"priority": 1})], ["high", "default", "low"]),
    # tenants drain weighted-fair; one tenant keeps LIFO
    "tenants": ("a,weight=3;b,weight=1",
                [(f"{t}{i}", {"tenant": t}) for i in range(3) for t in ("a", "b")], None),
}


@pytest.mark.parametrize("drain", sorted(DRAINS))
def test_parked_waiters_drain_alike(drain):
    spec, parks, want = DRAINS[drain]

    def run(pkg):
        adm = PKG[pkg]["adm"]
        clock = FakeClock()
        ctrl = adm.AdmissionController(
            limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1, clock=clock),
            max_queue_wait_s=WAIT_S, shed_low_when_saturated=False, clock=clock,
            tenancy=parse_tenancy_spec(spec, clock=clock) if spec else None)
        order = _drain_order(ctrl, ctrl.acquire(), parks)
        return order, ctrl.snapshot()

    order, snap = _both(run)
    assert sorted(order) == sorted(tag for tag, _ in parks)
    if want is not None:
        assert order == want
    assert snap["inflight"] == 0 and snap["admitted_total"] == len(parks) + 1


def test_queue_full_and_queue_timeout_reasons():
    def run(pkg):
        adm = PKG[pkg]["adm"]
        ctrl = adm.AdmissionController(
            limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1),
            max_queue=1, max_queue_wait_s=0.05)
        tok = ctrl.acquire()
        parked = {}

        def park():
            try:
                parked["out"] = ctrl.acquire()
            except adm.AdmissionRejected as exc:
                parked["out"] = exc

        thread = threading.Thread(target=park)
        thread.start()
        end = time.monotonic() + WAIT_S
        while not ctrl.queue_depths().get("default") and "out" not in parked:
            assert time.monotonic() < end
            time.sleep(0.001)
        with pytest.raises(adm.AdmissionRejected) as full:
            ctrl.acquire()
        thread.join(WAIT_S)
        tok.release(0.01)
        snap = ctrl.snapshot()
        return full.value.reason, parked["out"].reason, snap["lanes"], snap["shed_total"]

    full, timeout, lanes, shed = _both(run)
    assert (full, timeout) == (jax_adm.SHED_QUEUE_FULL, jax_adm.SHED_QUEUE_TIMEOUT)
    assert shed == 2


def test_async_admit_timeout_and_cancel():
    def run(pkg):
        adm = PKG[pkg]["adm"]

        async def main():
            ctrl = adm.AdmissionController(
                limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1),
                max_queue_wait_s=0.2)
            tok = await ctrl.acquire_async()
            task = asyncio.ensure_future(ctrl.acquire_async())
            await asyncio.sleep(0.02)
            tok.release(0.01)
            tok2 = await task
            waited = tok2.waited_s > 0.0
            task = asyncio.ensure_future(ctrl.acquire_async())
            try:
                await task
                timed_out = None
            except adm.AdmissionRejected as exc:
                timed_out = exc.reason
            task = asyncio.ensure_future(ctrl.acquire_async())
            await asyncio.sleep(0.02)
            task.cancel()
            try:
                await task
                cancelled = False
            except asyncio.CancelledError:
                cancelled = True
            tok2.release(0.01)
            snap = ctrl.snapshot()
            return waited, timed_out, cancelled, ctrl.inflight, snap["admitted_total"], \
                snap["lanes"]["default"]["shed"]

        return asyncio.run(main())

    assert _both(run) == (True, jax_adm.SHED_QUEUE_TIMEOUT, True, 0, 2,
                          {jax_adm.SHED_QUEUE_TIMEOUT: 1})


def test_dead_loop_waiter_slot_reclaimed():
    def run(pkg):
        adm = PKG[pkg]["adm"]
        ctrl = adm.AdmissionController(
            limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1), max_queue_wait_s=5.0)
        tok = ctrl.acquire()
        loop = asyncio.new_event_loop()

        async def park():
            task = asyncio.ensure_future(ctrl.acquire_async())
            await asyncio.sleep(0.05)
            task.cancel()  # not awaited: the waiter stays parked on a loop about to close

        loop.run_until_complete(park())
        loop.close()
        tok.release(0.01)  # must neither raise nor leak the slot
        inflight = ctrl.inflight
        ctrl.acquire().release(0.01)
        return inflight, ctrl.inflight

    assert _both(run) == (0, 0)


def test_double_release_raises_and_force_never_sheds():
    def run(pkg):
        adm = PKG[pkg]["adm"]
        ctrl = adm.AdmissionController(limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1))
        tok = ctrl.acquire()
        forced = ctrl.acquire(force=True)
        inflight = ctrl.inflight
        forced.release(0.01)
        tok.release(0.01)
        with pytest.raises(Exception) as exc:
            tok.release(0.01)
        return inflight, exc.value.status(), ctrl.inflight

    assert _both(run) == (2, "ADMISSION_TOKEN", 0)


def test_tenancy_spec_string_waits_for_a7():
    with pytest.raises(NotImplementedError, match="A7"):
        port_adm.AdmissionController(tenancy="a,rate=1,burst=1")
    # JAX's controller parses the string; the port takes a policy object
    policy = parse_tenancy_spec("a,rate=1,burst=1", clock=FakeClock())
    tok = port_adm.AdmissionController(tenancy=policy).acquire(tenant="a")
    with pytest.raises(port_adm.AdmissionRejected) as exc:
        port_adm.AdmissionController(tenancy=policy).acquire(tenant="a")
    assert exc.value.reason == port_adm.SHED_OVER_QUOTA and exc.value.tenant == "a"
    tok.release(0.01)


# -- the SHED domain -------------------------------------------------------------
def test_rejected_never_retried_and_no_breaker_outcome():
    def run(pkg):
        adm, res = PKG[pkg]["adm"], PKG[pkg]["res"]
        breaker = res.CircuitBreaker(min_calls=2, window=4)
        policy = res.ResiliencePolicy(
            retry=res.RetryPolicy(max_attempts=5, initial_backoff_s=0.0), breaker=breaker)
        attempts = [0]

        def op():
            attempts[0] += 1
            raise adm.AdmissionRejected(adm.SHED_SATURATED, adm.LANE_DEFAULT)

        for _ in range(4):
            with pytest.raises(adm.AdmissionRejected):
                policy.execute(op)
        return attempts[0], breaker.state, len(breaker._outcomes)

    assert _both(run) == (4, jax_res.CircuitBreaker.CLOSED, 0)


def test_attach_admission_exports_the_same_series():
    def run(pkg):
        adm, observe = PKG[pkg]["adm"], PKG[pkg]["observe"]
        tel = observe.Telemetry()
        ctrls = [tel.attach_admission(adm.AdmissionController(
            limiter=adm.AdaptiveLimiter(initial_limit=1, max_limit=1))) for _ in range(2)]
        tok = ctrls[0].acquire()
        with pytest.raises(adm.AdmissionRejected):
            ctrls[0].acquire(priority=4)
        tok.release(0.01)
        ctrls[1].acquire().release(0.01)
        return sorted(line for line in tel.registry.prometheus_text().splitlines()
                      if "client_tpu_admission" in line)

    lines = _both(run)
    assert any('scope="pool#2"' in line for line in lines)
    assert any("client_tpu_admission_shed_total{" in line for line in lines)


# -- the perf runner's shed accounting -----------------------------------------
@pytest.fixture(scope="module")
def http_servers():
    made = {"port": HttpInferenceServer(ServerCore([AddSubModel(device="cpu")],
                                                   device="cpu")).start(),
            "jax": JaxHttpServer(JaxCore([jax_simple.AddSubModel()])).start()}
    yield made
    for server in made.values():
        server.stop()


def test_perf_open_loop_counts_sheds_apart_from_errors(http_servers):
    """Breaker fast-fails and admission rejections are sheds, genuine
    failures errors, in both runners' open-loop rows."""

    def run(pkg):
        adm, res, perf = PKG[pkg]["adm"], PKG[pkg]["res"], PKG[pkg]["perf"]
        kwargs = {"device": "cpu"} if pkg == "port" else {}
        runner = perf.PerfRunner(http_servers[pkg].url, "http", "simple", **kwargs)
        counter = {"n": 0}
        lock = threading.Lock()

        def flaky(client, inputs, outputs=None):
            with lock:
                counter["n"] += 1
                n = counter["n"]
            if n % 3 == 0:
                raise res.CircuitOpenError()
            if n % 3 == 1:
                raise adm.AdmissionRejected(adm.SHED_SATURATED, adm.LANE_DEFAULT)
            raise RuntimeError("genuine server error")

        runner._infer_once = flaky
        try:
            row = runner.run_rate(500.0, 30, pool_size=4)
        finally:
            runner.close()
        return (row["issued"], row["shed"], row["errors"], round(row["shed_pct"], 1),
                round(row["error_pct"], 1), "admission rejected" in row["shed_sample"])

    assert _both(run) == (30, 20, 10, 66.7, 33.3, True)
