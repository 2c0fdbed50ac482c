"""``client_tpu_torch.pool`` against ``client_tpu.pool``.

- the engine: one seeded script of selects, successes, failures, health
  flips and clock steps drives an ``EndpointPool`` of each package under an
  injected clock, for all five routing policies; the picked urls, the
  emitted events and the final snapshot must be equal;
- ejection windows (exponential growth, cap, decay) and the half-pool cap;
- ``_affinity_ranked``, ``load_score`` and ``HedgePolicy.delay`` on seeded
  inputs;
- the 2x2 case: each package's ``PoolClient`` over one JAX HTTP server and
  one port HTTP server (CPU, a small decoder and encoder), every output held
  to each package's own model at the slice's tolerances (decoder tokens
  exact and logits within 5e-2; encoder within 2e-5); a sequence pins to
  one server.

Every pool is closed by its test, so no prober thread outlives it.
"""

import random

import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu.observe as jax_observe
import client_tpu.pool as jax_pool
import client_tpu.resilience as jax_res
import client_tpu_torch.http as port_http
import client_tpu_torch.observe as port_observe
import client_tpu_torch.pool as port_pool
import client_tpu_torch.resilience as port_res
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.models.long_context import LongContextEncoderModel as JaxEncoder
from client_tpu.server import HttpInferenceServer as JaxServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import LongContextEncoderModel, TinyDecoderModel
from client_tpu_torch.models.long_context import load_jax_params
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)
from test_torch_long_context import jax_weights

PKG = {
    "port": {"pool": port_pool, "res": port_res, "observe": port_observe,
             "http": port_http},
    "jax": {"pool": jax_pool, "res": jax_res, "observe": jax_observe,
            "http": jax_http},
}
POLICIES = ["round_robin", "least_outstanding", "weighted", "orca_weighted",
            "affinity"]
URLS = [f"10.0.0.{i}:8000" for i in range(4)]
WEIGHTS = [3.0, 1.0, 2.0, 1.0]
ENC_TOL = 2e-5
LOGIT_TOL = 5e-2


# -- the engine ----------------------------------------------------------------
def _script(seed, n_ops=300):
    """One seeded operation list, replayed verbatim on both packages."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        i = int(rng.integers(len(URLS)))
        if r < 0.45:
            ops.append(("select", f"key{int(rng.integers(6))}", bool(rng.random() < 0.5)))
        elif r < 0.60:
            ops.append(("success", i, float(rng.uniform(0.001, 0.05))))
        elif r < 0.78:
            ops.append(("failure", i, ["connect", "transient", "timeout", "fatal"][
                int(rng.integers(4))]))
        elif r < 0.83:
            ops.append(("health", i, bool(rng.random() < 0.6)))
        elif r < 0.93:
            ops.append(("tick", float(rng.uniform(0.0, 3.0))))
        else:
            ops.append(("done", i))
    loads = [[float(v) for v in rng.uniform(0.0, 1.0, size=len(URLS))]
             for _ in range(8)]
    return ops, loads


def _run_engine(pkg, routing, seed):
    mods = PKG[pkg]
    t = [0.0]

    def clock():
        return t[0]

    eps = [mods["pool"].EndpointState(
        url, client=None,
        policy=mods["res"].ResiliencePolicy(breaker=mods["res"].CircuitBreaker(
            min_calls=2, window=4, recovery_time_s=2.0, clock=clock)),
        weight=WEIGHTS[i]) for i, url in enumerate(URLS)]
    ops, loads = _script(seed)
    load_step = [0]

    def lookup():
        row = loads[load_step[0] % len(loads)]
        return {url: mods["observe"].EndpointLoad(
            {"application_utilization": row[i], "qps": 10.0 * (i + 1)}, "json")
            for i, url in enumerate(URLS)}

    events = []
    pool = mods["pool"].EndpointPool(
        eps, routing=routing, eject_after=2, base_ejection_s=1.5,
        max_ejection_s=5.0, ejection_decay_s=8.0, clock=clock,
        on_event=lambda e: events.append(
            (type(e).__name__, e.url, round(getattr(e, "window_s", 0.0), 9))),
        load_lookup=lookup if routing == "orca_weighted" else None)
    trace = []
    for op in ops:
        kind = op[0]
        if kind == "select":
            try:
                ep = pool.select(affinity_key=op[1] if routing == "affinity" else None)
            except Exception as e:  # noqa: BLE001 - the typed outcome is compared
                trace.append(type(e).__name__)
                continue
            # the ORCA reports are read through a 2 ms cache: drop it so
            # each pick reads the step's loads
            pool._load_cache = None
            load_step[0] += 1
            trace.append(ep.url)
            if op[2]:
                pool.begin(ep)
        elif kind == "success":
            pool.record_success(eps[op[1]], op[2])
        elif kind == "failure":
            pool.record_failure(eps[op[1]], op[2])
        elif kind == "health":
            pool.set_health(eps[op[1]], op[2])
        elif kind == "tick":
            t[0] += op[1]
        else:
            pool.done(eps[op[1]])
    return trace, events, pool.snapshot(), pool.latency_p95()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("routing", POLICIES)
def test_select_sequences_match_jax(routing, seed):
    port = _run_engine("port", routing, seed)
    ref = _run_engine("jax", routing, seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    # the script really exercises selection and ejection
    assert len(set(port[0]) & set(URLS)) >= 2
    assert any(e[0] == "EndpointEjected" for e in port[1])


def _ejection_windows(pkg, n_rounds):
    mods = PKG[pkg]
    t = [0.0]
    eps = [mods["pool"].EndpointState(f"ep{i}", client=None,
                                      policy=mods["res"].ResiliencePolicy())
           for i in range(3)]
    windows = []
    pool = mods["pool"].EndpointPool(
        eps, eject_after=1, base_ejection_s=1.0, ejection_multiplier=2.0,
        max_ejection_s=3.0, ejection_decay_s=10.0, clock=lambda: t[0],
        on_event=lambda e: windows.append((type(e).__name__, e.url,
                                           getattr(e, "window_s", None))))
    for _ in range(n_rounds):
        pool.record_failure(eps[0], "connect")
        t[0] = eps[0].ejected_until
        pool.select()
    t[0] += 20.0
    pool.record_failure(eps[0], "connect")
    # the half-pool cap: a second ejection is allowed, a third is not
    pool.record_failure(eps[1], "transient")
    pool.record_failure(eps[2], "transient")
    return windows, [(ep.ejected, ep.ejection_count) for ep in eps]


@pytest.mark.parametrize("n_rounds", [1, 4])
def test_ejection_windows_match_jax(n_rounds):
    port = _ejection_windows("port", n_rounds)
    assert port == _ejection_windows("jax", n_rounds)
    assert port[1][2] == (False, 0)


@pytest.mark.parametrize("seed", range(4))
def test_affinity_ranked_matches_jax(seed):
    rng = np.random.default_rng(seed)
    urls = [f"h{int(v)}:{8000 + i}" for i, v in enumerate(rng.integers(0, 999, 6))]
    for k in range(20):
        digest = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
        port = port_pool._affinity_ranked(
            digest, [port_pool.EndpointState(u, None, port_res.ResiliencePolicy())
                     for u in urls])
        ref = jax_pool._affinity_ranked(
            digest, [jax_pool.EndpointState(u, None, jax_res.ResiliencePolicy())
                     for u in urls])
        assert [ep.url for ep in port] == [ep.url for ep in ref]


LOADS = [
    {"application_utilization": 0.3},
    {"cpu_utilization": 1.7},
    {"utilization.gpu": 0.2, "utilization.mem": 0.9},
    {"application_utilization": 0.5, "qps": 40.0},
    {"rps_fractional": 12.5},
    {"named_metrics.avg_compute_infer_us": 350.0},
    {},
]


@pytest.mark.parametrize("metrics", LOADS, ids=range(len(LOADS)))
@pytest.mark.parametrize("max_qps, max_busy", [(None, None), (80.0, 700.0)])
def test_load_score_matches_jax(metrics, max_qps, max_busy):
    port = port_pool.load_score(port_observe.EndpointLoad(dict(metrics), "json"),
                                max_qps, max_busy)
    ref = jax_pool.load_score(jax_observe.EndpointLoad(dict(metrics), "json"),
                              max_qps, max_busy)
    assert port == ref


@pytest.mark.parametrize("kwargs", [{}, {"delay_s": 0.02}, {"jitter_frac": 0.0},
                                    {"fallback_delay_s": 0.2, "jitter_frac": 0.5}])
def test_hedge_delay_matches_jax(kwargs):
    port = port_pool.HedgePolicy(**kwargs)
    ref = jax_pool.HedgePolicy(**kwargs)
    r_port, r_ref = random.Random(7), random.Random(7)
    for p95 in [None, 0.001, 0.03, None, 0.5] * 4:
        assert port.delay(p95, r_port) == ref.delay(p95, r_ref)
    assert port.delay(None) == ref.delay(None)


def test_default_client_factory_is_the_ports():
    for protocol in ("http", "grpc"):
        for aio in (False, True):
            cls = port_pool._default_client_factory(protocol, aio)
            assert cls.__module__.startswith("client_tpu_torch.")
            ref = jax_pool._default_client_factory(protocol, aio)
            assert cls.__name__ == ref.__name__
    with pytest.raises(ValueError, match="unknown protocol"):
        port_pool._default_client_factory("native", False)


# -- the 2x2 case: pools of either package over servers of both ----------------
def _jax_encoder_weights():
    ref = JaxEncoder(dim=64, heads=4, seed=0, attention="flash", n_devices=1)
    return ref, jax_weights(64, seed=0)


@pytest.fixture(scope="module")
def fleet():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_enc, weights = _jax_encoder_weights()
    port_enc = LongContextEncoderModel(dim=64, heads=4, device="cpu")
    load_jax_params(port_enc, weights)
    jax_dec = JaxDecoder()
    port_dec = TinyDecoderModel(device="cpu")
    servers = [JaxServer(JaxCore([jax_enc, jax_dec])).start(),
               HttpInferenceServer(ServerCore([port_enc, TinyDecoderModel(device="cpu")],
                                              device="cpu")).start()]
    yield {"urls": [s.url for s in servers], "encoders": (jax_enc, port_enc),
           "decoders": (jax_dec, port_dec)}
    for s in servers:
        s.stop()
    torch.set_num_threads(before)


def _encode(model, x):
    out = model.execute({"sequence": x}, {})["encoded"]
    return np.asarray(out)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pool_over_both_servers_encoder(fleet, pkg):
    mods = PKG[pkg]
    pool = mods["pool"].PoolClient(fleet["urls"], protocol="http",
                                   health_interval_s=0.2)
    try:
        for i in range(6):
            x = np.random.default_rng(i).standard_normal((24, 64)).astype(np.float32)
            inp = mods["http"].InferInput("sequence", [24, 64], "FP32")
            inp.set_data_from_numpy(x)
            out = pool.infer("long_context_encoder", [inp]).as_numpy("encoded")
            for model in fleet["encoders"]:
                np.testing.assert_allclose(out, _encode(model, x),
                                           atol=ENC_TOL, rtol=ENC_TOL)
        stats = pool.endpoint_stats()
        # round robin: three requests on each package's server
        assert [stats[u]["resilience"]["calls"] for u in fleet["urls"]] == [3, 3]
    finally:
        pool.close()


def _drive_model(model, prompt, n, seq_id):
    params = {"sequence_id": seq_id, "sequence_start": True, "sequence_end": False}
    out = model.execute({"TOKENS": np.array([prompt], np.int32)}, params)
    toks, logits = [int(np.asarray(out["NEXT_TOKEN"])[0, 0])], [np.asarray(out["LOGITS"])]
    for i in range(n - 1):
        params = {"sequence_id": seq_id, "sequence_start": False,
                  "sequence_end": i == n - 2}
        out = model.execute({"TOKENS": np.array([[toks[-1]]], np.int32)}, params)
        toks.append(int(np.asarray(out["NEXT_TOKEN"])[0, 0]))
        logits.append(np.asarray(out["LOGITS"]))
    return toks, np.concatenate(logits)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pool_pins_a_decoder_sequence_to_one_server(fleet, pkg):
    mods = PKG[pkg]
    http = mods["http"]
    prompt, n = [5, 6, 7], 6
    pool = mods["pool"].PoolClient(fleet["urls"], protocol="http",
                                   health_interval_s=0.2)
    try:
        for seq_id in (41, 42):  # round robin homes the two sequences apart
            toks, logits = [], []
            step = [prompt]
            for i in range(n):
                inp = http.InferInput("TOKENS", [1, len(step[0])], "INT32")
                inp.set_data_from_numpy(np.array(step, np.int32))
                res = pool.infer("decoder_lm", [inp], sequence_id=seq_id,
                                 sequence_start=i == 0, sequence_end=i == n - 1)
                toks.append(int(res.as_numpy("NEXT_TOKEN")[0, 0]))
                logits.append(res.as_numpy("LOGITS"))
                step = [[toks[-1]]]
            for model, sid in zip(fleet["decoders"], (seq_id + 100, seq_id + 200)):
                ref_toks, ref_logits = _drive_model(model, prompt, n, sid)
                assert toks == ref_toks
                np.testing.assert_allclose(np.concatenate(logits), ref_logits,
                                           atol=LOGIT_TOL, rtol=0)
        calls = [pool.endpoint_stats()[u]["resilience"]["calls"] for u in fleet["urls"]]
        # every step of a sequence lands on its pinned server: 6 + 6
        assert sorted(calls) == [n, n]
    finally:
        pool.close()
