"""``client_tpu_torch.watch`` against ``client_tpu.watch``.

- The black box: the same records written under one fake clock (a ``time``
  module patched into both packages' ``watch``) give byte-identical ring
  files, and each package's ``read_blackbox`` / ``blackbox_report`` reads
  the other's ring. Truncation at every 8-byte boundary, mid-record cuts,
  seeded bit flips and a torn record header are skipped identically: both
  readers return the same records and the same scan counts, and never
  raise.
- ``Cusum`` and ``PageHinkley`` trip at the same indices on seeded streams.
- ``Watchtower`` under the fake clock on both packages: the same alert
  edges (kind, source, state, evidence, timestamps), deduplication,
  multi-window burn, watermark rules with hysteresis, changepoint
  attribution, sinks, the black box drains and the disabled path.
- A client process SIGKILLed mid-run: its ring is reconstructed by both
  packages' ``doctor --blackbox`` with the same text.
"""

import json
import os
import random
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import client_tpu.doctor as jax_doctor
import client_tpu.flight as jax_flight
import client_tpu.observe as jax_observe
import client_tpu.watch as jax_watch
import client_tpu_torch.doctor as port_doctor
import client_tpu_torch.flight as port_flight
import client_tpu_torch.observe as port_observe
import client_tpu_torch.watch as port_watch
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

REPO = Path(__file__).resolve().parent.parent
PKGS = {
    "port": SimpleNamespace(name="port", watch=port_watch, observe=port_observe,
                            flight=port_flight, doctor=port_doctor),
    "jax": SimpleNamespace(name="jax", watch=jax_watch, observe=jax_observe,
                           flight=jax_flight, doctor=jax_doctor),
}


def seeded():
    return random.Random(0xB1AB0)


class FakeTime:
    """A ``time`` module whose wall and monotonic clocks step by a fixed
    amount on every read, so two runs read the same times."""

    def __init__(self, start=1_700_000_000.0, step=0.001):
        self.now = start
        self.step = step

    def time(self):
        self.now += self.step
        return self.now

    def monotonic(self):
        return self.time()

    def perf_counter(self):
        return self.time()

    def perf_counter_ns(self):
        return int(self.time() * 1e9)

    def time_ns(self):
        return int(self.time() * 1e9)

    def sleep(self, s):
        self.now += s


@pytest.fixture
def fake_time(monkeypatch):
    """Patch a fresh FakeTime into a package's watch module: ``clock(pkg)``."""
    def clock(pkg):
        fake = FakeTime()
        monkeypatch.setattr(PKGS[pkg].watch, "time", fake)
        return fake

    return clock


def _records(report):
    return [r.as_dict() for r in report.records]


# -- the black box ring ---------------------------------------------------------------
RING_PAYLOADS = [("timeline", {"i": i, "tag": "x" * (i % 37)}) for i in range(50)] + [
    ("alert", {"kind": "slo_burn", "source": "slo:p95"}),
    ("metrics", {"families": [{"name": "client_tpu_requests_total", "value": 3.5}]}),
    ("meta", {"pid": 1, "nested": {"a": [1, 2, None]}, "unicode": "é中"}),
]


def _write_ring(pkg, path, capacity, payloads):
    bb = PKGS[pkg].watch.BlackBox(str(path), capacity_bytes=capacity)
    wrote = [bb.append(kind, data) for kind, data in payloads]
    stats = bb.stats()
    bb.close()
    return wrote, dict(stats, path=None)


@pytest.mark.parametrize("capacity, n", [(1 << 16, 53), (4096, 53), (4096, 300)])
def test_ring_files_are_byte_identical(tmp_path, fake_time, capacity, n):
    payloads = (RING_PAYLOADS * 6)[:n]
    files = {}
    for pkg in PKGS:
        fake_time(pkg)
        files[pkg] = tmp_path / f"{pkg}.bbx"
        files[pkg + "_stats"] = _write_ring(pkg, files[pkg], capacity, payloads)
    assert files["port_stats"] == files["jax_stats"]
    assert files["port"].read_bytes() == files["jax"].read_bytes()


def test_oversize_records_drop_alike(tmp_path, fake_time):
    out = {}
    for pkg in PKGS:
        fake_time(pkg)
        out[pkg] = _write_ring(pkg, tmp_path / f"{pkg}.bbx", 4096,
                               [("metrics", {"blob": "z" * 10000}), ("meta", {"ok": 1})])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, True] and out["port"][1]["dropped_oversize"] == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_reads_the_other_s_ring(tmp_path, writer, reader):
    path = tmp_path / "ring.bbx"
    _write_ring(writer, path, 1 << 16, RING_PAYLOADS)
    ours = PKGS[reader].watch.read_blackbox(str(path))
    theirs = PKGS[writer].watch.read_blackbox(str(path))
    assert ours.ok and _records(ours) == _records(theirs)
    assert [r.seq for r in ours.records] == list(range(1, len(RING_PAYLOADS) + 1))
    assert [(r.kind, r.data) for r in ours.records] == [
        (k, json.loads(json.dumps(d))) for k, d in RING_PAYLOADS]
    assert PKGS[reader].watch.blackbox_report(str(path)) == \
        PKGS[writer].watch.blackbox_report(str(path))


def test_reopened_ring_continues_its_sequence_in_either_package(tmp_path):
    path = tmp_path / "r.bbx"
    _write_ring("jax", path, 1 << 14, [("timeline", {"i": i}) for i in range(10)])
    bb = port_watch.BlackBox(str(path))
    assert bb.stats()["next_seq"] == 11
    bb.append("meta", {"resumed": True})
    bb.close()
    rep = jax_watch.read_blackbox(str(path))
    assert [r.seq for r in rep.records] == list(range(1, 12)) and rep.records[-1].kind == "meta"


def _both_read(path):
    reports = {pkg: P.watch.read_blackbox(str(path)) for pkg, P in PKGS.items()}
    port, jax = reports["port"], reports["jax"]
    assert (port.ok, port.note, port.stats) == (jax.ok, jax.note, jax.stats)
    assert _records(port) == _records(jax)
    return port


def _torn_ring(tmp_path, n=24):
    path = tmp_path / "torn.bbx"
    originals = [{"i": i, "pad": "p" * ((i * 7) % 53)} for i in range(n)]
    _write_ring("port", path, 1 << 13, [("timeline", d) for d in originals])
    return path.read_bytes(), originals


def _valid_subset(rep, originals):
    assert rep.ok
    seqs = [r.seq for r in rep.records]
    assert seqs == sorted(seqs)
    assert all(r.kind == "timeline" and r.data == originals[r.seq - 1] for r in rep.records)


def test_truncation_at_every_boundary_is_skipped_alike(tmp_path):
    raw, originals = _torn_ring(tmp_path)
    target = tmp_path / "cut.bbx"
    cuts = list(range(64, len(raw) + 1, 8)) + list(range(67, len(raw), 64))
    for cut in cuts:
        target.write_bytes(raw[:cut])
        _valid_subset(_both_read(target), originals)


def test_bit_flips_are_skipped_alike(tmp_path):
    raw, originals = _torn_ring(tmp_path)
    rng = seeded()
    target = tmp_path / "flip.bbx"
    for _ in range(200):
        flipped = bytearray(raw)
        flipped[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
        target.write_bytes(bytes(flipped))
        rep = _both_read(target)
        if rep.ok:
            assert all(r.data == originals[r.seq - 1] for r in rep.records)
        else:
            assert rep.records == []


def test_torn_header_and_garbage_are_skipped_alike(tmp_path):
    raw, originals = _torn_ring(tmp_path, n=5)
    torn = bytearray(raw)
    torn[-24:-8] = b"\x00" * 16
    target = tmp_path / "torn2.bbx"
    target.write_bytes(bytes(torn))
    _valid_subset(_both_read(target), originals)
    target.write_bytes(b"not a blackbox at all" * 10)
    assert not _both_read(target).ok
    assert not _both_read(tmp_path / "missing.bbx").ok
    assert port_watch.blackbox_report(str(target)) == jax_watch.blackbox_report(str(target))


# -- changepoint detectors -------------------------------------------------------------
def _stream(seed, base, shift, n_base, n_shift, sd):
    rng = random.Random(seed)
    return ([base + rng.gauss(0, sd) for _ in range(n_base)]
            + [shift + rng.gauss(0, sd) for _ in range(n_shift)])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kwargs", [{"warmup": 16}, {"warmup": 12, "k": 0.25, "h": 5.0},
                                    {"warmup": 24, "rel_floor": 0.0, "abs_floor": 0.1}])
def test_cusum_trips_at_the_same_indices(seed, kwargs):
    xs = _stream(seed, 10, 24, 40, 60, 0.4) + _stream(seed + 100, 50, 50, 200, 0, 2.0)
    trips = {}
    for pkg, P in PKGS.items():
        det = P.watch.Cusum(**kwargs)
        trips[pkg] = ([i for i, x in enumerate(xs) if det.update(x)], det.state())
    assert trips["port"] == trips["jax"]
    assert trips["port"][0] and trips["port"][0][0] >= 40


@pytest.mark.parametrize("seed", range(6))
def test_page_hinkley_trips_at_the_same_indices(seed):
    xs = _stream(seed, 5, 9, 30, 80, 0.2)
    trips = {}
    for pkg, P in PKGS.items():
        det = P.watch.PageHinkley(delta=0.05, threshold=20.0, min_samples=8)
        trips[pkg] = ([i for i, x in enumerate(xs) if det.update(x)], det.state())
    assert trips["port"] == trips["jax"]
    assert trips["port"][0] and trips["port"][0][0] >= 30


# -- the watchtower under a fake clock -----------------------------------------------
class _StubTelemetry:
    def __init__(self, P, slos=(), windows=None, pools=(), ctrls=(), feds=(), flight=None):
        self._slos, self._windows = list(slos), dict(windows or {})
        self._pools, self._ctrls, self._feds = list(pools), list(ctrls), list(feds)
        self.flight = flight
        self.registry = P.observe.MetricsRegistry()

    def _fold_pending(self):
        pass

    def _fold_stream_pending(self):
        pass

    def slos(self):
        return list(self._slos)

    def stream_windows(self):
        return dict(self._windows)

    def pools(self):
        return list(self._pools)

    def admission_controllers(self):
        return [(c, "pool") for c in self._ctrls]

    def federations(self):
        return [(f, "pool") for f in self._feds]


class _StubPool:
    def __init__(self, gauges):
        self.gauges = gauges

    def watch_gauges(self):
        return self.gauges


class _StubCtrl:
    def __init__(self):
        self.admitted = 0
        self.shed = 0

    def watch_gauges(self):
        return {"admitted_total": self.admitted, "shed_total": self.shed,
                "inflight": 0, "limit": 8, "collapsed": False}


class _StubFlight:
    def __init__(self, divergence):
        self.divergence = divergence
        self.marks = []

    def tail_divergence(self, *a, **kw):
        return self.divergence

    def mark(self, layer, event, **attrs):
        self.marks.append((layer, event, attrs))


def _edges(edges):
    return [e.as_dict() for e in edges]


def _tower_view(wt):
    stats = wt.stats()
    stats.pop("tick_ns", None)
    return {"stats": stats, "active": _edges(wt.active_alerts()), "history": wt.history()}


def _scenario_burn(P, tmp_path):
    clock = [0.0]
    slo = P.observe.SLO("req_p95", "request_ms", threshold_ms=50.0, objective=0.95,
                        window_s=60.0, clock=lambda: clock[0])
    for _ in range(200):
        slo.observe(5.0)
    wt = P.watch.Watchtower(_StubTelemetry(P, slos=[slo]), interval_s=0.01,
                            fast_window_s=10.0, changepoint=False)
    out = [_edges(wt.tick())]
    clock[0] = 55.0
    for _ in range(30):
        slo.observe(500.0)
    out += [_edges(wt.tick()), _edges(wt.tick())]
    clock[0] = 120.0
    for _ in range(50):
        slo.observe(5.0)
    out.append(_edges(wt.tick()))
    return out, _tower_view(wt)


def _scenario_blip(P, tmp_path):
    clock = [0.0]
    slo = P.observe.SLO("req_p95", "request_ms", threshold_ms=50.0, objective=0.95,
                        window_s=600.0, clock=lambda: clock[0])
    for _ in range(3000):
        slo.observe(5.0)
    clock[0] = 550.0
    for _ in range(3):
        slo.observe(500.0)
    wt = P.watch.Watchtower(_StubTelemetry(P, slos=[slo]), interval_s=0.01,
                            fast_window_s=100.0, changepoint=False)
    return [_edges(wt.tick())], _tower_view(wt)


def _scenario_watermark(P, tmp_path):
    pool = _StubPool({"breakers_open": 0, "quarantined": 1, "unrouteable": 1,
                      "quarantined_urls": ["http://liar:8000"], "breaker_open_urls": []})
    sink = tmp_path / f"{P.name}_alerts.jsonl"
    wt = P.watch.Watchtower(_StubTelemetry(P, pools=[pool]), interval_s=0.01,
                            changepoint=False, sinks=(P.watch.JsonlSink(str(sink)),))
    out = [_edges(wt.tick()), _edges(wt.tick())]
    pool.gauges = dict(pool.gauges, quarantined=0, quarantined_urls=[])
    out.append(_edges(wt.tick()))
    return out, _tower_view(wt), sink.read_text()


def _scenario_shed(P, tmp_path):
    ctrl = _StubCtrl()
    wt = P.watch.Watchtower(_StubTelemetry(P, ctrls=[ctrl]), interval_s=0.01,
                            changepoint=False, shed_rate_watermark=0.5)
    out = [_edges(wt.tick())]
    for admitted, shed in ((10, 40), (80, 70), (180, 71)):
        ctrl.admitted, ctrl.shed = admitted, shed
        out.append(_edges(wt.tick()))
    return out, _tower_view(wt)


def _scenario_changepoint(P, tmp_path):
    clock = [0.0]
    sk = P.observe.WindowedSketch(window_s=60, subwindows=6,
                                  buckets=(1.0, 10.0, 100.0, 1000.0), clock=lambda: clock[0])
    flight = _StubFlight({"dominant": "pool:http://bad:1", "tail_count": 12,
                          "tail_share": 0.9, "baseline_count": 4, "baseline_share": 0.1})
    wt = P.watch.Watchtower(_StubTelemetry(P, windows={("request_ms", "http"): sk},
                                           flight=flight),
                            interval_s=0.01, fast_window_s=60.0, cusum_warmup=6,
                            min_stream_count=4)
    out = []
    for _ in range(8):
        for _ in range(6):
            sk.observe(5.0)
        out.append(_edges(wt.tick()))
    for _ in range(40):
        sk.observe(500.0)
    for _ in range(4):
        out.append(_edges(wt.tick()))
    return out, _tower_view(wt), flight.marks, wt.snapshot()["detectors"]


def _scenario_sick_sink(P, tmp_path):
    def bad_sink(alert):
        raise RuntimeError("sink down")

    pool = _StubPool({"breakers_open": 2, "quarantined": 0, "unrouteable": 2,
                      "quarantined_urls": [], "breaker_open_urls": ["a", "b"]})
    wt = P.watch.Watchtower(_StubTelemetry(P, pools=[pool]), interval_s=0.01,
                            changepoint=False, sinks=(bad_sink,))
    return [_edges(wt.tick())], _tower_view(wt)


SCENARIOS = {"burn": _scenario_burn, "blip": _scenario_blip, "watermark": _scenario_watermark,
             "shed": _scenario_shed, "changepoint": _scenario_changepoint,
             "sick_sink": _scenario_sick_sink}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watchtower_edges_equal_jax_s(tmp_path, fake_time, name):
    seen = {}
    for pkg, P in PKGS.items():
        fake_time(pkg)
        seen[pkg] = SCENARIOS[name](P, tmp_path)
    assert seen["port"] == seen["jax"]
    edges = [e for tick in seen["port"][0] for e in tick]
    if name == "blip":
        assert edges == []
        return
    assert edges and edges[0]["state"] == "firing"
    expected = {"burn": "slo:req_p95", "watermark": "gauge:pool.quarantined",
                "shed": "gauge:admission.shed_rate",
                "changepoint": "changepoint:request_ms:http:p99",
                "sick_sink": "gauge:pool.breakers_open"}[name]
    assert edges[0]["source"] == expected
    if name == "changepoint":
        assert edges[0]["evidence"]["moved"] == "pool:http://bad:1"
    if name in ("burn", "watermark", "shed"):
        assert edges[-1]["state"] == "resolved" and seen["port"][1]["active"] == []


def test_watchtower_black_box_drains_alike(tmp_path, fake_time):
    out = {}
    for pkg, P in PKGS.items():
        fake_time(pkg)
        path = tmp_path / f"{pkg}.bbx"
        rec = P.flight.FlightRecorder(rng=seeded(), baseline_ratio=1.0)
        tel = P.observe.Telemetry(sample="always", flight=rec)
        wt = P.watch.Watchtower(tel, interval_s=0.01, blackbox=str(path),
                                metrics_every_ticks=1)
        rec.commit(rec.begin("pool", "m"))
        wt.tick()
        wt.stop()
        rep = P.watch.read_blackbox(str(path))
        out[pkg] = ([r.kind for r in rep.records], rec._commit_tap is None,
                    tel.registry._drains == [],
                    P.watch.blackbox_report(str(path))["timelines_recovered"])
    assert out["port"] == out["jax"]
    kinds, tap_gone, drains_gone, timelines = out["port"]
    assert {"meta", "timeline", "metrics"} <= set(kinds) and tap_gone and drains_gone
    assert timelines == 1


def test_disabled_path_and_install_alike():
    for P in PKGS.values():
        rec = P.flight.FlightRecorder(rng=seeded(), baseline_ratio=1.0)
        assert rec._commit_tap is None
        assert rec.commit(rec.begin("pool", "m")) == "baseline"
        assert P.observe.MetricsRegistry()._drains == []
        assert P.watch.watchtower() is None
    assert port_watch.__all__ == jax_watch.__all__
    with pytest.raises(ValueError) as ours:
        port_watch.Watchtower(_StubTelemetry(PKGS["port"]), interval_s=0)
    with pytest.raises(ValueError) as theirs:
        jax_watch.Watchtower(_StubTelemetry(PKGS["jax"]), interval_s=0)
    assert str(ours.value) == str(theirs.value)


def test_enable_watchtower_installs_the_process_instance():
    tel = port_observe.Telemetry(sample="off")
    tower = port_watch.enable_watchtower(tel, interval_s=0.05)
    try:
        assert port_watch.watchtower() is tower
        assert tower.tick() == []
    finally:
        tower.stop()
        port_watch.install_watchtower(None)
    assert port_watch.watchtower() is None


# -- a client process killed with SIGKILL ---------------------------------------------
CHILD = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from client_tpu_torch import watch
from client_tpu_torch.flight import FlightRecorder
from client_tpu_torch.observe import Telemetry
import random
rec = FlightRecorder(rng=random.Random(1), baseline_ratio=1.0)
tel = Telemetry(sample="always", flight=rec)
wt = watch.Watchtower(tel, interval_s=60.0, blackbox={path!r}, metrics_every_ticks=1)
for i in range(5):
    rec.commit(rec.begin("pool", "m%d" % i))
wt.tick()
wt.blackbox.append("alert", {{"kind": "watermark", "source": "gauge:pool.quarantined",
                             "state": "firing"}})
print("WROTE", flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_killed_client_s_ring_is_reconstructed_by_both_doctors(tmp_path):
    path = tmp_path / "killed.bbx"
    proc = subprocess.run([sys.executable, "-c", CHILD.format(repo=str(REPO), path=str(path))],
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == -signal.SIGKILL and "WROTE" in proc.stdout, proc.stderr
    texts = {}
    for pkg in PKGS:
        out = subprocess.run([sys.executable, "-m", f"{PKGS[pkg].doctor.__name__}",
                              "--blackbox", str(path)], cwd=REPO, capture_output=True,
                             text=True, timeout=60, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr
        texts[pkg] = out.stdout
    assert texts["port"] == texts["jax"]
    doc = port_watch.blackbox_report(str(path))
    assert doc["ok"] and doc["timelines_recovered"] == 5
    assert doc["last_alert"]["source"] == "gauge:pool.quarantined" and doc["metrics"]
    assert port_doctor._render_blackbox(doc) == jax_doctor._render_blackbox(
        jax_watch.blackbox_report(str(path)))
