"""``client_tpu_torch.doctor`` against ``client_tpu.doctor``.

Each doctor probes a fresh fleet of the port's servers (two HTTP servers of
the default zoo on the CPU; the JAX package's clients speak to them, as the
2x2 matrix holds), with each of the snapshot's optional sections armed:
cells (one of them down), roles, a shard layout, the chain pipeline,
integrity and a watch window. The snapshots must have the same keys at
every level and the same anomaly flags. Values are not compared where
they are timings or depend on them; the keys whose values or sub-keys
are excluded are ``EXCLUDED`` below. Then: ``render_summary`` and the
``--blackbox`` rendering give JAX's text on the same document, the CLI's
exit codes (``--fail-on-anomaly`` included) are JAX's, the postmortem
bundle has JAX's keys and kind, and the arena, cache and tenancy sections
list the port's live objects (and only those).
"""

import json
import re
import socket
import sys

import pytest

import client_tpu.doctor as jax_doctor
import client_tpu.integrity as jax_integrity
import client_tpu.watch as jax_watch
import client_tpu_torch.doctor as port_doctor
import client_tpu_torch.integrity as port_integrity
import client_tpu_torch.watch as port_watch
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

DOCTORS = {"port": port_doctor, "jax": jax_doctor}
# keys whose sub-keys are data the run decides, not the snapshot's shape:
# - pipeline.dominant: keyed by the stage that took the most time in this run;
# - shm.server_regions.<url>.<family>: the device family is "cuda" on the
#   port's doctor and "tpu" on JAX's (a port server answers JAX's tpu status
#   call with an error entry), so the family's name and sub-keys are dropped.
# - shm.arena[].registration_cache: keyed by every endpoint a live arena of
#   this process registered with, fleets of earlier tests included;
# - anomalies[]: which entries exist is the flags' business (below), and an
#   entry's keys depend on its flag.
# - the process-wide sections (shm.local_inventory, shm.arena, cache,
#   tenancy, integrity.violations_by_url): the live objects and endpoints of
#   this process, other test files in the same worker included; their rows'
#   keys are held to JAX's in test_local_sections_list_the_port_s_live_objects.
EXCLUDED = ("pipeline/dominant", "shm/server_regions/*/*", "anomalies[]/*",
            "shm/local_inventory[]/*", "shm/arena[]/*", "cache[]/*", "tenancy[]/*",
            "integrity/violations_by_url/*")
# flags raised by timings of the run (latency against the fleet median,
# the dominant pipeline stage, clock skew, tail shifts, SLO latency, watch
# alerts on latency streams): not compared; every other flag is.
TIMING_FLAGS = {"load_latency_divergence", "pipeline_stage_hot", "clock_skew",
                "tail_divergence", "slo_breached", "changepoint", "alert_firing",
                "shm_churn_high"}
# values never compared (timings, clocks, counts of probes that ran under
# those clocks): everything but the keys, the anomaly flags and the fields
# named in test_snapshot_keys_and_flags_equal_jax_s.


@pytest.fixture
def fleet():
    """``make(n)``: n fresh port HTTP servers of the default zoo (urls)."""
    servers = []

    def make(n=2):
        made = [HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
                for _ in range(n)]
        servers.extend(made)
        return [s.url for s in made]

    yield make
    for s in servers:
        s.stop()


def _dead_url():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    url = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    return url


def _shape(x, urls, path=""):
    """The key paths of a snapshot, urls replaced by their index."""
    def name(k):
        k = str(k)
        for i, u in enumerate(urls):
            k = k.replace(u, f"<url{i}>")
        return k

    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            p = f"{path}/{name(k)}" if path else name(k)
            if any(re.fullmatch(re.escape(pat).replace(r"\*", "[^/]+"), p) for pat in EXCLUDED):
                continue
            out.add(p)
            out |= _shape(v, urls, p)
    elif isinstance(x, list):
        for v in x:
            out |= _shape(v, urls, path + "[]")
    return out


def _flags(snap, urls):
    out = []
    for f in snap["anomalies"]:
        if f["flag"] in TIMING_FLAGS:
            continue
        url = f.get("url")
        out.append((f["flag"], urls.index(url) if url in urls else url))
    return sorted(out, key=str)


def _args(case, urls, dead):
    return {
        "plain": (urls, {}),
        "cells": ([], {"cells": {"up": [urls[0]], "down": [dead]}}),
        "cells_spec": ([], {"cells": f"home={urls[0]};away={urls[1]}"}),
        "roles": ([], {"roles": {"prefill": [urls[0]], "decode": [urls[1]]}}),
        "shard": (urls, {"model": "batched_matmul", "shard_layout": "X=0->Y=0"}),
        "pipeline": (urls, {"pipeline": "chain", "pipeline_runs": 2}),
        "integrity": (urls, {"integrity": True}),
        "watch": (urls[:1], {"watch": 0.3}),
    }[case]


@pytest.mark.parametrize("case", ["plain", "cells", "cells_spec", "roles", "shard", "pipeline",
                                  "integrity", "watch"])
def test_snapshot_keys_and_flags_equal_jax_s(fleet, case, monkeypatch):
    # the integrity section reads the process-wide stats, which other test
    # files in this worker may have filled (violations_by_kind is keyed by
    # the kinds seen): each package's doctor reads fresh stats here
    for integrity in (jax_integrity, port_integrity):
        monkeypatch.setattr(integrity, "_GLOBAL_STATS", integrity.IntegrityStats())
    dead = _dead_url()
    snaps, urls_by = {}, {}
    for pkg, doctor in DOCTORS.items():
        urls = fleet(2)
        probe_urls, kw = _args(case, urls, dead)
        snaps[pkg] = doctor.collect_snapshot(probe_urls, requests_per_endpoint=2,
                                             probe_timeout_s=2.0, **kw)
        urls_by[pkg] = urls + [dead]
    shapes = {pkg: _shape(s, urls_by[pkg]) for pkg, s in snaps.items()}
    assert shapes["port"] == shapes["jax"], (sorted(shapes["port"] - shapes["jax"]),
                                             sorted(shapes["jax"] - shapes["port"]))
    assert _flags(snaps["port"], urls_by["port"]) == _flags(snaps["jax"], urls_by["jax"])
    port = snaps["port"]
    assert [(e.get("live"), e.get("ready")) for e in port["endpoints"]] == \
        [(e.get("live"), e.get("ready")) for e in snaps["jax"]["endpoints"]]
    assert set(port["shm"]["server_regions"][urls_by["port"][0]]) == {"system", "cuda"}
    if case == "cells":
        assert ("cell_down", "down") in _flags(port, urls_by["port"])
        cells = port["cells"][0]["cells"]
        assert cells["up"]["pool"]["available"] and not cells["down"]["pool"]["available"]
    if case == "roles":
        assert set(port["roles"]) == {"prefill", "decode"}
    if case in ("shard", "pipeline", "integrity", "watch"):
        assert {"shard": "shard", "pipeline": "pipeline", "integrity": "integrity",
                "watch": "watch"}[case] in port


def test_render_summary_equals_jax_s_on_the_same_snapshot(fleet):
    urls = fleet(2)
    dead = _dead_url()
    for kw in ({"cells": {"up": [urls[0]], "down": [dead]}},
               {"roles": {"prefill": [urls[0]], "decode": [urls[1]]}, "integrity": True}):
        for doctor in DOCTORS.values():
            snap = json.loads(json.dumps(doctor.collect_snapshot(
                [], requests_per_endpoint=2, probe_timeout_s=2.0, **kw), default=str))
            assert port_doctor.render_summary(snap) == jax_doctor.render_summary(snap)


def test_postmortem_bundle_has_jax_s_keys(fleet):
    bundles = {}
    for pkg, doctor in DOCTORS.items():
        urls = fleet(2)
        tel = doctor.Telemetry(sample="always", flight=True)
        snap = doctor.collect_snapshot(urls, requests_per_endpoint=2, probe_timeout_s=2.0,
                                       telemetry=tel, cells={"a": [urls[0]], "b": [urls[1]]})
        bundles[pkg] = doctor.postmortem_bundle(snap, tel)
    assert bundles["port"]["kind"] == bundles["jax"]["kind"] == "client_tpu_postmortem"
    assert set(bundles["port"]) == set(bundles["jax"])
    assert bundles["port"]["sections"] == bundles["jax"]["sections"]
    assert port_doctor.POSTMORTEM_SECTIONS == jax_doctor.POSTMORTEM_SECTIONS


def _ring(tmp_path):
    path = tmp_path / "ring.bbx"
    bb = port_watch.BlackBox(str(path), capacity_bytes=1 << 16)
    bb.append("meta", {"pid": 1, "started_unix": 1.5, "interval_s": 1.0, "seed": 0,
                       "version": 1})
    for i in range(3):
        bb.append("timeline", {"op": "infer", "model": f"m{i}", "verdict": "ok",
                               "events": []})
    bb.append("metrics", {"families": []})
    bb.append("alert", {"kind": "watermark", "severity": "ticket",
                        "source": "gauge:pool.quarantined", "state": "firing",
                        "fired_unix": 2.0, "resolved_unix": None, "evidence": {"value": 1}})
    bb.close()
    return path


def test_blackbox_text_equals_jax_s(tmp_path):
    path = _ring(tmp_path)
    docs = {"port": port_watch.blackbox_report(str(path)),
            "jax": jax_watch.blackbox_report(str(path))}
    assert docs["port"] == docs["jax"]
    assert port_doctor._render_blackbox(docs["port"]) == jax_doctor._render_blackbox(docs["jax"])


def _main(doctor, argv, capsys):
    try:
        rc = doctor.main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out


@pytest.mark.parametrize("case", ["no_urls", "healthy", "healthy_fail_on_anomaly",
                                  "down_cell", "down_cell_fail_on_anomaly", "blackbox",
                                  "blackbox_missing", "json"])
def test_cli_exit_codes_equal_jax_s(fleet, tmp_path, capsys, case):
    rcs = {}
    for pkg, doctor in DOCTORS.items():
        urls = fleet(2)
        argv = {"no_urls": [],
                "healthy": urls,
                "healthy_fail_on_anomaly": urls + ["--fail-on-anomaly", "--json",
                                                   str(tmp_path / f"{pkg}.json")],
                "down_cell": ["--cells", f"up={urls[0]};down={_dead_url()}"],
                "down_cell_fail_on_anomaly": ["--cells", f"up={urls[0]};down={_dead_url()}",
                                              "--fail-on-anomaly"],
                "blackbox": ["--blackbox", str(_ring(tmp_path))],
                "blackbox_missing": ["--blackbox", str(tmp_path / "missing.bbx")],
                "json": urls + ["--json", str(tmp_path / f"{pkg}.json")]}[case]
        argv += ["--requests", "2", "--timeout", "2"] if argv and "--blackbox" not in argv else []
        rcs[pkg], out = _main(doctor, argv, capsys)
        if case == "healthy_fail_on_anomaly":
            # a healthy fleet may still raise a timing flag (a probe slower
            # than the fleet median): the exit code follows the snapshot
            flagged = json.loads((tmp_path / f"{pkg}.json").read_text())["anomalies"]
            assert rcs[pkg] == (1 if flagged else 0)
            assert {f["flag"] for f in flagged} <= TIMING_FLAGS
            rcs[pkg] = 0
        if case == "json":
            assert set(json.loads((tmp_path / f"{pkg}.json").read_text())) >= {"endpoints",
                                                                              "anomalies"}
        if case.startswith("down_cell"):
            assert "cell_down" in out
    assert rcs["port"] == rcs["jax"]
    assert rcs["port"] == {"no_urls": 2, "healthy": 0, "healthy_fail_on_anomaly": 0,
                           "down_cell": 0, "down_cell_fail_on_anomaly": 1, "blackbox": 0,
                           "blackbox_missing": 1, "json": 0}[case]


def test_local_sections_list_the_port_s_live_objects(fleet, monkeypatch):
    """The arena, cache and tenancy sections read the port's registries by
    name: non-empty while the port's objects live, and blind to the JAX
    package's."""
    import client_tpu.arena as jax_arena
    from client_tpu_torch.arena import ShmArena, arenas
    from client_tpu_torch.cache import ResponseCache, caches
    from client_tpu_torch.tenancy import parse_tenancy_spec, policies

    urls = fleet(1)
    before = port_doctor.collect_snapshot(urls, requests_per_endpoint=1, probe_timeout_s=2.0)
    arena = ShmArena(device="cpu")
    cache = ResponseCache()
    policy = parse_tenancy_spec("t0,rate=5")
    jax_side = jax_arena.ShmArena()
    try:
        snap = port_doctor.collect_snapshot(urls, requests_per_endpoint=1, probe_timeout_s=2.0)
        # the registries are weak sets in no set order, and arenas of earlier
        # tests may still live with registrations of their own: hold the row
        # of each package's fresh arena
        with monkeypatch.context() as m:
            m.setattr(sys.modules["client_tpu_torch.arena"], "arenas", lambda: [arena])
            m.setattr(jax_arena, "arenas", lambda: [jax_side])
            ours, theirs = port_doctor._arena_status(), jax_doctor._arena_status()
        assert {k: set(v) if isinstance(v, dict) else None for k, v in ours[-1].items()} == \
            {k: set(v) if isinstance(v, dict) else None for k, v in theirs[-1].items()}
        assert len(snap["shm"]["arena"]) == len(arenas()) >= 1
        assert len(snap["cache"]) == len(caches()) >= 1
        assert len(snap["tenancy"]) == len(policies()) >= 1
        # the cache stages its entries in an arena of its own too
        assert len(snap["shm"]["arena"]) >= len(before["shm"]["arena"]) + 1
        assert len(snap["cache"]) == len(before["cache"]) + 1
        assert len(snap["tenancy"]) == len(before["tenancy"]) + 1
    finally:
        arena.close()
        jax_side.close()
        del cache, policy
