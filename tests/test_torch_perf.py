"""``client_tpu_torch.perf`` against ``client_tpu.perf``.

The port's ``PerfRunner`` beside the JAX package's on the same requests: the
closed loop, the open loop (constant and poisson arrivals) and the replay of
a seeded trace, in the shared-memory modes none, system and cuda (the JAX
runner's tpu). Each port row runs against both packages' servers; the JAX
runner runs against the JAX server (its tpu family has no route on the
port's servers). The rows must have the JAX rows' keys at every level, the
same completed counts and zero errors; the ``client_shm`` sub-row's region
and registration counts must be equal. The routing and serving flags (the
pool over both packages' HTTP servers, hedging, routing, admission with
tenancy, endpoint limits, affinity, coalescing, the cache and singleflight)
run in both runners, from ``PerfRunner`` and from the CLI, and a
tenant-attributed trace replays with per-tenant rows. The orchestration
flags run in both runners over each package's zoo servers: ``--shard-layout``
scatters closed-loop infers, and ``sharded``, ``prefill_decode`` and
``pipeline`` records replay through the shard layout, ``--roles`` and
``--pipeline``. The federation flags (``--cells``, ``--home-cell``,
``--shadow-cell``, ``--canary-cell``) run in both runners over cells of the
two packages' servers, and ``--watch`` over the port's server, with the
``client_federation`` / ``client_watch`` blocks' keys equal. The native
protocols (the C++ clients of ``client_tpu_torch.native``) run against the
port's servers with their transport's row keys, and ``python -m
client_tpu_torch.perf -f json`` prints rows that parse.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from client_tpu import perf as jax_perf
from client_tpu import trace as jax_trace
from client_tpu.models import simple as jax_simple
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.models.generate import TinyGenerateModel as JaxGenerate
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import perf as port_perf
from client_tpu_torch import trace as port_trace
from client_tpu_torch.models import (
    AddSubModel,
    IdentityModel,
    SequenceAccumulatorModel,
    TinyDecoderModel,
    TinyGenerateModel,
)
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

REPO = Path(__file__).resolve().parent.parent
SHAPE = {"INPUT0": [1, 256]}
# the port's mode, the JAX runner's mode
MODES = {"none": "none", "system": "system", "cuda": "tpu"}


def _port_models():
    decoder = TinyDecoderModel(device="cpu")
    return [AddSubModel(device="cpu"), IdentityModel("identity_fp32", "FP32", device="cpu"),
            SequenceAccumulatorModel(), decoder, TinyGenerateModel(decoder=decoder)]


def _jax_models():
    decoder = JaxDecoder()
    return [jax_simple.AddSubModel(), jax_simple.IdentityModel("identity_fp32", "FP32"),
            jax_simple.SequenceAccumulatorModel(), decoder, JaxGenerate(decoder=decoder)]


@pytest.fixture(scope="module")
def servers():
    port_core = ServerCore(_port_models(), device="cpu")
    jax_core = JaxCore(_jax_models())
    made = {("port", "http"): HttpInferenceServer(port_core).start(),
            ("port", "grpc"): GrpcInferenceServer(port_core).start(),
            ("jax", "http"): JaxHttpServer(jax_core).start(),
            ("jax", "grpc"): JaxGrpcServer(jax_core).start()}
    yield made
    for server in made.values():
        server.stop()


@pytest.fixture(scope="module")
def zoo_servers():
    """Two HTTP servers of each package's default zoo: {package: [url, url]}."""
    from client_tpu.models import default_model_zoo as jax_zoo
    from client_tpu_torch.models import default_model_zoo

    made = {"port": [HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
                     for _ in range(2)],
            "jax": [JaxHttpServer(JaxCore(jax_zoo())).start() for _ in range(2)]}
    yield {pkg: [s.url for s in svs] for pkg, svs in made.items()}
    for svs in made.values():
        for server in svs:
            server.stop()


# the orchestration records' spec per kind, and the runner kwargs that replay them
A8A_RECORDS = {
    "sharded": lambda urls: {"endpoints": urls, "shard_layout": "TOKENS=0->LOGITS=0,NEXT_TOKEN=0"},
    "prefill_decode": lambda urls: {"roles": f"prefill={urls[0]};decode={urls[1]}"},
    "pipeline": lambda urls: {"pipeline": "chain"},
}


def _a8a_replay(zoo_servers, spec, kind):
    """The spec's trace replayed by both runners, each over its own package's
    zoo servers. ``sharded`` records name their default model,
    ``decoder_lm_tp_prefill`` (tp = 4 over the CPU's mesh entries in the
    port's zoo)."""
    rows = {}
    for pkg, mod, trace_mod in (("port", port_perf, port_trace), ("jax", jax_perf, jax_trace)):
        urls = zoo_servers[pkg]
        trace = trace_mod.generate(spec, seed=0)
        assert all(rec.model == "decoder_lm_tp_prefill"
                   for rec in trace.records if rec.kind == "sharded")
        runner = _runner(mod, urls[0], "http", "simple", "none", **A8A_RECORDS[kind](urls))
        try:
            rows[pkg] = runner.run_trace(trace, speed=4.0, replay_workers=4)
        finally:
            _close(runner)
    return rows


def _keys(row, depth=2):
    """The row's keys and its sub-rows' keys (values dropped). Deeper
    levels may be None or a dict by the run: a flight recorder's commit
    costs are None when it retained no request."""
    if depth and isinstance(row, dict):
        return {k: _keys(v, depth - 1) for k, v in row.items()}
    if depth and isinstance(row, list) and row and isinstance(row[0], dict):
        return [_keys(v, depth - 1) for v in row]
    return None


def _runner(mod, url, protocol, model, mode, **kw):
    if mod is port_perf:
        kw["device"] = "cpu"
    shapes = SHAPE if model == "identity_fp32" else None
    return mod.PerfRunner(url, protocol, model, mode, shapes, **kw)


def _close(runner):
    arena = runner._arena
    runner.close()
    if arena is not None:
        arena.close(force=True)


SHM_COUNTS = ("regions_created", "regions_destroyed", "regions_registered",
              "regions_unregistered", "map_writes", "map_reads")
ARENA_COUNTS = ("leases", "hits", "misses", "registrations_issued", "leased_bytes", "regions")


def _counts(row, server_maps=True):
    """The row's counts. ``server_maps=False`` leaves out the map reads and
    writes, which count a server in this process too: a JAX server's cuda
    reads land in the JAX package's recorder, not the port's."""
    shm = row.get("client_shm")
    keys = SHM_COUNTS if server_maps else SHM_COUNTS[:4]
    return {
        "requests": row["requests"], "errors": row["errors"], "shed": row["shed"],
        "issued": row.get("issued"),
        "shm": None if shm is None else (
            {k: shm[k] for k in keys}, {k: shm["arena"][k] for k in ARENA_COUNTS}),
    }


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_closed_and_open_loop_rows(servers, protocol, server, mode):
    """Closed loop at concurrency 1 and 2, then a constant and a poisson
    rate: the port's rows beside the JAX runner's, run for run."""
    rows = {}
    for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
        where = server if pkg == "port" else "jax"
        runner = _runner(mod, servers[(where, protocol)].url, protocol, "identity_fp32",
                         mode if pkg == "port" else MODES[mode], validate=True)
        try:
            rows[pkg] = [runner.run(1, 12), runner.run(2, 12),
                         runner.run_rate(400.0, 10, "constant", pool_size=4),
                         runner.run_rate(400.0, 10, "poisson", pool_size=4)]
        finally:
            _close(runner)
    for port_row, jax_row in zip(rows["port"], rows["jax"]):
        assert _keys(port_row) == _keys(jax_row)
        assert port_row["errors"] == 0, port_row["error_sample"]
        assert port_row["client_integrity"]["violations"] == 0
    closed1, closed2, const, poisson = rows["port"]
    assert closed1["requests"] == 12
    assert 12 <= closed2["requests"] <= 13
    assert const["requests"] == const["issued"] == poisson["requests"] == 10
    # the counts at concurrency 1 and in the open loop are exact, and equal
    # the device family's server-side maps reach the runner's recorder only
    # when the server is of the runner's package
    server_maps = not (server == "jax" and mode == "cuda")
    for i in (0, 2, 3):
        assert (_counts(rows["port"][i], server_maps)
                == _counts(rows["jax"][i], server_maps))
    if mode == "none":
        assert "client_shm" not in closed1
    else:
        fam = closed1["client_shm"]
        assert fam["family"] == mode
        # a cold arena: one region for the one size class the input and
        # the output share (4 KiB slabs), one registration, then only
        # cache hits
        assert fam["regions_created"] == fam["regions_registered"] == 1
        assert fam["arena"]["misses"] == 1
        assert closed2["client_shm"]["regions_created"] == 0
        assert closed2["client_shm"]["arena"]["hit_rate"] == 1.0
        assert fam["arena"]["leased_bytes"] == 0


@pytest.mark.parametrize("observe, flight", [(True, False), (False, True), (True, True)])
def test_observe_and_flight_rows(servers, observe, flight):
    rows = {}
    for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
        where = "port" if pkg == "port" else "jax"
        runner = _runner(mod, servers[(where, "http")].url, "http", "simple", "none",
                         observe=observe, flight=flight)
        try:
            rows[pkg] = runner.run(1, 8)
        finally:
            _close(runner)
    assert _keys(rows["port"]) == _keys(rows["jax"])
    assert rows["port"]["requests"] == rows["jax"]["requests"] == 8
    if flight:
        assert rows["port"]["client_flight"]["requests"] == 8


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_retries_and_clean_chaos_rows(servers, protocol):
    rows = {}
    for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
        where = "port" if pkg == "port" else "jax"
        runner = _runner(mod, servers[(where, protocol)].url, protocol, "simple", "none",
                         retries=2, chaos="none")
        try:
            assert runner.url != runner._direct_url  # measured through the proxy
            rows[pkg] = runner.run(2, 10)
        finally:
            _close(runner)
    assert _keys(rows["port"]) == _keys(rows["jax"])
    assert rows["port"]["errors"] == 0, rows["port"]["error_sample"]
    assert rows["port"]["requests"] >= 10


def test_generate_stream_rows(servers):
    rows = {}
    for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
        where = "port" if pkg == "port" else "jax"
        runner = _runner(mod, servers[(where, "http")].url, "http", "tiny_lm_generate",
                         "none", generate_stream=True, stream_prompt_tokens=4,
                         stream_output_tokens=3, observe=True)
        try:
            rows[pkg] = runner.run(1, 3)
        finally:
            _close(runner)
    assert _keys(rows["port"]) == _keys(rows["jax"])
    assert rows["port"]["requests"] == 3 and rows["port"]["errors"] == 0
    assert "client_stream_ms" in rows["port"]


REPLAY_SPEC = ("mixed:duration_s=1,rate=16,stream_fraction=0.25,seq_fraction=0.2,"
               "output_mean=3,max_output=4,max_prompt=8")


@pytest.mark.parametrize("server", ["port", "jax"])
def test_trace_replay_rows(servers, server):
    """The same seeded trace replayed by both runners: equal kinds and
    counts, zero errors, the same sequence groups, SLO rows of the same
    keys."""
    rows = {}
    for pkg, mod, tmod in (("port", port_perf, port_trace), ("jax", jax_perf, jax_trace)):
        where = server if pkg == "port" else "jax"
        tr = tmod.generate(REPLAY_SPEC, seed=0)
        runner = _runner(mod, servers[(where, "http")].url, "http", "simple", "none")
        try:
            rows[pkg] = runner.run_trace(tr, speed=4.0, replay_workers=8,
                                         slos=["p99<5000ms", "error_rate<1%"])
        finally:
            _close(runner)
    port, ref = rows["port"], rows["jax"]
    assert _keys(port) == _keys(ref)
    assert port["errors"] == 0, port["error_sample"]
    for key in ("requests", "issued", "sequence_groups"):
        assert port[key] == ref[key]
    assert port["trace"] == ref["trace"]
    assert {k: (v["requests"], v["ok"]) for k, v in port["kinds"].items()} == \
        {k: (v["requests"], v["ok"]) for k, v in ref["kinds"].items()}
    assert [row["slo"] for row in port["slo"]] == [row["slo"] for row in ref["slo"]]


def test_trace_replay_over_grpc(servers):
    tr = port_trace.generate("mixed:duration_s=1,rate=16,stream_fraction=0,seq_fraction=0.3",
                             seed=1)
    runner = _runner(port_perf, servers[("port", "grpc")].url, "grpc", "simple", "none")
    try:
        row = runner.run_trace(tr, speed=4.0, replay_workers=8)
    finally:
        _close(runner)
    assert row["errors"] == 0 and row["requests"] == len(tr.records)


def test_run_trace_rejects_bad_inputs():
    runner = port_perf.PerfRunner.__new__(port_perf.PerfRunner)  # no server needed
    runner.protocol = "grpc"
    runner.shared_memory = "none"
    with pytest.raises(ValueError, match="empty trace"):
        port_perf.PerfRunner.run_trace(runner, [])
    stream_rec = port_trace.TraceRecord(
        at_s=0.0, kind="generate_stream", model="m", prompt_tokens=4, output_tokens=2)
    with pytest.raises(ValueError, match="HTTP SSE"):
        port_perf.PerfRunner.run_trace(runner, [stream_rec])
    runner.protocol = "http"
    runner.shared_memory = "cuda"
    with pytest.raises(ValueError, match="shared-memory none"):
        port_perf.PerfRunner.run_trace(runner, [stream_rec])
    runner.shared_memory = "none"
    with pytest.raises(ValueError, match="speed"):
        port_perf.PerfRunner.run_trace(runner, [stream_rec], speed=0.0)


@pytest.mark.parametrize("spec, item", [
    ("sharded:duration_s=1,rate=5", "A8"),
    ("mixed:duration_s=1,rate=20,disagg_fraction=0.5", "A8"),
    ("mixed:duration_s=1,rate=20,pipeline_fraction=0.5", "A8"),
    ("multi_tenant:duration_s=1,rate=5", "A7"),
])
def test_unported_record_kinds_raise(servers, zoo_servers, spec, item):
    if item == "A8":
        # ported: each kind replays through its layer in both runners
        kind = {"sharded": "sharded", "mixed": None}[spec.split(":")[0]] or (
            "prefill_decode" if "disagg_fraction" in spec else "pipeline")
        rows = _a8a_replay(zoo_servers, spec, kind)
        assert _keys(rows["port"]) == _keys(rows["jax"])
        assert rows["port"]["errors"] == 0, rows["port"]["error_sample"]
        assert rows["jax"]["errors"] == 0, rows["jax"]["error_sample"]
        ok = {pkg: row["kinds"][kind]["ok"] for pkg, row in rows.items()}
        assert ok["port"] == ok["jax"] > 0
        assert rows["port"]["issued"] == rows["jax"]["issued"]
        if kind == "pipeline":
            assert rows["port"]["pipeline_stages"].keys() == rows["jax"]["pipeline_stages"].keys()
        return
    if item == "A7":
        # ported: the tenant-attributed records replay through tenant=
        rows = {}
        for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
            runner = _runner(mod, servers[("port", "http")].url, "http", "simple", "none")
            try:
                trace = (port_trace if mod is port_perf else jax_trace).generate(spec, seed=0)
                rows[pkg] = runner.run_trace(trace, speed=4.0, replay_workers=4)
            finally:
                _close(runner)
        assert _keys(rows["port"]) == _keys(rows["jax"])
        port_tenants = {t: (r["issued"], r["ok"]) for t, r in rows["port"]["tenants"].items()}
        assert port_tenants == {t: (r["issued"], r["ok"])
                                for t, r in rows["jax"]["tenants"].items()}
        assert rows["port"]["errors"] == 0, rows["port"]["error_sample"]
        assert sum(n for n, _ in port_tenants.values()) == rows["port"]["issued"]
        return
    runner = port_perf.PerfRunner.__new__(port_perf.PerfRunner)
    runner.protocol = "http"
    runner.shared_memory = "none"
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        port_perf.PerfRunner.run_trace(runner, port_trace.generate(spec, seed=0))


UNPORTED = [
    ({"endpoints": ["127.0.0.1:1"]}, "--endpoints", "A7"),
    ({"hedge": True}, "--hedge", "A7"),
    ({"hedge_delay_s": 0.01}, "--hedge", "A7"),
    ({"routing": "least_outstanding"}, "--routing", "A7"),
    ({"admission": True}, "--admission", "A7"),
    ({"tenancy": "t0,rate=5"}, "--tenancy", "A7"),
    ({"endpoint_limits": True}, "--endpoint-limits", "A7"),
    ({"affinity_key": "worker"}, "--affinity-key", "A7"),
    ({"coalesce": True}, "--coalesce", "A7"),
    ({"cache": True}, "--cache", "A7"),
    ({"singleflight": True}, "--singleflight", "A7"),
    ({"cells": {"a": ["127.0.0.1:1"]}}, "--cells", "A8"),
    ({"home_cell": "a"}, "--home-cell", "A8"),
    ({"shadow_cell": "a"}, "--shadow-cell", "A8"),
    ({"canary_cell": "a"}, "--canary-cell", "A8"),
    ({"shard_layout": "X=0->Y=0"}, "--shard-layout", "A8"),
    ({"roles": "prefill=u1;decode=u2"}, "--roles", "A8"),
    ({"pipeline": "chain"}, "--pipeline", "A8"),
    ({"watch": True}, "--watch", "A8"),
    ({"protocol": "native"}, "-i native", "A10"),
    ({"protocol": "native-grpc"}, "-i native-grpc", "A10"),
    ({"protocol": "native-grpc-async"}, "-i native-grpc-async", "A10"),
]


# what each routing and serving flag needs beside it, and the row's block
A7_NEEDS = {
    "--endpoints": ({}, None),
    "--hedge": ({"hedge": True}, None),
    "--routing": ({}, None),
    "--admission": ({}, "client_admission"),
    "--tenancy": ({"admission": True}, "client_admission"),
    "--endpoint-limits": ({}, None),
    "--affinity-key": ({"routing": "affinity"}, None),
    "--coalesce": ({}, "client_batch"),
    "--cache": ({}, "client_cache"),
    "--singleflight": ({}, "client_cache"),
}
POOL_FREE = ("--coalesce", "--cache", "--singleflight")


def _a7_kwargs(servers, kwargs, flag):
    """The flag with what it needs: a pool over the port's and the JAX
    package's HTTP servers for the pool flags."""
    kw = dict(kwargs, **A7_NEEDS[flag][0])
    if flag not in POOL_FREE:
        kw["endpoints"] = [servers[("port", "http")].url, servers[("jax", "http")].url]
    return kw


def _a7_rows(servers, kwargs, flag):
    rows = {}
    for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
        runner = _runner(mod, servers[("port", "http")].url, "http", "simple", "none",
                         **_a7_kwargs(servers, kwargs, flag))
        try:
            rows[pkg] = runner.run(1, 10)
        finally:
            _close(runner)
    return rows


FEDERATION_FLAGS = ("--cells", "--home-cell", "--shadow-cell", "--canary-cell", "--watch")


def _a8b_kwargs(servers, kwargs, flag):
    """The flag with what it needs: cells ``a`` (the port's HTTP server) and
    ``b`` (the JAX package's), the named cell being ``b``."""
    if flag == "--watch":
        return dict(kwargs)
    cells = {"a": [servers[("port", "http")].url], "b": [servers[("jax", "http")].url]}
    named = {k: "b" for k in kwargs if k.endswith("_cell")}
    # one outcome per canary request decides the verdict here
    extra = {"canary_weight": 0.5, "canary_min_events": 1000} if "canary_cell" in named else {}
    return dict(cells=cells, **named, **extra)


def _a8b_rows(servers, kwargs, flag):
    rows = {}
    for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
        runner = _runner(mod, servers[("port", "http")].url, "http", "simple", "none",
                         **_a8b_kwargs(servers, kwargs, flag))
        try:
            rows[pkg] = runner.run(1, 10)
        finally:
            _close(runner)
    return rows


@pytest.mark.parametrize("kwargs, flag, item", UNPORTED, ids=[u[1] + str(i)
                                                                for i, u in enumerate(UNPORTED)])
def test_unported_flags_raise_naming_their_item(servers, zoo_servers, kwargs, flag, item):
    if flag in FEDERATION_FLAGS:
        # ported: the flag runs in both runners and its block has JAX's keys
        rows = _a8b_rows(servers, kwargs, flag)
        assert _keys(rows["port"], 1) == _keys(rows["jax"], 1)
        assert rows["port"]["requests"] == rows["jax"]["requests"] == 10
        assert rows["port"]["errors"] == 0, rows["port"]["error_sample"]
        block = "client_watch" if flag == "--watch" else "client_federation"
        assert _keys(rows["port"][block]) == _keys(rows["jax"][block])
        if block == "client_federation":
            fed = {pkg: row[block] for pkg, row in rows.items()}
            assert fed["port"]["home"] == fed["jax"]["home"]
            assert fed["port"]["order"] == fed["jax"]["order"]
            assert fed["port"]["spills"] == fed["jax"]["spills"] == 0
            if flag == "--shadow-cell":
                assert fed["port"]["shadow"]["cell"] == "b"
            if flag == "--canary-cell":
                assert fed["port"]["canary"]["cell"] == "b"
        else:
            assert rows["port"][block]["ticks"] >= 1
        return
    if flag in ("--shard-layout", "--roles", "--pipeline"):
        # ported: the flag runs in both runners over each package's zoo
        rows, runners = {}, {}
        for pkg, mod in (("port", port_perf), ("jax", jax_perf)):
            urls = zoo_servers[pkg]
            if flag == "--shard-layout":
                kw = dict(kwargs, endpoints=urls, shape_overrides={"X": [4, 64]})
                runner = mod.PerfRunner(urls[0], "http", "batched_matmul",
                                        **kw, **({"device": "cpu"} if mod is port_perf else {}))
            else:
                kw = ({"roles": f"prefill={urls[0]};decode={urls[1]}"} if flag == "--roles"
                      else kwargs)
                runner = _runner(mod, urls[0], "http", "simple", "none", **kw)
            try:
                rows[pkg] = runner.run(1, 10)
                runners[pkg] = runner
            finally:
                _close(runner)
        assert _keys(rows["port"], 1) == _keys(rows["jax"], 1)
        assert rows["port"]["requests"] == rows["jax"]["requests"] == 10
        assert rows["port"]["errors"] == 0, rows["port"]["error_sample"]
        if flag == "--roles":
            assert list(runners["port"].roles) == list(runners["jax"].roles) == ["prefill", "decode"]
        if flag == "--pipeline":
            assert runners["port"].pipeline.describe() == runners["jax"].pipeline.describe()
        if flag == "--shard-layout":
            ours, theirs = (runners[pkg].shard_layout.describe() for pkg in ("port", "jax"))
            assert dict(ours, endpoints=None) == dict(theirs, endpoints=None)
            assert ours["endpoints"] == zoo_servers["port"]
        return
    if item == "A7":
        # ported: the flag runs in both runners and counts the same requests
        rows = _a7_rows(servers, kwargs, flag)
        assert _keys(rows["port"], 1) == _keys(rows["jax"], 1)
        assert rows["port"]["requests"] == rows["jax"]["requests"] == 10
        assert rows["port"]["errors"] == 0, rows["port"]["error_sample"]
        block = A7_NEEDS[flag][1]
        if block is not None:
            assert _keys(rows["port"][block]) == _keys(rows["jax"][block])
        if block == "client_cache":
            assert rows["port"]["client_cache"] == rows["jax"]["client_cache"]
        return
    # ported (A10): the native protocol runs against the port's server, its
    # rows with the keys of its transport's python protocol, in each data
    # plane it takes (none, and cuda but for the async client)
    assert item == "A10"
    protocol = kwargs["protocol"]
    transport = "http" if protocol == "native" else "grpc"
    url = servers[("port", transport)].url
    for mode in ("none",) if protocol == "native-grpc-async" else ("none", "cuda"):
        rows = {}
        for name in (protocol, transport):
            runner = _runner(port_perf, url, name, "identity_fp32", mode)
            try:
                rows[name] = runner.run(1, 10)
            finally:
                _close(runner)
        assert _keys(rows[protocol], 1) == _keys(rows[transport], 1)
        assert rows[protocol]["requests"] == 10
        assert rows[protocol]["errors"] == 0, rows[protocol]["error_sample"]


@pytest.mark.parametrize("flag", ["--shard-layout", "--roles", "--pipeline"])
def test_orchestration_cli_flags_run(zoo_servers, capsys, flag):
    """``python -m client_tpu_torch.perf`` with each orchestration flag: the
    shard layout on a closed loop, roles and the chain pipeline on a replay
    of their record kind."""
    a, b = zoo_servers["port"]
    argv = ["-u", a, "--warmup-requests", "0", "-f", "json"]
    if flag == "--shard-layout":
        argv += ["-m", "batched_matmul", "--endpoints", f"{a},{b}", "--shape", "X:4,64",
                 "--measurement-requests", "6", flag, "X=0->Y=0"]
        kind = None
    else:
        fraction = "disagg_fraction" if flag == "--roles" else "pipeline_fraction"
        argv += ["-m", "simple", "--trace-gen",
                 f"mixed:duration_s=1,rate=10,stream_fraction=0,seq_fraction=0,{fraction}=1.0",
                 "--speed", "4", "--replay-workers", "4",
                 flag, f"prefill={a};decode={b}" if flag == "--roles" else "chain"]
        kind = "prefill_decode" if flag == "--roles" else "pipeline"
    assert port_perf.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    row = out[0] if isinstance(out, list) else out
    assert row["errors"] == 0, row["error_sample"]
    if kind is None:
        assert row["requests"] == 6
    else:
        assert row["kinds"][kind]["ok"] == row["issued"] > 0


@pytest.mark.parametrize("flag", ["--admission", "--coalesce", "--watch", "--cache",
                                  "--hedge", "--singleflight", "--endpoint-limits"])
def test_unported_cli_switches_raise(servers, capsys, flag):
    # ported: the switch runs from the CLI and its row carries the layer
    argv = ["-m", "simple", "-u", servers[("port", "http")].url, "--concurrency-range", "1",
            "--measurement-requests", "6", "--warmup-requests", "0", "-f", "json", flag]
    if flag not in POOL_FREE + ("--watch",):
        argv += ["--endpoints", ",".join(_a7_kwargs(servers, {}, flag)["endpoints"])]
    assert port_perf.main(argv) == 0
    (row,) = json.loads(capsys.readouterr().out)
    assert row["requests"] == 6 and row["errors"] == 0, row["error_sample"]
    block = "client_watch" if flag == "--watch" else A7_NEEDS[flag][1]
    assert block is None or block in row


@pytest.mark.parametrize("flag", ["--cells", "--home-cell", "--shadow-cell", "--canary-cell"])
def test_federation_cli_flags_run(servers, capsys, flag):
    """``python -m client_tpu_torch.perf --cells ...`` with each cell flag:
    the row's ``client_federation`` block names the cells, and the named
    cell is the one the flag armed."""
    a, b = servers[("port", "http")].url, servers[("jax", "http")].url
    argv = ["-m", "simple", "-u", a, "--concurrency-range", "1", "--measurement-requests",
            "6", "--warmup-requests", "0", "-f", "json", "--cells", f"a={a};b={b}"]
    if flag != "--cells":
        argv += [flag, "b"]
    assert port_perf.main(argv) == 0
    (row,) = json.loads(capsys.readouterr().out)
    assert row["requests"] == 6 and row["errors"] == 0, row["error_sample"]
    fed = row["client_federation"]
    assert set(fed["cells"]) == {"a", "b"} and fed["spills"] == 0
    assert fed["home"] == ("b" if flag == "--home-cell" else "a")
    if flag == "--shadow-cell":
        assert fed["shadow"]["cell"] == "b"
    if flag == "--canary-cell":
        assert fed["canary"]["cell"] == "b"


def test_cells_validation_messages_equal_jax_s():
    """The ``--cells`` checks raise JAX's messages before any connection."""
    cases = [
        {"cells": {"a": ["127.0.0.1:1"]}, "endpoints": ["127.0.0.1:1"]},
        {"cells": {"a": ["127.0.0.1:1"]}, "shared_memory": "system"},
        {"cells": {"a": ["127.0.0.1:1"]}, "chaos": "none"},
        {"cells": {"a": ["127.0.0.1:1"]}, "coalesce": True},
        {"cells": {"a": ["127.0.0.1:1"]}, "home_cell": "z"},
        {"home_cell": "a"},
        {"routing": "least_outstanding"},
        {"cells": "a=127.0.0.1:1;a=127.0.0.1:2"},
    ]
    for kw in cases:
        msgs = []
        for mod in (port_perf, jax_perf):
            with pytest.raises(ValueError) as exc:
                mod.PerfRunner("127.0.0.1:1", **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1], kw


def test_shared_memory_modes_are_the_port_s(capsys):
    with pytest.raises(ValueError, match="none\\|system\\|cuda"):
        port_perf.PerfRunner("127.0.0.1:1", shared_memory="tpu")
    with pytest.raises(SystemExit):
        port_perf.main(["-m", "simple", "--shared-memory", "tpu"])
    assert "choose from none, system, cuda" in capsys.readouterr().err


def test_generate_stream_needs_http_and_no_shm():
    with pytest.raises(ValueError, match="http protocol"):
        port_perf.PerfRunner("127.0.0.1:1", "grpc", generate_stream=True)
    with pytest.raises(ValueError, match="shared-memory none"):
        port_perf.PerfRunner("127.0.0.1:1", "http", shared_memory="cuda",
                             generate_stream=True)


@pytest.mark.parametrize("spec", ["latency:0.001", "reset:10", "stall:5", "flap:3",
                                  "blackhole", "none", ""])
def test_chaos_specs_parse_as_jax(spec):
    port, ref = port_perf._parse_chaos_fault(spec), jax_perf._parse_chaos_fault(spec)
    if ref is None:
        assert port is None
    else:
        assert (port.kind, port.after_bytes, port.every) == (ref.kind, ref.after_bytes, ref.every)


def test_cli_json_rows_parse(servers, capsys):
    url = servers[("port", "http")].url
    rc = port_perf.main(["-m", "identity_fp32", "-u", url, "--shape", "INPUT0:1,64",
                         "--concurrency-range", "1:2", "--measurement-requests", "6",
                         "--warmup-requests", "2", "--shared-memory", "cuda",
                         "--device", "cpu", "-f", "json"])
    rows = json.loads(capsys.readouterr().out)
    assert rc == 0 and [r["concurrency"] for r in rows] == [1, 2]
    assert all(r["errors"] == 0 and r["client_shm"]["family"] == "cuda" for r in rows)


@pytest.mark.parametrize("cli", [True, False])
def test_cuda_host_window_for_another_process(servers, monkeypatch, capsys, cli):
    """The CLI's server is another process, which reads a cuda region's host
    window: the CLI's slabs carry each staged input there. A runner's
    default colocated slabs leave the window unwritten, for a server in its
    own process that takes the staged tensor."""
    from client_tpu_torch.arena import ArenaLease

    windows = []
    write_torch = ArenaLease.write_torch

    def recorded(lease, tensor, *args, **kwargs):
        out = write_torch(lease, tensor, *args, **kwargs)
        window = lease._region.handle._host_buf()  # raw: read_host would flush
        windows.append((bytes(window[lease.offset:lease.offset + lease.nbytes]),
                        tensor.numpy().tobytes()))
        return out

    monkeypatch.setattr(ArenaLease, "write_torch", recorded)
    url = servers[("port", "http")].url
    if cli:
        assert port_perf.main(["-m", "identity_fp32", "-u", url, "--shape", "INPUT0:1,64",
                               "--concurrency-range", "1", "--measurement-requests", "4",
                               "--warmup-requests", "1", "--shared-memory", "cuda",
                               "--device", "cpu", "-f", "json"]) == 0
        capsys.readouterr()
    else:
        runner = _runner(port_perf, url, "http", "identity_fp32", "cuda")
        try:
            assert runner.run(1, 4)["errors"] == 0
        finally:
            _close(runner)
    assert windows and all(any(staged) for _, staged in windows)
    assert all((host == staged) == cli for host, staged in windows)


def test_cli_rate_and_trace_tables(servers, capsys):
    url = servers[("port", "http")].url
    assert port_perf.main(["-m", "simple", "-u", url, "--request-rate-range", "200",
                           "--measurement-requests", "5", "--warmup-requests", "0"]) == 0
    assert "rate" in capsys.readouterr().out
    assert port_perf.main(["-m", "simple", "-u", url, "--trace-gen",
                           "poisson_burst:duration_s=0.5,rate=10", "--speed", "4",
                           "--slo", "p99<5000ms"]) == 0
    out = capsys.readouterr().out
    assert "trace replay" in out and "slo_ok=True" in out


def test_module_runs_as_a_script(servers):
    """``python -m client_tpu_torch.perf -f json`` in its own process."""
    url = servers[("port", "http")].url
    out = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.perf", "-m", "simple", "-u", url,
         "--measurement-requests", "4", "--warmup-requests", "1", "-f", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=50)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert rows[0]["requests"] == 4 and rows[0]["errors"] == 0


def test_random_tensors_equal_jax_s():
    for datatype in ("INT32", "FP32", "UINT8", "BYTES", "FP16"):
        a = port_perf._random_tensor(datatype, [2, 3], np.random.default_rng(5))
        b = jax_perf._random_tensor(datatype, [2, 3], np.random.default_rng(5))
        assert a.dtype == b.dtype and (a == b).all()
