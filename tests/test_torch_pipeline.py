"""``client_tpu_torch.pipeline`` against ``client_tpu.pipeline``.

- Construction: the same invalid graphs through both packages raise the same
  exception type with the same message; ``Pipeline.parse`` and
  ``Pipeline.plan`` (levels, births, deaths, high water) agree with JAX's.
- Runs: the chain over the port's CPU server, sync and aio, equals one
  ``chain_fused`` call bit for bit; steady state creates no region and issues
  no registration RPC, and each run's peak arena residency is the plan's high
  water; one admission token a run; the flight waterfall.
- Across packages: the port's ``PipelineClient`` against a JAX server and
  JAX's against the port's server, SCORES within 1e-5 of the other package's
  fused call (a 32-term fp32 dot product summed in another order).
- Failure: a stage whose endpoint is reset raises ``StageFailed`` naming it,
  its dependents never dispatch, and no lease leaks.
- Trace v6: the generators' records equal JAX's, and ``PerfRunner(
  pipeline="chain")`` replays them with per-stage columns.
"""

import asyncio

import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu.pipeline as jax_pipeline
import client_tpu_torch.http as port_http
import client_tpu_torch.pipeline as port_pipeline
from client_tpu import trace as jax_trace
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import trace as port_trace
from client_tpu_torch.admission import AdmissionController
from client_tpu_torch.flight import FlightRecorder
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.observe import Telemetry
from client_tpu_torch.perf import PerfRunner
from client_tpu_torch.pipeline import (
    AioPipelineClient,
    Pipeline,
    PipelineClient,
    PipelineConfigError,
    Stage,
    StageFailed,
    chain_pipeline,
)
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.testing import ChaosProxy, Fault
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

RAW = np.arange(16, dtype=np.int32).reshape(1, 16) * 3 + 1
CROSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def server():
    srv = HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server():
    srv = JaxHttpServer(JaxCore(jax_zoo())).start()
    yield srv
    srv.stop()


def _fused(http, url, raw=RAW):
    client = http.InferenceServerClient(url)
    try:
        inp = http.InferInput("RAW", list(raw.shape), "INT32").set_data_from_numpy(raw)
        return client.infer("chain_fused", [inp]).as_numpy("SCORES")
    finally:
        client.close()


@pytest.fixture(scope="module")
def fused_scores(server):
    return _fused(port_http, server.url)


# -- construction ------------------------------------------------------------------


def _ident(m, name, model, src, shape, dtype="FP32"):
    return m.Stage(name, model, inputs={"INPUT0": src}, outputs={"OUTPUT0": (dtype, list(shape))})


X4 = {"X": ("FP32", [1, 4])}

INVALID = {
    "cycle": lambda m: m.Pipeline(
        stages=[m.Stage("a", "identity_fp32", inputs={"INPUT0": "b.OUTPUT0"},
                        outputs={"OUTPUT0": ("FP32", [1, 4])}),
                m.Stage("b", "identity_fp32", inputs={"INPUT0": "a.OUTPUT0"},
                        outputs={"OUTPUT0": ("FP32", [1, 4])})],
        inputs=X4, outputs={"Y": "b.OUTPUT0"}),
    "missing_producer": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "ghost.OUT", [1, 4])],
        inputs=X4, outputs={"Y": "a.OUTPUT0"}),
    "missing_output_on_producer": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "$.X", [1, 4]),
                _ident(m, "b", "identity_fp32", "a.NOPE", [1, 4])],
        inputs=X4, outputs={"Y": "b.OUTPUT0"}),
    "dtype_mismatch": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "$.X", [1, 4]),
                m.Stage("b", "custom_identity_int32", inputs={"INPUT0": "a.OUTPUT0"},
                        input_specs={"INPUT0": ("INT32", [1, 4])},
                        outputs={"OUTPUT0": ("INT32", [1, 4])})],
        inputs=X4, outputs={"Y": "b.OUTPUT0"}),
    "shape_mismatch": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "$.X", [1, 4]),
                m.Stage("b", "identity_fp32", inputs={"INPUT0": "a.OUTPUT0"},
                        input_specs={"INPUT0": ("FP32", [2, 8])},
                        outputs={"OUTPUT0": ("FP32", [2, 8])})],
        inputs=X4, outputs={"Y": "b.OUTPUT0"}),
    "unconsumed_output": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "$.X", [1, 4]),
                _ident(m, "b", "identity_fp32", "$.X", [1, 4])],
        inputs=X4, outputs={"Y": "a.OUTPUT0"}),
    "unconsumed_input": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "$.X", [1, 4])],
        inputs={"X": ("FP32", [1, 4]), "Z": ("FP32", [1, 4])}, outputs={"Y": "a.OUTPUT0"}),
    "self_reference": lambda m: m.Pipeline(
        stages=[_ident(m, "a", "identity_fp32", "a.OUTPUT0", [1, 4])],
        inputs=X4, outputs={"Y": "a.OUTPUT0"}),
    "empty_stages": lambda m: m.Pipeline(stages=[], inputs=X4, outputs={"Y": "a.OUTPUT0"}),
    "no_outputs": lambda m: m.Stage("a", "identity_fp32", inputs={"INPUT0": "$.X"}, outputs={}),
    "bad_reference": lambda m: m.Stage("a", "identity_fp32", inputs={"INPUT0": "no-dot"},
                                       outputs={"OUTPUT0": ("FP32", [1, 4])}),
    "unknown_spec": lambda m: m.resolve_pipeline("nonesuch"),
    "bad_spec_segment": lambda m: m.Pipeline.parse("in RAW:INT32[1,16]; what is this"),
    "bad_output_declaration": lambda m: m.Pipeline.parse(
        "in RAW:INT32[1,16]; t=chain_tokenize(RAW=$.RAW)->TOKENS; out S=t.TOKENS"),
}


def _raised(build, mod):
    try:
        build(mod)
    except Exception as e:  # the exception itself is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", list(INVALID))
def test_construction_errors_are_jax_s(case):
    ours, theirs = _raised(INVALID[case], port_pipeline), _raised(INVALID[case], jax_pipeline)
    assert theirs is not None and theirs[0] == "PipelineConfigError"
    assert ours == theirs


CHAIN_SPEC = ("in RAW:INT32[1,16]; "
              "tokenize=chain_tokenize(RAW=$.RAW)->TOKENS:INT32[1,16]; "
              "embed=chain_embed(TOKENS=tokenize.TOKENS)->EMBED:FP32[1,16,32]; "
              "rerank=chain_rerank(EMBED=embed.EMBED)->SCORES:FP32[1,16]; "
              "out SCORES=rerank.SCORES")
FAN_SPEC = ("in X:INT32[1,16]; a=custom_identity_int32(INPUT0=$.X)->OUTPUT0:INT32[1,16]; "
            "b=custom_identity_int32(INPUT0=$.X)->OUTPUT0:INT32[1,16]; "
            "join=simple(INPUT0=a.OUTPUT0,INPUT1=b.OUTPUT0)->OUTPUT0:INT32[1,16]+OUTPUT1:INT32[1,16]; "
            "out SUM=join.OUTPUT0; out DIFF=join.OUTPUT1")


@pytest.mark.parametrize("graph", ["chain", "chain_spec", "chain_4x32", "fan"])
def test_parse_and_plan_are_jax_s(graph):
    def build(m):
        if graph == "chain":
            return m.chain_pipeline()
        if graph == "chain_4x32":
            return m.chain_pipeline(batch=4, length=32)
        return m.Pipeline.parse(CHAIN_SPEC if graph == "chain_spec" else FAN_SPEC)

    ours, theirs = build(port_pipeline), build(jax_pipeline)
    assert ours.order == theirs.order
    assert ours.describe() == theirs.describe()
    for class_for in (None, lambda n: 1 << max(0, int(n) - 1).bit_length()):
        p, t = ours.plan(class_for), theirs.plan(class_for)
        assert p.tensors == t.tensors
        assert p.level_bytes == t.level_bytes
        assert p.high_water_bytes == t.high_water_bytes == max(p.level_bytes)
        assert p.describe() == t.describe()


# -- runs on the port's server ----------------------------------------------------------


def test_chain_equals_fused_sync(server, fused_scores):
    client = PipelineClient([server.url], chain_pipeline(), protocol="http",
                            health_interval_s=None)
    try:
        res = client.run({"RAW": RAW})
        assert np.array_equal(res.as_numpy("SCORES"), fused_scores)
        assert set(res.stage_latency_s) == {"tokenize", "embed", "rerank"}
        assert res.plan_high_water_bytes == client.plan().high_water_bytes
    finally:
        client.close()


def test_chain_equals_fused_aio(server, fused_scores):
    async def go():
        client = AioPipelineClient([server.url], chain_pipeline(), protocol="http",
                                   health_interval_s=None)
        try:
            return (await client.run({"RAW": RAW})).as_numpy("SCORES")
        finally:
            await client.close()

    assert np.array_equal(asyncio.run(go()), fused_scores)


def test_steady_state_zero_rpcs_and_plan_high_water(server, fused_scores):
    client = PipelineClient([server.url], chain_pipeline(), protocol="http",
                            health_interval_s=None)
    try:
        client.run({"RAW": RAW})
        before = client.arena().stats()
        for _ in range(3):
            res = client.run({"RAW": RAW})
            assert np.array_equal(res.as_numpy("SCORES"), fused_scores)
            assert res.arena_high_water_bytes == res.plan_high_water_bytes
        after = client.arena().stats()
        assert after["regions_created"] == before["regions_created"]
        assert after["registrations_issued"] == before["registrations_issued"]
        assert after["leased_bytes"] == before["leased_bytes"]
        stats = client.stats()
        assert stats["runs"] == 4 and stats["failures"] == 0
        assert stats["observed_high_water_bytes"] == stats["plan_high_water_bytes"]
    finally:
        client.close()


def test_fan_out_join_equals_the_arithmetic(server):
    client = PipelineClient([server.url], Pipeline.parse(FAN_SPEC), protocol="http",
                            health_interval_s=None)
    try:
        res = client.run({"X": RAW})
        assert np.array_equal(res.as_numpy("SUM"), RAW + RAW)
        assert np.array_equal(res.as_numpy("DIFF"), RAW - RAW)
    finally:
        client.close()


def test_composition_rejections(server):
    with pytest.raises(PipelineConfigError, match="substrate"):
        PipelineClient(object(), chain_pipeline())
    client = PipelineClient([server.url], chain_pipeline(), protocol="http",
                            health_interval_s=None)
    try:
        with pytest.raises(PipelineConfigError, match="sequence"):
            client.run({"RAW": RAW}, sequence_id=7)
        with pytest.raises(PipelineConfigError, match="outputs"):
            client.run({"RAW": RAW}, outputs=[])
        with pytest.raises(PipelineConfigError, match="generate_stream"):
            client.generate_stream("m", {})
        with pytest.raises(PipelineConfigError, match="feeds"):
            client.run({"RAW": RAW, "EXTRA": RAW})
        with pytest.raises(PipelineConfigError, match="dtype"):
            client.run({"RAW": RAW.astype(np.float32)})
    finally:
        client.close()


def test_one_admission_token_per_run(server):
    ctrl = AdmissionController()
    client = PipelineClient([server.url], chain_pipeline(), protocol="http",
                            health_interval_s=None, admission=ctrl)

    def admitted():
        return sum(lane["admitted_total"] for lane in ctrl.snapshot()["lanes"].values())

    try:
        base = admitted()
        client.run({"RAW": RAW})
        client.run({"RAW": RAW})
        assert admitted() == base + 2
    finally:
        client.close()


def test_flight_retains_the_pipeline_waterfall(server):
    tel = Telemetry(flight=FlightRecorder(baseline_ratio=1.0))
    client = PipelineClient([server.url], chain_pipeline(), protocol="http",
                            health_interval_s=None, telemetry=tel)
    try:
        client.run({"RAW": RAW})
    finally:
        client.close()
    timelines = tel.flight.retained()
    names = {(e[1], e[2]) for t in timelines for e in t.events}
    for event in ("plan", "stage_dispatch", "handoff", "stage_settle", "release"):
        assert ("pipeline", event) in names, event
    keys = set()
    for t in timelines:
        keys.update(t.attribution()["ms"])
    assert any(k.startswith("pipeline:") for k in keys), keys


# -- across packages --------------------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_cross_package_chain(server, jax_server, client_pkg):
    """Each package's PipelineClient against the other package's server, held
    to that server's own fused call bit for bit and to the other server's
    within 1e-5."""
    raw = np.random.default_rng(7).integers(-10**6, 10**6, (1, 16)).astype(np.int32)
    if client_pkg == "port":
        url, mod, other = jax_server.url, port_pipeline, (port_http, server.url)
        same = (jax_http, url)
    else:
        url, mod, other = server.url, jax_pipeline, (jax_http, jax_server.url)
        same = (port_http, url)
    client = mod.PipelineClient([url], mod.chain_pipeline(), protocol="http",
                                health_interval_s=None)
    try:
        scores = client.run({"RAW": raw}).as_numpy("SCORES")
    finally:
        client.close()
    assert np.array_equal(scores, _fused(*same, raw))
    np.testing.assert_allclose(scores, _fused(*other, raw), atol=CROSS_TOL, rtol=CROSS_TOL)


# -- a killed stage ------------------------------------------------------------------------


def test_killed_stage_typed_failure_cancels_dependents(server):
    victim = HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
    proxy = ChaosProxy("127.0.0.1", victim.port).start()
    pipe = Pipeline(
        stages=[Stage("tokenize", "chain_tokenize", inputs={"RAW": "$.RAW"},
                      outputs={"TOKENS": ("INT32", [1, 16])}, endpoint=proxy.url),
                Stage("embed", "chain_embed", inputs={"TOKENS": "tokenize.TOKENS"},
                      outputs={"EMBED": ("FP32", [1, 16, 32])}, endpoint=server.url),
                Stage("rerank", "chain_rerank", inputs={"EMBED": "embed.EMBED"},
                      outputs={"SCORES": ("FP32", [1, 16])}, endpoint=server.url)],
        inputs={"RAW": ("INT32", [1, 16])}, outputs={"SCORES": "rerank.SCORES"})
    client = PipelineClient([server.url, proxy.url], pipe, protocol="http",
                            health_interval_s=None)
    try:
        assert client.run({"RAW": RAW}).as_numpy("SCORES").shape == (1, 16)
        base_leased = client.arena().stats()["leased_bytes"]
        proxy.fault = Fault("reset", after_bytes=0)
        proxy.reset_active()
        with pytest.raises(StageFailed) as ei:
            client.run({"RAW": RAW}, client_timeout=10.0)
        assert ei.value.stage == "tokenize" and ei.value.cause is not None
        stats = client.stats()["stages"]
        assert stats["embed"]["count"] == 1 and stats["rerank"]["count"] == 1
        assert client.arena().stats()["leased_bytes"] == base_leased
        proxy.heal()
        assert client.run({"RAW": RAW}).as_numpy("SCORES").shape == (1, 16)
        assert client.arena().stats()["leased_bytes"] == base_leased
    finally:
        client.close()
        proxy.stop()
        victim.stop()


# -- trace v6 ---------------------------------------------------------------------------------

SPEC_V6 = ("mixed:duration_s=2,rate=12,stream_fraction=0.1,seq_fraction=0,"
           "pipeline_fraction=0.5,unary_model=simple")


def test_trace_v6_round_trip_is_the_jax_trace(tmp_path):
    ours, theirs = port_trace.generate(SPEC_V6, seed=11), jax_trace.generate(SPEC_V6, seed=11)
    text = port_trace.dumps_trace(ours.records, ours.header)
    assert text == jax_trace.dumps_trace(theirs.records, theirs.header)
    loaded = port_trace.loads_trace(text)
    assert loaded.skipped == 0
    assert loaded.kind_counts() == ours.kind_counts()
    assert all(r.model == "chain" and r.shapes == {"RAW": [1, 16]}
               for r in loaded.records if r.kind == "pipeline")
    bumped = text.replace('"v":6', '"v":99')
    assert port_trace.loads_trace(bumped).skipped == ours.kind_counts()["pipeline"]


def test_replay_drives_pipeline_runs(server):
    tr = port_trace.generate(SPEC_V6, seed=11)
    n_pipe = tr.kind_counts()["pipeline"]
    assert n_pipe > 0
    runner = PerfRunner(server.url, "http", "simple", pipeline="chain", device="cpu")
    try:
        res = runner.run_trace(tr, speed=4.0, replay_workers=8)
    finally:
        runner.close()
    assert res["errors"] == 0, res["error_sample"]
    assert res["kinds"]["pipeline"]["ok"] == n_pipe
    stages = res["pipeline_stages"]
    assert set(stages) == {"tokenize", "embed", "rerank"}
    assert all(row["count"] == n_pipe for row in stages.values())


def test_replay_without_pipeline_is_typed(server):
    tr = port_trace.generate("mixed:duration_s=1,rate=10,pipeline_fraction=0.5", seed=3)
    runner = PerfRunner(server.url, "http", "simple", device="cpu")
    try:
        with pytest.raises(ValueError, match="--pipeline"):
            runner.run_trace(tr, speed=4.0)
    finally:
        runner.close()
