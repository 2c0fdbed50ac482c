"""``client_tpu_torch.shard`` against ``client_tpu.shard``.

- Layout validation, axis coverage and the gather's exactness asserts: the
  same invalid layouts, ranges and shard results through both packages raise
  the same exception type with the same message.
- Stubbed endpoints (a scriptable client behind the port's ``PoolClient``):
  composition rejections, request/layout mismatches, ``ShardFailed`` naming
  the shard with each endpoint called exactly once (no silent retry), a
  replicated input reaching every shard, one admission token a logical
  request, and the logical span's scatter / attempt / gather phases.
- Port servers of the CPU zoo: ``batched_matmul`` scattered over two
  replicas, sync and aio, bit-equal to the concatenation of the per-shard
  direct calls; ``decoder_lm_prefill`` rows the same, ``NEXT_TOKEN`` equal to
  one unsharded call and the logits within 5e-2 of it (the decoder's bound;
  the batch's row count changes the CPU's matmul blocking); a replica whose
  connections are reset (the port's ``ChaosProxy``) gives ``ShardFailed``
  naming it, with no partial gather; the arena's steady
  state; trace v2 replay through ``PerfRunner(shard_layout=...)``.
- Across packages: each package's ``ShardedClient`` over the other's servers
  on ``batched_matmul`` (the same seeded W), within 1e-5 of its own.

JAX's ``decoder_lm_tp_prefill`` case is in tests/test_torch_decoder_tp.py.
"""

import asyncio

import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu.shard as jax_shard
import client_tpu_torch.http as port_http
import client_tpu_torch.shard as port_shard
from client_tpu import trace as jax_trace
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.pool import PoolClient as JaxPoolClient
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import trace as port_trace
from client_tpu_torch._base import InferenceServerClientBase
from client_tpu_torch.admission import AdmissionController
from client_tpu_torch.arena import ShmArena
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.observe import REQUEST_PHASES, Telemetry
from client_tpu_torch.perf import PerfRunner
from client_tpu_torch.pool import HedgePolicy, PoolClient
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.shard import (
    AioShardedClient,
    ShardConfigError,
    ShardedClient,
    ShardFailed,
    ShardLayout,
    ShardLayoutError,
    _input_array,
)
from client_tpu_torch.testing import ChaosProxy, Fault
from client_tpu_torch.utils import np_to_triton_dtype
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

LOGIT_ATOL = 5e-2
CROSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(x, mod=port_http, name="X"):
    return mod.InferInput(name, list(x.shape), np_to_triton_dtype(x.dtype)).set_data_from_numpy(x)


# -- validation against JAX -----------------------------------------------------------

INVALID_LAYOUTS = {
    "no_endpoints": lambda m: m.ShardLayout([], inputs={"X": 0}, outputs={"Y": 0}),
    "repeated_endpoint": lambda m: m.ShardLayout(["a", "a"], inputs={"X": 0}, outputs={"Y": 0}),
    "all_replicated": lambda m: m.ShardLayout(["a", "b"], inputs={"X": None}, outputs={"Y": 0}),
    "bogus_axis": lambda m: m.ShardLayout(["a", "b"], inputs={"X": "bogus"}, outputs={"Y": 0}),
    "no_outputs": lambda m: m.ShardLayout(["a", "b"], inputs={"X": 0}, outputs={}),
    "negative_axis": lambda m: m.ShardAxis(-1),
    "spec_without_arrow": lambda m: m.ShardLayout.parse("X=0", ["a", "b"]),
    "spec_axis_not_int": lambda m: m.ShardLayout.parse("X=zero->Y=0", ["a", "b"]),
    "overlap": lambda m: m.ShardAxis(0, ranges=[(0, 5), (4, 8)]).resolve("X", 8, 2),
    "gap": lambda m: m.ShardAxis(0, ranges=[(0, 3), (5, 8)]).resolve("X", 8, 2),
    "short": lambda m: m.ShardAxis(0, ranges=[(0, 3), (3, 6)]).resolve("X", 8, 2),
    "range_count": lambda m: m.ShardAxis(0, ranges=[(0, 8)]).resolve("X", 8, 2),
    "empty_range": lambda m: m.ShardAxis(0, ranges=[(0, 0), (0, 8)]).resolve("X", 8, 2),
    "axis_too_short": lambda m: m.ShardAxis(0).resolve("X", 1, 2),
}


def _raised(build, mod):
    try:
        build(mod)
    except Exception as e:  # the exception itself is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", list(INVALID_LAYOUTS))
def test_layout_errors_are_jax_s(case):
    ours = _raised(INVALID_LAYOUTS[case], port_shard)
    theirs = _raised(INVALID_LAYOUTS[case], jax_shard)
    assert theirs is not None and theirs[0] == "ShardLayoutError"
    assert ours == theirs


@pytest.mark.parametrize("spec", ["X=0,W=r->Y=0,S=r", "TOKENS=0->LOGITS=0,NEXT_TOKEN=0",
                                  "A=1,B=0->C=1"])
def test_layout_parse_and_split_are_jax_s(spec):
    ours = port_shard.ShardLayout.parse(spec, ["a", "b", "c"])
    theirs = jax_shard.ShardLayout.parse(spec, ["a", "b", "c"])
    assert ours.describe() == theirs.describe()
    for length in (3, 7, 8, 100):
        assert port_shard.ShardAxis(0).resolve("X", length, 3) == \
            jax_shard.ShardAxis(0).resolve("X", length, 3)


class FakeResult:
    """A minimal InferResult stand-in for the gather."""

    def __init__(self, outputs):
        self._outputs = {k: np.asarray(v) for k, v in outputs.items()}

    def get_output(self, name):
        arr = self._outputs.get(name)
        if arr is None:
            return None
        return {"name": name, "datatype": np_to_triton_dtype(arr.dtype), "shape": list(arr.shape)}

    def get_response(self):
        return {"model_name": "fake", "outputs": [self.get_output(n) for n in self._outputs]}

    def as_numpy(self, name):
        return self._outputs.get(name)


A = np.arange(6, dtype=np.float32).reshape(2, 3)
S = np.array([7], dtype=np.int32)
GATHERS = {
    "missing_output": [{"Y": A, "S": S}, {"S": S}],
    "dtype": [{"Y": A, "S": S}, {"Y": A.astype(np.float64), "S": S}],
    "non_gather_dim": [{"Y": A, "S": S}, {"Y": np.zeros((2, 4), np.float32), "S": S}],
    "undeclared": [{"Y": A, "S": S, "EXTRA": S}, {"Y": A, "S": S, "EXTRA": S}],
    "undeclared_on_shard_1": [{"Y": A, "S": S}, {"Y": A, "S": S, "EXTRA": S}],
    "rank": [{"Y": A, "S": S}, {"Y": A.reshape(6), "S": S}],
    "replicated_differs": [{"Y": A, "S": S}, {"Y": A, "S": np.array([8], np.int32)}],
}


@pytest.mark.parametrize("case", list(GATHERS))
def test_gather_asserts_are_jax_s(case):
    def build(m):
        layout = m.ShardLayout(["a", "b"], inputs={"X": 0}, outputs={"Y": 0, "S": None})
        res = m.ShardedInferResult(layout, [FakeResult(o) for o in GATHERS[case]])
        res.as_numpy("S")
        return res

    ours, theirs = _raised(build, port_shard), _raised(build, jax_shard)
    assert theirs is not None and theirs[0] == "ShardGatherError"
    assert ours == theirs


def test_gather_concatenates_and_keeps_replicated():
    layout = ShardLayout(["a", "b"], inputs={"X": 0}, outputs={"Y": 0, "S": None})
    res = port_shard.ShardedInferResult(layout, [FakeResult({"Y": A, "S": S}),
                                                 FakeResult({"Y": A + 6, "S": S})])
    np.testing.assert_array_equal(res.as_numpy("Y"), np.concatenate([A, A + 6]))
    np.testing.assert_array_equal(res.as_numpy("S"), S)
    assert res.get_output("Y")["shape"] == [4, 3]
    assert res.get_response()["shards"] == 2


# -- stubbed endpoints ----------------------------------------------------------------


class ShardStub(InferenceServerClientBase):
    """A scriptable shard endpoint: echoes the X slice as Y unless
    ``behavior`` overrides."""

    def __init__(self, url, behavior=None):
        super().__init__()
        self.url = url
        self.behavior = behavior
        self.calls = []

    def infer(self, model_name, inputs=None, **kwargs):
        self.calls.append({"model": model_name, "kwargs": dict(kwargs), "inputs": list(inputs or ())})
        op = self.behavior or self._echo
        if self._resilience is not None:
            return self._resilience.execute(lambda: op(inputs, **kwargs), idempotent=True)
        return op(inputs, **kwargs)

    def _echo(self, inputs, **kwargs):
        return FakeResult({"Y": _input_array(inp) for inp in inputs if inp.name() == "X"})

    def is_server_ready(self, probe=False, **kw):
        return True

    def close(self):
        pass


def _stub_sharded(behaviors, layout=None, **pool_kwargs):
    urls = list(behaviors)
    stubs = {}

    def factory(url):
        stubs[url] = ShardStub(url, behaviors[url])
        return stubs[url]

    pool_kwargs.setdefault("health_interval_s", None)
    pool = PoolClient(urls, client_factory=factory, **pool_kwargs)
    layout = layout or ShardLayout(urls, inputs={"X": 0}, outputs={"Y": 0})
    return ShardedClient(pool, layout), stubs


def test_composition_rejections():
    layout = ShardLayout(["u1", "u2"], inputs={"X": 0}, outputs={"Y": 0})
    hedged = PoolClient(["u1", "u2"], client_factory=lambda u: ShardStub(u),
                        health_interval_s=None, hedge=HedgePolicy())
    with pytest.raises(ShardConfigError, match="hedg"):
        ShardedClient(hedged, layout)
    hedged.close()
    client, _ = _stub_sharded({"u1": None, "u2": None}, layout)
    try:
        with pytest.raises(ShardConfigError, match="coalesc"):
            client.coalescing()
        with pytest.raises(ShardConfigError, match="sequence"):
            client.infer("m", [_x(np.zeros((4, 2), np.float32))], sequence_id=9)
        with pytest.raises(ShardConfigError, match="stream"):
            client.generate_stream("m", {})
        with pytest.raises(ShardConfigError, match="coalescing"):
            ShardedClient(client.inner.coalescing(), layout)
        with pytest.raises(ShardConfigError, match="sync/aio"):
            AioShardedClient(client.inner, layout)
    finally:
        client.close()
    pool = PoolClient(["u1"], client_factory=lambda u: ShardStub(u), health_interval_s=None)
    try:
        with pytest.raises(ShardConfigError, match="pins endpoints"):
            ShardedClient(pool, layout)
    finally:
        pool.close()


def test_request_layout_mismatch_typed():
    layout = ShardLayout(["u1", "u2"], inputs={"X": 0, "W": 1}, outputs={"Y": 0})
    client, _ = _stub_sharded({"u1": None, "u2": None}, layout)
    x = np.zeros((4, 2), np.float32)
    try:
        with pytest.raises(ShardLayoutError, match="not declared"):
            client.infer("m", [_x(x), _x(x, name="Z"), _x(x, name="W")])
        with pytest.raises(ShardLayoutError, match="missing from the request"):
            client.infer("m", [_x(x)])
        bad = ShardLayout(["u1", "u2"], inputs={"X": 3}, outputs={"Y": 0})
        with pytest.raises(ShardLayoutError, match="out of range"):
            ShardedClient(client.inner, bad).infer("m", [_x(x)])
        shm_bound = _x(x)
        shm_bound.set_shared_memory("r", 32)
        with pytest.raises(ShardConfigError, match="bound to shared memory"):
            client.infer("m", [shm_bound])
    finally:
        client.close()


def test_shard_failed_is_whole_request_no_silent_retry():
    boom = ConnectionResetError("replica died")

    def fail(inputs, **kw):
        raise boom

    client, stubs = _stub_sharded({"u1": None, "u2": fail})
    try:
        with pytest.raises(ShardFailed) as excinfo:
            client.infer("m", [_x(np.arange(8, dtype=np.float32).reshape(4, 2))])
        err = excinfo.value
        assert (err.shard, err.url, err.cause) == (1, "u2", boom)
        assert "u2" in str(err) and "shard 1" in str(err)
        assert len(stubs["u2"].calls) == 1 and len(stubs["u1"].calls) == 1
    finally:
        client.close()


def test_replicated_input_reaches_every_shard_once():
    layout = ShardLayout(["u1", "u2"], inputs={"X": 0, "W": None}, outputs={"Y": 0})
    client, stubs = _stub_sharded({"u1": None, "u2": None}, layout)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    w = np.arange(4, dtype=np.float32)
    try:
        res = client.infer("m", [_x(x), _x(w, name="W")])
        np.testing.assert_array_equal(res.as_numpy("Y"), x)
        for i, url in enumerate(("u1", "u2")):
            (call,) = stubs[url].calls
            got = {inp.name(): _input_array(inp) for inp in call["inputs"]}
            np.testing.assert_array_equal(got["W"], w)
            np.testing.assert_array_equal(got["X"], x[3 * i: 3 * (i + 1)])
    finally:
        client.close()


def test_admission_charges_one_token_per_logical_request():
    tel = Telemetry(sample="always")
    ctrl = AdmissionController()
    client, _ = _stub_sharded({"u1": None, "u2": None}, telemetry=tel, admission=ctrl)
    try:
        for _ in range(3):
            client.infer("m", [_x(np.zeros((4, 2), np.float32))])
        assert ctrl.admitted_total == 3
        tel.flush()
        assert sum(s.value for s in tel.shard_subrequests_total._series.values()) == 6
    finally:
        client.close()


def test_logical_span_decomposes_scatter_attempt_gather():
    assert "shard_scatter" in REQUEST_PHASES and "shard_gather" in REQUEST_PHASES
    tel = Telemetry(sample="always")
    client, _ = _stub_sharded({"u1": None, "u2": None}, telemetry=tel)
    try:
        client.infer("m", [_x(np.zeros((4, 2), np.float32))])
        tel.flush()
        spans = [t for t in tel.tracer.recent() if t.get("op") == "shard_infer"]
        phases = [p["name"] for p in spans[-1]["phases"]]
        assert phases.count("attempt") == 2
        assert "shard_scatter" in phases and "shard_gather" in phases
        breakdown = tel.phase_breakdown()
        assert "shard_scatter" in breakdown and "shard_gather" in breakdown
        assert spans[-1]["frontend"].startswith("shard+")
        assert sum(s.value for s in tel.shard_requests_total._series.values()) == 1
    finally:
        client.close()


# -- port servers ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    svs = [HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
           for _ in range(2)]
    yield svs
    for s in svs:
        s.stop()


def _direct(url, model, name, x, out, mod=port_http):
    client = mod.InferenceServerClient(url)
    try:
        return client.infer(model, [_x(x, mod, name)]).as_numpy(out)
    finally:
        client.close()


def _per_shard(urls, model, name, x, out):
    """The concatenation of each shard's rows sent to its endpoint directly."""
    bounds = ShardLayout(urls, inputs={name: 0}, outputs={out: 0}).inputs[name].resolve(
        name, x.shape[0], len(urls))
    return np.concatenate([_direct(u, model, name, x[lo:hi], out)
                           for u, (lo, hi) in zip(urls, bounds)])


def test_scatter_gather_bit_exact_sync(servers):
    urls = [s.url for s in servers]
    x = np.random.default_rng(0xC11E).standard_normal((7, 64)).astype(np.float32)
    layout = ShardLayout(urls, inputs={"X": 0}, outputs={"Y": 0})
    with ShardedClient(urls, layout, health_interval_s=None) as client:
        res = client.infer("batched_matmul", [_x(x)])
        got = res.as_numpy("Y").copy()
        res.release()
    assert got.shape == (7, 16)
    np.testing.assert_array_equal(got, _per_shard(urls, "batched_matmul", "X", x, "Y"))
    np.testing.assert_allclose(got, _direct(urls[0], "batched_matmul", "X", x, "Y"),
                               atol=CROSS_TOL, rtol=CROSS_TOL)


def test_scatter_gather_bit_exact_aio(servers):
    import client_tpu_torch.http.aio as aioclient

    urls = [s.url for s in servers]
    x = np.random.default_rng(0xA10).standard_normal((8, 64)).astype(np.float32)
    layout = ShardLayout(urls, inputs={"X": 0}, outputs={"Y": 0})

    async def run():
        client = AioShardedClient(urls, layout, health_interval_s=None)
        try:
            res = await client.infer("batched_matmul", [_x(x, aioclient)])
            out = res.as_numpy("Y").copy()
            res.release()
            return out
        finally:
            await client.close()

    np.testing.assert_array_equal(asyncio.run(run()),
                                  _per_shard(urls, "batched_matmul", "X", x, "Y"))


def test_sharded_decoder_prefill_rows(servers):
    urls = [s.url for s in servers]
    tokens = np.random.default_rng(11).integers(0, 256, size=(8, 8), dtype=np.int32)
    layout = ShardLayout(urls, inputs={"TOKENS": 0}, outputs={"LOGITS": 0, "NEXT_TOKEN": 0})
    with ShardedClient(urls, layout, health_interval_s=None) as client:
        res = client.infer("decoder_lm_prefill", [_x(tokens, name="TOKENS")])
        logits, nxt = res.as_numpy("LOGITS").copy(), res.as_numpy("NEXT_TOKEN").copy()
        res.release()
    np.testing.assert_array_equal(logits, _per_shard(urls, "decoder_lm_prefill", "TOKENS",
                                                     tokens, "LOGITS"))
    np.testing.assert_array_equal(nxt, _per_shard(urls, "decoder_lm_prefill", "TOKENS",
                                                  tokens, "NEXT_TOKEN"))
    whole = _direct(urls[0], "decoder_lm_prefill", "TOKENS", tokens, "LOGITS")
    np.testing.assert_allclose(logits, whole, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(
        nxt, _direct(urls[0], "decoder_lm_prefill", "TOKENS", tokens, "NEXT_TOKEN"))


def test_arena_steady_state_zero_rpcs(servers):
    urls = [s.url for s in servers]
    arena = ShmArena(name_prefix="shard_t", device="cpu")
    pool = PoolClient(urls, protocol="http", health_interval_s=None, shm_arena=arena)
    client = ShardedClient(pool, ShardLayout(urls, inputs={"X": 0}, outputs={"Y": 0}))
    x = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    try:
        warm = client.infer("batched_matmul", [_x(x)])
        a, b = warm.as_numpy("Y"), warm.as_numpy("Y")
        assert a is b and warm._gather_leases
        assert np.shares_memory(a, np.frombuffer(warm._gather_leases[0].memoryview(), np.uint8))
        warm.release()
        before = arena.stats()
        for _ in range(10):
            res = client.infer("batched_matmul", [_x(x)])
            res.as_numpy("Y")
            res.release()
        after = arena.stats()
        assert after["regions_created"] == before["regions_created"]
        assert after["registrations_issued"] == before["registrations_issued"]
        assert after["leased_bytes"] == 0
    finally:
        client.close()
        arena.close()


def test_reset_replica_fails_the_logical_request(servers):
    """Shard 1's endpoint is a proxy whose connections are reset: the logical
    request raises ShardFailed naming shard 1 and its url, with no partial
    gather; after the proxy heals the same client answers in full again."""
    proxy = ChaosProxy("127.0.0.1", servers[1].port).start()
    urls = [servers[0].url, proxy.url]
    tel = Telemetry(sample="always")
    pool = PoolClient(urls, protocol="http", health_interval_s=None, telemetry=tel)
    client = ShardedClient(pool, ShardLayout(urls, inputs={"X": 0}, outputs={"Y": 0}))
    x = np.random.default_rng(5).standard_normal((8, 64)).astype(np.float32)
    want = _per_shard([s.url for s in servers], "batched_matmul", "X", x, "Y")
    try:
        np.testing.assert_array_equal(client.infer("batched_matmul", [_x(x)]).as_numpy("Y"), want)
        proxy.fault = Fault("reset", after_bytes=0)
        proxy.reset_active()
        for _ in range(3):
            with pytest.raises(ShardFailed) as ei:
                client.infer("batched_matmul", [_x(x)], client_timeout=10.0)
            assert (ei.value.shard, ei.value.url) == (1, proxy.url)
            assert proxy.url in str(ei.value)
        tel.flush()
        assert sum(s.value for s in tel.shard_failed_total._series.values()) == 3
        proxy.heal()
        np.testing.assert_array_equal(client.infer("batched_matmul", [_x(x)]).as_numpy("Y"), want)
    finally:
        client.close()
        proxy.stop()


# -- trace v2 --------------------------------------------------------------------------


def test_sharded_trace_is_the_jax_trace():
    kw = dict(seed=2, duration_s=2.0, rate=5.0, shards=2, model="batched_matmul",
              shapes={"X": [8, 64]}, dtypes={"X": "FP32"})
    ours, theirs = port_trace.sharded(**kw), jax_trace.sharded(**kw)
    text = port_trace.dumps_trace(ours)
    assert text == jax_trace.dumps_trace(theirs)
    assert '"v":2' in text.splitlines()[1]
    loaded = port_trace.loads_trace(text)
    assert loaded.skipped == 0 and loaded.kind_counts()["sharded"] == len(ours)


@pytest.mark.parametrize("workers", [1, 8])
def test_sharded_trace_replay(servers, workers):
    urls = [s.url for s in servers]
    records = [port_trace.TraceRecord(at_s=i * 0.03, kind="sharded", model="batched_matmul",
                                      shapes={"X": [8, 64]}, dtypes={"X": "FP32"}, shards=2)
               for i in range(20)]
    runner = PerfRunner(urls[0], "http", "batched_matmul", endpoints=urls,
                        shape_overrides={"X": [8, 64]}, shard_layout="X=0->Y=0", device="cpu")
    try:
        row = runner.run_trace(port_trace.Trace(header={}, records=records),
                               replay_workers=workers, slos=["error_rate<1%"])
    finally:
        runner.close()
    assert row["kinds"]["sharded"]["ok"] == 20
    assert row["errors"] == 0 and row["shed"] == 0
    assert row["slo_ok"], row["slo"]


def test_replay_sharded_records_require_a_layout(servers):
    urls = [s.url for s in servers]
    rec = port_trace.TraceRecord(at_s=0.0, kind="sharded", model="batched_matmul",
                                 shapes={"X": [8, 64]}, dtypes={"X": "FP32"}, shards=2)
    runner = PerfRunner(urls[0], "http", "batched_matmul", endpoints=urls, device="cpu")
    try:
        with pytest.raises(ValueError, match="shard-layout"):
            runner.run_trace(port_trace.Trace(header={}, records=[rec]))
    finally:
        runner.close()


# -- across packages ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_servers():
    svs = [JaxHttpServer(JaxCore(jax_zoo())).start() for _ in range(2)]
    yield svs
    for s in svs:
        s.stop()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_cross_package_scatter_gather(servers, jax_servers, client_pkg):
    x = np.random.default_rng(9).standard_normal((6, 64)).astype(np.float32)
    if client_pkg == "port":
        urls = [f"127.0.0.1:{s.port}" for s in jax_servers]
        mod, http, pool_cls, own = port_shard, port_http, PoolClient, [s.url for s in servers]
    else:
        urls = [s.url for s in servers]
        mod, http, pool_cls = jax_shard, jax_http, JaxPoolClient
        own = [f"127.0.0.1:{s.port}" for s in jax_servers]
    pool = pool_cls(urls, protocol="http", health_interval_s=None, shm_arena=True)
    client = mod.ShardedClient(pool, mod.ShardLayout(urls, inputs={"X": 0}, outputs={"Y": 0}))
    try:
        res = client.infer("batched_matmul", [_x(x, http)])
        got = res.as_numpy("Y").copy()
        res.release()
    finally:
        client.close()
    theirs = mod.ShardedClient(pool_cls(own, protocol="http", health_interval_s=None,
                                        shm_arena=True),
                               mod.ShardLayout(own, inputs={"X": 0}, outputs={"Y": 0}))
    try:
        res = theirs.infer("batched_matmul", [_x(x, http)])
        ref = res.as_numpy("Y").copy()
        res.release()
    finally:
        theirs.close()
    np.testing.assert_allclose(got, ref, atol=CROSS_TOL, rtol=CROSS_TOL)
