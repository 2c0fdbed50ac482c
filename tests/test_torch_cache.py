"""``client_tpu_torch.cache`` against ``client_tpu.cache``.

- ``ResponseCache``: one seeded script of inserts (three tenants and the
  tenantless partition, random payload sizes) and lookups under an
  injected clock drives a cache of each package; every lookup verdict,
  the resident keys in LRU order and the stats (evictions by reason,
  per-tenant partitions) must be equal, for LRU capacity, TTL expiry,
  stale-while-revalidate and per-tenant eviction;
- ``content_key`` is equal for the same seeded request, and a tenant
  gives another key;
- singleflight: 16 threads with one identical request collapse onto one
  inner call in each package; the stub's inner call waits until the 15
  followers have joined the flight, never on a sleep; repeats are hits
  whose bytes equal the miss's, and a hit's ``as_torch`` equals it;
- an evicted entry's view raises ``ArenaLeaseReleased`` in both packages.
"""

import threading

import numpy as np
import pytest
import torch

import client_tpu.arena as jax_arena
import client_tpu.cache as jax_cache
import client_tpu.http as jax_http
import client_tpu_torch.arena as port_arena
import client_tpu_torch.cache as port_cache
import client_tpu_torch.http as port_http
from client_tpu._base import InferenceServerClientBase as JaxBase
from client_tpu_torch._base import InferenceServerClientBase as PortBase
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PKG = {
    "port": {"cache": port_cache, "arena": port_arena, "http": port_http, "base": PortBase},
    "jax": {"cache": jax_cache, "arena": jax_arena, "http": jax_http, "base": JaxBase},
}
TENANTS = [None, "a", "b", "c"]


class _Result:
    """A served response: one FP32 output ``Y`` and one INT32 ``N``."""

    def __init__(self, y, n):
        self._arrays = {"Y": y, "N": n}
        self._response = {"model_name": "m", "id": "r",
                          "outputs": [
                              {"name": "Y", "datatype": "FP32", "shape": list(y.shape),
                               "parameters": {"binary_data_size": y.nbytes}},
                              {"name": "N", "datatype": "INT32", "shape": list(n.shape)}]}

    def get_response(self):
        return self._response

    def as_numpy(self, name):
        return self._arrays.get(name)


def _make_arena(pkg):
    if pkg == "port":
        return port_arena.ShmArena(device="cpu", name_prefix="torch_cache_test")
    return jax_arena.ShmArena(name_prefix="jax_cache_test")


def _script(seed, n_ops=160):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        key = f"k{int(rng.integers(12))}"
        tenant = TENANTS[int(rng.integers(len(TENANTS)))]
        if r < 0.45:
            size = int(rng.integers(1, 300))
            ops.append(("insert", key, tenant, size, int(rng.integers(1 << 30))))
        elif r < 0.85:
            ops.append(("lookup", key))
        elif r < 0.97:
            ops.append(("tick", float(rng.uniform(0.0, 2.5))))
        else:
            ops.append(("invalidate", key))
    return ops


def _run_cache(pkg, seed, **kwargs):
    mods = PKG[pkg]
    t = [0.0]
    arena = _make_arena(pkg)
    cache = mods["cache"].ResponseCache(arena=arena, clock=lambda: t[0], **kwargs)
    log = []
    try:
        for op in _script(seed):
            if op[0] == "insert":
                _, key, tenant, size, value = op
                y = np.random.default_rng(value).standard_normal(size).astype(np.float32)
                entry = cache.insert(key, "m", _Result(y, np.array([value], np.int32)),
                                     tenant=tenant)
                log.append(("insert", entry is not None))
            elif op[0] == "lookup":
                state, entry = cache.lookup(op[1])
                if entry is None:
                    log.append((state, None))
                else:
                    res = mods["cache"].CachedInferResult(entry)
                    log.append((state, res.as_numpy("Y").tobytes(),
                                res.as_numpy("N").tolist(), res.get_response()))
            elif op[0] == "tick":
                t[0] += op[1]
            else:
                log.append(("invalidate", cache.invalidate(key=op[1])))
        resident = [(k, e.tenant, e.nbytes) for k, e in cache._entries.items()]
        return log, resident, cache.stats()
    finally:
        cache.clear()
        arena.close(force=True)


CONFIGS = [
    {"max_entries": 6, "max_bytes": 1 << 20, "ttl_s": 1000.0},            # LRU by count
    {"max_entries": 4096, "max_bytes": 1 << 16, "ttl_s": 1000.0},         # LRU by bytes
    {"max_entries": 64, "max_bytes": 1 << 20, "ttl_s": 3.0},              # TTL
    {"max_entries": 64, "max_bytes": 1 << 20, "ttl_s": 2.0,
     "stale_while_revalidate_s": 2.0},                                     # stale window
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", CONFIGS, ids=["entries", "bytes", "ttl", "stale"])
def test_response_cache_script_matches_jax(config, seed):
    port = _run_cache("port", seed, **config)
    ref = _run_cache("jax", seed, **config)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[2]["insertions"] > 0 and port[2]["hits"] > 0


def test_tenant_budgets_from_a_policy_match_jax():
    from client_tpu.tenancy import parse_tenancy_spec as jax_parse
    from client_tpu_torch.tenancy import parse_tenancy_spec as port_parse

    spec = "a,cache_bytes=4096;b,cache_bytes=16384;c"
    port = _run_cache("port", 3, max_entries=64, max_bytes=1 << 16,
                      tenancy=port_parse(spec))
    ref = _run_cache("jax", 3, max_entries=64, max_bytes=1 << 16, tenancy=jax_parse(spec))
    assert port == ref
    assert set(port[2]["tenants"]) >= {"a", "b"}


def _request(mod, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5)).astype(np.float32)
    return [mod.InferInput("X", [2, 5], "FP32").set_data_from_numpy(x)]


@pytest.mark.parametrize("kwargs", [{}, {"model_version": "1", "parameters": {"p": 2}}])
@pytest.mark.parametrize("seed", range(3))
def test_content_key_matches_jax(seed, kwargs):
    port = port_cache.content_key("m", _request(port_http, seed), dict(kwargs))
    assert port == jax_cache.content_key("m", _request(jax_http, seed), dict(kwargs))
    tenant = port_cache.content_key("m", _request(port_http, seed), dict(kwargs, tenant="t"))
    assert tenant == jax_cache.content_key("m", _request(jax_http, seed),
                                           dict(kwargs, tenant="t"))
    assert tenant != port


def _parked_stub(base, n_followers, client_box):
    """An inner client whose call returns only once ``n_followers`` callers
    have joined the flight it leads."""

    class Stub(base):
        _FRONTEND = "stub"

        def __init__(self):
            super().__init__()
            self.calls = 0
            self.parked = threading.Event()

        def infer(self, model_name, inputs, **kwargs):
            self.calls += 1
            wrapper = client_box[0]
            while True:
                with wrapper._flights_lock:
                    flights = list(wrapper._flights.values())
                if flights and flights[0].followers >= n_followers:
                    break
                self.parked.wait(0.001)
            x = np.frombuffer(bytes(inputs[0]._get_binary_data()), np.float32).reshape(2, 5)
            return _Result(x * 3.0, np.array([self.calls], np.int32))

        def close(self):
            pass

    return Stub()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_singleflight_collapses_then_hits(pkg):
    mods = PKG[pkg]
    box = [None]
    inner = _parked_stub(mods["base"], 15, box)
    arena = _make_arena(pkg)
    client = mods["cache"].CachingClient(inner, arena=arena)
    box[0] = client
    results = [None] * 16
    gate = threading.Barrier(16)

    def caller(i):
        gate.wait()
        results[i] = client.infer("m", _request(mods["http"], 9))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    try:
        stats = client.cache_stats()
        assert inner.calls == 1
        assert (stats["wire_requests"], stats["singleflight_collapsed"]) == (1, 15)
        miss = results[0].as_numpy("Y").copy()
        assert all(np.array_equal(r.as_numpy("Y"), miss) for r in results)
        hits = [client.infer("m", _request(mods["http"], 9)) for _ in range(16)]
        stats = client.cache_stats()
        assert inner.calls == 1 and stats["hit"] == 16
        assert all(h.as_numpy("Y").tobytes() == miss.tobytes() for h in hits)
        if pkg == "port":
            t = hits[0].as_torch("Y", "cpu")
            assert torch.equal(t, torch.from_numpy(miss))
            # a copy: dropping the entry leaves the tensor intact
            client.cache().clear()
            assert torch.equal(t, torch.from_numpy(miss))
    finally:
        client.close()
        arena.close(force=True)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_evicted_view_raises_lease_released(pkg):
    mods = PKG[pkg]
    arena = _make_arena(pkg)
    cache = mods["cache"].ResponseCache(arena=arena, max_entries=1)
    try:
        one, zero = np.ones(4, np.float32), np.zeros(1, np.int32)
        res = mods["cache"].CachedInferResult(cache.insert("k0", "m", _Result(one, zero)))
        cache.insert("k1", "m", _Result(one * 2, zero))
        assert cache.lookup("k0") == ("miss", None)
        with pytest.raises(mods["arena"].ArenaLeaseReleased):
            res.as_numpy("Y")
        if pkg == "port":
            with pytest.raises(port_arena.ArenaLeaseReleased):
                res.as_torch("Y", "cpu")
        # a retained result outlives the eviction, until released
        held = mods["cache"].CachedInferResult(cache.lookup("k1")[1]).retain()
        cache.insert("k2", "m", _Result(one * 3, zero))
        np.testing.assert_array_equal(held.as_numpy("Y"), one * 2)
        held.release()
        with pytest.raises(mods["arena"].ArenaLeaseReleased):
            held.as_numpy("Y")
    finally:
        cache.clear()
        arena.close(force=True)
