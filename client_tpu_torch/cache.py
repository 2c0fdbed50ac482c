"""Hot-key serving: client-side singleflight + a bounded response cache.

Zipfian fleets repeat themselves: identical concurrent prompts, the same
classification input from thousands of users, the same feature vector
polled every second. Until now every one of those requests paid a full
wire round-trip — N callers, N serializations, N server executions for
ONE answer. This module makes a hot key cost the fleet ~one request:

- **Singleflight** — concurrent ``infer()`` calls with an identical
  *content key* (a stable hash over model, version, input names/dtypes/
  shapes/bytes, requested outputs and parameters — the same
  compatibility-key plumbing as ``client_tpu_torch.batch``, via
  :func:`~client_tpu_torch.batch.plan_request`) collapse onto ONE wire request:
  the first caller in becomes the leader, everyone else parks until the
  leader's result scatters back. A failed leader fans the SAME typed
  error to every collapsed caller. The leader's single inner ``infer``
  composes with ``.coalescing()`` (a leader may still ride a batch) and
  with pools (one routing/admission decision per collapsed group).

- **A bounded response cache** — LRU + TTL with a byte-size watermark.
  Entries are staged into :class:`~client_tpu_torch.arena.ShmArena` slabs
  (``ShmArena.stage``) held by ref-counted leases, so a cache hit's
  ``as_numpy`` is a ZERO-COPY lease-pinned view that stays valid past the
  wire buffer — and a trimmed/evicted entry raises the typed
  :class:`~client_tpu_torch.arena.ArenaLeaseReleased` instead of ever returning
  aliased memory. Errors are never cached. ``invalidate(model=...)``
  drops entries explicitly, and ``load_model``/``unload_model`` through
  the wrapper (including a pool's fleet-wide broadcast) invalidate that
  model's entries automatically. ``stale_while_revalidate_s`` is a typed
  opt-in: a TTL-expired entry inside the staleness window is served
  immediately (marked ``stale=True``) while ONE background refresh —
  deduplicated through the same singleflight table — repopulates it.

What never collapses or caches (the exact ``batch.py`` exclusion
matrix, shared via :func:`~client_tpu_torch.batch.plan_request`): sequence
requests, per-request ``resilience=`` overrides, shm-bound or
JSON-staged tensors, per-tensor parameters, classification and
shm-placed outputs. Those bypass to the inner client verbatim.

Usage::

    from client_tpu_torch.cache import CachingClient

    client = CachingClient("127.0.0.1:8000", protocol="http",
                           ttl_s=5.0, max_bytes=64 << 20)
    client.infer("classifier", inputs)      # hot keys cost ~one request

    # or wrap an existing client/pool/batcher (cache OUTSIDE batching:
    # hits skip the coalescing window entirely, misses may ride a batch)
    client = PoolClient(urls).coalescing().caching()

The port of ``client_tpu.cache``: entries stage through the port's
``ShmArena.stage`` in the arena's default family, and ``as_torch`` places
a hit's view on a torch device.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import flight as _flight_recorder
from ._base import fold_infer_args
from .batch import plan_request
from .utils import (
    InferenceServerException,
    serialize_bf16_tensor,
    serialize_byte_tensor,
)

__all__ = [
    "AioCachingClient",
    "CachedInferResult",
    "CachingClient",
    "ResponseCache",
    "caches",
    "content_key",
]


def content_key(model_name: str, inputs, kwargs: Optional[Dict] = None,
                ) -> Optional[str]:
    """The stable content hash identifying one request's ANSWER: model,
    version, per-input (name, dtype, shape) plus the staged bytes,
    requested outputs, and every semantic parameter. Two requests with
    equal keys are guaranteed byte-identical on the wire, so one may
    answer for the other. Returns None for requests outside the shared
    eligibility matrix (see :func:`~client_tpu_torch.batch.plan_request`)."""
    kwargs = dict(kwargs or {})
    plan = plan_request(list(inputs), kwargs)
    if plan is None:
        return None
    return _digest(model_name, plan)


def _digest(model_name: str, plan) -> str:
    sig, rows, raw_by_name, out_sig, extra_key = plan
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((model_name, rows, sig, out_sig, extra_key)).encode())
    for name, _, _ in sig:  # sig is sorted, so payload order is canonical
        payload = raw_by_name[name]
        # length framing: adjacent payloads can never collide by shifting
        h.update(len(payload).to_bytes(8, "little"))
        h.update(payload)
    return h.hexdigest()


class _CacheEntry:
    """One cached response: the sanitized response header plus each
    output's payload staged in an arena lease (datatype, shape, lease).
    The entry owns ONE reference per lease; eviction/invalidation
    releases them, after which views raise ``ArenaLeaseReleased``."""

    __slots__ = ("key", "model", "response", "outputs", "nbytes",
                 "inserted_at", "hits", "tenant")

    def __init__(self, key: str, model: str, response: Dict[str, Any],
                 outputs: Dict[str, Tuple[str, Tuple[int, ...], Any]],
                 nbytes: int, inserted_at: float,
                 tenant: Optional[str] = None):
        self.key = key
        self.model = model
        self.response = response
        self.outputs = outputs
        self.nbytes = nbytes
        self.inserted_at = inserted_at
        self.hits = 0
        self.tenant = tenant

    def release(self) -> None:
        from .arena import ArenaError

        for _, _, lease in self.outputs.values():
            try:
                lease.release()
            except ArenaError:
                pass  # already torn down elsewhere (arena close at exit)


class CachedInferResult:
    """A cache hit, quacking like the frontends' ``InferResult``.

    ``as_numpy`` returns a zero-copy view over the entry's arena slab,
    pinned by the entry's lease: valid while the entry lives, and raising
    the typed :class:`~client_tpu_torch.arena.ArenaLeaseReleased` once the
    entry was evicted, invalidated or TTL-expired — never aliased bytes.
    ``retain()``/``release()`` pin the underlying leases past eviction
    for callers that hold views across cache churn — ``release()`` drops
    only references THIS result added, so a caller cannot release the
    cache's own hold on a still-resident entry."""

    __slots__ = ("_entry", "_retains", "stale")

    cached = True

    def __init__(self, entry: _CacheEntry, stale: bool = False):
        self._entry = entry
        self._retains = 0
        self.stale = stale

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        spec = self._entry.outputs.get(name)
        if spec is None:
            return None
        datatype, shape, lease = spec
        return lease.as_numpy(datatype, shape)

    def as_torch(self, name: str, device="cuda"):
        """Output ``name`` on ``device``: one copy out of the lease-pinned
        view, so the tensor never aliases a slab the cache may recycle
        (an evicted entry raises ``ArenaLeaseReleased`` here as in
        ``as_numpy``)."""
        arr = self.as_numpy(name)
        if arr is None:
            return None
        if arr.dtype == np.object_:
            raise InferenceServerException(
                "BYTES outputs cannot be placed on device")
        from .utils import numpy_to_tensor

        out = numpy_to_tensor(arr, device)
        # on the CPU numpy_to_tensor shares the slab's memory
        return out.clone() if out.device.type == "cpu" else out

    def get_response(self) -> Dict[str, Any]:
        return self._entry.response

    def get_output(self, name: str) -> Optional[Dict[str, Any]]:
        for out in self._entry.response.get("outputs", []):
            if out.get("name") == name:
                return out
        return None

    def get_response_header(self, name: str, default=None):
        # transport headers (ORCA load et al.) describe a LIVE exchange;
        # a cached answer has none — never serve a stale load report
        return default

    def age_s(self, clock=time.monotonic) -> float:
        return max(0.0, clock() - self._entry.inserted_at)

    def retain(self) -> "CachedInferResult":
        for _, _, lease in self._entry.outputs.values():
            lease.retain()
        self._retains += 1
        return self

    def release(self) -> None:
        """Drop one retain this result holds (no-op when it holds none —
        the entry's own references belong to the cache, and releasing
        them here would corrupt a still-resident entry)."""
        if self._retains <= 0:
            return
        self._retains -= 1
        self._entry.release()


class ResponseCache:
    """LRU + TTL response cache bounded by a byte-size watermark.

    Entries are arena-staged (``ShmArena.stage``) so hits serve zero-copy
    lease-pinned views. Thread-safe; all methods are one short lock.
    ``clock`` is injectable for deterministic TTL tests.

    **Tenant partitioning**: the byte/entry watermarks are split into
    per-tenant PARTITIONS — eviction only ever reclaims within the
    inserting tenant's partition, so one tenant's zipf churn can never
    evict another tenant's hot set. A tenant's byte budget is its
    ``TenantSpec.cache_bytes`` when a ``tenancy`` policy declares one,
    else an equal share (``max_bytes // partitions``); entry budgets are
    always equal shares. With a single partition (the tenantless default)
    the split is the whole watermark — byte-identical legacy behavior.
    Isolation of CONTENT (tenant A never *served* tenant B's response)
    does not live here: the tenant is folded into the content key by
    ``batch.plan_request``, so cross-tenant keys never collide."""

    def __init__(
        self,
        ttl_s: float = 30.0,
        max_bytes: int = 64 * 1024 * 1024,
        max_entries: int = 4096,
        stale_while_revalidate_s: float = 0.0,
        arena=None,
        tenancy=None,
        clock=time.monotonic,
    ):
        if ttl_s <= 0:
            raise ValueError("ttl_s must be > 0")
        if max_bytes <= 0 or max_entries < 1:
            raise ValueError("max_bytes/max_entries must be positive")
        if stale_while_revalidate_s < 0:
            raise ValueError("stale_while_revalidate_s must be >= 0")
        if arena is None:
            from .arena import default_arena

            arena = default_arena()
        self.ttl_s = float(ttl_s)
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self.stale_while_revalidate_s = float(stale_while_revalidate_s)
        self.arena = arena
        self.tenancy = tenancy
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self._bytes = 0
        # tenant partitions: a partition exists from the first insert
        # under that tenant and persists (budgets stay stable even when a
        # partition momentarily empties)
        self._partitions: set = set()
        self._tenant_bytes: Dict[Optional[str], int] = {}
        self._tenant_entries: Dict[Optional[str], int] = {}
        self._stats = {
            "hits": 0, "misses": 0, "stale_hits": 0, "insertions": 0,
            "uncacheable": 0, "invalidations": 0,
            "evictions": {"capacity": 0, "ttl": 0, "replaced": 0,
                          "oversize": 0},
        }
        _CACHES.add(self)

    # -- partition accounting ----------------------------------------------
    def _account_remove_locked(self, entry: _CacheEntry) -> None:
        self._bytes -= entry.nbytes
        t = entry.tenant
        self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) - entry.nbytes
        self._tenant_entries[t] = self._tenant_entries.get(t, 0) - 1

    def _account_add_locked(self, entry: _CacheEntry) -> None:
        self._bytes += entry.nbytes
        t = entry.tenant
        self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) + entry.nbytes
        self._tenant_entries[t] = self._tenant_entries.get(t, 0) + 1

    def _partition_budget_locked(
            self, tenant: Optional[str]) -> Tuple[int, int]:
        """The partition's ``(byte_budget, entry_budget)``: the declared
        ``cache_bytes`` when a tenancy policy carries one for this
        tenant, else an equal share of the watermark. One partition
        (the tenantless default) gets the whole cache."""
        nparts = max(1, len(self._partitions))
        byte_budget = self.max_bytes // nparts
        entry_budget = max(1, self.max_entries // nparts)
        if self.tenancy is not None:
            declared = self.tenancy.spec(tenant).cache_bytes
            if declared:
                byte_budget = declared
        return max(1, byte_budget), entry_budget

    def _evict_tenant_locked(self, tenant: Optional[str],
                             victims: List[_CacheEntry],
                             newcomer: Optional[_CacheEntry] = None) -> None:
        """Reclaim the tenant's partition down to its budget — oldest of
        THIS tenant first, other tenants' entries untouchable."""
        byte_budget, entry_budget = self._partition_budget_locked(tenant)
        while (self._tenant_bytes.get(tenant, 0) > byte_budget
               or self._tenant_entries.get(tenant, 0) > entry_budget):
            victim_key = next(
                (k for k, e in self._entries.items() if e.tenant == tenant),
                None)
            if victim_key is None:
                break
            victim = self._entries[victim_key]
            if victim is newcomer:
                # the newcomer alone busts the partition against a hot
                # survivor set: stop — nothing older of ours remains
                break
            del self._entries[victim_key]
            self._account_remove_locked(victim)
            self._stats["evictions"]["capacity"] += 1
            victims.append(victim)

    def _register_partition_locked(self, tenant: Optional[str],
                                   victims: List[_CacheEntry]) -> None:
        """First insert under a new tenant: the equal-share budgets
        shrank for every existing partition — trim them NOW so the new
        tenant's guaranteed share is actually free, not hostage to
        whoever filled the cache first."""
        if tenant in self._partitions:
            return
        self._partitions.add(tenant)
        for other in self._partitions:
            if other != tenant:
                self._evict_tenant_locked(other, victims)

    # -- lookup ------------------------------------------------------------
    def lookup(self, key: str) -> Tuple[str, Optional[_CacheEntry]]:
        """``("hit"|"stale"|"miss", entry)``. A TTL-expired entry inside
        the stale-while-revalidate window is returned as ``"stale"`` (the
        caller serves it and revalidates); past the window it is evicted
        (reason ``ttl``) and reported as a miss."""
        now = self._clock()
        released: Optional[_CacheEntry] = None
        try:
            with self._lock:
                entry = self._entries.get(key)
                if entry is None:
                    self._stats["misses"] += 1
                    return "miss", None
                age = now - entry.inserted_at
                if age <= self.ttl_s:
                    self._entries.move_to_end(key)
                    entry.hits += 1
                    self._stats["hits"] += 1
                    return "hit", entry
                if (self.stale_while_revalidate_s
                        and age <= self.ttl_s + self.stale_while_revalidate_s):
                    self._entries.move_to_end(key)
                    entry.hits += 1
                    self._stats["stale_hits"] += 1
                    return "stale", entry
                released = self._entries.pop(key)
                self._account_remove_locked(released)
                self._stats["evictions"]["ttl"] += 1
                self._stats["misses"] += 1
                return "miss", None
        finally:
            if released is not None:
                released.release()  # outside the lock: may take arena locks

    # -- insert ------------------------------------------------------------
    @staticmethod
    def _serialize_output(datatype: str, arr: np.ndarray):
        """One output's staged payload: exactly the arena lease encoding
        that ``ArenaLease.as_numpy(datatype, shape)`` decodes back."""
        if datatype == "BYTES" or arr.dtype == np.object_ \
                or arr.dtype.kind in ("S", "U"):
            s = serialize_byte_tensor(arr)
            return s.item() if s.size else b""
        if datatype == "BF16":
            s = serialize_bf16_tensor(arr)
            return s.item() if s.size else b""
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)

    def insert(self, key: str, model: str, result,
               tenant: Optional[str] = None) -> Optional[_CacheEntry]:
        """Stage one successful response into the cache; returns the new
        entry, or None when the response is uncacheable (an output whose
        payload the client cannot decode — e.g. a non-arena shm region).
        Errors must never reach here: the wrapper only inserts successes.
        ``tenant`` selects the partition charged (and reclaimed from) —
        eviction never crosses into another tenant's partition."""
        outputs: Dict[str, Tuple[str, Tuple[int, ...], Any]] = {}
        out_rows: List[Dict[str, Any]] = []
        nbytes = 0
        try:
            response = result.get_response()
            for out in response.get("outputs", []) or []:
                name = out.get("name")
                datatype = out.get("datatype")
                shape = tuple(int(d) for d in out.get("shape") or ())
                arr = result.as_numpy(name)
                if arr is None:
                    raise _Uncacheable()
                lease = self.arena.stage(
                    self._serialize_output(datatype, arr))
                outputs[name] = (datatype, shape, lease)
                nbytes += lease.byte_size
                # the sanitized header: wire-body byte counts and shm
                # params describe buffers this entry does not hold
                row = {k: v for k, v in out.items() if k != "parameters"}
                params = {
                    k: v for k, v in (out.get("parameters") or {}).items()
                    if k not in ("binary_data_size", "shared_memory_region",
                                 "shared_memory_byte_size",
                                 "shared_memory_offset")}
                if params:
                    row["parameters"] = params
                out_rows.append(row)
        except _Uncacheable:
            for _, _, lease in outputs.values():
                lease.release()
            with self._lock:
                self._stats["uncacheable"] += 1
            return None
        except BaseException:
            for _, _, lease in outputs.values():
                lease.release()
            raise
        header = {k: v for k, v in response.items()
                  if k != "raw_output_contents"}
        header["outputs"] = out_rows
        entry = _CacheEntry(key, model, header, outputs, nbytes,
                            self._clock(), tenant)
        victims: List[_CacheEntry] = []
        oversize = False
        with self._lock:
            self._register_partition_locked(tenant, victims)
            byte_budget, _ = self._partition_budget_locked(tenant)
            if nbytes > byte_budget:
                # oversize is judged against the PARTITION's budget: a
                # response no amount of own-partition eviction could fit
                self._stats["evictions"]["oversize"] += 1
                oversize = True
            else:
                old = self._entries.pop(key, None)
                if old is not None:
                    victims.append(old)
                    self._account_remove_locked(old)
                    self._stats["evictions"]["replaced"] += 1
                self._entries[key] = entry
                self._account_add_locked(entry)
                self._stats["insertions"] += 1
                self._evict_tenant_locked(tenant, victims, newcomer=entry)
        if oversize:
            for _, _, lease in outputs.values():
                lease.release()
        for victim in victims:
            victim.release()
        return None if oversize else entry

    # -- invalidation ------------------------------------------------------
    def invalidate(self, model: Optional[str] = None,
                   key: Optional[str] = None) -> int:
        """Drop entries by model name, by exact key, or (neither given)
        ALL entries. Returns the number dropped."""
        victims: List[_CacheEntry] = []
        with self._lock:
            if key is not None:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    victims.append(entry)
            else:
                for k in [k for k, e in self._entries.items()
                          if model is None or e.model == model]:
                    victims.append(self._entries.pop(k))
            for victim in victims:
                self._account_remove_locked(victim)
            self._stats["invalidations"] += len(victims)
        for victim in victims:
            victim.release()
        return len(victims)

    def clear(self) -> int:
        return self.invalidate()

    # -- read side ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in self._stats.items()}
            s["entries"] = len(self._entries)
            s["bytes_resident"] = self._bytes
            s["max_bytes"] = self.max_bytes
            s["ttl_s"] = self.ttl_s
            lookups = s["hits"] + s["stale_hits"] + s["misses"]
            s["hit_rate"] = (round((s["hits"] + s["stale_hits"]) / lookups, 4)
                             if lookups else None)
            # per-tenant partition rows, only once a real (non-None)
            # tenant has inserted — tenantless stats stay byte-identical
            if any(t is not None for t in self._partitions):
                s["tenants"] = {
                    (t if t is not None else "_default"): {
                        "bytes_resident": self._tenant_bytes.get(t, 0),
                        "entries": self._tenant_entries.get(t, 0),
                        "byte_budget":
                            self._partition_budget_locked(t)[0],
                    }
                    for t in sorted(self._partitions,
                                    key=lambda t: (t is None, t or ""))
                }
        return s


class _Uncacheable(Exception):
    """Internal: an output's payload cannot be staged client-side."""


def _fan_error(error: Optional[BaseException]) -> Optional[BaseException]:
    """What a collapsed follower should see for its leader's failure: the
    SAME typed error for real failures, but an interrupted/cancelled
    leader (KeyboardInterrupt, asyncio cancellation) must NOT propagate
    its control-flow exception into tasks that were never interrupted —
    followers get a typed retryable error instead."""
    if error is None or isinstance(error, Exception):
        return error
    return InferenceServerException(
        "singleflight leader was interrupted/cancelled before completing; "
        "retry the request", status="499")


# live caches (the doctor's cache section enumerates these)
_CACHES: "weakref.WeakSet[ResponseCache]" = weakref.WeakSet()


def caches() -> List[ResponseCache]:
    """Every live ResponseCache in this process."""
    return list(_CACHES)


class _Flight:
    """One in-flight singleflight group: the leader publishes its outcome
    here and every collapsed follower reads it. ``entry`` set = serve a
    fresh cache view; else ``result`` is the shared transport result."""

    __slots__ = ("cond", "done", "entry", "result", "error", "followers",
                 "future")

    def __init__(self):
        self.cond = threading.Condition()
        self.done = False
        self.entry: Optional[_CacheEntry] = None
        self.result = None
        self.error: Optional[BaseException] = None
        self.followers = 0
        self.future = None  # aio only

    def materialize(self):
        if self.entry is not None:
            return CachedInferResult(self.entry)
        return self.result


class _CachingCore:
    """Construction, eligibility, accounting and cache plumbing shared by
    the sync and asyncio wrappers."""

    _AIO = False

    def __init__(
        self,
        client,
        protocol: str = "http",
        cache=True,
        singleflight: bool = True,
        ttl_s: float = 30.0,
        max_bytes: int = 64 * 1024 * 1024,
        max_entries: int = 4096,
        stale_while_revalidate_s: float = 0.0,
        arena=None,
        tenancy=None,
        telemetry=None,
    ):
        """``client``: an existing frontend/pool/batching client to wrap,
        or a ``host:port`` url (built with ``protocol``). ``cache``: a
        :class:`ResponseCache` to share, ``True`` to build one from
        ``ttl_s``/``max_bytes``/``max_entries``/
        ``stale_while_revalidate_s``/``arena``, or ``None``/``False`` for
        singleflight-only operation (no entries retained). ``tenancy``:
        a ``client_tpu_torch.tenancy.TenancyPolicy`` whose per-tenant
        ``cache_bytes`` declarations size the cache's tenant partitions
        (forwarded to the built :class:`ResponseCache`). ``telemetry``:
        an ``observe.Telemetry``; when omitted the inner client's is
        adopted."""
        if isinstance(client, str):
            from .pool import _default_client_factory

            client = _default_client_factory(protocol, self._AIO)(client)
        self._inner = client
        if cache is True:
            cache = ResponseCache(
                ttl_s=ttl_s, max_bytes=max_bytes, max_entries=max_entries,
                stale_while_revalidate_s=stale_while_revalidate_s,
                arena=arena, tenancy=tenancy)
        elif cache is False:
            cache = None
        self._cache: Optional[ResponseCache] = cache
        self._singleflight = bool(singleflight)
        if self._cache is None and not self._singleflight:
            raise ValueError(
                "a CachingClient with cache=None and singleflight=False "
                "would be a no-op wrapper")
        self._frontend = f"{getattr(client, '_FRONTEND', 'client')}+cache"
        self._flights_lock = threading.Lock()
        self._flights: Dict[str, _Flight] = {}
        self._closed = False
        self._stats_lock = threading.Lock()
        self._counts = {
            "bypass": 0, "hit": 0, "stale": 0, "miss": 0,
            "collapsed": 0, "revalidations": 0, "revalidate_errors": 0,
        }
        self._telemetry = None
        self._instruments = None
        if telemetry is None:
            accessor = getattr(client, "telemetry", None)
            if callable(accessor):
                try:
                    telemetry = accessor()
                except Exception:
                    telemetry = None
        if telemetry is not None:
            self.configure_telemetry(telemetry)

    # -- configuration -------------------------------------------------------
    def configure_telemetry(self, telemetry):
        """Install (or clear) the telemetry this wrapper reports into:
        per-caller spans with a ``cache_lookup`` phase, hit/miss/collapse
        counters, and scrape-time residency gauges. The inner client's
        telemetry (tracing the wire request on a miss) is configured
        separately on the inner client."""
        self._telemetry = telemetry
        if telemetry is None:
            self._instruments = None
            return self
        reg = telemetry.registry
        requests = reg.counter(
            "client_tpu_cache_requests_total",
            "Caller-level infers through the caching wrapper, by outcome "
            "(hit/stale/miss/bypass)", ("model", "outcome"))
        collapsed = reg.counter(
            "client_tpu_singleflight_collapsed_total",
            "Callers that rode another caller's in-flight identical "
            "request instead of issuing their own", ("model",))
        bytes_gauge = reg.gauge(
            "client_tpu_cache_bytes_resident",
            "Bytes held by live response-cache entries (arena slabs)")
        entries_gauge = reg.gauge(
            "client_tpu_cache_entries", "Live response-cache entries")
        evictions_gauge = reg.gauge(
            "client_tpu_cache_evictions_total",
            "Cache evictions by reason (cumulative, exported at scrape)",
            ("reason",))
        self._instruments = (requests, collapsed)
        cache = self._cache
        if cache is not None:
            cache_ref = weakref.ref(cache)

            def collect() -> None:
                c = cache_ref()
                if c is None:
                    return
                s = c.stats()
                bytes_gauge.set(s["bytes_resident"])
                entries_gauge.set(s["entries"])
                for reason, n in s["evictions"].items():
                    evictions_gauge.labels(reason).set(n)

            reg.add_collector(collect)
        return self

    def telemetry(self):
        return self._telemetry

    def cache(self) -> Optional[ResponseCache]:
        return self._cache

    def invalidate(self, model: Optional[str] = None,
                   key: Optional[str] = None) -> int:
        """Explicitly drop cached entries (see ResponseCache.invalidate);
        0 when running singleflight-only."""
        if self._cache is None:
            return 0
        return self._cache.invalidate(model=model, key=key)

    # -- accounting ----------------------------------------------------------
    def _count(self, model: str, outcome: str) -> None:
        with self._stats_lock:
            self._counts[outcome] += 1
        instruments = self._instruments
        if instruments is not None:
            requests, collapsed = instruments
            if outcome == "collapsed":
                collapsed.labels(model).inc()
            else:
                requests.labels(model, outcome).inc()

    # note: no ``stats()`` here on purpose — the name belongs to the
    # batching dispatcher, and ``pool.coalescing().caching()`` must keep
    # delegating it through __getattr__; this wrapper's row is cache_stats
    def cache_stats(self) -> Dict[str, Any]:
        """One JSON-ready row: wrapper outcome counts + the cache's own
        stats. ``wire_requests`` counts the infers that actually reached
        the inner client (misses + background revalidations); everything
        else was served client-side."""
        with self._stats_lock:
            counts = dict(self._counts)
        row: Dict[str, Any] = dict(counts)
        row["singleflight_collapsed"] = counts["collapsed"]
        row["wire_requests"] = counts["miss"] + counts["revalidations"]
        served = (counts["hit"] + counts["stale"] + counts["miss"]
                  + counts["collapsed"])
        row["logical_requests"] = served
        row["collapse_ratio"] = (
            round(1.0 - row["wire_requests"] / served, 4) if served else 0.0)
        # caller-level hit rate: followers probe the cache before they
        # collapse, so the cache's internal miss count over-counts — the
        # honest denominator is callers served, not cache probes
        row["hit_rate"] = (
            round((counts["hit"] + counts["stale"]) / served, 4)
            if served else None)
        if self._cache is not None:
            cs = self._cache.stats()
            row["cache"] = cs
            row["bytes_resident"] = cs["bytes_resident"]
            row["entries"] = cs["entries"]
        else:
            row["bytes_resident"] = 0
            row["entries"] = 0
        return row

    # -- span plumbing --------------------------------------------------------
    def _begin_span(self, model: str):
        tel = self._telemetry
        if tel is None:
            return None
        return tel.begin(self._frontend, model)

    def _finish_span(self, span, t0: int, t1: int, t2: Optional[int],
                     outcome: str, error=None) -> None:
        tel = self._telemetry
        if tel is None or span is None:
            return
        span.phase("cache_lookup", t0, t1)
        if t2 is not None:
            span.phase("attempt", t1, t2)
        span.event("cache", outcome=outcome)
        tel.finish(span, error=error)

    # -- shared helpers -------------------------------------------------------
    def _plan_key(self, model_name: str, inputs, kwargs) -> Optional[str]:
        if self._closed:
            return None
        plan = plan_request(inputs, kwargs)
        if plan is None:
            return None
        return _digest(model_name, plan)

    @staticmethod
    def _revalidate_args(inputs, kwargs):
        """Detached copies for a background refresh: the caller may
        re-stage its InferInput objects the moment we return the stale
        view, so the refresh rebuilds inputs from the staged bytes."""
        from ._tensor import InferInput

        fresh = []
        for inp in inputs:
            clone = InferInput(inp.name(), list(inp.shape()), inp.datatype())
            clone._raw_data = bytes(inp._get_binary_data())
            fresh.append(clone)
        kw = dict(kwargs)
        kw.pop("request_id", None)
        return fresh, kw

    # -- generic surface delegation -------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._inner, name)


class CachingClient(_CachingCore):
    """Synchronous singleflight + response-cache wrapper over any sync
    frontend, pool or batching client. ``infer`` runs the collapse/cache
    engine; ``load_model``/``unload_model`` delegate then invalidate; every
    other method is delegated untouched."""

    _AIO = False

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        if self._cache is not None:
            self._cache.clear()
        self._inner.close()

    def __enter__(self) -> "CachingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- model admin: automatic invalidation ----------------------------------
    def load_model(self, model_name: str, *args, **kwargs):
        """Delegate (a pool broadcasts to every replica), then drop the
        model's cached responses — a (re)loaded model may answer
        differently."""
        try:
            return self._inner.load_model(model_name, *args, **kwargs)
        finally:
            self.invalidate(model=model_name)

    def unload_model(self, model_name: str, *args, **kwargs):
        try:
            return self._inner.unload_model(model_name, *args, **kwargs)
        finally:
            self.invalidate(model=model_name)

    # -- inference -------------------------------------------------------------
    def infer(self, model_name: str, inputs, *args, **kwargs):
        """Collapsing/caching ``infer`` (drop-in: positionals follow the
        frontends' shared prefix). Ineligible requests bypass verbatim; a
        hit returns a zero-copy :class:`CachedInferResult`; concurrent
        identical misses collapse onto one inner request."""
        kwargs = fold_infer_args(args, kwargs)
        inputs = list(inputs) if inputs is not None else inputs
        key = self._plan_key(model_name, inputs, kwargs)
        if key is None:
            self._count(model_name, "bypass")
            return self._inner.infer(model_name, inputs, **kwargs)
        scratch = _flight_recorder.layer_begin(
            self._telemetry, "cache", model_name)
        if scratch is None:
            return self._infer_keyed(key, model_name, inputs, kwargs)
        try:
            result = self._infer_keyed(key, model_name, inputs, kwargs)
        except BaseException as e:
            _flight_recorder.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight_recorder.layer_commit(self._telemetry, scratch)
        return result

    def _infer_keyed(self, key, model_name: str, inputs, kwargs):
        """The lookup/collapse engine behind :meth:`infer` (split out so
        the flight-recorder wrapper above owns one scratch per caller —
        a pure cache hit's timeline is just cache events, no wire leg)."""
        span = self._begin_span(model_name)
        t0 = time.perf_counter_ns()
        cache = self._cache
        if cache is not None:
            state, entry = cache.lookup(key)
            t1 = time.perf_counter_ns()
            if state == "hit":
                self._count(model_name, "hit")
                _flight_recorder.note("cache", "hit")
                self._finish_span(span, t0, t1, None, "hit")
                return CachedInferResult(entry)
            if state == "stale":
                self._count(model_name, "stale")
                _flight_recorder.note("cache", "stale_refresh")
                self._spawn_revalidation(key, model_name, inputs, kwargs)
                self._finish_span(span, t0, t1, None, "stale")
                return CachedInferResult(entry, stale=True)
        else:
            t1 = time.perf_counter_ns()
        if not self._singleflight:
            _flight_recorder.note("cache", "miss")
            return self._miss(key, model_name, inputs, kwargs, span, t0, t1)
        with self._flights_lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
            else:
                flight.followers += 1
                leader = False
        if leader:
            _flight_recorder.note("cache", "leader", key=key[:12])
            return self._lead(flight, key, model_name, inputs, kwargs,
                              span, t0, t1)
        _flight_recorder.note("cache", "follower", key=key[:12])
        with flight.cond:
            while not flight.done:
                flight.cond.wait()
        t2 = time.perf_counter_ns()
        self._count(model_name, "collapsed")
        _flight_recorder.note("cache", "collapsed")
        self._finish_span(span, t0, t1, t2, "collapsed", error=flight.error)
        if flight.error is not None:
            raise flight.error
        return flight.materialize()

    def _miss(self, key, model_name, inputs, kwargs, span, t0, t1):
        """Cache-only miss (singleflight disabled): fetch, insert, serve."""
        error: Optional[BaseException] = None
        result = entry = None
        try:
            result = self._inner.infer(model_name, inputs, **kwargs)
        except BaseException as e:
            error = e
        t2 = time.perf_counter_ns()
        if error is None and self._cache is not None:
            entry = self._cache.insert(key, model_name, result,
                                           tenant=kwargs.get("tenant"))
        self._count(model_name, "miss")
        self._finish_span(span, t0, t1, t2, "miss", error=error)
        if error is not None:
            raise error
        return CachedInferResult(entry) if entry is not None else result

    def _lead(self, flight, key, model_name, inputs, kwargs, span, t0, t1):
        error: Optional[BaseException] = None
        result = entry = None
        try:
            result = self._inner.infer(model_name, inputs, **kwargs)
        except BaseException as e:
            error = e  # errors are NEVER cached; fanned to every follower
        t2 = time.perf_counter_ns()
        if error is None and self._cache is not None:
            try:
                entry = self._cache.insert(key, model_name, result,
                                           tenant=kwargs.get("tenant"))
            except BaseException as e:
                # a broken insert (arena closed mid-flight) must not turn
                # a SERVED answer into an error — serve the wire result
                entry = None
                if not isinstance(e, Exception):
                    error = e
        # retire the flight BEFORE settling: a caller arriving after the
        # settle must start a fresh flight, never join a finished one
        with self._flights_lock:
            self._flights.pop(key, None)
        with flight.cond:
            flight.error = _fan_error(error)
            flight.entry = entry
            flight.result = result if error is None else None
            flight.done = True
            flight.cond.notify_all()
        self._count(model_name, "miss")
        self._finish_span(span, t0, t1, t2, "miss", error=error)
        if error is not None:
            raise error
        return CachedInferResult(entry) if entry is not None else result

    def _spawn_revalidation(self, key, model_name, inputs, kwargs) -> None:
        """ONE background refresh per stale key, deduplicated through the
        singleflight table (a concurrent true miss after full expiry joins
        it as a follower). Failures leave the stale entry in place — it
        ages out at ttl + stale window."""
        with self._flights_lock:
            if key in self._flights:
                return  # refresh (or a miss) already in flight
            flight = _Flight()
            self._flights[key] = flight
        fresh_inputs, kw = self._revalidate_args(inputs, kwargs)

        def run() -> None:
            error: Optional[BaseException] = None
            result = entry = None
            try:
                result = self._inner.infer(model_name, fresh_inputs, **kw)
            except BaseException as e:
                error = e
            if error is None and self._cache is not None:
                try:
                    entry = self._cache.insert(key, model_name, result,
                                           tenant=kwargs.get("tenant"))
                except Exception:
                    entry = None
            with self._flights_lock:
                self._flights.pop(key, None)
            with flight.cond:
                flight.error = _fan_error(error)
                flight.entry = entry
                flight.result = result if error is None else None
                flight.done = True
                flight.cond.notify_all()
            with self._stats_lock:
                self._counts["revalidations"] += 1
                if error is not None:
                    self._counts["revalidate_errors"] += 1

        threading.Thread(target=run, name="client_tpu_cache_revalidate",
                         daemon=True).start()


class AioCachingClient(_CachingCore):
    """Asyncio twin of :class:`CachingClient` over the aio frontends (or
    an ``AioPoolClient``/``AioBatchingClient``). Flights are futures;
    stale revalidation runs as a background task."""

    _AIO = True

    def __init__(self, client, **kwargs):
        super().__init__(client, **kwargs)
        self._revalidate_tasks: set = set()

    # -- lifecycle -----------------------------------------------------------
    async def close(self) -> None:
        self._closed = True
        for task in list(self._revalidate_tasks):
            task.cancel()
        if self._revalidate_tasks:
            await asyncio.gather(*list(self._revalidate_tasks),
                                 return_exceptions=True)
        if self._cache is not None:
            self._cache.clear()
        result = self._inner.close()
        if asyncio.iscoroutine(result):
            await result

    async def __aenter__(self) -> "AioCachingClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- model admin: automatic invalidation ----------------------------------
    async def load_model(self, model_name: str, *args, **kwargs):
        try:
            return await self._inner.load_model(model_name, *args, **kwargs)
        finally:
            self.invalidate(model=model_name)

    async def unload_model(self, model_name: str, *args, **kwargs):
        try:
            return await self._inner.unload_model(model_name, *args, **kwargs)
        finally:
            self.invalidate(model=model_name)

    # -- inference -------------------------------------------------------------
    async def infer(self, model_name: str, inputs, *args, **kwargs):
        """Collapsing/caching async ``infer`` (same eligibility/bypass
        contract as the sync twin)."""
        kwargs = fold_infer_args(args, kwargs)
        inputs = list(inputs) if inputs is not None else inputs
        key = self._plan_key(model_name, inputs, kwargs)
        if key is None:
            self._count(model_name, "bypass")
            return await self._inner.infer(model_name, inputs, **kwargs)
        scratch = _flight_recorder.layer_begin(
            self._telemetry, "cache", model_name)
        if scratch is None:
            return await self._infer_keyed(key, model_name, inputs, kwargs)
        try:
            result = await self._infer_keyed(key, model_name, inputs,
                                             kwargs)
        except BaseException as e:
            _flight_recorder.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight_recorder.layer_commit(self._telemetry, scratch)
        return result

    async def _infer_keyed(self, key, model_name: str, inputs, kwargs):
        """Async twin of the sync ``_infer_keyed`` split."""
        span = self._begin_span(model_name)
        t0 = time.perf_counter_ns()
        cache = self._cache
        if cache is not None:
            state, entry = cache.lookup(key)
            t1 = time.perf_counter_ns()
            if state == "hit":
                self._count(model_name, "hit")
                _flight_recorder.note("cache", "hit")
                self._finish_span(span, t0, t1, None, "hit")
                return CachedInferResult(entry)
            if state == "stale":
                self._count(model_name, "stale")
                _flight_recorder.note("cache", "stale_refresh")
                self._spawn_revalidation(key, model_name, inputs, kwargs)
                self._finish_span(span, t0, t1, None, "stale")
                return CachedInferResult(entry, stale=True)
        else:
            t1 = time.perf_counter_ns()
        if not self._singleflight:
            _flight_recorder.note("cache", "miss")
            return await self._fetch(key, model_name, inputs, kwargs,
                                     span, t0, t1, flight=None)
        loop = asyncio.get_running_loop()
        flight = self._flights.get(key)
        if flight is not None and flight.future is not None:
            # follower: await the leader's published outcome
            _flight_recorder.note("cache", "follower", key=key[:12])
            try:
                outcome = await asyncio.shield(flight.future)
            except BaseException:
                t2 = time.perf_counter_ns()
                self._count(model_name, "collapsed")
                self._finish_span(span, t0, t1, t2, "collapsed",
                                  error=flight.error)
                raise
            t2 = time.perf_counter_ns()
            self._count(model_name, "collapsed")
            _flight_recorder.note("cache", "collapsed")
            self._finish_span(span, t0, t1, t2, "collapsed")
            entry, result = outcome
            return CachedInferResult(entry) if entry is not None else result
        flight = _Flight()
        flight.future = loop.create_future()
        self._flights[key] = flight
        _flight_recorder.note("cache", "leader", key=key[:12])
        return await self._fetch(key, model_name, inputs, kwargs,
                                 span, t0, t1, flight=flight)

    async def _fetch(self, key, model_name, inputs, kwargs, span, t0, t1,
                     flight: Optional[_Flight]):
        error: Optional[BaseException] = None
        result = entry = None
        try:
            result = await self._inner.infer(model_name, inputs, **kwargs)
        except BaseException as e:
            error = e
        t2 = time.perf_counter_ns()
        if error is None and self._cache is not None:
            try:
                entry = self._cache.insert(key, model_name, result,
                                           tenant=kwargs.get("tenant"))
            except Exception:
                entry = None
        if flight is not None:
            self._flights.pop(key, None)
            fan = _fan_error(error)  # never a CancelledError for followers
            flight.error = fan
            if not flight.future.done():
                if fan is not None:
                    flight.future.set_exception(fan)
                    # the leader re-raises its own error below; followers
                    # consume the future's
                    flight.future.exception()
                else:
                    flight.future.set_result((entry, result))
        self._count(model_name, "miss")
        self._finish_span(span, t0, t1, t2, "miss", error=error)
        if error is not None:
            raise error
        return CachedInferResult(entry) if entry is not None else result

    def _spawn_revalidation(self, key, model_name, inputs, kwargs) -> None:
        if key in self._flights:
            return
        flight = _Flight()
        flight.future = asyncio.get_running_loop().create_future()
        self._flights[key] = flight
        fresh_inputs, kw = self._revalidate_args(inputs, kwargs)

        async def run() -> None:
            error: Optional[BaseException] = None
            result = entry = None
            try:
                result = await self._inner.infer(model_name, fresh_inputs,
                                                 **kw)
            except BaseException as e:
                error = e
            if error is None and self._cache is not None:
                try:
                    entry = self._cache.insert(key, model_name, result,
                                           tenant=kwargs.get("tenant"))
                except Exception:
                    entry = None
            self._flights.pop(key, None)
            fan = _fan_error(error)
            flight.error = fan
            if not flight.future.done():
                if fan is not None:
                    flight.future.set_exception(fan)
                    flight.future.exception()  # consumed: may have no waiter
                else:
                    flight.future.set_result((entry, result))
            with self._stats_lock:
                self._counts["revalidations"] += 1
                if error is not None:
                    self._counts["revalidate_errors"] += 1
            if error is not None and not isinstance(error, Exception):
                raise error  # cancellation at close(): honor it

        task = asyncio.ensure_future(run())
        self._revalidate_tasks.add(task)
        task.add_done_callback(self._revalidate_tasks.discard)
