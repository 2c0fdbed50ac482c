"""Health-aware multi-endpoint pool: failover, hedging, outlier ejection.

The port of ``client_tpu.pool``. The resilience layer makes a *single*
endpoint survivable; production
deployments front a fleet of replica servers and need the client to keep
working when one of them dies, degrades, or drains. This module is that
layer: an :class:`EndpointPool` (the transport-free health/routing engine)
plus :class:`PoolClient` / :class:`AioPoolClient` wrappers exposing the
familiar ``InferenceServerClient`` API over N server URLs — constructible
over all four frontends (HTTP sync/aio, GRPC sync/aio)::

    from client_tpu_torch.pool import PoolClient

    client = PoolClient(["10.0.0.1:8000", "10.0.0.2:8000"], protocol="http")
    client.infer("simple", inputs)          # routed, failed over, hedged
    client.endpoint_stats()                 # per-endpoint snapshot

What the pool provides:

- **Active health probing** — a background prober calls each endpoint's
  ``is_server_ready(probe=True)`` (the KServe v2 ready endpoint in
  probe mode: connect-class failures return ``False`` instead of raising)
  every ``health_interval_s``; an unready endpoint stops receiving traffic
  until the probe succeeds again. A *draining* replica (ready flipped
  false, still serving) is routed away from before its socket disappears.
- **Passive outlier ejection** — ``resilience.classify_fault`` outcomes
  feed per-endpoint consecutive-failure counters; ``eject_after``
  consecutive transport failures eject the endpoint for an exponentially
  growing window (``base_ejection_s * multiplier^k``, capped at
  ``max_ejection_s``), Envoy-style. At most ``ceil(N/2)`` replicas are
  ever ejected at once — the pool degrades before it self-blinds.
- **Routing policies** — ``round_robin``, ``least_outstanding``,
  ``weighted`` (smooth weighted round-robin over static weights), and
  ``orca_weighted`` (smooth-WRR over weights derived from the servers'
  TTL-fresh ORCA ``endpoint-load-metrics`` reports, hysteresis-smoothed,
  falling back to least-outstanding whenever any replica's load is stale
  or absent), each honoring health, ejection, the per-endpoint
  :class:`~client_tpu_torch.resilience.CircuitBreaker` (an endpoint whose
  breaker is open is never selected; a half-open endpoint receives
  exactly the probes its breaker admits) and, when armed, the
  per-endpoint adaptive concurrency limit.
- **Admission control** — ``admission=`` installs a pool-level
  :class:`~client_tpu_torch.admission.AdmissionController` (adaptive limiter +
  priority lanes + deadline-aware shedding): one token covers the whole
  failover/hedge run, saturated requests raise the typed
  ``AdmissionRejected`` (counted as *shed*, never error), and
  ``endpoint_limits=`` adds a per-replica adaptive limit that selection
  honors like a breaker.
- **Transparent failover** — one shared
  :class:`~client_tpu_torch.resilience.AttemptBudget` deadline across replicas;
  re-attempts obey the resilience layer's idempotency rule: a sequence request
  (``sequence_id != 0``) whose in-flight attempt died is NEVER silently
  re-sent to another replica — a typed :class:`SequenceAbandoned` event
  is delivered to ``on_event`` and the original error raises.
- **Hedged requests** — for idempotent infers with hedging armed, the
  request is issued to a second replica after a hedge delay (default:
  the rolling p95 of recent pool latencies, plus injectable-rng jitter);
  the first success wins and the loser is cancelled (true cancellation
  on asyncio, best-effort on threads). Sequence requests never hedge.

GRPC bidi streams are NOT pooled: ``start_stream`` selects one endpoint
and PINS the stream there — ``async_stream_infer`` / ``stop_stream``
route to that same endpoint until the stream stops (use
the stream's ``auto_reconnect`` for same-endpoint stream recovery).

Server-side *state* is fleet state: registration/admin mutators
(``register_*`` / ``unregister_*`` / ``load_model`` / ``unload_model`` /
``update_*`` settings, plus client plugins) are BROADCAST to every
endpoint instead of landing on one arbitrary replica; read-only calls
delegate to a single healthy endpoint under the failover engine.
"""

from __future__ import annotations

import asyncio
import hashlib
import inspect
import math
import random
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import flight as _flight
from ._base import (
    consume_admission_phase,
    fold_infer_args,
    stash_admission_phase,
)
from .admission import (
    AdaptiveLimiter,
    AdmissionController,
    AdmissionRejected,
    SHED_ENDPOINT_SATURATED,
)
from .resilience import (
    CONNECT,
    FATAL,
    INVALID,
    SHED,
    TIMEOUT,
    TRANSIENT,
    AttemptBudget,
    CircuitBreaker,
    CircuitOpenError,
    ResiliencePolicy,
    RetryPolicy,
    classify_fault,
)
from .utils import InferenceServerException, sorted_percentile

__all__ = [
    "ROUND_ROBIN",
    "LEAST_OUTSTANDING",
    "WEIGHTED",
    "ORCA_WEIGHTED",
    "AFFINITY",
    "AioPoolClient",
    "EndpointEjected",
    "EndpointHealthChanged",
    "EndpointPool",
    "EndpointQuarantined",
    "EndpointReadmitted",
    "EndpointSpec",
    "HedgePolicy",
    "NoEndpointAvailableError",
    "PoolClient",
    "RoleFallback",
    "SequenceAbandoned",
    "load_score",
]

ROUND_ROBIN = "round_robin"
LEAST_OUTSTANDING = "least_outstanding"
WEIGHTED = "weighted"
ORCA_WEIGHTED = "orca_weighted"
AFFINITY = "affinity"
_ROUTING_POLICIES = (ROUND_ROBIN, LEAST_OUTSTANDING, WEIGHTED, ORCA_WEIGHTED,
                     AFFINITY)

# orca_weighted tuning: the weight floor keeps a slammed replica barely
# in rotation (so its load reports keep flowing and recovery is visible);
# hysteresis ignores weight moves smaller than this fraction of the old
# weight (ORCA reports arrive per-response — routing must not thrash on
# report-to-report jitter); smoothing is the EWMA step for moves that DO
# clear the hysteresis band
_ORCA_WEIGHT_FLOOR = 0.05
_ORCA_HYSTERESIS = 0.10
_ORCA_SMOOTHING = 0.5
# utilization dominates the blend when both signals exist; qps fills in
# relative pressure between replicas reporting equal utilization
_ORCA_QPS_BLEND = 0.3

# affinity routing: a key's home may carry at most ``bound * fair-share``
# outstanding requests before the key deterministically spills to the
# next endpoint in its rendezvous order (bounded-load consistent hashing:
# a drowned home sheds overflow instead of queueing hot keys behind it)
_AFFINITY_BOUND = 2.0
# per-endpoint distinct-key tracking cap (doctor's affinity_skew signal);
# past it the count saturates rather than growing without bound
_AFFINITY_KEY_CAP = 2048


def _affinity_ranked(key_digest: bytes,
                     endpoints: Sequence["EndpointState"],
                     ) -> List["EndpointState"]:
    """Rendezvous (highest-random-weight) order of ``endpoints`` for one
    key: a pure function of (key, url) — every client ranks identically,
    and removing an endpoint never re-homes keys owned by the others."""
    return sorted(
        endpoints,
        key=lambda ep: hashlib.blake2b(
            key_digest + ep.url.encode(), digest_size=8).digest(),
        reverse=True)


def load_score(load, max_qps: Optional[float] = None,
               max_busy_us: Optional[float] = None) -> Optional[float]:
    """One ORCA report -> a busy score in [0, 1] (higher = more loaded).

    Prefers the standard ORCA utilization signals
    (``application_utilization``, ``cpu_utilization``, or the max over a
    ``utilization.*`` map), blended with relative QPS
    (``rps_fractional``/``qps`` against the fleet max) when present.
    Falls back to the in-repo server's
    ``named_metrics.avg_compute_infer_us`` (relative to the fleet max) so
    orca_weighted works against servers that report busy-time rather
    than utilization. Returns None when the report carries no usable
    signal."""
    metrics = load.metrics
    util = metrics.get("application_utilization")
    if util is None:
        util = metrics.get("cpu_utilization")
    if util is None:
        subs = [v for k, v in metrics.items() if k.startswith("utilization")]
        util = max(subs) if subs else None
    qps = metrics.get("rps_fractional", metrics.get("qps"))
    qps_norm = (qps / max_qps if qps is not None and max_qps else None)
    if util is not None:
        util = min(max(float(util), 0.0), 1.0)
        if qps_norm is not None:
            return ((1.0 - _ORCA_QPS_BLEND) * util
                    + _ORCA_QPS_BLEND * min(max(qps_norm, 0.0), 1.0))
        return util
    if qps_norm is not None:
        return min(max(qps_norm, 0.0), 1.0)
    busy = metrics.get("named_metrics.avg_compute_infer_us")
    if busy is not None and max_busy_us:
        return min(max(float(busy) / max_busy_us, 0.0), 1.0)
    return None


class NoEndpointAvailableError(InferenceServerException):
    """Every endpoint is ejected/unhealthy/breaker-open (or excluded)."""

    def __init__(self, msg: str = "no endpoint available in the pool"):
        super().__init__(msg, status="POOL_EXHAUSTED")


# -- typed pool events --------------------------------------------------------
class PoolEvent:
    """Base for events delivered to the pool's ``on_event`` callback."""

    __slots__ = ("url",)

    def __init__(self, url: str):
        self.url = url

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{name}={getattr(self, name)!r}"
            for cls in type(self).__mro__ for name in getattr(cls, "__slots__", ())
        )
        return f"{type(self).__name__}({fields})"


class EndpointEjected(PoolEvent):
    """Passive outlier ejection fired for ``url``."""

    __slots__ = ("window_s", "consecutive_failures", "ejection_count")

    def __init__(self, url, window_s, consecutive_failures, ejection_count):
        super().__init__(url)
        self.window_s = window_s
        self.consecutive_failures = consecutive_failures
        self.ejection_count = ejection_count


class EndpointQuarantined(PoolEvent):
    """Byzantine-replica quarantine fired for ``url``: ``invalid_count``
    contract-violating responses (resilience's INVALID domain) landed
    inside the quarantine window, so the endpoint is ejected for
    ``window_s`` with the usual exponential backoff. Unlike transport
    ejection this is evidence the replica is WRONG, not slow — the
    doctor's ``byzantine_replica`` anomaly names it from this state."""

    __slots__ = ("window_s", "invalid_count", "quarantine_count")

    def __init__(self, url, window_s, invalid_count, quarantine_count):
        super().__init__(url)
        self.window_s = window_s
        self.invalid_count = invalid_count
        self.quarantine_count = quarantine_count


class EndpointReadmitted(PoolEvent):
    """An ejected endpoint's window expired (or it proved itself healthy)."""

    __slots__ = ()


class EndpointHealthChanged(PoolEvent):
    """The active ready-probe flipped this endpoint's health."""

    __slots__ = ("healthy",)

    def __init__(self, url, healthy: bool):
        super().__init__(url)
        self.healthy = healthy


class SequenceAbandoned(PoolEvent):
    """A non-idempotent (sequence) request failed in flight: the pool did
    NOT re-send it to another replica (the server may already have applied
    its state transition). The application owns re-driving the sequence.
    Delivered to ``on_event``; the original transport error still raises."""

    __slots__ = ("request_id", "sequence_id", "cause")

    def __init__(self, url, request_id: str, sequence_id: int,
                 cause: BaseException):
        super().__init__(url)
        self.request_id = request_id
        self.sequence_id = sequence_id
        self.cause = cause


class RoleFallback(PoolEvent):
    """A role-scoped selection found its role empty, saturated or fully
    unavailable and the caller degraded to role-less (monolithic)
    serving. Emitted by the disaggregated prefill/decode layer through
    ``pool.emit`` — degradation is typed and observable, never a silent
    behavior change. ``url`` is the fallback endpoint that absorbed the
    request ('' when even the fallback selection failed)."""

    __slots__ = ("role", "reason")

    def __init__(self, url: str, role: str, reason: str):
        super().__init__(url)
        self.role = role
        self.reason = reason


class EndpointSpec:
    """One replica address plus its serving role.

    Pass instances in a pool's ``urls`` list to label endpoints for
    role-aware selection (disaggregated prefill/decode serving routes
    prefill and decode to differently-labeled replicas)::

        PoolClient([EndpointSpec("h1:8000", role="prefill"),
                    EndpointSpec("h2:8000", role="decode")])

    Plain strings stay role-less (``role=None``) and behave exactly as
    before; role-less endpoints are eligible for every role-less
    selection and serve as the monolithic fallback tier."""

    __slots__ = ("url", "role")

    def __init__(self, url: str, role: Optional[str] = None):
        if not url or not isinstance(url, str):
            raise ValueError("EndpointSpec needs a non-empty url string")
        if role is not None and (not role or not isinstance(role, str)):
            raise ValueError("role must be a non-empty string (or None)")
        self.url = url
        self.role = role

    def __repr__(self) -> str:
        return f"EndpointSpec({self.url!r}, role={self.role!r})"


class HedgePolicy:
    """When and how to hedge an idempotent infer.

    ``delay_s=None`` (default) uses the pool's rolling p95 of recent infer
    latencies — the canonical "hedge after the tail begins" setting; until
    ``min_latency_samples`` latencies are recorded, ``fallback_delay_s``
    is used. ``jitter_frac`` multiplies the delay by ``1 + U(0, frac)``
    drawn from the injectable ``rng`` (deterministic under a seeded rng)
    so synchronized clients don't hedge in lockstep. ``max_hedges`` bounds
    extra in-flight copies per request (1 = primary + one hedge)."""

    def __init__(
        self,
        delay_s: Optional[float] = None,
        fallback_delay_s: float = 0.05,
        jitter_frac: float = 0.1,
        max_hedges: int = 1,
        min_latency_samples: int = 8,
        rng: Optional[random.Random] = None,
    ):
        if max_hedges < 1:
            raise ValueError("max_hedges must be >= 1")
        self.delay_s = delay_s
        self.fallback_delay_s = fallback_delay_s
        self.jitter_frac = jitter_frac
        self.max_hedges = max_hedges
        self.min_latency_samples = min_latency_samples
        self.rng = rng

    def delay(self, rolling_p95_s: Optional[float],
              rng: Optional[random.Random] = None) -> float:
        base = self.delay_s
        if base is None:
            base = (rolling_p95_s if rolling_p95_s is not None
                    else self.fallback_delay_s)
        r = self.rng or rng
        if self.jitter_frac and r is not None:
            base *= 1.0 + r.uniform(0.0, self.jitter_frac)
        return base


class EndpointState:
    """One replica: its client, breaker-backed policy, and outlier state.

    All mutable fields are guarded by the owning pool's lock.
    ``limiter`` (optional) is a per-endpoint
    :class:`~client_tpu_torch.admission.AdaptiveLimiter`: selection skips an
    endpoint whose outstanding count has reached its adaptive limit, and
    ``shed_total`` counts the requests shed because EVERY candidate was
    at its limit. ``_orca_weight`` is the hysteresis-smoothed
    ``orca_weighted`` routing weight (None until the first fresh load)."""

    __slots__ = (
        "url", "client", "policy", "weight", "role", "outstanding", "healthy",
        "consecutive_failures", "ejected", "ejected_until", "ejection_count",
        "last_ejection_end", "_wrr_current", "limiter", "shed_total",
        "_orca_weight", "affinity_routed", "affinity_rehomed",
        "affinity_spilled", "_affinity_keys",
        "invalid_total", "quarantined", "quarantine_count", "_invalid_times",
    )

    def __init__(self, url: str, client: Any, policy: ResiliencePolicy,
                 weight: float = 1.0, limiter: Optional[AdaptiveLimiter] = None,
                 role: Optional[str] = None):
        self.url = url
        self.client = client
        self.policy = policy  # breaker + per-endpoint ResilienceStats
        self.weight = weight
        self.role = role  # serving role label (None = role-less/monolithic)
        self.outstanding = 0
        self.healthy = True
        self.consecutive_failures = 0
        self.ejected = False
        self.ejected_until = 0.0
        self.ejection_count = 0
        self.last_ejection_end = 0.0
        self._wrr_current = 0.0
        self.limiter = limiter
        self.shed_total = 0
        self._orca_weight: Optional[float] = None
        # affinity routing accounting (disjoint: every pick lands in ONE
        # bucket): picks landed here as the key's home (routed), because
        # the home was ineligible (rehomed), or because the home was over
        # its bounded-load limit (spilled) — plus the capped distinct-key
        # set behind the doctor's affinity_skew flag
        self.affinity_routed = 0
        self.affinity_rehomed = 0
        self.affinity_spilled = 0
        self._affinity_keys: set = set()
        # byzantine-replica accounting: contract-violating (INVALID)
        # responses, the sliding timestamp window behind quarantine, and
        # whether the CURRENT ejection is a quarantine (vs transport)
        self.invalid_total = 0
        self.quarantined = False
        self.quarantine_count = 0
        self._invalid_times: deque = deque()


class EndpointPool:
    """The transport-free engine: selection, health, and outlier ejection.

    Thread-safe; shared by the sync and asyncio pool clients. Events are
    emitted OUTSIDE the internal lock (the callback may call back into
    the pool)."""

    def __init__(
        self,
        endpoints: Sequence[EndpointState],
        routing: str = ROUND_ROBIN,
        eject_after: int = 3,
        base_ejection_s: float = 1.0,
        ejection_multiplier: float = 2.0,
        max_ejection_s: float = 30.0,
        ejection_decay_s: float = 60.0,
        latency_window: int = 256,
        clock: Callable[[], float] = time.monotonic,
        on_event: Optional[Callable[[PoolEvent], None]] = None,
        load_lookup: Optional[Callable[[], Dict[str, Any]]] = None,
        affinity_bound: float = _AFFINITY_BOUND,
        quarantine_after: int = 3,
        quarantine_window_s: float = 30.0,
    ):
        """``load_lookup`` (``orca_weighted`` routing): a zero-arg callable
        returning ``{url: observe.EndpointLoad}`` containing ONLY
        TTL-fresh reports — typically ``Telemetry.endpoint_loads``. A pick
        where any candidate lacks a fresh report falls back to
        least-outstanding: the policy never routes on (or divides by) an
        expired load."""
        if not endpoints:
            raise ValueError("pool needs at least one endpoint")
        if routing not in _ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {routing!r} (one of {_ROUTING_POLICIES})")
        if eject_after < 1:
            raise ValueError("eject_after must be >= 1")
        self.endpoints: List[EndpointState] = list(endpoints)
        self.routing = routing
        self.eject_after = eject_after
        self.base_ejection_s = base_ejection_s
        self.ejection_multiplier = ejection_multiplier
        self.max_ejection_s = max_ejection_s
        self.ejection_decay_s = ejection_decay_s
        # at most ceil(N/2) replicas may ever be ejected at once: the pool
        # must degrade (keep trying suspect replicas) before it self-blinds
        self.max_ejected = math.ceil(len(self.endpoints) / 2)
        # RoleFallback emissions per role (role-aware callers degrading to
        # monolithic serving); read by health_summary/doctor
        self.role_fallbacks: Dict[str, int] = {}
        if affinity_bound < 1.0:
            raise ValueError("affinity_bound must be >= 1.0")
        self.affinity_bound = affinity_bound
        if quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        # byzantine quarantine: N INVALID (contract-violating) responses
        # inside the sliding window ejects the endpoint (same backoff +
        # max_ejected guard as transport ejection)
        self.quarantine_after = quarantine_after
        self.quarantine_window_s = quarantine_window_s
        self._clock = clock
        self._on_event = on_event
        self._load_lookup = load_lookup
        # micro-cache over the lookup: loads only change on response
        # ingest, so a few ms of reuse spares the per-pick dict build
        # (and the telemetry-lock acquire) on the hot routing path.
        # Real time on purpose — a test-injected fake pool clock must
        # not freeze the cache across ingests.
        self._load_cache: Any = None
        self._load_cache_at = 0.0
        self._lock = threading.Lock()
        self._rr = 0
        self._latencies: deque = deque(maxlen=latency_window)

    # -- events --------------------------------------------------------------
    def emit(self, event: PoolEvent) -> None:
        if isinstance(event, RoleFallback):
            # counted whether or not anyone listens: the doctor's
            # role_degraded anomaly reads this to prove fallback traffic
            # is actually flowing while a role has no healthy member
            with self._lock:
                self.role_fallbacks[event.role] = (
                    self.role_fallbacks.get(event.role, 0) + 1)
        if self._on_event is None:
            return
        try:
            self._on_event(event)
        except Exception:
            pass  # an observer must never break the data path

    def _emit_all(self, events: List[PoolEvent]) -> None:
        for event in events:
            self.emit(event)

    # -- selection -----------------------------------------------------------
    def _readmit_expired(self, now: float, events: List[PoolEvent]) -> None:
        for ep in self.endpoints:
            if ep.ejected and now >= ep.ejected_until:
                ep.ejected = False
                ep.quarantined = False
                ep.consecutive_failures = 0
                events.append(EndpointReadmitted(ep.url))

    @staticmethod
    def _within_limit(ep: EndpointState) -> bool:
        return ep.limiter is None or ep.limiter.would_admit(ep.outstanding)

    def _orca_weights(self,
                      candidates: List[EndpointState]) -> Optional[Dict[int, float]]:
        """Hysteresis-smoothed smooth-WRR weights from the TTL-fresh load
        reports, or None when ANY candidate lacks a fresh report (the
        whole pick then falls back to least-outstanding — a half-fresh
        weighting would starve exactly the replicas whose reports went
        silent). Caller holds the pool lock."""
        lookup = self._load_lookup
        if lookup is None:
            return None
        now = time.monotonic()
        if self._load_cache is not None and now - self._load_cache_at < 0.002:
            loads = self._load_cache
        else:
            try:
                loads = lookup()  # TTL-filtered by the telemetry
            except Exception:
                return None
            self._load_cache = loads
            self._load_cache_at = now
        if not loads:
            return None
        per_ep = []
        for ep in candidates:
            load = loads.get(ep.url)
            if load is None:
                return None  # stale or absent: never route on it
            per_ep.append((ep, load))
        # fleet-relative normalizers for the qps / busy-time signals
        qps_values = [l.metrics.get("rps_fractional", l.metrics.get("qps"))
                      for _, l in per_ep]
        max_qps = max((q for q in qps_values if q is not None), default=None)
        busy_values = [l.metrics.get("named_metrics.avg_compute_infer_us")
                       for _, l in per_ep]
        max_busy = max((b for b in busy_values if b is not None), default=None)
        weights: Dict[int, float] = {}
        for ep, load in per_ep:
            score = load_score(load, max_qps, max_busy)
            if score is None:
                return None  # a report with no usable signal: fall back
            target = max(1.0 - score, _ORCA_WEIGHT_FLOOR) * ep.weight
            old = ep._orca_weight
            if old is None:
                smoothed = target
            elif abs(target - old) < _ORCA_HYSTERESIS * max(old, 1e-9):
                smoothed = old  # inside the hysteresis band: hold steady
            else:
                smoothed = old + _ORCA_SMOOTHING * (target - old)
            ep._orca_weight = smoothed
            weights[id(ep)] = smoothed
        return weights

    def _pick_affinity(self, candidates: List[EndpointState],
                       affinity_key: str) -> EndpointState:
        """Rendezvous-hash the key onto its home endpoint with a
        bounded-load spill: the winner is the highest-scoring ELIGIBLE
        candidate whose outstanding count is under ``affinity_bound``
        times the candidates' fair share — a saturated home sheds the
        overflow to the key's deterministic runner-up instead of queueing
        hot keys behind one drowning replica. Caller holds the pool lock.
        Re-homing is deterministic: every client ranks (key, url)
        identically, so an ejected/unhealthy/breaker-open home moves the
        key to the SAME fallback everywhere, and the key returns home the
        moment the home becomes eligible again."""
        digest = hashlib.blake2b(
            str(affinity_key).encode(), digest_size=8).digest()
        ranked = _affinity_ranked(digest, candidates)
        # the key's TRUE home ranks over the whole pool, eligible or not:
        # the rehomed-vs-spilled split below must know whether the home
        # was missing from the candidate set or merely over its bound
        home = _affinity_ranked(digest, self.endpoints)[0]
        total = sum(ep.outstanding for ep in candidates)
        limit = max(1.0,
                    self.affinity_bound * (total + 1.0) / len(candidates))
        chosen = None
        for ep in ranked:
            if ep.outstanding < limit:
                chosen = ep
                break
        if chosen is None:
            chosen = ranked[0]  # every candidate over the bound: go home
        # disjoint counters: every pick lands in exactly ONE bucket, so
        # routed + rehomed + spilled = total affinity picks
        if chosen is home:
            chosen.affinity_routed += 1
            _flight.note("pool", "affinity", outcome="home", url=chosen.url)
        elif home in candidates:
            chosen.affinity_spilled += 1
            _flight.note("pool", "affinity", outcome="spill",
                         url=chosen.url, home=home.url)
        else:
            chosen.affinity_rehomed += 1
            _flight.note("pool", "affinity", outcome="rehome",
                         url=chosen.url, home=home.url)
        if len(chosen._affinity_keys) < _AFFINITY_KEY_CAP:
            chosen._affinity_keys.add(digest)
        return chosen

    def _pick(self, candidates: List[EndpointState],
              affinity_key: Optional[str] = None) -> EndpointState:
        routing = self.routing
        if routing == AFFINITY:
            if affinity_key is not None:
                # affinity accounting runs even for a lone candidate: the
                # key-spread/rehome counters must reflect every pick
                return self._pick_affinity(candidates, affinity_key)
            # keyless request on an affinity pool: client-local pressure
            routing = LEAST_OUTSTANDING
        if len(candidates) == 1:
            return candidates[0]
        if routing == ORCA_WEIGHTED:
            weights = self._orca_weights(candidates)
            if weights is not None:
                # smooth-WRR over the load-derived weights (same
                # algorithm as the static ``weighted`` policy)
                total = sum(weights.values())
                for ep in candidates:
                    ep._wrr_current += weights[id(ep)]
                best = max(candidates, key=lambda e: e._wrr_current)
                best._wrr_current -= total
                return best
            # loads stale/absent/unusable: degrade to least_outstanding
            # (client-local pressure) rather than stalling or guessing
            routing = LEAST_OUTSTANDING
        if routing == LEAST_OUTSTANDING:
            least = min(ep.outstanding for ep in candidates)
            candidates = [ep for ep in candidates if ep.outstanding == least]
            # ties rotate so idle pools still spread load
        elif routing == WEIGHTED:
            # smooth weighted round-robin (nginx algorithm): deterministic,
            # interleaves instead of bursting onto the heaviest endpoint
            total = sum(ep.weight for ep in candidates)
            for ep in candidates:
                ep._wrr_current += ep.weight
            best = max(candidates, key=lambda e: e._wrr_current)
            best._wrr_current -= total
            return best
        idx = self._rr % len(candidates)
        self._rr += 1
        return candidates[idx]

    def roles(self) -> Dict[Optional[str], int]:
        """Endpoint count per role label (``None`` = role-less)."""
        out: Dict[Optional[str], int] = {}
        with self._lock:
            for ep in self.endpoints:
                out[ep.role] = out.get(ep.role, 0) + 1
        return out

    def select(self, exclude: Sequence[EndpointState] = (),
               affinity_key: Optional[str] = None,
               role: Optional[str] = None) -> EndpointState:
        """Pick an endpoint under the routing policy, honoring health,
        ejection windows, breaker admission and (when armed) each
        endpoint's adaptive concurrency limit. ``affinity_key`` (with
        ``routing="affinity"``) rendezvous-hashes the key onto its home
        endpoint with deterministic bounded-load fallback — see
        :meth:`_pick_affinity`. ``exclude`` lists
        endpoints already tried by this call's failover loop.
        ``role`` restricts the whole selection (healthy AND panic tier)
        to endpoints carrying that role label — the disaggregated
        prefill/decode layer routes each leg this way; a role with no
        members at all raises :class:`NoEndpointAvailableError`
        immediately (the caller owns the typed fallback to role-less
        serving). When no
        eligible endpoint remains, panic-routes to a non-excluded endpoint
        whose breaker would still admit (degraded beats unavailable);
        raises :class:`NoEndpointAvailableError` when even that is empty.
        When the ONLY thing blocking every survivor is its adaptive
        limit, the pool is genuinely saturated — that raises a typed
        :class:`~client_tpu_torch.admission.AdmissionRejected` (reason
        ``endpoint_saturated``, counted per endpoint as ``shed_total``)
        instead of piling more work onto replicas already past their
        limits."""
        events: List[PoolEvent] = []
        excluded = set(map(id, exclude))
        saturated = False
        with self._lock:
            now = self._clock()
            self._readmit_expired(now, events)
            members = (self.endpoints if role is None
                       else [ep for ep in self.endpoints if ep.role == role])
            if role is not None and not members:
                raise NoEndpointAvailableError(
                    f"no endpoint with role {role!r} in the pool")
            # healthy tier first, WITHOUT the limiter: whether the pool
            # enters the panic tier must depend on health/ejection/breaker
            # alone — healthy replicas transiently at their adaptive limit
            # must shed, never spill traffic onto an ejected outlier
            healthy = [
                ep for ep in members
                if id(ep) not in excluded and not ep.ejected and ep.healthy
                and (ep.policy.breaker is None
                     or ep.policy.breaker.would_admit())
            ]
            candidates = [ep for ep in healthy if self._within_limit(ep)]
            if not candidates and healthy:
                # every HEALTHY replica is blocked only by its adaptive
                # limit: the pool is genuinely saturated — shed (typed)
                saturated = True
                for ep in healthy:
                    ep.shed_total += 1
            elif not candidates:
                # panic tier: no healthy replica at all — ignore health/
                # ejection, still skip endpoints whose breaker would
                # fast-fail without touching a socket
                relaxed = [
                    ep for ep in members
                    if id(ep) not in excluded
                    and (ep.policy.breaker is None
                         or ep.policy.breaker.would_admit())
                ]
                candidates = [ep for ep in relaxed if self._within_limit(ep)]
                if not candidates and relaxed:
                    saturated = True
                    for ep in relaxed:
                        ep.shed_total += 1
            picked = (self._pick(candidates, affinity_key)
                      if candidates else None)
        self._emit_all(events)
        if picked is None:
            if saturated:
                raise AdmissionRejected(
                    SHED_ENDPOINT_SATURATED, lane="endpoint",
                    msg="every candidate endpoint is at its adaptive "
                        "concurrency limit")
            raise NoEndpointAvailableError()
        return picked

    def endpoint_by_url(self, url: str) -> EndpointState:
        """The EndpointState serving ``url`` (the sharded scatter-gather
        layer pins each shard to one replica by url). Raises
        :class:`NoEndpointAvailableError` for an unknown url — a layout
        naming a replica outside the pool has no legal target."""
        for ep in self.endpoints:
            if ep.url == url:
                return ep
        raise NoEndpointAvailableError(
            f"endpoint {url!r} is not a member of this pool")

    # -- accounting ----------------------------------------------------------
    def begin(self, ep: EndpointState) -> None:
        with self._lock:
            ep.outstanding += 1

    def done(self, ep: EndpointState) -> None:
        with self._lock:
            ep.outstanding = max(0, ep.outstanding - 1)

    def record_success(self, ep: EndpointState,
                       latency_s: Optional[float] = None) -> None:
        events: List[PoolEvent] = []
        if ep.limiter is not None:
            # latency None (admin/metadata calls) is a neutral feed: the
            # per-endpoint limit tracks INFER latency only
            ep.limiter.on_result(latency_s, ok=True)
        with self._lock:
            ep.consecutive_failures = 0
            if ep.ejected:
                # proved itself (panic routing landed here and succeeded):
                # readmit early rather than waiting out the window — a
                # contract-VALIDATED success even clears quarantine (the
                # replica demonstrably answers correctly again)
                ep.ejected = False
                ep.quarantined = False
                events.append(EndpointReadmitted(ep.url))
            if latency_s is not None:
                self._latencies.append(latency_s)
        self._emit_all(events)

    def record_failure(self, ep: EndpointState, domain: str) -> None:
        """Feed one transport-level failure (connect/transient/timeout —
        FATAL application errors prove delivery and belong in
        :meth:`record_success`) into the outlier detector."""
        if domain not in (CONNECT, TRANSIENT, TIMEOUT):
            return
        if ep.limiter is not None:
            # a transport-level failure is the strongest back-off signal
            # the endpoint can send: decay its adaptive limit
            ep.limiter.on_result(None, ok=False)
        events: List[PoolEvent] = []
        with self._lock:
            ep.consecutive_failures += 1
            if ep.consecutive_failures < self.eject_after or ep.ejected:
                pass
            else:
                now = self._clock()
                already = sum(
                    1 for e in self.endpoints
                    if e.ejected and e.ejected_until > now)
                if already < self.max_ejected:
                    if (ep.last_ejection_end
                            and now - ep.last_ejection_end > self.ejection_decay_s):
                        ep.ejection_count = 0  # long-healthy: forgive history
                    window = min(
                        self.base_ejection_s
                        * (self.ejection_multiplier ** ep.ejection_count),
                        self.max_ejection_s,
                    )
                    ep.ejected = True
                    ep.ejected_until = now + window
                    ep.last_ejection_end = ep.ejected_until
                    ep.ejection_count += 1
                    events.append(EndpointEjected(
                        ep.url, window, ep.consecutive_failures,
                        ep.ejection_count))
        self._emit_all(events)

    def record_invalid(self, ep: EndpointState) -> None:
        """Feed one contract-violating (INVALID) response into the
        byzantine quarantine: the endpoint ANSWERED — so this is neither
        a breaker failure nor transport-outlier evidence — but
        ``quarantine_after`` invalid responses inside
        ``quarantine_window_s`` eject it with the usual exponential
        backoff (and the ``max_ejected`` self-blind guard). Deliberately
        NOT ``record_success``: a wrong answer must never readmit an
        ejected endpoint early."""
        events: List[PoolEvent] = []
        with self._lock:
            now = self._clock()
            ep.invalid_total += 1
            times = ep._invalid_times
            times.append(now)
            cutoff = now - self.quarantine_window_s
            while times and times[0] < cutoff:
                times.popleft()
            if len(times) >= self.quarantine_after and not ep.ejected:
                already = sum(
                    1 for e in self.endpoints
                    if e.ejected and e.ejected_until > now)
                if already < self.max_ejected:
                    if (ep.last_ejection_end
                            and now - ep.last_ejection_end > self.ejection_decay_s):
                        ep.ejection_count = 0  # long-healthy: forgive history
                    window = min(
                        self.base_ejection_s
                        * (self.ejection_multiplier ** ep.ejection_count),
                        self.max_ejection_s,
                    )
                    ep.ejected = True
                    ep.quarantined = True
                    ep.ejected_until = now + window
                    ep.last_ejection_end = ep.ejected_until
                    ep.ejection_count += 1
                    ep.quarantine_count += 1
                    invalid_count = len(times)
                    times.clear()
                    events.append(EndpointQuarantined(
                        ep.url, window, invalid_count, ep.quarantine_count))
                    _flight.note("integrity", "quarantine", url=ep.url,
                                 window_s=window,
                                 quarantine_count=ep.quarantine_count)
        self._emit_all(events)

    def quarantine_dominated(self) -> bool:
        """More than half the endpoints currently sit in quarantine —
        the federation layer treats such a cell as down (a majority of
        demonstrably-lying replicas is worse than a dead cell: spillover
        is strictly safer)."""
        with self._lock:
            now = self._clock()
            quarantined = sum(
                1 for ep in self.endpoints
                if ep.quarantined and ep.ejected and ep.ejected_until > now)
        return quarantined * 2 > len(self.endpoints)

    def set_health(self, ep: EndpointState, healthy: bool) -> None:
        events: List[PoolEvent] = []
        with self._lock:
            if ep.healthy != healthy:
                ep.healthy = healthy
                events.append(EndpointHealthChanged(ep.url, healthy))
        self._emit_all(events)

    # -- introspection -------------------------------------------------------
    def latency_p95(self, min_samples: int = 8) -> Optional[float]:
        with self._lock:
            if len(self._latencies) < min_samples:
                return None
            ordered = sorted(self._latencies)
        return sorted_percentile(ordered, 0.95)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-endpoint state + the per-endpoint ResilienceStats counters."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            now = self._clock()
            for i, ep in enumerate(self.endpoints):
                breaker = ep.policy.breaker
                ejected = ep.ejected and ep.ejected_until > now
                key = ep.url if ep.url not in out else f"{ep.url}#{i}"
                out[key] = {
                    "role": ep.role,
                    "healthy": ep.healthy,
                    "ejected": ejected,
                    "ejected_for_s": round(max(0.0, ep.ejected_until - now), 3)
                    if ejected else 0.0,
                    "consecutive_failures": ep.consecutive_failures,
                    "ejection_count": ep.ejection_count,
                    "outstanding": ep.outstanding,
                    "weight": ep.weight,
                    # admission view: the adaptive per-endpoint limit (None
                    # when no limiter is armed), the in-flight count it
                    # gates, and how many requests were shed because every
                    # candidate sat at its limit
                    "limit": (round(ep.limiter.limit, 2)
                              if ep.limiter is not None else None),
                    "inflight": ep.outstanding,
                    "shed_total": ep.shed_total,
                    "breaker_state": breaker.state if breaker is not None else None,
                    "resilience": ep.policy.stats.as_dict(),
                    # byzantine view: contract-violating responses seen,
                    # whether the current ejection is a quarantine, and
                    # how many quarantines this endpoint has earned
                    "invalid_total": ep.invalid_total,
                    "quarantined": ep.quarantined and ejected,
                    "quarantine_count": ep.quarantine_count,
                }
                if self.routing == AFFINITY:
                    # affinity view: how many picks landed here and why,
                    # plus the (capped) distinct-key ownership count the
                    # doctor's affinity_skew anomaly reads
                    out[key]["affinity"] = {
                        "routed": ep.affinity_routed,
                        "rehomed": ep.affinity_rehomed,
                        "spilled": ep.affinity_spilled,
                        "keys": len(ep._affinity_keys),
                    }
        return out

    def watch_gauges(self) -> Dict[str, Any]:
        """The watchtower's gauge-source contract: flat pressure gauges
        plus the endpoint NAMES behind them, so a watermark alert can say
        *which* replica is quarantined, not just how many."""
        snap = self.snapshot()
        breaker_open_urls: List[str] = []
        quarantined_urls: List[str] = []
        unrouteable = 0
        for key, stats in snap.items():
            url = key.partition("#")[0]
            if stats.get("breaker_state") == "open":
                breaker_open_urls.append(url)
            if stats.get("quarantined"):
                quarantined_urls.append(url)
            if not (stats["healthy"] and not stats["ejected"]
                    and stats.get("breaker_state") != "open"):
                unrouteable += 1
        return {
            "endpoints": len(snap),
            "breakers_open": len(breaker_open_urls),
            "breaker_open_urls": sorted(set(breaker_open_urls)),
            "quarantined": len(quarantined_urls),
            "quarantined_urls": sorted(set(quarantined_urls)),
            "unrouteable": unrouteable,
        }


def _default_client_factory(protocol: str, aio: bool):
    if protocol == "http":
        if aio:
            import client_tpu_torch.http.aio as mod
        else:
            import client_tpu_torch.http as mod
    elif protocol == "grpc":
        if aio:
            import client_tpu_torch.grpc.aio as mod
        else:
            import client_tpu_torch.grpc as mod
    else:
        raise ValueError(f"unknown protocol {protocol!r} (http|grpc)")
    return mod.InferenceServerClient


def _arena_event_observer(arena, chain=None):
    """Chainable pool observer invalidating the arena's cached shm
    registrations on BOTH edges of a replica's availability: ejection or
    an unhealthy probe (it may be about to restart), AND readmission or
    a healthy-again probe — a replica that healed may have restarted
    DURING the outage, so a re-prefill (or any re-homed request) landing
    on the newly-healed endpoint must re-verify its registration instead
    of trusting the pre-outage cache entry."""

    def observer(event: PoolEvent) -> None:
        if isinstance(
                event, (EndpointEjected, EndpointReadmitted,
                        EndpointHealthChanged)):
            try:
                arena.invalidate_endpoint(event.url)
            except Exception:
                pass  # an observer must never break the data path
        if chain is not None:
            chain(event)

    return observer


class _PoolClientBase:
    """Construction + bookkeeping shared by the sync and asyncio wrappers."""

    _AIO = False

    def __init__(
        self,
        urls: Sequence[str],
        protocol: str = "http",
        client_factory: Optional[Callable[[str], Any]] = None,
        routing: str = ROUND_ROBIN,
        weights: Optional[Sequence[float]] = None,
        health_interval_s: Optional[float] = 1.0,
        probe_timeout_s: float = 1.0,
        eject_after: int = 3,
        base_ejection_s: float = 1.0,
        ejection_multiplier: float = 2.0,
        max_ejection_s: float = 30.0,
        ejection_decay_s: float = 60.0,
        quarantine_after: int = 3,
        quarantine_window_s: float = 30.0,
        breaker_factory: Optional[Callable[[], Optional[CircuitBreaker]]] = None,
        endpoint_retry: Optional[RetryPolicy] = None,
        max_failover_attempts: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        per_attempt_timeout_s: Optional[float] = None,
        hedge: Optional[HedgePolicy] = None,
        hedge_executor_workers: Optional[int] = None,
        rng: Optional[random.Random] = None,
        on_event: Optional[Callable[[PoolEvent], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        telemetry=None,
        shm_arena=None,
        admission=None,
        endpoint_limits=None,
        affinity_bound: float = _AFFINITY_BOUND,
        seq_pin_idle_s: Optional[float] = 300.0,
    ):
        """``urls``: N ``host:port`` replica addresses. ``client_factory``
        overrides the per-endpoint client constructor (receives the url);
        default builds the ``protocol`` frontend (sync or aio to match this
        wrapper). ``weights`` pairs with ``routing="weighted"``.
        ``endpoint_retry`` arms in-endpoint retries BEFORE failover kicks
        in (default None: failover across replicas IS the retry).
        ``hedge``: a :class:`HedgePolicy` (idempotent infers only); on the
        sync client every hedged attempt (primary included) runs on a
        shared thread pool, so size ``hedge_executor_workers`` to at least
        ``caller_threads * (1 + max_hedges)`` when driving the pool from
        many threads (default: ``max(8, 4 * N)``).
        ``health_interval_s=None`` disables the active prober.
        ``telemetry``: an ``observe.Telemetry`` shared by the pool and every
        endpoint client — pool events feed its counters (ejections,
        readmissions, health flips, hedge win/loss), per-endpoint breakers
        and retries report through it, endpoint stats surface as gauges at
        scrape time, and each endpoint client traces request phases.

        ``admission``: an :class:`~client_tpu_torch.admission.AdmissionController`
        (or ``True`` for defaults) gating every pooled ``infer`` /
        ``generate_stream``: ONE token covers the whole failover/hedge
        engine run; saturated or deadline-infeasible requests raise the
        typed ``AdmissionRejected`` instead of queueing. ``endpoint_limits``
        (``True`` or a zero-arg ``AdaptiveLimiter`` factory) arms a
        per-endpoint adaptive concurrency limit that selection honors
        like a breaker. ``routing="orca_weighted"`` requires ``telemetry``
        (ideally with ``orca_format=`` set so the frontends opt in): the
        smooth-WRR weights come from the TTL-fresh ORCA load reports,
        falling back to least-outstanding whenever any replica's load is
        stale or absent.

        ``routing="affinity"`` rendezvous-hashes a caller-supplied
        ``infer(..., affinity_key=...)`` / ``generate_stream(...,
        affinity_key=...)`` session/prefix key onto a home endpoint with
        deterministic bounded-load fallback (``affinity_bound`` times the
        fair share) — replica-local state (KV caches, session prefixes)
        keeps landing on one replica, survives that replica's ejection by
        re-homing deterministically, and returns home on recovery.
        Keyless requests on an affinity pool route least-outstanding.

        ``seq_pin_idle_s``: sequence pins whose sequence went idle this
        long without a ``sequence_end`` are garbage-collected (the pin is
        dropped and the existing ``SequenceAbandoned`` event fires) — a
        caller that died mid-sequence must not leak its pin forever.
        ``None`` disables the GC."""
        # ``urls`` entries may be plain strings (role-less) or
        # EndpointSpec instances carrying a serving-role label for
        # role-aware selection (disaggregated prefill/decode)
        specs = [u if isinstance(u, EndpointSpec) else EndpointSpec(u)
                 for u in urls]
        urls = [s.url for s in specs]
        if not urls:
            raise ValueError("pool needs at least one url")
        if routing not in _ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {routing!r} (one of {_ROUTING_POLICIES})")
        if weights is not None and len(weights) != len(urls):
            raise ValueError("weights must pair 1:1 with urls")
        if seq_pin_idle_s is not None and seq_pin_idle_s <= 0:
            raise ValueError(
                "seq_pin_idle_s must be > 0 (None disables the pin GC)")
        if weights is None:
            weights = [1.0] * len(urls)
        if client_factory is None:
            client_factory = _default_client_factory(protocol, self._AIO)
        if breaker_factory is None:
            breaker_factory = CircuitBreaker
        if routing == ORCA_WEIGHTED and telemetry is None:
            raise ValueError(
                "routing='orca_weighted' needs telemetry=: the ORCA load "
                "reports it routes on are ingested by observe.Telemetry "
                "(set orca_format='json'|'text' on it so every frontend "
                "opts in to the endpoint-load-metrics header)")
        self._telemetry = telemetry
        if admission is True:
            admission = AdmissionController()
        elif isinstance(admission, dict):
            # kwargs form, so layers that build one pool per cell
            # (federation's pool_kwargs) can arm per-pool controllers —
            # sharing one instance would merge queues across cells
            admission = AdmissionController(**admission)
        self._admission = admission
        if endpoint_limits is True:
            endpoint_limits = AdaptiveLimiter
        limiter_factory = endpoint_limits if callable(endpoint_limits) else None
        if shm_arena is True:
            from .arena import default_arena

            shm_arena = default_arena()
        self._shm_arena = shm_arena
        if shm_arena is not None:
            # ejection means the replica was failing (it may have restarted
            # and lost its server-side shm registrations): drop the arena's
            # cached registrations for that url so the next use re-issues
            # the RPC instead of pointing the server at a region it no
            # longer holds
            on_event = _arena_event_observer(shm_arena, chain=on_event)
        if telemetry is not None:
            # count every typed pool event exactly once, then forward to
            # the caller's observer (if any)
            on_event = telemetry.pool_observer(chain=on_event)
        endpoints: List[EndpointState] = []
        try:
            for spec, weight in zip(specs, weights):
                url = spec.url
                policy = ResiliencePolicy(
                    retry=endpoint_retry, breaker=breaker_factory())
                if telemetry is not None:
                    telemetry.attach(policy)  # retries/fast-fails/breaker
                client = client_factory(url)
                # every call through this client now runs under the
                # endpoint's breaker and is counted in its stats
                client.configure_resilience(policy)
                if telemetry is not None and hasattr(
                        client, "configure_telemetry"):
                    client.configure_telemetry(telemetry)
                if shm_arena is not None and hasattr(
                        client, "configure_arena"):
                    # each endpoint client carries the SAME arena: one slab
                    # write serves every replica, and registrations cache
                    # per (endpoint url, region)
                    client.configure_arena(shm_arena)
                endpoints.append(EndpointState(
                    url, client, policy, weight,
                    limiter=limiter_factory() if limiter_factory else None,
                    role=spec.role))
        except Exception:
            self._abandon(endpoints)
            raise
        try:
            self.pool = EndpointPool(
                endpoints,
                routing=routing,
                eject_after=eject_after,
                base_ejection_s=base_ejection_s,
                ejection_multiplier=ejection_multiplier,
                max_ejection_s=max_ejection_s,
                ejection_decay_s=ejection_decay_s,
                quarantine_after=quarantine_after,
                quarantine_window_s=quarantine_window_s,
                clock=clock,
                on_event=on_event,
                # orca_weighted: weights come from the telemetry's
                # TTL-filtered load map — an expired report is simply
                # absent, so the policy can never divide by a stale load
                load_lookup=(telemetry.endpoint_loads
                             if routing == ORCA_WEIGHTED else None),
                affinity_bound=affinity_bound,
            )
        except Exception:
            self._abandon(endpoints)
            raise
        if telemetry is not None:
            # per-endpoint health/ejection/breaker/outstanding gauges,
            # refreshed from pool.snapshot() at scrape time
            telemetry.register_pool(self.pool)
            if self._admission is not None:
                # shed/admit counters + limit/inflight/queue-depth gauges
                telemetry.attach_admission(self._admission)
                if getattr(self._admission, "tenancy", None) is not None:
                    # per-tenant admitted/shed/quota/burn gauges
                    self._admission.tenancy.attach_telemetry(telemetry)
        self._hedge = hedge
        self._hedge_executor_workers = (
            hedge_executor_workers
            if hedge_executor_workers is not None
            else max(8, 4 * len(urls)))
        self._rng = rng or random.Random()
        self._health_interval_s = health_interval_s or None
        self._probe_timeout_s = probe_timeout_s
        self._max_failover_attempts = max_failover_attempts or len(urls)
        if default_deadline_s is not None or per_attempt_timeout_s is not None:
            self._budget_policy: Optional[ResiliencePolicy] = ResiliencePolicy(
                retry=RetryPolicy(
                    max_attempts=1,
                    total_deadline_s=default_deadline_s,
                    per_attempt_timeout_s=per_attempt_timeout_s,
                ))
        else:
            self._budget_policy = None
        # sequence affinity: server-side sequence state (KV caches, CORRID
        # slots) is replica-local, so every request of one sequence must
        # land on the SAME endpoint; pins live until sequence_end (or until
        # the sequence is abandoned). "established" = at least one request
        # of the sequence reached the pinned replica.
        self._seq_lock = threading.Lock()
        self._seq_pins: Dict[int, EndpointState] = {}
        self._seq_established: set = set()
        # pin GC: a caller that dies without sequence_end must not leak
        # its pin — pins idle past seq_pin_idle_s are swept (emitting
        # SequenceAbandoned) on the sequence path and the prober cadence
        self._clock = clock
        self._seq_pin_idle_s = seq_pin_idle_s
        self._seq_gc_interval_s = (
            max(seq_pin_idle_s / 4.0, 0.01)
            if seq_pin_idle_s is not None else None)
        self._seq_last_used: Dict[int, float] = {}
        self._seq_gc_at = clock()
        # backoff schedule for re-attempting a PINNED replica (a sequence
        # has exactly one legal endpoint, so zero-delay retries would burn
        # every attempt inside a sub-second connect blip)
        self._seq_backoff_policy = RetryPolicy(
            initial_backoff_s=0.05, max_backoff_s=0.5, rng=self._rng)
        self._closed = False

    @staticmethod
    def _abandon(endpoints: List[EndpointState]) -> None:
        for ep in endpoints:
            try:
                close = ep.client.close
            except AttributeError:
                continue
            try:
                result = close()
                if hasattr(result, "close"):  # unawaited coroutine
                    result.close()
            except Exception:
                pass

    # method-name prefixes whose calls mutate SERVER-side (or client-side)
    # state: these broadcast to every endpoint — registering a shm region
    # or loading a model on one arbitrary replica while infers route to
    # all of them would be a trap
    _BROADCAST_PREFIXES = (
        "register_", "unregister_", "load_model", "unload_model", "update_",
    )

    def configure_resilience(self, policy):
        raise InferenceServerException(
            "PoolClient owns each endpoint's resilience policy (breaker + "
            "stats); configure endpoint_retry= / breaker_factory= at pool "
            "construction instead")

    def configure_telemetry(self, telemetry):
        raise InferenceServerException(
            "PoolClient wires telemetry through every endpoint at "
            "construction; pass telemetry= to the pool constructor instead")

    def telemetry(self):
        return self._telemetry

    def configure_arena(self, arena):
        raise InferenceServerException(
            "PoolClient wires the shm arena through every endpoint (and its "
            "ejection-invalidation hook) at construction; pass shm_arena= "
            "to the pool constructor instead")

    def arena(self):
        return self._shm_arena

    def admission(self):
        return self._admission

    # -- admission helpers ---------------------------------------------------
    def _admission_deadline(self, timeout_s: Optional[float]) -> Optional[float]:
        """The request's absolute deadline under the pool's budget policy
        (the caller's explicit timeout wins) — what deadline-aware
        shedding judges feasibility against."""
        return AttemptBudget(self._budget_policy, timeout_s).deadline

    def _admission_note_shed(self, exc: AdmissionRejected) -> None:
        """Export a shed raised below the controller (the per-endpoint
        saturation path) exactly once; controller-level sheds were
        already counted by its observer."""
        if exc.counted:
            return
        exc.counted = True
        tel = self._telemetry
        if tel is not None:
            try:
                tel.on_admission_shed(exc.lane, exc.reason)
            except Exception:
                pass  # an observer must never break the data path

    def _admission_settle(self, token, t0: float,
                          exc: Optional[BaseException]) -> None:
        """Release the pool-level admission slot, feeding the limiter the
        whole pooled call's outcome: successes and FATAL application
        answers are completions (the fleet served them); transport-class
        failures are breaches (the overload back-off signal); sheds,
        breaker fast-fails and interrupts teach nothing."""
        # the call may have finished without any endpoint span claiming
        # the stashed wait (all-ejected select, endpoint saturation, an
        # endpoint client built without configure_telemetry): drop any
        # unclaimed stash or it would leak onto the next, unrelated
        # request's span — a no-op in the common claimed case
        consume_admission_phase()
        if exc is None:
            token.release(time.monotonic() - t0, ok=True)
            return
        if isinstance(exc, AdmissionRejected):
            self._admission_note_shed(exc)
            token.release()
            return
        if isinstance(exc, CircuitOpenError) or not isinstance(exc, Exception):
            token.release()
            return
        if classify_fault(exc) in (CONNECT, TRANSIENT, TIMEOUT):
            token.release(time.monotonic() - t0, ok=False)
        else:
            token.release(time.monotonic() - t0, ok=True)

    @property
    def _FRONTEND(self) -> str:
        """The wrapped protocol's telemetry label (wrapper layers — the
        batching dispatcher — derive their own label from it)."""
        return getattr(
            self.pool.endpoints[0].client, "_FRONTEND", "client")

    def coalescing(self, **kwargs):
        """Wrap this pool in the opt-in coalescing dispatcher
        (``client_tpu_torch.batch``): concurrent compatible ``infer()`` calls
        merge into ONE pooled request — one routing decision, one
        failover/hedge engine run — and the result rows scatter back per
        caller. The pool's telemetry is adopted automatically."""
        from .batch import AioBatchingClient, BatchingClient

        cls = AioBatchingClient if self._AIO else BatchingClient
        return cls(self, **kwargs)

    def caching(self, **kwargs):
        """Wrap this pool in the opt-in singleflight + response-cache
        layer (``client_tpu_torch.cache``): hot content keys are served
        client-side (zero wire requests), concurrent identical misses
        collapse onto one pooled request — one routing decision, one
        admission token — and ``load_model``/``unload_model`` broadcasts
        invalidate the model's cached entries. The pool's telemetry is
        adopted automatically. Compose OUTSIDE ``.coalescing()``."""
        from .cache import AioCachingClient, CachingClient

        cls = AioCachingClient if self._AIO else CachingClient
        return cls(self, **kwargs)

    @classmethod
    def _is_broadcast(cls, name: str) -> bool:
        return any(name.startswith(p) for p in cls._BROADCAST_PREFIXES)

    # -- shared helpers ------------------------------------------------------
    def health_summary(self) -> Dict[str, Any]:
        """The CELL-level aggregate over :meth:`endpoint_stats`: how many
        replicas this pool can actually route to right now, and the
        pressure counters a federation layer (or the doctor's ``--cells``
        snapshot) judges the whole cell by. ``available`` is the binary
        verdict: at least one replica is healthy, un-ejected and not
        breaker-open."""
        snap = self.pool.snapshot()
        healthy = ejected = breaker_open = quarantined = 0
        outstanding = shed_total = invalid_total = 0
        roles: Dict[str, Dict[str, Any]] = {}
        for stats in snap.values():
            if stats["ejected"]:
                ejected += 1
            if stats.get("quarantined"):
                quarantined += 1
            invalid_total += stats.get("invalid_total", 0)
            state = stats.get("breaker_state")
            # only a fully-open breaker is unroutable: half_open is MID
            # RECOVERY and actively admitting probes — counting it down
            # would raise a false whole-cell outage alarm exactly while
            # the cell is healing
            open_breaker = state == "open"
            if open_breaker:
                breaker_open += 1
            routable = (stats["healthy"] and not stats["ejected"]
                        and not open_breaker)
            if routable:
                healthy += 1
            outstanding += stats["outstanding"]
            shed_total += stats.get("shed_total", 0)
            role = stats.get("role")
            if role is not None:
                r = roles.setdefault(
                    role, {"endpoints": 0, "healthy": 0, "available": False})
                r["endpoints"] += 1
                if routable:
                    r["healthy"] += 1
                    r["available"] = True
        out = {
            "endpoints": len(snap),
            "healthy": healthy,
            "ejected": ejected,
            "breaker_open": breaker_open,
            "outstanding": outstanding,
            "shed_total": shed_total,
            "available": healthy > 0,
            # byzantine view: endpoints currently in quarantine + the
            # cell-wide count of contract-violating responses; a
            # quarantine-dominated cell is treated as down by federation
            "quarantined": quarantined,
            "invalid_total": invalid_total,
            "quarantine_dominated": quarantined * 2 > len(snap),
        }
        if roles:
            # per-role availability (disaggregated prefill/decode): a
            # role with zero routable members is the doctor's
            # ``role_degraded`` trigger when fallback traffic flows —
            # ``fallbacks`` counts the RoleFallback events that prove it
            with self.pool._lock:
                for role, r in roles.items():
                    r["fallbacks"] = self.pool.role_fallbacks.get(role, 0)
            out["roles"] = roles
        return out

    def endpoint_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-endpoint snapshot: health, ejection, breaker state,
        outstanding count, the endpoint's ResilienceStats counters — and,
        when the pool's telemetry has ingested ORCA reports, the latest
        un-expired ``EndpointLoad`` per endpoint (a ``load`` key;
        ``routing="orca_weighted"`` routes on exactly these reports) —
        plus the admission view: the adaptive per-endpoint ``limit``,
        the ``inflight`` count it gates, and ``shed_total``."""
        out = self.pool.snapshot()
        tel = self._telemetry
        if tel is not None:
            loads = tel.endpoint_loads()
            if loads:
                for key, stats in out.items():
                    load = loads.get(key.partition("#")[0])
                    if load is not None:
                        stats["load"] = load.as_dict()
        return out

    def watch_gauges(self) -> Dict[str, Any]:
        """The watchtower's gauge-source contract (delegates to the
        :class:`EndpointPool`, which is what telemetry registers)."""
        return self.pool.watch_gauges()

    def _record_attempt_failure(self, ep: EndpointState,
                                exc: BaseException) -> str:
        """Feed one failed attempt into the outlier detector; returns the
        fault domain ('' for a fast-fail that never touched the wire)."""
        if isinstance(exc, CircuitOpenError):
            return ""  # nothing was sent; the breaker already knows
        domain = classify_fault(exc)
        if domain == INVALID:
            # the endpoint answered WRONG: not record_success (a wrong
            # answer must never readmit an ejected endpoint early), not
            # transport-outlier evidence — quarantine accounting
            self.pool.record_invalid(ep)
        elif domain == FATAL:
            # an application error proves the transport delivered the
            # request — for ejection purposes that is a success
            self.pool.record_success(ep)
        else:
            self.pool.record_failure(ep, domain)
        return domain

    def _sequence_event(self, ep: EndpointState, request_id: str,
                        sequence_id: int, exc: BaseException) -> None:
        _flight.note("pool", "sequence_abandoned", url=ep.url,
                     sequence_id=sequence_id)
        self.pool.emit(SequenceAbandoned(ep.url, request_id, sequence_id, exc))

    # -- sequence affinity helpers -------------------------------------------
    def _seq_gc(self) -> None:
        """Sweep pins whose sequence went idle past ``seq_pin_idle_s``
        without a ``sequence_end`` (the caller died, or simply leaked):
        the pin and its established mark are dropped and the existing
        :class:`SequenceAbandoned` event fires per evicted pin. Without
        this, ``_seq_pins``/``_seq_established`` grow unbounded under
        caller churn. Events are emitted OUTSIDE ``_seq_lock``."""
        if self._seq_pin_idle_s is None:
            return
        now = self._clock()
        evicted: List[Tuple[int, EndpointState]] = []
        with self._seq_lock:
            if now - self._seq_gc_at < self._seq_gc_interval_s:
                return
            self._seq_gc_at = now
            cutoff = now - self._seq_pin_idle_s
            for sid in [sid for sid, ts in self._seq_last_used.items()
                        if ts < cutoff]:
                self._seq_last_used.pop(sid, None)
                self._seq_established.discard(sid)
                ep = self._seq_pins.pop(sid, None)
                if ep is not None:
                    evicted.append((sid, ep))
        for sid, ep in evicted:
            self.pool.emit(SequenceAbandoned(
                ep.url, "", sid, InferenceServerException(
                    f"sequence pin idle for > {self._seq_pin_idle_s:g}s "
                    "with no sequence_end: pin garbage-collected (the "
                    "server-side sequence state is abandoned)",
                    status="SEQUENCE_PIN_EXPIRED")))

    def _seq_endpoint(self, sequence_id: int,
                      exclude: Sequence[EndpointState] = (),
                      affinity_key: Optional[str] = None) -> EndpointState:
        now = self._clock()
        with self._seq_lock:
            # refresh BEFORE the sweep: an idle-then-resumed sequence must
            # never be garbage-collected by its own resuming call
            self._seq_last_used[sequence_id] = now
        self._seq_gc()
        with self._seq_lock:
            ep = self._seq_pins.get(sequence_id)
        if ep is not None:
            return ep
        # select OUTSIDE _seq_lock: selection emits pool events whose
        # callbacks may re-enter the sequence path (non-reentrant lock).
        # An affinity pool places the initial pin by the caller's key, so
        # a resumed session lands back on the replica holding its state.
        candidate = self.pool.select(exclude=exclude,
                                     affinity_key=affinity_key)
        with self._seq_lock:
            return self._seq_pins.setdefault(sequence_id, candidate)

    def _seq_backoff_s(self, attempt: int, budget: AttemptBudget) -> float:
        """Backoff before re-attempting the PINNED replica: the shared
        RetryPolicy full-jitter schedule (seeded-rng deterministic),
        clamped to the remaining budget."""
        delay = self._seq_backoff_policy.backoff_s(attempt)
        if budget.deadline is not None:
            delay = min(delay, max(0.0, budget.deadline - time.monotonic()))
        return delay

    def _seq_mark_established(self, sequence_id: int) -> None:
        with self._seq_lock:
            self._seq_established.add(sequence_id)

    def _seq_unpin(self, sequence_id: int) -> None:
        with self._seq_lock:
            self._seq_pins.pop(sequence_id, None)
            self._seq_established.discard(sequence_id)
            self._seq_last_used.pop(sequence_id, None)

    def _seq_repin_allowed(self, sequence_id: int) -> bool:
        """A connect failure provably never reached the server: if NO
        request of this sequence has landed yet, there is no replica-local
        state and the pin may move; once established, the pin is fixed."""
        with self._seq_lock:
            return sequence_id not in self._seq_established


class PoolClient(_PoolClientBase):
    """Synchronous pool wrapper over the HTTP or GRPC sync frontend.

    Exposes the full ``InferenceServerClient`` surface: ``infer`` runs the
    failover/hedging engine; every other client method is delegated to a
    selected endpoint under the same failover loop (admin/health calls are
    idempotent by nature)."""

    _AIO = False

    def __init__(self, urls, **kwargs):
        super().__init__(urls, **kwargs)
        self._executor_lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._stream_lock = threading.Lock()
        self._stream_ep: Optional[EndpointState] = None
        self._probe_stop = threading.Event()
        self._probe_threads: List[threading.Thread] = []
        if self._health_interval_s:
            # one persistent thread per endpoint: concurrent (a blackholed
            # endpoint never delays another's probe) with no per-tick
            # thread churn
            self._probe_threads = [
                threading.Thread(
                    target=self._probe_loop, args=(ep,),
                    name=f"client_tpu_pool_probe_{i}", daemon=True)
                for i, ep in enumerate(self.pool.endpoints)
            ]
            for t in self._probe_threads:
                t.start()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._probe_stop.set()
        for t in self._probe_threads:
            t.join(timeout=self._probe_timeout_s + 5)
        with self._executor_lock:
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None
        for ep in self.pool.endpoints:
            try:
                ep.client.close()
            except Exception:
                pass

    def __enter__(self) -> "PoolClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- active health probing ----------------------------------------------
    def _probe_one(self, ep: EndpointState) -> None:
        try:
            ok = ep.client.is_server_ready(
                probe=True, client_timeout=self._probe_timeout_s)
        except Exception:
            ok = False  # FATAL probe answer: endpoint is up but broken
        self.pool.set_health(ep, ok)

    def _probe_loop(self, ep: EndpointState) -> None:
        while not self._probe_stop.wait(self._health_interval_s):
            self._probe_one(ep)
            # the prober cadence doubles as the idle-pin sweep: a pool
            # with no further sequence traffic must still GC leaked pins
            self._seq_gc()

    def wait_healthy(self, min_healthy: Optional[int] = None,
                     timeout_s: float = 10.0) -> bool:
        """Block until at least ``min_healthy`` endpoints (default: all)
        are healthy, probing directly rather than waiting for the prober
        cadence. Returns False on timeout. Replay/capacity harnesses call
        this before measuring so probe warmup (first requests 503ing or
        routing to not-yet-probed replicas) never pollutes the first
        measurement window."""
        want = len(self.pool.endpoints) if min_healthy is None else min_healthy
        deadline = time.monotonic() + timeout_s
        first_pass = True
        while True:
            healthy = 0
            for ep in self.pool.endpoints:
                # endpoints START optimistically healthy — the first pass
                # must probe every one of them or a down replica would be
                # vouched for without a single probe ever going out
                if first_pass or not ep.healthy:
                    self._probe_one(ep)
                if ep.healthy:
                    healthy += 1
            first_pass = False
            if healthy >= want:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    # -- failover engine ------------------------------------------------------
    def _execute(self, op, idempotent: bool = True,
                 timeout_s: Optional[float] = None,
                 request_id: str = "", sequence_id: int = 0,
                 record_latency: bool = False,
                 affinity_key: Optional[str] = None):
        """Run ``op(client, remaining_timeout)`` against the pool: one
        shared deadline budget, at most ``max_failover_attempts`` distinct
        replicas, idempotency-gated re-sends. ``record_latency`` feeds the
        hedge-delay p95 window — infers only, so fast admin/metadata calls
        don't drag the window down and trigger spurious hedges.
        ``affinity_key`` steers every selection (the failover re-select
        excludes the failed home, so the key re-homes deterministically
        instead of retrying a dead replica)."""
        budget = AttemptBudget(self._budget_policy, timeout_s)
        tried: List[EndpointState] = []
        last: Optional[BaseException] = None
        while len(tried) < self._max_failover_attempts:
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            try:
                ep = self.pool.select(exclude=tried,
                                      affinity_key=affinity_key)
            except NoEndpointAvailableError:
                if last is not None:
                    raise last
                raise
            tried.append(ep)
            _flight.note("pool", "route", url=ep.url, attempt=len(tried))
            self.pool.begin(ep)
            t0 = time.monotonic()
            try:
                result = op(ep.client, remaining)
            except CircuitOpenError as e:
                last = e  # raced an opening breaker; nothing was sent
                _flight.note("pool", "failover", url=ep.url,
                             domain="circuit_open")
                continue
            except Exception as e:
                domain = self._record_attempt_failure(ep, e)
                if domain == INVALID:
                    # the endpoint answered WRONG (IntegrityError): never
                    # retried on the SAME endpoint — an idempotent request
                    # fails over to a different replica, a sequence
                    # request raises (its state lives on a liar)
                    last = e
                    if not idempotent:
                        self._sequence_event(ep, request_id, sequence_id, e)
                        raise
                    _flight.note("pool", "failover", url=ep.url,
                                 domain=domain)
                    continue
                if domain in (FATAL, SHED):
                    # FATAL: the server answered; SHED: a client-local
                    # admission rejection — failover cannot help either
                    raise
                last = e
                if domain in (TRANSIENT, TIMEOUT) and not idempotent:
                    self._sequence_event(ep, request_id, sequence_id, e)
                    raise
                _flight.note("pool", "failover", url=ep.url, domain=domain)
                continue
            finally:
                self.pool.done(ep)
            self.pool.record_success(
                ep, time.monotonic() - t0 if record_latency else None)
            return result
        assert last is not None
        raise last

    # -- admission gate -------------------------------------------------------
    def _admission_begin(self, kwargs, sequence_id: int,
                         tenant: Optional[str] = None):
        """Acquire the pool-level admission slot (or raise the typed
        ``AdmissionRejected``). Established sequences force-admit:
        shedding a step of server-held sequence state would poison it.
        A non-zero queue wait is stashed for the endpoint client's span
        (the ``admission_queue`` phase)."""
        ctrl = self._admission
        force = bool(sequence_id) and not self._seq_repin_allowed(sequence_id)
        deadline = self._admission_deadline(kwargs.get("client_timeout"))
        t0_ns = time.perf_counter_ns()
        token = ctrl.acquire(
            kwargs.get("priority") or 0, deadline, force=force,
            tenant=tenant)
        if token.waited_s and self._telemetry is not None:
            # only worth stashing when a span can claim it; an unclaimed
            # stash would sit in the contextvar waiting to pollute some
            # unrelated client's next span on this thread
            stash_admission_phase(t0_ns, time.perf_counter_ns())
        return token

    # -- inference -------------------------------------------------------------
    def infer(self, model_name: str, inputs, *args, **kwargs):
        """Pool-routed ``infer`` (positional arguments follow the
        frontends' shared prefix). Sequence requests (``sequence_id != 0``)
        PIN to one endpoint — replica-local sequence state must not
        scatter — are NEVER hedged, re-attempt only never-sent connect
        failures (moving the pin only while the sequence has no
        server-side state yet), and an in-flight death surfaces a
        :class:`SequenceAbandoned` event plus the original error.
        With admission armed, ONE token covers the whole failover/hedge
        engine run; a saturated pool raises ``AdmissionRejected``.
        ``affinity_key=`` (with ``routing="affinity"``) pins the request
        to the key's home endpoint — never forwarded to the replica."""
        kwargs = fold_infer_args(args, kwargs)
        scratch = _flight.layer_begin(self._telemetry, "pool", model_name)
        if scratch is None:
            return self._infer_gated(model_name, inputs, kwargs)
        try:
            result = self._infer_gated(model_name, inputs, kwargs)
        except BaseException as e:
            _flight.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight.layer_commit(self._telemetry, scratch)
        return result

    def _infer_gated(self, model_name: str, inputs, kwargs):
        """The admission-gated engine behind :meth:`infer` (split out so
        the flight-recorder wrapper above owns exactly one scratch per
        logical pool request, sheds included)."""
        affinity_key = kwargs.pop("affinity_key", None)
        # the tenant is a CLIENT-side QoS dimension (like affinity_key):
        # popped here so it never reaches the wire, judged by admission
        tenant = kwargs.pop("tenant", None)
        sequence_id = kwargs.get("sequence_id", 0)
        if self._admission is None:
            try:
                return self._infer_routed(model_name, inputs, kwargs,
                                          sequence_id, affinity_key)
            except AdmissionRejected as e:
                self._admission_note_shed(e)  # endpoint-limiter shed
                raise
        token = self._admission_begin(kwargs, sequence_id, tenant)
        t0 = time.monotonic()
        try:
            result = self._infer_routed(model_name, inputs, kwargs,
                                        sequence_id, affinity_key)
        except BaseException as e:
            self._admission_settle(token, t0, e)
            raise
        self._admission_settle(token, t0, None)
        return result

    def _infer_routed(self, model_name: str, inputs, kwargs,
                      sequence_id: int, affinity_key: Optional[str] = None):
        timeout_s = kwargs.get("client_timeout")
        request_id = kwargs.get("request_id", "")
        if sequence_id:
            return self._sequence_infer(model_name, inputs, kwargs,
                                        affinity_key)
        if self._hedge is not None:
            # hedged attempts run on executor threads that don't inherit
            # this context: a stashed admission phase would never be
            # claimed and could leak onto a later unrelated span
            consume_admission_phase()
            return self._hedged_infer(model_name, inputs, kwargs, timeout_s,
                                      affinity_key)

        def op(client, remaining):
            kw = dict(kwargs)
            if remaining is not None:
                kw["client_timeout"] = remaining
            return client.infer(model_name, inputs, **kw)

        return self._execute(
            op, idempotent=True, timeout_s=timeout_s,
            request_id=request_id, sequence_id=sequence_id,
            record_latency=True, affinity_key=affinity_key)

    def _sequence_infer(self, model_name: str, inputs, kwargs,
                        affinity_key: Optional[str] = None):
        """Affinity-pinned sequence request: every request of one sequence
        lands on the pinned replica. Connect failures re-attempt (the pin
        moves only while the sequence has no established server state);
        in-flight deaths abandon the sequence — never silently re-sent."""
        sequence_id = kwargs["sequence_id"]
        request_id = kwargs.get("request_id", "")
        budget = AttemptBudget(self._budget_policy, kwargs.get("client_timeout"))
        tried: List[EndpointState] = []
        last: Optional[BaseException] = None
        for _ in range(self._max_failover_attempts):
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            ep = self._seq_endpoint(sequence_id, exclude=tried,
                                    affinity_key=affinity_key)
            if ep not in tried:
                tried.append(ep)
            _flight.note("pool", "route", url=ep.url,
                         sequence_id=sequence_id)
            self.pool.begin(ep)
            t0 = time.monotonic()
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = ep.client.infer(model_name, inputs, **kw)
            except CircuitOpenError as e:
                last = e  # nothing was sent; the pinned replica is retried
                time.sleep(self._seq_backoff_s(len(tried), budget))
                continue
            except Exception as e:
                domain = self._record_attempt_failure(ep, e)
                if domain in (FATAL, SHED):
                    raise  # neither outcome is servable elsewhere
                last = e
                if domain == CONNECT:
                    if self._seq_repin_allowed(sequence_id):
                        # no request of this sequence ever landed: there is
                        # no replica-local state, the pin may move
                        self._seq_unpin(sequence_id)
                    else:
                        # one legal endpoint: back off instead of burning
                        # every attempt inside a sub-second connect blip
                        time.sleep(self._seq_backoff_s(len(tried), budget))
                    continue
                # transient/timeout: the request may have reached the
                # replica — the sequence state is unknowable, abandon it
                self._sequence_event(ep, request_id, sequence_id, e)
                self._seq_unpin(sequence_id)
                raise
            finally:
                self.pool.done(ep)
            self.pool.record_success(ep, time.monotonic() - t0)
            self._seq_mark_established(sequence_id)
            if kwargs.get("sequence_end"):
                self._seq_unpin(sequence_id)
            return result
        assert last is not None
        raise last

    def pinned_infer(self, url: str, model_name: str, inputs, *args,
                     **kwargs):
        """ONE infer against the named replica: no routing, no failover,
        no hedging, and no pool-level admission gate — the sharded
        scatter-gather layer (``client_tpu_torch.shard``) owns retry/admission
        semantics per LOGICAL request and pins each shard here. The
        outcome still feeds the endpoint's breaker, outlier detector,
        outstanding count and latency window exactly like a routed
        attempt, so shard traffic is visible to ``least_outstanding``
        routing and health accounting (shard-aware routing)."""
        kwargs = fold_infer_args(args, kwargs)
        ep = self.pool.endpoint_by_url(url)
        self.pool.begin(ep)
        t0 = time.monotonic()
        try:
            result = ep.client.infer(model_name, inputs, **kwargs)
        except CircuitOpenError:
            raise  # nothing was sent; the breaker already knows
        except Exception as e:
            self._record_attempt_failure(ep, e)
            raise
        finally:
            self.pool.done(ep)
        self.pool.record_success(ep, time.monotonic() - t0)
        return result

    def routed_infer(self, model_name: str, inputs, *args, **kwargs):
        """One pool-routed infer WITHOUT the pool-level admission gate:
        full routing/failover/hedging, but admission belongs to the
        caller — the pipeline layer (``client_tpu_torch.pipeline``) charges
        ONE token per logical DAG run and dispatches each unpinned
        stage here (the ``pinned_infer`` contract, minus the pin).
        ``affinity_key=`` still lands the request on its key's home
        replica under ``routing="affinity"``."""
        kwargs = fold_infer_args(args, kwargs)
        affinity_key = kwargs.pop("affinity_key", None)
        kwargs.pop("tenant", None)
        sequence_id = kwargs.get("sequence_id", 0)
        try:
            return self._infer_routed(model_name, inputs, kwargs,
                                      sequence_id, affinity_key)
        except AdmissionRejected as e:
            self._admission_note_shed(e)  # endpoint-limiter shed
            raise

    def pinned_generate_stream(self, url: str, *args, **kwargs):
        """One SSE generate stream against the named replica: no routing,
        no failover and no pool-level admission gate — the disaggregated
        prefill/decode layer (``client_tpu_torch.disagg``) pins its decode leg
        here and owns retry/admission per LOGICAL session. The endpoint's
        ``outstanding`` slot is held for the life of the iteration and
        the outcome feeds its breaker/outlier/latency accounting exactly
        like a routed stream."""
        ep = self.pool.endpoint_by_url(url)
        inner = ep.client.generate_stream(*args, **kwargs)  # lazy: no I/O yet

        def stream():
            self.pool.begin(ep)
            ok = True
            try:
                for item in inner:
                    yield item
            except Exception as e:
                ok = False
                self._record_attempt_failure(ep, e)
                raise
            finally:
                self.pool.done(ep)
                if ok:
                    self.pool.record_success(ep)

        return stream()

    def _get_executor(self) -> ThreadPoolExecutor:
        with self._executor_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._hedge_executor_workers,
                    thread_name_prefix="client_tpu_pool_hedge")
            return self._executor

    def _hedged_infer(self, model_name, inputs, kwargs,
                      timeout_s: Optional[float],
                      affinity_key: Optional[str] = None):
        """Primary + up to ``max_hedges`` staggered copies on distinct
        replicas; first success wins, losers are cancelled best-effort
        (a thread-borne attempt that already started runs to completion
        in the background and still records its outcome). With an
        affinity key the primary goes home; hedges exclude it, so a hedge
        is the key's deterministic rendezvous runner-up."""
        budget = AttemptBudget(self._budget_policy, timeout_s)
        hedge = self._hedge
        pool = self.pool
        executor = self._get_executor()
        tried: List[EndpointState] = []
        failures: List[BaseException] = []
        futures: List[Any] = []

        def attempt(ep, remaining):
            pool.begin(ep)
            t0 = time.monotonic()
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = ep.client.infer(model_name, inputs, **kw)
            except Exception as e:
                self._record_attempt_failure(ep, e)
                raise
            finally:
                pool.done(ep)
            pool.record_success(ep, time.monotonic() - t0)
            return result

        def spawn():
            remaining = budget.attempt_timeout_s()  # raises once spent
            ep = pool.select(exclude=tried, affinity_key=affinity_key)
            tried.append(ep)
            _flight.note("pool", "route", url=ep.url, attempt=len(tried))
            future = executor.submit(attempt, ep, remaining)
            futures.append(future)
            return future

        tel = self._telemetry
        hedge_futures: set = set()  # attempts fired BY the hedge timer
        max_attempts = max(self._max_failover_attempts, 1 + hedge.max_hedges)
        spawn()
        hedges_left = hedge.max_hedges
        hedge_at = time.monotonic() + hedge.delay(
            pool.latency_p95(hedge.min_latency_samples), self._rng)
        while True:
            timeout = None
            if hedges_left > 0:
                timeout = max(0.0, hedge_at - time.monotonic())
            done, _ = wait(futures, timeout=timeout,
                           return_when=FIRST_COMPLETED)
            for f in done:
                futures.remove(f)
                try:
                    result = f.result()
                except Exception as e:
                    if (not isinstance(e, CircuitOpenError)
                            and classify_fault(e) in (FATAL, SHED)):
                        for p in futures:
                            p.cancel()
                        raise  # the server answered; racing more copies won't help
                    failures.append(e)
                else:
                    for p in futures:
                        p.cancel()
                    if hedge_futures:
                        # a hedge raced this request: did it beat the primary?
                        _flight.note(
                            "hedge",
                            "win" if f in hedge_futures else "loss")
                        if tel is not None:
                            tel.on_hedge_result(f in hedge_futures)
                    return result
            firing = hedges_left > 0 and time.monotonic() >= hedge_at
            if futures and not firing:
                continue
            # need a fresh attempt: the hedge timer fired, or every
            # in-flight attempt has failed (failover inside the hedge path)
            if len(tried) >= max_attempts:
                if futures:
                    hedges_left = 0
                    continue
                raise failures[-1]
            try:
                spawned = spawn()
            except (NoEndpointAvailableError, InferenceServerException) as e:
                if futures:
                    hedges_left = 0  # nothing to hedge to; ride out in-flight
                    continue
                if failures:
                    raise failures[-1] from e
                raise
            if firing:
                hedge_futures.add(spawned)
                _flight.note("hedge", "launch", url=tried[-1].url)
                if tel is not None:
                    tel.on_hedge_fired()
                hedges_left -= 1
                hedge_at = time.monotonic() + hedge.delay(
                    pool.latency_p95(hedge.min_latency_samples), self._rng)

    # -- streaming (HTTP generate extension) ----------------------------------
    def generate_stream(self, *args, **kwargs):
        """Pool-routed SSE generate stream. The endpoint's ``outstanding``
        count stays held until the stream is exhausted (or abandoned), so
        ``least_outstanding`` routing sees long-lived generations — a bare
        delegation would release the slot as soon as the iterator is
        returned, before a single event streamed. With admission armed the
        stream holds one slot for its whole life (admitted on first
        iteration, like the outstanding count; released without feeding
        the limiter — an SSE session's duration is not a unary RTT).
        ``affinity_key=`` (with ``routing="affinity"``) lands the session
        on its key's home replica, so a re-opened generation finds its
        KV cache."""
        affinity_key = kwargs.pop("affinity_key", None)
        tenant = kwargs.pop("tenant", None)
        try:
            ep = self.pool.select(affinity_key=affinity_key)
        except AdmissionRejected as e:
            self._admission_note_shed(e)
            raise
        inner = ep.client.generate_stream(*args, **kwargs)  # lazy: no I/O yet

        def stream():
            # begin/done pair with actual iteration (the underlying client
            # generator only issues the request on first next); a returned-
            # but-never-iterated stream holds no slot (nor admission)
            token = None
            if self._admission is not None:
                try:
                    token = self._admission.acquire(tenant=tenant)
                except AdmissionRejected as e:
                    self._admission_note_shed(e)
                    raise
            self.pool.begin(ep)
            ok = True
            tel = self._telemetry
            t0 = time.monotonic() if tel is not None else 0.0
            first = tel is not None
            try:
                for item in inner:
                    if first:
                        # per-endpoint TTFT feed: one windowed observation
                        # per stream, so ejection decisions have a latency
                        # signal per replica (scrape shows
                        # client_tpu_pool_endpoint_ttft_ms)
                        first = False
                        tel.observe_endpoint_ttft(
                            ep.url, (time.monotonic() - t0) * 1e3)
                    yield item
            except Exception as e:
                ok = False
                self._record_attempt_failure(ep, e)
                raise
            finally:
                # abandonment closes the generator -> GeneratorExit runs
                # this too, releasing the outstanding slot
                self.pool.done(ep)
                if token is not None:
                    token.release()
                if ok:
                    self.pool.record_success(ep)

        return stream()

    # -- streaming (GRPC): pinned to ONE endpoint -----------------------------
    def start_stream(self, *args, **kwargs):
        """Open a bidi stream on ONE selected endpoint and pin it there:
        stream state lives on a single client, so ``async_stream_infer`` /
        ``stop_stream`` route to the same endpoint until the stream stops
        (combine with ``auto_reconnect=True`` for same-endpoint recovery).
        Streams are never failed over — sequence state is server-local."""
        with self._stream_lock:
            if self._stream_ep is not None:
                raise InferenceServerException(
                    "cannot start a stream: one is already active; stop it first")
            ep = self.pool.select()
            result = ep.client.start_stream(*args, **kwargs)
            self._stream_ep = ep
            return result

    def async_stream_infer(self, *args, **kwargs):
        with self._stream_lock:
            ep = self._stream_ep
        if ep is None:
            raise InferenceServerException(
                "stream not available: call start_stream first")
        return ep.client.async_stream_infer(*args, **kwargs)

    def stop_stream(self, *args, **kwargs):
        with self._stream_lock:
            ep = self._stream_ep
        if ep is None:
            return None
        try:
            return ep.client.stop_stream(*args, **kwargs)
        finally:
            # release the pin even when stop raised: the grpc client clears
            # its own stream state before closing, so a retried start_stream
            # must not stay wedged behind a stale pin
            with self._stream_lock:
                if self._stream_ep is ep:
                    self._stream_ep = None

    # -- generic surface delegation -------------------------------------------
    def _broadcast(self, name: str, args, kwargs):
        """Apply a state-mutating method to EVERY endpoint; every endpoint
        is attempted even if one fails, then the first failure raises."""
        first_exc: Optional[BaseException] = None
        result = None
        for ep in self.pool.endpoints:
            try:
                result = getattr(ep.client, name)(*args, **kwargs)
            except Exception as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return result

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        probe = getattr(self.pool.endpoints[0].client, name, None)
        if not callable(probe):
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r}")

        if self._is_broadcast(name):
            def call(*args, **kwargs):
                return self._broadcast(name, args, kwargs)
        else:
            def call(*args, **kwargs):
                def op(client, _remaining):
                    return getattr(client, name)(*args, **kwargs)
                return self._execute(op, idempotent=True)

        call.__name__ = name
        return call


class AioPoolClient(_PoolClientBase):
    """Asyncio twin of :class:`PoolClient` over the aio HTTP/GRPC frontends.

    The health prober runs as an asyncio task, started lazily on the first
    pooled call (or explicitly via :meth:`start`); hedged attempts are
    asyncio tasks, so the losing hedge is truly cancelled mid-flight."""

    _AIO = True

    def __init__(self, urls, **kwargs):
        super().__init__(urls, **kwargs)
        self._probe_task = None

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "AioPoolClient":
        self._ensure_prober()
        return self

    def _ensure_prober(self) -> None:
        if (self._probe_task is None and self._health_interval_s
                and not self._closed):
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # no loop yet; the next in-loop call starts it
            self._probe_task = loop.create_task(self._probe_loop())

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except BaseException:
                pass
            self._probe_task = None
        for ep in self.pool.endpoints:
            try:
                await ep.client.close()
            except Exception:
                pass

    async def __aenter__(self) -> "AioPoolClient":
        self._ensure_prober()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- active health probing ----------------------------------------------
    async def _probe_one(self, ep: EndpointState) -> None:
        try:
            ok = await ep.client.is_server_ready(
                probe=True, client_timeout=self._probe_timeout_s)
        except Exception:
            ok = False
        self.pool.set_health(ep, ok)

    async def _probe_once(self) -> None:
        # concurrent (see the sync twin): one hung endpoint must not
        # delay every other endpoint's probe by probe_timeout_s
        await asyncio.gather(
            *(self._probe_one(ep) for ep in self.pool.endpoints))

    async def _probe_loop(self) -> None:
        while True:
            await asyncio.sleep(self._health_interval_s)
            await self._probe_once()
            # idle-pin sweep on the prober cadence (see the sync twin);
            # _seq_gc never blocks beyond one short lock
            self._seq_gc()

    # -- failover engine ------------------------------------------------------
    async def _execute(self, op, idempotent: bool = True,
                       timeout_s: Optional[float] = None,
                       request_id: str = "", sequence_id: int = 0,
                       record_latency: bool = False,
                       affinity_key: Optional[str] = None):
        self._ensure_prober()
        budget = AttemptBudget(self._budget_policy, timeout_s)
        tried: List[EndpointState] = []
        last: Optional[BaseException] = None
        while len(tried) < self._max_failover_attempts:
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            try:
                ep = self.pool.select(exclude=tried,
                                      affinity_key=affinity_key)
            except NoEndpointAvailableError:
                if last is not None:
                    raise last
                raise
            tried.append(ep)
            _flight.note("pool", "route", url=ep.url, attempt=len(tried))
            self.pool.begin(ep)
            t0 = time.monotonic()
            try:
                result = await op(ep.client, remaining)
            except CircuitOpenError as e:
                last = e
                _flight.note("pool", "failover", url=ep.url,
                             domain="circuit_open")
                continue
            except Exception as e:
                domain = self._record_attempt_failure(ep, e)
                if domain == INVALID:
                    # answered WRONG: never same-endpoint retried; fail
                    # over iff idempotent (see the sync twin)
                    last = e
                    if not idempotent:
                        self._sequence_event(ep, request_id, sequence_id, e)
                        raise
                    _flight.note("pool", "failover", url=ep.url,
                                 domain=domain)
                    continue
                if domain in (FATAL, SHED):
                    raise  # neither outcome is servable elsewhere
                last = e
                if domain in (TRANSIENT, TIMEOUT) and not idempotent:
                    self._sequence_event(ep, request_id, sequence_id, e)
                    raise
                _flight.note("pool", "failover", url=ep.url, domain=domain)
                continue
            finally:
                self.pool.done(ep)
            self.pool.record_success(
                ep, time.monotonic() - t0 if record_latency else None)
            return result
        assert last is not None
        raise last

    # -- admission gate -------------------------------------------------------
    async def _admission_begin(self, kwargs, sequence_id: int,
                               tenant: Optional[str] = None):
        """Async twin of the sync gate (see ``PoolClient._admission_begin``)."""
        ctrl = self._admission
        force = bool(sequence_id) and not self._seq_repin_allowed(sequence_id)
        deadline = self._admission_deadline(kwargs.get("client_timeout"))
        t0_ns = time.perf_counter_ns()
        token = await ctrl.acquire_async(
            kwargs.get("priority") or 0, deadline, force=force,
            tenant=tenant)
        if token.waited_s and self._telemetry is not None:
            # see the sync twin: stash only when a span can claim it
            stash_admission_phase(t0_ns, time.perf_counter_ns())
        return token

    # -- inference -------------------------------------------------------------
    async def infer(self, model_name: str, inputs, *args, **kwargs):
        """Pool-routed async ``infer`` (same affinity/idempotency/hedging
        and admission contract as the sync twin)."""
        kwargs = fold_infer_args(args, kwargs)
        scratch = _flight.layer_begin(self._telemetry, "pool", model_name)
        if scratch is None:
            return await self._infer_gated(model_name, inputs, kwargs)
        try:
            result = await self._infer_gated(model_name, inputs, kwargs)
        except BaseException as e:
            _flight.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight.layer_commit(self._telemetry, scratch)
        return result

    async def _infer_gated(self, model_name: str, inputs, kwargs):
        """Async twin of the sync ``_infer_gated`` split."""
        affinity_key = kwargs.pop("affinity_key", None)
        tenant = kwargs.pop("tenant", None)
        sequence_id = kwargs.get("sequence_id", 0)
        if self._admission is None:
            try:
                return await self._infer_routed(model_name, inputs, kwargs,
                                                sequence_id, affinity_key)
            except AdmissionRejected as e:
                self._admission_note_shed(e)  # endpoint-limiter shed
                raise
        token = await self._admission_begin(kwargs, sequence_id, tenant)
        t0 = time.monotonic()
        try:
            result = await self._infer_routed(model_name, inputs, kwargs,
                                              sequence_id, affinity_key)
        except BaseException as e:
            self._admission_settle(token, t0, e)
            raise
        self._admission_settle(token, t0, None)
        return result

    async def _infer_routed(self, model_name: str, inputs, kwargs,
                            sequence_id: int,
                            affinity_key: Optional[str] = None):
        timeout_s = kwargs.get("client_timeout")
        request_id = kwargs.get("request_id", "")
        if sequence_id:
            return await self._sequence_infer(model_name, inputs, kwargs,
                                              affinity_key)
        if self._hedge is not None:
            # hedge tasks share this task's context, but racing attempts
            # would each claim-or-miss the one stashed phase
            # nondeterministically — drop it instead (see the sync twin)
            consume_admission_phase()
            return await self._hedged_infer(
                model_name, inputs, kwargs, timeout_s, affinity_key)

        async def op(client, remaining):
            kw = dict(kwargs)
            if remaining is not None:
                kw["client_timeout"] = remaining
            return await client.infer(model_name, inputs, **kw)

        return await self._execute(
            op, idempotent=True, timeout_s=timeout_s,
            request_id=request_id, sequence_id=sequence_id,
            record_latency=True, affinity_key=affinity_key)

    async def _sequence_infer(self, model_name: str, inputs, kwargs,
                              affinity_key: Optional[str] = None):
        """Async twin of the sync affinity-pinned sequence path."""
        self._ensure_prober()
        sequence_id = kwargs["sequence_id"]
        request_id = kwargs.get("request_id", "")
        budget = AttemptBudget(self._budget_policy, kwargs.get("client_timeout"))
        tried: List[EndpointState] = []
        last: Optional[BaseException] = None
        for _ in range(self._max_failover_attempts):
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            ep = self._seq_endpoint(sequence_id, exclude=tried,
                                    affinity_key=affinity_key)
            if ep not in tried:
                tried.append(ep)
            _flight.note("pool", "route", url=ep.url,
                         sequence_id=sequence_id)
            self.pool.begin(ep)
            t0 = time.monotonic()
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = await ep.client.infer(model_name, inputs, **kw)
            except CircuitOpenError as e:
                last = e
                await asyncio.sleep(self._seq_backoff_s(len(tried), budget))
                continue
            except Exception as e:
                domain = self._record_attempt_failure(ep, e)
                if domain in (FATAL, SHED):
                    raise  # neither outcome is servable elsewhere
                last = e
                if domain == CONNECT:
                    if self._seq_repin_allowed(sequence_id):
                        self._seq_unpin(sequence_id)
                    else:
                        await asyncio.sleep(
                            self._seq_backoff_s(len(tried), budget))
                    continue
                self._sequence_event(ep, request_id, sequence_id, e)
                self._seq_unpin(sequence_id)
                raise
            finally:
                self.pool.done(ep)
            self.pool.record_success(ep, time.monotonic() - t0)
            self._seq_mark_established(sequence_id)
            if kwargs.get("sequence_end"):
                self._seq_unpin(sequence_id)
            return result
        assert last is not None
        raise last

    async def pinned_infer(self, url: str, model_name: str, inputs, *args,
                           **kwargs):
        """Async twin of the sync :meth:`PoolClient.pinned_infer` (the
        sharded scatter-gather layer's per-shard dispatch)."""
        self._ensure_prober()
        kwargs = fold_infer_args(args, kwargs)
        ep = self.pool.endpoint_by_url(url)
        self.pool.begin(ep)
        t0 = time.monotonic()
        try:
            result = await ep.client.infer(model_name, inputs, **kwargs)
        except asyncio.CancelledError:
            raise  # a cancelled sibling shard: no outcome to record
        except CircuitOpenError:
            raise
        except Exception as e:
            self._record_attempt_failure(ep, e)
            raise
        finally:
            self.pool.done(ep)
        self.pool.record_success(ep, time.monotonic() - t0)
        return result

    async def routed_infer(self, model_name: str, inputs, *args,
                           **kwargs):
        """Async twin of the sync :meth:`PoolClient.routed_infer` (the
        pipeline layer's per-stage dispatch: routed, admission-free)."""
        self._ensure_prober()
        kwargs = fold_infer_args(args, kwargs)
        affinity_key = kwargs.pop("affinity_key", None)
        kwargs.pop("tenant", None)
        sequence_id = kwargs.get("sequence_id", 0)
        try:
            return await self._infer_routed(model_name, inputs, kwargs,
                                            sequence_id, affinity_key)
        except AdmissionRejected as e:
            self._admission_note_shed(e)
            raise

    # -- streaming (HTTP generate extension) ----------------------------------
    def generate_stream(self, *args, **kwargs):
        """Pool-routed async SSE generate stream; the endpoint's
        ``outstanding`` slot — and, with admission armed, one admission
        slot — is held for the life of the iteration (see the sync
        twin). ``affinity_key=`` lands the session on its key's home
        replica under ``routing="affinity"``."""
        self._ensure_prober()  # streaming-only pools still need health
        affinity_key = kwargs.pop("affinity_key", None)
        tenant = kwargs.pop("tenant", None)
        try:
            ep = self.pool.select(affinity_key=affinity_key)
        except AdmissionRejected as e:
            self._admission_note_shed(e)
            raise
        inner = ep.client.generate_stream(*args, **kwargs)  # lazy: no I/O yet

        async def stream():
            self._ensure_prober()  # called outside a loop? start it here
            token = None
            if self._admission is not None:
                try:
                    token = await self._admission.acquire_async(tenant=tenant)
                except AdmissionRejected as e:
                    self._admission_note_shed(e)
                    raise
            self.pool.begin(ep)
            ok = True
            tel = self._telemetry
            t0 = time.monotonic() if tel is not None else 0.0
            first = tel is not None
            try:
                async for item in inner:
                    if first:
                        # per-endpoint TTFT feed (see the sync twin)
                        first = False
                        tel.observe_endpoint_ttft(
                            ep.url, (time.monotonic() - t0) * 1e3)
                    yield item
            except Exception as e:
                ok = False
                self._record_attempt_failure(ep, e)
                raise
            finally:
                self.pool.done(ep)
                if token is not None:
                    token.release()
                if ok:
                    self.pool.record_success(ep)

        return stream()

    def pinned_generate_stream(self, url: str, *args, **kwargs):
        """Async twin of the sync :meth:`PoolClient.pinned_generate_stream`
        (the disaggregated decode leg's replica-pinned SSE stream)."""
        self._ensure_prober()
        ep = self.pool.endpoint_by_url(url)
        inner = ep.client.generate_stream(*args, **kwargs)  # lazy: no I/O yet

        async def stream():
            self.pool.begin(ep)
            ok = True
            try:
                async for item in inner:
                    yield item
            except Exception as e:
                ok = False
                self._record_attempt_failure(ep, e)
                raise
            finally:
                self.pool.done(ep)
                if ok:
                    self.pool.record_success(ep)

        return stream()

    async def _hedged_infer(self, model_name, inputs, kwargs,
                            timeout_s: Optional[float],
                            affinity_key: Optional[str] = None):
        self._ensure_prober()
        budget = AttemptBudget(self._budget_policy, timeout_s)
        hedge = self._hedge
        pool = self.pool
        tried: List[EndpointState] = []
        failures: List[BaseException] = []
        tasks: "set" = set()

        async def attempt(ep, remaining):
            pool.begin(ep)
            t0 = time.monotonic()
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = await ep.client.infer(model_name, inputs, **kw)
            except asyncio.CancelledError:
                raise  # the losing hedge: no outcome to record
            except Exception as e:
                self._record_attempt_failure(ep, e)
                raise
            finally:
                pool.done(ep)
            pool.record_success(ep, time.monotonic() - t0)
            return result

        def spawn():
            remaining = budget.attempt_timeout_s()
            ep = pool.select(exclude=tried, affinity_key=affinity_key)
            tried.append(ep)
            _flight.note("pool", "route", url=ep.url, attempt=len(tried))
            task = asyncio.ensure_future(attempt(ep, remaining))
            tasks.add(task)
            return task

        async def cancel_pending():
            for t in tasks:
                t.cancel()
            for t in tasks:
                try:
                    await t
                except BaseException:
                    pass

        tel = self._telemetry
        hedge_tasks: set = set()  # attempts fired BY the hedge timer
        max_attempts = max(self._max_failover_attempts, 1 + hedge.max_hedges)
        spawn()
        hedges_left = hedge.max_hedges
        hedge_at = time.monotonic() + hedge.delay(
            pool.latency_p95(hedge.min_latency_samples), self._rng)
        try:
            while True:
                timeout = None
                if hedges_left > 0:
                    timeout = max(0.0, hedge_at - time.monotonic())
                done, _ = await asyncio.wait(
                    tasks, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    tasks.discard(t)
                    try:
                        result = t.result()
                    except Exception as e:
                        if (not isinstance(e, CircuitOpenError)
                                and classify_fault(e) in (FATAL, SHED)):
                            await cancel_pending()
                            raise
                        failures.append(e)
                    else:
                        await cancel_pending()
                        if hedge_tasks:
                            _flight.note(
                                "hedge",
                                "win" if t in hedge_tasks else "loss")
                            if tel is not None:
                                tel.on_hedge_result(t in hedge_tasks)
                        return result
                firing = hedges_left > 0 and time.monotonic() >= hedge_at
                if tasks and not firing:
                    continue
                if len(tried) >= max_attempts:
                    if tasks:
                        hedges_left = 0
                        continue
                    raise failures[-1]
                try:
                    spawned = spawn()
                except (NoEndpointAvailableError, InferenceServerException) as e:
                    if tasks:
                        hedges_left = 0
                        continue
                    if failures:
                        raise failures[-1] from e
                    raise
                if firing:
                    hedge_tasks.add(spawned)
                    _flight.note("hedge", "launch", url=tried[-1].url)
                    if tel is not None:
                        tel.on_hedge_fired()
                    hedges_left -= 1
                    hedge_at = time.monotonic() + hedge.delay(
                        pool.latency_p95(hedge.min_latency_samples), self._rng)
        except asyncio.CancelledError:
            # external cancellation (wait_for timeout, caller teardown):
            # the in-flight attempts must die with the caller, not keep
            # loading replicas in the background
            await cancel_pending()
            raise

    # -- generic surface delegation -------------------------------------------
    async def _broadcast(self, name: str, args, kwargs):
        """Async twin of the sync broadcast: every endpoint is attempted
        even if one fails, then the first failure raises. Handles the sync
        methods the aio clients inherit (register_plugin etc.)."""
        first_exc: Optional[BaseException] = None
        result = None
        for ep in self.pool.endpoints:
            try:
                result = getattr(ep.client, name)(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
            except Exception as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return result

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        probe = getattr(self.pool.endpoints[0].client, name, None)
        if not callable(probe):
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r}")

        if self._is_broadcast(name):
            async def call(*args, **kwargs):
                return await self._broadcast(name, args, kwargs)
        else:
            async def call(*args, **kwargs):
                async def op(client, _remaining):
                    # the aio clients inherit a few sync methods from the
                    # shared base (plugins); awaiting their None would throw
                    result = getattr(client, name)(*args, **kwargs)
                    if inspect.isawaitable(result):
                        result = await result
                    return result
                return await self._execute(op, idempotent=True)

        call.__name__ = name
        return call
