"""First-class multi-tenancy: quotas, weights and per-tenant SLO windows.

"Millions of users" are not one user a million times. Until now the
client's QoS machinery — admission lanes, the response cache, the
singleflight table, batch coalescing — was tenant-blind: one hostile
caller could fill a lane's queue, evict every other caller's hot cache
set, or collapse onto answers it never computed. This module is the
shared vocabulary that makes tenancy a first-class, *enforced* dimension:

- :class:`TenantSpec` — one tenant's declared contract: scheduling
  ``weight`` (its share of contended admission capacity), a token-bucket
  ``rate``/``burst`` quota (requests/s; ``None`` = unmetered), an
  optional per-tenant latency SLO (``slo_ms`` at ``slo_objective``), and
  an optional response-cache byte budget (``cache_bytes``).

- :class:`TenancyPolicy` — the live registry the enforcement points
  share. ``client_tpu_torch.admission.AdmissionController(tenancy=...)`` asks
  it for quota verdicts (:meth:`try_take` — an over-quota request sheds
  with the typed reason ``over_quota`` and an HONEST ``retry_after_s``,
  the time until the bucket refills one token) and for WFQ weights (the
  per-tenant virtual queues in the controller drain proportionally to
  weight). Completions feed per-tenant SLO burn windows
  (:meth:`on_result`); :meth:`snapshot` is the doctor's ``tenancy``
  section and :meth:`noisy_neighbors` its ``noisy_neighbor`` anomaly —
  naming the tenant whose offered load dwarfs its quota.

- **Quota sheds are policy, not capacity.** ``over_quota`` is
  deliberately NOT in ``admission.SPILL_REASONS``: a federation layer
  must never answer a quota denial by silently moving the tenant's
  excess to another cell (that would launder the quota away), and
  ``resilience.classify_fault`` maps the shed to the ``SHED`` domain —
  never retried, never a breaker/ejection signal.

- **Isolation, not just fairness.** The tenant is folded into the shared
  ``batch.plan_request`` content key, so the response cache, the
  singleflight table AND batch coalescing all partition by tenant in one
  place — a tenant can never be served (or collapse onto) another
  tenant's response object, and ``cache.ResponseCache`` additionally
  partitions its byte budget per tenant so one tenant's zipf churn
  cannot evict another's hot set. Tenantless callers (``tenant=None``)
  keep byte-identical keys and behavior.

Wiring: every frontend and wrapper accepts ``infer(..., tenant=...)``;
the pool pops it before the wire (like ``affinity_key``) and passes it to
admission. Telemetry export rides :meth:`TenancyPolicy.attach_telemetry`
(per-tenant admitted/shed/burn gauges at scrape time). The port of
``client_tpu.tenancy``: the same specs, buckets and verdicts.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "DEFAULT_TENANT_LABEL",
    "TenancyPolicy",
    "TenantSpec",
    "parse_tenancy_spec",
    "policies",
]

# the {tenant=...} label exported for tenantless traffic (tenant=None);
# a real tenant may not claim it (parse rejects the name)
DEFAULT_TENANT_LABEL = "_default"

# noisy-neighbor verdict thresholds: a tenant is flagged when its
# over-quota sheds are both numerous (>= _NOISY_MIN_SHEDS: one burst of a
# handful of sheds is not an attack) and dominate its admitted traffic
# (>= _NOISY_SHED_FACTOR x admitted: the tenant is offering a multiple of
# its quota, not riding the boundary)
_NOISY_MIN_SHEDS = 16
_NOISY_SHED_FACTOR = 2.0


class TenantSpec:
    """One tenant's declared contract (immutable after construction).

    ``weight`` is the WFQ share under contention (relative to the other
    tenants' weights; 2.0 drains twice as often as 1.0). ``rate`` /
    ``burst`` arm the token-bucket quota: a sustained ``rate`` requests/s
    with bursts up to ``burst`` tokens (default ``max(rate, 1)``);
    ``rate=None`` is unmetered. ``slo_ms`` (with ``slo_objective``)
    declares the tenant's latency SLO — completions feed a windowed
    burn gauge. ``cache_bytes`` caps the tenant's response-cache
    partition (``None``: an equal split of the cache's watermark)."""

    __slots__ = ("name", "weight", "rate", "burst", "slo_ms",
                 "slo_objective", "cache_bytes")

    def __init__(self, name: Optional[str], weight: float = 1.0,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 slo_ms: Optional[float] = None,
                 slo_objective: float = 0.99,
                 cache_bytes: Optional[int] = None):
        if name == DEFAULT_TENANT_LABEL:
            raise ValueError(
                f"tenant name {DEFAULT_TENANT_LABEL!r} is reserved for "
                "tenantless traffic")
        if weight <= 0.0:
            raise ValueError("weight must be > 0")
        if rate is not None and rate <= 0.0:
            raise ValueError("rate must be > 0 (or None for unmetered)")
        if burst is not None:
            if rate is None:
                raise ValueError("burst without rate is meaningless")
            if burst < 1.0:
                raise ValueError("burst must be >= 1")
        if not 0.0 < slo_objective < 1.0:
            raise ValueError("slo_objective must be in (0, 1)")
        if slo_ms is not None and slo_ms <= 0.0:
            raise ValueError("slo_ms must be > 0")
        if cache_bytes is not None and cache_bytes < 1:
            raise ValueError("cache_bytes must be >= 1")
        self.name = name
        self.weight = float(weight)
        self.rate = float(rate) if rate is not None else None
        self.burst = (float(burst) if burst is not None
                      else (max(self.rate, 1.0)
                            if self.rate is not None else None))
        self.slo_ms = float(slo_ms) if slo_ms is not None else None
        self.slo_objective = float(slo_objective)
        self.cache_bytes = int(cache_bytes) if cache_bytes else None

    @property
    def label(self) -> str:
        return self.name if self.name is not None else DEFAULT_TENANT_LABEL

    def replace(self, name: Optional[str]) -> "TenantSpec":
        """This spec re-issued under another tenant's name (the template
        path for tenants first seen at runtime)."""
        return TenantSpec(
            name, weight=self.weight, rate=self.rate, burst=self.burst,
            slo_ms=self.slo_ms, slo_objective=self.slo_objective,
            cache_bytes=self.cache_bytes)

    def to_obj(self) -> Dict[str, Any]:
        return {
            "weight": self.weight, "rate": self.rate, "burst": self.burst,
            "slo_ms": self.slo_ms, "slo_objective": self.slo_objective,
            "cache_bytes": self.cache_bytes,
        }


class _TokenBucket:
    """The quota meter: ``burst`` capacity refilled at ``rate``/s.
    Mutations happen under the owning policy's lock."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst  # a fresh tenant may burst immediately
        self.last = now

    def _refill(self, now: float) -> None:
        elapsed = now - self.last
        if elapsed > 0.0:
            self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.last = now

    def take(self, now: float) -> Tuple[bool, Optional[float]]:
        """``(admitted, retry_after_s)``. The hint is the honest
        backpressure signal: exactly the time until the bucket holds one
        whole token again."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, None
        return False, (1.0 - self.tokens) / self.rate

    def charge(self, now: float) -> None:
        """Unconditional debit (force-admitted sequence steps): the debt
        is bounded at one burst below empty so a long sequence cannot
        mortgage the tenant's quota forever."""
        self._refill(now)
        self.tokens = max(-self.burst, self.tokens - 1.0)


class _BurnWindow:
    """A subwindowed good/bad event window (the per-tenant twin of the
    observe-layer SLO burn machinery, small enough to live on the
    admission path). Mutations under the owning policy's lock."""

    __slots__ = ("window_s", "subwindows", "_sub_s", "_good", "_bad",
                 "_period")

    def __init__(self, window_s: float = 30.0, subwindows: int = 6):
        self.window_s = float(window_s)
        self.subwindows = int(subwindows)
        self._sub_s = self.window_s / self.subwindows
        self._good = [0] * self.subwindows
        self._bad = [0] * self.subwindows
        self._period = 0

    def _rotate(self, now: float) -> int:
        period = int(now / self._sub_s)
        if period != self._period:
            empty = min(period - self._period, self.subwindows)
            for i in range(1, empty + 1):
                slot = (self._period + i) % self.subwindows
                self._good[slot] = 0
                self._bad[slot] = 0
            self._period = period
        return period % self.subwindows

    def observe(self, ok: bool, now: float) -> None:
        slot = self._rotate(now)
        if ok:
            self._good[slot] += 1
        else:
            self._bad[slot] += 1

    def counts(self, now: float) -> Tuple[int, int]:
        self._rotate(now)
        return sum(self._good), sum(self._bad)


class _TenantState:
    """One tenant's live accounting: quota bucket, cumulative counters
    and the windowed SLO burn. Mutations under the policy lock."""

    __slots__ = ("spec", "bucket", "admitted_total", "shed_by_reason",
                 "completions", "breaches_total", "window")

    def __init__(self, spec: TenantSpec, now: float,
                 window_s: float):
        self.spec = spec
        self.bucket = (_TokenBucket(spec.rate, spec.burst, now)
                       if spec.rate is not None else None)
        self.admitted_total = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.completions = 0
        self.breaches_total = 0
        self.window = _BurnWindow(window_s)


class TenancyPolicy:
    """The per-tenant quota/weight/SLO registry shared by the
    enforcement points (admission, cache, doctor, telemetry).

    ``tenants``: the declared :class:`TenantSpec` contracts. ``default``
    is the TEMPLATE for tenants first seen at runtime (auto-registered
    under their own name); its default — unmetered, weight 1 — means an
    undeclared tenant is admitted like today's tenantless traffic, just
    separately queued and accounted. Tenantless requests
    (``tenant=None``) ride their own ``_default`` row. Thread-safe: one
    short lock around every operation."""

    def __init__(self, tenants: Iterable[TenantSpec] = (),
                 default: Optional[TenantSpec] = None,
                 window_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.window_s = float(window_s)
        self._default = default or TenantSpec(None)
        self._states: "Dict[Optional[str], _TenantState]" = {}
        now = clock()
        for spec in tenants:
            if spec.name in self._states:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self._states[spec.name] = _TenantState(
                spec, now, self.window_s)
        _POLICIES.add(self)

    # -- registry -------------------------------------------------------------
    def _state(self, tenant: Optional[str]) -> _TenantState:
        """The tenant's live state (auto-registered from the default
        template on first sight). Caller holds the lock."""
        state = self._states.get(tenant)
        if state is None:
            spec = (self._default if tenant is None
                    else self._default.replace(tenant))
            state = self._states[tenant] = _TenantState(
                spec, self._clock(), self.window_s)
        return state

    def spec(self, tenant: Optional[str]) -> TenantSpec:
        with self._lock:
            return self._state(tenant).spec

    def weight(self, tenant: Optional[str]) -> float:
        with self._lock:
            return self._state(tenant).spec.weight

    def tenants(self) -> List[Optional[str]]:
        with self._lock:
            return list(self._states)

    # -- quota ---------------------------------------------------------------
    def try_take(self, tenant: Optional[str]
                 ) -> Tuple[bool, Optional[float]]:
        """One admission attempt against the tenant's quota:
        ``(admitted, retry_after_s)``. Unmetered tenants always pass."""
        with self._lock:
            state = self._state(tenant)
            if state.bucket is None:
                return True, None
            return state.bucket.take(self._clock())

    def charge(self, tenant: Optional[str]) -> None:
        """Unconditional quota debit (force-admitted sequence steps)."""
        with self._lock:
            state = self._state(tenant)
            if state.bucket is not None:
                state.bucket.charge(self._clock())

    # -- accounting (fed by the admission controller) -------------------------
    def on_admit(self, tenant: Optional[str]) -> None:
        with self._lock:
            self._state(tenant).admitted_total += 1

    def on_shed(self, tenant: Optional[str], reason: str) -> None:
        with self._lock:
            state = self._state(tenant)
            state.shed_by_reason[reason] = (
                state.shed_by_reason.get(reason, 0) + 1)
            # a shed counts against the tenant's SLO window: the request
            # was NOT served inside its objective (same rule as the
            # capacity harness — shed capacity is not delivered capacity)
            state.window.observe(False, self._clock())

    def on_result(self, tenant: Optional[str],
                  latency_s: Optional[float], ok: bool) -> None:
        """One completion under the tenant's admission slot. ``ok=False``
        or a latency above the tenant's ``slo_ms`` is a bad event in the
        burn window; tenants with no declared SLO count errors only."""
        with self._lock:
            state = self._state(tenant)
            state.completions += 1
            good = ok
            if (good and state.spec.slo_ms is not None
                    and latency_s is not None
                    and latency_s * 1e3 > state.spec.slo_ms):
                good = False
            if not good and ok:
                state.breaches_total += 1
            elif not ok:
                state.breaches_total += 1
            state.window.observe(good, self._clock())

    # -- read side ------------------------------------------------------------
    def _row(self, state: _TenantState, now: float) -> Dict[str, Any]:
        good, bad = state.window.counts(now)
        total = good + bad
        budget = 1.0 - state.spec.slo_objective
        burn = ((bad / total) / budget if total and budget > 0.0 else 0.0)
        row: Dict[str, Any] = {
            "spec": state.spec.to_obj(),
            "admitted_total": state.admitted_total,
            "shed": dict(state.shed_by_reason),
            "completions": state.completions,
            "slo_breaches_total": state.breaches_total,
            "window": {"good": good, "bad": bad,
                       "burn_rate": round(burn, 4),
                       "breached": bool(total) and burn > 1.0},
        }
        if state.bucket is not None:
            state.bucket._refill(now)
            row["quota_tokens"] = round(state.bucket.tokens, 3)
        return row

    def snapshot(self) -> Dict[str, Any]:
        """The doctor's ``tenancy`` section: one row per tenant plus the
        policy-level noisy-neighbor verdicts."""
        with self._lock:
            now = self._clock()
            rows = {
                (DEFAULT_TENANT_LABEL if name is None else name):
                    self._row(state, now)
                for name, state in self._states.items()
            }
        noisy = self.noisy_neighbors()
        return {
            "tenants": rows,
            "window_s": self.window_s,
            "noisy_neighbors": noisy,
        }

    def noisy_neighbors(self) -> List[Dict[str, Any]]:
        """Tenants whose over-quota sheds dominate their admitted
        traffic — the adversarial-neighbor signature. Each verdict NAMES
        the tenant and quantifies its overreach (offered ≈ admitted +
        sheds vs the quota that admitted implies)."""
        from .admission import SHED_OVER_QUOTA

        out: List[Dict[str, Any]] = []
        with self._lock:
            for name, state in self._states.items():
                sheds = state.shed_by_reason.get(SHED_OVER_QUOTA, 0)
                if sheds < _NOISY_MIN_SHEDS:
                    continue
                admitted = state.admitted_total
                if sheds < _NOISY_SHED_FACTOR * max(1, admitted):
                    continue
                offered = admitted + sum(state.shed_by_reason.values())
                out.append({
                    "tenant": (DEFAULT_TENANT_LABEL if name is None
                               else name),
                    "over_quota_sheds": sheds,
                    "admitted_total": admitted,
                    "offered_over_admitted": round(
                        offered / max(1, admitted), 2),
                })
        return out

    # -- telemetry ------------------------------------------------------------
    def attach_telemetry(self, telemetry) -> "TenancyPolicy":
        """Export per-tenant gauges on the telemetry's registry at scrape
        time (cumulative counters exported as gauges, like the cache
        layer's eviction export): admitted/shed totals, quota tokens,
        SLO burn rate and the breached flag. Held by weak reference —
        attaching never extends this policy's lifetime."""
        reg = telemetry.registry
        admitted = reg.gauge(
            "client_tpu_tenant_admitted_total",
            "Requests admitted per tenant (cumulative, exported at "
            "scrape)", ("tenant",))
        shed = reg.gauge(
            "client_tpu_tenant_shed_total",
            "Requests shed per tenant by reason (cumulative, exported "
            "at scrape)", ("tenant", "reason"))
        tokens = reg.gauge(
            "client_tpu_tenant_quota_tokens",
            "Live token-bucket level per metered tenant", ("tenant",))
        burn = reg.gauge(
            "client_tpu_tenant_slo_burn_rate",
            "Windowed per-tenant SLO burn rate (1.0 = burning exactly "
            "the budget)", ("tenant",))
        breached = reg.gauge(
            "client_tpu_tenant_slo_breached",
            "1 when the tenant's windowed burn rate exceeds its budget",
            ("tenant",))
        self_ref = weakref.ref(self)

        def collect() -> None:
            policy = self_ref()
            if policy is None:
                return
            snap = policy.snapshot()
            for label, row in snap["tenants"].items():
                admitted.labels(label).set(row["admitted_total"])
                for reason, n in row["shed"].items():
                    shed.labels(label, reason).set(n)
                if "quota_tokens" in row:
                    tokens.labels(label).set(row["quota_tokens"])
                window = row["window"]
                burn.labels(label).set(window["burn_rate"])
                breached.labels(label).set(
                    1.0 if window["breached"] else 0.0)

        reg.add_collector(collect)
        return self


# live policies (the doctor's tenancy section enumerates these, exactly
# like cache.caches())
_POLICIES: "weakref.WeakSet[TenancyPolicy]" = weakref.WeakSet()


def policies() -> List[TenancyPolicy]:
    """Every live TenancyPolicy in this process."""
    return list(_POLICIES)


# spec-string keys -> TenantSpec kwargs (the CLI/bench surface)
_SPEC_KEYS = {
    "weight": float, "w": float,
    "rate": float, "r": float,
    "burst": float, "b": float,
    "slo_ms": float,
    "slo_objective": float,
    "cache_bytes": int,
}
_SPEC_CANON = {"w": "weight", "r": "rate", "b": "burst"}


def parse_tenancy_spec(spec: str,
                       default: Optional[TenantSpec] = None,
                       window_s: float = 30.0,
                       clock: Callable[[], float] = time.monotonic,
                       ) -> TenancyPolicy:
    """Build a policy from a flat spec string (the perf/bench surface):
    ``name,key=value,...;name2,...`` — e.g.
    ``"alpha,rate=50,weight=2;beta,rate=50;adv,rate=50,slo_ms=250"``.
    Keys: ``weight``/``w``, ``rate``/``r``, ``burst``/``b``, ``slo_ms``,
    ``slo_objective``, ``cache_bytes``."""
    specs: List[TenantSpec] = []
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        name, _, rest = entry.partition(",")
        name = name.strip()
        if not name:
            raise ValueError(f"tenancy spec entry {entry!r} has no name")
        kwargs: Dict[str, Any] = {}
        for part in filter(None, (p.strip() for p in rest.split(","))):
            key, sep, value = part.partition("=")
            if not sep:
                raise ValueError(
                    f"malformed tenancy param {part!r} (want key=value)")
            key = key.strip()
            conv = _SPEC_KEYS.get(key)
            if conv is None:
                raise ValueError(
                    f"unknown tenancy param {key!r} "
                    f"(one of {sorted(set(_SPEC_CANON.values()) | set(k for k in _SPEC_KEYS if len(k) > 1))})")
            kwargs[_SPEC_CANON.get(key, key)] = conv(value.strip())
        specs.append(TenantSpec(name, **kwargs))
    if not specs:
        raise ValueError(f"empty tenancy spec {spec!r}")
    return TenancyPolicy(specs, default=default, window_s=window_s,
                         clock=clock)
