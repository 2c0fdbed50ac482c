"""Adaptive admission control: concurrency limiting + priority-lane shedding.

Under overload, a client that keeps queueing doomed work destroys the p99
of the traffic it *could* have served: every request waits behind requests
that will miss their deadlines anyway, and nothing distinguishes "the
fleet is slow" from "the fleet is drowning". This module closes ROADMAP
item 2's admission half:

- :class:`AdaptiveLimiter` — an adaptive concurrency limit over observed
  completion latency. ``mode="aimd"`` grows the limit additively on
  in-SLO completions and decays it multiplicatively when latency diverges
  from the declared SLO target (or, with no target, from a minRTT EWMA);
  ``mode="gradient"`` is a gradient2-style tracker (long-RTT over
  short-RTT gradient with a sqrt queue allowance). Both are bounded by
  ``min_limit``/``max_limit`` and cheap enough for the per-request path
  (one short lock).

- :class:`AdmissionController` — the limiter plus **priority lanes with
  deadline-aware shedding**. Requests carry a KServe ``priority`` (0 =
  default; per the reference semantics LOWER values are MORE important)
  mapped to a lane; when the limiter is saturated:

  * requests that cannot possibly meet their deadline (remaining budget
    below the limiter's latency estimate) are rejected immediately —
    reject cheap and early beats timing out late;
  * low-priority lanes are rejected immediately instead of queueing;
  * everyone else waits in a bounded per-lane **LIFO** queue — the
    NEWEST waiter is admitted first, so fresh requests beat requests
    that have already burned most of their budget waiting — bounded by
    ``max_queue`` and ``max_queue_wait_s``.

- :class:`AdmissionRejected` — the typed fault every shed raises. It is a
  *client-local* rejection (nothing touched the wire):
  ``resilience.classify_fault`` maps it to the ``SHED`` domain (never
  retried, never counted against breakers or outlier ejection) and the
  perf/replay harnesses count it as ``shed``, not ``error``.

- **Tenancy** (``AdmissionController(tenancy=...)``, see
  ``client_tpu_torch.tenancy``): each lane's waiter stack becomes per-tenant
  virtual queues drained weighted-fair — the tenant with the smallest
  virtual finish time drains next (its vtime advances by ``1/weight``
  per admit), LIFO within the tenant, so one tenant's backlog can no
  longer starve its lane-mates while a single tenant sees the exact
  legacy LIFO order. Token-bucket quotas shed over-quota requests at
  the door with the typed reason ``over_quota`` and an HONEST
  ``retry_after_s`` (the bucket's refill eta). ``over_quota`` is a
  POLICY denial, deliberately absent from ``SPILL_REASONS`` — a
  federation layer must never launder a quota away by spilling the
  excess to another cell.

Wiring lives in ``client_tpu_torch.pool`` (``PoolClient(admission=...)``
acquires one token per pooled infer — one token covers the whole
failover/hedge engine run, and a coalesced batch from
``client_tpu_torch.batch`` admits ONCE per wire dispatch by construction) and
``client_tpu_torch.observe`` (``Telemetry.attach_admission`` exports
``client_tpu_admission_shed_total{lane,reason}``, per-lane queue depth,
and the live limit/inflight gauges). This module is a copy of
``client_tpu.admission``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import flight as _flight
from .utils import InferenceServerException

__all__ = [
    "AdaptiveLimiter",
    "AdmissionController",
    "AdmissionRejected",
    "AdmissionToken",
    "LANE_DEFAULT",
    "LANE_HIGH",
    "LANE_LOW",
    "SHED_DEADLINE",
    "SHED_ENDPOINT_SATURATED",
    "SHED_OVER_QUOTA",
    "SHED_QUEUE_FULL",
    "SHED_QUEUE_TIMEOUT",
    "SHED_SATURATED",
    "SPILL_REASONS",
    "default_lane_map",
    "is_spill_signal",
]

# shed reasons (the {reason} label on client_tpu_admission_shed_total)
SHED_SATURATED = "saturated"            # low lane rejected at the door
SHED_DEADLINE = "deadline"              # could not possibly meet its deadline
SHED_QUEUE_FULL = "queue_full"          # lane queue at capacity
SHED_QUEUE_TIMEOUT = "queue_timeout"    # waited max_queue_wait_s, still saturated
SHED_ENDPOINT_SATURATED = "endpoint_saturated"  # every replica at its limit
SHED_OVER_QUOTA = "over_quota"          # tenant token-bucket quota exhausted

LANE_HIGH = "high"
LANE_DEFAULT = "default"
LANE_LOW = "low"

# the controller's exception status; resilience.classify_fault keys the
# SHED domain off this string so the two modules never import each other
ADMISSION_REJECTED_STATUS = "ADMISSION_REJECTED"

# shed reasons that double as CAPACITY signals: every one of them means
# "this cell/pool cannot take the request right now", so a multi-cell
# layer (client_tpu_torch.federation) may answer it by SPILLING the request to
# another cell instead of surfacing the shed to the caller. A rejection
# reason that is NOT about capacity must be left out of this set so it
# never silently moves traffic — concretely, SHED_OVER_QUOTA is a POLICY
# denial: spilling a tenant's over-quota excess to a sibling cell would
# launder the quota away, so it stays out of this set by design.
SPILL_REASONS = frozenset({
    SHED_SATURATED,
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    SHED_QUEUE_TIMEOUT,
    SHED_ENDPOINT_SATURATED,
})


def is_spill_signal(exc: BaseException) -> bool:
    """Whether this fault is an admission shed a locality-spillover
    layer may answer by re-routing to another cell (see
    ``SPILL_REASONS``). The federation layer calls this on every
    ``AdmissionRejected`` its home cell raises — the shed→spill bridge
    that turns saturation into graceful degradation instead of a
    user-visible error."""
    return (isinstance(exc, AdmissionRejected)
            and exc.reason in SPILL_REASONS)


class AdmissionRejected(InferenceServerException):
    """A request shed by admission control before it touched the wire.

    ``reason`` is one of the ``SHED_*`` constants, ``lane`` the priority
    lane it was judged in, ``tenant`` the tenant it was judged AS (None
    for tenantless traffic). ``retry_after_s`` is an honest backpressure
    hint when known: the token bucket's refill eta for ``over_quota``
    sheds, the limiter's minRTT eta for capacity sheds. ``classify_fault``
    maps this to the ``SHED`` domain: never retried, never a
    breaker/ejection signal, and counted as ``shed`` (not ``error``) by
    the perf/replay harnesses."""

    def __init__(self, reason: str, lane: str = LANE_DEFAULT,
                 msg: Optional[str] = None,
                 retry_after_s: Optional[float] = None,
                 tenant: Optional[str] = None):
        super().__init__(
            msg or (f"admission rejected ({reason}; lane={lane}"
                    + (f"; tenant={tenant}" if tenant is not None else "")
                    + (f"; retry_after={retry_after_s:.3f}s"
                       if retry_after_s is not None else "")
                    + ")"),
            status=ADMISSION_REJECTED_STATUS)
        self.reason = reason
        self.lane = lane
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        # set True once a telemetry counter has seen this instance, so a
        # shed that crosses layers (endpoint select -> pool wrapper) is
        # exported exactly once
        self.counted = False


def default_lane_map(priority: int) -> Tuple[str, int]:
    """KServe ``priority`` -> ``(lane, rank)``; rank 0 drains first.

    The reference semantics: priority 0 means "the model's default
    priority level"; EXPLICIT values are ordered with lower = more
    important (1 is the highest priority). So ``1`` rides the high lane,
    ``0``/unset the default lane, and everything ``>= 2`` the low lane —
    the lane shed first under saturation."""
    if priority == 1:
        return LANE_HIGH, 0
    if priority in (0, None):
        return LANE_DEFAULT, 1
    return LANE_LOW, 2


class AdaptiveLimiter:
    """An adaptive concurrency limit over observed completion latency.

    ``mode="aimd"`` (default): every in-SLO completion grows the limit by
    ``increase / limit`` (additive, amortized — one full unit of limit per
    ``limit`` good completions); a breach (an error, or latency above the
    SLO ``target_ms`` — or above ``tolerance * minRTT`` when no target is
    declared) decays it multiplicatively by ``decay``, at most once per
    ``cooldown_s`` so one burst of queued completions doesn't collapse
    the limit to the floor in a single RTT.

    ``mode="gradient"`` (gradient2-style): tracks a slow long-RTT EWMA
    and a fast short-RTT EWMA; the limit tracks
    ``limit * clamp(long/short) + sqrt(limit)`` (the sqrt term is the
    queue allowance), smoothed by ``smoothing``. Errors and SLO-target
    breaches decay multiplicatively exactly like aimd.

    The limiter also maintains a **minRTT EWMA** (fast to track down,
    slow to drift up) used as the service-time estimate for
    deadline-aware shedding (:meth:`eta_s`).

    Thread-safe; every operation is one short lock."""

    def __init__(
        self,
        mode: str = "aimd",
        target_ms: Optional[float] = None,
        initial_limit: float = 8.0,
        min_limit: int = 1,
        max_limit: int = 256,
        increase: float = 1.0,
        decay: float = 0.7,
        tolerance: float = 2.0,
        cooldown_s: float = 0.1,
        smoothing: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
    ):
        if mode not in ("aimd", "gradient"):
            raise ValueError(f"unknown limiter mode {mode!r} (aimd|gradient)")
        if min_limit < 1 or max_limit < min_limit:
            raise ValueError("need 1 <= min_limit <= max_limit")
        if not 0.0 < decay < 1.0:
            raise ValueError("decay must be in (0, 1)")
        if tolerance < 1.0:
            raise ValueError("tolerance must be >= 1")
        self.mode = mode
        self.target_ms = target_ms
        self.min_limit = int(min_limit)
        self.max_limit = int(max_limit)
        self.increase = float(increase)
        self.decay = float(decay)
        self.tolerance = float(tolerance)
        self.cooldown_s = float(cooldown_s)
        self.smoothing = float(smoothing)
        self._clock = clock
        self._lock = threading.Lock()
        self._limit = float(min(max(initial_limit, min_limit), max_limit))
        self._minrtt_s: Optional[float] = None
        self._short_s: Optional[float] = None  # fast EWMA (gradient mode)
        self._long_s: Optional[float] = None   # slow EWMA (gradient mode)
        self._last_decay = 0.0
        self.good_total = 0
        self.breach_total = 0
        self.decay_total = 0

    # EWMA alphas: minRTT tracks down fast and drifts up slowly (so a
    # transient fast completion re-anchors it but sustained queueing can't
    # inflate it into vouching for doomed deadlines); gradient's long RTT
    # moves an order of magnitude slower than its short RTT
    _MINRTT_DOWN = 0.5
    _MINRTT_UP = 0.02
    _SHORT_ALPHA = 0.3
    _LONG_ALPHA = 0.03

    @property
    def limit(self) -> float:
        with self._lock:
            return self._limit

    def limit_int(self) -> int:
        """The whole-request admission bound (never below 1)."""
        with self._lock:
            return max(1, int(self._limit))

    def would_admit(self, inflight: int) -> bool:
        return inflight < self.limit_int()

    def eta_s(self) -> Optional[float]:
        """The current service-time estimate (minRTT EWMA) used for
        deadline feasibility; None until a completion has been seen."""
        with self._lock:
            return self._minrtt_s

    def minrtt_ms(self) -> Optional[float]:
        eta = self.eta_s()
        return eta * 1e3 if eta is not None else None

    # -- feeding --------------------------------------------------------------
    def on_result(self, latency_s: Optional[float], ok: bool = True) -> bool:
        """Feed one completion. ``latency_s=None`` with ``ok=True`` is a
        neutral release (no signal — e.g. a request shed downstream);
        ``ok=False`` is a breach whatever the latency (an overload-class
        error is the strongest "back off" signal there is). Returns
        whether the completion counted as in-SLO."""
        if latency_s is None and ok:
            return True
        with self._lock:
            now = self._clock()
            if latency_s is not None:
                self._feed_rtts(latency_s)
            breach = not ok or self._is_breach(latency_s)
            if breach:
                self.breach_total += 1
                if now - self._last_decay >= self.cooldown_s:
                    self._limit = max(
                        float(self.min_limit), self._limit * self.decay)
                    self._last_decay = now
                    self.decay_total += 1
                return False
            self.good_total += 1
            if self.mode == "gradient":
                self._gradient_step()
            else:
                self._limit = min(
                    float(self.max_limit),
                    self._limit + self.increase / max(self._limit, 1.0))
            return True

    def _feed_rtts(self, latency_s: float) -> None:
        if latency_s < 0.0:
            return
        m = self._minrtt_s
        if m is None:
            self._minrtt_s = latency_s
        else:
            alpha = self._MINRTT_DOWN if latency_s < m else self._MINRTT_UP
            self._minrtt_s = m + alpha * (latency_s - m)
        s = self._short_s
        self._short_s = (latency_s if s is None
                         else s + self._SHORT_ALPHA * (latency_s - s))
        lo = self._long_s
        self._long_s = (latency_s if lo is None
                        else lo + self._LONG_ALPHA * (latency_s - lo))

    def _is_breach(self, latency_s: Optional[float]) -> bool:
        if latency_s is None:
            return False
        if self.target_ms is not None:
            return latency_s * 1e3 > self.target_ms
        m = self._minrtt_s
        return m is not None and latency_s > self.tolerance * m

    def _gradient_step(self) -> None:
        short, long = self._short_s, self._long_s
        if not short or not long:
            return
        # gradient < 1 means latency is rising above its long-run norm:
        # shrink; clamped so one outlier sample can neither halve nor
        # double the limit in a single step
        gradient = max(0.5, min(1.0, self.tolerance * long / short / 2.0 + 0.5))
        candidate = self._limit * gradient + math.sqrt(self._limit)
        self._limit = max(
            float(self.min_limit),
            min(float(self.max_limit),
                (1.0 - self.smoothing) * self._limit
                + self.smoothing * candidate))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "mode": self.mode,
                "limit": round(self._limit, 2),
                "min_limit": self.min_limit,
                "max_limit": self.max_limit,
                "target_ms": self.target_ms,
                "minrtt_ms": (round(self._minrtt_s * 1e3, 3)
                              if self._minrtt_s is not None else None),
                "good_total": self.good_total,
                "breach_total": self.breach_total,
                "decay_total": self.decay_total,
            }


# waiter states; transitions happen ONLY under the controller lock
_WAITING = "waiting"
_ADMITTED = "admitted"
_CANCELLED = "cancelled"
_SHED = "shed"


class _Waiter:
    """One parked acquire: a sync thread (``event``) or an asyncio task
    (``loop`` + ``future``). ``state`` transitions only under the
    controller lock — the event/future is a wakeup hint, never the
    authority on who owns the admission slot."""

    __slots__ = ("lane", "rank", "tenant", "deadline", "enqueued_ns",
                 "state", "event", "loop", "future", "shed_reason")

    def __init__(self, lane: str, rank: int, deadline: Optional[float],
                 tenant: Optional[str] = None):
        self.lane = lane
        self.rank = rank
        self.tenant = tenant
        self.deadline = deadline
        self.enqueued_ns = time.perf_counter_ns()
        self.state = _WAITING
        self.event: Optional[threading.Event] = None
        self.loop = None
        self.future = None
        self.shed_reason: Optional[str] = None

    def notify(self) -> bool:
        """Wake the waiter; False when it can never wake (its event loop
        is closed) so the caller can reclaim the admission slot instead
        of leaking it — and instead of letting the RuntimeError abort
        the rest of a release's notify batch."""
        if self.event is not None:
            self.event.set()
            return True
        try:
            self.loop.call_soon_threadsafe(self._resolve)
            return True
        except RuntimeError:
            return False

    def _resolve(self) -> None:
        if not self.future.done():
            self.future.set_result(True)


class _TenantQueue:
    """One tenant's LIFO waiter stack within a lane, plus its WFQ
    virtual finish time. ``vtime`` advances by ``1/weight`` per admitted
    waiter; the drain always serves the smallest-vtime tenant next, so
    service converges to weight-proportional shares under contention.
    Mutations happen under the controller lock."""

    __slots__ = ("stack", "depth", "vtime", "weight")

    def __init__(self, weight: float):
        self.stack: deque = deque()
        self.depth = 0  # live (non-cancelled) waiters of this tenant
        self.vtime = 0.0
        self.weight = weight


class _Lane:
    """One priority lane: per-tenant LIFO waiter queues drained
    weighted-fair, plus the lane's counters. ``vclock`` is the lane's
    virtual clock — the vtime of the last served tenant; a tenant whose
    queue went idle re-enters at ``max(its vtime, vclock)`` so idling
    never banks catch-up credit (the classic WFQ start-time rule). With
    a single tenant the drain degenerates to the exact legacy
    LIFO-within-lane order. Mutations happen under the controller lock;
    cancelled waiters stay in their stack (marked) and are skipped
    lazily at drain time."""

    __slots__ = ("label", "rank", "queues", "depth", "vclock",
                 "admitted_total", "shed_by_reason")

    def __init__(self, label: str, rank: int):
        self.label = label
        self.rank = rank
        self.queues: Dict[Optional[str], _TenantQueue] = {}
        self.depth = 0  # live (non-cancelled) waiters across tenants
        self.vclock = 0.0
        self.admitted_total = 0
        self.shed_by_reason: Dict[str, int] = {}


class AdmissionToken:
    """One admitted request's slot. ``release`` returns the slot and
    feeds the limiter: pass the completion latency and whether the
    outcome was ok; ``latency_s=None`` with ``ok=True`` releases without
    feeding (nothing was learned). Double release raises."""

    __slots__ = ("_ctrl", "lane", "tenant", "waited_s", "_released")

    def __init__(self, ctrl: "AdmissionController", lane: str,
                 waited_s: float, tenant: Optional[str] = None):
        self._ctrl = ctrl
        self.lane = lane
        self.tenant = tenant
        self.waited_s = waited_s
        self._released = False

    def release(self, latency_s: Optional[float] = None,
                ok: bool = True) -> None:
        if self._released:
            raise InferenceServerException(
                "admission token released twice", status="ADMISSION_TOKEN")
        self._released = True
        self._ctrl._release(latency_s, ok, self.tenant)


class AdmissionController:
    """The pool-level admission gate: limiter + lanes + deadline shedding.

    ``acquire`` / ``acquire_async`` either return an
    :class:`AdmissionToken` (whose ``release`` MUST be called exactly
    once) or raise :class:`AdmissionRejected`. One token should cover one
    logical request end to end — the pool acquires before routing and
    releases after the whole failover/hedge engine finishes, so retries
    and hedges never multiply admission.

    ``observer`` (duck-typed, see ``observe.Telemetry.attach_admission``):
    ``on_admission_admit(lane, waited_s)`` / ``on_admission_shed(lane,
    reason)``, called outside the lock and never allowed to break the
    data path."""

    def __init__(
        self,
        limiter: Optional[AdaptiveLimiter] = None,
        mode: str = "aimd",
        target_ms: Optional[float] = None,
        max_queue: int = 64,
        max_queue_wait_s: float = 0.5,
        shed_low_when_saturated: bool = True,
        eta_factor: float = 1.0,
        lane_map: Callable[[int], Tuple[str, int]] = default_lane_map,
        tenancy: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """``limiter`` defaults to ``AdaptiveLimiter(mode=mode,
        target_ms=target_ms)``. ``max_queue`` bounds EACH lane's waiter
        stack; ``max_queue_wait_s`` bounds how long any waiter parks
        before it sheds (also clamped by the request's own deadline minus
        the limiter's service-time estimate). ``eta_factor`` scales the
        estimate in the deadline-feasibility test (>1 sheds earlier).
        ``tenancy`` — a ``client_tpu_torch.tenancy.TenancyPolicy`` (or a spec
        string for ``parse_tenancy_spec``) arming per-tenant quotas and
        weighted-fair drain; None keeps the controller tenant-blind
        (tenants still get separate queues but equal weight and no
        quota)."""
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        if max_queue_wait_s < 0:
            raise ValueError("max_queue_wait_s must be >= 0")
        if isinstance(tenancy, str):
            from .tenancy import parse_tenancy_spec
            tenancy = parse_tenancy_spec(tenancy, clock=clock)
        self.tenancy = tenancy
        self.limiter = limiter or AdaptiveLimiter(
            mode=mode, target_ms=target_ms)
        self.max_queue = int(max_queue)
        self.max_queue_wait_s = float(max_queue_wait_s)
        self.shed_low_when_saturated = shed_low_when_saturated
        self.eta_factor = float(eta_factor)
        self._lane_map = lane_map
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0
        self._lanes: Dict[str, _Lane] = {}
        self.admitted_total = 0
        self.shed_total = 0
        self.observer = None

    # -- introspection --------------------------------------------------------
    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return {label: lane.depth for label, lane in self._lanes.items()}

    def snapshot(self) -> Dict[str, Any]:
        limiter = self.limiter.snapshot()
        with self._lock:
            lanes = {}
            for label, lane in self._lanes.items():
                row: Dict[str, Any] = {
                    "depth": lane.depth,
                    "admitted_total": lane.admitted_total,
                    "shed": dict(lane.shed_by_reason),
                }
                # per-tenant queue depths, only once a real (non-None)
                # tenant has queued here — tenantless snapshots stay
                # byte-identical to the pre-tenancy schema
                if any(t is not None for t in lane.queues):
                    row["tenants"] = {
                        (t if t is not None else "_default"): tq.depth
                        for t, tq in lane.queues.items()
                    }
                lanes[label] = row
            snap = {
                "limit": limiter["limit"],
                "inflight": self._inflight,
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                # pinned at the floor: the collapse signal doctor's
                # admission_collapse anomaly keys off (alongside SLO burn)
                "collapsed": limiter["limit"] <= limiter["min_limit"],
                "lanes": lanes,
                "limiter": limiter,
            }
        if self.tenancy is not None:
            # outside the controller lock: the policy takes its own
            snap["tenancy"] = self.tenancy.snapshot()
        return snap

    def watch_gauges(self) -> Dict[str, Any]:
        """The watchtower's gauge-source contract: cumulative totals the
        tower differences per tick into a live shed rate, plus the
        instantaneous pressure gauges."""
        limiter = self.limiter.snapshot()
        with self._lock:
            return {
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "inflight": self._inflight,
                "limit": limiter["limit"],
                "collapsed": limiter["limit"] <= limiter["min_limit"],
            }

    # -- internals ------------------------------------------------------------
    def _lane(self, label: str, rank: int) -> _Lane:
        lane = self._lanes.get(label)
        if lane is None:
            lane = self._lanes[label] = _Lane(label, rank)
        return lane

    def _observe_admit(self, lane: str, waited_s: float,
                       tenant: Optional[str] = None) -> None:
        if tenant is not None:
            _flight.note("admission", "admit", lane=lane, tenant=tenant,
                         waited_ms=round(waited_s * 1e3, 3))
        else:
            _flight.note("admission", "admit", lane=lane,
                         waited_ms=round(waited_s * 1e3, 3))
        if self.tenancy is not None:
            self.tenancy.on_admit(tenant)
        if self.observer is not None:
            try:
                self.observer.on_admission_admit(lane, waited_s)
            except Exception:
                pass  # an observer must never break the data path

    def _shed(self, lane: _Lane, reason: str,
              retry_after_s: Optional[float] = None,
              tenant: Optional[str] = None) -> AdmissionRejected:
        """Count one shed and build (not raise) the typed rejection."""
        with self._lock:
            self.shed_total += 1
            lane.shed_by_reason[reason] = (
                lane.shed_by_reason.get(reason, 0) + 1)
        exc = AdmissionRejected(reason, lane.label,
                                retry_after_s=retry_after_s,
                                tenant=tenant)
        if tenant is not None:
            _flight.note("admission", "shed", reason=reason,
                         lane=lane.label, tenant=tenant)
        else:
            _flight.note("admission", "shed", reason=reason,
                         lane=lane.label)
        if self.tenancy is not None:
            self.tenancy.on_shed(tenant, reason)
        if self.observer is not None:
            try:
                self.observer.on_admission_shed(lane.label, reason)
                exc.counted = True
            except Exception:
                pass
        return exc

    def _deadline_infeasible(self, deadline: Optional[float],
                             now: float) -> bool:
        """Could this request still complete before its deadline if it
        were admitted right now? (minRTT EWMA as the service estimate —
        shedding work that cannot possibly finish is the cheapest
        capacity there is.)"""
        if deadline is None:
            return False
        eta = self.limiter.eta_s()
        if eta is None:
            return deadline <= now  # no estimate: only shed already-late
        return now + eta * self.eta_factor > deadline

    def _try_admit_locked(self, rank: int) -> bool:
        """Fast-path admission under the lock. A fresh arrival may take a
        free slot ahead of queued SAME-OR-LOWER-priority waiters (that IS
        the LIFO rule: the freshest request wins) but never ahead of a
        queued HIGHER-priority lane."""
        if self._inflight >= self.limiter.limit_int():
            return False
        for lane in self._lanes.values():
            if lane.depth > 0 and lane.rank < rank:
                return False
        self._inflight += 1
        return True

    def _tenant_queue_locked(self, lane: _Lane,
                             tenant: Optional[str]) -> _TenantQueue:
        tq = lane.queues.get(tenant)
        if tq is None:
            weight = (self.tenancy.weight(tenant)
                      if self.tenancy is not None else 1.0)
            tq = lane.queues[tenant] = _TenantQueue(weight)
        return tq

    def _park_locked(self, lane: _Lane, waiter: _Waiter) -> None:
        tq = self._tenant_queue_locked(lane, waiter.tenant)
        if tq.depth == 0:
            # the WFQ start-time rule: an idle tenant re-enters at the
            # lane's virtual clock, so idling never banks catch-up credit
            tq.vtime = max(tq.vtime, lane.vclock)
        tq.stack.append(waiter)
        tq.depth += 1
        lane.depth += 1

    def _drain_locked(self) -> List[_Waiter]:
        """Admit queued waiters while slots are free: lanes by rank
        (high first); within a lane, the tenant with the smallest virtual
        finish time drains next (weighted-fair — its vtime advances by
        ``1/weight`` per admit), NEWEST waiter first within the tenant.
        Waiters whose deadline became infeasible while parked are shed
        instead of admitted (their slot stays free, and the shed does not
        advance the tenant's vtime — no service was rendered). Returns
        waiters to notify OUTSIDE the lock."""
        to_notify: List[_Waiter] = []
        now = self._clock()
        lanes = sorted(self._lanes.values(), key=lambda l: l.rank)
        for lane in lanes:
            while lane.depth > 0 and self._inflight < self.limiter.limit_int():
                tq = min((q for q in lane.queues.values() if q.depth > 0),
                         key=lambda q: q.vtime)
                waiter = tq.stack.pop()  # LIFO: newest first
                if waiter.state != _WAITING:
                    continue  # cancelled: depths already decremented
                tq.depth -= 1
                lane.depth -= 1
                if self._deadline_infeasible(waiter.deadline, now):
                    waiter.state = _SHED
                    waiter.shed_reason = SHED_DEADLINE
                    to_notify.append(waiter)
                    continue
                waiter.state = _ADMITTED
                lane.vclock = max(lane.vclock, tq.vtime)
                tq.vtime += 1.0 / tq.weight
                self._inflight += 1
                lane.admitted_total += 1
                self.admitted_total += 1
                to_notify.append(waiter)
        return to_notify

    def _release(self, latency_s: Optional[float], ok: bool,
                 tenant: Optional[str] = None) -> None:
        self.limiter.on_result(latency_s, ok)
        if self.tenancy is not None and not (latency_s is None and ok):
            # neutral releases (no signal) skip the tenant's SLO window
            self.tenancy.on_result(tenant, latency_s, ok)
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            to_notify = self._drain_locked()
        while to_notify:
            dead = [w for w in to_notify if not w.notify()]
            if not dead:
                return
            # a waiter whose loop died can never wake: reclaim any slot
            # transferred to it and hand the capacity to the next waiter
            with self._lock:
                for w in dead:
                    if w.state == _ADMITTED:
                        w.state = _CANCELLED
                        self._inflight = max(0, self._inflight - 1)
                to_notify = self._drain_locked()

    def _admit_or_park(self, priority: int, deadline: Optional[float],
                       loop=None, tenant: Optional[str] = None,
                       lane: Optional[Tuple[str, int]] = None) -> Any:
        """Shared front half of the sync/async acquire: fast-path admit
        (returns a token), immediate shed (raises), or a parked waiter
        (returned for the caller to wait on). One lock acquisition
        decides everything — a slot freed between two separate critical
        sections could otherwise strand a fresh waiter until timeout.
        ``loop`` non-None builds an asyncio waiter (future created BEFORE
        the waiter is published, so a racing wakeup always has something
        to notify). ``lane`` overrides the priority→lane mapping with an
        explicit ``(label, rank)`` — the disaggregated prefill/decode
        layer charges its two legs to separate lanes this way (their
        SLOs differ); lanes are created lazily, no registration needed."""
        label, rank = lane if lane is not None \
            else self._lane_map(priority or 0)
        # the quota gate runs FIRST and unconditionally — even on an idle
        # controller. A quota is policy, not a load response: an
        # over-quota tenant is denied whether or not capacity is free,
        # with the bucket's refill eta as the honest retry hint
        if self.tenancy is not None:
            quota_ok, refill_eta = self.tenancy.try_take(tenant)
            if not quota_ok:
                with self._lock:
                    lane = self._lane(label, rank)
                raise self._shed(lane, SHED_OVER_QUOTA,
                                 retry_after_s=refill_eta, tenant=tenant)
        # deadline feasibility is judged ONLY when saturated (below): an
        # idle controller always admits, even a request the minRTT EWMA
        # says is doomed — a wrong estimate then costs one admitted
        # request whose completion CORRECTS the estimate, whereas
        # shedding at the door would starve the estimator of completions
        # and lock a transiently-inflated minRTT into a permanent
        # full-shed outage
        infeasible = self._deadline_infeasible(deadline, self._clock())
        shed_reason: Optional[str] = None
        waiter: Optional[_Waiter] = None
        admitted = False
        with self._lock:
            lane = self._lane(label, rank)
            if self._try_admit_locked(rank):
                lane.admitted_total += 1
                self.admitted_total += 1
                admitted = True
            elif infeasible:
                shed_reason = SHED_DEADLINE
            elif self.shed_low_when_saturated and label == LANE_LOW:
                shed_reason = SHED_SATURATED
            elif (self.max_queue == 0
                  or self._tenant_queue_locked(lane, tenant).depth
                  >= self.max_queue):
                # the bound is per TENANT queue: one tenant's backlog
                # fills its own queue, never the whole lane's
                shed_reason = SHED_QUEUE_FULL
            else:
                waiter = _Waiter(label, rank, deadline, tenant)
                if loop is None:
                    waiter.event = threading.Event()
                else:
                    waiter.loop = loop
                    waiter.future = loop.create_future()
                self._park_locked(lane, waiter)
        if admitted:
            self._observe_admit(label, 0.0, tenant)
            return AdmissionToken(self, label, 0.0, tenant)
        if waiter is not None:
            return waiter
        raise self._shed(lane, shed_reason,
                         retry_after_s=self.limiter.eta_s(),
                         tenant=tenant)

    def _wait_bound_s(self, deadline: Optional[float]) -> float:
        """How long a waiter may park: the queue-wait cap, clamped so a
        deadline-carrying request leaves itself the limiter's service
        estimate to actually run."""
        bound = self.max_queue_wait_s
        if deadline is not None:
            eta = self.limiter.eta_s() or 0.0
            bound = min(bound, max(
                0.0, deadline - self._clock() - eta * self.eta_factor))
        return bound

    def _settle_waiter(self, waiter: _Waiter) -> Tuple[str, Optional[str]]:
        """Resolve a waiter's final state under the lock after its wait
        ended (wakeup, timeout or cancellation). Ownership is decided
        HERE: a wakeup racing a timeout may have admitted the waiter
        already — then the slot is ours and the timeout is moot."""
        with self._lock:
            state, reason = waiter.state, waiter.shed_reason
            if state == _WAITING:
                waiter.state = _CANCELLED
                lane = self._lanes[waiter.lane]
                lane.depth -= 1
                tq = lane.queues.get(waiter.tenant)
                if tq is not None:
                    tq.depth -= 1
                    # remove the tombstone NOW: drain pops newest-first,
                    # so a cancelled waiter buried under live ones would
                    # otherwise sit in the deque forever — unbounded
                    # growth exactly during the sustained saturation this
                    # module exists for
                    try:
                        tq.stack.remove(waiter)
                    except ValueError:
                        pass  # already popped (and skipped) by a drain
                return _CANCELLED, None
            return state, reason

    def _finish_wait(self, waiter: _Waiter) -> AdmissionToken:
        """Shared back half of the sync/async acquire: turn the settled
        waiter into a token or the right typed rejection."""
        state, reason = self._settle_waiter(waiter)
        lane = self._lanes[waiter.lane]
        if state == _ADMITTED:
            waited = (time.perf_counter_ns() - waiter.enqueued_ns) * 1e-9
            self._observe_admit(waiter.lane, waited, waiter.tenant)
            return AdmissionToken(self, waiter.lane, waited, waiter.tenant)
        if state == _SHED:
            raise self._shed(lane, reason or SHED_DEADLINE,
                             tenant=waiter.tenant)
        raise self._shed(lane, SHED_QUEUE_TIMEOUT,
                         retry_after_s=self.limiter.eta_s(),
                         tenant=waiter.tenant)

    def _force_admit(self, priority: int,
                     tenant: Optional[str] = None,
                     lane: Optional[Tuple[str, int]] = None) -> AdmissionToken:
        """Unconditional admission (still counted in-flight): established
        sequences use it — shedding step k of a sequence the server
        already holds state for would poison replica-local state, which
        is strictly worse than the overload it would relieve. The
        tenant's quota IS still charged (debt bounded at one burst), so
        a long sequence consumes quota without ever being shed."""
        label, rank = lane if lane is not None \
            else self._lane_map(priority or 0)
        if self.tenancy is not None:
            self.tenancy.charge(tenant)
        with self._lock:
            lane = self._lane(label, rank)
            self._inflight += 1
            lane.admitted_total += 1
            self.admitted_total += 1
        self._observe_admit(label, 0.0, tenant)
        return AdmissionToken(self, label, 0.0, tenant)

    # -- sync acquire ---------------------------------------------------------
    def acquire(self, priority: int = 0,
                deadline: Optional[float] = None,
                force: bool = False,
                tenant: Optional[str] = None,
                lane: Optional[Tuple[str, int]] = None) -> AdmissionToken:
        """Admit one request or raise :class:`AdmissionRejected`.
        ``deadline`` is an absolute ``time.monotonic`` instant (the
        request's budget), enabling deadline-aware shedding. ``force``
        admits unconditionally (never sheds, still counts in-flight).
        ``tenant`` selects the tenant's virtual queue and quota (None:
        the tenantless default queue). ``lane`` is an explicit
        ``(label, rank)`` override of the priority→lane mapping (lanes
        are created lazily): the disaggregated prefill/decode layer
        charges its legs to separate lanes whose SLOs differ."""
        if force:
            return self._force_admit(priority, tenant, lane=lane)
        parked = self._admit_or_park(priority, deadline, tenant=tenant,
                                     lane=lane)
        if isinstance(parked, AdmissionToken):
            return parked
        waiter: _Waiter = parked
        # unlocked depth read: a point-in-time queue-depth annotation on
        # the flight timeline, not an accounting source
        _flight.note("admission", "park", lane=waiter.lane,
                     depth=self._lanes[waiter.lane].depth)
        waiter.event.wait(self._wait_bound_s(deadline))
        return self._finish_wait(waiter)

    # -- async acquire --------------------------------------------------------
    async def acquire_async(self, priority: int = 0,
                            deadline: Optional[float] = None,
                            force: bool = False,
                            tenant: Optional[str] = None,
                            lane: Optional[Tuple[str, int]] = None,
                            ) -> AdmissionToken:
        """Asyncio twin of :meth:`acquire`. Cancellation mid-wait returns
        the slot if the wakeup raced the cancel — a cancelled caller can
        never leak admission."""
        import asyncio

        if force:
            return self._force_admit(priority, tenant, lane=lane)
        parked = self._admit_or_park(
            priority, deadline, loop=asyncio.get_running_loop(),
            tenant=tenant, lane=lane)
        if isinstance(parked, AdmissionToken):
            return parked
        waiter: _Waiter = parked
        _flight.note("admission", "park", lane=waiter.lane,
                     depth=self._lanes[waiter.lane].depth)
        try:
            await asyncio.wait_for(
                waiter.future, timeout=self._wait_bound_s(deadline))
        except asyncio.TimeoutError:
            pass  # _finish_wait decides ownership under the lock
        except asyncio.CancelledError:
            state, reason = self._settle_waiter(waiter)
            if state == _ADMITTED:
                # the wakeup won the race: give the slot back
                self._release(None, True, waiter.tenant)
            elif state == _SHED:
                # a drain shed this waiter just before the cancel landed:
                # the shed HAPPENED — count it (the built exception is
                # discarded; the caller sees its CancelledError)
                self._shed(self._lanes[waiter.lane],
                           reason or SHED_DEADLINE, tenant=waiter.tenant)
            raise
        return self._finish_wait(waiter)
