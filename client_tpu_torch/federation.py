"""Multi-cell federation: locality-first spillover, shadow & canary rollout.

One :class:`~client_tpu_torch.pool.PoolClient` stops at one *cell* — one site's
replica fleet. Production deployments run several cells (zones, racks,
shared facilities) and two failure shapes the single-cell stack cannot
absorb: a WHOLE cell saturating or blackholing (admission sheds become
user-visible errors instead of traffic moving somewhere healthy), and a
bad model rollout (a new version burning its SLO with no automatic way
back). This module closes ROADMAP item 5:

- :class:`FederatedClient` / :class:`AioFederatedClient` — the familiar
  ``InferenceServerClient`` surface over NAMED cells, each cell an
  existing pool client, so resilience, admission, the shm arena, caching,
  batching and flight recording all compose unchanged *underneath*::

      from client_tpu_torch.federation import FederatedClient

      fed = FederatedClient(
          {"us-a": ["10.0.0.1:8000", "10.0.0.2:8000"],
           "us-b": ["10.1.0.1:8000", "10.1.0.2:8000"]},
          home="us-a", protocol="http")
      fed.infer("simple", inputs)       # home cell; spills when it can't

- **Locality-first spillover** — traffic goes to the *home* cell; a
  request the home cell cannot serve transparently fails over to the
  next-preferred cell under ONE shared
  :class:`~client_tpu_torch.resilience.AttemptBudget`. Three spill signals:

  * *saturated* — the home pool shed it (typed
    :class:`~client_tpu_torch.admission.AdmissionRejected`:
    ``endpoint_saturated``, lane saturation, queue overflow — see
    ``admission.SPILL_REASONS``). A windowed shed-rate **hysteresis**
    (engage above ``spill_shed_hi``, release below ``spill_shed_lo``)
    flips the cell into *spill-active* so sustained saturation stops
    paying a doomed home attempt per request, and traffic returns home
    only once the pressure genuinely clears.
  * *down* — the per-cell :class:`~client_tpu_torch.resilience.CircuitBreaker`
    is open (fed by fed-level transport outcomes: a cell whose pool
    keeps failing over to nothing opens its breaker and is skipped
    wholesale until a half-open probe proves it back), the pool raised
    ``NoEndpointAvailableError``, or connect-class failures.
  * *blackholed / erroring* — transient/timeout failures that survived
    the pool's own in-cell failover.

  FATAL answers never spill (the server answered; another cell cannot
  help), and sequences never silently cross cells (below).

- **Sequence / stream cell pinning** — a sequence establishes on one
  cell and stays there (server-side sequence state is cell-local); the
  pin may move only while no request of the sequence has landed. An
  in-flight death (or a dead established cell) raises the original
  error and emits a typed :class:`CellSequenceAbandoned` — NEVER a
  silent cross-cell re-send, mirroring the pool's endpoint semantics.
  ``generate_stream`` sessions pin to the cell that produced their
  first event; only a stream that died before delivering anything may
  fail over to the next cell.

- **Shadow mirroring** — ``shadow=ShadowPolicy(cell=..., ratio=...)``
  duplicates a sampled fraction of successful unary infers to a shadow
  cell *off the caller's path*: the mirror runs on a bounded background
  executor AFTER the primary response settles, its response is compared
  bit-for-bit against the primary (the shard-gather exactness rule) and
  only COUNTED (``matched``/``diverged``/``error``) — never returned,
  never billed to the caller's latency, and never to the caller's
  admission token (the mirror rides the shadow cell's own pool).

- **Canary** — ``canary=CanaryPolicy(cell=..., weight=..., slo=...)``
  routes a weighted split of eligible traffic to a canary cell, feeds
  every canary outcome into an :class:`~client_tpu_torch.observe.SLO`
  burn-rate window, and on burn (breached after ``min_events``) ramps
  the weight to ZERO and emits a typed :class:`CanaryRolledBack` —
  automatically, with zero user-visible errors attributable to the
  rollback: a failing canary attempt falls back to the serve plan under
  the same budget instead of raising.

Observability: spills, shadow verdicts and canary transitions export as
``client_tpu_federation_*`` counters plus per-cell gauges
(``Telemetry.attach_federation``), typed events reach ``on_event``,
and the flight recorder gains ``federation``-layer ``route`` /
``cell_spill`` / ``spill_engaged`` / ``canary_route`` /
``canary_rollback`` / ``shadow_mirror`` timeline events. The doctor's
``--cells`` snapshot adds per-cell health and the ``cell_down`` /
``spillover_active`` / ``canary_burning`` anomaly flags. See
docs/federation.md.
"""

from __future__ import annotations

import copy
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import flight as _flight
from ._base import fold_infer_args
from .admission import AdmissionRejected, is_spill_signal
from .pool import AioPoolClient, NoEndpointAvailableError, PoolClient
from .resilience import (
    CONNECT,
    FATAL,
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
from .utils import InferenceServerException

__all__ = [
    "AioFederatedClient",
    "CanaryPolicy",
    "CanaryRolledBack",
    "CellSequenceAbandoned",
    "CellSpill",
    "CellState",
    "FederatedClient",
    "FederationEvent",
    "NoCellAvailableError",
    "ShadowDiverged",
    "ShadowPolicy",
    "SPILL_DOWN",
    "SPILL_ERROR",
    "SPILL_SATURATED",
    "parse_cells_spec",
]

# spill reasons (the {reason} label on client_tpu_federation_spill_total)
SPILL_SATURATED = "saturated"   # home shed it (admission pressure)
SPILL_DOWN = "down"             # cell breaker open / no endpoint / connect
SPILL_ERROR = "error"           # transient/timeout survived in-cell failover

# cell roles
ROLE_SERVE = "serve"
ROLE_SHADOW = "shadow"
ROLE_CANARY = "canary"


class NoCellAvailableError(InferenceServerException):
    """Every serving cell is breaker-open / down / saturated."""

    def __init__(self, msg: str = "no cell available in the federation"):
        super().__init__(msg, status="FEDERATION_EXHAUSTED")


def parse_cells_spec(spec: str) -> Dict[str, List[str]]:
    """``"a=h1:8000+h2:8000;b=h3:8000"`` -> ``{"a": [...], "b": [...]}``.

    Cells are ``;``-separated ``name=url+url`` groups (``+`` joins a
    cell's replica urls); declaration order is the spill preference
    order, first cell = default home."""
    cells: Dict[str, List[str]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, eq, urls = part.partition("=")
        name = name.strip()
        if not eq or not name:
            raise ValueError(
                f"malformed cell spec {part!r} (want name=url+url)")
        if name in cells:
            raise ValueError(f"duplicate cell name {name!r}")
        url_list = [u.strip() for u in urls.split("+") if u.strip()]
        if not url_list:
            raise ValueError(f"cell {name!r} declares no urls")
        cells[name] = url_list
    if not cells:
        raise ValueError("cells spec declares no cells")
    return cells


# -- typed federation events --------------------------------------------------
class FederationEvent:
    """Base for events delivered to the federation's ``on_event``."""

    __slots__ = ("cell",)

    def __init__(self, cell: str):
        self.cell = cell

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{name}={getattr(self, name)!r}"
            for cls in type(self).__mro__
            for name in getattr(cls, "__slots__", ()))
        return f"{type(self).__name__}({fields})"


class CellSpill(FederationEvent):
    """A request the home cell could not serve landed on ``target``.
    ``cell`` is the home (preferred) cell, ``reason`` one of the
    ``SPILL_*`` constants."""

    __slots__ = ("target", "reason")

    def __init__(self, cell: str, target: str, reason: str):
        super().__init__(cell)
        self.target = target
        self.reason = reason


class CellSequenceAbandoned(FederationEvent):
    """A sequence pinned to ``cell`` died in flight (or its cell died):
    the federation did NOT re-send it to another cell — cell-local
    sequence state cannot move. The application owns re-driving the
    sequence; the original error still raises."""

    __slots__ = ("request_id", "sequence_id", "cause")

    def __init__(self, cell: str, request_id: str, sequence_id: int,
                 cause: BaseException):
        super().__init__(cell)
        self.request_id = request_id
        self.sequence_id = sequence_id
        self.cause = cause


class ShadowDiverged(FederationEvent):
    """A mirrored request's shadow response did not match the primary
    bit-for-bit. ``output`` names the first mismatching tensor,
    ``detail`` the mismatch class (dtype/shape/values/missing)."""

    __slots__ = ("model", "output", "detail")

    def __init__(self, cell: str, model: str, output: str, detail: str):
        super().__init__(cell)
        self.model = model
        self.output = output
        self.detail = detail


class CanaryRolledBack(FederationEvent):
    """The canary cell's SLO burned: its traffic weight was ramped to
    zero. ``burn_rate`` is the windowed burn at rollback, ``events`` how
    many canary outcomes fed the verdict, ``weight`` the weight that was
    active when the burn tripped."""

    __slots__ = ("burn_rate", "events", "weight")

    def __init__(self, cell: str, burn_rate: float, events: int,
                 weight: float):
        super().__init__(cell)
        self.burn_rate = burn_rate
        self.events = events
        self.weight = weight


# -- rollout policies ---------------------------------------------------------
class ShadowPolicy:
    """Mirror a sampled fraction of successful unary infers to ``cell``.

    ``ratio`` is the sampled fraction (1.0 mirrors everything);
    ``compare`` turns on the bit-for-bit response comparison (off =
    fire-and-count only); ``max_pending`` bounds concurrently in-flight
    mirrors — past it mirrors are SKIPPED (counted), never queued: the
    shadow cell's slowness must not build an unbounded backlog in the
    serving process. ``timeout_s`` bounds each mirror call."""

    def __init__(self, cell: str, ratio: float = 0.01, compare: bool = True,
                 max_pending: int = 8, timeout_s: float = 10.0,
                 rng: Optional[random.Random] = None):
        if not 0.0 < ratio <= 1.0:
            raise ValueError("shadow ratio must be in (0, 1]")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.cell = cell
        self.ratio = float(ratio)
        self.compare = compare
        self.max_pending = int(max_pending)
        self.timeout_s = timeout_s
        self.rng = rng


class CanaryPolicy:
    """Route ``weight`` of eligible traffic to ``cell`` under an SLO
    burn watcher.

    ``slo`` is a latency spec string (``"p95<100ms"`` — ``request_ms``
    metrics only: the canary verdict is caller-visible latency/errors)
    or a prebuilt :class:`~client_tpu_torch.observe.SLO`. Every canary outcome
    feeds it (an error always counts bad); once at least ``min_events``
    outcomes are in and the windowed burn rate exceeds 1.0, the weight
    ramps to ZERO and a typed :class:`CanaryRolledBack` fires — the
    in-flight and subsequent requests serve from the normal plan, so
    the rollback itself causes no user-visible errors. ``window_s``
    bounds the burn window when ``slo`` is a spec string."""

    def __init__(self, cell: str, weight: float = 0.05,
                 slo: Any = "p95<250ms", min_events: int = 20,
                 window_s: float = 60.0,
                 rng: Optional[random.Random] = None):
        if not 0.0 <= weight <= 1.0:
            raise ValueError("canary weight must be in [0, 1]")
        if min_events < 1:
            raise ValueError("min_events must be >= 1")
        self.cell = cell
        self.weight = float(weight)
        self.slo = slo
        self.min_events = int(min_events)
        self.window_s = float(window_s)
        self.rng = rng

    def build_slo(self):
        """Resolve ``slo`` into a live :class:`~client_tpu_torch.observe.SLO`."""
        from .observe import SLO, parse_slo_spec

        if isinstance(self.slo, SLO):
            return self.slo
        spec = parse_slo_spec(str(self.slo))
        if spec.kind != "latency" or spec.metric != "request_ms":
            raise ValueError(
                f"canary slo must be a request-latency objective "
                f"(e.g. 'p95<100ms'), got {self.slo!r}")
        return SLO(f"canary:{self.cell}", "request_ms", spec.threshold_ms,
                   spec.objective, window_s=self.window_s)


class CellState:
    """One named cell: its pool client, cell breaker and spill state.

    Counter mutations happen under the owning federation's lock; the
    shed-rate hysteresis window lives here too (a deque of recent
    home-attempt outcomes, True = shed)."""

    __slots__ = (
        "name", "pool", "role", "breaker", "owns_pool", "served_total",
        "spill_out", "spill_in", "shed_window", "spill_active",
        "sequence_abandoned_total",
    )

    def __init__(self, name: str, pool: Any, role: str = ROLE_SERVE,
                 breaker: Optional[CircuitBreaker] = None,
                 owns_pool: bool = False, shed_window: int = 64):
        self.name = name
        self.pool = pool
        self.role = role
        self.breaker = breaker
        self.owns_pool = owns_pool
        self.served_total = 0
        self.spill_out: Dict[str, int] = {}
        self.spill_in = 0
        self.shed_window: deque = deque(maxlen=shed_window)
        self.spill_active = False
        self.sequence_abandoned_total = 0

    def breaker_admits(self) -> bool:
        return self.breaker is None or self.breaker.would_admit()

    def quarantine_dominated(self) -> bool:
        """More than half this cell's replicas are quarantined for
        contract-violating (byzantine) responses — the plan treats the
        cell as down: a majority of demonstrably-lying replicas is worse
        than a dead cell, and spillover is strictly safer."""
        check = getattr(getattr(self.pool, "pool", None),
                        "quarantine_dominated", None)
        return bool(check()) if check is not None else False

    def record_transport(self, ok: bool) -> None:
        """Feed one fed-level transport outcome into the cell breaker
        (sheds and FATAL answers are NOT transport outcomes)."""
        if self.breaker is not None:
            self.breaker.record(ok)

    def shed_rate(self) -> Optional[float]:
        if not self.shed_window:
            return None
        return sum(self.shed_window) / len(self.shed_window)


def _output_names(result) -> List[str]:
    """Output tensor names of an InferResult (http dict response or the
    grpc codec's decoded message)."""
    try:
        resp = result.get_response()
    except Exception:
        return []
    outputs = (resp.get("outputs", []) if isinstance(resp, dict)
               else getattr(resp, "outputs", []) or [])
    names = []
    for out in outputs:
        name = (out.get("name") if isinstance(out, dict)
                else getattr(out, "name", None))
        if name:
            names.append(name)
    return names


def _compare_results(primary, shadow) -> Optional[Tuple[str, str]]:
    """Shard-style exactness compare: every primary output must exist on
    the shadow with the same dtype, shape and BYTES (bit-for-bit — float
    ``==`` would pass NaN-free near-misses and fail legal NaNs). Returns
    ``None`` on match, else ``(output_name, mismatch_detail)``."""
    names = _output_names(primary)
    if not names:
        return None
    for name in names:
        a = primary.as_numpy(name)
        b = shadow.as_numpy(name)
        if a is None or b is None:
            if (a is None) != (b is None):
                return name, "missing"
            continue
        a = np.asarray(a)
        b = np.asarray(b)
        if a.dtype != b.dtype:
            return name, f"dtype {a.dtype} != {b.dtype}"
        if a.shape != b.shape:
            return name, f"shape {a.shape} != {b.shape}"
        if a.tobytes() != b.tobytes():
            return name, "values"
    return None


class _FederatedBase:
    """Construction + routing/rollout state shared by sync and aio."""

    _AIO = False

    def __init__(
        self,
        cells: Dict[str, Any],
        home: Optional[str] = None,
        preference: Optional[Sequence[str]] = None,
        protocol: str = "http",
        telemetry=None,
        shadow: Optional[ShadowPolicy] = None,
        canary: Optional[CanaryPolicy] = None,
        cell_breaker_factory: Optional[
            Callable[[], Optional[CircuitBreaker]]] = None,
        spill_shed_hi: float = 0.5,
        spill_shed_lo: float = 0.1,
        spill_min_samples: int = 8,
        spill_probe_ratio: float = 0.1,
        shed_window: int = 64,
        default_deadline_s: Optional[float] = None,
        per_attempt_timeout_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
        on_event: Optional[Callable[[FederationEvent], None]] = None,
        pool_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """``cells``: ordered ``{name: PoolClient | [urls]}`` — url lists
        are built into pool clients of the matching flavor (``protocol``
        + ``pool_kwargs`` forwarded, ``telemetry`` shared across every
        cell). ``home`` names the locality-preferred cell (default: the
        first); ``preference`` orders the spill targets (default:
        declaration order). Cells named by ``shadow``/``canary`` leave
        the serve plan: a shadow cell receives only mirrors, a canary
        cell only its weighted split (a down canary must never be a
        spill target — it is the unproven version).

        ``spill_shed_hi``/``spill_shed_lo``: the shed-rate hysteresis
        band over the last ``shed_window`` home attempts (judged once
        ``spill_min_samples`` are in) — engage spill-active at/above
        ``hi``, release at/below ``lo``. While spill-active,
        ``spill_probe_ratio`` of requests still try the home cell first:
        those probes are the only thing that can refresh the shed window
        and RELEASE the hysteresis, so traffic returns home once the
        pressure genuinely clears (0 would latch spill-active forever).

        ``default_deadline_s``/``per_attempt_timeout_s``: the shared
        cross-cell attempt budget (the caller's explicit
        ``client_timeout`` wins)."""
        if not cells:
            raise ValueError("federation needs at least one cell")
        if not 0.0 < spill_shed_lo <= spill_shed_hi <= 1.0:
            raise ValueError(
                "need 0 < spill_shed_lo <= spill_shed_hi <= 1")
        if not 0.0 < spill_probe_ratio <= 1.0:
            raise ValueError(
                "spill_probe_ratio must be in (0, 1]: without home "
                "probes, an engaged spill could never release")
        self.spill_probe_ratio = float(spill_probe_ratio)
        self._shed_window_size = max(2, int(shed_window))
        if cell_breaker_factory is None:
            cell_breaker_factory = CircuitBreaker
        self._telemetry = telemetry
        self._rng = rng or random.Random()
        self._on_event = on_event
        self._lock = threading.Lock()
        self.spill_shed_hi = float(spill_shed_hi)
        self.spill_shed_lo = float(spill_shed_lo)
        self.spill_min_samples = max(1, int(spill_min_samples))
        roles: Dict[str, str] = {}
        if shadow is not None:
            if shadow.cell not in cells:
                raise ValueError(
                    f"shadow cell {shadow.cell!r} is not a declared cell")
            roles[shadow.cell] = ROLE_SHADOW
        if canary is not None:
            if canary.cell not in cells:
                raise ValueError(
                    f"canary cell {canary.cell!r} is not a declared cell")
            if roles.get(canary.cell) == ROLE_SHADOW:
                raise ValueError(
                    "one cell cannot be both shadow and canary")
            roles[canary.cell] = ROLE_CANARY
        built: List[CellState] = []
        self.cells: Dict[str, CellState] = {}
        try:
            for name, value in cells.items():
                role = roles.get(name, ROLE_SERVE)
                if isinstance(value, (list, tuple)):
                    pool = self._build_pool(list(value), protocol,
                                            pool_kwargs or {})
                    owns = True
                else:
                    pool = value
                    owns = False
                state = CellState(name, pool, role=role,
                                  breaker=cell_breaker_factory(),
                                  owns_pool=owns,
                                  shed_window=self._shed_window_size)
                built.append(state)
                self.cells[name] = state
                if telemetry is not None and state.breaker is not None:
                    state.breaker.on_transition = \
                        telemetry.on_breaker_transition
        except Exception:
            self._abandon(built)
            raise
        serve_names = [s.name for s in self.cells.values()
                       if s.role == ROLE_SERVE]
        if not serve_names:
            self._abandon(built)
            raise ValueError(
                "federation needs at least one serving cell (every "
                "declared cell is shadow/canary)")
        self.home = home if home is not None else serve_names[0]
        if self.home not in self.cells:
            self._abandon(built)
            raise ValueError(f"unknown home cell {self.home!r}")
        if self.cells[self.home].role != ROLE_SERVE:
            self._abandon(built)
            raise ValueError(
                f"home cell {self.home!r} must be a serving cell "
                f"(it is {self.cells[self.home].role})")
        if preference is None:
            preference = serve_names
        preference = list(preference)
        unknown = [n for n in preference if n not in self.cells]
        if unknown:
            self._abandon(built)
            raise ValueError(f"unknown cells in preference: {unknown}")
        nonserve = [n for n in preference
                    if self.cells[n].role != ROLE_SERVE]
        if nonserve:
            self._abandon(built)
            raise ValueError(
                f"shadow/canary cells cannot be spill targets: {nonserve}")
        # the serve plan: home first, then the caller's preference order
        self._serve_order: List[CellState] = [self.cells[self.home]] + [
            self.cells[n] for n in preference if n != self.home]
        if default_deadline_s is not None or per_attempt_timeout_s is not None:
            self._budget_policy: Optional[ResiliencePolicy] = \
                ResiliencePolicy(retry=RetryPolicy(
                    max_attempts=1,
                    total_deadline_s=default_deadline_s,
                    per_attempt_timeout_s=per_attempt_timeout_s))
        else:
            self._budget_policy = None
        # -- sequence cell pinning -------------------------------------------
        self._seq_cells: Dict[int, CellState] = {}
        self._seq_established: set = set()
        # -- shadow -----------------------------------------------------------
        self._shadow = shadow
        self._shadow_pending = 0
        self._shadow_stats = {"sent": 0, "matched": 0, "diverged": 0,
                              "errors": 0, "skipped": 0, "uncompared": 0}
        # -- canary -----------------------------------------------------------
        self._canary = canary
        self._canary_slo = canary.build_slo() if canary is not None else None
        self._canary_weight = canary.weight if canary is not None else 0.0
        self._canary_rolled_back = False
        self._canary_stats = {"routed": 0, "ok": 0, "bad": 0,
                              "fallbacks": 0, "rollbacks": 0}
        self._closed = False
        if telemetry is not None and hasattr(telemetry, "attach_federation"):
            telemetry.attach_federation(self)

    # -- construction helpers -------------------------------------------------
    def _build_pool(self, urls: List[str], protocol: str,
                    pool_kwargs: Dict[str, Any]):
        cls = AioPoolClient if self._AIO else PoolClient
        kwargs = dict(pool_kwargs)
        kwargs.setdefault("protocol", protocol)
        if self._telemetry is not None:
            kwargs.setdefault("telemetry", self._telemetry)
        return cls(urls, **kwargs)

    @staticmethod
    def _abandon(states: List[CellState]) -> None:
        for state in states:
            if not state.owns_pool:
                continue
            try:
                result = state.pool.close()
                if hasattr(result, "close"):  # unawaited coroutine
                    result.close()
            except Exception:
                pass

    # -- events / telemetry ----------------------------------------------------
    def emit(self, event: FederationEvent) -> None:
        if self._on_event is None:
            return
        try:
            self._on_event(event)
        except Exception:
            pass  # an observer must never break the data path

    def _tel_spill(self, home: str, target: str, reason: str) -> None:
        tel = self._telemetry
        if tel is not None and hasattr(tel, "on_cell_spill"):
            try:
                tel.on_cell_spill(home, target, reason)
            except Exception:
                pass

    def _tel_shadow(self, outcome: str) -> None:
        tel = self._telemetry
        if tel is not None and hasattr(tel, "on_shadow_result"):
            try:
                tel.on_shadow_result(outcome)
            except Exception:
                pass

    def _tel_canary(self, outcome: str) -> None:
        tel = self._telemetry
        if tel is not None and hasattr(tel, "on_canary"):
            try:
                tel.on_canary(outcome)
            except Exception:
                pass

    # -- spill hysteresis ------------------------------------------------------
    def _note_home_outcome(self, cell: CellState, shed: bool) -> None:
        """Feed one home-cell attempt outcome (shed or served) into the
        cell's shed-rate window and flip the hysteresis state. Emits the
        engage/release transitions onto the flight timeline."""
        with self._lock:
            cell.shed_window.append(shed)
            if len(cell.shed_window) < self.spill_min_samples:
                return
            rate = sum(cell.shed_window) / len(cell.shed_window)
            was = cell.spill_active
            if not was and rate >= self.spill_shed_hi:
                cell.spill_active = True
            elif was and rate <= self.spill_shed_lo:
                cell.spill_active = False
            changed = cell.spill_active != was
            active = cell.spill_active
        if changed:
            _flight.note("federation",
                         "spill_engaged" if active else "spill_released",
                         cell=cell.name, shed_rate=round(rate, 3))

    def _count_spill(self, home: CellState, target: CellState,
                     reason: str) -> None:
        with self._lock:
            home.spill_out[reason] = home.spill_out.get(reason, 0) + 1
            target.spill_in += 1
        _flight.note("federation", "cell_spill", cell=home.name,
                     target=target.name, reason=reason)
        self._tel_spill(home.name, target.name, reason)
        self.emit(CellSpill(home.name, target.name, reason))

    # -- routing plan ----------------------------------------------------------
    @staticmethod
    def _preempt_reason(plan: List[CellState],
                        home: CellState) -> Optional[str]:
        """Why a request that never even TRIES the home cell counts as a
        spill when it lands elsewhere: the home's open breaker filtered
        it from the plan (down), or the shed-rate hysteresis moved it to
        the back (saturated). None = home is first, no preemption."""
        if not plan or plan[0] is home:
            return None
        if home not in plan:
            return SPILL_DOWN
        return SPILL_SATURATED

    def _plan(self) -> List[CellState]:
        """The serve-order candidate cells for one request: home first —
        moved LAST while its shed-rate hysteresis is engaged (still a
        last resort: saturated beats unavailable) — skipping cells whose
        breaker would fast-fail without touching a socket. When every
        cell's breaker is open, the unfiltered order is returned
        (degraded beats self-blinded; each breaker's half-open window
        decides what actually goes through)."""
        order = list(self._serve_order)
        with self._lock:
            if order and order[0].spill_active and len(order) > 1:
                # probe fraction: a sampled slice of traffic keeps trying
                # home first while spill-active — the only feed that can
                # refresh the shed window and release the hysteresis
                if self._rng.random() >= self.spill_probe_ratio:
                    order = order[1:] + order[:1]
        admitted = [c for c in order
                    if c.breaker_admits() and not c.quarantine_dominated()]
        return admitted or order

    # -- sequence pinning helpers ---------------------------------------------
    def _seq_cell(self, sequence_id: int,
                  exclude: Sequence[CellState] = ()) -> CellState:
        with self._lock:
            cell = self._seq_cells.get(sequence_id)
        if cell is not None:
            return cell
        excluded = set(map(id, exclude))
        for candidate in self._plan():
            if id(candidate) not in excluded:
                with self._lock:
                    return self._seq_cells.setdefault(
                        sequence_id, candidate)
        raise NoCellAvailableError()

    def _seq_repin_allowed(self, sequence_id: int) -> bool:
        with self._lock:
            return sequence_id not in self._seq_established

    def _seq_mark_established(self, sequence_id: int) -> None:
        with self._lock:
            self._seq_established.add(sequence_id)

    def _seq_unpin(self, sequence_id: int) -> None:
        with self._lock:
            self._seq_cells.pop(sequence_id, None)
            self._seq_established.discard(sequence_id)

    def _seq_abandon(self, cell: CellState, request_id: str,
                     sequence_id: int, exc: BaseException) -> None:
        with self._lock:
            cell.sequence_abandoned_total += 1
        _flight.note("federation", "sequence_abandoned", cell=cell.name,
                     sequence_id=sequence_id)
        self.emit(CellSequenceAbandoned(cell.name, request_id,
                                        sequence_id, exc))
        self._seq_unpin(sequence_id)

    # -- canary state ----------------------------------------------------------
    def _canary_draw(self, kwargs) -> Optional[CellState]:
        """The canary cell when this request drew the canary split (and
        the canary is armed, not rolled back, and the request eligible —
        unary, non-sequence)."""
        canary = self._canary
        if canary is None or kwargs.get("sequence_id"):
            return None
        with self._lock:
            weight = self._canary_weight
        if weight <= 0.0:
            return None
        rng = canary.rng or self._rng
        if rng.random() >= weight:
            return None
        cell = self.cells[canary.cell]
        if not cell.breaker_admits():
            return None
        return cell

    def _canary_feed(self, latency_s: Optional[float], ok: bool) -> None:
        """Feed one canary outcome into the burn watcher; trips the
        rollback at most once."""
        slo = self._canary_slo
        if slo is None:
            return
        rollback: Optional[CanaryRolledBack] = None
        with self._lock:
            if ok and latency_s is not None:
                slo.observe(latency_s * 1e3)
                self._canary_stats["ok"] += 1
            else:
                slo.observe_failure()
                self._canary_stats["bad"] += 1
            events = self._canary_stats["ok"] + self._canary_stats["bad"]
            if (not self._canary_rolled_back
                    and events >= self._canary.min_events
                    and slo.breached()):
                weight = self._canary_weight
                self._canary_weight = 0.0
                self._canary_rolled_back = True
                self._canary_stats["rollbacks"] += 1
                rollback = CanaryRolledBack(
                    self._canary.cell, round(slo.burn_rate(), 4),
                    events, weight)
        if rollback is not None:
            _flight.note("federation", "canary_rollback",
                         cell=rollback.cell, burn_rate=rollback.burn_rate,
                         events=rollback.events)
            self._tel_canary("rollback")
            self.emit(rollback)

    def canary_arm(self, weight: Optional[float] = None) -> None:
        """Re-arm a rolled-back canary (a NEW rollout decision — never
        automatic). Default weight: the policy's declared weight."""
        if self._canary is None:
            raise InferenceServerException(
                "no canary policy configured", status="FEDERATION_CANARY")
        with self._lock:
            self._canary_weight = (self._canary.weight if weight is None
                                   else float(weight))
            self._canary_rolled_back = False

    def canary_status(self) -> Optional[Dict[str, Any]]:
        if self._canary is None:
            return None
        with self._lock:
            stats = dict(self._canary_stats)
            weight = self._canary_weight
            rolled_back = self._canary_rolled_back
        slo = self._canary_slo
        return {
            "cell": self._canary.cell,
            "weight": weight,
            "declared_weight": self._canary.weight,
            "rolled_back": rolled_back,
            "min_events": self._canary.min_events,
            "slo": slo.name if slo is not None else None,
            "threshold_ms": slo.threshold_ms if slo is not None else None,
            "objective": slo.objective if slo is not None else None,
            "burn_rate": round(slo.burn_rate(), 4) if slo is not None
            else None,
            "breached": slo.breached() if slo is not None else False,
            **stats,
        }

    def shadow_status(self) -> Optional[Dict[str, Any]]:
        if self._shadow is None:
            return None
        with self._lock:
            stats = dict(self._shadow_stats)
            pending = self._shadow_pending
        return {
            "cell": self._shadow.cell,
            "ratio": self._shadow.ratio,
            "compare": self._shadow.compare,
            "pending": pending,
            **stats,
        }

    # -- shared shadow accounting ---------------------------------------------
    def _shadow_should_mirror(self, kwargs) -> bool:
        sp = self._shadow
        if sp is None or kwargs.get("sequence_id"):
            return False
        rng = sp.rng or self._rng
        if rng.random() >= sp.ratio:
            return False
        with self._lock:
            if self._shadow_pending >= sp.max_pending:
                self._shadow_stats["skipped"] += 1
                skipped = True
            else:
                self._shadow_pending += 1
                skipped = False
        if skipped:
            self._tel_shadow("skipped")
            return False
        return True

    @staticmethod
    def _shadow_kwargs(kwargs, timeout_s: float) -> Dict[str, Any]:
        kw = {k: v for k, v in kwargs.items()
              if k not in ("client_timeout", "request_id")}
        kw["client_timeout"] = timeout_s
        return kw

    def _shadow_settle(self, model: str, primary, shadow_result,
                       error: Optional[BaseException]) -> None:
        """Compare + count one finished mirror (runs OFF the caller's
        path). A divergence is retained on its own flight timeline when
        a recorder is armed — the per-request evidence the aggregate
        counter cannot carry."""
        sp = self._shadow
        outcome = "matched"
        mismatch: Optional[Tuple[str, str]] = None
        if error is not None:
            outcome = "error"
        elif sp.compare:
            mismatch = _compare_results(primary, shadow_result)
            if mismatch is not None:
                outcome = "diverged"
        else:
            # compare=False mirrors are fire-and-count only: reporting
            # them as "matched" would claim a bit-identical shadow that
            # was never checked
            outcome = "uncompared"
        with self._lock:
            self._shadow_pending = max(0, self._shadow_pending - 1)
            self._shadow_stats["sent"] += 1
            key = {"matched": "matched", "uncompared": "uncompared",
                   "diverged": "diverged", "error": "errors"}[outcome]
            self._shadow_stats[key] += 1
        self._tel_shadow(outcome)
        if mismatch is not None:
            output, detail = mismatch
            recorder = getattr(self._telemetry, "flight", None) \
                if self._telemetry is not None else None
            if recorder is not None:
                scratch = recorder.begin("federation", model, "shadow")
                if scratch is not None:
                    _flight.note("federation", "shadow_diverged",
                                 cell=sp.cell, output=output, detail=detail)
                    recorder.commit(scratch, error=InferenceServerException(
                        f"shadow diverged on {output!r}: {detail}",
                        status="SHADOW_DIVERGED"))
            self.emit(ShadowDiverged(sp.cell, model, output, detail))

    # -- introspection ---------------------------------------------------------
    def telemetry(self):
        return self._telemetry

    def cell_names(self) -> List[str]:
        return list(self.cells)

    def serve_order(self) -> List[str]:
        """The live serve plan (spill-hysteresis applied) by cell name."""
        return [c.name for c in self._plan()]

    def federation_stats(self) -> Dict[str, Any]:
        """One JSON-ready snapshot: per-cell role/breaker/spill state and
        the pool's aggregated health, plus the shadow and canary views —
        the doctor's ``cells`` section and the bench artifact's evidence
        row both read exactly this."""
        rows: Dict[str, Any] = {}
        with self._lock:
            snap = {
                name: {
                    "role": cell.role,
                    "home": name == self.home,
                    "breaker_state": (cell.breaker.state
                                      if cell.breaker is not None else None),
                    "spill_active": cell.spill_active,
                    "shed_rate": (round(cell.shed_rate(), 4)
                                  if cell.shed_window else None),
                    "served": cell.served_total,
                    "spill_out": dict(cell.spill_out),
                    "spill_in": cell.spill_in,
                    "sequence_abandoned": cell.sequence_abandoned_total,
                }
                for name, cell in self.cells.items()
            }
        for name, row in snap.items():
            health = getattr(self.cells[name].pool, "health_summary", None)
            if health is not None:
                try:
                    row["pool"] = health()
                except Exception:
                    row["pool"] = None
            rows[name] = row
        return {
            "home": self.home,
            "order": [c.name for c in self._serve_order],
            "cells": rows,
            "shadow": self.shadow_status(),
            "canary": self.canary_status(),
        }

    def spill_total(self) -> int:
        with self._lock:
            return sum(n for cell in self.cells.values()
                       for n in cell.spill_out.values())

    def watch_gauges(self) -> Dict[str, Any]:
        """The watchtower's gauge-source contract: how many cells are
        down (breaker open) and their NAMES, plus whether spillover is
        carrying traffic right now."""
        down: List[str] = []
        spill_active = 0
        with self._lock:
            names = list(self.cells)
            for name, cell in self.cells.items():
                if cell.breaker is not None and cell.breaker.state == "open":
                    down.append(name)
                if cell.spill_active:
                    spill_active += 1
        return {
            "cells": len(names),
            "cells_down": len(down),
            "down_cells": sorted(down),
            "spill_active": spill_active,
        }

    # -- surface plumbing ------------------------------------------------------
    def configure_resilience(self, policy):
        raise InferenceServerException(
            "FederatedClient owns per-cell breakers and each cell pool "
            "owns its endpoints' resilience; configure the cells instead")

    def configure_telemetry(self, telemetry):
        raise InferenceServerException(
            "FederatedClient wires telemetry through every cell at "
            "construction; pass telemetry= to the constructor instead")

    # state mutators reach EVERY cell (shadow/canary included: a model or
    # shm registration must exist wherever any traffic can land)
    _BROADCAST_PREFIXES = (
        "register_", "unregister_", "load_model", "unload_model", "update_",
    )

    @classmethod
    def _is_broadcast(cls, name: str) -> bool:
        return any(name.startswith(p) for p in cls._BROADCAST_PREFIXES)


class FederatedClient(_FederatedBase):
    """Synchronous federation over sync pool clients (HTTP or GRPC)."""

    _AIO = False

    def __init__(self, cells, **kwargs):
        super().__init__(cells, **kwargs)
        self._shadow_executor: Optional[ThreadPoolExecutor] = None
        self._shadow_executor_lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._shadow_executor_lock:
            if self._shadow_executor is not None:
                self._shadow_executor.shutdown(wait=True)
                self._shadow_executor = None
        for cell in self.cells.values():
            if cell.owns_pool:
                try:
                    cell.pool.close()
                except Exception:
                    pass

    def __enter__(self) -> "FederatedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wait_healthy(self, min_healthy: Optional[int] = None,
                     timeout_s: float = 10.0) -> bool:
        """Direct-probe every SERVING cell's pool (see
        ``PoolClient.wait_healthy``); True when every one reached its
        target. Shadow/canary cells are probed too but never fail the
        wait — an absent rollout target must not block serving."""
        ok = True
        for cell in self.cells.values():
            wait = getattr(cell.pool, "wait_healthy", None)
            if wait is None:
                continue
            healthy = wait(min_healthy=min_healthy, timeout_s=timeout_s)
            if cell.role == ROLE_SERVE:
                ok = ok and healthy
        return ok

    # -- inference -------------------------------------------------------------
    def infer(self, model_name: str, inputs, *args, **kwargs):
        """Federated ``infer``: canary split first (when drawn), then the
        locality-first serve plan under one shared attempt budget, with
        the home cell's saturation/availability driving transparent
        spillover. Sequences pin to a cell (below); successful unary
        responses may be shadow-mirrored off-path."""
        kwargs = fold_infer_args(args, kwargs)
        scratch = _flight.layer_begin(self._telemetry, "federation",
                                      model_name)
        if scratch is None:
            return self._infer_fed(model_name, inputs, kwargs)
        try:
            result = self._infer_fed(model_name, inputs, kwargs)
        except BaseException as e:
            _flight.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight.layer_commit(self._telemetry, scratch)
        return result

    def _infer_fed(self, model_name: str, inputs, kwargs):
        if kwargs.get("sequence_id"):
            return self._sequence_infer(model_name, inputs, kwargs)
        budget = AttemptBudget(self._budget_policy,
                               kwargs.get("client_timeout"))
        canary_cell = self._canary_draw(kwargs)
        if canary_cell is not None:
            served, result = self._canary_attempt(
                canary_cell, model_name, inputs, kwargs, budget)
            if served:
                # canary-served responses are NEVER mirrored: comparing
                # the canary version's output against the shadow cell's
                # baseline version would report every legitimate version
                # difference as a divergence and drown the real signal
                return result
        result = self._serve(model_name, inputs, kwargs, budget)
        self._maybe_shadow(model_name, inputs, kwargs, result)
        return result

    def _canary_attempt(self, cell: CellState, model_name, inputs, kwargs,
                        budget) -> Tuple[bool, Any]:
        """One canary-cell attempt: outcome feeds the burn watcher; a
        failure FALLS BACK to the serve plan (returns (False, None)) so
        canary sickness — and the rollback it triggers — never surfaces
        as a user-visible error."""
        with self._lock:
            self._canary_stats["routed"] += 1
        self._tel_canary("routed")
        _flight.note("federation", "canary_route", cell=cell.name)
        try:
            remaining = budget.attempt_timeout_s()
        except InferenceServerException:
            return False, None  # let the serve plan raise the deadline
        t0 = time.monotonic()
        try:
            kw = dict(kwargs)
            if remaining is not None:
                kw["client_timeout"] = remaining
            result = cell.pool.infer(model_name, inputs, **kw)
        except Exception as e:
            domain = (SHED if isinstance(e, (AdmissionRejected,
                                             CircuitOpenError,
                                             NoEndpointAvailableError))
                      else classify_fault(e))
            if domain in (CONNECT, TRANSIENT, TIMEOUT):
                cell.record_transport(False)
            self._canary_feed(None, ok=False)
            with self._lock:
                self._canary_stats["fallbacks"] += 1
            self._tel_canary("fallback")
            _flight.note("federation", "canary_fallback", cell=cell.name,
                         domain=domain)
            return False, None
        cell.record_transport(True)
        with self._lock:
            cell.served_total += 1
        self._canary_feed(time.monotonic() - t0, ok=True)
        return True, result

    def _serve(self, model_name, inputs, kwargs, budget):
        """The locality-first spill loop over the serve plan."""
        plan = self._plan()
        home = self.cells[self.home]
        reason = self._preempt_reason(plan, home)
        last: Optional[BaseException] = None
        for cell in plan:
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            _flight.note("federation", "route", cell=cell.name)
            t0 = time.monotonic()
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = cell.pool.infer(model_name, inputs, **kw)
            except AdmissionRejected as e:
                # the cell shed it: a saturation signal, not a transport
                # outcome (never fed to the cell breaker). Only reasons
                # admission.SPILL_REASONS blesses may move traffic — a
                # future non-capacity rejection must not silently spill.
                if not is_spill_signal(e):
                    raise
                if cell is home:
                    self._note_home_outcome(home, shed=True)
                last, reason = e, SPILL_SATURATED
                _flight.note("federation", "cell_saturated", cell=cell.name,
                             reason=e.reason)
                continue
            except (CircuitOpenError, NoEndpointAvailableError) as e:
                # nothing in the cell can take traffic: count it against
                # the CELL breaker so a dead cell is skipped wholesale
                cell.record_transport(False)
                last, reason = e, SPILL_DOWN
                _flight.note("federation", "cell_down", cell=cell.name)
                continue
            except Exception as e:
                domain = classify_fault(e)
                if domain == FATAL:
                    # the server answered: spilling cannot improve a
                    # request the application already rejected
                    cell.record_transport(True)
                    raise
                if domain == SHED:
                    if cell is home:
                        self._note_home_outcome(home, shed=True)
                    last, reason = e, SPILL_SATURATED
                    continue
                cell.record_transport(False)
                last = e
                reason = SPILL_DOWN if domain == CONNECT else SPILL_ERROR
                _flight.note("federation", "cell_failed", cell=cell.name,
                             domain=domain)
                continue
            cell.record_transport(True)
            with self._lock:
                cell.served_total += 1
            if cell is home:
                self._note_home_outcome(home, shed=False)
            else:
                self._count_spill(home, cell, reason or SPILL_ERROR)
            return result
        if last is not None:
            raise last
        raise NoCellAvailableError()

    # -- sequences -------------------------------------------------------------
    def _sequence_infer(self, model_name, inputs, kwargs):
        """Cell-pinned sequence request: the pin may move only while the
        sequence has no established cell state (connect-class failures of
        a never-landed sequence). An in-flight death abandons the
        sequence with a typed :class:`CellSequenceAbandoned` and raises
        the original error — never a silent cross-cell re-send."""
        sequence_id = kwargs["sequence_id"]
        request_id = kwargs.get("request_id", "")
        budget = AttemptBudget(self._budget_policy,
                               kwargs.get("client_timeout"))
        tried: List[CellState] = []
        last: Optional[BaseException] = None
        for _ in range(len(self._serve_order)):
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            cell = self._seq_cell(sequence_id, exclude=tried)
            if cell not in tried:
                tried.append(cell)
            _flight.note("federation", "route", cell=cell.name,
                         sequence_id=sequence_id)
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = cell.pool.infer(model_name, inputs, **kw)
            except AdmissionRejected as e:
                if not is_spill_signal(e):
                    raise  # non-capacity rejections never move traffic
                last = e
                if cell is self.cells[self.home]:
                    self._note_home_outcome(cell, shed=True)
                if self._seq_repin_allowed(sequence_id):
                    # nothing landed yet: the pin (and the sequence) may
                    # start life in the next cell
                    self._seq_unpin(sequence_id)
                    continue
                raise  # established sequences force-admit below; honor it
            except (CircuitOpenError, NoEndpointAvailableError) as e:
                cell.record_transport(False)
                last = e
                if self._seq_repin_allowed(sequence_id):
                    self._seq_unpin(sequence_id)
                    continue
                raise  # one legal cell; nothing was sent — caller retries
            except Exception as e:
                domain = classify_fault(e)
                if domain in (FATAL, SHED):
                    raise
                cell.record_transport(False)
                last = e
                if domain == CONNECT and self._seq_repin_allowed(sequence_id):
                    self._seq_unpin(sequence_id)
                    continue
                # in-flight death (or an established cell's connect
                # failure after the pool burned its own pinned retries):
                # the cell-local sequence state is unknowable — abandon
                self._seq_abandon(cell, request_id, sequence_id, e)
                raise
            cell.record_transport(True)
            with self._lock:
                cell.served_total += 1
            if cell is self.cells[self.home]:
                # a home-served sequence step refreshes the shed window
                # too: a sequence-heavy workload must be able to RELEASE
                # an engaged spill, not latch it forever
                self._note_home_outcome(cell, shed=False)
            self._seq_mark_established(sequence_id)
            if kwargs.get("sequence_end"):
                self._seq_unpin(sequence_id)
            return result
        assert last is not None
        raise last

    # -- streaming -------------------------------------------------------------
    def generate_stream(self, model_name, *args, **kwargs):
        """Federated SSE generate stream: the session pins to the cell
        that produced its FIRST event; a cell that fails before
        delivering anything spills to the next (nothing was consumed, so
        the re-open is safe). After the first event, failures raise —
        generation state is cell-local."""
        plan = self._plan()
        home = self.cells[self.home]
        reason = self._preempt_reason(plan, home)

        def stream():
            last: Optional[BaseException] = None
            spill_reason = reason
            for cell in plan:
                _flight.note("federation", "route", cell=cell.name,
                             op="generate_stream")
                delivered = False
                try:
                    inner = cell.pool.generate_stream(
                        model_name, *args, **kwargs)
                    for item in inner:
                        if not delivered:
                            delivered = True
                            cell.record_transport(True)
                            with self._lock:
                                cell.served_total += 1
                            if cell is home:
                                self._note_home_outcome(home, shed=False)
                            else:
                                self._count_spill(
                                    home, cell,
                                    spill_reason or SPILL_ERROR)
                        yield item
                    return
                except AdmissionRejected as e:
                    if delivered:
                        raise
                    if cell is home:
                        self._note_home_outcome(home, shed=True)
                    last, spill_reason = e, SPILL_SATURATED
                    continue
                except (CircuitOpenError, NoEndpointAvailableError) as e:
                    if delivered:
                        raise
                    cell.record_transport(False)
                    last, spill_reason = e, SPILL_DOWN
                    continue
                except Exception as e:
                    domain = classify_fault(e)
                    if delivered or domain in (FATAL, SHED):
                        raise
                    cell.record_transport(False)
                    last = e
                    spill_reason = (SPILL_DOWN if domain == CONNECT
                                    else SPILL_ERROR)
                    continue
            if last is not None:
                raise last
            raise NoCellAvailableError()

        return stream()

    # -- shadow mirroring ------------------------------------------------------
    def _get_shadow_executor(self) -> ThreadPoolExecutor:
        with self._shadow_executor_lock:
            if self._closed:
                # a submit racing close() must fail HERE (handled below
                # as a skipped mirror), not recreate an executor that
                # nothing will ever shut down
                raise RuntimeError("federation closed")
            if self._shadow_executor is None:
                self._shadow_executor = ThreadPoolExecutor(
                    max_workers=max(2, self._shadow.max_pending),
                    thread_name_prefix="client_tpu_fed_shadow")
            return self._shadow_executor

    def _maybe_shadow(self, model_name, inputs, kwargs, primary) -> None:
        if self._closed or not self._shadow_should_mirror(kwargs):
            return
        sp = self._shadow
        _flight.note("federation", "shadow_mirror", cell=sp.cell)
        # shallow-copy each input: the caller may re-stage the originals
        # the moment this call returns, and the mirror serializes on its
        # own thread (raw-data bytes are immutable, so a shallow copy
        # pins this request's payload)
        try:
            snap = ([copy.copy(i) for i in inputs]
                    if isinstance(inputs, (list, tuple)) else inputs)
        except Exception:
            snap = inputs
        kw = self._shadow_kwargs(kwargs, sp.timeout_s)
        cell = self.cells[sp.cell]

        def mirror():
            error: Optional[BaseException] = None
            result = None
            try:
                result = cell.pool.infer(model_name, snap, **kw)
            except Exception as e:
                error = e
            self._shadow_settle(model_name, primary, result, error)

        try:
            self._get_shadow_executor().submit(mirror)
        except RuntimeError:
            # lost the race with close(): the caller's SUCCESSFUL infer
            # must never pay for a mirror that cannot run — release the
            # pending slot and count the mirror as skipped
            with self._lock:
                self._shadow_pending = max(0, self._shadow_pending - 1)
                self._shadow_stats["skipped"] += 1
            self._tel_shadow("skipped")

    def shadow_drain(self, timeout_s: float = 10.0) -> bool:
        """Block until no mirrors are pending (tests/bench teardown)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._shadow_pending == 0:
                    return True
            time.sleep(0.01)
        return False

    # -- generic surface delegation --------------------------------------------
    def _broadcast(self, name: str, args, kwargs):
        first_exc: Optional[BaseException] = None
        result = None
        for cell in self.cells.values():
            try:
                result = getattr(cell.pool, name)(*args, **kwargs)
            except Exception as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return result

    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("cells", "home"):
            # the construction-time guard: a lookup of cells/home on a
            # partially-built instance must fail, not recurse through
            # this delegation
            raise AttributeError(name)
        home_pool = self.cells[self.home].pool
        probe = getattr(home_pool, name, None)
        if not callable(probe):
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r}")

        if self._is_broadcast(name):
            def call(*args, **kwargs):
                return self._broadcast(name, args, kwargs)
        else:
            def call(*args, **kwargs):
                # read-only/admin calls are locality-first too: the home
                # pool's own failover covers its replicas; a down home
                # cell falls through the serve plan
                last: Optional[BaseException] = None
                for cell in self._plan():
                    try:
                        return getattr(cell.pool, name)(*args, **kwargs)
                    except (CircuitOpenError,
                            NoEndpointAvailableError) as e:
                        last = e
                        continue
                    except Exception as e:
                        if classify_fault(e) in (CONNECT, TRANSIENT,
                                                 TIMEOUT):
                            last = e
                            continue
                        raise
                if last is not None:
                    raise last
                raise NoCellAvailableError()

        call.__name__ = name
        return call


class AioFederatedClient(_FederatedBase):
    """Asyncio twin of :class:`FederatedClient` over aio pool clients.
    Shadow mirrors run as bounded asyncio tasks (truly cancelled at
    close)."""

    _AIO = True

    def __init__(self, cells, **kwargs):
        super().__init__(cells, **kwargs)
        self._shadow_tasks: set = set()

    # -- lifecycle -------------------------------------------------------------
    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for task in list(self._shadow_tasks):
            task.cancel()
        for task in list(self._shadow_tasks):
            try:
                await task
            except BaseException:
                pass
        self._shadow_tasks.clear()
        for cell in self.cells.values():
            if cell.owns_pool:
                try:
                    await cell.pool.close()
                except Exception:
                    pass

    async def __aenter__(self) -> "AioFederatedClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- inference -------------------------------------------------------------
    async def infer(self, model_name: str, inputs, *args, **kwargs):
        """Async federated ``infer`` (same routing/rollout contract as
        the sync twin)."""
        kwargs = fold_infer_args(args, kwargs)
        scratch = _flight.layer_begin(self._telemetry, "federation",
                                      model_name)
        if scratch is None:
            return await self._infer_fed(model_name, inputs, kwargs)
        try:
            result = await self._infer_fed(model_name, inputs, kwargs)
        except BaseException as e:
            _flight.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight.layer_commit(self._telemetry, scratch)
        return result

    async def _infer_fed(self, model_name: str, inputs, kwargs):
        if kwargs.get("sequence_id"):
            return await self._sequence_infer(model_name, inputs, kwargs)
        budget = AttemptBudget(self._budget_policy,
                               kwargs.get("client_timeout"))
        canary_cell = self._canary_draw(kwargs)
        if canary_cell is not None:
            served, result = await self._canary_attempt(
                canary_cell, model_name, inputs, kwargs, budget)
            if served:
                # never mirrored: see the sync twin (version differences
                # are not shadow divergences)
                return result
        result = await self._serve(model_name, inputs, kwargs, budget)
        self._maybe_shadow(model_name, inputs, kwargs, result)
        return result

    async def _canary_attempt(self, cell, model_name, inputs, kwargs,
                              budget) -> Tuple[bool, Any]:
        with self._lock:
            self._canary_stats["routed"] += 1
        self._tel_canary("routed")
        _flight.note("federation", "canary_route", cell=cell.name)
        try:
            remaining = budget.attempt_timeout_s()
        except InferenceServerException:
            return False, None
        t0 = time.monotonic()
        try:
            kw = dict(kwargs)
            if remaining is not None:
                kw["client_timeout"] = remaining
            result = await cell.pool.infer(model_name, inputs, **kw)
        except Exception as e:
            domain = (SHED if isinstance(e, (AdmissionRejected,
                                             CircuitOpenError,
                                             NoEndpointAvailableError))
                      else classify_fault(e))
            if domain in (CONNECT, TRANSIENT, TIMEOUT):
                cell.record_transport(False)
            self._canary_feed(None, ok=False)
            with self._lock:
                self._canary_stats["fallbacks"] += 1
            self._tel_canary("fallback")
            _flight.note("federation", "canary_fallback", cell=cell.name,
                         domain=domain)
            return False, None
        cell.record_transport(True)
        with self._lock:
            cell.served_total += 1
        self._canary_feed(time.monotonic() - t0, ok=True)
        return True, result

    async def _serve(self, model_name, inputs, kwargs, budget):
        plan = self._plan()
        home = self.cells[self.home]
        reason = self._preempt_reason(plan, home)
        last: Optional[BaseException] = None
        for cell in plan:
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            _flight.note("federation", "route", cell=cell.name)
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = await cell.pool.infer(model_name, inputs, **kw)
            except AdmissionRejected as e:
                if not is_spill_signal(e):  # see the sync twin
                    raise
                if cell is home:
                    self._note_home_outcome(home, shed=True)
                last, reason = e, SPILL_SATURATED
                _flight.note("federation", "cell_saturated", cell=cell.name,
                             reason=e.reason)
                continue
            except (CircuitOpenError, NoEndpointAvailableError) as e:
                cell.record_transport(False)
                last, reason = e, SPILL_DOWN
                _flight.note("federation", "cell_down", cell=cell.name)
                continue
            except Exception as e:
                domain = classify_fault(e)
                if domain == FATAL:
                    cell.record_transport(True)
                    raise
                if domain == SHED:
                    if cell is home:
                        self._note_home_outcome(home, shed=True)
                    last, reason = e, SPILL_SATURATED
                    continue
                cell.record_transport(False)
                last = e
                reason = SPILL_DOWN if domain == CONNECT else SPILL_ERROR
                _flight.note("federation", "cell_failed", cell=cell.name,
                             domain=domain)
                continue
            cell.record_transport(True)
            with self._lock:
                cell.served_total += 1
            if cell is home:
                self._note_home_outcome(home, shed=False)
            else:
                self._count_spill(home, cell, reason or SPILL_ERROR)
            return result
        if last is not None:
            raise last
        raise NoCellAvailableError()

    async def _sequence_infer(self, model_name, inputs, kwargs):
        sequence_id = kwargs["sequence_id"]
        request_id = kwargs.get("request_id", "")
        budget = AttemptBudget(self._budget_policy,
                               kwargs.get("client_timeout"))
        tried: List[CellState] = []
        last: Optional[BaseException] = None
        for _ in range(len(self._serve_order)):
            try:
                remaining = budget.attempt_timeout_s()
            except InferenceServerException as deadline_exc:
                if last is not None:
                    raise deadline_exc from last
                raise
            cell = self._seq_cell(sequence_id, exclude=tried)
            if cell not in tried:
                tried.append(cell)
            _flight.note("federation", "route", cell=cell.name,
                         sequence_id=sequence_id)
            try:
                kw = dict(kwargs)
                if remaining is not None:
                    kw["client_timeout"] = remaining
                result = await cell.pool.infer(model_name, inputs, **kw)
            except AdmissionRejected as e:
                if not is_spill_signal(e):  # see the sync twin
                    raise
                last = e
                if cell is self.cells[self.home]:
                    self._note_home_outcome(cell, shed=True)
                if self._seq_repin_allowed(sequence_id):
                    self._seq_unpin(sequence_id)
                    continue
                raise
            except (CircuitOpenError, NoEndpointAvailableError) as e:
                cell.record_transport(False)
                last = e
                if self._seq_repin_allowed(sequence_id):
                    self._seq_unpin(sequence_id)
                    continue
                raise
            except Exception as e:
                domain = classify_fault(e)
                if domain in (FATAL, SHED):
                    raise
                cell.record_transport(False)
                last = e
                if domain == CONNECT and self._seq_repin_allowed(sequence_id):
                    self._seq_unpin(sequence_id)
                    continue
                self._seq_abandon(cell, request_id, sequence_id, e)
                raise
            cell.record_transport(True)
            with self._lock:
                cell.served_total += 1
            if cell is self.cells[self.home]:
                # a home-served sequence step refreshes the shed window
                # too: a sequence-heavy workload must be able to RELEASE
                # an engaged spill, not latch it forever
                self._note_home_outcome(cell, shed=False)
            self._seq_mark_established(sequence_id)
            if kwargs.get("sequence_end"):
                self._seq_unpin(sequence_id)
            return result
        assert last is not None
        raise last

    # -- streaming -------------------------------------------------------------
    def generate_stream(self, model_name, *args, **kwargs):
        """Async federated SSE stream (same first-event pinning contract
        as the sync twin)."""
        plan = self._plan()
        home = self.cells[self.home]
        reason = self._preempt_reason(plan, home)

        async def stream():
            last: Optional[BaseException] = None
            spill_reason = reason
            for cell in plan:
                _flight.note("federation", "route", cell=cell.name,
                             op="generate_stream")
                delivered = False
                try:
                    inner = cell.pool.generate_stream(
                        model_name, *args, **kwargs)
                    async for item in inner:
                        if not delivered:
                            delivered = True
                            cell.record_transport(True)
                            with self._lock:
                                cell.served_total += 1
                            if cell is home:
                                self._note_home_outcome(home, shed=False)
                            else:
                                self._count_spill(
                                    home, cell,
                                    spill_reason or SPILL_ERROR)
                        yield item
                    return
                except AdmissionRejected as e:
                    if delivered:
                        raise
                    if cell is home:
                        self._note_home_outcome(home, shed=True)
                    last, spill_reason = e, SPILL_SATURATED
                    continue
                except (CircuitOpenError, NoEndpointAvailableError) as e:
                    if delivered:
                        raise
                    cell.record_transport(False)
                    last, spill_reason = e, SPILL_DOWN
                    continue
                except Exception as e:
                    domain = classify_fault(e)
                    if delivered or domain in (FATAL, SHED):
                        raise
                    cell.record_transport(False)
                    last = e
                    spill_reason = (SPILL_DOWN if domain == CONNECT
                                    else SPILL_ERROR)
                    continue
            if last is not None:
                raise last
            raise NoCellAvailableError()

        return stream()

    # -- shadow mirroring ------------------------------------------------------
    def _maybe_shadow(self, model_name, inputs, kwargs, primary) -> None:
        if self._closed or not self._shadow_should_mirror(kwargs):
            return
        import asyncio

        sp = self._shadow
        _flight.note("federation", "shadow_mirror", cell=sp.cell)
        try:
            snap = ([copy.copy(i) for i in inputs]
                    if isinstance(inputs, (list, tuple)) else inputs)
        except Exception:
            snap = inputs
        kw = self._shadow_kwargs(kwargs, sp.timeout_s)
        cell = self.cells[sp.cell]

        async def mirror():
            error: Optional[BaseException] = None
            result = None
            try:
                result = await cell.pool.infer(model_name, snap, **kw)
            except asyncio.CancelledError:
                # teardown cancel: release the pending slot, count nothing
                with self._lock:
                    self._shadow_pending = max(0, self._shadow_pending - 1)
                raise
            except Exception as e:
                error = e
            self._shadow_settle(model_name, primary, result, error)

        try:
            task = asyncio.get_running_loop().create_task(mirror())
        except RuntimeError:
            # no running loop (shouldn't happen mid-infer): drop the slot
            with self._lock:
                self._shadow_pending = max(0, self._shadow_pending - 1)
            return
        self._shadow_tasks.add(task)
        task.add_done_callback(self._shadow_tasks.discard)

    async def shadow_drain(self, timeout_s: float = 10.0) -> bool:
        import asyncio

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._shadow_pending == 0:
                    return True
            await asyncio.sleep(0.01)
        return False

    # -- generic surface delegation --------------------------------------------
    async def _broadcast(self, name: str, args, kwargs):
        import inspect

        first_exc: Optional[BaseException] = None
        result = None
        for cell in self.cells.values():
            try:
                result = getattr(cell.pool, name)(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
            except Exception as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return result

    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("cells", "home"):
            # the construction-time guard: a lookup of cells/home on a
            # partially-built instance must fail, not recurse through
            # this delegation
            raise AttributeError(name)
        home_pool = self.cells[self.home].pool
        probe = getattr(home_pool, name, None)
        if not callable(probe):
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r}")

        if self._is_broadcast(name):
            async def call(*args, **kwargs):
                return await self._broadcast(name, args, kwargs)
        else:
            async def call(*args, **kwargs):
                import inspect

                last: Optional[BaseException] = None
                for cell in self._plan():
                    try:
                        result = getattr(cell.pool, name)(*args, **kwargs)
                        if inspect.isawaitable(result):
                            result = await result
                        return result
                    except (CircuitOpenError,
                            NoEndpointAvailableError) as e:
                        last = e
                        continue
                    except Exception as e:
                        if classify_fault(e) in (CONNECT, TRANSIENT,
                                                 TIMEOUT):
                            last = e
                            continue
                        raise
                if last is not None:
                    raise last
                raise NoCellAvailableError()

        call.__name__ = name
        return call
