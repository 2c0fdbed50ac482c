"""Transport-agnostic resilience policies for the four client frontends.

The reference client leaves failure handling to the caller: a transient
connection reset, a slow-starting server, or a mid-stream disconnect all
surface as a raw ``InferenceServerException`` with no recovery path. This
module is the shared policy engine behind
``InferenceServerClientBase.configure_resilience``:

- :class:`RetryPolicy` — bounded retries with exponential backoff and full
  jitter, per-attempt and total deadline budgets, and a fault-domain gate
  that distinguishes *connect* failures (the request provably never reached
  the server — always safe to retry) from *transient* in-flight failures
  (reset / 503 / UNAVAILABLE — safe only for idempotent requests) from
  *fatal* errors (data corruption, protocol violations — never retried).
- :class:`CircuitBreaker` — closed → open → half-open with a sliding
  failure-rate window; an open circuit fast-fails with
  :class:`CircuitOpenError` instead of queueing doomed work (load shedding).
- :class:`ResiliencePolicy` — composes the two and runs an operation under
  them, sync (``execute``) or asyncio (``execute_async``).
- :class:`StreamReconnected` — the typed event a reconnecting GRPC stream
  delivers through its callback after transparently re-establishing the
  bidi call. Non-idempotent (sequence) requests are never silently
  re-sent; their ids arrive in ``abandoned_request_ids`` instead.

Classification is name-based over the exception cause chain plus the typed
exception's status, so the engine stays free of urllib3/aiohttp/grpc
imports and one policy object serves all four transports.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import flight as _flight
from .utils import InferenceServerException

__all__ = [
    "CONNECT",
    "TRANSIENT",
    "TIMEOUT",
    "FATAL",
    "SHED",
    "INVALID",
    "AttemptBudget",
    "CircuitBreaker",
    "CircuitOpenError",
    "ResiliencePolicy",
    "ResilienceStats",
    "RetryPolicy",
    "RetryableStatusError",
    "StreamReconnected",
    "classify_fault",
]

# -- fault domains -----------------------------------------------------------
CONNECT = "connect"      # never reached the server: always safe to retry
TRANSIENT = "transient"  # may have reached the server: retry iff idempotent
TIMEOUT = "timeout"      # budget spent in flight: retry iff opted in + idempotent
FATAL = "fatal"          # corruption / protocol / application error: never retry
SHED = "shed"            # admission control rejected it client-side: never sent,
#                          never retried, and NOT a breaker/ejection signal —
#                          accounting counts it as shed, not error
INVALID = "invalid"      # the endpoint ANSWERED, but the answer failed contract
#                          validation (integrity.IntegrityError): never retried
#                          on the same endpoint, safe to fail over iff
#                          idempotent, counted into the pool's quarantine window

# client_tpu_torch.admission.AdmissionRejected carries this status; matching on
# the status string keeps this module free of an admission import
_ADMISSION_REJECTED_STATUS = "ADMISSION_REJECTED"

# client_tpu_torch.integrity.IntegrityError carries this status; same pattern —
# no integrity import here
_INTEGRITY_VIOLATION_STATUS = "INTEGRITY_VIOLATION"

# Exception type names (checked across the __cause__/__context__ chain, and
# across each exception's MRO) that mark a request as never-sent.
_CONNECT_TYPE_NAMES = frozenset({
    "NewConnectionError",       # urllib3: refused / DNS
    "ConnectTimeoutError",      # urllib3: SYNs dropped — equally never-sent
    "ClientConnectorError",     # aiohttp: refused / DNS
    "ConnectionRefusedError",
    "gaierror",
})

# In-flight transport deaths: the bytes may or may not have been processed.
_TRANSIENT_TYPE_NAMES = frozenset({
    "ProtocolError",            # urllib3 mid-body death
    "ConnectionResetError",
    "BrokenPipeError",
    "ConnectionAbortedError",
    "RemoteDisconnected",
    "IncompleteRead",
    "ServerDisconnectedError",  # aiohttp
    "ClientOSError",            # aiohttp
    "ClientPayloadError",       # aiohttp truncated body
})

_TIMEOUT_TYPE_NAMES = frozenset({
    "TimeoutError",
    "ReadTimeoutError",
    "ServerTimeoutError",
})

# HTTP statuses where the server (or an intermediary) explicitly shed the
# request; KServe/Triton semantics make these re-issuable.
RETRYABLE_HTTP_STATUSES = frozenset({"408", "429", "502", "503", "504"})
_TIMEOUT_HTTP_STATUSES = frozenset({"499"})

_TRANSIENT_GRPC_STATUSES = frozenset({
    "StatusCode.UNAVAILABLE",
    "StatusCode.RESOURCE_EXHAUSTED",
})
_TIMEOUT_GRPC_STATUSES = frozenset({"StatusCode.DEADLINE_EXCEEDED"})

_CONNECT_DETAIL_MARKERS = (
    "failed to connect",
    "connection refused",
    "connect failed",
    "name resolution",
    "dns resolution",
)


class CircuitOpenError(InferenceServerException):
    """Fast-fail raised while a circuit breaker is open (load shedding)."""

    def __init__(self, msg: str = "circuit breaker is open; request fast-failed",
                 retry_after_s: Optional[float] = None):
        super().__init__(msg, status="CIRCUIT_OPEN")
        self.retry_after_s = retry_after_s


class RetryableStatusError(InferenceServerException):
    """Internal marker: an HTTP response whose status is worth retrying.

    The HTTP frontends raise it *inside* a resilient attempt so the engine
    re-issues the request, then unwrap ``response`` at the boundary when
    attempts are exhausted — callers keep seeing a plain response + the
    usual ``raise_if_error`` path, never this type.
    """

    def __init__(self, status: int, response: Any):
        super().__init__(f"retryable HTTP status {status}", status=str(status))
        self.response = response


def _chain(exc: BaseException) -> List[BaseException]:
    """The exception plus its cause/context chain (cycle-safe)."""
    out: List[BaseException] = []
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        out.append(cur)
        cur = cur.__cause__ if cur.__cause__ is not None else cur.__context__
    return out


def _type_names(exc: BaseException) -> List[str]:
    return [c.__name__ for c in type(exc).__mro__]


def classify_fault(exc: BaseException) -> str:
    """Map an exception (typically the clients' typed exception, with the
    transport error as its ``__cause__``) to a fault domain."""
    if isinstance(exc, CircuitOpenError):
        return FATAL  # retrying inside an open circuit defeats the breaker
    if (isinstance(exc, InferenceServerException)
            and exc.status() == _ADMISSION_REJECTED_STATUS):
        # admission control shed it before anything touched the wire:
        # never retried (retries_domain: unknown domain -> False), never
        # a breaker outcome (see _record), counted as shed by harnesses
        return SHED
    chain = _chain(exc)
    for e in chain:
        if (isinstance(e, InferenceServerException)
                and e.status() == _INTEGRITY_VIOLATION_STATUS):
            # the transport worked end to end and the server answered —
            # wrongly. Same-endpoint retry would re-trust a liar
            # (retries_domain: unknown domain -> False); the pool fails
            # over idempotent requests and counts it toward quarantine.
            return INVALID
    names: List[str] = []
    for e in chain:
        names.extend(_type_names(e))
    name_set = set(names)
    if name_set & _CONNECT_TYPE_NAMES:
        return CONNECT
    status = None
    message = ""
    for e in chain:
        if isinstance(e, InferenceServerException):
            status = status if status is not None else e.status()
            message = message or (e.message() or "")
    if status is not None:
        if status in RETRYABLE_HTTP_STATUSES or status in _TRANSIENT_GRPC_STATUSES:
            low = message.lower()
            if any(marker in low for marker in _CONNECT_DETAIL_MARKERS):
                return CONNECT
            return TRANSIENT
        if status in _TIMEOUT_HTTP_STATUSES or status in _TIMEOUT_GRPC_STATUSES:
            return TIMEOUT
    if name_set & _TRANSIENT_TYPE_NAMES:
        return TRANSIENT
    if name_set & _TIMEOUT_TYPE_NAMES:
        return TIMEOUT
    return FATAL


class RetryPolicy:
    """Exponential backoff with full jitter, bounded by attempts + deadlines.

    ``max_attempts`` counts the first try: ``max_attempts=1`` disables
    retries. ``total_deadline_s`` bounds the whole resilient call (attempts
    plus backoff sleeps) when the caller supplies no explicit per-request
    timeout; an explicit timeout always wins. ``per_attempt_timeout_s`` is
    advisory for transports that accept a per-attempt socket timeout.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        initial_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        backoff_multiplier: float = 2.0,
        jitter: bool = True,
        per_attempt_timeout_s: Optional[float] = None,
        total_deadline_s: Optional[float] = None,
        retry_connect: bool = True,
        retry_transient: bool = True,
        retry_timeouts: bool = False,
        rng: Optional[random.Random] = None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if initial_backoff_s < 0 or max_backoff_s < 0:
            raise ValueError("backoff must be >= 0")
        self.max_attempts = max_attempts
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.backoff_multiplier = backoff_multiplier
        self.jitter = jitter
        self.per_attempt_timeout_s = per_attempt_timeout_s
        self.total_deadline_s = total_deadline_s
        self.retry_connect = retry_connect
        self.retry_transient = retry_transient
        self.retry_timeouts = retry_timeouts
        self._rng = rng or random.Random()

    def backoff_s(self, attempt: int) -> float:
        """Backoff before re-attempt number ``attempt+1`` (attempt is 0-based)."""
        base = min(
            self.initial_backoff_s * (self.backoff_multiplier ** attempt),
            self.max_backoff_s,
        )
        if not self.jitter:
            return base
        return self._rng.uniform(0.0, base)  # full jitter (AWS-style)

    def retries_domain(self, domain: str, idempotent: bool) -> bool:
        if domain == CONNECT:
            return self.retry_connect
        if domain == TRANSIENT:
            return self.retry_transient and idempotent
        if domain == TIMEOUT:
            return self.retry_timeouts and idempotent
        return False


class CircuitBreaker:
    """Sliding-window failure-rate circuit breaker (thread-safe).

    closed: all calls pass; outcomes fill a window of the last
    ``window`` transport-level results. Once at least ``min_calls`` are
    recorded and the failure rate reaches ``failure_threshold``, the
    circuit opens. open: calls fast-fail with :class:`CircuitOpenError`
    until ``recovery_time_s`` elapses. half-open: up to
    ``half_open_max_probes`` calls are let through; a success closes the
    circuit (window cleared), a failure re-opens it.

    Only transport-level failures (connect/transient/timeout domains)
    count against the breaker; application errors (4xx, corruption) prove
    the transport delivered the request and count as successes — so a 4xx
    answer to a half-open probe closes the circuit instead of wedging it.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failure_threshold: float = 0.5,
        window: int = 16,
        min_calls: int = 8,
        recovery_time_s: float = 5.0,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError("failure_threshold must be in (0, 1]")
        if window < 1 or min_calls < 1:
            raise ValueError("window and min_calls must be >= 1")
        self.failure_threshold = failure_threshold
        self.window = window
        self.min_calls = min_calls
        self.recovery_time_s = recovery_time_s
        self.half_open_max_probes = half_open_max_probes
        # observability hook: called with the NEW state name after every
        # transition, outside the breaker lock (must be fast + non-raising;
        # observe.Telemetry.attach wires it to a transition counter)
        self.on_transition: Optional[Callable[[str], None]] = None
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: deque = deque(maxlen=window)
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes_in_flight = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _notify(self, state: Optional[str]) -> None:
        if state is None:
            return
        # the transition lands on the flight timeline of whichever request
        # caused it (the allow()/record() caller) — a breaker flip is a
        # per-request causal fact, not only a fleet counter
        _flight.note("breaker", "transition", state=state)
        if self.on_transition is None:
            return
        try:
            self.on_transition(state)
        except Exception:
            pass  # an observer must never break the data path

    def allow(self) -> None:
        """Admit one call or raise :class:`CircuitOpenError`."""
        transition = None
        try:
            with self._lock:
                if self._state == self.CLOSED:
                    return
                now = self._clock()
                if self._state == self.OPEN:
                    remaining = self._opened_at + self.recovery_time_s - now
                    if remaining > 0:
                        raise CircuitOpenError(
                            f"circuit breaker open; retry in {remaining:.3f}s",
                            retry_after_s=remaining,
                        )
                    self._state = self.HALF_OPEN
                    self._probes_in_flight = 0
                    transition = self.HALF_OPEN
                # HALF_OPEN: admit a bounded number of probes
                if self._probes_in_flight >= self.half_open_max_probes:
                    raise CircuitOpenError(
                        "circuit breaker half-open; probe already in flight",
                        retry_after_s=self.recovery_time_s,
                    )
                self._probes_in_flight += 1
        finally:
            self._notify(transition)

    def record(self, ok: bool) -> None:
        transition = None
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                if ok:
                    self._state = self.CLOSED
                    self._outcomes.clear()
                    transition = self.CLOSED
                else:
                    self._state = self.OPEN
                    self._opened_at = self._clock()
                    transition = self.OPEN
            else:
                self._outcomes.append(ok)
                if (self._state == self.CLOSED
                        and len(self._outcomes) >= self.min_calls):
                    failures = sum(1 for o in self._outcomes if not o)
                    if failures / len(self._outcomes) >= self.failure_threshold:
                        self._state = self.OPEN
                        self._opened_at = self._clock()
                        transition = self.OPEN
        self._notify(transition)

    def would_admit(self) -> bool:
        """Non-mutating peek: would :meth:`allow` admit a call right now?

        Unlike ``allow`` this takes no probe slot and performs no state
        transition, so selection layers (the endpoint pool) can skip an
        endpoint whose breaker would fast-fail without consuming the
        half-open probe budget. Inherently racy under concurrency — the
        admitting ``allow`` remains the authority and callers must still
        handle :class:`CircuitOpenError`."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                # an elapsed recovery window means allow() would half-open
                # and admit the first probe
                return self._clock() >= self._opened_at + self.recovery_time_s
            return self._probes_in_flight < self.half_open_max_probes

    def abort_probe(self) -> None:
        """Release an admitted probe slot without recording an outcome
        (the attempt was interrupted, e.g. cancellation/KeyboardInterrupt —
        half-open has no time-based escape, so a leaked slot wedges the
        breaker forever)."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)

    def reset(self) -> None:
        with self._lock:
            changed = self._state != self.CLOSED
            self._state = self.CLOSED
            self._outcomes.clear()
            self._probes_in_flight = 0
        if changed:
            self._notify(self.CLOSED)


class ResilienceStats:
    """Cumulative counters for one policy object (thread-safe writes,
    lock-free reads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls = 0
        self.attempts = 0
        self.retries = 0
        self.fast_fails = 0

    def _bump(self, calls=0, attempts=0, retries=0, fast_fails=0) -> None:
        with self._lock:
            self.calls += calls
            self.attempts += attempts
            self.retries += retries
            self.fast_fails += fast_fails

    def as_dict(self) -> Dict[str, int]:
        # lock-free: each counter is one int slot only ever mutated under
        # _bump's lock, so a read sees a valid value; the four reads may be
        # an increment apart, which a metrics scrape tolerates — taking the
        # lock here would put scrapers on the data path's critical section
        return {
            "calls": self.calls,
            "attempts": self.attempts,
            "retries": self.retries,
            "fast_fails": self.fast_fails,
        }


class StreamReconnected:
    """Delivered through a reconnecting stream's callback (as the result,
    with ``error=None``) after the bidi call was re-established.

    ``resent_request_ids``: idempotent requests that were in flight on the
    dead stream and were transparently re-sent on the new one.
    ``abandoned_request_ids``: non-idempotent (sequence) requests that were
    in flight — these are NEVER silently re-sent; the application owns
    re-driving its sequence state.
    """

    __slots__ = ("attempt", "resent_request_ids", "abandoned_request_ids", "cause")

    def __init__(self, attempt: int, resent_request_ids: Sequence[str],
                 abandoned_request_ids: Sequence[str],
                 cause: Optional[Exception] = None):
        self.attempt = attempt
        self.resent_request_ids = list(resent_request_ids)
        self.abandoned_request_ids = list(abandoned_request_ids)
        self.cause = cause

    def __repr__(self) -> str:
        return (
            f"StreamReconnected(attempt={self.attempt}, "
            f"resent={self.resent_request_ids}, "
            f"abandoned={self.abandoned_request_ids})"
        )


class AttemptBudget:
    """Shared deadline arithmetic for the frontends' retrying request
    wrappers: derives the total budget (the caller's explicit timeout,
    else the retry policy's total deadline — which must bound in-flight
    attempts too, not only backoff sleeps) and clamps every re-attempt to
    the REMAINING budget and the policy's per-attempt timeout, so a
    re-attempt never gets a fresh full timeout."""

    __slots__ = ("per_attempt_s", "deadline")

    def __init__(self, policy: Optional["ResiliencePolicy"],
                 timeout_s: Optional[float] = None):
        budget = timeout_s
        self.per_attempt_s: Optional[float] = None
        if policy is not None and policy.retry is not None:
            self.per_attempt_s = policy.retry.per_attempt_timeout_s
            if budget is None:
                budget = policy.retry.total_deadline_s
        self.deadline = (
            time.monotonic() + budget if budget is not None else None)

    def attempt_timeout_s(self, status: str = "499") -> Optional[float]:
        """Timeout for the next attempt: the remaining total budget clamped
        to the per-attempt timeout, or None when both are unbounded. Raises
        a typed Deadline Exceeded (with the transport's ``status`` code)
        when the budget is already spent, so the engine never launches a
        doomed attempt."""
        remaining = None
        if self.deadline is not None:
            remaining = self.deadline - time.monotonic()
            if remaining <= 0:
                raise InferenceServerException(
                    "Deadline Exceeded", status=status)
        if self.per_attempt_s is not None:
            remaining = (self.per_attempt_s if remaining is None
                         else min(remaining, self.per_attempt_s))
        return remaining


class ResiliencePolicy:
    """Retry + circuit-breaker composition with sync and asyncio engines.

    One policy may be shared across clients; the breaker window then
    reflects the whole process' view of the endpoint (that is the point).
    Per-request overrides go through ``execute(..., retry=...)`` or the
    clients' ``resilience=`` keyword.
    """

    def __init__(
        self,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        classify: Callable[[BaseException], str] = classify_fault,
        retry_http_statuses: bool = True,
    ):
        self.retry = retry
        self.breaker = breaker
        self.classify = classify
        # when True the HTTP frontends convert 408/429/502/503/504 responses
        # into retryable attempts (unwrapped back to plain responses at the
        # boundary if attempts run out)
        self.retry_http_statuses = retry_http_statuses
        self.stats = ResilienceStats()
        # observability hook (duck-typed; see observe.Telemetry.attach):
        # on_retry(attempt, exc, delay_s) / on_fast_fail() called alongside
        # the stats counters — must be fast and non-raising
        self.observer = None

    # -- decision core (shared by both engines) -----------------------------
    @staticmethod
    def _deadline(timeout_s: Optional[float],
                  retry: Optional[RetryPolicy]) -> Optional[float]:
        budget = timeout_s
        if budget is None and retry is not None:
            budget = retry.total_deadline_s
        return time.monotonic() + budget if budget is not None else None

    def _retry_delay(
        self,
        exc: BaseException,
        attempt: int,
        idempotent: bool,
        deadline: Optional[float],
        retry: Optional[RetryPolicy],
    ) -> Optional[float]:
        """Backoff before the next attempt, or None when ``exc`` is final."""
        if retry is None or attempt + 1 >= retry.max_attempts:
            return None
        domain = self.classify(exc)
        if not retry.retries_domain(domain, idempotent):
            return None
        delay = retry.backoff_s(attempt)
        if deadline is not None and time.monotonic() + delay >= deadline:
            return None
        return delay

    def _record(self, exc: Optional[BaseException]) -> None:
        breaker = self.breaker
        if breaker is None:
            return
        if exc is None:
            breaker.record(True)
        elif isinstance(exc, CircuitOpenError):
            # a (nested) fast-fail never touched the endpoint, so there is
            # no outcome to record — but if op() raised it while OUR breaker
            # was half-open, the admitted probe slot must be released or the
            # breaker wedges (half-open has no time-based escape)
            breaker.abort_probe()
        elif self.classify(exc) == SHED:
            # a client-local admission rejection never touched the
            # endpoint: no outcome to record, but a half-open probe slot
            # taken by this attempt must be released (same rule as a
            # nested CircuitOpenError)
            breaker.abort_probe()
        elif self.classify(exc) in (CONNECT, TRANSIENT, TIMEOUT):
            breaker.record(False)
        else:
            # FATAL (application) errors prove the transport worked — the
            # request reached the server and was answered — so they count
            # as breaker successes; anything else would leak the half-open
            # probe slot and wedge the breaker on a 4xx probe response
            breaker.record(True)

    # -- engines -------------------------------------------------------------
    def execute(
        self,
        op: Callable[[], Any],
        *,
        idempotent: bool = True,
        timeout_s: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> Any:
        """Run ``op()`` under the policy; returns its result or raises the
        final error. ``retry`` overrides the policy's RetryPolicy for this
        call (per-request hook)."""
        active_retry = retry if retry is not None else self.retry
        deadline = self._deadline(timeout_s, active_retry)
        self.stats._bump(calls=1)
        attempt = 0
        while True:
            if self.breaker is not None:
                try:
                    self.breaker.allow()
                except CircuitOpenError:
                    self.stats._bump(fast_fails=1)
                    _flight.note("breaker", "fast_fail")
                    if self.observer is not None:
                        try:
                            self.observer.on_fast_fail()
                        except Exception:
                            pass
                    raise
            self.stats._bump(attempts=1)
            try:
                result = op()
            except Exception as exc:
                self._record(exc)
                delay = self._retry_delay(
                    exc, attempt, idempotent, deadline, active_retry)
                if delay is None:
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                self.stats._bump(retries=1)
                _flight.note("retry", "attempt", n=attempt + 1,
                             delay_ms=round(delay * 1e3, 3),
                             error=type(exc).__name__)
                if self.observer is not None:
                    try:
                        self.observer.on_retry(attempt, exc, delay)
                    except Exception:
                        pass
                sleep(delay)
                attempt += 1
                continue
            except BaseException:
                # KeyboardInterrupt/SystemExit: no outcome to record, but a
                # half-open probe slot must be released or the breaker wedges
                if self.breaker is not None:
                    self.breaker.abort_probe()
                raise
            self._record(None)
            return result

    async def execute_async(
        self,
        op: Callable[[], Any],
        *,
        idempotent: bool = True,
        timeout_s: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    ) -> Any:
        """Asyncio twin of :meth:`execute`; ``op`` is a coroutine function."""
        import asyncio

        active_retry = retry if retry is not None else self.retry
        deadline = self._deadline(timeout_s, active_retry)
        self.stats._bump(calls=1)
        attempt = 0
        while True:
            if self.breaker is not None:
                try:
                    self.breaker.allow()
                except CircuitOpenError:
                    self.stats._bump(fast_fails=1)
                    _flight.note("breaker", "fast_fail")
                    if self.observer is not None:
                        try:
                            self.observer.on_fast_fail()
                        except Exception:
                            pass
                    raise
            self.stats._bump(attempts=1)
            try:
                result = await op()
            except Exception as exc:
                self._record(exc)
                delay = self._retry_delay(
                    exc, attempt, idempotent, deadline, active_retry)
                if delay is None:
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                self.stats._bump(retries=1)
                _flight.note("retry", "attempt", n=attempt + 1,
                             delay_ms=round(delay * 1e3, 3),
                             error=type(exc).__name__)
                if self.observer is not None:
                    try:
                        self.observer.on_retry(attempt, exc, delay)
                    except Exception:
                        pass
                await asyncio.sleep(delay)
                attempt += 1
                continue
            except BaseException:
                # asyncio.CancelledError is a BaseException: a cancelled
                # probe must release its half-open slot
                if self.breaker is not None:
                    self.breaker.abort_probe()
                raise
            self._record(None)
            return result


def connect_only_policy(max_retries: int) -> Optional[ResiliencePolicy]:
    """The legacy ``max_retries`` semantics as a policy: re-attempt only
    connect-class failures (request provably never sent), deterministic
    linear-ish backoff, no breaker. None when retries are disabled."""
    if max_retries <= 0:
        return None
    return ResiliencePolicy(
        retry=RetryPolicy(
            max_attempts=max_retries + 1,
            initial_backoff_s=0.05,
            max_backoff_s=0.5,
            jitter=False,
            retry_connect=True,
            retry_transient=False,
            retry_timeouts=False,
        ),
        retry_http_statuses=False,
    )
