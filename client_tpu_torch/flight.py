"""Flight recorder: tail-based retention of per-request causal timelines.

The aggregate telemetry (``client_tpu_torch.observe``) can say *that* the p999
burned an SLO; nothing in the process can say *why request X was slow* —
which retry fired, which endpoint was re-homed, whether the token parked
in an admission queue or a coalescing window, whether the cache stale
path refreshed. This module is the per-request attribution layer every
other layer reports into:

- Every layer emits **structured point events** into a thread/task-local
  scratch buffer via :func:`note` — a plain list append keyed off one
  contextvar, ~sub-microsecond per event, and exactly one branch when no
  request is being recorded (the contextvar reads ``None``).
- The **outermost** layer of a request (cache -> batch -> pool ->
  endpoint frontend, whichever the caller holds) opens the scratch with
  :meth:`FlightRecorder.begin` and settles it with
  :meth:`FlightRecorder.commit`; nested layers see an active scratch and
  only append. Events across layers therefore land on ONE timeline in
  causal order, stitched to the wire via the W3C trace ids of every
  endpoint span begun under the scratch (``span``-layer events).
- **Tail-based retention** is the headline mechanism: at commit a
  *verdict* decides whether the whole timeline is retained in a bounded
  ring or dropped wholesale — ``error`` (the request failed), ``shed``
  (admission/breaker shed it), ``slo_breach`` (over the declared
  ``slo_ms``), ``slow`` (over a rolling tail-quantile threshold of
  recent durations), or ``baseline`` (a small reservoir sample of
  healthy traffic for contrast). Fast healthy requests — the
  overwhelming majority at production rates — cost one scratch list
  that is dropped whole; full forensic detail exists for exactly the
  requests worth explaining.
- Exporters: :meth:`FlightRecorder.to_chrome_trace` (merged with the
  tracer ring's ``RequestSpan`` phase intervals by trace id),
  :meth:`FlightRecorder.dump_jsonl`, and
  :meth:`FlightRecorder.last_anomalies`;
  :meth:`FlightRecorder.tail_divergence` is the anomaly detector behind
  the doctor's ``tail_divergence`` flag, and
  ``client_tpu_torch.doctor --postmortem`` packages the retained timelines
  with the fleet snapshot into one self-contained bundle.

Wiring: ``Telemetry(flight=FlightRecorder())`` (or ``flight=True``)
arms it; the frontends, pool, admission, batching, cache, arena, shard
and federation layers all emit automatically (the federation layer
stamps every event with its ``cell`` and contributes ``route`` /
``cell_spill`` / ``spill_engaged``/``spill_released`` /
``canary_route``/``canary_rollback`` / ``shadow_mirror``/
``shadow_diverged`` / ``sequence_abandoned`` — a divergent shadow
response is retained on its OWN timeline). See docs/observability.md
"Flight recorder & postmortems".
"""

from __future__ import annotations

import contextvars
import itertools
import json
import random
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "FLIGHT_VERDICTS",
    "FlightRecorder",
    "FlightTimeline",
    "active_scratch",
    "layer_begin",
    "layer_commit",
    "note",
]

# retained-timeline verdicts, roughly most-severe first. "disrupted" is
# the stream-specific verdict (the stream reconnected mid-flight but
# finished); "baseline" is the healthy-contrast reservoir sample; "mark"
# is an out-of-band marker timeline (the watchtower's ``watch.alert``
# edges land in the ring this way — requestless, but retained so a
# postmortem reads alerts interleaved with the requests they explain).
FLIGHT_VERDICTS = (
    "error", "shed", "slo_breach", "slow", "disrupted", "baseline", "mark")

# The active scratch for the request being processed on this thread/task.
# contextvars give thread- AND asyncio-task-locality in one mechanism;
# executor threads (hedge attempts, shard fan-out workers) do not inherit
# the caller's context, so their note() calls are no-ops unless an
# endpoint span opens its own scratch there — exactly the isolation the
# coordinator-side events (hedge launch/win, shard dispatch) rely on.
_SCRATCH: contextvars.ContextVar = contextvars.ContextVar(
    "client_tpu_flight_scratch", default=None)


class _Scratch:
    """One in-progress request's append-only event buffer. Never shared
    across threads: it lives in exactly one context between begin() and
    commit()."""

    __slots__ = ("start_ns", "frontend", "model", "op", "events",
                 "truncated", "trace_id", "trace_ids", "limit", "token",
                 "committed")

    def __init__(self, frontend: str, model: str, op: str, limit: int):
        self.start_ns = time.perf_counter_ns()
        self.frontend = frontend
        self.model = model
        self.op = op
        # (perf_counter_ns, layer, event, attrs-or-None) tuples
        self.events: List[Tuple[int, str, str, Optional[dict]]] = []
        self.truncated = 0
        self.trace_id: Optional[str] = None
        self.trace_ids: List[str] = []
        self.limit = limit
        self.token = None
        self.committed = False

    def append(self, layer: str, event: str, **attrs) -> None:
        """Cap-aware append for callers that already HOLD the scratch
        (:func:`note` inlines the same rule for the contextvar hot path —
        keep the two in sync)."""
        if len(self.events) < self.limit:
            self.events.append((time.perf_counter_ns(), layer, event,
                                attrs or None))
        else:
            self.truncated += 1


def note(layer: str, event: str, **attrs) -> None:
    """Record one structured event on the active request's timeline.

    THE hot-path entry every layer calls unconditionally: with no request
    being recorded (no recorder armed, or this thread/task is outside a
    request) the contextvar reads None and this is one branch. With an
    active scratch it is one ``perf_counter_ns`` plus a bounded list
    append. The
    cap-and-append rule is inlined for speed: keep it in sync with
    :meth:`_Scratch.append`."""
    s = _SCRATCH.get()
    if s is None or s.committed:
        # committed guard: a task that inherited a context COPY (aio
        # batch flusher, hedge task) may still see a scratch its owner
        # already settled — its events list now belongs to a retained
        # timeline and must never grow
        return
    if len(s.events) < s.limit:
        s.events.append((time.perf_counter_ns(), layer, event,
                         attrs or None))
    else:
        s.truncated += 1


def active_scratch() -> Optional[_Scratch]:
    """The in-progress scratch on this context, if any (introspection)."""
    return _SCRATCH.get()


def layer_begin(telemetry, frontend: str, model: str,
                op: str = "infer") -> Optional[_Scratch]:
    """The wrapper layers' (pool/batch/cache/shard) one-line gate: open a
    scratch owned by this layer, or None when no recorder is armed on
    ``telemetry`` or a request is already being recorded (nested layer)."""
    if telemetry is None:
        return None
    recorder = getattr(telemetry, "flight", None)
    if recorder is None:
        return None
    return recorder.begin(frontend, model, op)


def layer_commit(telemetry, scratch: Optional[_Scratch],
                 error: Optional[BaseException] = None) -> None:
    """Settle a scratch opened by :func:`layer_begin` (no-op for None)."""
    if scratch is not None:
        telemetry.flight.commit(scratch, error=error)


class _RollingQuantile:
    """A rolling tail-quantile threshold over the last ``window``
    durations, recomputed every ``refresh`` insertions (a sort of a
    bounded copy, amortized off the per-request path). Returns None until
    ``min_samples`` durations have been observed — the recorder samples
    nothing as "slow" before it knows what normal looks like."""

    __slots__ = ("quantile", "window", "refresh", "min_samples", "_buf",
                 "_idx", "_count", "_since", "_value")

    def __init__(self, quantile: float = 0.99, window: int = 2048,
                 refresh: int = 256, min_samples: int = 128):
        if not 0.0 < quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.quantile = quantile
        self.window = int(window)
        self.refresh = max(1, int(refresh))
        self.min_samples = max(1, int(min_samples))
        self._buf: List[float] = []
        self._idx = 0
        self._count = 0
        self._since = 0
        self._value: Optional[float] = None

    def add(self, value: float) -> None:
        if len(self._buf) < self.window:
            self._buf.append(value)
        else:
            self._buf[self._idx] = value
            self._idx = (self._idx + 1) % self.window
        self._count += 1
        self._since += 1
        if self._since >= self.refresh or (
                self._value is None and self._count >= self.min_samples):
            self._since = 0
            if self._count >= self.min_samples:
                s = sorted(self._buf)
                from .utils import sorted_percentile

                self._value = sorted_percentile(s, self.quantile)

    def threshold(self) -> Optional[float]:
        return self._value


class FlightTimeline:
    """One committed (retained) request timeline: immutable after commit."""

    __slots__ = ("seq", "verdict", "trace_id", "trace_ids", "frontend",
                 "model", "op", "start_ns", "end_ns", "duration_ms",
                 "error", "events", "truncated", "_attribution")

    def __init__(self, seq: int, verdict: str, scratch: _Scratch,
                 end_ns: int, error: Optional[str]):
        self.seq = seq
        self.verdict = verdict
        self.trace_id = scratch.trace_id
        self.trace_ids = list(scratch.trace_ids)
        self.frontend = scratch.frontend
        self.model = scratch.model
        self.op = scratch.op
        self.start_ns = scratch.start_ns
        self.end_ns = end_ns
        self.duration_ms = round((end_ns - scratch.start_ns) / 1e6, 6)
        self.error = error
        self.events = scratch.events  # ownership transfers at commit
        self.truncated = scratch.truncated

    def attribution(self) -> Dict[str, Any]:
        """Decompose the timeline's wall time over its event sequence.

        The gap between consecutive events is attributed to the EARLIER
        event's layer (the time that elapsed while that layer's step was
        the latest thing that happened); events carrying a ``url``
        attribute attribute as ``"<layer>:<url>"`` so a slow replica is
        named, not just a slow layer. Returns the per-key milliseconds,
        the dominant key and its share — the per-timeline input to
        :meth:`FlightRecorder.tail_divergence`. Memoized: a timeline is
        immutable after commit, and tail_divergence / doctor snapshots /
        postmortem bundles all re-read the same decomposition."""
        cached = getattr(self, "_attribution", None)
        if cached is not None:
            return cached
        total_ns = max(self.end_ns - self.start_ns, 1)
        keys: Dict[str, float] = {}
        prev_ns = self.start_ns
        prev_key = "pre"
        for ts, layer, _event, attrs in self.events:
            keys[prev_key] = keys.get(prev_key, 0.0) + (ts - prev_ns)
            url = (attrs or {}).get("url")
            prev_key = f"{layer}:{url}" if url else layer
            prev_ns = ts
        keys[prev_key] = keys.get(prev_key, 0.0) + (self.end_ns - prev_ns)
        ms = {k: round(v / 1e6, 4) for k, v in keys.items() if v > 0}
        if not ms:
            out = {"ms": {}, "dominant": None, "dominant_share": 0.0}
        else:
            dominant = max(ms, key=ms.get)
            out = {
                "ms": ms,
                "dominant": dominant,
                "dominant_share": round(keys[dominant] / total_ns, 4),
            }
        self._attribution = out
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "verdict": self.verdict,
            "trace_id": self.trace_id,
            "trace_ids": list(self.trace_ids),
            "frontend": self.frontend,
            "model": self.model,
            "op": self.op,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ms": self.duration_ms,
            "error": self.error,
            "truncated": self.truncated,
            "events": [
                {"ns": ts, "offset_ms": round((ts - self.start_ns) / 1e6, 4),
                 "layer": layer, "event": event, **(attrs or {})}
                for ts, layer, event, attrs in self.events
            ],
            "attribution": self.attribution(),
        }


class FlightRecorder:
    """Bounded, lock-light ring of per-request causal timelines.

    ``capacity`` bounds the retained ring (oldest evicted);
    ``slow_quantile`` sets the rolling tail threshold behind the ``slow``
    verdict; ``slo_ms`` (optional) declares a hard per-request objective
    behind ``slo_breach``; ``baseline_ratio`` is the healthy-traffic
    reservoir sample; ``max_events`` caps one request's scratch (past it
    events are counted as truncated, never appended — the per-request
    memory bound). ``stream_slow_ttft_quantile`` is the stream twin of
    the slow threshold, fed by per-attempt TTFT.

    Thread-safety: the scratch is context-local (never locked); the
    commit path takes ONE short lock for the verdict bookkeeping and the
    ring append. note()/begin() never block on it."""

    def __init__(
        self,
        capacity: int = 512,
        slow_quantile: float = 0.99,
        baseline_ratio: float = 0.005,
        slo_ms: Optional[float] = None,
        max_events: int = 512,
        threshold_window: int = 2048,
        threshold_min_samples: int = 128,
        rng: Optional[random.Random] = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not 0.0 <= baseline_ratio <= 1.0:
            raise ValueError("baseline_ratio must be in [0, 1]")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError("slo_ms must be > 0")
        self.capacity = int(capacity)
        self.baseline_ratio = float(baseline_ratio)
        self.slo_ms = slo_ms
        self.max_events = max(1, int(max_events))
        self.enabled = True
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._next_seq = itertools.count(1).__next__
        self._threshold = _RollingQuantile(
            slow_quantile, threshold_window,
            min_samples=threshold_min_samples)
        self._stream_threshold = _RollingQuantile(
            slow_quantile, threshold_window,
            min_samples=threshold_min_samples)
        self._counts: Dict[str, int] = {v: 0 for v in FLIGHT_VERDICTS}
        self._dropped = 0
        self._evicted = 0
        self._requests = 0
        self._events_recorded = 0
        self._events_committed = 0
        self._truncated = 0
        # last-N commit costs (ns), split retained vs dropped
        self._commit_retained_ns: deque = deque(maxlen=4096)
        self._commit_dropped_ns: deque = deque(maxlen=4096)
        self._telemetry_ref: Optional[Callable[[], Any]] = None
        # commit tap: called with every RETAINED timeline, outside the
        # ring lock (the watchtower's black box drains timelines to disk
        # through this). None = one attribute load + branch per commit.
        self._commit_tap: Optional[Callable[["FlightTimeline"], None]] \
            = None

    # -- lifecycle (the per-request path) ------------------------------------
    def begin(self, frontend: str, model: str = "",
              op: str = "infer") -> Optional[_Scratch]:
        """Open a scratch on this context and become its owner, or None
        when disabled or a request is already being recorded here (the
        caller is a nested layer — it only notes)."""
        if not self.enabled:
            return None
        current = _SCRATCH.get()
        if current is not None and not current.committed:
            return None
        scratch = _Scratch(frontend, model, op, self.max_events)
        scratch.token = _SCRATCH.set(scratch)
        return scratch

    def span_begin(self, span, url: Optional[str] = None) -> None:
        """Called by the endpoint frontends' ``_obs_begin``: bind the new
        wire span's trace id onto the active scratch (opening one owned
        by the span — committed by ``Telemetry.finish`` — when this
        frontend IS the outermost layer)."""
        scratch = _SCRATCH.get()
        if scratch is None or scratch.committed:
            scratch = self.begin(span.frontend, span.model, span.op)
            if scratch is None:
                return
            span.flight = scratch
        if scratch.trace_id is None:
            scratch.trace_id = span.trace_id
        scratch.trace_ids.append(span.trace_id)
        if url:
            scratch.append("span", "begin", trace_id=span.trace_id,
                           frontend=span.frontend, url=url)
        else:
            scratch.append("span", "begin", trace_id=span.trace_id,
                           frontend=span.frontend)

    def _classify_error(self, error: BaseException) -> Tuple[str, str]:
        """(verdict, short error string) for a failed request."""
        from .resilience import SHED, CircuitOpenError, classify_fault

        text = f"{type(error).__name__}: {error}"[:256]
        if isinstance(error, CircuitOpenError):
            return "shed", text
        if classify_fault(error) == SHED:
            return "shed", text
        return "error", text

    def commit(self, scratch: _Scratch,
               error: Optional[BaseException] = None) -> Optional[str]:
        """Settle the request: run the verdict and retain or drop the
        whole timeline. Returns the verdict (None = dropped). Idempotent
        (a double commit is a counted no-op), and always clears the
        contextvar so a leaked scratch can never pollute the next request
        on this thread/task."""
        t0 = time.perf_counter_ns()
        if scratch.committed:
            return None
        scratch.committed = True
        token, scratch.token = scratch.token, None
        if token is not None:
            try:
                _SCRATCH.reset(token)
            except ValueError:
                # committed from a different context than begin (should
                # not happen by construction; never let it leak a scratch)
                _SCRATCH.set(None)
        end_ns = t0
        duration_ms = (end_ns - scratch.start_ns) / 1e6
        verdict: Optional[str] = None
        err_text: Optional[str] = None
        if error is not None:
            verdict, err_text = self._classify_error(error)
        with self._lock:
            self._requests += 1
            self._events_recorded += len(scratch.events)
            if verdict is None:
                if self.slo_ms is not None and duration_ms > self.slo_ms:
                    verdict = "slo_breach"
                else:
                    threshold = self._threshold.threshold()
                    if threshold is not None and duration_ms >= threshold:
                        verdict = "slow"
                    elif (self.baseline_ratio
                          and self._rng.random() < self.baseline_ratio):
                        verdict = "baseline"
                # only successful requests teach the slow threshold
                self._threshold.add(duration_ms)
            if verdict is None:
                self._dropped += 1
                self._commit_dropped_ns.append(
                    time.perf_counter_ns() - t0)
                return None
            timeline = FlightTimeline(
                self._next_seq(), verdict, scratch, end_ns, err_text)
            self._counts[verdict] += 1
            self._events_committed += len(timeline.events)
            self._truncated += timeline.truncated
            if len(self._ring) == self._ring.maxlen:
                self._evicted += 1
            self._ring.append(timeline)
            self._commit_retained_ns.append(time.perf_counter_ns() - t0)
        tap = self._commit_tap
        if tap is not None:
            try:
                tap(timeline)
            except Exception:
                pass  # a sick tap must never fail the request
        return verdict

    def commit_stream(self, span, error: Optional[BaseException] = None,
                      abandoned: bool = False) -> Optional[str]:
        """Settle one finished stream from its :class:`StreamSpan` (the
        streaming paths never hold a scratch open across the generator's
        life — a consumer could interleave unary calls on the same
        thread). The span's attempts and point events (reconnects!)
        synthesize the timeline; verdicts: error/shed as unary,
        ``disrupted`` for a reconnected-but-finished stream, ``slow``
        for a TTFT above the rolling stream threshold, else the baseline
        reservoir."""
        if not self.enabled:
            return None
        t0 = time.perf_counter_ns()
        verdict: Optional[str] = None
        err_text: Optional[str] = None
        if error is not None:
            verdict, err_text = self._classify_error(error)
        ttfts = span.ttft_ms_per_attempt()
        reconnects = len(span.attempts) - 1
        scratch = _Scratch(span.frontend, span.model, span.op,
                           self.max_events)
        scratch.start_ns = span.start_ns
        scratch.trace_id = span.trace_id
        scratch.trace_ids = [span.trace_id]
        for i, attempt in enumerate(span.attempts):
            scratch.events.append(
                (attempt.start_ns, "stream", "attempt",
                 {"attempt": i, "chunks": len(attempt.marks)}))
        for name, ts, attrs in (getattr(span, "events", None) or ()):
            scratch.events.append((ts, "stream", name, attrs))
        scratch.events.sort(key=lambda e: e[0])
        end_ns = getattr(span, "end_ns", 0) or t0
        duration_ms = (end_ns - span.start_ns) / 1e6
        with self._lock:
            self._requests += 1
            self._events_recorded += len(scratch.events)
            if verdict is None:
                if abandoned:
                    verdict = "error"
                    err_text = "abandoned by consumer"
                elif self.slo_ms is not None and duration_ms > self.slo_ms:
                    # the declared objective applies to streams too: a
                    # grossly-over-budget session is retained even when
                    # its TTFT was fast and nothing reconnected
                    verdict = "slo_breach"
                elif reconnects:
                    verdict = "disrupted"
                else:
                    threshold = self._stream_threshold.threshold()
                    if (ttfts and threshold is not None
                            and ttfts[0] >= threshold):
                        verdict = "slow"
                    elif (self.baseline_ratio
                          and self._rng.random() < self.baseline_ratio):
                        verdict = "baseline"
                if ttfts:
                    self._stream_threshold.add(ttfts[0])
            if verdict is None:
                self._dropped += 1
                self._commit_dropped_ns.append(
                    time.perf_counter_ns() - t0)
                return None
            timeline = FlightTimeline(
                self._next_seq(), verdict, scratch, end_ns, err_text)
            self._counts[verdict] += 1
            self._events_committed += len(timeline.events)
            if len(self._ring) == self._ring.maxlen:
                self._evicted += 1
            self._ring.append(timeline)
            self._commit_retained_ns.append(time.perf_counter_ns() - t0)
        tap = self._commit_tap
        if tap is not None:
            try:
                tap(timeline)
            except Exception:
                pass
        return verdict

    def set_commit_tap(
            self, tap: Optional[Callable[["FlightTimeline"], None]]) -> None:
        """Install (or clear, with None) the retained-timeline tap: called
        with every timeline the verdict keeps, after the ring append and
        outside the ring lock. With no tap the commit path pays one
        attribute load + branch. Exceptions from the tap are swallowed."""
        self._commit_tap = tap

    def mark(self, layer: str, event: str, **attrs) -> Optional[str]:
        """Retain one out-of-band single-event marker timeline (verdict
        ``mark``) with no request context — the watchtower records its
        ``watch.alert`` firing/resolved edges here so every alert is
        attributable next to the request timelines around it. Marks show
        in :meth:`last_anomalies` (they ARE worth explaining) but never
        count as tail evidence for :meth:`tail_divergence`."""
        if not self.enabled:
            return None
        now = time.perf_counter_ns()
        scratch = _Scratch("watch", "", event, self.max_events)
        scratch.start_ns = now
        scratch.events.append((now, layer, event, attrs or None))
        scratch.committed = True
        with self._lock:
            timeline = FlightTimeline(
                self._next_seq(), "mark", scratch, now, None)
            self._counts["mark"] += 1
            self._events_committed += 1
            if len(self._ring) == self._ring.maxlen:
                self._evicted += 1
            self._ring.append(timeline)
        return "mark"

    # -- read side -----------------------------------------------------------
    def retained(self, count: Optional[int] = None) -> List[FlightTimeline]:
        """The retained timelines, oldest first (a bounded snapshot)."""
        with self._lock:
            timelines = list(self._ring)
        if count is not None:
            timelines = timelines[-count:]
        return timelines

    def last_anomalies(self, count: int = 16) -> List[Dict[str, Any]]:
        """The newest ``count`` NON-baseline retained timelines (error/
        shed/slo_breach/slow/disrupted), newest first, as dicts — the
        "why were my last requests slow" accessor."""
        with self._lock:
            timelines = [t for t in self._ring if t.verdict != "baseline"]
        return [t.as_dict() for t in reversed(timelines[-count:])]

    def find(self, trace_id: str) -> Optional[FlightTimeline]:
        """The retained timeline containing ``trace_id`` (any wire span of
        the request — exemplar trace ids resolve here), if still in the
        ring."""
        with self._lock:
            for timeline in reversed(self._ring):
                if (timeline.trace_id == trace_id
                        or trace_id in timeline.trace_ids):
                    return timeline
        return None

    def bind(self, telemetry) -> None:
        """Attach to a Telemetry: export retained/dropped gauges on its
        registry at scrape time, and let :meth:`to_chrome_trace` merge
        with its tracer ring. Called by ``Telemetry(flight=...)``."""
        self._telemetry_ref = weakref.ref(telemetry)
        reg = telemetry.registry
        retained_g = reg.gauge(
            "client_tpu_flight_retained_total",
            "Flight timelines retained by the tail-based verdict",
            ("verdict",))
        dropped_g = reg.gauge(
            "client_tpu_flight_dropped_total",
            "Requests whose flight timeline was dropped wholesale "
            "(fast + healthy)")
        ring_g = reg.gauge(
            "client_tpu_flight_ring",
            "Retained timelines currently in the bounded ring")

        def collect() -> None:
            stats = self.stats()
            for verdict, n in stats["retained"].items():
                retained_g.labels(verdict).set(n)
            dropped_g.set(stats["dropped"])
            ring_g.set(stats["ring"])

        reg.add_collector(collect)

    def stats(self) -> Dict[str, Any]:
        """JSON-ready accounting incl. the commit-cost percentiles the
        perf harness emits as ``client_flight``."""
        from .utils import sorted_percentile

        with self._lock:
            retained_ns = sorted(self._commit_retained_ns)
            dropped_ns = sorted(self._commit_dropped_ns)
            counts = dict(self._counts)
            out: Dict[str, Any] = {
                "requests": self._requests,
                "retained": counts,
                "retained_total": sum(counts.values()),
                "dropped": self._dropped,
                "evicted": self._evicted,
                "ring": len(self._ring),
                "capacity": self.capacity,
                "events_recorded": self._events_recorded,
                "events_committed": self._events_committed,
                "truncated_events": self._truncated,
                "slow_threshold_ms": self._threshold.threshold(),
            }
        out["retained_fraction"] = (
            round(out["retained_total"] / out["requests"], 6)
            if out["requests"] else 0.0)
        out["events_per_request"] = (
            round(out["events_recorded"] / out["requests"], 3)
            if out["requests"] else 0.0)
        for label, samples in (("commit_retained_ns", retained_ns),
                               ("commit_dropped_ns", dropped_ns)):
            if samples:
                out[label] = {
                    "p50": round(sorted_percentile(samples, 0.5), 1),
                    "p99": round(sorted_percentile(samples, 0.99), 1),
                }
        return out

    # -- anomaly detection ----------------------------------------------------
    def tail_divergence(self, min_tail: int = 8,
                        min_share: float = 0.6) -> Optional[Dict[str, Any]]:
        """Do the retained TAIL timelines (slow/slo_breach) share one
        dominant attribution key that the baseline/median traffic does
        not? That shape — "every slow request spent its time in the same
        layer (or behind the same endpoint), the typical request did
        not" — is the classic one-bad-replica / one-hot-lock signature.

        Returns None when there is no divergence (or not enough tail
        evidence); else a dict naming the dominant key, its tail share
        and the baseline share — the doctor surfaces it as the
        ``tail_divergence`` anomaly."""
        with self._lock:
            timelines = list(self._ring)
        tail = [t for t in timelines
                if t.verdict in ("slow", "slo_breach")]
        if len(tail) < min_tail:
            return None
        base = [t for t in timelines if t.verdict == "baseline"]

        def dominants(group: List[FlightTimeline]) -> Dict[str, int]:
            counts: Dict[str, int] = {}
            for t in group:
                key = t.attribution()["dominant"]
                if key is not None:
                    counts[key] = counts.get(key, 0) + 1
            return counts

        tail_counts = dominants(tail)
        if not tail_counts:
            return None
        key = max(tail_counts, key=tail_counts.get)
        tail_share = tail_counts[key] / len(tail)
        if tail_share < min_share:
            return None
        base_counts = dominants(base)
        base_share = (base_counts.get(key, 0) / len(base)) if base else 0.0
        # the tail concentrating where the median does NOT is the signal;
        # when baseline traffic concentrates in the same place the slow
        # tail is just "everything is slow", not a divergence
        if base and base_share >= tail_share / 2.0:
            return None
        return {
            "dominant": key,
            "tail_count": len(tail),
            "tail_share": round(tail_share, 4),
            "baseline_count": len(base),
            "baseline_share": round(base_share, 4),
        }

    # -- exporters -------------------------------------------------------------
    def to_chrome_trace(self, tracer=None) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON over the retained timelines: one
        complete ("X") event per retained request, instant ("i") events
        per flight event, MERGED with the phase intervals of every
        :class:`~client_tpu_torch.observe.RequestSpan` in the tracer ring whose
        trace id belongs to a retained timeline (``tracer`` defaults to
        the bound Telemetry's). Events are emitted sorted by timestamp —
        the same contract as ``Tracer.chrome_trace``."""
        if tracer is None and self._telemetry_ref is not None:
            telemetry = self._telemetry_ref()
            if telemetry is not None:
                tracer = telemetry.tracer
        timelines = self.retained()
        events: List[Dict[str, Any]] = []
        by_trace: Dict[str, int] = {}
        for timeline in timelines:
            tid = timeline.seq
            for trace_id in timeline.trace_ids:
                by_trace[trace_id] = tid
            name = f"{timeline.op} {timeline.model}".strip()
            events.append({
                "name": f"{name} [{timeline.verdict}]",
                "cat": timeline.frontend or "flight", "ph": "X",
                "ts": timeline.start_ns / 1e3,
                "dur": max(timeline.end_ns - timeline.start_ns, 0) / 1e3,
                "pid": 1, "tid": tid,
                "args": {"trace_id": timeline.trace_id,
                         "verdict": timeline.verdict,
                         "error": timeline.error},
            })
            for ts, layer, event, attrs in timeline.events:
                events.append({
                    "name": f"{layer}.{event}", "cat": layer, "ph": "i",
                    "ts": ts / 1e3, "s": "t", "pid": 1, "tid": tid,
                    "args": attrs or {},
                })
        if tracer is not None:
            with tracer._lock:
                spans = list(tracer._ring)
            for span in spans:
                tid = by_trace.get(span.trace_id)
                if tid is None:
                    continue
                for pname, s, e in span.phases:
                    events.append({
                        "name": pname, "cat": "phase", "ph": "X",
                        "ts": s / 1e3, "dur": max(e - s, 0) / 1e3,
                        "pid": 1, "tid": tid,
                        "args": {"trace_id": span.trace_id},
                    })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_jsonl(self, path: Optional[str] = None) -> Any:
        """The retained timelines as JSON-lines (one timeline per line,
        oldest first). Returns the string, or the timeline count when
        ``path`` is given (written atomically enough for a postmortem:
        one open/write/close)."""
        lines = [json.dumps(t.as_dict(), separators=(",", ":"))
                 for t in self.retained()]
        text = "\n".join(lines) + ("\n" if lines else "")
        if path is None:
            return text
        with open(path, "w") as f:
            f.write(text)
        return len(lines)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
