"""Client-side observability: request-phase tracing, metrics, propagation.

The reference client can only *configure* server-side tracing
(``update_trace_settings``) — the client itself is a black box, which is
exactly where production debugging of a KServe v2 data plane happens (is
the latency in serialize, connect, TTFB, or deserialize?). This module is
the consumer for the structured events the other layers emit (retry
callbacks, breaker transitions, ``PoolEvent``s) and the phase timers the
frontends already capture:

- :class:`Tracer` + :class:`RequestSpan` — a monotonic per-request phase
  timeline (queue → serialize → connect/acquire → send → first-byte →
  recv → deserialize, plus retry-attempt and hedge sub-spans) with
  ``always`` / ``ratio`` / ``slow``-only sampling and a ring buffer of
  recent traces dumpable as Chrome ``trace_event`` JSON
  (``chrome://tracing`` / Perfetto load it directly).
- :class:`MetricsRegistry` — counters, gauges and fixed-bucket latency
  histograms with lock-cheap hot-path increments, rendered as Prometheus
  text exposition (``prometheus_text``) or a JSON snapshot
  (``snapshot``).
- W3C trace context propagation — :func:`format_traceparent` /
  :func:`parse_traceparent`; every frontend injects a ``traceparent``
  header (HTTP) or metadata key (GRPC) when a telemetry object is
  configured, and the in-repo servers honor it by recording a
  server-side access record joined on the same trace id (see
  ``ServerCore.access_records`` and the servers' ``/metrics`` route).
- :class:`Telemetry` — the facade a client/pool/policy shares via
  ``InferenceServerClientBase.configure_telemetry``: pre-wired
  request/error/retry/breaker/ejection/hedge metrics fed by the existing
  resilience and pool event streams.
- :class:`StreamSpan` + :class:`WindowedSketch` + :class:`SLO` — the
  streaming layer: token-level stream tracing (open -> per-attempt TTFT
  -> per-chunk marks -> close/error/reconnect; the hot path is one
  timestamp append per chunk), sliding-window quantile sketches merged
  at scrape time into ``ttft_ms``/``itl_ms``/``stream_duration_ms``
  windowed gauges, and declared SLOs (burn rate + breach gauges). See
  docs/observability.md "Streaming & SLOs".

Pay-for-what-you-use: with no telemetry configured the frontends' hot
paths check one attribute and do nothing else (~0 overhead); with
telemetry enabled the per-call cost is bounded by a handful of
pre-resolved label lookups and one registry-lock critical section
(``chip_smoke.py`` measures the clients' hook cost on the GPU).
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import json
import re
import random
import threading
import time
import weakref
from bisect import bisect_left, bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import flight as _flight

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_S",
    "DEFAULT_STREAM_MS_BUCKETS",
    "ENDPOINT_LOAD_FORMAT_HEADER",
    "ENDPOINT_LOAD_HEADER",
    "SHM_FAMILIES",
    "TRACEPARENT_HEADER",
    "Counter",
    "DataPlaneRecorder",
    "EndpointLoad",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RequestSpan",
    "SLO",
    "SLOSpec",
    "StatsCorrelator",
    "StreamSpan",
    "Telemetry",
    "Tracer",
    "WindowedSketch",
    "accepts_client_timeout",
    "dataplane",
    "enable_dataplane",
    "format_traceparent",
    "install_dataplane",
    "make_span_id",
    "make_trace_id",
    "parse_endpoint_load",
    "parse_slo_spec",
    "parse_traceparent",
]

# -- W3C trace context --------------------------------------------------------
TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

_id_rng = random.Random()  # module-level: ids must differ across Telemetry objects


def make_trace_id(rng: Optional[random.Random] = None) -> str:
    """A 16-byte lowercase-hex W3C trace id (never all-zero)."""
    r = rng or _id_rng
    return f"{r.getrandbits(128) or 1:032x}"


def make_span_id(rng: Optional[random.Random] = None) -> str:
    """An 8-byte lowercase-hex W3C span (parent) id (never all-zero)."""
    r = rng or _id_rng
    return f"{r.getrandbits(64) or 1:016x}"


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(value: Optional[str]):
    """``(trace_id, parent_span_id, sampled)`` or None when malformed.

    Per the W3C spec: version ``ff`` and all-zero trace/span ids are
    invalid; unknown flag bits are ignored beyond the sampled bit."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 1)


# -- metrics ------------------------------------------------------------------
# Fixed latency buckets (seconds): 100 µs .. 10 s, roughly 1-2.5-5 decades —
# wide enough for localhost shm round trips and cold-compile outliers alike.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _percentile_row(values: Sequence[float],
                    percentiles: Sequence[float] = (0.5, 0.99),
                    ) -> Dict[str, float]:
    """count/avg/pN summary of exact samples — the one percentile-index
    convention every breakdown (phase, stream, span dump) shares."""
    from .utils import sorted_percentile

    s = sorted(values)
    row: Dict[str, float] = {"count": len(s)}
    if not s:
        return row
    row["avg"] = round(sum(s) / len(s), 4)
    for q in percentiles:
        row[f"p{int(q * 100)}"] = round(sorted_percentile(s, q), 4)
    return row


class _Series:
    """One labeled time series. Mutations take the registry's shared lock
    (one uncontended acquire per op — "lock-cheap"); the ``_``-prefixed
    unlocked primitives exist so :meth:`Telemetry.finish` can batch a whole
    request's updates under a single acquire."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def _inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def _set(self, value: float) -> None:
        self.value = value

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def get(self) -> float:
        return self.value  # single-slot read: no lock needed


class _HistogramSeries:
    """One labeled histogram: cumulative-on-render fixed buckets + sum/count.

    ``exemplars`` (allocated lazily, only when the owning registry opted
    in) holds the LAST ``(trace_id, value, unix_ts)`` observed per bucket
    — the OpenMetrics-exemplar link from a dashboard bucket straight to a
    retained flight timeline."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, lock: threading.Lock, buckets: Sequence[float]):
        self._lock = lock
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.exemplars: Optional[List[Optional[Tuple[str, float, float]]]] \
            = None

    def _exemplar(self, idx: int, trace_id: str, value: float) -> None:
        """Record one exemplar on bucket ``idx`` (caller holds the lock)."""
        if self.exemplars is None:
            self.exemplars = [None] * (len(self.buckets) + 1)
        self.exemplars[idx] = (trace_id, value, time.time())

    def observe(self, value: float) -> None:
        with self._lock:
            self._observe(value)

    def _observe(self, value: float) -> None:
        self.counts[bisect_right(self.buckets, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation inside the owning
        bucket (the usual histogram_quantile estimate). Values beyond the
        last finite edge clamp to it."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        lower = 0.0
        for i, edge in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= rank:
                frac = (rank - prev) / max(counts[i], 1)
                return lower + (edge - lower) * min(max(frac, 0.0), 1.0)
            lower = edge
        return self.buckets[-1] if self.buckets else lower


# label value the cardinality guard aggregates overflowing series into
OVERFLOW_LABEL = "other"


class _Metric:
    """Shared labeled-family machinery for the three instrument kinds."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r}")
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _new_series(self):
        raise NotImplementedError

    def labels(self, *values) -> Any:
        """The series for one label-value tuple (created on first use and
        cached — callers are expected to hold on to hot series).

        Cardinality guard: once this instrument holds the registry's
        ``max_series_per_metric`` distinct label-sets, NEW label-sets are
        not materialized — they aggregate into one ``other`` series (every
        label value :data:`OVERFLOW_LABEL`) and bump the registry's
        dropped-labelsets counter, so unbounded label sources (region
        names, URLs) can never blow up the scrape."""
        return self._resolve(values, fold_overflow=True)

    def try_labels(self, *values) -> Optional[Any]:
        """Like :meth:`labels`, but returns None (still counting the drop)
        when the cardinality cap would fold the label-set into the
        ``other`` series — for instruments where an aggregated value is
        meaningless (per-entity gauges like the ORCA load: a last-writer-
        wins mix of endpoints would also be unremovable by TTL expiry)."""
        return self._resolve(values, fold_overflow=False)

    def _resolve(self, values, fold_overflow: bool,
                 note_drop: bool = True) -> Optional[Any]:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {key}")
        series = self._series.get(key)
        if series is None:
            dropped = False
            with self._registry._lock:
                series = self._series.get(key)
                if series is None:
                    limit = self._registry.max_series_per_metric
                    if (limit and self.labelnames
                            and len(self._series) >= limit):
                        dropped = True
                        if fold_overflow:
                            key = (OVERFLOW_LABEL,) * len(self.labelnames)
                            series = self._series.get(key)
                    if series is None and (fold_overflow or not dropped):
                        series = self._new_series()
                        self._series[key] = series
            if dropped and note_drop:
                # outside the registry lock: the dropped counter may need
                # to be created, which re-enters _instrument
                self._registry._note_dropped_labelset(self.name)
        return series

    def remove(self, *values) -> bool:
        """Drop one label-set's series (stale-endpoint gauge expiry);
        True when a series was actually removed."""
        key = tuple(str(v) for v in values)
        with self._registry._lock:
            return self._series.pop(key, None) is not None

    def _default(self):
        """The unlabeled series (metrics declared with no label names)."""
        return self.labels()


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return _Series(self._registry._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def get(self) -> float:
        return self._default().get()


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return _Series(self._registry._lock)

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def get(self) -> float:
        return self._default().get()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        super().__init__(registry, name, help, labelnames)
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if len(set(edges)) != len(edges):
            raise ValueError("histogram bucket edges must be distinct")
        self.buckets = edges

    def _new_series(self):
        return _HistogramSeries(self._registry._lock, self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)


class MetricsRegistry:
    """A process-local metric registry with Prometheus + JSON exporters.

    Instruments are created idempotently (asking for an existing name
    returns the existing instrument; a kind/label mismatch raises).
    ``add_collector`` registers a callback run before every export — the
    pool uses it to refresh per-endpoint gauges at scrape time instead of
    on the data path.

    ``max_series_per_metric`` caps the distinct label-sets any one
    instrument may hold (0 disables the cap): past it, new label-sets
    fold into a single ``other`` series and
    ``client_tpu_metrics_dropped_labelsets_total{metric}`` counts the
    overflow resolutions.

    ``exemplars=True`` opts in to OpenMetrics-style exemplars: histogram
    bucket lines grow a `` # {trace_id="..."} value ts`` suffix carrying
    the last trace id observed in that bucket (the request/TTFT
    histograms populate them from the active span), linking any
    dashboard bucket straight to a retained flight timeline
    (``FlightRecorder.find(trace_id)``). Off by default — the plain
    0.0.4 text exposition stays byte-compatible with strict parsers."""

    def __init__(self, max_series_per_metric: int = 512,
                 exemplars: bool = False):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []
        # scrape-drain hooks: called with the finished snapshot dict at
        # the end of every snapshot() — the watchtower's black box drains
        # metric state to disk through this. Empty list = one branch.
        self._drains: List[Callable[[Dict[str, Any]], None]] = []
        self.max_series_per_metric = max(0, int(max_series_per_metric))
        self.exemplars = bool(exemplars)
        self._dropped_labelsets: Optional[Counter] = None

    def _note_dropped_labelset(self, metric_name: str) -> None:
        # created lazily OUTSIDE the registry lock (counter creation
        # re-enters _instrument); races create it idempotently
        counter = self._dropped_labelsets
        if counter is None:
            counter = self._dropped_labelsets = self.counter(
                "client_tpu_metrics_dropped_labelsets_total",
                "Label-set resolutions folded into the 'other' overflow "
                "series by the cardinality guard", ("metric",))
        # note_drop=False: if this counter is itself at the cap, its own
        # overflow fold must not re-note the drop — that recursed forever
        counter._resolve((metric_name,), fold_overflow=True,
                         note_drop=False).inc()

    def _instrument(self, cls, name, help, labelnames, **kwargs) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different kind or labels")
                return existing
        metric = cls(self, name, help, labelnames, **kwargs)
        with self._lock:
            return self._metrics.setdefault(name, metric)

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._instrument(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._instrument(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  ) -> Histogram:
        return self._instrument(
            Histogram, name, help, labelnames, buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def add_drain(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Register a scrape-drain hook: called (outside the registry
        lock, exceptions swallowed) with the snapshot dict at the end of
        every :meth:`snapshot`. The watchtower's crash-safe black box
        subscribes here so metric state survives a ``kill -9``; with no
        drains registered the cost is one empty-list branch."""
        with self._lock:
            self._drains.append(fn)

    def remove_drain(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            try:
                self._drains.remove(fn)
            except ValueError:
                pass

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:  # outside the lock: collectors set gauges
            try:
                fn()
            except Exception:
                pass  # an exporter must never break on a sick collector

    # -- exporters -----------------------------------------------------------
    @staticmethod
    def _exemplar_text(exemplars, idx: int) -> str:
        """The OpenMetrics `` # {trace_id="..."} value ts`` bucket-line
        suffix (empty when exemplars are off or this bucket has none)."""
        if exemplars is None:
            return ""
        entry = exemplars[idx]
        if entry is None:
            return ""
        trace_id, value, ts = entry
        return (f' # {{trace_id="{_escape_label(trace_id)}"}} '
                f"{_fmt_value(value)} {ts:.3f}")

    @staticmethod
    def _labels_text(labelnames, key, extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4). Histogram buckets are
        cumulative and ``+Inf``-terminated, with ``_sum``/``_count``."""
        self._run_collectors()
        lines: List[str] = []
        with self._lock:
            for metric in self._metrics.values():
                if not metric._series:
                    continue
                if metric.help:
                    lines.append(f"# HELP {metric.name} {metric.help}")
                lines.append(f"# TYPE {metric.name} {metric.kind}")
                for key in sorted(metric._series):
                    series = metric._series[key]
                    if metric.kind == "histogram":
                        exemplars = (series.exemplars
                                     if self.exemplars else None)
                        cum = 0
                        for i, (edge, n) in enumerate(
                                zip(series.buckets, series.counts)):
                            cum += n
                            labels = self._labels_text(
                                metric.labelnames, key,
                                f'le="{_fmt_value(edge)}"')
                            lines.append(
                                f"{metric.name}_bucket{labels} {cum}"
                                + self._exemplar_text(exemplars, i))
                        labels = self._labels_text(
                            metric.labelnames, key, 'le="+Inf"')
                        lines.append(
                            f"{metric.name}_bucket{labels} {series.count}"
                            + self._exemplar_text(
                                exemplars, len(series.buckets)))
                        base = self._labels_text(metric.labelnames, key)
                        lines.append(
                            f"{metric.name}_sum{base} "
                            f"{_fmt_value(series.sum)}")
                        lines.append(f"{metric.name}_count{base} "
                                     f"{series.count}")
                    else:
                        labels = self._labels_text(metric.labelnames, key)
                        lines.append(
                            f"{metric.name}{labels} "
                            f"{_fmt_value(series.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-ready snapshot (plain dict/list/str/number values only, so
        ``json.loads(json.dumps(snapshot)) == snapshot``)."""
        self._run_collectors()
        out: Dict[str, Any] = {}
        with self._lock:
            for metric in self._metrics.values():
                series_out = []
                for key in sorted(metric._series):
                    series = metric._series[key]
                    labels = dict(zip(metric.labelnames, key))
                    if metric.kind == "histogram":
                        cum = 0
                        buckets = []
                        for edge, n in zip(series.buckets, series.counts):
                            cum += n
                            buckets.append({"le": edge, "count": cum})
                        buckets.append({"le": "+Inf", "count": series.count})
                        row = {
                            "labels": labels,
                            "count": series.count,
                            "sum": series.sum,
                            "buckets": buckets,
                        }
                        if self.exemplars and series.exemplars:
                            edges = list(series.buckets) + ["+Inf"]
                            row["exemplars"] = [
                                {"le": edges[i], "trace_id": ex[0],
                                 "value": ex[1], "ts": ex[2]}
                                for i, ex in enumerate(series.exemplars)
                                if ex is not None
                            ]
                        series_out.append(row)
                    else:
                        series_out.append(
                            {"labels": labels, "value": series.value})
                out[metric.name] = {
                    "kind": metric.kind,
                    "help": metric.help,
                    "series": series_out,
                }
        if self._drains:
            for fn in list(self._drains):
                try:
                    fn(out)
                except Exception:
                    pass  # a sick drain must never break the scrape
        return out

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        """Rebuild a registry from a :meth:`snapshot` dict so that
        ``MetricsRegistry.from_snapshot(s).snapshot() == s`` — the
        offline half of the black-box metrics drain: a postmortem (or
        ``doctor --blackbox``) reloads the last scraped state into real
        instruments and queries them as if the process were alive.
        Histogram bucket edges are recovered from the cumulative bucket
        rows (``+Inf`` excluded) and the per-bucket counts decumulated;
        exemplars restore when present. The restored registry has no
        cardinality cap (it holds exactly the series the snapshot did —
        a second fold would corrupt the parity contract)."""
        exemplars = any(
            "exemplars" in row
            for doc in snap.values() for row in doc.get("series", ()))
        reg = cls(max_series_per_metric=0, exemplars=exemplars)
        for name, doc in snap.items():
            kind = doc.get("kind", "untyped")
            help_text = doc.get("help", "")
            series = doc.get("series", [])
            labelnames = tuple(series[0]["labels"]) if series else ()
            if kind == "histogram":
                if series:
                    edges = tuple(float(b["le"])
                                  for b in series[0]["buckets"]
                                  if b["le"] != "+Inf")
                else:
                    edges = DEFAULT_LATENCY_BUCKETS_S
                metric = reg.histogram(name, help_text, labelnames,
                                       buckets=edges)
                for row in series:
                    s = metric.labels(*(row["labels"][n]
                                        for n in labelnames))
                    finite = [b for b in row["buckets"]
                              if b["le"] != "+Inf"]
                    counts = []
                    cum_prev = 0
                    for b in finite:
                        counts.append(int(b["count"]) - cum_prev)
                        cum_prev = int(b["count"])
                    counts.append(int(row["count"]) - cum_prev)
                    s.counts = counts
                    s.sum = float(row["sum"])
                    s.count = int(row["count"])
                    for ex in row.get("exemplars", ()):
                        if s.exemplars is None:
                            s.exemplars = [None] * (len(edges) + 1)
                        idx = (len(edges) if ex["le"] == "+Inf"
                               else list(edges).index(float(ex["le"])))
                        s.exemplars[idx] = (ex["trace_id"], ex["value"],
                                            ex["ts"])
            else:
                factory = reg.gauge if kind == "gauge" else reg.counter
                metric = factory(name, help_text, labelnames)
                for row in series:
                    s = metric.labels(*(row["labels"][n]
                                        for n in labelnames))
                    s.value = float(row["value"])
        return reg


# -- data-plane (shm lifecycle) accounting ------------------------------------
# The byte-level data plane: shared-memory regions created, attached,
# read/written and destroyed by utils.shared_memory / utils.cuda_shared_memory,
# plus the register/unregister RPCs the frontends issue against the server.
# "tpu" is the JAX package's device family; the families stay the same three
# so both packages render the same exposition
SHM_FAMILIES = ("system", "tpu", "cuda")


class _FamilyBinding:
    """Pre-resolved per-family series so one shm op is dict-lookup-free."""

    __slots__ = ("create", "attach", "map_read", "map_write", "destroy",
                 "regions", "bytes_resident", "bytes_peak")

    def __init__(self, rec: "DataPlaneRecorder", family: str):
        self.create = rec.ops.labels(family, "create")
        self.attach = rec.ops.labels(family, "attach")
        self.map_read = rec.ops.labels(family, "map_read")
        self.map_write = rec.ops.labels(family, "map_write")
        self.destroy = rec.ops.labels(family, "destroy")
        self.regions = rec.regions.labels(family)
        self.bytes_resident = rec.bytes_resident.labels(family)
        self.bytes_peak = rec.bytes_peak.labels(family)


class DataPlaneRecorder:
    """shm lifecycle accounting: region create/attach/map/destroy counters,
    bytes-resident/peak gauges, and register/unregister RPC latency.

    The shm utils are module-level (regions are process-global state, not
    client-bound), so the recorder is installed process-globally via
    :func:`install_dataplane` / :func:`enable_dataplane` /
    ``Telemetry.enable_dataplane``. The shm modules' hot paths check one
    module attribute against None and do nothing else when no recorder is
    installed (the same pay-for-what-you-use bar as request telemetry);
    with a recorder installed each op batches its counter/gauge updates
    under ONE registry-lock acquire.

    This is the measure-before-you-optimize baseline for pooled shm
    arenas (ROADMAP item 1): the per-use-site churn the arena will
    eliminate is a committed number, not a hunch."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry or MetricsRegistry()
        self.registry = reg
        self._lock = reg._lock  # all series share it: one acquire per op
        self.ops = reg.counter(
            "client_tpu_shm_ops_total",
            "Shared-memory lifecycle operations "
            "(create/attach/map_read/map_write/destroy)",
            ("family", "op"))
        self.regions = reg.gauge(
            "client_tpu_shm_regions",
            "Shared-memory regions currently held by this process",
            ("family",))
        self.bytes_resident = reg.gauge(
            "client_tpu_shm_bytes_resident",
            "Bytes currently resident in held shared-memory regions",
            ("family",))
        self.bytes_peak = reg.gauge(
            "client_tpu_shm_bytes_peak",
            "High-water mark of resident shared-memory bytes", ("family",))
        self.rpc_seconds = reg.histogram(
            "client_tpu_shm_registration_seconds",
            "Client-observed latency of shm register/unregister RPCs",
            ("frontend", "family", "op"))
        self.rpcs = reg.counter(
            "client_tpu_shm_rpcs_total",
            "shm register/unregister RPCs by outcome",
            ("frontend", "family", "op", "outcome"))
        # arena accounting (client_tpu_torch.arena): slab lease hit/miss, leased/
        # free bytes per size class, and registration-cache outcomes —
        # cached-vs-issued is THE number proving registration RPCs/req -> 0
        self.arena_leases = reg.counter(
            "client_tpu_arena_leases_total",
            "Arena slab leases (hit = served from a free slab; "
            "miss = a new region was carved)",
            ("family", "class", "outcome"))
        self.arena_bytes = reg.gauge(
            "client_tpu_arena_bytes",
            "Arena bytes by size class and state (leased/free)",
            ("family", "class", "state"))
        self.arena_registrations = reg.counter(
            "client_tpu_arena_registrations_total",
            "Arena registration-cache outcomes "
            "(issued = RPC sent; cached = served without network; "
            "invalidated = entry dropped on ejection/unregister)",
            ("outcome",))
        self._families = {f: _FamilyBinding(self, f) for f in SHM_FAMILIES}
        # (frontend, family, op, ok) -> (histogram series, counter series)
        self._rpc_cache: Dict[Tuple[str, str, str, bool], Tuple[Any, Any]] = {}
        # (family, class) -> (hit ctr, miss ctr, leased gauge, free gauge)
        self._arena_cache: Dict[Tuple[str, int], Tuple[Any, Any, Any, Any]] = {}
        self._arena_reg_cache: Dict[str, Any] = {}
        # handle identity -> recorded nbytes, for regions whose create/
        # attach THIS recorder saw (destroys of older regions skip the
        # residency decrement instead of stealing it from live ones)
        self._live: Dict[int, int] = {}
        self.started_monotonic = time.monotonic()

    # -- region ops (fed by the shm utils; one lock acquire each) ------------
    def on_create(self, family: str, nbytes: int,
                  key: Optional[int] = None) -> None:
        f = self._families[family]
        with self._lock:
            f.create.value += 1
            f.regions.value += 1
            f.bytes_resident.value += nbytes
            if f.bytes_resident.value > f.bytes_peak.value:
                f.bytes_peak.value = f.bytes_resident.value
            if key is not None:
                self._live[key] = nbytes

    def on_attach(self, family: str, nbytes: int,
                  key: Optional[int] = None) -> None:
        # an attach maps the region into THIS process too: it is resident
        # here until its handle is destroyed/detached
        f = self._families[family]
        with self._lock:
            f.attach.value += 1
            f.regions.value += 1
            f.bytes_resident.value += nbytes
            if f.bytes_resident.value > f.bytes_peak.value:
                f.bytes_peak.value = f.bytes_resident.value
            if key is not None:
                self._live[key] = nbytes

    def on_map(self, family: str, write: bool) -> None:
        f = self._families[family]
        with self._lock:
            (f.map_write if write else f.map_read).value += 1

    def on_destroy(self, family: str, nbytes: int,
                   key: Optional[int] = None) -> None:
        f = self._families[family]
        with self._lock:
            f.destroy.value += 1
            if key is not None:
                recorded = self._live.pop(key, None)
                if recorded is None:
                    # region predates this recorder (installed mid-process):
                    # its create was never counted, so its destroy must not
                    # shrink the residency other live regions account for
                    return
                nbytes = recorded
            # clamp at zero for key-less callers: a destroy with no
            # matching on_create must not drive the gauges negative
            f.regions.value = max(f.regions.value - 1, 0)
            f.bytes_resident.value = max(f.bytes_resident.value - nbytes, 0)

    # -- register/unregister RPCs (fed by the four frontends) ----------------
    def on_rpc(self, frontend: str, family: str, op: str, seconds: float,
               ok: bool = True) -> None:
        key = (frontend, family, op, ok)
        cached = self._rpc_cache.get(key)
        if cached is None:
            cached = (self.rpc_seconds.labels(frontend, family, op),
                      self.rpcs.labels(frontend, family, op,
                                       "ok" if ok else "error"))
            self._rpc_cache[key] = cached
        hist, counter = cached
        with self._lock:
            hist._observe(seconds)
            counter.value += 1

    # -- arena ops (fed by client_tpu_torch.arena; one lock acquire each) ----------
    def _arena_series(self, family: str, class_bytes: int):
        key = (family, class_bytes)
        cached = self._arena_cache.get(key)
        if cached is None:
            label = str(class_bytes)
            made = (self.arena_leases.labels(family, label, "hit"),
                    self.arena_leases.labels(family, label, "miss"),
                    self.arena_bytes.labels(family, label, "leased"),
                    self.arena_bytes.labels(family, label, "free"))
            # insert under the registry lock: snapshot() iterates this dict
            # under the same lock, so a first lease of a new class must not
            # mutate it mid-iteration (labels() manages its own locking and
            # is called before the acquire — never nested)
            with self._lock:
                cached = self._arena_cache.setdefault(key, made)
        return cached

    def on_arena_lease(self, family: str, class_bytes: int, hit: bool) -> None:
        hit_c, miss_c, leased_g, free_g = self._arena_series(family, class_bytes)
        with self._lock:
            (hit_c if hit else miss_c).value += 1
            leased_g.value += class_bytes
            free_g.value = max(free_g.value - class_bytes, 0)

    def on_arena_release(self, family: str, class_bytes: int) -> None:
        _, _, leased_g, free_g = self._arena_series(family, class_bytes)
        with self._lock:
            leased_g.value = max(leased_g.value - class_bytes, 0)
            free_g.value += class_bytes

    def on_arena_carve(self, family: str, class_bytes: int,
                       slab_count: int) -> None:
        """A new region was carved into ``slab_count`` free slabs."""
        _, _, _, free_g = self._arena_series(family, class_bytes)
        with self._lock:
            free_g.value += class_bytes * slab_count

    def on_arena_trim(self, family: str, class_bytes: int,
                      slab_count: int) -> None:
        """A fully-free region was destroyed (its slabs leave the pool)."""
        _, _, _, free_g = self._arena_series(family, class_bytes)
        with self._lock:
            free_g.value = max(free_g.value - class_bytes * slab_count, 0)

    def on_arena_registration(self, outcome: str) -> None:
        series = self._arena_reg_cache.get(outcome)
        if series is None:
            made = self.arena_registrations.labels(outcome)
            with self._lock:
                series = self._arena_reg_cache.setdefault(outcome, made)
        with self._lock:
            series.value += 1

    # -- read side -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready per-family accounting + RPC totals + churn rate."""
        elapsed = max(time.monotonic() - self.started_monotonic, 1e-9)
        out: Dict[str, Any] = {"elapsed_s": round(elapsed, 3)}
        families: Dict[str, Any] = {}
        total_ops = 0
        with self._lock:
            for name, f in self._families.items():
                ops = (f.create.value + f.attach.value + f.map_read.value
                       + f.map_write.value + f.destroy.value)
                total_ops += ops
                families[name] = {
                    "created": f.create.value,
                    "attached": f.attach.value,
                    "map_reads": f.map_read.value,
                    "map_writes": f.map_write.value,
                    "destroyed": f.destroy.value,
                    "regions": f.regions.value,
                    "bytes_resident": f.bytes_resident.value,
                    "bytes_peak": f.bytes_peak.value,
                }
            rpcs: Dict[str, float] = {}
            for key, series in self.rpcs._series.items():
                _, family, op, outcome = key
                label = f"{family}.{op}.{outcome}"
                rpcs[label] = rpcs.get(label, 0.0) + series.value
                total_ops += series.value
            arena: Dict[str, Any] = {
                "leases": {}, "bytes": {}, "registrations": {}}
            for (family, class_bytes), (hit_c, miss_c, leased_g, free_g) \
                    in self._arena_cache.items():
                arena["leases"][f"{family}.{class_bytes}"] = {
                    "hits": hit_c.value, "misses": miss_c.value}
                arena["bytes"][f"{family}.{class_bytes}"] = {
                    "leased": leased_g.value, "free": free_g.value}
            for outcome, series in self._arena_reg_cache.items():
                arena["registrations"][outcome] = series.value
        out["families"] = families
        out["rpcs"] = rpcs
        if arena["leases"] or arena["registrations"]:
            out["arena"] = arena
        out["churn_ops_per_s"] = round(total_ops / elapsed, 3)
        return out

    def registered_totals(self) -> Dict[str, float]:
        """Per-family successful register RPC counts (perf-row helper)."""
        totals: Dict[str, float] = {}
        with self._lock:
            for key, series in self.rpcs._series.items():
                _, family, op, outcome = key
                if op == "register" and outcome == "ok":
                    totals[family] = totals.get(family, 0.0) + series.value
        return totals


# the process-global recorder the shm utils and frontends consult; None
# keeps their hot paths at one attribute load + None check
_DATAPLANE: Optional[DataPlaneRecorder] = None


def dataplane() -> Optional[DataPlaneRecorder]:
    """The installed process-global data-plane recorder, if any."""
    return _DATAPLANE


def install_dataplane(
        recorder: Optional[DataPlaneRecorder]) -> Optional[DataPlaneRecorder]:
    """Install (or clear, with None) the process-global recorder; returns
    the previous one so scoped users (perf runs, tests) can restore it."""
    global _DATAPLANE
    previous = _DATAPLANE
    _DATAPLANE = recorder
    return previous


def enable_dataplane(
        registry: Optional[MetricsRegistry] = None) -> DataPlaneRecorder:
    """Create a :class:`DataPlaneRecorder` on ``registry`` (or a fresh
    one) and install it process-globally; returns the recorder."""
    recorder = DataPlaneRecorder(registry)
    install_dataplane(recorder)
    return recorder


# -- ORCA endpoint load ingestion ---------------------------------------------
# The server emits per-response load metrics in the ORCA ``endpoint-load-
# metrics`` response header (json or text form) when the client opts in via
# the ``endpoint-load-metrics-format`` request header; parsing them into a
# typed EndpointLoad is the observability half of load-aware routing
# (ROADMAP item 2 — routing on these stays there).
ENDPOINT_LOAD_HEADER = "endpoint-load-metrics"
ENDPOINT_LOAD_FORMAT_HEADER = "endpoint-load-metrics-format"

_ORCA_FORMATS = (None, "json", "text")


class EndpointLoad:
    """One parsed ORCA load report: a flat ``{metric: float}`` mapping
    (nested maps like ``named_metrics`` flatten to dotted keys)."""

    __slots__ = ("metrics", "format", "received_monotonic")

    def __init__(self, metrics: Dict[str, float], format: str):
        self.metrics = metrics
        self.format = format
        self.received_monotonic = time.monotonic()

    def get(self, name: str, default: Optional[float] = None):
        return self.metrics.get(name, default)

    def age_s(self) -> float:
        return max(time.monotonic() - self.received_monotonic, 0.0)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "metrics": dict(self.metrics),
            "format": self.format,
            "age_s": round(self.age_s(), 3),
        }

    def __repr__(self) -> str:
        return f"EndpointLoad({self.metrics!r}, format={self.format!r})"


def _load_value(value) -> Optional[float]:
    if isinstance(value, bool):
        return float(value)
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    # NaN / inf are not reportable load values
    if f != f or f in (float("inf"), float("-inf")):
        return None
    return f


def parse_endpoint_load(value: Optional[str],
                        fmt: Optional[str] = None) -> Optional[EndpointLoad]:
    """Parse an ORCA ``endpoint-load-metrics`` header value.

    ``fmt`` forces ``"json"`` or ``"text"``; None sniffs (a leading ``{``
    is json). Unknown keys are preserved verbatim; malformed values are
    skipped, never raised; a value with nothing parseable returns None
    (as does a missing header), so ingestion causes no gauge churn on
    garbage."""
    if not value or not isinstance(value, str):
        return None
    text = value.strip()
    metrics: Dict[str, float] = {}
    if fmt == "json" or (fmt is None and text.startswith("{")):
        try:
            obj = json.loads(text)
        except ValueError:
            return None
        if not isinstance(obj, dict):
            return None
        for key, val in obj.items():
            if isinstance(val, dict):  # named_metrics / utilization maps
                for sub, subval in val.items():
                    f = _load_value(subval)
                    if f is not None:
                        metrics[f"{key}.{sub}"] = f
            else:
                f = _load_value(val)
                if f is not None:
                    metrics[str(key)] = f
        return EndpointLoad(metrics, "json") if metrics else None
    for part in text.split(","):
        key, sep, val = part.partition("=")
        if not sep:
            continue
        key = key.strip()
        f = _load_value(val.strip())
        if key and f is not None:
            metrics[key] = f
    return EndpointLoad(metrics, "text") if metrics else None


# -- tracing ------------------------------------------------------------------
# Canonical phase vocabulary (what each transport can observe of it):
#   queue       time waiting for a worker/slot before the request is built
#   admission_queue  time parked in the pool's admission controller
#               (client_tpu_torch.admission; acquire -> admit — stashed by the
#               pool and claimed by the endpoint client's span)
#   coalesce_queue  time parked in the micro-batching dispatcher's queue
#               before the coalesced wire request was issued
#               (client_tpu_torch.batch; enqueue -> claim)
#   serialize   request body/tensor marshaling
#   connect     TCP/TLS/channel establishment (when separable)
#   send        request bytes on the wire (when separable from ttfb)
#   ttfb        request issued -> first response byte (HTTP: headers;
#               GRPC unary: the whole call, send+server+receive)
#   recv        response body read
#   deserialize response unmarshaling into InferResult
#   attempt     one resilient attempt (sub-span; repeated under retries —
#               and one per SHARD on a sharded logical request, so
#               phase_breakdown's attempt row is the slowest-shard leg)
#   shard_scatter  slicing + arena staging + dispatch of the per-shard
#               requests of one sharded logical infer (client_tpu_torch.shard)
#   shard_gather   shard-response exactness checks + logical-result
#               assembly after the last shard landed
#   cache_lookup   response-cache/singleflight key probe (client_tpu_torch.cache;
#               a hit's span is ONLY this phase — no wire leg at all)
REQUEST_PHASES = (
    "queue", "admission_queue", "coalesce_queue", "cache_lookup",
    "serialize", "connect", "send", "ttfb", "recv", "deserialize",
    "attempt", "shard_scatter", "shard_gather",
)


class RequestSpan:
    """One client request's span: ids, phase intervals, point events.

    ``phase(name, start_ns, end_ns)`` appends an interval (monotonic
    ``time.perf_counter_ns`` values); ``event(name, **attrs)`` appends a
    point annotation (retries, hedges, reconnects). Both are plain list
    appends — cheap enough for the hot path. ``events`` and ``tid`` are
    populated lazily (most requests have no point events, and the thread
    id is only needed when the span is retained for a trace dump)."""

    __slots__ = ("trace_id", "span_id", "frontend", "model", "op",
                 "start_ns", "end_ns", "phases", "events", "sampled",
                 "error", "tid", "flight")

    def __init__(self, trace_id: str, span_id: str, frontend: str,
                 model: str, op: str, sampled: bool):
        # end_ns / events / error / tid / flight are set lazily off the
        # hot path (finish, event(), trace retention, flight-recorder
        # ownership); readers use getattr defaults
        self.trace_id = trace_id
        self.span_id = span_id
        self.frontend = frontend
        self.model = model
        self.op = op
        self.start_ns = time.perf_counter_ns()
        self.phases: List[Tuple[str, int, int]] = []
        self.sampled = sampled

    def phase(self, name: str, start_ns: int, end_ns: int) -> None:
        self.phases.append((name, start_ns, end_ns))

    def event(self, name: str, **attrs) -> None:
        events = getattr(self, "events", None)
        if events is None:
            events = self.events = []
        events.append((name, time.perf_counter_ns(), attrs or None))

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id, self.sampled)

    def duration_s(self) -> float:
        end = getattr(self, "end_ns", 0) or time.perf_counter_ns()
        return (end - self.start_ns) * 1e-9

    def as_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "frontend": self.frontend,
            "model": self.model,
            "op": self.op,
            "start_ns": self.start_ns,
            "end_ns": getattr(self, "end_ns", 0),
            "duration_ms": round(self.duration_s() * 1e3, 6),
            "error": getattr(self, "error", None),
            "phases": [
                {"name": n, "start_ns": s, "end_ns": e,
                 "duration_ms": round((e - s) / 1e6, 6)}
                for n, s, e in self.phases
            ],
            "events": [
                {"name": n, "ns": ts, **(attrs or {})}
                for n, ts, attrs in (getattr(self, "events", None) or ())
            ],
        }


# -- streaming spans ----------------------------------------------------------
class _StreamAttempt:
    """One transport attempt of a stream (the initial open, or one
    reconnect): its open timestamp plus the raw chunk-arrival marks."""

    __slots__ = ("start_ns", "marks")

    def __init__(self, start_ns: int):
        self.start_ns = start_ns
        self.marks: List[int] = []


class StreamSpan:
    """One client stream's span: open -> first-chunk (TTFT) -> per-chunk
    marks -> close/error/reconnect.

    The hot path is :meth:`mark` — one ``perf_counter_ns`` plus one list
    append on the CURRENT attempt (the bound-method indirection is rebound
    by :meth:`reconnect`, so marking never branches on attempt state).
    Everything derived — TTFT, inter-chunk latencies, per-attempt splits —
    is computed at fold/scrape time, never per chunk.

    Reconnects open a new sub-attempt: TTFT and inter-chunk gaps are
    always computed WITHIN one attempt, so a retried stream never folds
    reconnect backoff into TTFT and the gap across a reconnect never
    poisons the inter-chunk distribution."""

    __slots__ = ("trace_id", "span_id", "frontend", "model", "op",
                 "start_ns", "end_ns", "attempts", "events", "sampled",
                 "error", "abandoned", "tid", "_mark")

    def __init__(self, trace_id: str, span_id: str, frontend: str,
                 model: str, op: str, sampled: bool):
        # end_ns / events / error / abandoned / tid set lazily off the hot
        # path; readers use getattr defaults (same pattern as RequestSpan)
        self.trace_id = trace_id
        self.span_id = span_id
        self.frontend = frontend
        self.model = model
        self.op = op
        self.start_ns = time.perf_counter_ns()
        first = _StreamAttempt(self.start_ns)
        self.attempts: List[_StreamAttempt] = [first]
        self.sampled = sampled
        self._mark = first.marks.append

    def mark(self) -> None:
        """Record one chunk/token arrival (the ≤2 µs/mark hot path)."""
        self._mark(time.perf_counter_ns())

    def reconnect(self, abandoned: int = 0, resent: int = 0) -> None:
        """Open a reconnect sub-attempt; subsequent marks land in it."""
        attempt = _StreamAttempt(time.perf_counter_ns())
        self.attempts.append(attempt)
        self._mark = attempt.marks.append
        self.event("reconnect", attempt=len(self.attempts) - 1,
                   abandoned=abandoned, resent=resent)

    def event(self, name: str, **attrs) -> None:
        events = getattr(self, "events", None)
        if events is None:
            events = self.events = []
        events.append((name, time.perf_counter_ns(), attrs or None))

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id, self.sampled)

    # -- derived views (fold/scrape side, never the chunk path) --------------
    @property
    def chunk_count(self) -> int:
        return sum(len(a.marks) for a in self.attempts)

    def marks_ns(self) -> List[int]:
        """All chunk marks in arrival order (attempts concatenated)."""
        out: List[int] = []
        for attempt in self.attempts:
            out.extend(attempt.marks)
        return out

    def ttft_ms_per_attempt(self) -> List[float]:
        """Open->first-chunk per attempt that saw a chunk — recorded per
        reconnect attempt so retries never inflate TTFT."""
        return [(a.marks[0] - a.start_ns) / 1e6
                for a in self.attempts if a.marks]

    def itl_values_ms(self) -> List[float]:
        """Inter-chunk gaps, computed within each attempt only (a gap that
        spans a reconnect is transport recovery, not token latency)."""
        out: List[float] = []
        for attempt in self.attempts:
            marks = attempt.marks
            for i in range(1, len(marks)):
                out.append((marks[i] - marks[i - 1]) / 1e6)
        return out

    def duration_s(self) -> float:
        end = getattr(self, "end_ns", 0) or time.perf_counter_ns()
        return (end - self.start_ns) * 1e-9

    @property
    def phases(self) -> List[Tuple[str, int, int]]:
        """Tracer-compatible interval view: one ``attempt`` interval per
        transport attempt plus its ``ttft`` window."""
        end_ns = getattr(self, "end_ns", 0)
        out: List[Tuple[str, int, int]] = []
        for i, attempt in enumerate(self.attempts):
            nxt = (self.attempts[i + 1].start_ns
                   if i + 1 < len(self.attempts) else end_ns)
            last = attempt.marks[-1] if attempt.marks else (
                nxt or attempt.start_ns)
            out.append(("attempt", attempt.start_ns, last))
            if attempt.marks:
                out.append(("ttft", attempt.start_ns, attempt.marks[0]))
        return out

    def as_dict(self) -> Dict[str, Any]:
        itl = self.itl_values_ms()
        itl_summary: Dict[str, Any] = _percentile_row(itl)
        if itl:
            itl_summary["max"] = round(max(itl), 4)
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "frontend": self.frontend,
            "model": self.model,
            "op": self.op,
            "start_ns": self.start_ns,
            "end_ns": getattr(self, "end_ns", 0),
            "duration_ms": round(self.duration_s() * 1e3, 6),
            "error": getattr(self, "error", None),
            "abandoned": bool(getattr(self, "abandoned", False)),
            "chunks": self.chunk_count,
            "reconnects": len(self.attempts) - 1,
            "ttft_ms": [round(v, 4) for v in self.ttft_ms_per_attempt()],
            "itl_ms": itl_summary,
            "attempts": [
                {"start_ns": a.start_ns, "chunks": len(a.marks)}
                for a in self.attempts
            ],
            "phases": [
                {"name": n, "start_ns": s, "end_ns": e,
                 "duration_ms": round((e - s) / 1e6, 6)}
                for n, s, e in self.phases
            ],
            "events": [
                {"name": n, "ns": ts, **(attrs or {})}
                for n, ts, attrs in (getattr(self, "events", None) or ())
            ],
        }


# -- sliding-window quantile sketch -------------------------------------------
# Fixed millisecond bucket edges for the windowed stream metrics: 50 µs ..
# 30 s — SSE token gaps on localhost sit at the bottom, cold-compile first
# tokens at the top.
DEFAULT_STREAM_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class WindowedSketch:
    """A sliding-window quantile sketch: a ring of fixed-bucket
    sub-windows, merged at read time.

    ``observe`` lands one value in the current sub-window (a bisect plus
    an increment under the sketch lock — this runs on the FOLD/scrape
    side, never the per-chunk path). Readers merge the live sub-windows
    and interpolate quantiles; values older than ``window_s`` age out as
    their sub-window is recycled. Rotation is lazy on both paths under
    the same lock, so a scrape concurrent with a rotation sees either the
    pre- or post-rotation window — never a torn one.
    """

    __slots__ = ("buckets", "window_s", "subwindows", "_sub_s", "_counts",
                 "_sums", "_ns", "_period", "_lock", "_clock")

    def __init__(self, window_s: float = 300.0, subwindows: int = 6,
                 buckets: Sequence[float] = DEFAULT_STREAM_MS_BUCKETS,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if subwindows < 1:
            raise ValueError("subwindows must be >= 1")
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges or len(set(edges)) != len(edges):
            raise ValueError("buckets must be non-empty and distinct")
        self.buckets = edges
        self.window_s = float(window_s)
        self.subwindows = int(subwindows)
        self._sub_s = self.window_s / self.subwindows
        self._counts = [[0] * (len(edges) + 1) for _ in range(subwindows)]
        self._sums = [0.0] * subwindows
        self._ns = [0] * subwindows
        self._period: Optional[int] = None
        self._lock = threading.Lock()
        self._clock = clock

    def _rotate_locked(self) -> int:
        """Advance to the current period, recycling expired sub-windows;
        returns the live slot index. Caller holds the lock."""
        period = int(self._clock() / self._sub_s)
        if self._period is None:
            self._period = period
        elif period > self._period:
            empty = len(self.buckets) + 1
            for i in range(1, min(period - self._period, self.subwindows) + 1):
                slot = (self._period + i) % self.subwindows
                self._counts[slot] = [0] * empty
                self._sums[slot] = 0.0
                self._ns[slot] = 0
            self._period = period
        return self._period % self.subwindows

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            slot = self._rotate_locked()
            # bisect_left: a value EQUAL to an edge lands in that edge's
            # ≤-bucket (Prometheus ``le`` semantics) — fraction_le(edge)
            # is then exact, which the SLO good/bad split relies on (its
            # single bucket edge IS the threshold)
            self._counts[slot][bisect_left(self.buckets, value)] += 1
            self._sums[slot] += value
            self._ns[slot] += 1

    def merged(self) -> Tuple[List[int], int, float]:
        """(per-bucket counts, total count, sum) over the live window."""
        with self._lock:
            self._rotate_locked()
            counts = [0] * (len(self.buckets) + 1)
            for sub in self._counts:
                for i, n in enumerate(sub):
                    counts[i] += n
            return counts, sum(self._ns), sum(self._sums)

    def count(self) -> int:
        return self.merged()[1]

    def quantile(self, q: float) -> float:
        """Windowed quantile via linear interpolation inside the owning
        bucket (same estimate as ``_HistogramSeries.quantile``)."""
        counts, total, _ = self.merged()
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        lower = 0.0
        for i, edge in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= rank:
                frac = (rank - prev) / max(counts[i], 1)
                return lower + (edge - lower) * min(max(frac, 0.0), 1.0)
            lower = edge
        return self.buckets[-1]

    def fraction_le(self, edge: float) -> float:
        """The windowed fraction of values <= ``edge`` (exact when
        ``edge`` is a bucket edge — the SLO good/bad split)."""
        counts, total, _ = self.merged()
        if total == 0:
            return 1.0
        idx = bisect_right(self.buckets, float(edge))
        return sum(counts[:idx]) / total

    def merged_recent(self, window_s: float) -> Tuple[List[int], int, float]:
        """(per-bucket counts, total count, sum) over only the NEWEST
        sub-windows covering the last ``window_s`` seconds — the fast-
        window tap behind multi-window burn-rate alerting
        (``client_tpu_torch.watch``): one sketch answers both the slow (full-
        window) and fast (recent sub-windows) burn question without a
        second ingest path. ``window_s`` rounds UP to whole sub-windows
        (never narrower than asked), clamped to the full window."""
        with self._lock:
            self._rotate_locked()
            k = min(self.subwindows,
                    max(1, int(-(-float(window_s) // self._sub_s))))
            counts = [0] * (len(self.buckets) + 1)
            total = 0
            total_sum = 0.0
            period = self._period or 0
            for i in range(k):
                slot = (period - i) % self.subwindows
                for j, n in enumerate(self._counts[slot]):
                    counts[j] += n
                total += self._ns[slot]
                total_sum += self._sums[slot]
            return counts, total, total_sum

    def quantile_recent(self, q: float, window_s: float) -> float:
        """:meth:`quantile` over only the last ``window_s`` seconds (the
        changepoint watchdog's per-tick sample)."""
        counts, total, _ = self.merged_recent(window_s)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        lower = 0.0
        for i, edge in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= rank:
                frac = (rank - prev) / max(counts[i], 1)
                return lower + (edge - lower) * min(max(frac, 0.0), 1.0)
            lower = edge
        return self.buckets[-1]

    def fraction_le_recent(self, edge: float, window_s: float) -> float:
        """:meth:`fraction_le` over only the last ``window_s`` seconds
        (the FAST half of a multi-window burn evaluation)."""
        counts, total, _ = self.merged_recent(window_s)
        if total == 0:
            return 1.0
        idx = bisect_right(self.buckets, float(edge))
        return sum(counts[:idx]) / total

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-pure snapshot (``json.loads(json.dumps(s)) == s``) that
        :meth:`from_snapshot` restores bit-for-bit."""
        with self._lock:
            self._rotate_locked()
            return {
                "window_s": self.window_s,
                "subwindows": self.subwindows,
                "buckets_ms": list(self.buckets),
                "counts": [list(sub) for sub in self._counts],
                "sums": list(self._sums),
                "ns": list(self._ns),
                "period": self._period,
            }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any],
                      clock: Callable[[], float] = time.monotonic,
                      ) -> "WindowedSketch":
        sketch = cls(snap["window_s"], snap["subwindows"],
                     snap["buckets_ms"], clock=clock)
        sketch._counts = [list(sub) for sub in snap["counts"]]
        sketch._sums = list(snap["sums"])
        sketch._ns = list(snap["ns"])
        sketch._period = snap["period"]
        return sketch


class SLO:
    """One declared latency objective, e.g. ``ttft_p95 < 200ms over 5m``.

    ``objective`` is the target good fraction (0.95 means 95% of events
    must land under ``threshold_ms``). Stream metrics (``ttft_ms``,
    ``itl_ms``, ``stream_duration_ms``) are fed from finished
    :class:`StreamSpan`\\ s; ``request_ms`` is fed from finished unary
    :class:`RequestSpan`\\ s (an errored request always counts bad — see
    :meth:`observe_failure`). The tracker counts every observed
    event good/bad (cumulative counters), keeps a windowed good/bad split
    (a :class:`WindowedSketch` whose single bucket edge IS the
    threshold), and exports at scrape time:

    - ``client_tpu_slo_events_total{slo,outcome}`` — cumulative counters;
    - ``client_tpu_slo_burn_rate{slo}`` — windowed bad fraction over the
      error budget (``1 - objective``); burning exactly the budget is 1.0;
    - ``client_tpu_slo_breached{slo}`` — 1 when the windowed burn rate
      exceeds 1 (the declared quantile currently misses the threshold).
    """

    __slots__ = ("name", "metric", "threshold_ms", "objective", "window_s",
                 "frontend", "window", "good", "bad")

    def __init__(self, name: str, metric: str = "ttft_ms",
                 threshold_ms: float = 200.0, objective: float = 0.95,
                 window_s: float = 300.0, frontend: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if metric not in ("ttft_ms", "itl_ms", "stream_duration_ms",
                          "request_ms"):
            raise ValueError(f"unknown SLO metric {metric!r}")
        if threshold_ms <= 0:
            raise ValueError("threshold_ms must be > 0")
        self.name = name
        self.metric = metric
        self.threshold_ms = float(threshold_ms)
        self.objective = float(objective)
        self.window_s = float(window_s)
        self.frontend = frontend
        # single bucket edge == threshold: counts[0] is good, counts[1] bad
        self.window = WindowedSketch(
            window_s, buckets=(self.threshold_ms,), clock=clock)
        self.good = None  # counters bound by the owning Telemetry
        self.bad = None

    def observe(self, value_ms: float) -> None:
        self.window.observe(value_ms)
        if value_ms <= self.threshold_ms:
            if self.good is not None:
                self.good.inc()
        elif self.bad is not None:
            self.bad.inc()

    def observe_failure(self) -> None:
        """Count one errored request as a bad event: an error violates a
        latency objective whatever its measured duration (a fast 500 is
        not 'within SLO'). The window sees a finite beyond-threshold
        value so sums/snapshots stay JSON-pure."""
        self.window.observe(self.threshold_ms * 2.0)
        if self.bad is not None:
            self.bad.inc()

    def burn_rate(self, window_s: Optional[float] = None) -> float:
        """Windowed bad fraction over the error budget. ``window_s``
        restricts the read to the newest sub-windows of the same sketch
        (the FAST window of multi-window burn alerting — see
        ``client_tpu_torch.watch``); None reads the full declared window."""
        if window_s is None:
            bad_fraction = 1.0 - self.window.fraction_le(self.threshold_ms)
        else:
            bad_fraction = 1.0 - self.window.fraction_le_recent(
                self.threshold_ms, window_s)
        return bad_fraction / (1.0 - self.objective)

    def breached(self) -> bool:
        return self.burn_rate() > 1.0

    def report(self) -> Dict[str, Any]:
        """Good/bad accounting as one JSON-pure row. Counts come from the
        cumulative counters when bound (exact over a bounded replay run
        on a fresh Telemetry — the capacity harness's contract), else
        from the live window. ``attained`` is the bounded-window verdict:
        the bad fraction fits inside the error budget — and requires at
        least one event: a declared objective that was never measured is
        NOT met (certifying an unmeasured SLO is the dishonest option)."""
        if self.good is not None and self.bad is not None:
            good = int(self.good.get())
            bad = int(self.bad.get())
        else:
            counts, total, _ = self.window.merged()
            good = int(counts[0])
            bad = int(total - counts[0])
        total = good + bad
        bad_fraction = (bad / total) if total else 0.0
        return {
            "slo": self.name,
            "metric": self.metric,
            "threshold_ms": self.threshold_ms,
            "objective": self.objective,
            "good": good,
            "bad": bad,
            "events": total,
            "bad_fraction": round(bad_fraction, 6),
            "attained": total > 0
            and bad_fraction <= (1.0 - self.objective) + 1e-12,
            "burn_rate": round(self.burn_rate(), 4),
            "breached": self.breached(),
        }


@dataclass
class SLOSpec:
    """A parsed capacity-SLO declaration (see :func:`parse_slo_spec`).

    ``kind`` is ``"latency"`` (declare via :meth:`Telemetry.track_slo`
    with ``metric``/``threshold_ms``/``objective``) or ``"error_rate"``
    (``limit`` is the max tolerated error fraction; evaluated by the
    replay harness from its shed/error accounting, not a latency window).
    """

    spec: str
    kind: str
    metric: Optional[str] = None
    threshold_ms: Optional[float] = None
    objective: Optional[float] = None
    limit: Optional[float] = None

    @property
    def name(self) -> str:
        return self.spec


_SLO_ERROR_RATE_RE = re.compile(
    r"^\s*error_rate\s*<\s*(?P<value>\d+(?:\.\d+)?)\s*(?P<pct>%)?\s*$")
_SLO_LATENCY_RE = re.compile(
    r"^\s*(?:(?P<name>[a-z_]+?)_?)?p(?P<pct>\d{2,4})\s*<\s*"
    r"(?P<value>\d+(?:\.\d+)?)\s*(?P<unit>ms|s)\s*$")

_SLO_METRICS = {
    "ttft": "ttft_ms",
    "itl": "itl_ms",
    "stream_duration": "stream_duration_ms",
    "duration": "stream_duration_ms",
    "latency": "request_ms",
    "request": "request_ms",
}


def parse_slo_spec(spec: str) -> SLOSpec:
    """Parse one declared SLO, e.g. ``ttft_p95<200ms``, ``p99<50ms``,
    ``itl_p99<20ms``, ``error_rate<0.1%``. Latency specs name a metric
    (``ttft``/``itl``/``duration``/``latency``; bare ``pNN`` means
    end-to-end request latency), a percentile, and a threshold in ``ms``
    or ``s``; ``error_rate`` takes ``%`` or a bare fraction."""
    m = _SLO_ERROR_RATE_RE.match(spec)
    if m is not None:
        limit = float(m.group("value"))
        if m.group("pct"):
            limit /= 100.0
        if not 0.0 <= limit < 1.0:
            raise ValueError(f"error_rate limit out of range: {spec!r}")
        return SLOSpec(spec=spec.strip(), kind="error_rate", limit=limit)
    m = _SLO_LATENCY_RE.match(spec)
    if m is None:
        raise ValueError(
            f"malformed SLO spec {spec!r} (want e.g. ttft_p95<200ms, "
            f"p99<50ms, error_rate<0.1%)")
    name, pct, value, unit = (m.group("name"), m.group("pct"),
                              float(m.group("value")), m.group("unit"))
    metric = _SLO_METRICS.get(name) if name else "request_ms"
    if metric is None:
        raise ValueError(
            f"unknown SLO metric {name!r} in {spec!r} "
            f"(one of {sorted(_SLO_METRICS)} or error_rate)")
    # p95 -> 0.95, p999 -> 0.999. The digit count IS the precision, so a
    # trailing-zero form like p100 would misparse to 0.10 — requiring the
    # objective to land in [0.5, 1) rejects p100/p05 instead of silently
    # certifying a 10%-good "SLO"
    objective = int(pct) / (10.0 ** len(pct))
    if not 0.5 <= objective < 1.0:
        raise ValueError(
            f"percentile out of range in {spec!r} (want p50..p99...)")
    threshold_ms = value * 1000.0 if unit == "s" else value
    if threshold_ms <= 0:
        raise ValueError(f"threshold must be > 0: {spec!r}")
    return SLOSpec(spec=spec.strip(), kind="latency", metric=metric,
                   threshold_ms=threshold_ms, objective=objective)


class Tracer:
    """Ring buffer of recently finished request spans + dump formats."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, capacity))
        self.dropped = 0

    def keep(self, span: RequestSpan) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def recent(self, count: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._ring)
        if count is not None:
            spans = spans[-count:]
        return [s.as_dict() for s in spans]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON (load in chrome://tracing/Perfetto):
        one complete ("X") event per request span, nested complete events
        per phase, instant ("i") events for retries/hedges.

        The ring is snapshotted under ONE lock acquire (``list(deque)``)
        so a dump racing the hot path's ``keep`` never sees a torn deque,
        and the emitted events are sorted by start timestamp — two
        concurrent scrapes produce the same, time-ordered stream instead
        of an interleaving that depends on finish order."""
        with self._lock:
            spans = list(self._ring)
        events: List[Dict[str, Any]] = []
        for span in spans:
            name = f"{span.op} {span.model}".strip()
            end_ns = getattr(span, "end_ns", 0) or span.start_ns
            tid = getattr(span, "tid", 0)
            error = getattr(span, "error", None)
            args: Dict[str, Any] = {
                "trace_id": span.trace_id, "span_id": span.span_id,
            }
            if error:
                args["error"] = error
            events.append({
                "name": name, "cat": span.frontend, "ph": "X",
                "ts": span.start_ns / 1e3,
                "dur": max(end_ns - span.start_ns, 0) / 1e3,
                "pid": 1, "tid": tid, "args": args,
            })
            for pname, s, e in span.phases:
                events.append({
                    "name": pname, "cat": "phase", "ph": "X",
                    "ts": s / 1e3, "dur": max(e - s, 0) / 1e3,
                    "pid": 1, "tid": tid,
                })
            for ename, ts, attrs in (getattr(span, "events", None) or ()):
                events.append({
                    "name": ename, "cat": "event", "ph": "i",
                    "ts": ts / 1e3, "s": "t", "pid": 1, "tid": tid,
                    "args": attrs or {},
                })
        # stable time-order: spans land in the ring in FINISH order, so an
        # early-started-late-finished span would otherwise appear after
        # requests it preceded (and a dump concurrent with another scrape
        # would interleave differently per call)
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_json(self) -> str:
        return json.dumps(self.chrome_trace(), separators=(",", ":"))


# -- the facade ---------------------------------------------------------------
_SAMPLE_MODES = ("always", "ratio", "slow", "off")


class _FrontendBinding:
    """Pre-resolved hot-path series for one frontend label value, so
    ``Telemetry.finish`` does dict lookups instead of label resolution."""

    __slots__ = ("requests", "request_seconds", "phase_series")

    def __init__(self, tel: "Telemetry", frontend: str):
        self.requests = tel.requests_total.labels(frontend)
        self.request_seconds = tel.request_seconds.labels(frontend)
        self.phase_series: Dict[str, _HistogramSeries] = {
            name: tel.phase_seconds.labels(frontend, name)
            for name in REQUEST_PHASES
        }


class Telemetry:
    """One telemetry object shared by frontends, pools and policies.

    ``sample``: which finished spans the tracer ring retains — ``always``,
    ``ratio`` (keep ``sample_ratio`` of requests, decided at span start so
    the traceparent sampled flag matches), ``slow`` (keep only requests
    slower than ``slow_threshold_s``), or ``off`` (metrics only). Metrics
    are always recorded; sampling gates only trace retention.

    ``orca_format``: ``"json"`` or ``"text"`` makes every frontend this
    telemetry is configured on opt in to ORCA per-response load metrics
    (the ``endpoint-load-metrics-format`` request header); parsed reports
    export as ``client_tpu_endpoint_load{url,metric}`` gauges and surface
    in ``PoolClient.endpoint_stats()``. Endpoints silent for longer than
    ``orca_ttl_s`` have their load gauges expired at scrape time.

    ``flight``: a :class:`~client_tpu_torch.flight.FlightRecorder` (or ``True``
    for one with defaults) arms the flight recorder: every layer records
    a per-request causal event timeline, and a tail-based verdict at
    completion retains the requests worth explaining (errors, sheds, SLO
    breaches, the rolling slow tail, a baseline sample) in a bounded
    ring — see docs/observability.md "Flight recorder & postmortems".
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        sample: str = "always",
        sample_ratio: float = 0.01,
        slow_threshold_s: float = 0.25,
        trace_capacity: int = 256,
        rng: Optional[random.Random] = None,
        stream_window_s: float = 300.0,
        orca_format: Optional[str] = None,
        orca_ttl_s: float = 60.0,
        flight: Any = None,
    ):
        if sample not in _SAMPLE_MODES:
            raise ValueError(
                f"unknown sample mode {sample!r} (one of {_SAMPLE_MODES})")
        if orca_format not in _ORCA_FORMATS:
            raise ValueError(
                f"unknown orca_format {orca_format!r} (one of json|text)")
        self.registry = registry or MetricsRegistry()
        self.tracer = Tracer(trace_capacity)
        if flight is True:
            flight = _flight.FlightRecorder()
        self.flight = flight
        if flight is not None:
            flight.bind(self)
        self.sample = sample
        self.sample_ratio = sample_ratio
        self.slow_threshold_s = slow_threshold_s
        self._rng = rng or random.Random()
        reg = self.registry
        # -- pre-wired client instruments ------------------------------------
        self.requests_total = reg.counter(
            "client_tpu_requests_total",
            "Requests finished (success or error) per frontend",
            ("frontend",))
        self.request_errors_total = reg.counter(
            "client_tpu_request_errors_total",
            "Requests finished with an error, by fault domain",
            ("frontend", "domain"))
        self.request_seconds = reg.histogram(
            "client_tpu_request_seconds",
            "End-to-end client request latency", ("frontend",))
        self.phase_seconds = reg.histogram(
            "client_tpu_phase_seconds",
            "Per-phase client latency (serialize/ttfb/recv/deserialize/...)",
            ("frontend", "phase"))
        self.retries_total = reg.counter(
            "client_tpu_retries_total",
            "Resilient re-attempts across all policies")
        self.fast_fails_total = reg.counter(
            "client_tpu_breaker_fast_fails_total",
            "Requests shed by an open circuit breaker")
        self.breaker_transitions_total = reg.counter(
            "client_tpu_breaker_transitions_total",
            "Circuit breaker state transitions", ("state",))
        self.stream_reconnects_total = reg.counter(
            "client_tpu_stream_reconnects_total",
            "GRPC bidi stream auto-reconnects")
        self.stream_abandoned_sequences_total = reg.counter(
            "client_tpu_stream_abandoned_sequences_total",
            "Sequence requests abandoned by a stream reconnect "
            "(never re-sent)")
        self.streams_total = reg.counter(
            "client_tpu_streams_total",
            "Streams finished (success, error or abandoned) per frontend",
            ("frontend",))
        self.stream_errors_total = reg.counter(
            "client_tpu_stream_errors_total",
            "Streams finished with an error, by fault domain",
            ("frontend", "domain"))
        self.stream_abandoned_total = reg.counter(
            "client_tpu_stream_abandoned_total",
            "Streams abandoned by the consumer before exhaustion",
            ("frontend",))
        self.stream_chunks_total = reg.counter(
            "client_tpu_stream_chunks_total",
            "Chunks/tokens received across all streams", ("frontend",))
        self.pool_ejections_total = reg.counter(
            "client_tpu_pool_ejections_total",
            "Passive outlier ejections per endpoint", ("url",))
        self.pool_readmissions_total = reg.counter(
            "client_tpu_pool_readmissions_total",
            "Ejection-window expiries / proven-healthy readmissions",
            ("url",))
        self.pool_health_changes_total = reg.counter(
            "client_tpu_pool_health_changes_total",
            "Active ready-probe health flips per endpoint", ("url",))
        self.pool_sequence_abandoned_total = reg.counter(
            "client_tpu_pool_sequence_abandoned_total",
            "Sequence requests abandoned mid-flight (never re-sent)",
            ("url",))
        # -- response integrity (client_tpu_torch.integrity) ------------------------
        self.integrity_checks_total = reg.counter(
            "client_tpu_integrity_checks_total",
            "Individual contract checks performed on responses",
            ("kind", "url"))
        self.integrity_violations_total = reg.counter(
            "client_tpu_integrity_violations_total",
            "Responses failing contract validation, by violated check",
            ("kind", "url"))
        self.pool_quarantines_total = reg.counter(
            "client_tpu_pool_quarantines_total",
            "Byzantine-replica quarantines (repeated INVALID responses)",
            ("url",))
        self.hedges_fired_total = reg.counter(
            "client_tpu_hedges_fired_total",
            "Hedge copies issued to a second replica")
        self.hedge_wins_total = reg.counter(
            "client_tpu_hedge_wins_total",
            "Requests won by a hedge copy (not the primary)")
        self.hedge_losses_total = reg.counter(
            "client_tpu_hedge_losses_total",
            "Requests where the primary beat an in-flight hedge")
        # -- sharded scatter-gather (client_tpu_torch.shard) ------------------------
        self.shard_requests_total = reg.counter(
            "client_tpu_shard_requests_total",
            "Sharded LOGICAL requests finished (success or error) per "
            "frontend", ("frontend",))
        self.shard_subrequests_total = reg.counter(
            "client_tpu_shard_subrequests_total",
            "Per-shard requests issued by the scatter-gather layer, by "
            "pinned endpoint", ("url",))
        self.shard_failed_total = reg.counter(
            "client_tpu_shard_failed_total",
            "Logical requests failed by a shard (the whole request fails "
            "— never a partial gather), by the failing pinned endpoint",
            ("url",))
        self.shard_skew_seconds = reg.histogram(
            "client_tpu_shard_skew_seconds",
            "Slowest-minus-fastest shard completion skew per successful "
            "logical request (the scatter-gather straggler cost)")
        # -- admission control (client_tpu_torch.admission) -------------------------
        self.admission_shed_total = reg.counter(
            "client_tpu_admission_shed_total",
            "Requests shed by admission control, by priority lane and "
            "shed reason (saturated/deadline/queue_full/queue_timeout/"
            "endpoint_saturated)", ("lane", "reason"))
        self.admission_admitted_total = reg.counter(
            "client_tpu_admission_admitted_total",
            "Requests admitted by admission control, by priority lane",
            ("lane",))
        self._admission_limit_gauge = reg.gauge(
            "client_tpu_admission_limit",
            "Live adaptive concurrency limit per attached controller",
            ("scope",))
        self._admission_inflight_gauge = reg.gauge(
            "client_tpu_admission_inflight",
            "In-flight requests holding an admission slot", ("scope",))
        self._admission_queue_depth_gauge = reg.gauge(
            "client_tpu_admission_queue_depth",
            "Waiters parked in each priority lane's LIFO admission queue",
            ("scope", "lane"))
        self._admission_ctrls: List[Any] = []  # (weakref, scope) pairs
        self._admission_collector_installed = False
        # -- multi-cell federation (client_tpu_torch.federation) --------------------
        self.federation_spill_total = reg.counter(
            "client_tpu_federation_spill_total",
            "Requests the home cell could not serve that transparently "
            "landed on another cell, by home cell, target cell and spill "
            "reason (saturated/down/error)", ("cell", "target", "reason"))
        self.federation_shadow_total = reg.counter(
            "client_tpu_federation_shadow_total",
            "Shadow-mirrored requests by outcome (matched/diverged/"
            "errors are compared responses; skipped = mirror dropped at "
            "the pending bound)", ("outcome",))
        self.federation_canary_total = reg.counter(
            "client_tpu_federation_canary_total",
            "Canary-split outcomes (routed/fallback/rollback)",
            ("outcome",))
        self._federations: List[Any] = []  # (weakref, scope) pairs
        self._federation_collector_installed = False
        self._federation_gauges: Optional[Dict[str, Gauge]] = None
        self._bindings: Dict[str, _FrontendBinding] = {}
        self._pools: List[Any] = []
        self._pools_lock = threading.Lock()
        self._pool_gauges: Optional[Dict[str, Gauge]] = None
        # -- hot-path fast lanes ---------------------------------------------
        # mode flags instead of string compares; cheap unique ids: span ids
        # are a random 64-bit base xor a GIL-atomic counter, trace ids a
        # random 64-bit hex prefix + the counter (W3C needs uniqueness and
        # non-zero; the per-object random prefix keeps ids distinct across
        # processes without paying getrandbits(128)+format per request)
        self._sample_ratio_mode = sample == "ratio"
        self._sample_slow_mode = sample == "slow"
        self._sample_off = sample == "off"
        self._trace_prefix = f"{self._rng.getrandbits(64) or 1:016x}"
        # itertools.count.__next__ is a single C call: each concurrent
        # caller receives a DISTINCT value (a python `seq += 1; read seq`
        # pair could hand two threads the same id)
        self._next_seq = itertools.count(1).__next__
        # finished spans queue here (lock-free GIL-atomic deque appends) and
        # fold into the counters/histograms on the SCRAPER's thread (via
        # the collector below) — the request path never pays the histogram
        # math. _FOLD_BACKLOG bounds memory when nothing scrapes: past it,
        # the unlucky request folds the backlog inline (amortized, rare).
        self._pending: deque = deque()
        self.registry.add_collector(self._fold_pending)
        # -- streaming: windowed sketches + SLOs ------------------------------
        # finished stream spans queue exactly like request spans (lock-free
        # deque, folded on the scraper's thread); the windowed ttft/itl/
        # duration sketches and any declared SLOs are fed AT FOLD TIME —
        # the per-chunk hot path is only StreamSpan.mark()
        self.stream_window_s = stream_window_s
        self._pending_streams: deque = deque()
        self._stream_windows: Dict[Tuple[str, str], WindowedSketch] = {}
        self._endpoint_ttft: Dict[str, WindowedSketch] = {}
        self._windows_lock = threading.Lock()
        self._slos: List[SLO] = []
        # request_ms SLOs resolved once: _fold_pending pays one truthiness
        # check when none are declared
        self._request_slos: List[SLO] = []
        self._window_quantile_gauge = reg.gauge(
            "client_tpu_stream_window_ms",
            f"Windowed stream latency quantiles (last "
            f"{stream_window_s:g}s, merged at scrape time)",
            ("metric", "frontend", "quantile"))
        self._window_count_gauge = reg.gauge(
            "client_tpu_stream_window_count",
            "Samples in the live window per windowed stream metric",
            ("metric", "frontend"))
        self._endpoint_ttft_gauge = reg.gauge(
            "client_tpu_pool_endpoint_ttft_ms",
            "Windowed per-endpoint generate_stream TTFT quantiles "
            "(fed by the pool, merged at scrape time)",
            ("url", "quantile"))
        self._slo_events = reg.counter(
            "client_tpu_slo_events_total",
            "SLO events by outcome", ("slo", "outcome"))
        self._slo_burn_gauge = reg.gauge(
            "client_tpu_slo_burn_rate",
            "Windowed bad fraction over the error budget (1.0 = burning "
            "exactly the budget)", ("slo",))
        self._slo_breached_gauge = reg.gauge(
            "client_tpu_slo_breached",
            "1 when the declared objective currently misses its threshold "
            "over the window", ("slo",))
        self.registry.add_collector(self._fold_stream_pending)
        self.registry.add_collector(self._collect_stream_windows)
        # -- ORCA endpoint load ----------------------------------------------
        # frontends read orca_format to decide whether to request the
        # header; ingestion works regardless (a caller may opt in manually
        # via per-request headers)
        self.orca_format = orca_format
        self.orca_ttl_s = float(orca_ttl_s)
        self._orca_lock = threading.Lock()
        self._orca_loads: Dict[str, EndpointLoad] = {}
        self._orca_gauge = reg.gauge(
            "client_tpu_endpoint_load",
            "Latest ORCA per-response load report per endpoint "
            f"(expired after {orca_ttl_s:g}s of silence)",
            ("url", "metric"))
        self._orca_reports = reg.counter(
            "client_tpu_endpoint_load_reports_total",
            "ORCA load reports ingested per endpoint", ("url",))
        self._orca_parse_errors = reg.counter(
            "client_tpu_endpoint_load_parse_errors_total",
            "ORCA headers that failed to parse", ("url",))
        self.registry.add_collector(self._expire_orca)

    _FOLD_BACKLOG = 32768
    _WINDOW_QUANTILES = ((0.5, "p50"), (0.9, "p90"), (0.95, "p95"),
                         (0.99, "p99"))

    # -- span lifecycle ------------------------------------------------------
    def begin(self, frontend: str, model: str = "",
              op: str = "infer") -> RequestSpan:
        """Open a request span. The sampled flag reflects ``ratio`` mode at
        start time (``slow`` keeps the flag set: the decision happens at
        finish, and servers record access on any traceparent)."""
        sampled = True
        if self._sample_ratio_mode:
            sampled = self._rng.random() < self.sample_ratio
        elif self._sample_off:
            sampled = False
        suffix = f"{self._next_seq():016x}"
        # one client span per trace, so the span id can reuse the trace
        # suffix: unique within the trace (trivially) and across this
        # object's traces (the counter), never all-zero (seq starts at 1)
        return RequestSpan(
            self._trace_prefix + suffix, suffix,
            frontend, model, op, sampled)

    def _binding(self, frontend: str) -> _FrontendBinding:
        binding = self._bindings.get(frontend)
        if binding is None:
            binding = _FrontendBinding(self, frontend)
            self._bindings[frontend] = binding
        return binding

    def finish(self, span: Optional[RequestSpan],
               error: Optional[BaseException] = None) -> None:
        """Close the span. The hot path is one timestamp, the trace-ring
        decision, and a lock-free deque append; the counter/histogram fold
        is deferred to scrape time (or amortized once the backlog passes
        ``_FOLD_BACKLOG``)."""
        if span is None:
            return
        end_ns = span.end_ns = time.perf_counter_ns()
        total_s = (end_ns - span.start_ns) * 1e-9
        if error is not None:
            from .resilience import classify_fault  # no import cycle: lazy

            span.error = f"{type(error).__name__}: {error}"[:256]
            pending = (span, total_s, classify_fault(error))
        else:
            pending = (span, total_s, None)
        self._pending.append(pending)
        if self._sample_slow_mode:
            if total_s >= self.slow_threshold_s:
                span.tid = threading.get_ident()
                self.tracer.keep(span)
        elif span.sampled:
            span.tid = threading.get_ident()
            self.tracer.keep(span)
        if self.flight is not None:
            # the wire span's completion lands on the flight timeline it
            # was BOUND to at _obs_begin (failover/hedge outers see each
            # attempt's end) — membership-gated, because finish() is not
            # always called on the originating thread: the batch
            # dispatcher settles EVERY coalesced caller's span on the
            # leader's thread, and fanning those foreign completions onto
            # the leader's active scratch would corrupt its timeline
            active = _flight._SCRATCH.get()
            if (active is not None and not active.committed
                    and span.trace_id in active.trace_ids):
                if error is not None:
                    active.append("span", "finish",
                                  ms=round(total_s * 1e3, 3),
                                  error=type(error).__name__)
                else:
                    active.append("span", "finish",
                                  ms=round(total_s * 1e3, 3))
            scratch = getattr(span, "flight", None)
            if scratch is not None:
                self.flight.commit(scratch, error=error)
        if len(self._pending) >= self._FOLD_BACKLOG:
            self._fold_pending()

    def _fold_pending(self) -> None:
        """Drain finished spans into the metric series. Runs at scrape time
        (registry collector), at the amortization threshold, or on demand;
        concurrent folders are safe — ``popleft`` hands each record to
        exactly one of them."""
        pending = self._pending
        if not pending:
            return
        lock = self.registry._lock
        while True:
            try:
                span, total_s, domain = pending.popleft()
            except IndexError:
                return
            binding = self._binding(span.frontend)
            err_series = None
            if domain is not None:
                err_series = self.request_errors_total.labels(
                    span.frontend, domain)
            phases = span.phases
            phase_series = binding.phase_series
            for name, _, _ in phases:  # rare: non-canonical phase name
                if name not in phase_series:
                    phase_series[name] = self.phase_seconds.labels(
                        span.frontend, name)
            req_hist = binding.request_seconds
            exemplars_on = self.registry.exemplars
            with lock:
                binding.requests.value += 1
                bucket = bisect_right(req_hist.buckets, total_s)
                req_hist.counts[bucket] += 1
                req_hist.sum += total_s
                req_hist.count += 1
                if exemplars_on:
                    req_hist._exemplar(bucket, span.trace_id, total_s)
                if err_series is not None:
                    err_series.value += 1
                for name, s, e in phases:
                    seconds = (e - s) * 1e-9
                    if seconds < 0.0:
                        seconds = 0.0
                    h = phase_series[name]
                    bucket = bisect_right(h.buckets, seconds)
                    h.counts[bucket] += 1
                    h.sum += seconds
                    h.count += 1
                    if exemplars_on:
                        h._exemplar(bucket, span.trace_id, seconds)
            if self._request_slos:
                for slo in self._request_slos:
                    if (slo.frontend is not None
                            and slo.frontend != span.frontend):
                        continue
                    if domain is not None:
                        slo.observe_failure()
                    else:
                        slo.observe(total_s * 1e3)
            # windowed request-latency tap: the same sliding-sketch family
            # the stream metrics use, keyed ``request_ms`` — the
            # watchtower's changepoint stream and the fast-window burn
            # evaluation read it (fold-side: never the per-request path)
            self._stream_window("request_ms", span.frontend).observe(
                total_s * 1e3)

    # -- stream span lifecycle ----------------------------------------------
    def begin_stream(self, frontend: str, model: str = "",
                     op: str = "generate_stream") -> StreamSpan:
        """Open a stream span (same id scheme and sampling decision as
        :meth:`begin`)."""
        sampled = True
        if self._sample_ratio_mode:
            sampled = self._rng.random() < self.sample_ratio
        elif self._sample_off:
            sampled = False
        suffix = f"{self._next_seq():016x}"
        return StreamSpan(
            self._trace_prefix + suffix, suffix, frontend, model, op, sampled)

    def finish_stream(self, span: Optional[StreamSpan],
                      error: Optional[BaseException] = None,
                      abandoned: bool = False) -> None:
        """Close a stream span (idempotent: a span can be finished by a
        terminal stream error and again by ``stop_stream``/``close`` — the
        first close wins). Counter/sketch folding is deferred to scrape
        time exactly like :meth:`finish`."""
        if span is None or getattr(span, "end_ns", 0):
            return
        end_ns = span.end_ns = time.perf_counter_ns()
        total_s = (end_ns - span.start_ns) * 1e-9
        domain = None
        if error is not None:
            from .resilience import classify_fault  # no import cycle: lazy

            span.error = f"{type(error).__name__}: {error}"[:256]
            domain = classify_fault(error)
        if abandoned:
            span.abandoned = True
        self._pending_streams.append((span, domain))
        if self._sample_slow_mode:
            if total_s >= self.slow_threshold_s:
                span.tid = threading.get_ident()
                self.tracer.keep(span)
        elif span.sampled:
            span.tid = threading.get_ident()
            self.tracer.keep(span)
        if self.flight is not None:
            # streams never hold a scratch open across the generator's
            # life; the recorder synthesizes the timeline (attempts +
            # reconnect events) from the finished span and verdicts it
            self.flight.commit_stream(span, error=error,
                                      abandoned=abandoned)
        if len(self._pending_streams) >= self._FOLD_BACKLOG:
            self._fold_stream_pending()

    def _stream_window(self, metric: str, frontend: str) -> WindowedSketch:
        key = (metric, frontend)
        window = self._stream_windows.get(key)
        if window is None:
            with self._windows_lock:
                window = self._stream_windows.setdefault(
                    key, WindowedSketch(self.stream_window_s))
        return window

    def _fold_stream_pending(self) -> None:
        """Drain finished stream spans into counters, windowed sketches
        and SLOs. Runs at scrape time (registry collector) or at the
        backlog threshold; ``popleft`` keeps concurrent folders safe."""
        pending = self._pending_streams
        while True:
            try:
                span, domain = pending.popleft()
            except IndexError:
                return
            frontend = span.frontend
            self.streams_total.labels(frontend).inc()
            chunks = span.chunk_count
            if chunks:
                self.stream_chunks_total.labels(frontend).inc(chunks)
            if domain is not None:
                self.stream_errors_total.labels(frontend, domain).inc()
            if getattr(span, "abandoned", False):
                self.stream_abandoned_total.labels(frontend).inc()
            ttfts = span.ttft_ms_per_attempt()
            itls = span.itl_values_ms()
            duration_ms = span.duration_s() * 1e3
            samples = (("ttft_ms", ttfts), ("itl_ms", itls),
                       ("stream_duration_ms", (duration_ms,)))
            for metric, values in samples:
                if not values:
                    continue
                window = self._stream_window(metric, frontend)
                for value in values:
                    if value >= 0.0:  # clock skew guard: never a negative
                        window.observe(value)
            for slo in self._slos:
                if slo.frontend is not None and slo.frontend != frontend:
                    continue
                for metric, values in samples:
                    if metric != slo.metric:
                        continue
                    if metric == "stream_duration_ms" and domain is not None:
                        # an errored stream's duration is short BECAUSE it
                        # was truncated — feeding it would count a failed
                        # session as a fast (good) one. The session did
                        # not complete inside the objective: bad.
                        slo.observe_failure()
                        continue
                    if metric == "ttft_ms" and domain is not None \
                            and not values:
                        # a stream that DIED before its first chunk has no
                        # TTFT sample, but it did not meet the objective —
                        # same rule as an errored unary request: an error
                        # always counts bad, never nothing. (Measured
                        # ttft/itl samples from partially-failed streams
                        # stay valid token-timing observations and feed
                        # normally.)
                        slo.observe_failure()
                        continue
                    for value in values:
                        if value >= 0.0:
                            slo.observe(value)

    def _collect_stream_windows(self) -> None:
        """Scrape-time collector: merge the windowed sketches into
        quantile gauges (no hot-path percentile math anywhere)."""
        with self._windows_lock:
            windows = list(self._stream_windows.items())
            endpoints = list(self._endpoint_ttft.items())
        for (metric, frontend), window in windows:
            self._window_count_gauge.labels(metric, frontend).set(
                window.count())
            for q, label in self._WINDOW_QUANTILES:
                self._window_quantile_gauge.labels(
                    metric, frontend, label).set(round(window.quantile(q), 4))
        for url, window in endpoints:
            for q, label in self._WINDOW_QUANTILES:
                self._endpoint_ttft_gauge.labels(url, label).set(
                    round(window.quantile(q), 4))
        for slo in self._slos:
            burn = slo.burn_rate()
            self._slo_burn_gauge.labels(slo.name).set(round(burn, 4))
            self._slo_breached_gauge.labels(slo.name).set(
                1.0 if burn > 1.0 else 0.0)

    # -- SLOs ----------------------------------------------------------------
    def track_slo(self, name: str, metric: str = "ttft_ms",
                  threshold_ms: float = 200.0, objective: float = 0.95,
                  window_s: Optional[float] = None,
                  frontend: Optional[str] = None) -> SLO:
        """Declare a streaming SLO (e.g. ``ttft_p95 < 200ms over 5m`` is
        ``track_slo("ttft_p95", "ttft_ms", 200, objective=0.95,
        window_s=300)``). Returns the tracker; its good/bad counters,
        burn rate and breach gauge export on every scrape."""
        slo = SLO(name, metric, threshold_ms, objective,
                  window_s if window_s is not None else self.stream_window_s,
                  frontend)
        slo.good = self._slo_events.labels(name, "good")
        slo.bad = self._slo_events.labels(name, "bad")
        self._slos.append(slo)
        if metric == "request_ms":
            self._request_slos.append(slo)
        return slo

    def slos(self) -> List[SLO]:
        return list(self._slos)

    def stream_windows(self) -> Dict[Tuple[str, str], WindowedSketch]:
        """The live windowed sketches keyed ``(metric, frontend)``,
        including the ``request_ms`` tap — the watchtower's changepoint
        detectors sample these per tick."""
        with self._windows_lock:
            return dict(self._stream_windows)

    def slo_report(self) -> List[Dict[str, Any]]:
        """One :meth:`SLO.report` row per declared SLO, after folding any
        pending spans — so a bounded replay run (fresh Telemetry, read
        once at the end) gets exact good/bad counts over exactly that
        run, without requiring a scrape."""
        self._fold_pending()
        self._fold_stream_pending()
        return [slo.report() for slo in self._slos]

    # -- pool TTFT feed -------------------------------------------------------
    def observe_endpoint_ttft(self, url: str, ttft_ms: float) -> None:
        """Record one stream's TTFT against the endpoint that served it
        (fed by ``PoolClient.generate_stream`` once per stream) so
        ejection decisions have a latency signal per replica."""
        if ttft_ms < 0.0:
            return
        window = self._endpoint_ttft.get(url)
        if window is None:
            with self._windows_lock:
                window = self._endpoint_ttft.setdefault(
                    url, WindowedSketch(self.stream_window_s))
        window.observe(ttft_ms)

    # -- ORCA endpoint load ---------------------------------------------------
    def ingest_endpoint_load(self, url: str, header_value: Optional[str],
                             fmt: Optional[str] = None,
                             ) -> Optional[EndpointLoad]:
        """Ingest one response's ORCA header for ``url``. A missing header
        (None) touches nothing — no gauge churn; a malformed one counts a
        parse error. Returns the parsed :class:`EndpointLoad`, if any."""
        if header_value is None:
            return None
        load = parse_endpoint_load(header_value, fmt or self.orca_format)
        if load is None:
            self._orca_parse_errors.labels(url).inc()
            return None
        gauge = self._orca_gauge
        reports = self._orca_reports.labels(url)
        with self._orca_lock:
            # gauge writes stay under the lock: two concurrent reports for
            # one url must not interleave (the loser could resurrect a
            # series the winner just removed, orphaning it forever).
            # try_labels: a load folded into the cardinality-overflow
            # series would be a meaningless endpoint mix AND unremovable
            # by the TTL expiry — drop it (counted) instead
            previous = self._orca_loads.get(url)
            self._orca_loads[url] = load
            # resolve series first (lock-free once cached), then write the
            # whole report under ONE registry-lock acquire — per-metric
            # series.set() would take it once per metric per response
            writes = [(series, value)
                      for name, value in load.metrics.items()
                      if (series := gauge.try_labels(url, name)) is not None]
            vanished = ([name for name in previous.metrics
                         if name not in load.metrics]
                        if previous is not None else [])
            with self.registry._lock:
                for series, value in writes:
                    series._set(value)
                reports._inc()
                for name in vanished:  # metric left the report
                    gauge._series.pop((url, name), None)
        return load

    def endpoint_loads(self) -> Dict[str, EndpointLoad]:
        """The un-expired latest load report per endpoint url."""
        now = time.monotonic()
        with self._orca_lock:
            return {url: load for url, load in self._orca_loads.items()
                    if now - load.received_monotonic <= self.orca_ttl_s}

    def _expire_orca(self) -> None:
        """Scrape-time collector: drop load gauges for endpoints that have
        not reported within ``orca_ttl_s`` (a stale load number is worse
        than no number — it looks current). Removal happens under
        ``_orca_lock``, the same invariant ``ingest_endpoint_load`` keeps:
        an ingest racing the expiry must not have its fresh gauges
        deleted."""
        now = time.monotonic()
        with self._orca_lock:
            for url, load in list(self._orca_loads.items()):
                if now - load.received_monotonic > self.orca_ttl_s:
                    del self._orca_loads[url]
                    for name in load.metrics:
                        self._orca_gauge.remove(url, name)

    # -- data plane -----------------------------------------------------------
    def enable_dataplane(self) -> DataPlaneRecorder:
        """Install a process-global :class:`DataPlaneRecorder` on THIS
        telemetry's registry (shm accounting shows up in its scrapes);
        returns the recorder. See :func:`install_dataplane` to restore a
        previous one."""
        return enable_dataplane(self.registry)

    # -- resilience observer protocol (duck-typed from resilience.py) --------
    def on_retry(self, attempt: int, exc: BaseException,
                 delay_s: float) -> None:
        self.retries_total.inc()

    def on_fast_fail(self) -> None:
        self.fast_fails_total.inc()

    def on_breaker_transition(self, state: str) -> None:
        self.breaker_transitions_total.labels(state).inc()

    def on_stream_reconnect(self, event=None) -> None:
        """Exactly-once bridge for ``resilience.StreamReconnected``: the
        reconnecting stream calls this (with the event) BEFORE the user
        callback sees it, so the counters move once per reconnect and the
        abandoned-sequence count is never lost even when the application
        swallows the event."""
        self.stream_reconnects_total.inc()
        abandoned = getattr(event, "abandoned_request_ids", None)
        if abandoned:
            self.stream_abandoned_sequences_total.inc(len(abandoned))

    def on_shard_subrequest(self, url: str) -> None:
        self.shard_subrequests_total.labels(url).inc()

    def on_shard_result(self, frontend: str,
                        skew_s: Optional[float] = None) -> None:
        """One sharded logical request finished (either way); ``skew_s``
        (successes only) is the slowest-minus-fastest shard interval."""
        self.shard_requests_total.labels(frontend).inc()
        if skew_s is not None:
            self.shard_skew_seconds.observe(max(0.0, skew_s))

    def on_shard_failed(self, url: str) -> None:
        self.shard_failed_total.labels(url).inc()

    def on_hedge_fired(self) -> None:
        self.hedges_fired_total.inc()

    def on_hedge_result(self, hedge_won: bool) -> None:
        (self.hedge_wins_total if hedge_won
         else self.hedge_losses_total).inc()

    def attach(self, policy) -> Any:
        """Wire a ``resilience.ResiliencePolicy`` (and its breaker) into
        this telemetry object; returns the policy for chaining."""
        policy.observer = self
        breaker = getattr(policy, "breaker", None)
        if breaker is not None:
            breaker.on_transition = self.on_breaker_transition
        return policy

    # -- admission bridge -----------------------------------------------------
    def on_admission_admit(self, lane: str, waited_s: float) -> None:
        self.admission_admitted_total.labels(lane).inc()

    def on_admission_shed(self, lane: str, reason: str) -> None:
        self.admission_shed_total.labels(lane, reason).inc()

    def attach_admission(self, controller, scope: str = "pool") -> Any:
        """Wire an ``admission.AdmissionController`` into this telemetry:
        its sheds/admits feed ``client_tpu_admission_shed_total{lane,
        reason}`` / ``..._admitted_total{lane}``, and the live limit,
        in-flight count and per-lane queue depths export as gauges at
        scrape time (held by weak reference, like pools). Returns the
        controller for chaining."""
        controller.observer = self
        with self._pools_lock:
            # disambiguate: two pools sharing one Telemetry must not
            # export colliding {scope=...} gauges where the last-collected
            # controller silently stands in for both
            taken = {s for ref, s in self._admission_ctrls
                     if ref() is not None}
            if scope in taken:
                n = 2
                while f"{scope}#{n}" in taken:
                    n += 1
                scope = f"{scope}#{n}"
            self._admission_ctrls.append((weakref.ref(controller), scope))
            if not self._admission_collector_installed:
                self._admission_collector_installed = True
                self.registry.add_collector(self._collect_admission)
        return controller

    def pools(self) -> List[Any]:
        """The live registered pools (dead weakrefs skipped) — the
        watchtower's breaker/quarantine watermark gauges read their
        ``watch_gauges()``/health summaries."""
        with self._pools_lock:
            refs = list(self._pools)
        return [pool for pool in (ref() for ref in refs)
                if pool is not None]

    def admission_controllers(self) -> List[Any]:
        """The live attached controllers (dead weakrefs skipped) —
        doctor's admission section reads their snapshots."""
        with self._pools_lock:
            refs = list(self._admission_ctrls)
        out = []
        for ref, scope in refs:
            ctrl = ref()
            if ctrl is not None:
                out.append((ctrl, scope))
        return out

    def _collect_admission(self) -> None:
        dead = []
        with self._pools_lock:
            refs = list(self._admission_ctrls)
        for entry in refs:
            ref, scope = entry
            ctrl = ref()
            if ctrl is None:
                dead.append(entry)
                continue
            try:
                snap = ctrl.snapshot()
            except Exception:
                continue  # one sick controller must not break the scrape
            self._admission_limit_gauge.labels(scope).set(snap["limit"])
            self._admission_inflight_gauge.labels(scope).set(
                snap["inflight"])
            for lane, row in snap["lanes"].items():
                self._admission_queue_depth_gauge.labels(scope, lane).set(
                    row["depth"])
        if dead:
            with self._pools_lock:
                for entry in dead:
                    try:
                        self._admission_ctrls.remove(entry)
                    except ValueError:
                        pass

    # -- federation bridge ----------------------------------------------------
    def on_cell_spill(self, cell: str, target: str, reason: str) -> None:
        self.federation_spill_total.labels(cell, target, reason).inc()

    def on_shadow_result(self, outcome: str) -> None:
        self.federation_shadow_total.labels(outcome).inc()

    def on_canary(self, outcome: str) -> None:
        self.federation_canary_total.labels(outcome).inc()

    def attach_federation(self, fed, scope: str = "federation") -> Any:
        """Wire a ``federation.FederatedClient`` into this telemetry:
        spills/shadow verdicts/canary transitions feed the
        ``client_tpu_federation_*`` counters (the federation calls the
        ``on_*`` hooks above directly, exactly once per event), and the
        per-cell health/spill-state/canary-weight gauges export at
        scrape time from ``federation_stats()`` (held by weak reference,
        like pools). Called by the federation constructor; returns the
        federation for chaining."""
        with self._pools_lock:
            if self._federation_gauges is None:
                reg = self.registry
                self._federation_gauges = {
                    "healthy": reg.gauge(
                        "client_tpu_federation_cell_healthy",
                        "Healthy (routable) endpoints per cell", ("cell",)),
                    "spill_active": reg.gauge(
                        "client_tpu_federation_cell_spill_active",
                        "1 while the cell's shed-rate hysteresis keeps "
                        "new traffic spilling past it", ("cell",)),
                    "shed_rate": reg.gauge(
                        "client_tpu_federation_cell_shed_rate",
                        "Windowed home-attempt shed rate per cell",
                        ("cell",)),
                    "breaker_state": reg.gauge(
                        "client_tpu_federation_cell_breaker_state",
                        "Cell breaker state (0 closed, 1 half-open, "
                        "2 open)", ("cell",)),
                    "canary_weight": reg.gauge(
                        "client_tpu_federation_canary_weight",
                        "Live canary traffic weight (0 after rollback)",
                        ("cell",)),
                }
            self._federations.append((weakref.ref(fed), scope))
            if not self._federation_collector_installed:
                self._federation_collector_installed = True
                self.registry.add_collector(self._collect_federations)
        return fed

    def federations(self) -> List[Any]:
        """The live attached federations as ``(fed, scope)`` pairs —
        doctor's ``cells`` section reads their ``federation_stats()``."""
        with self._pools_lock:
            refs = list(self._federations)
        out = []
        for ref, scope in refs:
            fed = ref()
            if fed is not None:
                out.append((fed, scope))
        return out

    def _collect_federations(self) -> None:
        _BREAKER_STATE = {"closed": 0, "half_open": 1, "open": 2}
        with self._pools_lock:
            refs = list(self._federations)
            gauges = self._federation_gauges
        if gauges is None:
            return
        dead = []
        for entry in refs:
            ref, _scope = entry
            fed = ref()
            if fed is None:
                dead.append(entry)
                continue
            try:
                stats = fed.federation_stats()
            except Exception:
                continue  # one sick federation must not break the scrape
            for name, row in stats.get("cells", {}).items():
                pool = row.get("pool") or {}
                gauges["healthy"].labels(name).set(pool.get("healthy", 0))
                gauges["spill_active"].labels(name).set(
                    1.0 if row.get("spill_active") else 0.0)
                rate = row.get("shed_rate")
                if rate is not None:
                    gauges["shed_rate"].labels(name).set(rate)
                state = row.get("breaker_state")
                if state is not None:
                    gauges["breaker_state"].labels(name).set(
                        _BREAKER_STATE.get(state, -1))
            canary = stats.get("canary")
            if canary:
                gauges["canary_weight"].labels(canary["cell"]).set(
                    canary.get("weight", 0.0))
        if dead:
            with self._pools_lock:
                for entry in dead:
                    try:
                        self._federations.remove(entry)
                    except ValueError:
                        pass

    # -- response integrity ---------------------------------------------------
    def integrity_checked(self, kind: str, url: str, checks: int = 1) -> None:
        """Count the contract checks one validated response passed."""
        self.integrity_checks_total.labels(kind, url or "").inc(checks)

    def integrity_violation(self, kind: str, url: str) -> None:
        """Count one response that failed contract validation."""
        self.integrity_violations_total.labels(kind, url or "").inc()

    # -- pool bridge ---------------------------------------------------------
    def pool_observer(self, chain: Optional[Callable[[Any], None]] = None,
                      ) -> Callable[[Any], None]:
        """An ``on_event`` callback for ``client_tpu_torch.pool`` that counts
        each typed pool event exactly once, then forwards to ``chain``.
        Matches on type name so this module never imports the pool."""
        counters = {
            "EndpointEjected": self.pool_ejections_total,
            "EndpointQuarantined": self.pool_quarantines_total,
            "EndpointReadmitted": self.pool_readmissions_total,
            "EndpointHealthChanged": self.pool_health_changes_total,
            "SequenceAbandoned": self.pool_sequence_abandoned_total,
        }

        def observe(event) -> None:
            try:
                counter = counters.get(type(event).__name__)
                if counter is not None:
                    counter.labels(event.url).inc()
            finally:
                if chain is not None:
                    chain(event)

        return observe

    def register_pool(self, pool) -> None:
        """Expose a pool's per-endpoint stats (health, ejection, breaker
        state, outstanding, resilience counters) as gauges refreshed at
        scrape time via a registry collector — one Prometheus scrape shows
        ejections, half-open probes and hedge win/loss together.

        Pools are held by weak reference: a long-lived Telemetry shared
        across PoolClient create/close cycles must not pin dead pools (and
        their endpoint clients) in memory or keep scraping them."""
        with self._pools_lock:
            first = self._pool_gauges is None
            if first:
                reg = self.registry
                self._pool_gauges = {
                    "healthy": reg.gauge(
                        "client_tpu_pool_endpoint_healthy",
                        "Active ready-probe verdict (1 healthy)", ("url",)),
                    "ejected": reg.gauge(
                        "client_tpu_pool_endpoint_ejected",
                        "Outlier-ejection state (1 ejected)", ("url",)),
                    "outstanding": reg.gauge(
                        "client_tpu_pool_endpoint_outstanding",
                        "In-flight requests per endpoint", ("url",)),
                    "consecutive_failures": reg.gauge(
                        "client_tpu_pool_endpoint_consecutive_failures",
                        "Consecutive transport failures", ("url",)),
                    "ejection_count": reg.gauge(
                        "client_tpu_pool_endpoint_ejection_count",
                        "Lifetime ejections per endpoint", ("url",)),
                    "breaker_state": reg.gauge(
                        "client_tpu_pool_endpoint_breaker_state",
                        "Breaker state (0 closed, 1 half-open, 2 open)",
                        ("url",)),
                    "resilience": reg.gauge(
                        "client_tpu_pool_endpoint_resilience",
                        "Per-endpoint ResilienceStats counters",
                        ("url", "counter")),
                    "affinity": reg.gauge(
                        "client_tpu_pool_endpoint_affinity",
                        "Affinity-routing counters per endpoint: picks "
                        "landed as home (routed), after deterministic "
                        "re-homing (rehomed), after a bounded-load spill "
                        "(spilled), and the capped distinct-key count "
                        "(keys)", ("url", "counter")),
                }
            self._pools.append(weakref.ref(pool))
            if first:
                self.registry.add_collector(self._collect_pools)

    def _collect_pools(self) -> None:
        _BREAKER_STATE = {"closed": 0, "half_open": 1, "open": 2}
        with self._pools_lock:
            refs = list(self._pools)
            gauges = self._pool_gauges
        if gauges is None:
            return
        dead = []
        for ref in refs:
            pool = ref()
            if pool is None:
                dead.append(ref)
                continue
            try:
                snapshot = pool.snapshot()
            except Exception:
                continue  # one sick pool must not break the whole scrape
            for url, stats in snapshot.items():
                gauges["healthy"].labels(url).set(
                    1.0 if stats["healthy"] else 0.0)
                gauges["ejected"].labels(url).set(
                    1.0 if stats["ejected"] else 0.0)
                gauges["outstanding"].labels(url).set(stats["outstanding"])
                gauges["consecutive_failures"].labels(url).set(
                    stats["consecutive_failures"])
                gauges["ejection_count"].labels(url).set(
                    stats["ejection_count"])
                state = stats.get("breaker_state")
                if state is not None:
                    gauges["breaker_state"].labels(url).set(
                        _BREAKER_STATE.get(state, -1))
                for name, value in stats.get("resilience", {}).items():
                    gauges["resilience"].labels(url, name).set(value)
                for name, value in (stats.get("affinity") or {}).items():
                    gauges["affinity"].labels(url, name).set(value)
        if dead:
            with self._pools_lock:
                for ref in dead:
                    try:
                        self._pools.remove(ref)
                    except ValueError:
                        pass

    # -- introspection -------------------------------------------------------
    def flush(self) -> None:
        """Fold any pending finished spans into the metric series now.
        Exporters (``prometheus_text``/``snapshot``) do this implicitly;
        call it before reading instrument objects directly."""
        self._fold_pending()

    def recent_traces(self, count: Optional[int] = None) -> List[Dict[str, Any]]:
        return self.tracer.recent(count)

    def chrome_trace(self) -> Dict[str, Any]:
        return self.tracer.chrome_trace()

    def dump_json(self) -> str:
        return self.tracer.dump_json()

    def phase_breakdown(self, percentiles: Sequence[float] = (0.5, 0.99),
                        ) -> Dict[str, Dict[str, float]]:
        """Per-phase latency percentiles (ms) computed from the EXACT
        samples in the trace ring (not histogram-interpolated) — the
        perf harness emits this under ``--observe``. Stream spans share
        the ring but have their own vocabulary (their ``attempt``/``ttft``
        intervals are whole-stream-scale): they report via
        :meth:`stream_breakdown`, never here."""
        samples: Dict[str, List[float]] = {}
        for trace in self.tracer.recent():
            if "chunks" in trace:  # a StreamSpan, not a request span
                continue
            for phase in trace["phases"]:
                samples.setdefault(phase["name"], []).append(
                    phase["duration_ms"])
        return {name: _percentile_row(values, percentiles)
                for name, values in sorted(samples.items())}

    def stream_breakdown(self, percentiles: Sequence[float] = (0.5, 0.99),
                         ) -> Dict[str, Dict[str, float]]:
        """TTFT / inter-chunk / duration percentiles (ms) from the EXACT
        stream samples retained in the trace ring — the perf harness emits
        this under ``--observe`` for streaming runs. Empty when no stream
        finished in the ring."""
        samples: Dict[str, List[float]] = {}
        with self.tracer._lock:
            spans = list(self.tracer._ring)
        for span in spans:
            if not isinstance(span, StreamSpan):
                continue
            samples.setdefault("ttft_ms", []).extend(
                span.ttft_ms_per_attempt())
            samples.setdefault("itl_ms", []).extend(span.itl_values_ms())
            samples.setdefault("stream_duration_ms", []).append(
                span.duration_s() * 1e3)
        return {name: _percentile_row(values, percentiles)
                for name, values in sorted(samples.items()) if values}


# -- client <-> server stats correlation --------------------------------------
def accepts_client_timeout(fn: Callable) -> bool:
    """Whether a transport method takes a per-call ``client_timeout=``
    (gRPC surfaces do; HTTP surfaces bound calls at the connection-pool
    level instead)."""
    try:
        return "client_timeout" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class StatsCorrelator:
    """Optional poller that merges SERVER-side timings into the client
    registry and renders a "where did the milliseconds go" decomposition.

    Each poll calls every endpoint's ``get_inference_statistics()`` (the
    KServe v2 statistics extension both in-repo servers expose) and — on
    transports that serve one — scrapes the server's ``/metrics`` text.
    Server queue/compute/batch-execution timings land in the client
    registry as ``client_tpu_server_stat_seconds{url,model,stat}`` et al,
    so ONE client scrape shows both halves of every request.

    :meth:`decomposition` compares the deltas between the first and the
    most recent poll against the client's own request latency over the
    same window: per (endpoint, model) it reports server queue ms, server
    compute ms, and the remainder (network + client overhead) — the
    framework-comparison methodology of the inference-benchmark literature
    (client-side totals decomposed against server-side accounting).

    ``endpoints``: a ``{url: client}`` mapping, an iterable of
    ``(url, client)`` pairs, or a ``PoolClient`` (its per-endpoint sync
    clients are used). Clients must be synchronous — run the poller
    beside an aio app with sync clients pointed at the same fleet."""

    def __init__(self, telemetry: Telemetry, endpoints,
                 interval_s: float = 5.0,
                 call_timeout_s: Optional[float] = None):
        self._telemetry = telemetry
        self.call_timeout_s = call_timeout_s
        pool = getattr(endpoints, "pool", None)
        if pool is not None and hasattr(pool, "endpoints"):
            self._endpoints = [(ep.url, ep.client) for ep in pool.endpoints]
        elif isinstance(endpoints, dict):
            self._endpoints = list(endpoints.items())
        else:
            self._endpoints = [(url, client) for url, client in endpoints]
        if not self._endpoints:
            raise ValueError("StatsCorrelator needs at least one endpoint")
        self._timeout_kw: Dict[str, bool] = {}
        for url, client in self._endpoints:
            stats_fn = getattr(client, "get_inference_statistics", None)
            if stats_fn is None or asyncio.iscoroutinefunction(stats_fn):
                # fail at construction, not as a counted error every poll
                # (an aio client would hand back un-awaited coroutines)
                raise TypeError(
                    "StatsCorrelator needs synchronous clients; endpoint "
                    f"{url!r} is async or lacks get_inference_statistics — "
                    "run the poller beside an aio app with sync clients "
                    "pointed at the same fleet")
            self._timeout_kw[url] = accepts_client_timeout(stats_fn)
        self.interval_s = interval_s
        reg = telemetry.registry
        self._stat_seconds = reg.gauge(
            "client_tpu_server_stat_seconds",
            "Cumulative server-side per-model timings mirrored from "
            "get_inference_statistics", ("url", "model", "stat"))
        self._stat_requests = reg.gauge(
            "client_tpu_server_requests",
            "Cumulative server-side request counts by outcome",
            ("url", "model", "outcome"))
        self._batch_seconds = reg.gauge(
            "client_tpu_server_batch_compute_seconds",
            "Cumulative server compute per executed batch size",
            ("url", "model", "batch_size"))
        self._batch_count = reg.gauge(
            "client_tpu_server_batch_executions",
            "Server executions per batch size",
            ("url", "model", "batch_size"))
        self._up = reg.gauge(
            "client_tpu_server_statistics_up",
            "1 when the last statistics poll of the endpoint succeeded",
            ("url",))
        self._poll_errors = reg.counter(
            "client_tpu_server_statistics_poll_errors_total",
            "Statistics polls that failed", ("url",))
        self._lock = threading.Lock()
        # (url, model) -> cumulative server counters at first/last poll
        self._baseline: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._latest: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._client_base: Optional[Tuple[float, float]] = None
        self._server_metrics: Dict[str, Dict[str, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @staticmethod
    def _server_row(row: Dict[str, Any]) -> Dict[str, float]:
        stats = row.get("inference_stats", {})

        def ns(stat: str) -> float:
            return float(stats.get(stat, {}).get("ns", 0))

        return {
            "requests": float(stats.get("success", {}).get("count", 0)),
            "fail": float(stats.get("fail", {}).get("count", 0)),
            "cancel": float(stats.get("cancel", {}).get("count", 0)),
            "queue_ns": ns("queue"),
            "compute_ns": (ns("compute_input") + ns("compute_infer")
                           + ns("compute_output")),
            "executions": float(row.get("execution_count", 0)),
            "inferences": float(row.get("inference_count", 0)),
        }

    def _client_totals(self) -> Tuple[float, float]:
        """(sum_s, count) across every frontend's request histogram."""
        self._telemetry.flush()
        hist = self._telemetry.request_seconds
        total_s = 0.0
        count = 0.0
        with self._telemetry.registry._lock:
            for series in hist._series.values():
                total_s += series.sum
                count += series.count
        return total_s, count

    @staticmethod
    def _parse_prometheus(text: str) -> Dict[str, float]:
        """Minimal Prometheus text parse: ``{series_string: value}``.

        Handles label values containing spaces (split after the closing
        ``}``) and the optional trailing timestamp field (ignored, never
        mistaken for the value)."""
        out: Dict[str, float] = {}
        for line in text.splitlines():
            if not line.strip() or line.startswith("#"):
                continue
            brace = line.rfind("}")
            if brace != -1:
                name = line[:brace + 1]
                fields = line[brace + 1:].split()
            else:
                parts = line.split()
                name, fields = parts[0], parts[1:]
            if not fields:
                continue
            try:
                out[name] = float(fields[0])
            except ValueError:
                continue
        return out

    def _scrape_server_metrics(self, url: str, client) -> None:
        """Best-effort GET /metrics (sync HTTP transports only)."""
        get = getattr(client, "_get", None)
        if get is None:
            return
        try:
            resp = get("metrics")
            if resp.status != 200:
                return
            parsed = self._parse_prometheus(resp.data.decode("utf-8"))
        except Exception:
            return
        with self._lock:
            self._server_metrics[url] = parsed

    def server_metrics(self, url: str) -> Dict[str, float]:
        """The last parsed /metrics scrape for ``url`` (may be empty)."""
        with self._lock:
            return dict(self._server_metrics.get(url, {}))

    def poll_once(self) -> None:
        """One poll of every endpoint: refresh the mirrored gauges and the
        delta bookkeeping ``decomposition()`` reads."""
        if self._client_base is None:
            self._client_base = self._client_totals()
        for url, client in self._endpoints:
            try:
                # per-call deadline where the transport takes one (gRPC);
                # HTTP transports are bounded by their constructor timeouts
                if self.call_timeout_s is not None and self._timeout_kw[url]:
                    stats = client.get_inference_statistics(
                        client_timeout=self.call_timeout_s)
                else:
                    stats = client.get_inference_statistics()
            except Exception:
                self._poll_errors.labels(url).inc()
                self._up.labels(url).set(0.0)
                continue
            self._up.labels(url).set(1.0)
            for row in stats.get("model_stats", []):
                model = row.get("name", "")
                parsed = self._server_row(row)
                self._stat_seconds.labels(url, model, "queue").set(
                    parsed["queue_ns"] / 1e9)
                self._stat_seconds.labels(url, model, "compute").set(
                    parsed["compute_ns"] / 1e9)
                self._stat_requests.labels(url, model, "success").set(
                    parsed["requests"])
                self._stat_requests.labels(url, model, "fail").set(
                    parsed["fail"])
                self._stat_requests.labels(url, model, "cancel").set(
                    parsed["cancel"])
                for batch in row.get("batch_stats", []):
                    size = batch.get("batch_size", 0)
                    ci = batch.get("compute_infer", {})
                    self._batch_seconds.labels(url, model, size).set(
                        float(ci.get("ns", 0)) / 1e9)
                    self._batch_count.labels(url, model, size).set(
                        float(ci.get("count", 0)))
                with self._lock:
                    key = (url, model)
                    self._baseline.setdefault(key, parsed)
                    self._latest[key] = parsed
            self._scrape_server_metrics(url, client)

    def decomposition(
        self,
        client_ms_by_url: Optional[Dict[str, float]] = None,
    ) -> List[Dict[str, Any]]:
        """Per (endpoint, model) latency decomposition over the polled
        window: server queue / server compute / the network+client
        remainder, all per request.

        ``client_ms_by_url`` supplies a per-endpoint client request
        latency (the doctor passes its probe averages) so the remainder
        is attributed to the endpoint that actually paid it. Without it,
        client latency falls back to the telemetry-wide request average
        over the window (the client histograms are per-frontend, not
        per-endpoint) — fine for a single endpoint, a misattribution on
        mixed fleets. Needs at least two polls with traffic in between."""
        client_ms = None
        if self._client_base is not None:
            base_s, base_n = self._client_base
            now_s, now_n = self._client_totals()
            if now_n > base_n:
                client_ms = (now_s - base_s) / (now_n - base_n) * 1e3
        rows: List[Dict[str, Any]] = []
        with self._lock:
            pairs = [(key, self._baseline.get(key), latest)
                     for key, latest in self._latest.items()]
        for (url, model), base, latest in sorted(pairs, key=lambda p: p[0]):
            if base is None:
                continue
            n = latest["requests"] - base["requests"]
            if n <= 0:
                continue
            queue_ms = (latest["queue_ns"] - base["queue_ns"]) / n / 1e6
            compute_ms = (latest["compute_ns"] - base["compute_ns"]) / n / 1e6
            row: Dict[str, Any] = {
                "url": url,
                "model": model,
                "requests": int(n),
                "server_queue_ms": round(queue_ms, 4),
                "server_compute_ms": round(compute_ms, 4),
                "server_total_ms": round(queue_ms + compute_ms, 4),
            }
            url_ms = (client_ms_by_url or {}).get(url, client_ms)
            if url_ms is not None:
                row["client_request_ms"] = round(url_ms, 4)
                row["network_client_overhead_ms"] = round(
                    max(url_ms - (queue_ms + compute_ms), 0.0), 4)
            rows.append(row)
        return rows

    # -- background polling ---------------------------------------------------
    def start(self) -> "StatsCorrelator":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception:
                    pass  # a sick endpoint must not kill the poller

        self._thread = threading.Thread(
            target=loop, name="client_tpu_stats_correlator", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
