"""Continuous monitoring: crash-safe black box, multi-window burn-rate
alerting, and a seeded deterministic changepoint watchdog.

Everything before this module answers questions at a *point in time* —
spans, OpenMetrics scrapes, the flight recorder, ``doctor``. This module
is the continuous layer over the same telemetry, in three pillars:

- **Crash-safe black box** (:class:`BlackBox` / :func:`read_blackbox`):
  an mmap-backed on-disk ring of length-prefixed, checksummed records.
  The flight recorder drains every retained timeline into it at commit
  (``FlightRecorder.set_commit_tap``), the metrics registry drains its
  snapshot at scrape (``MetricsRegistry.add_drain``), and every alert
  edge lands as its own record — so ``python -m client_tpu_torch.doctor
  --blackbox PATH`` reconstructs the last N retained timelines, the last
  metric snapshot and the last alerts after a ``kill -9``, from the ring
  file alone. Torn tails and bit flips are *skipped, never raised*: the
  reader validates each record's magic, length bound and CRC32 and
  returns only the records that verify.

- **Multi-window burn-rate alerting**: every declared ``observe.SLO``
  gets a fast/slow dual-window burn evaluation over its OWN windowed
  sketch (``SLO.burn_rate(window_s)`` reads the newest sub-windows; the
  plain call reads the full window) — an alert fires only when BOTH
  windows burn past their thresholds, the Google-SRE shape that pages on
  sustained burn without flapping on blips. Watermark rules cover the
  non-SLO pressure gauges: pool breakers open, byzantine quarantines,
  admission shed rate, arena residency and federation cells down.
  Alerts are typed :class:`Alert` objects with firing/resolved edge
  semantics, per-(kind, source) deduplication, pluggable sinks
  (callback, :class:`JsonlSink`, the black box) and a ``watch.alert``
  flight mark so every alert is attributable in the retained ring.

- **Changepoint watchdog**: one-sided standardized CUSUM detectors
  (:class:`Cusum`; :class:`PageHinkley` for raw-valued streams) over the
  ``WindowedSketch`` streams — request p99, TTFT p99, ITL p99, shed
  rate — deterministic given the sample stream (no wall-clock
  randomness; the ``seed`` only names the run). On trip the watchdog
  runs ``flight.tail_divergence()`` and the retained timelines'
  attribution to name the layer/endpoint that moved, distinguishing
  "one replica went bad" (a dominant key) from "the fleet shifted"
  (``fleet_shift``). After a trip the detector re-enters warmup, so a
  persistent new level is re-learned instead of re-alerted.

Wiring: ``Watchtower(telemetry, blackbox="/path/ring.bbx").start()``
arms everything (or :func:`enable_watchtower` for the process-global
instance, same install pattern as ``observe.enable_dataplane``). With
no watchtower installed the hot paths pay exactly one branch each
(flight commit tap None, registry drains empty) — the disabled-path
claim proven in BENCH_WATCH.json next to the enabled tick cost,
time-to-detect under live injected chaos, and a zero-false-positive
A/A soak. See docs/observability.md "Continuous monitoring & black
box".
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Alert",
    "BlackBox",
    "BlackBoxRecord",
    "BlackBoxReport",
    "Cusum",
    "JsonlSink",
    "PageHinkley",
    "WatermarkRule",
    "Watchtower",
    "blackbox_report",
    "enable_watchtower",
    "install_watchtower",
    "read_blackbox",
    "watchtower",
]


# -- crash-safe black box -----------------------------------------------------
# On-disk layout: a 64-byte file header, then a fixed-capacity data ring.
#   header: <8s I I Q  = magic "CTPUBBX1", version, reserved, capacity
#   record: <I I I I Q d = magic, payload_len, crc32, reserved, seq, unix_ts
#           followed by the JSON payload, zero-padded to 8 bytes.
# Records are written payload-first, header-last, at 8-aligned offsets;
# the CRC covers (seq, ts, payload). A reader therefore never needs the
# writer's head pointer: it scans every aligned offset, keeps exactly the
# records whose magic + length bound + CRC verify, and orders them by
# seq. A torn tail (kill -9 mid-write), a truncated file or a flipped
# bit invalidates only the records it touched — skipped, never raised.
_FILE_MAGIC = b"CTPUBBX1"
_FILE_HEADER = struct.Struct("<8sIIQ")
_FILE_HEADER_SIZE = 64
_FILE_VERSION = 1
_REC_MAGIC = 0x42425752  # "RWBB" little-endian
_REC_HEADER = struct.Struct("<IIIIQd")
_REC_HEADER_SIZE = _REC_HEADER.size  # 32
_ALIGN = 8


def _pad8(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class BlackBoxRecord:
    """One verified black-box record: ``kind`` is the record type
    (``meta`` / ``timeline`` / ``metrics`` / ``alert``), ``data`` the
    JSON payload, ``seq`` the writer's monotonic sequence number and
    ``ts`` the wall-clock write time."""

    __slots__ = ("seq", "ts", "kind", "data")

    def __init__(self, seq: int, ts: float, kind: str, data: Any):
        self.seq = seq
        self.ts = ts
        self.kind = kind
        self.data = data

    def as_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "ts": self.ts, "kind": self.kind,
                "data": self.data}


@dataclass
class BlackBoxReport:
    """The outcome of scanning a ring file: only verified records, plus
    honest accounting of what was skipped. Never raises on corruption —
    ``ok`` is False only when the file itself is absent/unreadable or
    carries no valid header."""

    ok: bool
    note: str
    records: List[BlackBoxRecord] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    def by_kind(self, kind: str) -> List[BlackBoxRecord]:
        return [r for r in self.records if r.kind == kind]

    def last(self, kind: str) -> Optional[BlackBoxRecord]:
        rows = self.by_kind(kind)
        return rows[-1] if rows else None


def _scan_region(data: bytes) -> Tuple[List[Tuple[int, int, float, bytes]],
                                       Dict[str, int]]:
    """Scan one data region for verified records. Returns
    ``[(seq, end_offset, ts, payload)]`` (unordered) and scan stats.
    Pure bytes in, never raises: every candidate must pass the magic,
    the length bound AND the CRC before its payload is even parsed."""
    found: List[Tuple[int, int, float, bytes]] = []
    stats = {"scanned": 0, "valid": 0, "rejected": 0}
    size = len(data)
    off = 0
    while off + _REC_HEADER_SIZE <= size:
        stats["scanned"] += 1
        magic, length, crc, _reserved, seq, ts = _REC_HEADER.unpack_from(
            data, off)
        if magic != _REC_MAGIC or length == 0 \
                or off + _REC_HEADER_SIZE + length > size:
            off += _ALIGN
            continue
        payload = bytes(data[off + _REC_HEADER_SIZE:
                             off + _REC_HEADER_SIZE + length])
        if zlib.crc32(struct.pack("<Qd", seq, ts) + payload) != crc:
            stats["rejected"] += 1
            off += _ALIGN
            continue
        end = off + _REC_HEADER_SIZE + _pad8(length)
        found.append((seq, end, ts, payload))
        stats["valid"] += 1
        off = end
    return found, stats


class BlackBox:
    """The mmap-backed crash-safe ring writer.

    ``capacity_bytes`` bounds the data region; records wrap (oldest
    overwritten by position). Writes are payload-first/header-last under
    one lock, so a ``kill -9`` tears at most the record in flight — and
    a torn record fails its CRC and is skipped by every reader. mmap
    pages survive process death without ``flush()`` (the page cache owns
    them); ``flush()`` exists for machine-crash durability.

    Reopening an existing ring recovers: the constructor scans for the
    highest verified seq and continues after it."""

    def __init__(self, path: str, capacity_bytes: int = 1 << 22):
        capacity = _pad8(max(int(capacity_bytes), 4096))
        self.path = str(path)
        self._lock = threading.Lock()
        self._appended = 0
        self._dropped_oversize = 0
        self._wrapped = 0
        size = _FILE_HEADER_SIZE + capacity
        fresh = True
        if os.path.exists(self.path) \
                and os.path.getsize(self.path) >= _FILE_HEADER_SIZE:
            with open(self.path, "rb") as f:
                head = f.read(_FILE_HEADER.size)
            try:
                magic, version, _, existing_cap = _FILE_HEADER.unpack(head)
                # a valid header is enough: a truncated file (crashed
                # mid-grow, copied short) is re-grown zero-filled below
                # and its surviving records recovered
                fresh = not (magic == _FILE_MAGIC
                             and version == _FILE_VERSION
                             and existing_cap > 0)
                if not fresh:
                    capacity = int(existing_cap)
                    size = _FILE_HEADER_SIZE + capacity
            except struct.error:
                fresh = True
        self.capacity = capacity
        flags = os.O_RDWR | os.O_CREAT
        fd = os.open(self.path, flags, 0o644)
        try:
            if fresh:
                os.ftruncate(fd, 0)
            if os.fstat(fd).st_size != size:
                os.ftruncate(fd, size)  # grow is zero-filled
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        if fresh:
            self._mm[:_FILE_HEADER.size] = _FILE_HEADER.pack(
                _FILE_MAGIC, _FILE_VERSION, 0, capacity)
            self._head = 0
            self._seq = 1
        else:
            found, _ = _scan_region(
                self._mm[_FILE_HEADER_SIZE:_FILE_HEADER_SIZE + capacity])
            if found:
                newest = max(found, key=lambda rec: rec[0])
                self._seq = newest[0] + 1
                self._head = newest[1] % capacity
            else:
                self._head = 0
                self._seq = 1
        self._closed = False

    def append(self, kind: str, data: Any) -> bool:
        """Write one record (JSON-serialized ``{"kind", "data"}``).
        Returns False (counted) when the payload cannot fit the ring."""
        payload = json.dumps({"kind": kind, "data": data},
                             separators=(",", ":"), default=str).encode()
        total = _REC_HEADER_SIZE + _pad8(len(payload))
        with self._lock:
            if self._closed:
                return False
            if total > self.capacity:
                self._dropped_oversize += 1
                return False
            if self._head + total > self.capacity:
                self._wrapped += 1
                self._head = 0
            base = _FILE_HEADER_SIZE + self._head
            seq = self._seq
            ts = time.time()
            crc = zlib.crc32(struct.pack("<Qd", seq, ts) + payload)
            # payload first, header (with its magic+CRC) last: a kill -9
            # between the two leaves a record that fails verification
            # instead of a record that parses as garbage
            self._mm[base + _REC_HEADER_SIZE:
                     base + _REC_HEADER_SIZE + len(payload)] = payload
            self._mm[base:base + _REC_HEADER_SIZE] = _REC_HEADER.pack(
                _REC_MAGIC, len(payload), crc, 0, seq, ts)
            self._head += total
            self._seq += 1
            self._appended += 1
        return True

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._mm.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._mm.flush()
            finally:
                self._mm.close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "capacity_bytes": self.capacity,
                "appended": self._appended,
                "dropped_oversize": self._dropped_oversize,
                "wrapped": self._wrapped,
                "next_seq": self._seq,
            }


def read_blackbox(path: str) -> BlackBoxReport:
    """Scan a black-box ring file and return every record that verifies,
    ordered by seq. NEVER raises on corruption: truncation, torn tails,
    bit flips and partial overwrites invalidate only the records they
    touch (magic/length-bound/CRC check), and a missing or headerless
    file returns an empty not-ok report."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        return BlackBoxReport(ok=False, note=f"unreadable: {exc}")
    if len(raw) < _FILE_HEADER.size:
        return BlackBoxReport(ok=False, note="no valid header (truncated)")
    magic, version, _, capacity = _FILE_HEADER.unpack_from(raw, 0)
    if magic != _FILE_MAGIC:
        return BlackBoxReport(ok=False, note="no valid header (bad magic)")
    # clamp to what is actually on disk: a truncated ring still yields
    # every record that fully survived
    region = raw[_FILE_HEADER_SIZE:_FILE_HEADER_SIZE + capacity]
    found, stats = _scan_region(region)
    records: List[BlackBoxRecord] = []
    seen: set = set()
    for seq, _end, ts, payload in sorted(found, key=lambda rec: rec[0]):
        if seq in seen:
            continue
        try:
            doc = json.loads(payload)
        except ValueError:
            stats["rejected"] += 1
            continue
        if not isinstance(doc, dict) or not isinstance(doc.get("kind"), str):
            stats["rejected"] += 1
            continue
        seen.add(seq)
        records.append(BlackBoxRecord(seq, ts, doc["kind"], doc.get("data")))
    stats["version"] = version
    stats["capacity_bytes"] = capacity
    return BlackBoxReport(ok=True, note="", records=records, stats=stats)


def blackbox_report(path: str, timelines: int = 16) -> Dict[str, Any]:
    """The ``doctor --blackbox`` reconstruction: one JSON-pure dict with
    the last retained timelines, the last metrics snapshot, every
    recovered alert and the run metadata — rebuilt from the ring file
    alone (no live process)."""
    report = read_blackbox(path)
    out: Dict[str, Any] = {
        "kind": "client_tpu_blackbox",
        "path": str(path),
        "ok": report.ok,
        "note": report.note,
        "scan": report.stats,
        "records": len(report.records),
    }
    if not report.ok:
        return out
    meta = report.last("meta")
    out["meta"] = meta.data if meta else None
    tl_records = report.by_kind("timeline")
    out["timelines_recovered"] = len(tl_records)
    out["timelines"] = [r.data for r in tl_records[-timelines:]]
    metrics = report.last("metrics")
    out["metrics"] = metrics.data if metrics else None
    out["metrics_snapshots_recovered"] = len(report.by_kind("metrics"))
    alerts = [dict(r.data, recorded_unix=r.ts)
              for r in report.by_kind("alert")
              if isinstance(r.data, dict)]
    out["alerts"] = alerts
    out["last_alert"] = alerts[-1] if alerts else None
    return out


# -- alerts -------------------------------------------------------------------
@dataclass
class Alert:
    """One typed alert. ``kind`` is the rule family (``slo_burn`` /
    ``watermark`` / ``changepoint``), ``source`` the deduplication key
    within it (e.g. ``slo:ttft_p95`` or ``gauge:pool.quarantined``),
    ``evidence`` the numbers behind the verdict (burn rates, gauge
    values, the flight divergence that names the moved endpoint)."""

    kind: str
    severity: str
    source: str
    evidence: Dict[str, Any]
    state: str = "firing"
    fired_unix: float = 0.0
    resolved_unix: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "source": self.source,
            "state": self.state,
            "fired_unix": self.fired_unix,
            "resolved_unix": self.resolved_unix,
            "evidence": self.evidence,
        }


class JsonlSink:
    """An alert sink appending one JSON line per firing/resolved edge."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()

    def __call__(self, alert: Alert) -> None:
        line = json.dumps(alert.as_dict(), separators=(",", ":"),
                          default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


@dataclass
class WatermarkRule:
    """Fire when a collected gauge crosses ``threshold``; resolve when it
    falls back below ``clear`` (defaults to the threshold — integer
    occupancy gauges like breakers-open want exact edges; rate gauges
    pass a lower ``clear`` for hysteresis)."""

    name: str
    key: str
    threshold: float
    clear: Optional[float] = None
    severity: str = "ticket"

    def clear_level(self) -> float:
        return self.threshold if self.clear is None else self.clear


# -- changepoint detectors ----------------------------------------------------
class PageHinkley:
    """Classic Page-Hinkley test for an upward mean shift on raw values:
    maintains the running mean and the cumulative deviation
    ``m_t = Σ (x_i - mean_i - delta)``; trips when ``m_t`` rises more
    than ``threshold`` above its running minimum. Fully deterministic
    given the sample stream. ``reset()`` (automatic after a trip)
    restarts the test so a persistent shift is learned, not re-alerted."""

    __slots__ = ("delta", "threshold", "min_samples", "n", "mean",
                 "_m", "_m_min", "trips")

    def __init__(self, delta: float = 0.05, threshold: float = 50.0,
                 min_samples: int = 16):
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = max(1, int(min_samples))
        self.trips = 0
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m = 0.0
        self._m_min = 0.0

    def update(self, x: float) -> bool:
        x = float(x)
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self._m += x - self.mean - self.delta
        self._m_min = min(self._m_min, self._m)
        if (self.n >= self.min_samples
                and self._m - self._m_min > self.threshold):
            self.trips += 1
            self.reset()
            return True
        return False

    def state(self) -> Dict[str, Any]:
        return {"detector": "page_hinkley", "n": self.n,
                "mean": round(self.mean, 4),
                "m": round(self._m - self._m_min, 4),
                "threshold": self.threshold, "trips": self.trips}


class Cusum:
    """One-sided (upward) standardized CUSUM with a Welford warmup.

    The first ``warmup`` samples learn the stream's mean/σ and never
    trip; after that each sample is standardized and accumulated as
    ``g = max(0, g + z - k)``, tripping when ``g > h`` — the classic
    sequential test for a sustained upward shift. σ is floored at
    ``rel_floor·|mean|`` and ``abs_floor`` so a bucket-quantized
    (near-constant) stream cannot manufacture infinite z-scores, and
    the baseline drifts only on unsuspicious samples (``z < k``) so a
    real shift cannot teach itself away before tripping. Deterministic
    given the sample stream; after a trip the detector re-enters warmup
    and adapts to the new level."""

    __slots__ = ("k", "h", "warmup", "rel_floor", "abs_floor", "drift",
                 "n", "mean", "_m2", "g", "trips")

    def __init__(self, k: float = 0.5, h: float = 8.0, warmup: int = 24,
                 rel_floor: float = 0.1, abs_floor: float = 0.5,
                 drift: float = 0.02):
        self.k = float(k)
        self.h = float(h)
        self.warmup = max(2, int(warmup))
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.drift = float(drift)
        self.trips = 0
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.g = 0.0

    def sigma(self) -> float:
        var = self._m2 / max(self.n - 1, 1)
        return max(var ** 0.5, self.rel_floor * abs(self.mean),
                   self.abs_floor)

    def update(self, x: float) -> bool:
        x = float(x)
        if self.n < self.warmup:
            self.n += 1
            delta = x - self.mean
            self.mean += delta / self.n
            self._m2 += delta * (x - self.mean)
            return False
        z = (x - self.mean) / self.sigma()
        self.g = max(0.0, self.g + z - self.k)
        if self.g > self.h:
            self.trips += 1
            self.reset()
            return True
        if z < self.k:
            self.mean += self.drift * (x - self.mean)
        return False

    def state(self) -> Dict[str, Any]:
        return {"detector": "cusum", "n": self.n,
                "armed": self.n >= self.warmup,
                "mean": round(self.mean, 4),
                "sigma": round(self.sigma(), 4) if self.n > 1 else None,
                "g": round(self.g, 4), "h": self.h, "trips": self.trips}


# -- the watchtower -----------------------------------------------------------
class Watchtower:
    """The background monitor over one ``observe.Telemetry``.

    Each tick (``interval_s``; :meth:`tick` is also public and
    synchronous for tests/benches) it:

    1. folds pending spans so the windowed sketches are fresh;
    2. evaluates fast/slow dual-window burn for every declared SLO
       (fires only when BOTH windows exceed their thresholds);
    3. collects watermark gauges from the telemetry's registered pools
       (breakers open, quarantined replicas), admission controllers
       (shed rate over the tick interval), federations (cells down) and
       live arenas (residency fraction), and evaluates the watermark
       rules with firing/resolved hysteresis;
    4. samples the ``WindowedSketch`` streams (request/TTFT/ITL p99 over
       the fast window, plus shed rate) into per-stream CUSUM detectors;
       a trip consults ``flight.tail_divergence()`` to name the moved
       endpoint/layer — or calls it a ``fleet_shift``;
    5. emits alert EDGES (fire once, resolve once — deduplicated on
       ``(kind, source)`` while active) to every sink, the black box,
       and the flight ring (``watch.alert`` marks).

    With ``blackbox`` armed it also installs the flight commit tap and
    the registry scrape drain, and writes a rate-limited metrics record
    per ``metrics_every_ticks`` ticks — the crash-surviving record
    ``doctor --blackbox`` reconstructs."""

    _STREAM_METRICS = ("request_ms", "ttft_ms", "itl_ms")

    def __init__(
        self,
        telemetry,
        interval_s: float = 1.0,
        blackbox: Optional[Any] = None,
        sinks: Tuple[Callable[[Alert], None], ...] = (),
        fast_window_s: float = 60.0,
        fast_burn_threshold: float = 6.0,
        slow_burn_threshold: float = 1.0,
        shed_rate_watermark: float = 0.5,
        arena_watermark: float = 0.9,
        changepoint: bool = True,
        cusum_k: float = 0.5,
        cusum_h: float = 8.0,
        cusum_warmup: int = 24,
        min_stream_count: int = 8,
        metrics_every_ticks: int = 10,
        history: int = 256,
        seed: int = 0,
        flight_marks: bool = True,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.telemetry = telemetry
        self.interval_s = float(interval_s)
        self.fast_window_s = float(fast_window_s)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        self.changepoint = bool(changepoint)
        self.cusum_k = float(cusum_k)
        self.cusum_h = float(cusum_h)
        self.cusum_warmup = int(cusum_warmup)
        self.min_stream_count = max(1, int(min_stream_count))
        self.metrics_every_ticks = max(1, int(metrics_every_ticks))
        self.seed = int(seed)
        self.flight_marks = bool(flight_marks)
        self.sinks: List[Callable[[Alert], None]] = list(sinks)
        self._owns_blackbox = isinstance(blackbox, (str, os.PathLike))
        self.blackbox: Optional[BlackBox] = (
            BlackBox(blackbox) if self._owns_blackbox else blackbox)
        self.watermarks: List[WatermarkRule] = [
            WatermarkRule("breakers_open", "pool.breakers_open", 1.0),
            WatermarkRule("quarantined_replicas", "pool.quarantined", 1.0),
            WatermarkRule("shed_rate", "admission.shed_rate",
                          float(shed_rate_watermark),
                          clear=float(shed_rate_watermark) / 2.0),
            WatermarkRule("arena_residency", "arena.leased_fraction",
                          float(arena_watermark),
                          clear=float(arena_watermark) * 0.8),
            WatermarkRule("cells_down", "federation.cells_down", 1.0,
                          severity="page"),
        ]
        self._lock = threading.Lock()
        self._active: Dict[Tuple[str, str], Alert] = {}
        self._history: deque = deque(maxlen=max(8, int(history)))
        self._fired: Dict[str, int] = {}
        self._resolved: Dict[str, int] = {}
        self._detectors: Dict[str, Cusum] = {}
        self._changepoint_trips = 0
        self._prev_admission: Optional[Tuple[float, float]] = None
        self._ticks = 0
        self._tick_errors = 0
        self._tick_ns: deque = deque(maxlen=4096)
        self._metrics_tick = 0
        self._last_metrics_drain = 0.0
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        if self.blackbox is not None:
            self.blackbox.append("meta", {
                "pid": os.getpid(),
                "started_unix": round(time.time(), 3),
                "interval_s": self.interval_s,
                "seed": self.seed,
                "version": 1,
            })
            registry = getattr(telemetry, "registry", None)
            if registry is not None and hasattr(registry, "add_drain"):
                registry.add_drain(self._drain_metrics)
            recorder = getattr(telemetry, "flight", None)
            if recorder is not None and hasattr(recorder, "set_commit_tap"):
                recorder.set_commit_tap(self._drain_timeline)

    # -- black-box drains ----------------------------------------------------
    def _drain_metrics(self, snapshot: Dict[str, Any]) -> None:
        """Registry scrape-drain hook: persist the snapshot, rate-limited
        so a hot scrape loop cannot churn the whole ring."""
        bb = self.blackbox
        if bb is None or self._stopped:
            return
        now = time.monotonic()
        if now - self._last_metrics_drain < min(self.interval_s, 1.0):
            return
        self._last_metrics_drain = now
        bb.append("metrics", snapshot)

    def _drain_timeline(self, timeline) -> None:
        """Flight commit tap: every retained timeline lands in the ring
        (tail-based retention already bounds the volume)."""
        bb = self.blackbox
        if bb is None or self._stopped:
            return
        try:
            bb.append("timeline", timeline.as_dict())
        except Exception:
            pass

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Watchtower":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="client-tpu-watchtower", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                self._tick_errors += 1

    def stop(self) -> None:
        self._stop_event.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=max(2.0, 4 * self.interval_s))
        self._stopped = True
        recorder = getattr(self.telemetry, "flight", None)
        if recorder is not None and hasattr(recorder, "set_commit_tap"):
            recorder.set_commit_tap(None)
        registry = getattr(self.telemetry, "registry", None)
        if registry is not None and hasattr(registry, "remove_drain"):
            registry.remove_drain(self._drain_metrics)
        if self.blackbox is not None:
            try:
                self.blackbox.append("meta", {
                    "pid": os.getpid(),
                    "stopped_unix": round(time.time(), 3),
                })
                self.blackbox.flush()
            finally:
                if self._owns_blackbox:
                    self.blackbox.close()

    # -- one evaluation ------------------------------------------------------
    def tick(self) -> List[Alert]:
        """One synchronous evaluation pass; returns the alert EDGES it
        emitted (fired or resolved this tick)."""
        t0 = time.perf_counter_ns()
        tel = self.telemetry
        try:
            tel._fold_pending()
            tel._fold_stream_pending()
        except Exception:
            pass
        edges: List[Alert] = []
        edges += self._eval_burn()
        gauges, details = self._collect_gauges()
        edges += self._eval_watermarks(gauges, details)
        if self.changepoint:
            edges += self._eval_changepoints(gauges)
        if self.blackbox is not None:
            self._metrics_tick += 1
            if self._metrics_tick >= self.metrics_every_ticks:
                self._metrics_tick = 0
                try:
                    # snapshot() runs the registry drain hook, which
                    # writes the rate-limited "metrics" record
                    tel.registry.snapshot()
                except Exception:
                    pass
        with self._lock:
            self._ticks += 1
            self._tick_ns.append(time.perf_counter_ns() - t0)
        return edges

    # -- pillar (b): burn + watermarks ---------------------------------------
    def _divergence(self) -> Optional[Dict[str, Any]]:
        recorder = getattr(self.telemetry, "flight", None)
        if recorder is None:
            return None
        try:
            return recorder.tail_divergence()
        except Exception:
            return None

    def _eval_burn(self) -> List[Alert]:
        edges: List[Alert] = []
        for slo in self.telemetry.slos():
            fast = slo.burn_rate(self.fast_window_s)
            slow = slo.burn_rate()
            firing = (fast >= self.fast_burn_threshold
                      and slow >= self.slow_burn_threshold)
            evidence = {
                "slo": slo.name,
                "metric": slo.metric,
                "threshold_ms": slo.threshold_ms,
                "objective": slo.objective,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": slo.window_s,
                "fast_burn": round(fast, 4),
                "slow_burn": round(slow, 4),
                "fast_burn_threshold": self.fast_burn_threshold,
                "slow_burn_threshold": self.slow_burn_threshold,
            }
            if firing:
                evidence["divergence"] = self._divergence()
            edges += self._set_condition(
                "slo_burn", f"slo:{slo.name}", firing, "page", evidence)
        return edges

    def _collect_gauges(self) -> Tuple[Dict[str, float], Dict[str, Any]]:
        """One flattened gauge namespace per tick, assembled from the
        live objects registered on the telemetry (pools, admission
        controllers, federations) plus the process arenas — each layer's
        ``watch_gauges()`` is the gauge source contract."""
        vals: Dict[str, float] = {}
        details: Dict[str, Any] = {}
        tel = self.telemetry
        breakers = quarantined = unrouteable = 0
        quarantined_urls: List[str] = []
        breaker_urls: List[str] = []
        pools = tel.pools() if hasattr(tel, "pools") else []
        for pool in pools:
            try:
                wg = pool.watch_gauges()
            except Exception:
                continue
            breakers += wg.get("breakers_open", 0)
            quarantined += wg.get("quarantined", 0)
            unrouteable += wg.get("unrouteable", 0)
            quarantined_urls += wg.get("quarantined_urls", [])
            breaker_urls += wg.get("breaker_open_urls", [])
        if pools:
            vals["pool.breakers_open"] = float(breakers)
            vals["pool.quarantined"] = float(quarantined)
            vals["pool.unrouteable"] = float(unrouteable)
            details["pool.quarantined"] = {"urls": quarantined_urls}
            details["pool.breakers_open"] = {"urls": breaker_urls}
        admitted = shed = 0.0
        ctrls = (tel.admission_controllers()
                 if hasattr(tel, "admission_controllers") else [])
        for ctrl, _scope in ctrls:
            try:
                wg = ctrl.watch_gauges()
            except Exception:
                continue
            admitted += wg.get("admitted_total", 0)
            shed += wg.get("shed_total", 0)
        if ctrls:
            prev = self._prev_admission
            self._prev_admission = (admitted, shed)
            if prev is not None:
                d_adm = max(admitted - prev[0], 0.0)
                d_shed = max(shed - prev[1], 0.0)
                denom = d_adm + d_shed
                vals["admission.shed_rate"] = (
                    d_shed / denom if denom > 0 else 0.0)
                details["admission.shed_rate"] = {
                    "admitted_delta": d_adm, "shed_delta": d_shed}
        cells_down = 0
        down_names: List[str] = []
        feds = tel.federations() if hasattr(tel, "federations") else []
        for fed, _scope in feds:
            try:
                wg = fed.watch_gauges()
            except Exception:
                continue
            cells_down += wg.get("cells_down", 0)
            down_names += wg.get("down_cells", [])
        if feds:
            vals["federation.cells_down"] = float(cells_down)
            details["federation.cells_down"] = {"cells": down_names}
        leased = total = 0
        import sys as _sys
        arena_mod = _sys.modules.get("client_tpu_torch.arena")
        if arena_mod is not None:
            for arena in arena_mod.arenas():
                try:
                    stats = arena.stats()
                except Exception:
                    continue
                leased += stats.get("leased_bytes", 0)
                total += stats.get("total_bytes", 0)
            if total > 0:
                vals["arena.leased_fraction"] = leased / total
                details["arena.leased_fraction"] = {
                    "leased_bytes": leased, "total_bytes": total}
        return vals, details

    def _eval_watermarks(self, gauges: Dict[str, float],
                         details: Dict[str, Any]) -> List[Alert]:
        edges: List[Alert] = []
        for rule in self.watermarks:
            value = gauges.get(rule.key)
            if value is None:
                continue
            key = ("watermark", f"gauge:{rule.key}")
            active = key in self._active
            # hysteresis: an active alert resolves only below clear_level
            firing = (value >= rule.threshold if not active
                      else value >= rule.clear_level())
            evidence = {
                "rule": rule.name,
                "gauge": rule.key,
                "value": round(float(value), 6),
                "threshold": rule.threshold,
                "clear": rule.clear_level(),
            }
            detail = details.get(rule.key)
            if detail:
                evidence.update(detail)
            edges += self._set_condition(
                "watermark", f"gauge:{rule.key}", firing, rule.severity,
                evidence)
        return edges

    # -- pillar (c): changepoints --------------------------------------------
    def _stream_samples(self, gauges: Dict[str, float],
                        ) -> Dict[str, float]:
        samples: Dict[str, float] = {}
        tel = self.telemetry
        windows = (tel.stream_windows()
                   if hasattr(tel, "stream_windows") else {})
        for (metric, frontend), sketch in windows.items():
            if metric not in self._STREAM_METRICS:
                continue
            counts, total, _ = sketch.merged_recent(self.fast_window_s)
            if total < self.min_stream_count:
                continue
            samples[f"{metric}:{frontend}:p99"] = sketch.quantile_recent(
                0.99, self.fast_window_s)
        shed_rate = gauges.get("admission.shed_rate")
        if shed_rate is not None:
            samples["shed_rate"] = shed_rate
        return samples

    def _make_detector(self, stream: str) -> Cusum:
        # shed rate lives in [0, 1]: the ms-scale floor would deafen it
        abs_floor = 0.02 if stream == "shed_rate" else 0.5
        return Cusum(k=self.cusum_k, h=self.cusum_h,
                     warmup=self.cusum_warmup, abs_floor=abs_floor)

    def _eval_changepoints(self, gauges: Dict[str, float]) -> List[Alert]:
        edges: List[Alert] = []
        for stream, value in self._stream_samples(gauges).items():
            detector = self._detectors.get(stream)
            if detector is None:
                detector = self._detectors[stream] = \
                    self._make_detector(stream)
            baseline_mean = detector.mean
            baseline_sigma = (detector.sigma()
                              if detector.n >= detector.warmup else None)
            tripped = detector.update(value)
            if tripped:
                self._changepoint_trips += 1
                divergence = self._divergence()
                moved = (divergence["dominant"]
                         if divergence else "fleet_shift")
                evidence = {
                    "stream": stream,
                    "value": round(value, 4),
                    "baseline_mean": round(baseline_mean, 4),
                    "baseline_sigma": (round(baseline_sigma, 4)
                                       if baseline_sigma else None),
                    "divergence": divergence,
                    "moved": moved,
                }
                edges += self._set_condition(
                    "changepoint", f"changepoint:{stream}", True, "page",
                    evidence)
            else:
                # a changepoint is an event: the edge auto-resolves on the
                # first non-tripping tick (the detector re-warms, so a
                # persistent shift is re-learned, not re-alerted)
                edges += self._set_condition(
                    "changepoint", f"changepoint:{stream}", False, "page",
                    {})
        return edges

    # -- edge semantics ------------------------------------------------------
    def _set_condition(self, kind: str, source: str, firing: bool,
                       severity: str, evidence: Dict[str, Any],
                       ) -> List[Alert]:
        key = (kind, source)
        with self._lock:
            active = self._active.get(key)
            if firing and active is None:
                alert = Alert(kind, severity, source, evidence,
                              state="firing",
                              fired_unix=round(time.time(), 3))
                self._active[key] = alert
                self._fired[kind] = self._fired.get(kind, 0) + 1
                self._history.append(alert.as_dict())
            elif not firing and active is not None:
                del self._active[key]
                active.state = "resolved"
                active.resolved_unix = round(time.time(), 3)
                self._resolved[kind] = self._resolved.get(kind, 0) + 1
                self._history.append(active.as_dict())
                alert = active
            else:
                if active is not None and evidence:
                    active.evidence = evidence  # refresh, no re-emit
                return []
        self._emit(alert)
        return [alert]

    def _emit(self, alert: Alert) -> None:
        for sink in self.sinks:
            try:
                sink(alert)
            except Exception:
                pass
        if self.blackbox is not None:
            try:
                self.blackbox.append("alert", alert.as_dict())
            except Exception:
                pass
        if self.flight_marks:
            recorder = getattr(self.telemetry, "flight", None)
            if recorder is not None and hasattr(recorder, "mark"):
                try:
                    recorder.mark(
                        "watch", "alert", kind=alert.kind,
                        source=alert.source, severity=alert.severity,
                        state=alert.state)
                except Exception:
                    pass

    # -- read side -----------------------------------------------------------
    def active_alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._active.values())

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._history)

    def stats(self) -> Dict[str, Any]:
        """JSON-pure accounting: the perf harness emits this (plus the
        active set) as the ``client_watch`` row block."""
        from .utils import sorted_percentile

        with self._lock:
            tick_ns = sorted(self._tick_ns)
            out: Dict[str, Any] = {
                "ticks": self._ticks,
                "tick_errors": self._tick_errors,
                "interval_s": self.interval_s,
                "alerts_fired": dict(self._fired),
                "alerts_resolved": dict(self._resolved),
                "alerts_active": len(self._active),
                "changepoint_trips": self._changepoint_trips,
            }
        out["alerts_fired_total"] = sum(out["alerts_fired"].values())
        out["alerts_resolved_total"] = sum(out["alerts_resolved"].values())
        if tick_ns:
            out["tick_ns"] = {
                "p50": round(sorted_percentile(tick_ns, 0.5), 1),
                "p99": round(sorted_percentile(tick_ns, 0.99), 1),
            }
        if self.blackbox is not None:
            out["blackbox"] = self.blackbox.stats()
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The doctor's ``watch`` section: stats + active alerts + recent
        history + detector states, JSON-pure."""
        out = self.stats()
        with self._lock:
            out["active"] = [a.as_dict() for a in self._active.values()]
            out["recent"] = list(self._history)[-32:]
            out["detectors"] = {
                stream: det.state()
                for stream, det in sorted(self._detectors.items())
            }
        out["rules"] = {
            "burn": {
                "fast_window_s": self.fast_window_s,
                "fast_burn_threshold": self.fast_burn_threshold,
                "slow_burn_threshold": self.slow_burn_threshold,
                "slos": [slo.name for slo in self.telemetry.slos()],
            },
            "watermarks": [
                {"name": r.name, "gauge": r.key, "threshold": r.threshold,
                 "clear": r.clear_level(), "severity": r.severity}
                for r in self.watermarks
            ],
            "changepoint": {
                "enabled": self.changepoint,
                "k": self.cusum_k, "h": self.cusum_h,
                "warmup": self.cusum_warmup,
                "streams": sorted(self._detectors),
            },
        }
        return out


# -- process-global install (the dataplane pattern) ---------------------------
_WATCH: Optional[Watchtower] = None


def watchtower() -> Optional[Watchtower]:
    """The installed process-global watchtower, if any."""
    return _WATCH


def install_watchtower(tower: Optional[Watchtower]) -> Optional[Watchtower]:
    """Install (or clear, with None) the process-global watchtower;
    returns the previous one so scoped users (perf runs, tests) can
    restore it."""
    global _WATCH
    previous = _WATCH
    _WATCH = tower
    return previous


def enable_watchtower(telemetry, **kwargs) -> Watchtower:
    """Create a :class:`Watchtower` on ``telemetry``, install it
    process-globally and start its background thread; returns it."""
    tower = Watchtower(telemetry, **kwargs)
    install_watchtower(tower)
    return tower.start()
