"""End-to-end response integrity: contract validation for every InferResult.

Every robustness layer below this one (resilience, pools, federation,
disagg) defends against endpoints that are *slow or dead*; this module
defends against endpoints that are *wrong*. A replica that lies about
shapes or dtypes, truncates a binary tensor, mis-frames a BYTES payload,
echoes the wrong request id, or replays a duplicate stream index must
surface as a typed :class:`IntegrityError` — never as a garbage numpy
view handed to the caller.

Three layers, wired through ``_base`` into all four frontends:

* **Contract validation** (default ON): every ``InferResult`` is checked
  against the request before it reaches the caller — returned output
  names vs the requested set, datatype/shape vs cached model metadata,
  binary payload sizes vs the header's claims and the shape x dtype
  arithmetic, BYTES length-framing walked to exact exhaustion, and the
  ``request_id`` echo. Validation is pure arithmetic over data already
  in memory: zero extra RPCs, nanoseconds per call (the bench's A/A arm
  proves the overhead sits inside the noise floor).
* **Stream index checks** (opt-in): SSE / decoupled stream events that
  carry an index must be strictly monotone within one wire stream — no
  duplicates, no gaps. Opt-in because recovery layers (e.g.
  ``disagg``'s re-prefill) legitimately dedup verified replays ACROSS
  re-opened streams and own that stronger semantic check themselves.
* **Data-plane digests** (opt-in, ``arena.LeaseDigest``): blake2b-128
  over shm/arena-resident outputs, sealed when the response lands and
  re-verified at ``as_numpy()`` map time, so a server that scribbles
  over a slab AFTER answering is caught before the first read. Digest
  state rides the existing lease: steady state stays 0 extra RPCs.

Classification: :class:`IntegrityError` carries the
``INTEGRITY_VIOLATION`` status, which ``resilience.classify_fault`` maps
to the ``INVALID`` fault domain — never retried on the SAME endpoint
(it answered; it answered wrong), failed over for idempotent requests,
and counted into the pool's quarantine window (N invalid responses
inside the window ejects the endpoint with a typed
``EndpointQuarantined`` pool event).

Fundamental limit, stated honestly: a bit-flip INSIDE a fixed-width
payload whose sizes all agree is invisible to any client-side check
without redundancy. The contract layer catches every *structural* lie;
value-level corruption is covered where redundancy exists (BYTES
framing, arena digests, and, in ``client_tpu``, disagg's token
continuity) — see docs/integrity.md for the full detection matrix.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import flight as _flight
from .utils import InferenceServerException, triton_to_np_dtype

__all__ = [
    "INTEGRITY_VIOLATION_STATUS",
    "IntegrityError",
    "IntegrityPolicy",
    "IntegrityStats",
    "StreamChecker",
    "default_policy",
    "element_size",
    "expected_nbytes",
    "global_stats",
    "note_parse_violation",
    "validate_result",
    "walk_bytes_framing",
]

INTEGRITY_VIOLATION_STATUS = "INTEGRITY_VIOLATION"


class IntegrityError(InferenceServerException):
    """A response failed contract validation.

    ``kind`` names the violated check (``output_name`` / ``dtype`` /
    ``shape`` / ``payload_size`` / ``tail`` / ``bytes_framing`` /
    ``request_id`` / ``stream_index`` / ``digest``), ``url`` the
    answering endpoint (may be empty for a bare client), ``field`` the
    offending output/field, and ``expected``/``actual`` the mismatched
    values. Carries the ``INTEGRITY_VIOLATION`` status so
    ``resilience.classify_fault`` maps it to the INVALID domain.
    """

    def __init__(self, kind: str, url: str, field: str,
                 expected: Any, actual: Any):
        super().__init__(
            f"integrity violation [{kind}] from {url or '<endpoint>'}: "
            f"{field!r} expected {expected!r}, got {actual!r}",
            status=INTEGRITY_VIOLATION_STATUS)
        self.kind = kind
        self.url = url
        self.field = field
        self.expected = expected
        self.actual = actual


# -- byte arithmetic ----------------------------------------------------------

# BF16 has no numpy dtype through triton_to_np_dtype on every install;
# its wire format is always 2 bytes/element little-endian
_BF16_ITEMSIZE = 2


def element_size(datatype: str) -> Optional[int]:
    """Wire bytes per element for a fixed-width Triton datatype; None for
    BYTES (length-framed) and unknown datatypes."""
    if datatype == "BYTES":
        return None
    if datatype == "BF16":
        return _BF16_ITEMSIZE
    np_dtype = triton_to_np_dtype(datatype)
    if np_dtype is None:
        return None
    return np.dtype(np_dtype).itemsize


def expected_nbytes(datatype: str, shape: Sequence[int]) -> Optional[int]:
    """shape x dtype wire size for fixed-width datatypes; None when the
    size is not statically computable (BYTES / unknown dtype)."""
    item = element_size(datatype)
    if item is None:
        return None
    n = 1
    for dim in shape:
        if not isinstance(dim, int) or isinstance(dim, bool) or dim < 0:
            return None
        n *= dim
    return n * item


def walk_bytes_framing(buf, count: int, url: str, field: str) -> int:
    """Walk a BYTES tensor's 4-byte length framing to EXACT exhaustion.

    Exactly ``count`` elements must consume exactly ``len(buf)`` bytes;
    a truncated prefix, an element running past the buffer, too few
    elements, or trailing slack all raise a typed ``bytes_framing``
    :class:`IntegrityError` (never an unhandled struct error)."""
    view = memoryview(buf)
    total = len(view)
    offset = 0
    for index in range(count):
        if offset + 4 > total:
            raise IntegrityError(
                "bytes_framing", url, field,
                f"length prefix for element {index}",
                f"buffer exhausted at byte {offset}/{total}")
        (length,) = struct.unpack_from("<I", view, offset)
        offset += 4
        if offset + length > total:
            raise IntegrityError(
                "bytes_framing", url, field,
                f"{length} bytes for element {index}",
                f"{total - offset} bytes remaining")
        offset += length
    if offset != total:
        raise IntegrityError(
            "bytes_framing", url, field,
            f"exactly {offset} framed bytes for {count} elements",
            f"{total} bytes ({total - offset} trailing)")
    return offset


# -- cumulative accounting ----------------------------------------------------

class IntegrityStats:
    """Thread-safe counters + a bounded overhead reservoir.

    One process-wide instance (:func:`global_stats`) backs the doctor's
    ``--integrity`` section and ``perf.py --validate``'s
    ``client_integrity`` row block; violations are additionally keyed by
    (kind, url) so a byzantine replica is NAMEABLE from the counters
    alone."""

    _RESERVOIR = 4096  # overhead samples kept for p50/p99 (ring)

    def __init__(self):
        self._lock = threading.Lock()
        self.checks = 0
        self.results = 0
        self.violations = 0
        self.violations_by_kind: Dict[str, int] = {}
        self.violations_by_url: Dict[str, int] = {}
        self._overhead_ns: List[int] = []
        self._overhead_pos = 0

    def record_checked(self, checks: int, overhead_ns: int) -> None:
        with self._lock:
            self.results += 1
            self.checks += checks
            if len(self._overhead_ns) < self._RESERVOIR:
                self._overhead_ns.append(overhead_ns)
            else:
                self._overhead_ns[self._overhead_pos] = overhead_ns
                self._overhead_pos = (self._overhead_pos + 1) % self._RESERVOIR
    def record_violation(self, kind: str, url: str) -> None:
        with self._lock:
            self.violations += 1
            self.violations_by_kind[kind] = (
                self.violations_by_kind.get(kind, 0) + 1)
            key = url or "<endpoint>"
            self.violations_by_url[key] = (
                self.violations_by_url.get(key, 0) + 1)

    def overhead_ns(self) -> Dict[str, Optional[float]]:
        with self._lock:
            samples = sorted(self._overhead_ns)
        if not samples:
            return {"p50": None, "p99": None, "samples": 0}
        def pct(q: float) -> float:
            idx = min(len(samples) - 1, int(q * (len(samples) - 1)))
            return float(samples[idx])
        return {"p50": pct(0.50), "p99": pct(0.99),
                "samples": len(samples)}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "results": self.results,
                "checks": self.checks,
                "violations": self.violations,
                "violations_by_kind": dict(self.violations_by_kind),
                "violations_by_url": dict(self.violations_by_url),
            }
        out["overhead_ns"] = self.overhead_ns()
        return out


_GLOBAL_STATS = IntegrityStats()


def global_stats() -> IntegrityStats:
    """The process-wide stats instance every policy folds into by
    default (doctor / perf read exactly this)."""
    return _GLOBAL_STATS


# -- policy -------------------------------------------------------------------

class IntegrityPolicy:
    """What to check, and the (cached) model metadata to check against.

    ``contract`` (default True) arms the structural checks on every
    unary result. ``digests`` opts shm/arena-resident outputs into
    ``arena.LeaseDigest`` sealing at response-finish time (verified at
    map time). ``stream_index`` opts SSE/decoupled streams into the
    strict per-stream index monotonicity check (see module docstring
    for why recovery layers keep this off).

    Metadata is NEVER fetched by the validator (zero extra RPCs): it is
    captured for free when the owning client fetches
    ``get_model_metadata`` (``_base`` calls :meth:`note_metadata`), or
    primed explicitly by a harness. One policy may be shared across
    clients — a pool's endpoints then validate against one fleet-wide
    contract, which is exactly what catches a single replica that
    disagrees with it.
    """

    def __init__(self, contract: bool = True, digests: bool = False,
                 stream_index: bool = False,
                 stats: Optional[IntegrityStats] = None):
        self.contract = contract
        self.digests = digests
        self.stream_index = stream_index
        self.stats = stats if stats is not None else _GLOBAL_STATS
        self._metadata_lock = threading.Lock()
        # model -> {output_name: (datatype, shape tuple or None)}
        self._metadata: Dict[str, Dict[str, Tuple[str, Optional[Tuple[int, ...]]]]] = {}

    # -- metadata cache ------------------------------------------------------
    def note_metadata(self, model_name: str, metadata: Any) -> None:
        """Fold a v2 model-metadata response (dict or object with
        ``.get``) into the contract cache. Malformed metadata is ignored
        — the cache only ever narrows what a response may claim."""
        try:
            outputs = metadata.get("outputs") or []
            table: Dict[str, Tuple[str, Optional[Tuple[int, ...]]]] = {}
            for out in outputs:
                name = out.get("name")
                datatype = out.get("datatype")
                if not isinstance(name, str) or not isinstance(datatype, str):
                    continue
                shape = out.get("shape")
                dims: Optional[Tuple[int, ...]] = None
                if isinstance(shape, (list, tuple)):
                    dims = tuple(int(d) for d in shape)
                table[name] = (datatype, dims)
        except Exception:
            return
        if table:
            with self._metadata_lock:
                self._metadata[model_name] = table

    def metadata_for(self, model_name: str) -> Optional[
            Dict[str, Tuple[str, Optional[Tuple[int, ...]]]]]:
        with self._metadata_lock:
            return self._metadata.get(model_name)


_DEFAULT_POLICY = IntegrityPolicy()


def default_policy() -> IntegrityPolicy:
    """The always-on process default every client validates under
    unless ``configure_integrity`` armed its own policy."""
    return _DEFAULT_POLICY


# -- stream checking ----------------------------------------------------------

# event keys accepted as the stream index (first match wins): the
# in-repo decode models emit ``INDEX``; generic decoupled responses may
# carry ``index`` / ``sequence_index``
_INDEX_KEYS = ("INDEX", "index", "sequence_index")


def event_index(event: Any) -> Optional[int]:
    """The stream index an SSE/decoupled event carries, or None."""
    if not isinstance(event, dict):
        return None
    for key in _INDEX_KEYS:
        value = event.get(key)
        if value is None:
            continue
        if isinstance(value, list):
            value = value[0] if value else None
        try:
            return int(value)
        except (TypeError, ValueError):
            return None
    return None


class StreamChecker:
    """Strict per-wire-stream index monotonicity: each indexed event
    must carry exactly ``previous + 1`` (the first indexed event pins
    the base). Duplicates, gaps and regressions raise a typed
    ``stream_index`` :class:`IntegrityError`; index-less events pass
    through uncounted."""

    __slots__ = ("url", "policy", "_next", "events")

    def __init__(self, url: str = "", policy: Optional[IntegrityPolicy] = None):
        self.url = url
        self.policy = policy if policy is not None else _DEFAULT_POLICY
        self._next: Optional[int] = None
        self.events = 0

    def observe(self, event: Any) -> Any:
        """Check one event; returns it unchanged for pipeline use."""
        index = event_index(event)
        if index is None:
            return event
        self.events += 1
        if self._next is not None and index != self._next:
            kind_expected = self._next
            self.policy.stats.record_violation("stream_index", self.url)
            _flight.note("integrity", "violation", kind="stream_index",
                         url=self.url, expected=kind_expected, actual=index)
            raise IntegrityError(
                "stream_index", self.url, "index", kind_expected, index)
        self._next = index + 1
        return event


# -- unary contract validation ------------------------------------------------

def _request_contract(inputs, outputs, request_id: str) -> Tuple[
        Optional[set], str, set]:
    """(requested output-name set or None when the server chooses,
    request id, class-mode output names) — extracted once per call.

    ``class_count`` outputs opt into the classification extension: the
    server REWRITES them to BYTES ``"value:idx:label"`` tensors of shape
    [class_count], so the cached metadata contract (the model's declared
    dtype/shape) deliberately does not apply to them."""
    requested: Optional[set] = None
    class_mode: set = set()
    if outputs:
        requested = set()
        for out in outputs:
            name = out.name() if callable(getattr(out, "name", None)) \
                else getattr(out, "name", "")
            requested.add(name)
            if getattr(out, "_class_count", 0):
                class_mode.add(name)
    return requested, request_id or "", class_mode


def _check_http_binary_tail(result, response: Dict[str, Any], url: str,
                            checks: List[int]) -> None:
    """HTTP only: the binary tail must be EXACTLY the sum of the header's
    binary_data_size claims — a response with trailing bytes nobody
    claimed (or an offsets map that under-consumes) is corrupt even when
    every per-output size is internally plausible."""
    buffer = getattr(result, "_buffer", None)
    offsets = getattr(result, "_offsets", None)
    if buffer is None or offsets is None:
        return
    checks[0] += 1
    binary_start = getattr(result, "_binary_start", len(buffer))
    claimed = sum(end - start for start, end in offsets.values())
    tail = len(buffer) - binary_start
    if claimed != tail:
        raise IntegrityError(
            "tail", url, "binary_tail",
            f"{claimed} claimed bytes", f"{tail} body bytes")


def _validate_output_entry(out: Dict[str, Any], url: str,
                           metadata, requested: Optional[set],
                           payload_nbytes: Optional[int],
                           payload, checks: List[int]) -> None:
    """Shared per-output checks over one response entry.

    ``payload_nbytes`` is the binary byte count the transport actually
    carries for this output (None when the output rode JSON data or a
    shared-memory region); ``payload`` is the raw buffer when available
    (BYTES framing is walked over it)."""
    name = out.get("name")
    if not isinstance(name, str) or not name:
        raise IntegrityError(
            "output_name", url, "name", "a named output", name)
    datatype = out.get("datatype", "")
    shape = out.get("shape", [])
    checks[0] += 1
    if requested is not None and name not in requested:
        raise IntegrityError(
            "output_name", url, name, sorted(requested), name)
    if not isinstance(shape, list) or any(
            (not isinstance(d, int)) or isinstance(d, bool) or d < 0
            for d in shape):
        raise IntegrityError("shape", url, name, "non-negative dims", shape)
    if metadata is not None:
        expected = metadata.get(name)
        if expected is not None:
            meta_dtype, meta_shape = expected
            checks[0] += 1
            if datatype != meta_dtype:
                raise IntegrityError(
                    "dtype", url, name, meta_dtype, datatype)
            if meta_shape is not None:
                # metadata dims: -1 is a free (batch/dynamic) axis; a
                # fixed axis must match exactly, and so must the rank
                checks[0] += 1
                if len(shape) != len(meta_shape):
                    raise IntegrityError(
                        "shape", url, name, list(meta_shape), shape)
                for got, want in zip(shape, meta_shape):
                    if want >= 0 and got != want:
                        raise IntegrityError(
                            "shape", url, name, list(meta_shape), shape)
    if payload_nbytes is None:
        return
    want = expected_nbytes(datatype, shape)
    if want is not None:
        checks[0] += 1
        if payload_nbytes != want:
            raise IntegrityError(
                "payload_size", url, name,
                f"{want} bytes for {datatype}{shape}",
                f"{payload_nbytes} bytes")
    elif datatype == "BYTES" and payload is not None:
        n_elems = 1
        for dim in shape:
            n_elems *= dim
        checks[0] += 1
        walk_bytes_framing(payload, n_elems, url, name)
    elif element_size(datatype) is None and datatype != "BYTES":
        raise IntegrityError(
            "dtype", url, name, "a known v2 datatype", datatype)


def _validate_http(result, url: str, metadata, requested: Optional[set],
                   checks: List[int]) -> None:
    response = result.get_response()
    _check_http_binary_tail(result, response, url, checks)
    offsets = getattr(result, "_offsets", {})
    buffer = getattr(result, "_buffer", b"")
    for out in response.get("outputs", []):
        name = out.get("name")
        params = out.get("parameters", {}) or {}
        payload_nbytes = None
        payload = None
        if isinstance(name, str) and name in offsets:
            start, end = offsets[name]
            payload_nbytes = end - start
            payload = buffer[start:end]
        elif "shared_memory_region" in params or "data" in out:
            payload_nbytes = None  # region- or JSON-resident
        _validate_output_entry(
            out, url, metadata, requested, payload_nbytes, payload, checks)


def _validate_grpc(result, url: str, metadata, requested: Optional[set],
                   checks: List[int]) -> None:
    response = result.get_response()
    raw = response.get("raw_output_contents", []) or []
    outputs = response.get("outputs", []) or []
    non_shm = [
        out for out in outputs
        if "shared_memory_region" not in (out.get("parameters") or {})
        and not out.get("contents")
    ]
    # raw_output_contents aligns with non-shm outputs IN ORDER: a short
    # or long raw list silently misaligns every later tensor
    if raw:
        checks[0] += 1
        if len(raw) != len(non_shm):
            raise IntegrityError(
                "tail", url, "raw_output_contents",
                f"{len(non_shm)} chunks", f"{len(raw)} chunks")
    raw_index = 0
    for out in outputs:
        params = out.get("parameters") or {}
        payload_nbytes = None
        payload = None
        if ("shared_memory_region" not in params
                and not out.get("contents")):
            if raw_index < len(raw):
                payload = raw[raw_index]
                payload_nbytes = len(payload)
            raw_index += 1
        _validate_output_entry(
            out, url, metadata, requested, payload_nbytes, payload, checks)


def validate_result(result, inputs=None, outputs=None, request_id: str = "",
                    url: str = "", model_name: str = "",
                    policy: Optional[IntegrityPolicy] = None) -> int:
    """Validate one unary ``InferResult`` against its request contract.

    Dispatches on the result's wire shape (HTTP byte-tail vs GRPC
    raw_output_contents), raising :class:`IntegrityError` on the first
    violation; returns the number of checks performed. The caller (the
    frontends' ``_integrity_check``) owns accounting and flight events.
    """
    active = policy if policy is not None else _DEFAULT_POLICY
    checks = [0]
    requested, want_id, class_mode = _request_contract(
        inputs, outputs, request_id)
    response = result.get_response()
    if want_id:
        checks[0] += 1
        got_id = response.get("id", "")
        if got_id != want_id:
            raise IntegrityError("request_id", url, "id", want_id, got_id)
    if requested is not None:
        checks[0] += 1
        got_names = [out.get("name")
                     for out in response.get("outputs", []) or []]
        missing = requested - set(got_names)
        if missing:
            raise IntegrityError(
                "output_name", url, ",".join(sorted(missing)),
                sorted(requested), sorted(n for n in got_names
                                          if isinstance(n, str)))
        if len(got_names) != len(set(got_names)):
            raise IntegrityError(
                "output_name", url, "outputs",
                "unique output names", got_names)
    metadata = active.metadata_for(model_name) if model_name else None
    if metadata and class_mode:
        # classification-extension outputs are rewritten server-side to
        # BYTES [class_count] tensors — the model's declared contract
        # does not describe them
        metadata = {k: v for k, v in metadata.items() if k not in class_mode}
    if hasattr(result, "_offsets"):
        _validate_http(result, url, metadata, requested, checks)
    else:
        _validate_grpc(result, url, metadata, requested, checks)
    return checks[0]


def check_result(result, inputs=None, outputs=None, request_id: str = "",
                 url: str = "", model_name: str = "",
                 policy: Optional[IntegrityPolicy] = None,
                 telemetry=None) -> None:
    """The frontends' one-call wrapper: validate + account.

    Times the validation, folds (checks, overhead) into the policy's
    stats, bumps the telemetry counters when a Telemetry is attached,
    and emits the ``integrity`` flight event on violation before
    re-raising."""
    active = policy if policy is not None else _DEFAULT_POLICY
    if not active.contract:
        return
    t0 = time.perf_counter_ns()
    try:
        checks = validate_result(
            result, inputs, outputs, request_id, url, model_name, active)
    except IntegrityError as e:
        active.stats.record_violation(e.kind, url)
        _flight.note("integrity", "violation", kind=e.kind, url=url,
                     field=e.field)
        if telemetry is not None:
            try:
                telemetry.integrity_violation(e.kind, url)
            except Exception:
                pass
        raise
    overhead = time.perf_counter_ns() - t0
    active.stats.record_checked(checks, overhead)
    if telemetry is not None:
        try:
            telemetry.integrity_checked("contract", url, checks)
        except Exception:
            pass


def note_parse_violation(err: IntegrityError, url: str = "",
                         telemetry=None,
                         policy: Optional[IntegrityPolicy] = None) -> None:
    """Attribute and account a parse-time :class:`IntegrityError`.

    Some violations (torn JSON header, binary sizes that overrun the
    body) are caught while *decoding* the response, before
    ``check_result`` ever runs — the decoder can't build a result object
    to validate. Decoders raise with ``url=""``; the frontend calls this
    to stamp its endpoint url on and fold the violation into the same
    stats / flight / telemetry streams, so a byzantine replica's torn
    responses count toward its quarantine exactly like contract lies.
    Parse violations are recorded even when contract checking is OFF: an
    undecodable body yields no result either way — the policy only
    chooses whether we *look* for lies, not whether torn bytes parse."""
    if url and not err.url:
        err.url = url
    active = policy if policy is not None else _DEFAULT_POLICY
    active.stats.record_violation(err.kind, err.url)
    _flight.note("integrity", "violation", kind=err.kind, url=err.url,
                 field=err.field)
    if telemetry is not None:
        try:
            telemetry.integrity_violation(err.kind, err.url)
        except Exception:
            pass
