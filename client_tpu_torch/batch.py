"""Client-side adaptive micro-batching: a coalescing infer dispatcher.

Every concurrent caller of ``infer()`` has, until now, paid full request
serialization and its own wire round-trip — even though the in-repo
server's ``DynamicBatcher`` happily executes stacked rows. This module
moves the batching decision to the CLIENT, where the aggregate arrival
stream is visible before it fans out into sockets: an opt-in wrapper (in
the style of ``client_tpu_torch.pool.PoolClient``) that queues concurrent
``infer()`` calls per compatibility key, stacks them along the batch
dimension into ONE KServe request, sends it once, and scatters the result
rows back to each caller::

    from client_tpu_torch.batch import BatchingClient

    client = BatchingClient("127.0.0.1:8000", protocol="http",
                            batch_max_rows=32)
    client.infer("batched_matmul", inputs)   # may ride a shared request

    # or wrap an existing client / pool (one coalesced request per
    # routing decision):
    client = PoolClient(urls, protocol="http").coalescing()

What coalesces, and what never does:

- **Compatibility key** — requests merge only when ``(model, version,
  per-input (name, dtype, shape[1:]), requested outputs, parameters,
  priority, timeouts, headers, compression)`` all agree. The key mirrors
  the server batcher's rule: merging across differing parameters would
  silently compute under the wrong ones.
- **Sequence requests NEVER coalesce** (``sequence_id != 0``): they carry
  server-side state transitions and are delegated verbatim to the inner
  client (which already pins/never-resends them).
- Shared-memory-bound tensors, JSON-staged (``binary_data=False``)
  tensors, per-request ``resilience=`` overrides, and requests already at
  or above ``batch_max_rows`` bypass to the inner client unchanged.

Dispatch mechanics (sync): leader/follower with zero extra threads. The
first caller into an idle queue becomes the *leader*: it waits out the
coalescing window (woken early when the queue reaches ``batch_max_rows``),
claims the queued calls, sends the stacked request, and scatters rows;
followers park on the queue's condition until their rows (or the batch's
typed error) arrive. Leadership hands off to a queued follower whenever a
claim leaves a remainder, so dispatches pipeline — a new batch can be
in-flight while the previous one is still on the wire. The asyncio twin
replaces the leader with a per-key flusher task and dispatches batches as
independent tasks.

**Adaptive window** — ``window_us=None`` (default) tunes the coalescing
window from EWMAs of the observed inter-arrival gap and wire service
time: the candidate window is ``gap * (batch_max_rows - 1)`` (just long
enough to fill a batch at the observed rate), capped at ``max_window_us``
AND at half the observed service time (so coalesced e2e latency stays
within ~1.5x while the batch size multiplies throughput); when the
candidate window would collect fewer than ~2 arrivals — a lone
closed-loop caller's gap IS the service time — the window is ZERO and
light traffic pays no added latency (a lone call is passed through
verbatim, original ``request_id`` included). The live window is exported
as the ``client_tpu_batch_window_us`` gauge.

Composition contract:

- **Under ``ResiliencePolicy``** — the dispatcher issues ONE inner
  ``infer``; the inner client's policy (retry/breaker) applies to the
  coalesced request, which is idempotent by construction (only
  non-sequence calls merge). A failed batch fans the SAME typed error out
  to every caller in it.
- **Behind ``PoolClient``** — wrap the pool: each coalesced request is one
  routing decision (one replica choice, one failover/hedge engine run) —
  and, with the pool's admission control armed (``client_tpu_torch.admission``),
  ONE admission decision: a coalesced batch admits once, and a shed batch
  fans the same typed ``AdmissionRejected`` to every caller (counted as
  ``shed_dispatches`` in :meth:`stats`, distinct from dispatch errors).
  Requests with different ``priority`` values never share a key, so the
  admission controller's lanes still see each caller's true priority.
- **Telemetry** — with an ``observe.Telemetry`` configured (or adopted
  from the inner client), every caller gets its own ``RequestSpan`` with a
  ``coalesce_queue`` phase (enqueue -> claim) and an ``attempt`` phase
  (the shared wire call), plus the ``client_tpu_batch_rows`` batch-size
  histogram, dispatch/mode counters and the window gauge on ``/metrics``.

The port of ``client_tpu.batch``: the same keys, stacked bodies and
window; ``as_torch`` places a caller's rows on a torch device.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import flight as _flight
from ._base import fold_infer_args
from ._tensor import InferInput
from .utils import InferenceServerException, sorted_percentile

__all__ = [
    "AioBatchingClient",
    "BatchingClient",
    "CoalescedInferResult",
    "plan_request",
]

# batch-size histogram edges (rows per dispatched wire request)
BATCH_ROWS_BUCKETS: Tuple[float, ...] = (
    1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
)

def plan_request(inputs, kwargs):
    """Shared eligibility + signature scan for the client-side wrapper
    layers — the coalescing dispatcher here and the response cache /
    singleflight collapser (``client_tpu_torch.cache``) reuse ONE exclusion
    matrix, so "what may coalesce" and "what may collapse or cache" can
    never drift apart. (The model name is not scanned here — each layer
    folds it into its own key.)

    Returns ``(sig, rows, raw_by_name, out_sig, extra_key)`` when the
    request is a plain, binary-staged, stateless infer:

    - ``sig``: sorted ``((name, datatype, shape-tail), ...)`` per input
    - ``rows``: the shared leading (batch) dimension
    - ``raw_by_name``: each input's staged binary payload
    - ``out_sig``: sorted requested-output signature (None = all outputs)
    - ``extra_key``: a canonical repr of every other semantic kwarg

    Returns None when the request must bypass: sequences (server-side
    state transitions), per-request ``resilience=`` overrides, shm-bound
    or JSON-staged tensors, per-tensor parameters, ragged/absent batch
    dims, and classification or shm-placed outputs."""
    if kwargs.get("sequence_id"):
        return None  # sequence semantics: NEVER merged or cached
    if kwargs.get("resilience") is not None:
        return None  # per-request policy override: honor it verbatim
    if not inputs:
        return None
    sig: List[Tuple[str, str, Tuple[int, ...]]] = []
    raw_by_name: Dict[str, Any] = {}
    rows: Optional[int] = None
    try:
        for inp in inputs:
            raw = inp._get_binary_data()
            if raw is None:
                return None  # shm-bound or JSON-staged tensor
            if inp._parameters:
                return None  # per-tensor parameters don't stack
            shape = inp.shape()
            if not shape:
                return None
            r = int(shape[0])
            if r < 1:
                return None
            if rows is None:
                rows = r
            elif rows != r:
                return None  # ragged batch dims can't scatter back
            sig.append((inp.name(), inp.datatype(),
                        tuple(int(d) for d in shape[1:])))
            raw_by_name[inp.name()] = raw
    except AttributeError:
        return None  # not the shared InferInput value model
    if rows is None:
        return None
    outputs = kwargs.get("outputs")
    out_sig = None
    if outputs:
        out_entries = []
        try:
            for out in outputs:
                if out._in_shared_memory() or out._class_count:
                    return None
                out_entries.append((out.name(), bool(out._binary_data)))
        except AttributeError:
            return None
        out_sig = tuple(sorted(out_entries))
    extra = {
        k: v for k, v in kwargs.items()
        # request_id is caller bookkeeping; affinity_key is a ROUTING
        # hint the pool pops before the wire — requests differing only by
        # session key produce identical answers, so they may share a
        # batch row, a singleflight, and a cache entry (the dispatched
        # request carries the first caller's key).
        # tenant= is deliberately NOT excluded: folding it here is THE
        # cross-tenant isolation point — cache keys, singleflight groups
        # and coalesced batches all partition by tenant in this one
        # place, so tenant A can never be served (or collapse onto)
        # tenant B's response. Tenantless callers (tenant=None) fall
        # under the `v is not None` filter and keep byte-identical keys.
        if k not in ("request_id", "outputs", "resilience", "affinity_key")
        and v is not None
        and not (k in ("sequence_id", "sequence_start", "sequence_end",
                       "priority") and not v)
    }
    try:
        extra_key = repr(sorted(extra.items()))
    except Exception:
        return None
    return tuple(sorted(sig)), rows, raw_by_name, out_sig, extra_key


_EWMA_ALPHA = 0.2  # inter-arrival gap / service-time smoothing
# adaptive windows never exceed this fraction of the observed wire service
# time: a batch may wait at most half a round-trip, bounding the coalesced
# e2e latency to ~1.5x while the batch size multiplies throughput
_SERVICE_FRAC = 0.5
# a window is only worth opening when it is expected to collect at least
# this many arrivals (window / ewma_gap); below it, dispatch immediately
_MIN_EXPECTED_ARRIVALS = 1.5


class _PendingCall:
    """One caller's infer, queued for coalescing."""

    __slots__ = ("inputs", "sig", "raw", "kwargs", "rows", "span",
                 "enqueued_ns", "claimed", "done", "result", "error",
                 "future", "batch_rows", "batch_calls")

    def __init__(self, inputs, sig, raw, kwargs, rows, span):
        self.inputs = inputs      # the caller's original InferInput list
        self.sig = sig            # ((name, datatype, tail), ...) sorted
        self.raw = raw            # name -> staged binary payload
        self.kwargs = kwargs
        self.rows = rows
        self.span = span
        self.enqueued_ns = time.perf_counter_ns()
        self.claimed = False
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None
        self.future = None        # aio only
        # stamped at settle so the CALLER's thread/task can annotate its
        # own flight timeline with the batch it rode
        self.batch_rows = 0
        self.batch_calls = 0


class _SyncKeyState:
    """One compatibility key's queue (sync client). All mutable fields are
    guarded by ``cond``; ``leader`` is the call currently running the
    window/claim cycle (None between cycles)."""

    __slots__ = ("cond", "items", "rows", "leader", "model",
                 "last_arrival_ns", "ewma_gap_ns", "ewma_service_ns",
                 "window_us")

    def __init__(self, model: str):
        self.cond = threading.Condition()
        self.items: deque = deque()
        self.rows = 0
        self.leader = None
        self.model = model
        self.last_arrival_ns = 0
        self.ewma_gap_ns: Optional[float] = None
        self.ewma_service_ns: Optional[float] = None
        self.window_us = 0.0

    def busy(self) -> bool:
        return bool(self.items) or self.leader is not None


class _AioKeyState:
    """One compatibility key's queue (asyncio client; loop-confined, so no
    lock — mutations only happen between awaits)."""

    __slots__ = ("items", "rows", "task", "wake", "model",
                 "last_arrival_ns", "ewma_gap_ns", "ewma_service_ns",
                 "window_us")

    def __init__(self, model: str):
        self.items: deque = deque()
        self.rows = 0
        self.task: Optional[asyncio.Task] = None
        self.wake = asyncio.Event()
        self.model = model
        self.last_arrival_ns = 0
        self.ewma_gap_ns: Optional[float] = None
        self.ewma_service_ns: Optional[float] = None
        self.window_us = 0.0

    def busy(self) -> bool:
        return bool(self.items) or self.task is not None


class _SharedBatchResult:
    """The decoded view of one coalesced response, shared by every
    caller's row slice: each output tensor is decoded ONCE (on first
    access, under a lock) no matter how many callers slice it."""

    __slots__ = ("result", "total_rows", "_lock", "_arrays")

    def __init__(self, result: Any, total_rows: int):
        self.result = result
        self.total_rows = total_rows
        self._lock = threading.Lock()
        self._arrays: Dict[str, Any] = {}

    def array(self, name: str):
        with self._lock:
            if name not in self._arrays:
                arr = self.result.as_numpy(name)
                if arr is not None and (
                        arr.ndim == 0 or arr.shape[0] != self.total_rows):
                    raise InferenceServerException(
                        f"coalesced output '{name}' has shape "
                        f"{getattr(arr, 'shape', None)}; expected leading "
                        f"dimension {self.total_rows}",
                        status="COALESCE_SCATTER")
                self._arrays[name] = arr
            return self._arrays[name]


class CoalescedInferResult:
    """One caller's row slice of a coalesced response.

    Quacks like the frontends' ``InferResult``: ``as_numpy`` returns a
    zero-copy view of this caller's rows, ``get_output``/``get_response``
    rewrite shapes to the slice, and transport extras (e.g.
    ``get_response_header``) delegate to the underlying batch result.
    ``batch_result()`` is the escape hatch to the full response."""

    __slots__ = ("_shared", "_start", "_stop")

    def __init__(self, shared: _SharedBatchResult, start: int, stop: int):
        self._shared = shared
        self._start = start
        self._stop = stop

    def as_numpy(self, name: str):
        arr = self._shared.array(name)
        if arr is None:
            return None
        return arr[self._start:self._stop]

    def as_torch(self, name: str, device="cuda"):
        """This caller's rows of output ``name`` on ``device`` (one H2D
        copy)."""
        arr = self.as_numpy(name)
        if arr is None:
            return None
        import numpy as np

        if arr.dtype == np.object_:
            raise InferenceServerException(
                "BYTES outputs cannot be placed on device")
        from .utils import numpy_to_tensor

        return numpy_to_tensor(arr, device)

    def get_output(self, name: str) -> Optional[Dict[str, Any]]:
        out = self._shared.result.get_output(name)
        if out is None:
            return None
        out = dict(out)
        shape = list(out.get("shape") or ())
        if shape:
            shape[0] = self._stop - self._start
            out["shape"] = shape
        params = out.get("parameters")
        if params:
            # per-batch byte counts don't describe the slice
            params = {k: v for k, v in params.items()
                      if k != "binary_data_size"}
            if params:
                out["parameters"] = params
            else:
                out.pop("parameters", None)
        return out

    def get_response(self) -> Dict[str, Any]:
        resp = dict(self._shared.result.get_response())
        outputs = []
        for out in resp.get("outputs", []) or []:
            sliced = self.get_output(out.get("name"))
            if sliced is not None:
                outputs.append(sliced)
        resp["outputs"] = outputs
        resp.pop("raw_output_contents", None)  # grpc: rows live in as_numpy
        return resp

    def get_response_header(self, name: str, default=None):
        getter = getattr(self._shared.result, "get_response_header", None)
        if getter is None:
            return default
        return getter(name, default)

    def batch_result(self):
        """The undivided transport result the whole batch shares."""
        return self._shared.result


class _BatchingCore:
    """Construction, eligibility, key/queue bookkeeping, stacking, scatter
    and accounting shared by the sync and asyncio wrappers."""

    _AIO = False
    _MAX_STATES = 512  # idle-key pruning threshold

    def __init__(
        self,
        client,
        protocol: str = "http",
        window_us: Optional[float] = None,
        max_window_us: float = 20000.0,
        batch_max_rows: int = 32,
        telemetry=None,
    ):
        """``client``: an existing frontend/pool client to wrap, or a
        ``host:port`` url (built with ``protocol``, sync or aio to match
        this wrapper; ``close()`` closes the inner client either way).
        ``window_us``: fixed coalescing window in microseconds; ``None``
        (default) auto-tunes from the observed arrival rate, capped at
        ``max_window_us``. ``batch_max_rows`` bounds the stacked batch
        dimension — size it to the serving model's ``max_batch_size``.
        ``telemetry``: an ``observe.Telemetry``; when omitted, the inner
        client's configured telemetry is adopted."""
        if batch_max_rows < 1:
            raise ValueError("batch_max_rows must be >= 1")
        if window_us is not None and window_us < 0:
            raise ValueError("window_us must be >= 0")
        if max_window_us <= 0:
            raise ValueError("max_window_us must be > 0")
        if isinstance(client, str):
            from .pool import _default_client_factory

            client = _default_client_factory(protocol, self._AIO)(client)
        self._inner = client
        self.window_us = window_us
        self.max_window_us = float(max_window_us)
        self.batch_max_rows = int(batch_max_rows)
        self._frontend = f"{getattr(client, '_FRONTEND', 'client')}+batch"
        self._states: Dict[Any, Any] = {}
        self._states_lock = threading.Lock()
        self._closed = False
        # running stats (always on; cheap slots + a bounded deque)
        self._stats_lock = threading.Lock()
        self._dispatches = 0
        self._coalesced = 0
        self._solo = 0
        self._bypass = 0
        self._dispatch_errors = 0
        self._shed_dispatches = 0
        self._recent_rows: deque = deque(maxlen=4096)
        self._last_window_us = 0.0
        # telemetry instruments: one (rows, dispatch, calls, errors,
        # window) tuple swapped atomically so a concurrent dispatch reads
        # all five or none (configure_telemetry may run mid-traffic)
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
        """Install (or clear) the telemetry this dispatcher reports into:
        per-caller spans with a ``coalesce_queue`` phase, the batch-size
        histogram, dispatch/mode counters and the window gauge. The inner
        client's own telemetry (tracing the wire request) is configured
        separately on the inner client."""
        self._telemetry = telemetry
        if telemetry is None:
            self._instruments = None
            return self
        reg = telemetry.registry
        self._instruments = (
            reg.histogram(
                "client_tpu_batch_rows",
                "Rows per dispatched (possibly coalesced) infer request",
                ("model",), buckets=BATCH_ROWS_BUCKETS),
            reg.counter(
                "client_tpu_batch_dispatch_total",
                "Wire requests issued by the coalescing dispatcher",
                ("model",)),
            reg.counter(
                "client_tpu_batch_calls_total",
                "Caller-level infers by dispatch mode",
                ("model", "mode")),
            reg.counter(
                "client_tpu_batch_errors_total",
                "Dispatched batches that failed (error fanned out to every "
                "caller)", ("model",)),
            reg.gauge(
                "client_tpu_batch_window_us",
                "Live coalescing window per model (auto-tuned unless "
                "window_us is fixed)", ("model",)),
        )
        return self

    def telemetry(self):
        return self._telemetry

    def configure_resilience(self, policy):
        """Resilience belongs to the inner client: the coalesced request
        runs under whatever policy the wrapped client (or pool) carries."""
        return self._inner.configure_resilience(policy)

    def configure_arena(self, arena):
        """The shm arena belongs to the inner client too: arena-leased
        (shm-param) inputs bypass coalescing verbatim, while plain binary
        inputs coalesce and the JOINED batch payload is promoted into one
        leased slab at dispatch — zero-copy batching end to end. Returns
        this wrapper (not the inner client) so configuration chains."""
        self._inner.configure_arena(arena)
        return self

    def arena(self):
        return self._inner.arena()

    def stats(self) -> Dict[str, Any]:
        """A snapshot of dispatcher behavior: dispatch/solo/coalesced/
        bypass counts, the live window, and batch-size percentiles over
        the most recent dispatches."""
        with self._stats_lock:
            rows = sorted(self._recent_rows)
            return {
                "dispatches": self._dispatches,
                "coalesced_calls": self._coalesced,
                "solo_calls": self._solo,
                "bypass_calls": self._bypass,
                "dispatch_errors": self._dispatch_errors,
                "shed_dispatches": self._shed_dispatches,
                "window_us": round(self._last_window_us, 1),
                "batch_rows": {
                    "p50": sorted_percentile(rows, 0.5),
                    "p99": sorted_percentile(rows, 0.99),
                    "max": rows[-1] if rows else 0,
                    "mean": round(sum(rows) / len(rows), 2) if rows else 0.0,
                },
            }

    # -- eligibility / compatibility key -------------------------------------
    def _plan(self, model_name: str, inputs, kwargs):
        """``(key, rows, raw_by_name, sig)`` when this call may coalesce,
        else None (bypass to the inner client unchanged). Eligibility and
        signatures come from the shared :func:`plan_request` scan."""
        plan = plan_request(inputs, kwargs)
        if plan is None:
            return None
        sig_t, rows, raw_by_name, out_sig, extra_key = plan
        if rows >= self.batch_max_rows:
            return None  # already a full batch: nothing to gain by queueing
        key = (model_name, sig_t, out_sig, extra_key)
        return key, rows, raw_by_name, sig_t

    def _new_state(self, model: str):
        raise NotImplementedError

    def _state_for(self, key, model: str):
        with self._states_lock:
            state = self._states.get(key)
            if state is None:
                if len(self._states) >= self._MAX_STATES:
                    for k in [k for k, s in self._states.items()
                              if not s.busy()]:
                        del self._states[k]
                state = self._new_state(model)
                self._states[key] = state
            return state

    # -- adaptive window ------------------------------------------------------
    def _note_arrival(self, state) -> None:
        now = time.perf_counter_ns()
        last = state.last_arrival_ns
        state.last_arrival_ns = now
        if last:
            gap = float(now - last)
            ewma = state.ewma_gap_ns
            state.ewma_gap_ns = (
                gap if ewma is None else ewma + _EWMA_ALPHA * (gap - ewma))

    def _window_s(self, state) -> float:
        if self.window_us is not None:
            window_us = self.window_us
        else:
            # the window worth waiting: long enough to fill a batch at the
            # observed arrival rate, but never more than max_window_us nor
            # half the observed service time (so the coalesced e2e stays
            # within ~1.5x while the batch size multiplies throughput)
            gap_ns = state.ewma_gap_ns
            window_us = 0.0
            if gap_ns is not None and gap_ns > 0.0:
                target_ns = gap_ns * (self.batch_max_rows - 1)
                cap_ns = self.max_window_us * 1e3
                service_ns = state.ewma_service_ns
                if service_ns is not None:
                    cap_ns = min(cap_ns, service_ns * _SERVICE_FRAC)
                target_ns = min(target_ns, cap_ns)
                # light traffic: a window expecting fewer than ~2 arrivals
                # (a lone closed-loop caller's gap IS the service time)
                # only adds latency — dispatch immediately instead
                if target_ns / gap_ns >= _MIN_EXPECTED_ARRIVALS:
                    window_us = target_ns / 1e3
        state.window_us = window_us
        self._last_window_us = window_us
        return window_us / 1e6

    @staticmethod
    def _note_service(state, wire_ns: int) -> None:
        ewma = state.ewma_service_ns
        state.ewma_service_ns = (
            float(wire_ns) if ewma is None
            else ewma + _EWMA_ALPHA * (wire_ns - ewma))

    # -- claiming / stacking / scatter ----------------------------------------
    def _claim(self, state) -> List[_PendingCall]:
        """Pop a batch (FIFO, up to ``batch_max_rows`` rows) off the
        queue. The head is always taken even when oversized — it cannot
        be split."""
        cap = self.batch_max_rows
        items = state.items
        batch: List[_PendingCall] = []
        rows = 0
        while items:
            nxt = items[0]
            if batch and rows + nxt.rows > cap:
                break
            items.popleft()
            nxt.claimed = True
            batch.append(nxt)
            rows += nxt.rows
            if rows >= cap:
                break
        state.rows -= rows
        return batch

    def _stack(self, batch: List[_PendingCall]):
        """One stacked request for the whole batch: per-input payloads are
        concatenated along axis 0 (raw row-major bytes concatenate
        directly — this holds for fixed-width dtypes, BF16 and the
        length-prefixed BYTES wire format alike), and the shared kwargs
        are the key-identical first caller's minus its request_id."""
        first = batch[0]
        total = sum(c.rows for c in batch)
        inputs = []
        for name, datatype, tail in first.sig:
            inp = InferInput(name, [total, *tail], datatype)
            inp._raw_data = b"".join(c.raw[name] for c in batch)
            inputs.append(inp)
        kwargs = dict(first.kwargs)
        kwargs.pop("request_id", None)
        return inputs, kwargs, total

    @staticmethod
    def _check_batch_shapes(result, total_rows: int) -> None:
        """Cheap pre-scatter validation off the response header: every
        output must carry ``total_rows`` leading rows, or the mismatch is
        fanned out as a typed error instead of mis-sliced data."""
        for out in result.get_response().get("outputs", []) or []:
            shape = out.get("shape") or []
            if not shape or int(shape[0]) != total_rows:
                raise InferenceServerException(
                    f"coalesced response output {out.get('name')!r} has "
                    f"shape {list(shape)}; expected leading dimension "
                    f"{total_rows}", status="COALESCE_SCATTER")

    def _scatter(self, parent, batch: List[_PendingCall], total_rows: int):
        shared = _SharedBatchResult(parent, total_rows)
        offset = 0
        for call in batch:
            call.result = CoalescedInferResult(
                shared, offset, offset + call.rows)
            offset += call.rows

    # -- accounting -----------------------------------------------------------
    def _count_bypass(self, model: str) -> None:
        with self._stats_lock:
            self._bypass += 1
        instruments = self._instruments
        if instruments is not None:
            instruments[2].labels(model, "bypass").inc()

    @staticmethod
    def _is_shed(error: Optional[BaseException]) -> bool:
        """Was this dispatch shed by admission control?"""
        from .admission import ADMISSION_REJECTED_STATUS

        return (isinstance(error, InferenceServerException)
                and error.status() == ADMISSION_REJECTED_STATUS)

    def _account_dispatch(self, state, batch: List[_PendingCall],
                          total_rows: int, error: bool,
                          shed: bool = False) -> None:
        n = len(batch)
        with self._stats_lock:
            self._dispatches += 1
            self._recent_rows.append(total_rows)
            if n == 1:
                self._solo += 1
            else:
                self._coalesced += n
            if shed:
                # a shed batch is honest load-shedding, not a dispatch
                # failure — accounted separately so error_rate math stays
                # truthful under overload
                self._shed_dispatches += 1
            elif error:
                self._dispatch_errors += 1
        instruments = self._instruments
        if instruments is not None:
            m_rows, m_dispatch, m_calls, m_errors, m_window = instruments
            model = state.model
            m_rows.labels(model).observe(total_rows)
            m_dispatch.labels(model).inc()
            m_calls.labels(model, "solo" if n == 1 else "coalesced").inc(n)
            if error and not shed:
                m_errors.labels(model).inc()
            m_window.labels(model).set(round(state.window_us, 1))

    def _finish_spans(self, batch: List[_PendingCall], t_wire0: int,
                      t_wire1: int, total_rows: int,
                      error: Optional[BaseException]) -> None:
        tel = self._telemetry
        if tel is None:
            return
        for call in batch:
            span = call.span
            if span is None:
                continue
            span.phase("coalesce_queue", call.enqueued_ns, t_wire0)
            span.phase("attempt", t_wire0, t_wire1)
            span.event("coalesced", rows=call.rows, batch_rows=total_rows,
                       batch_calls=len(batch))
            tel.finish(span, error=error)

    def _begin_span(self, model: str):
        tel = self._telemetry
        if tel is None:
            return None
        return tel.begin(self._frontend, model)

    # -- composition -----------------------------------------------------------
    def caching(self, **kwargs):
        """Wrap THIS batching client in the hot-key layer (cache outside
        batching: hits skip the coalescing window, misses may still ride
        a batch). Without this override ``__getattr__`` would delegate to
        the inner client and silently compose the cache around the POOL
        instead — dropping the batching layer from the chain."""
        from .cache import AioCachingClient, CachingClient

        cls = AioCachingClient if self._AIO else CachingClient
        return cls(self, **kwargs)

    # -- generic surface delegation -------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._inner, name)


class BatchingClient(_BatchingCore):
    """Synchronous coalescing wrapper over any sync frontend or pool.

    ``infer`` runs the dispatcher; every other method is delegated to the
    inner client untouched."""

    _AIO = False

    def _new_state(self, model: str) -> _SyncKeyState:
        return _SyncKeyState(model)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        self._inner.close()

    def __enter__(self) -> "BatchingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- inference -------------------------------------------------------------
    def infer(self, model_name: str, inputs, *args, **kwargs):
        """Coalescing ``infer`` (drop-in: positional arguments follow the
        frontends' shared prefix). Sequence requests, shm/JSON tensors and
        per-request resilience overrides bypass to the inner client; a
        lone eligible call is passed through verbatim (zero rewrite)."""
        kwargs = fold_infer_args(args, kwargs)
        # materialize first: _plan iterates inputs, and a generator would
        # reach the inner client (or the passthrough) exhausted
        inputs = list(inputs) if inputs is not None else inputs
        plan = self._plan(model_name, inputs, kwargs)
        if plan is None:
            self._count_bypass(model_name)
            return self._inner.infer(model_name, inputs, **kwargs)
        key, rows, raw, sig = plan
        call = _PendingCall(inputs, sig, raw, kwargs, rows,
                            self._begin_span(model_name))
        scratch = _flight.layer_begin(self._telemetry, "batch", model_name)
        _flight.note("batch", "join", rows=rows)
        if scratch is None:
            return self._infer_queued(model_name, key, call)
        try:
            result = self._infer_queued(model_name, key, call)
        except BaseException as e:
            _flight.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight.layer_commit(self._telemetry, scratch)
        return result

    def _infer_queued(self, model_name: str, key, call: _PendingCall):
        """The queue/lead/follow engine behind :meth:`infer` (split out so
        the flight-recorder wrapper above owns one scratch per caller)."""
        state = self._state_for(key, model_name)
        with state.cond:
            self._note_arrival(state)
            state.items.append(call)
            state.rows += call.rows
            if (state.leader is not None
                    and state.rows >= self.batch_max_rows):
                state.cond.notify_all()  # wake the leader: batch is full
        while True:
            batch = None
            with state.cond:
                while not call.done:
                    if state.leader is None and not call.claimed:
                        state.leader = call
                        batch = self._lead_locked(state)
                        break
                    state.cond.wait()
                if call.done:
                    break
            # leader duty continues OUTSIDE the lock: the wire call must
            # not serialize new arrivals (they queue for the next leader)
            self._dispatch(state, batch)
            # the claimed batch may not include this call (row-cap
            # overflow): loop back to follow — or lead — again
        _flight.note("batch", "dispatched", rows=call.rows,
                     batch_rows=call.batch_rows,
                     batch_calls=call.batch_calls)
        if call.error is not None:
            raise call.error
        return call.result

    # -- leader duty ----------------------------------------------------------
    def _lead_locked(self, state: _SyncKeyState) -> List[_PendingCall]:
        """Wait out the coalescing window (cut short when the queue
        reaches the row cap), then claim the batch and hand leadership
        off. Caller holds ``state.cond``."""
        cap = self.batch_max_rows
        window_s = self._window_s(state)
        if window_s > 0.0 and state.rows < cap:
            deadline = time.monotonic() + window_s
            while state.rows < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    break
                state.cond.wait(remaining)
        batch = self._claim(state)
        state.leader = None
        state.cond.notify_all()  # a queued follower takes the next cycle
        return batch

    def _dispatch(self, state: _SyncKeyState,
                  batch: List[_PendingCall]) -> None:
        if not batch:
            return
        t0 = time.perf_counter_ns()
        total_rows = sum(c.rows for c in batch)
        error: Optional[BaseException] = None
        try:
            if len(batch) == 1:
                # verbatim passthrough: identical to an uncoalesced call
                call = batch[0]
                call.result = self._inner.infer(
                    state.model, call.inputs, **call.kwargs)
            else:
                inputs, kwargs, total_rows = self._stack(batch)
                parent = self._inner.infer(state.model, inputs, **kwargs)
                self._check_batch_shapes(parent, total_rows)
                self._scatter(parent, batch, total_rows)
        except BaseException as e:
            error = e
        t1 = time.perf_counter_ns()
        # unblock the parked followers FIRST: accounting/span bookkeeping
        # must never sit between a caller and its result (nor, if it ever
        # misbehaved, strand the batch)
        self._settle(state, batch, error)
        if error is None:
            self._note_service(state, t1 - t0)
        self._account_dispatch(state, batch, total_rows,
                               error=error is not None,
                               shed=self._is_shed(error))
        self._finish_spans(batch, t0, t1, total_rows, error)
        if error is not None and not isinstance(error, Exception):
            raise error  # KeyboardInterrupt/SystemExit: don't swallow

    def _settle(self, state: _SyncKeyState, batch: List[_PendingCall],
                error: Optional[BaseException]) -> None:
        total_rows = sum(c.rows for c in batch)
        n = len(batch)
        with state.cond:
            for call in batch:
                call.batch_rows = total_rows
                call.batch_calls = n
                call.error = error
                call.done = True
            state.cond.notify_all()


class AioBatchingClient(_BatchingCore):
    """Asyncio twin of :class:`BatchingClient` over the aio frontends (or
    an ``AioPoolClient``). A per-key flusher task replaces the leader;
    batches dispatch as independent tasks so they pipeline."""

    _AIO = True

    def __init__(self, client, **kwargs):
        super().__init__(client, **kwargs)
        self._dispatch_tasks: set = set()

    def _new_state(self, model: str) -> _AioKeyState:
        return _AioKeyState(model)

    # -- lifecycle -----------------------------------------------------------
    async def close(self) -> None:
        self._closed = True
        closed_exc = InferenceServerException(
            "batching client closed", status="499")
        for state in list(self._states.values()):
            if state.task is not None:
                state.task.cancel()
            while state.items:
                call = state.items.popleft()
                state.rows -= call.rows
                if call.future is not None and not call.future.done():
                    call.future.set_exception(closed_exc)
        if self._dispatch_tasks:
            await asyncio.gather(
                *list(self._dispatch_tasks), return_exceptions=True)
        result = self._inner.close()
        if asyncio.iscoroutine(result):
            await result

    async def __aenter__(self) -> "AioBatchingClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- inference -------------------------------------------------------------
    async def infer(self, model_name: str, inputs, *args, **kwargs):
        """Coalescing async ``infer`` (same eligibility/bypass contract as
        the sync twin)."""
        kwargs = fold_infer_args(args, kwargs)
        # materialize first (see the sync twin): _plan iterates inputs
        inputs = list(inputs) if inputs is not None else inputs
        plan = self._plan(model_name, inputs, kwargs)
        if plan is None or self._closed:
            self._count_bypass(model_name)
            return await self._inner.infer(model_name, inputs, **kwargs)
        key, rows, raw, sig = plan
        call = _PendingCall(inputs, sig, raw, kwargs, rows,
                            self._begin_span(model_name))
        call.future = asyncio.get_running_loop().create_future()
        scratch = _flight.layer_begin(self._telemetry, "batch", model_name)
        _flight.note("batch", "join", rows=rows)
        state = self._state_for(key, model_name)
        self._note_arrival(state)
        state.items.append(call)
        state.rows += call.rows
        if state.task is None:
            state.task = asyncio.ensure_future(self._flush_loop(state))
        elif state.rows >= self.batch_max_rows:
            state.wake.set()  # cut the window short: batch is full
        if scratch is None:
            return await call.future
        try:
            result = await call.future
        except BaseException as e:
            _flight.note("batch", "dispatched", rows=call.rows,
                         batch_rows=call.batch_rows,
                         batch_calls=call.batch_calls)
            _flight.layer_commit(self._telemetry, scratch, error=e)
            raise
        _flight.note("batch", "dispatched", rows=call.rows,
                     batch_rows=call.batch_rows,
                     batch_calls=call.batch_calls)
        _flight.layer_commit(self._telemetry, scratch)
        return result

    # -- flusher --------------------------------------------------------------
    async def _flush_loop(self, state: _AioKeyState) -> None:
        try:
            while state.items:
                window_s = self._window_s(state)
                if window_s > 0.0 and state.rows < self.batch_max_rows:
                    state.wake.clear()
                    try:
                        await asyncio.wait_for(state.wake.wait(), window_s)
                    except asyncio.TimeoutError:
                        pass
                batch = self._claim(state)
                if not batch:
                    break
                # dispatch as its own task: the flusher keeps claiming
                # while previous batches are still on the wire
                task = asyncio.ensure_future(self._dispatch(state, batch))
                self._dispatch_tasks.add(task)
                task.add_done_callback(self._dispatch_tasks.discard)
        finally:
            # reset synchronously with the final items-check: arrivals only
            # run between awaits, so none can slip in unflushed
            state.task = None

    async def _dispatch(self, state: _AioKeyState,
                        batch: List[_PendingCall]) -> None:
        t0 = time.perf_counter_ns()
        total_rows = sum(c.rows for c in batch)
        error: Optional[BaseException] = None
        try:
            if len(batch) == 1:
                call = batch[0]
                call.result = await self._inner.infer(
                    state.model, call.inputs, **call.kwargs)
            else:
                inputs, kwargs, total_rows = self._stack(batch)
                parent = await self._inner.infer(
                    state.model, inputs, **kwargs)
                self._check_batch_shapes(parent, total_rows)
                self._scatter(parent, batch, total_rows)
        except BaseException as e:
            error = e
        t1 = time.perf_counter_ns()
        # settle the callers first (see the sync twin)
        n = len(batch)
        for call in batch:
            call.batch_rows = total_rows
            call.batch_calls = n
            if call.future is None or call.future.done():
                continue  # cancelled caller: nothing to deliver
            if error is not None:
                call.future.set_exception(error)
            else:
                call.future.set_result(call.result)
        if error is None:
            self._note_service(state, t1 - t0)
        self._account_dispatch(state, batch, total_rows,
                               error=error is not None,
                               shed=self._is_shed(error))
        self._finish_spans(batch, t0, t1, total_rows, error)
        if error is not None and not isinstance(error, Exception):
            raise error
