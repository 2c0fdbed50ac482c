"""Client base: plugin hook, auth, request bag, cumulative client statistics.

The counterpart of ``client_tpu._base``: the plugin/auth hook, the request
header bag, ``RequestTimers`` (with the host<->device transfer points),
``InferStat``, and the hooks every frontend routes its transport through:
telemetry (``observe``: request and stream spans, the ``traceparent`` on
the wire, ORCA endpoint load), data-plane accounting of the shm
register/unregister calls, response integrity (``integrity``),
resilience (``resilience``), the shm arena (``arena``: staged inputs
promoted into leased slabs, cached region registrations), and the
``coalescing()`` / ``caching()`` wrappers (``batch``, ``cache``) with the
positional-prefix folding they and the pool share.
"""

from __future__ import annotations

import abc
import base64
import contextvars
import threading
import time
from typing import Dict, Optional, Tuple

from . import observe as _observe

# wire family segment -> data-plane accounting family
SHM_FAMILY_OF = {
    "systemsharedmemory": "system",
    "cudasharedmemory": "cuda",
}

# the four frontends' infer() signatures share this positional prefix;
# folding positionals into kwargs lets the wrapper layers (pool, batch)
# stay drop-in replacements for code that calls e.g. client.infer("m",
# inputs, "2")
INFER_POSITIONAL_PREFIX = (
    "model_version", "outputs", "request_id", "sequence_id",
    "sequence_start", "sequence_end", "priority", "timeout",
    "client_timeout", "headers",
)


def _any_arena_lease(inputs, outputs) -> bool:
    """Does any tensor of this request carry an arena lease? (The no-arena
    hot path pays one class-attribute check per tensor and nothing else.)"""
    for inp in inputs:
        if getattr(inp, "_arena_lease", None) is not None:
            return True
    for out in outputs or ():
        if getattr(out, "_arena_lease", None) is not None:
            return True
    return False


# admission-queue phase handoff: the pool's admission gate runs BEFORE a
# frontend's request span exists, so it stashes the wait interval in a
# contextvar (thread- and task-local) and the next span begun on the same
# thread/task claims it as an ``admission_queue`` phase. Consume-once, so
# an admitted-then-errored call can never donate its wait to a later
# request. (Hedged attempts run on executor threads that don't inherit
# the caller's context — their spans simply skip the phase.)
_ADMISSION_PHASE: contextvars.ContextVar = contextvars.ContextVar(
    "client_tpu_admission_phase", default=None)


def stash_admission_phase(start_ns: int, end_ns: int) -> None:
    """Record an admission-queue wait for the next span on this context."""
    _ADMISSION_PHASE.set((start_ns, end_ns))


def consume_admission_phase() -> Optional[Tuple[int, int]]:
    value = _ADMISSION_PHASE.get()
    if value is not None:
        _ADMISSION_PHASE.set(None)
    return value


def fold_infer_args(args, kwargs):
    """Fold ``infer``'s shared positional prefix into ``kwargs``."""
    if len(args) > len(INFER_POSITIONAL_PREFIX):
        raise TypeError(
            "too many positional arguments to wrapped infer(); the "
            f"frontends diverge after {INFER_POSITIONAL_PREFIX[-1]!r} — "
            "pass the rest by keyword")
    for name, value in zip(INFER_POSITIONAL_PREFIX, args):
        if name in kwargs:
            raise TypeError(f"infer() got multiple values for argument {name!r}")
        kwargs[name] = value
    return kwargs


class Request:
    """A mutable view of an outgoing request handed to plugins (headers bag)."""

    def __init__(self, headers: Dict[str, str]):
        self.headers = headers


class InferenceServerClientPlugin(abc.ABC):
    """A plugin is invoked with the Request before every network operation.

    Subclass and implement ``__call__`` to mutate headers (auth tokens,
    tracing ids, ...).
    """

    @abc.abstractmethod
    def __call__(self, request: Request) -> None:
        ...


class BasicAuth(InferenceServerClientPlugin):
    """HTTP basic auth plugin: sets the ``authorization`` header."""

    def __init__(self, username: str, password: str):
        creds = f"{username}:{password}".encode("utf-8")
        self._auth_header = "Basic " + base64.b64encode(creds).decode("ascii")

    def __call__(self, request: Request) -> None:
        request.headers["authorization"] = self._auth_header


class InferenceServerClientBase:
    """Holds the (single) registered plugin and applies it before network ops,
    plus the shared resilience hook every frontend routes its transport
    through (see ``client_tpu_torch.resilience``)."""

    # telemetry frontend label ("http", "grpc", "http_aio", "grpc_aio");
    # wrapper layers derive theirs from it (e.g. batch -> "http+batch")
    _FRONTEND = "client"
    # which batching wrapper coalescing() builds (aio frontends flip this)
    _BATCH_AIO = False

    def __init__(self):
        self._plugin: Optional[InferenceServerClientPlugin] = None
        self._resilience = None  # Optional[resilience.ResiliencePolicy]
        self._telemetry = None  # Optional[observe.Telemetry]
        # None = process-default integrity policy; False = disabled;
        # else an integrity.IntegrityPolicy
        self._integrity = None
        self._shm_arena = None  # Optional[arena.ShmArena]

    def _call_plugin(self, request: Request) -> None:
        if self._plugin is not None:
            self._plugin(request)

    # -- observability -------------------------------------------------------
    def configure_telemetry(self, telemetry) -> "InferenceServerClientBase":
        """Install an ``observe.Telemetry`` (or None to clear) that every
        inference of this client reports into: request-phase spans, a
        ``traceparent`` header/metadata key on the wire, and the pre-wired
        metrics. Pay-for-what-you-use: with no telemetry configured the
        transport paths check one attribute and do nothing else."""
        self._telemetry = telemetry
        return self

    def telemetry(self):
        return self._telemetry

    def _obs_begin(self, frontend: str, model: str):
        """A request span when telemetry is configured, else None — the
        single hot-path gate all four frontends share. A pending
        admission-queue wait stashed by the pool's admission gate is
        claimed onto the new span as its first phase. With a flight
        recorder armed, the span's trace id is bound onto the active
        flight scratch (or a span-owned scratch opens — this frontend is
        the outermost layer — which ``Telemetry.finish`` settles)."""
        tel = self._telemetry
        if tel is None:
            return None
        span = tel.begin(frontend, model)
        flight = getattr(tel, "flight", None)
        if flight is not None:
            flight.span_begin(span, getattr(self, "_url", None))
        pending = consume_admission_phase()
        if pending is not None:
            span.phase("admission_queue", pending[0], pending[1])
        return span

    def _obs_begin_stream(self, frontend: str, model: str,
                          op: str = "generate_stream"):
        """A stream span when telemetry is configured, else None — the
        streaming twin of ``_obs_begin`` (SSE generate streams and GRPC
        bidi streams)."""
        tel = self._telemetry
        if tel is None:
            return None
        return tel.begin_stream(frontend, model, op)

    # -- data plane ----------------------------------------------------------
    def configure_arena(self, arena) -> "InferenceServerClientBase":
        """Install a ``client_tpu_torch.arena.ShmArena`` (``True`` = the
        process default arena; ``None`` to clear) as this client's
        zero-copy data plane: binary-staged inputs are transparently
        promoted into leased slabs at ``infer()`` time, arena-leased
        inputs/outputs get their region registrations ensured (an RPC only
        on first use per endpoint), and ``InferResult.as_numpy`` serves
        zero-copy views over leased output slabs."""
        if arena is True:
            from .arena import default_arena

            arena = default_arena()
        self._shm_arena = arena
        return self

    def arena(self):
        return self._shm_arena

    def _arena_bind(self, inputs, outputs, promote: bool = True):
        """Per-request arena binding for the sync frontends: None when the
        request touches no arena state (the common no-arena hot path costs
        one attribute check per tensor)."""
        arena = self._shm_arena
        if arena is None and not _any_arena_lease(inputs, outputs):
            return None
        from . import arena as _arena_mod

        return _arena_mod.bind_request(self, arena, inputs, outputs,
                                       promote=promote)

    async def _arena_bind_async(self, inputs, outputs, promote: bool = True):
        """Asyncio twin of :meth:`_arena_bind`."""
        arena = self._shm_arena
        if arena is None and not _any_arena_lease(inputs, outputs):
            return None
        from . import arena as _arena_mod

        return await _arena_mod.bind_request_async(
            self, arena, inputs, outputs, promote=promote)

    def _shm_call(self, family: str, op: str, call, *args,
                  region_name: Optional[str] = None, **kwargs):
        """Run one shm register/unregister RPC under data-plane accounting
        (registration latency + outcome). With no process-global recorder
        installed this is one attribute check around the plain call.
        A successful unregister also notifies the arena registration
        caches (``region_name``: the unregistered region; "" = all)."""
        rec = _observe._DATAPLANE
        if rec is None:
            result = call(*args, **kwargs)
        else:
            t0 = time.perf_counter_ns()
            try:
                result = call(*args, **kwargs)
            except BaseException:
                rec.on_rpc(self._FRONTEND, family, op,
                           (time.perf_counter_ns() - t0) * 1e-9, ok=False)
                raise
            rec.on_rpc(self._FRONTEND, family, op,
                       (time.perf_counter_ns() - t0) * 1e-9)
        if op == "unregister" and region_name is not None:
            self._arena_notify_unregister(region_name)
        return result

    async def _shm_call_async(self, family: str, op: str, call, *args,
                              region_name: Optional[str] = None, **kwargs):
        """Async twin of :meth:`_shm_call` for the aio frontends."""
        rec = _observe._DATAPLANE
        if rec is None:
            result = await call(*args, **kwargs)
        else:
            t0 = time.perf_counter_ns()
            try:
                result = await call(*args, **kwargs)
            except BaseException:
                rec.on_rpc(self._FRONTEND, family, op,
                           (time.perf_counter_ns() - t0) * 1e-9, ok=False)
                raise
            rec.on_rpc(self._FRONTEND, family, op,
                       (time.perf_counter_ns() - t0) * 1e-9)
        if op == "unregister" and region_name is not None:
            self._arena_notify_unregister(region_name)
        return result

    def _arena_notify_unregister(self, region_name: str) -> None:
        """Tell every live arena the server no longer holds the
        registration (cache entries for this endpoint are dropped so the
        next use re-issues the RPC). Lazy lookup: processes that never
        touch the arena never load it."""
        import sys

        arena_mod = sys.modules.get("client_tpu_torch.arena")
        if arena_mod is not None:
            arena_mod.notify_unregister(
                getattr(self, "_url", None), region_name)

    # -- ORCA endpoint load ---------------------------------------------------
    def _orca_opt_in(self, hdrs: Dict[str, str]) -> Dict[str, str]:
        """Stamp the ORCA opt-in request header when the configured
        telemetry declared an ``orca_format`` (caller-set values win)."""
        tel = self._telemetry
        if tel is not None and tel.orca_format is not None:
            hdrs.setdefault(
                _observe.ENDPOINT_LOAD_FORMAT_HEADER, tel.orca_format)
        return hdrs

    def _orca_ingest(self, result) -> None:
        """Feed a response's ORCA header (if any) into the telemetry's
        per-endpoint load gauges. Missing header → nothing happens, so
        this is safe to call on every infer."""
        tel = self._telemetry
        if tel is None:
            return
        value = result.get_response_header(_observe.ENDPOINT_LOAD_HEADER)
        if value is not None:
            tel.ingest_endpoint_load(self._url, value)

    # -- response integrity --------------------------------------------------
    def configure_integrity(self, policy) -> "InferenceServerClientBase":
        """Install an ``integrity.IntegrityPolicy`` (``True`` = the process
        default; ``None`` restores the default; ``False`` disables
        validation for this client). Contract validation runs under the
        process-default policy even when nothing is configured — every
        ``InferResult`` is checked against its request before the caller
        sees it (see docs/integrity.md)."""
        if policy is True:
            from .integrity import default_policy

            policy = default_policy()
        self._integrity = policy
        return self

    def integrity_policy(self):
        """The effective policy: the configured one, the process default
        when unconfigured, or None when explicitly disabled."""
        policy = self._integrity
        if policy is None:
            from .integrity import default_policy

            return default_policy()
        if policy is False:
            return None
        return policy

    def _integrity_check(self, result, inputs=None, outputs=None,
                         request_id: str = "", model_name: str = "") -> None:
        """Validate one unary ``InferResult`` before it reaches the caller.

        Raises ``integrity.IntegrityError`` (status INTEGRITY_VIOLATION →
        resilience's INVALID domain) on any contract violation; on the
        happy path it is pure arithmetic over bytes already in memory."""
        policy = self._integrity
        if policy is False:
            return
        from . import integrity as _integrity

        _integrity.check_result(
            result, inputs, outputs, request_id,
            url=getattr(self, "_url", "") or "", model_name=model_name,
            policy=policy, telemetry=self._telemetry)

    def _integrity_parse_note(self, err) -> None:
        """Stamp this client's url on a parse-time ``IntegrityError`` (a
        body the decoder could not even parse — torn JSON, overrun binary
        sizes) and account it into the same stats/flight/telemetry
        streams as post-parse contract violations. The caller re-raises;
        parse violations bypass the contract on/off switch because an
        undecodable body yields no result either way."""
        from . import integrity as _integrity

        policy = self._integrity
        _integrity.note_parse_violation(
            err, url=getattr(self, "_url", "") or "",
            telemetry=self._telemetry,
            policy=policy if policy not in (None, False) else None)

    def _integrity_note_metadata(self, model_name: str, metadata) -> None:
        """Fold a just-fetched model-metadata response into the effective
        policy's contract cache — the only way the cache is ever
        populated (responses never teach the contract: a byzantine
        replica answering first could otherwise poison it)."""
        policy = self.integrity_policy()
        if policy is not None and model_name:
            policy.note_metadata(model_name, metadata)

    def _integrity_stream_checker(self, model_name: str = ""):
        """A per-stream ``integrity.StreamChecker`` when the effective
        policy opted into stream-index checks, else None."""
        policy = self.integrity_policy()
        if policy is None or not policy.stream_index:
            return None
        from .integrity import StreamChecker

        return StreamChecker(getattr(self, "_url", "") or "", policy)

    # -- resilience ---------------------------------------------------------
    def configure_resilience(self, policy) -> "InferenceServerClientBase":
        """Install a ``resilience.ResiliencePolicy`` (or None to clear) that
        every network operation of this client runs under. Pay-for-what-you-
        use: with no policy configured the transport paths are untouched."""
        self._resilience = policy
        return self

    def resilience_policy(self):
        return self._resilience

    def _resilience_for(self, override):
        """The effective policy for one request (per-request override hook).

        ``override=False`` explicitly bypasses the configured policy — the
        health-probe paths use it so a probe observes the endpoint itself,
        never an open circuit breaker's fast-fail."""
        if override is False:
            return None
        return override if override is not None else self._resilience

    # -- micro-batching -----------------------------------------------------
    def coalescing(self, **kwargs):
        """Wrap this client in the opt-in coalescing dispatcher
        (``client_tpu_torch.batch``): concurrent compatible ``infer()``
        calls are stacked into one KServe request within an adaptive
        window and the result rows scattered back per caller. Returns a
        ``BatchingClient`` (or the asyncio twin for aio frontends); the
        client's configured telemetry is adopted automatically."""
        from .batch import AioBatchingClient, BatchingClient

        cls = AioBatchingClient if self._BATCH_AIO else BatchingClient
        return cls(self, **kwargs)

    # -- hot-key serving ----------------------------------------------------
    def caching(self, **kwargs):
        """Wrap this client in the opt-in singleflight + response-cache
        layer (``client_tpu_torch.cache``): concurrent identical
        ``infer()`` calls collapse onto one wire request, and repeated
        content keys are served from a bounded LRU+TTL cache as zero-copy
        arena views. Returns a ``CachingClient`` (or the asyncio twin for
        aio frontends); the client's configured telemetry is adopted
        automatically. Compose OUTSIDE ``.coalescing()`` — hits skip the
        coalescing window, misses may still ride a batch."""
        from .cache import AioCachingClient, CachingClient

        cls = AioCachingClient if self._BATCH_AIO else CachingClient
        return cls(self, **kwargs)

    def register_plugin(self, plugin: InferenceServerClientPlugin) -> None:
        if plugin is None:
            raise ValueError("cannot register a null plugin")
        if self._plugin is not None:
            raise ValueError("A plugin is already registered. Unregister it first.")
        self._plugin = plugin

    def plugin(self) -> Optional[InferenceServerClientPlugin]:
        return self._plugin

    def unregister_plugin(self) -> None:
        if self._plugin is None:
            raise ValueError("No plugin is registered.")
        self._plugin = None


class RequestTimers:
    """Per-request monotonic nanosecond timestamps.

    The reference's six points plus two device-transfer points (host->device
    and device->host staging around the wire/shm hop).
    """

    REQUEST_START = "REQUEST_START"
    REQUEST_END = "REQUEST_END"
    SEND_START = "SEND_START"
    SEND_END = "SEND_END"
    RECV_START = "RECV_START"
    RECV_END = "RECV_END"
    H2D_START = "H2D_START"  # host->device staging
    H2D_END = "H2D_END"
    D2H_START = "D2H_START"  # device->host staging
    D2H_END = "D2H_END"

    __slots__ = ("_ts",)

    def __init__(self):
        self._ts: Dict[str, int] = {}

    def capture(self, kind: str) -> None:
        self._ts[kind] = time.perf_counter_ns()

    def get(self, kind: str) -> Optional[int]:
        return self._ts.get(kind)

    def duration_ns(self, start_kind: str, end_kind: str) -> int:
        s, e = self._ts.get(start_kind), self._ts.get(end_kind)
        if s is None or e is None or e < s:
            return 0
        return e - s


class InferStat:
    """Cumulative client-side inference statistics (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.completed_request_count = 0
        self.cumulative_total_request_time_ns = 0
        self.cumulative_send_time_ns = 0
        self.cumulative_receive_time_ns = 0
        self.cumulative_h2d_time_ns = 0
        self.cumulative_d2h_time_ns = 0

    def update(self, timers: RequestTimers) -> None:
        with self._lock:
            self.completed_request_count += 1
            self.cumulative_total_request_time_ns += timers.duration_ns(
                RequestTimers.REQUEST_START, RequestTimers.REQUEST_END
            )
            self.cumulative_send_time_ns += timers.duration_ns(
                RequestTimers.SEND_START, RequestTimers.SEND_END
            )
            self.cumulative_receive_time_ns += timers.duration_ns(
                RequestTimers.RECV_START, RequestTimers.RECV_END
            )
            self.cumulative_h2d_time_ns += timers.duration_ns(
                RequestTimers.H2D_START, RequestTimers.H2D_END
            )
            self.cumulative_d2h_time_ns += timers.duration_ns(
                RequestTimers.D2H_START, RequestTimers.D2H_END
            )

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return {
                "completed_request_count": self.completed_request_count,
                "cumulative_total_request_time_ns": self.cumulative_total_request_time_ns,
                "cumulative_send_time_ns": self.cumulative_send_time_ns,
                "cumulative_receive_time_ns": self.cumulative_receive_time_ns,
                "cumulative_h2d_time_ns": self.cumulative_h2d_time_ns,
                "cumulative_d2h_time_ns": self.cumulative_d2h_time_ns,
            }

    def __str__(self) -> str:
        d = self.as_dict()
        n = max(d["completed_request_count"], 1)
        return (
            f"completed_request_count {d['completed_request_count']}\n"
            f"avg_request_time_us {d['cumulative_total_request_time_ns'] // n // 1000}\n"
            f"avg_send_time_us {d['cumulative_send_time_ns'] // n // 1000}\n"
            f"avg_receive_time_us {d['cumulative_receive_time_ns'] // n // 1000}\n"
            f"avg_h2d_time_us {d['cumulative_h2d_time_ns'] // n // 1000}\n"
            f"avg_d2h_time_us {d['cumulative_d2h_time_ns'] // n // 1000}"
        )
