"""Synchronous KServe v2 GRPC client.

The counterpart of ``client_tpu.grpc.InferenceServerClient``: infer,
async_infer (a cancellable CallContext), the bidi stream with sequence
support, and the admin surface (health, metadata, config, repository,
statistics, trace and log settings, system and cuda shared memory) over
generic grpc callables bound to the schema-driven wire codec (no generated
stubs). Request frames and metadata are byte-identical to the JAX
package's for the same inputs.

Every call runs under the client's resilience policy, reports into its
telemetry (request spans, the ``traceparent`` metadata key, ORCA endpoint
load), and every ``InferResult`` is checked against its request
(``integrity``); ``start_stream(auto_reconnect=True)`` re-establishes a dead
bidi stream. The tpu shared-memory rpcs are left out; the port's device
data plane is cuda.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import grpc

from .._base import InferenceServerClientBase, InferStat, Request, RequestTimers
from .._tensor import InferInput, InferRequestedOutput
from ..observe import TRACEPARENT_HEADER
from ..resilience import FATAL, AttemptBudget, StreamReconnected, classify_fault
from ..utils import InferenceServerException
from . import _messages as M
from ._infer import (
    InferResult,
    build_infer_request,
    from_infer_parameter,
    to_grpc_compression,
)
from ._stream import _InferStream, _ReconnectingStream
from ._wire import decode_message, encode_message

INT32_MAX = 2**31 - 1


class KeepAliveOptions:
    """GRPC keepalive configuration (maps to grpc channel args)."""

    def __init__(
        self,
        keepalive_time_ms: int = INT32_MAX,
        keepalive_timeout_ms: int = 20000,
        keepalive_permit_without_calls: bool = False,
        http2_max_pings_without_data: int = 2,
    ):
        self.keepalive_time_ms = keepalive_time_ms
        self.keepalive_timeout_ms = keepalive_timeout_ms
        self.keepalive_permit_without_calls = keepalive_permit_without_calls
        self.http2_max_pings_without_data = http2_max_pings_without_data


def channel_options(keepalive_options: Optional[KeepAliveOptions],
                    channel_args: Optional[List]) -> List:
    """The channel arguments both GRPC clients open their channel with."""
    if channel_args is not None:
        return list(channel_args)
    ka = keepalive_options or KeepAliveOptions()
    return [
        ("grpc.max_send_message_length", INT32_MAX),
        ("grpc.max_receive_message_length", INT32_MAX),
        ("grpc.keepalive_time_ms", ka.keepalive_time_ms),
        ("grpc.keepalive_timeout_ms", ka.keepalive_timeout_ms),
        ("grpc.keepalive_permit_without_calls", int(ka.keepalive_permit_without_calls)),
        ("grpc.http2.max_pings_without_data", ka.http2_max_pings_without_data),
    ]


def ssl_credentials(root_certificates, private_key, certificate_chain):
    """Channel credentials from PEM file paths (each may be None)."""
    def read(path):
        if not path:
            return None
        with open(path, "rb") as f:
            return f.read()

    return grpc.ssl_channel_credentials(
        read(root_certificates), read(private_key), read(certificate_chain))


def callables_for(channel, method: str, streaming: bool = False):
    """A unary or stream-stream callable for ``method`` on ``channel``,
    bound to the wire codec's specs for its request and response."""
    req_spec, resp_spec = M.METHODS[method]
    kwargs = dict(
        request_serializer=lambda d: encode_message(req_spec, d),
        response_deserializer=lambda b: decode_message(resp_spec, b),
    )
    if streaming:
        return channel.stream_stream(M.method_path(method), **kwargs)
    return channel.unary_unary(M.method_path(method), **kwargs)


def trace_request(model_name, settings) -> Dict[str, Any]:
    """A TraceSettingRequest dict: every value as a list of strings, None
    as a cleared setting."""
    req: Dict[str, Any] = {"settings": {}}
    if model_name:
        req["model_name"] = model_name
    for key, value in (settings or {}).items():
        if value is None:
            req["settings"][key] = {}
        elif isinstance(value, (list, tuple)):
            req["settings"][key] = {"value": [str(v) for v in value]}
        else:
            req["settings"][key] = {"value": [str(value)]}
    return req


def log_request(settings) -> Dict[str, Any]:
    """A LogSettingsRequest dict (bool, uint32 or string per setting)."""
    req: Dict[str, Any] = {"settings": {}}
    for key, value in (settings or {}).items():
        if isinstance(value, bool):
            req["settings"][key] = {"bool_param": value}
        elif isinstance(value, int):
            req["settings"][key] = {"uint32_param": value}
        else:
            req["settings"][key] = {"string_param": str(value)}
    return req


def load_request(model_name, config, files) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    if config is not None:
        params["config"] = {"string_param": config}
    for path, content in (files or {}).items():
        params[path] = {"bytes_param": content}
    req: Dict[str, Any] = {"model_name": model_name}
    if params:
        req["parameters"] = params
    return req


def unload_request(model_name, unload_dependents) -> Dict[str, Any]:
    return {
        "model_name": model_name,
        "parameters": {"unload_dependents": {"bool_param": unload_dependents}},
    }


def trace_settings_of(response) -> Dict[str, Any]:
    return {k: v.get("value", []) for k, v in response.get("settings", {}).items()}


def log_settings_of(response) -> Dict[str, Any]:
    return {k: from_infer_parameter(v) for k, v in response.get("settings", {}).items()}


def cuda_register_request(name, raw_handle, device_id, byte_size) -> Dict[str, Any]:
    if isinstance(raw_handle, str):
        raw_handle = raw_handle.encode("ascii")
    return {"name": name, "raw_handle": raw_handle, "device_id": device_id,
            "byte_size": byte_size}


class CallContext:
    """Handle for an in-flight async_infer supporting cancellation."""

    def __init__(self, future: "grpc.Future"):
        self._future = future

    def cancel(self) -> bool:
        return self._future.cancel()

    def get_result(self, timeout: Optional[float] = None) -> InferResult:
        try:
            result = InferResult(self._future.result(timeout=timeout))
        except grpc.RpcError as e:
            raise _to_exception(e) from e
        try:
            # the future is the call: its response metadata, as on the
            # unary path
            result._response_headers = flatten_metadata(
                self._future.initial_metadata(), self._future.trailing_metadata())
        except Exception:
            pass
        return result


def flatten_metadata(*metadata_pairs) -> Dict[str, str]:
    """Initial and trailing response metadata as one ``{key: value}`` dict
    (string values only; binary ``-bin`` entries are skipped): what the
    infer paths stash as ``InferResult._response_headers``."""
    out: Dict[str, str] = {}
    for pairs in metadata_pairs:
        for key, value in pairs or ():
            if isinstance(value, str):
                out[key] = value
    return out


def _to_exception(rpc_error: grpc.RpcError) -> InferenceServerException:
    code = rpc_error.code() if hasattr(rpc_error, "code") else None
    details = rpc_error.details() if hasattr(rpc_error, "details") else str(rpc_error)
    if code == grpc.StatusCode.DEADLINE_EXCEEDED:
        return InferenceServerException("Deadline Exceeded", status="StatusCode.DEADLINE_EXCEEDED")
    return InferenceServerException(
        details, status=f"StatusCode.{code.name}" if code else None
    )


class InferenceServerClient(InferenceServerClientBase):
    """Client for the KServe v2 GRPC protocol."""

    _FRONTEND = "grpc"

    def __init__(
        self,
        url: str,
        verbose: bool = False,
        ssl: bool = False,
        root_certificates: Optional[str] = None,
        private_key: Optional[str] = None,
        certificate_chain: Optional[str] = None,
        creds: Optional["grpc.ChannelCredentials"] = None,
        keepalive_options: Optional[KeepAliveOptions] = None,
        channel_args: Optional[List] = None,
    ):
        super().__init__()
        self._url = url
        self._verbose = verbose
        options = channel_options(keepalive_options, channel_args)
        if creds is None and ssl:
            creds = ssl_credentials(root_certificates, private_key, certificate_chain)
        if creds is not None:
            self._channel = grpc.secure_channel(url, creds, options=options)
        else:
            self._channel = grpc.insecure_channel(url, options=options)
        self._callables: Dict[str, Callable] = {}
        self._stream: Optional[_InferStream] = None
        self._stream_span = None  # Optional[observe.StreamSpan]
        self._stream_lock = threading.Lock()
        self._infer_stat = InferStat()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self.stop_stream()
        self._channel.close()

    def __enter__(self) -> "InferenceServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def client_infer_stat(self) -> Dict[str, int]:
        """Cumulative client-side inference statistics (see InferStat)."""
        return self._infer_stat.as_dict()

    # -- transport ---------------------------------------------------------
    def _callable(self, method: str, streaming: bool = False):
        c = self._callables.get(method)
        if c is None:
            c = self._callables[method] = callables_for(self._channel, method, streaming)
        return c

    def _metadata(self, headers: Optional[Dict[str, str]]):
        request = Request(dict(headers or {}))
        self._call_plugin(request)
        return tuple(request.headers.items()) or None

    def _call(
        self,
        method: str,
        request: Dict[str, Any],
        headers: Optional[Dict[str, str]] = None,
        client_timeout: Optional[float] = None,
        compression_algorithm: Optional[str] = None,
        idempotent: bool = True,
        resilience=None,
        span=None,
        metadata_sink: Optional[Dict[str, str]] = None,
    ) -> Dict[str, Any]:
        """One unary call under the client's resilience policy (or the
        per-request ``resilience`` override; ``False`` bypasses it).

        ``metadata_sink``: when given, the call runs through ``with_call``
        and the response's initial and trailing metadata (string values
        only) land in the dict — the GRPC twin of HTTP response headers
        (e.g. ORCA's ``endpoint-load-metrics``)."""
        if self._verbose:
            print(f"{method}, metadata {headers or {}}\n{request}")
        policy = self._resilience_for(resilience)
        budget = AttemptBudget(policy, client_timeout)

        def attempt() -> Dict[str, Any]:
            attempt_timeout = budget.attempt_timeout_s(status="StatusCode.DEADLINE_EXCEEDED")
            try:
                if metadata_sink is None:
                    return self._callable(method)(
                        request,
                        metadata=self._metadata(headers),
                        timeout=attempt_timeout,
                        compression=to_grpc_compression(compression_algorithm),
                    )
                response, call = self._callable(method).with_call(
                    request,
                    metadata=self._metadata(headers),
                    timeout=attempt_timeout,
                    compression=to_grpc_compression(compression_algorithm),
                )
                metadata_sink.clear()  # a retried attempt must not mix in
                metadata_sink.update(flatten_metadata(
                    call.initial_metadata(), call.trailing_metadata()))
                return response
            except grpc.RpcError as e:
                raise _to_exception(e) from e

        run_attempt = attempt
        on_retry = None
        if span is not None:
            def run_attempt():
                t_a = time.perf_counter_ns()
                try:
                    result = attempt()
                except BaseException:
                    span.phase("attempt", t_a, time.perf_counter_ns())
                    raise
                end = time.perf_counter_ns()
                span.phase("attempt", t_a, end)
                # a unary call's send, server time and first byte are not
                # separable, so the successful attempt is the ttfb window
                span.phase("ttfb", t_a, end)
                return result

            def on_retry(n, exc, delay):
                span.event("retry", attempt=n, backoff_s=round(delay, 6),
                           error=type(exc).__name__)

        if policy is None:
            response = run_attempt()
        else:
            # UNAVAILABLE/RESOURCE_EXHAUSTED re-attempt under the policy; a
            # sequence infer only on never-sent connect failures
            response = policy.execute(
                run_attempt, idempotent=idempotent, timeout_s=client_timeout,
                on_retry=on_retry)
        if self._verbose:
            print(response)
        return response

    # -- health / metadata -------------------------------------------------
    def _health(self, method, field, headers, client_timeout, probe: bool) -> bool:
        """Shared ServerLive/ServerReady call. By default transport failures
        raise (the typed UNAVAILABLE/DEADLINE_EXCEEDED from ``_call``), so
        callers tell "the server said no" from "could not ask".
        ``probe=True`` maps connect/transient/timeout-class failures to
        False and bypasses the resilience policy."""
        try:
            resp = self._call(method, {}, headers, client_timeout,
                              resilience=False if probe else None)
        except InferenceServerException as e:
            if probe and classify_fault(e) != FATAL:
                return False
            raise
        return bool(resp.get(field, False))

    def is_server_live(self, headers=None, client_timeout=None, probe: bool = False) -> bool:
        return self._health("ServerLive", "live", headers, client_timeout, probe)

    def is_server_ready(self, headers=None, client_timeout=None, probe: bool = False) -> bool:
        return self._health("ServerReady", "ready", headers, client_timeout, probe)

    def is_model_ready(self, model_name, model_version="", headers=None, client_timeout=None) -> bool:
        # transport errors propagate; a served-but-unknown model comes back
        # ready=False
        req = {"name": model_name, "version": model_version}
        return bool(self._call("ModelReady", req, headers, client_timeout).get("ready", False))

    def get_server_metadata(self, headers=None, client_timeout=None, as_json=True) -> Dict[str, Any]:
        # as_json is accepted for signature compatibility; results are always
        # dicts (there is no protobuf message object to return)
        return self._call("ServerMetadata", {}, headers, client_timeout)

    def get_model_metadata(
        self, model_name, model_version="", headers=None, client_timeout=None,
        as_json=True,
    ) -> Dict[str, Any]:
        metadata = self._call(
            "ModelMetadata", {"name": model_name, "version": model_version},
            headers, client_timeout,
        )
        # captured into the integrity contract cache: later responses are
        # validated against this fetched truth (never the other way round)
        self._integrity_note_metadata(model_name, metadata)
        return metadata

    def get_model_config(
        self, model_name, model_version="", headers=None, client_timeout=None,
        as_json=True,
    ) -> Dict[str, Any]:
        return self._call(
            "ModelConfig", {"name": model_name, "version": model_version},
            headers, client_timeout,
        )

    # -- repository --------------------------------------------------------
    def get_model_repository_index(self, headers=None, client_timeout=None) -> List[Dict[str, Any]]:
        return self._call("RepositoryIndex", {}, headers, client_timeout).get("models", [])

    def load_model(
        self, model_name, headers=None, config: Optional[str] = None,
        files: Optional[Dict[str, bytes]] = None, client_timeout=None,
    ) -> None:
        self._call("RepositoryModelLoad", load_request(model_name, config, files),
                   headers, client_timeout)

    def unload_model(
        self, model_name, headers=None, unload_dependents: bool = False, client_timeout=None
    ) -> None:
        self._call("RepositoryModelUnload", unload_request(model_name, unload_dependents),
                   headers, client_timeout)

    # -- statistics / trace / log ------------------------------------------
    def get_inference_statistics(
        self, model_name="", model_version="", headers=None, client_timeout=None,
        as_json=True,
    ) -> Dict[str, Any]:
        return self._call(
            "ModelStatistics", {"name": model_name, "version": model_version},
            headers, client_timeout,
        )

    def update_trace_settings(
        self, model_name=None, settings: Optional[Dict[str, Any]] = None,
        headers=None, client_timeout=None,
    ) -> Dict[str, Any]:
        return trace_settings_of(self._call(
            "TraceSetting", trace_request(model_name, settings), headers, client_timeout))

    def get_trace_settings(self, model_name=None, headers=None, client_timeout=None) -> Dict[str, Any]:
        req = {"model_name": model_name} if model_name else {}
        return trace_settings_of(self._call("TraceSetting", req, headers, client_timeout))

    def update_log_settings(self, settings: Dict[str, Any], headers=None, client_timeout=None) -> Dict[str, Any]:
        return log_settings_of(self._call(
            "LogSettings", log_request(settings), headers, client_timeout))

    def get_log_settings(self, headers=None, client_timeout=None) -> Dict[str, Any]:
        return log_settings_of(self._call("LogSettings", {}, headers, client_timeout))

    # -- shared memory -----------------------------------------------------
    def _shm_status(self, method, region_name, headers, client_timeout) -> List[Dict[str, Any]]:
        resp = self._call(method, {"name": region_name}, headers, client_timeout)
        return list(resp.get("regions", {}).values())

    def get_system_shared_memory_status(
        self, region_name="", headers=None, client_timeout=None
    ) -> List[Dict[str, Any]]:
        return self._shm_status("SystemSharedMemoryStatus", region_name, headers, client_timeout)

    def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, client_timeout=None
    ) -> None:
        self._shm_call(
            "system", "register", self._call, "SystemSharedMemoryRegister",
            {"name": name, "key": key, "offset": offset, "byte_size": byte_size},
            headers, client_timeout,
        )

    def unregister_system_shared_memory(self, name="", headers=None, client_timeout=None) -> None:
        self._shm_call("system", "unregister", self._call, "SystemSharedMemoryUnregister",
                       {"name": name}, headers, client_timeout, region_name=name)

    def get_cuda_shared_memory_status(self, region_name="", headers=None, client_timeout=None):
        return self._shm_status("CudaSharedMemoryStatus", region_name, headers, client_timeout)

    def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, client_timeout=None
    ) -> None:
        """Register a cuda_shared_memory region by its base64 raw handle
        (see ``utils.cuda_shared_memory.get_raw_handle``)."""
        self._shm_call("cuda", "register", self._call, "CudaSharedMemoryRegister",
                       cuda_register_request(name, raw_handle, device_id, byte_size),
                       headers, client_timeout)

    def unregister_cuda_shared_memory(self, name="", headers=None, client_timeout=None) -> None:
        self._shm_call("cuda", "unregister", self._call, "CudaSharedMemoryUnregister",
                       {"name": name}, headers, client_timeout, region_name=name)

    # -- inference ---------------------------------------------------------
    def infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        client_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        parameters: Optional[Dict[str, Any]] = None,
        compression_algorithm: Optional[str] = None,
        resilience=None,
    ) -> InferResult:
        """Run a synchronous inference.

        ``resilience``: per-request ``ResiliencePolicy`` override (``False``
        bypasses the policy). Sequence requests (``sequence_id != 0``) are
        non-idempotent: only never-sent connect failures are retried."""
        span = self._obs_begin(self._FRONTEND, model_name)
        timers = RequestTimers()
        timers.capture(RequestTimers.REQUEST_START)
        actx = None
        try:
            # arena data plane: promote staged binary inputs into leased
            # slabs and ensure (cached) region registrations BEFORE the
            # request is built, so it rides shm params
            actx = self._arena_bind(inputs, outputs)
            request = build_infer_request(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
            )
            hdrs = self._orca_opt_in(dict(headers or {}))
            if span is not None:
                hdrs[TRACEPARENT_HEADER] = span.traceparent()
                span.phase("serialize", span.start_ns, time.perf_counter_ns())
            timers.capture(RequestTimers.SEND_START)
            metadata_sink: Dict[str, str] = {}
            response = self._call(
                "ModelInfer", request, hdrs, client_timeout, compression_algorithm,
                idempotent=sequence_id == 0, resilience=resilience, span=span,
                metadata_sink=metadata_sink,
            )
            timers.capture(RequestTimers.SEND_END)
            timers.capture(RequestTimers.RECV_START)
            result = InferResult(response)
            result._response_headers = metadata_sink
            if actx is not None:
                actx.finish(result)
            # the result never reaches the caller (nor the ORCA path below)
            # unchecked
            self._integrity_check(result, inputs, outputs, request_id, model_name)
            timers.capture(RequestTimers.RECV_END)
        except BaseException as e:
            if span is not None:
                self._telemetry.finish(span, error=e)
            raise
        finally:
            if actx is not None:
                actx.settle()
        timers.capture(RequestTimers.REQUEST_END)
        self._infer_stat.update(timers)
        if span is not None:
            span.phase("deserialize", timers.get(RequestTimers.RECV_START),
                       timers.get(RequestTimers.RECV_END))
            self._telemetry.finish(span)
        # after the phase capture: ORCA bookkeeping must not count as
        # deserialize time
        self._orca_ingest(result)
        return result

    def async_infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
        callback: Optional[Callable] = None,
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        client_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        parameters: Optional[Dict[str, Any]] = None,
        compression_algorithm: Optional[str] = None,
    ) -> CallContext:
        """Fire an async inference; ``callback(result, error)`` when done."""
        # ensure-only arena binding: registrations are cached per endpoint;
        # promotion is skipped because a transient lease could be reused
        # before the server reads it (the future outlives this call)
        self._arena_bind(inputs, outputs, promote=False)
        request = build_infer_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
        )
        future = self._callable("ModelInfer").future(
            request,
            metadata=self._metadata(self._orca_opt_in(dict(headers or {}))),
            timeout=client_timeout,
            compression=to_grpc_compression(compression_algorithm),
        )
        if callback is not None:
            def _done(f):
                result, error = None, None
                try:
                    result = InferResult(f.result())
                    try:
                        # the future is the call: its response metadata, as
                        # on the unary path (and any ORCA header to the
                        # telemetry)
                        result._response_headers = flatten_metadata(
                            f.initial_metadata(), f.trailing_metadata())
                        self._orca_ingest(result)
                    except Exception:
                        pass
                    # the unary path's contract check: a violation becomes
                    # the callback's typed error, never a result
                    try:
                        self._integrity_check(result, inputs, outputs, request_id,
                                              model_name)
                    except InferenceServerException as e:
                        result, error = None, e
                except grpc.RpcError as e:
                    error = _to_exception(e)
                except Exception as e:  # cancelled etc.
                    error = InferenceServerException(str(e))
                # outside the try: a raising user callback must not be
                # re-invoked with a phantom error
                callback(result, error)

            future.add_done_callback(_done)
        return CallContext(future)

    # -- streaming ---------------------------------------------------------
    def start_stream(
        self,
        callback: Callable,
        stream_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        compression_algorithm: Optional[str] = None,
        auto_reconnect: bool = False,
        resilience=None,
    ) -> None:
        """Open the bidi stream; ``callback(result, error)`` per response.

        ``auto_reconnect=True`` (needs a resilience policy with a
        RetryPolicy, configured on the client or passed here) makes the
        stream survive transport death: the bidi call is re-established
        with backoff and the callback receives a
        ``resilience.StreamReconnected`` event (as the result). In-flight
        idempotent requests are re-sent; in-flight sequence requests are
        never re-sent — their ids arrive in the event's
        ``abandoned_request_ids``."""
        with self._stream_lock:
            if self._stream is not None:
                raise InferenceServerException(
                    "cannot start a stream: one is already active; stop it first"
                )
            span = self._obs_begin_stream(self._FRONTEND, "", op="stream")
            self._stream_span = span
            if span is not None:
                # a stream-level traceparent: every request on the bidi call
                # joins this stream's trace in the server's access records,
                # across reconnects (metadata is recomputed per re-open from
                # this same headers dict)
                headers = dict(headers or {})
                headers[TRACEPARENT_HEADER] = span.traceparent()
                user_callback = callback
                mark = span.mark
                tel_ = self._telemetry
                stream_box: Dict[str, Any] = {}

                def callback(result, error):
                    if error is not None:
                        span.event("stream_error", error=type(error).__name__)
                        # an in-band per-request error leaves the bidi call
                        # healthy; a terminal one (the stream died and will
                        # not reconnect) closes the span with the error now
                        inner = stream_box.get("stream")
                        if inner is None or not inner.is_active():
                            tel_.finish_stream(span, error=error)
                    elif type(result) is StreamReconnected:
                        span.reconnect(abandoned=len(result.abandoned_request_ids),
                                       resent=len(result.resent_request_ids))
                    else:
                        mark()
                    user_callback(result, error)

            compression = to_grpc_compression(compression_algorithm)
            try:
                if auto_reconnect:
                    def open_inner(cb):
                        inner = _InferStream(cb, self._verbose)
                        # metadata computed per (re)open: the plugin
                        # re-stamps auth headers on every reconnect
                        inner.start(
                            self._callable("ModelStreamInfer", streaming=True),
                            self._metadata(headers), stream_timeout,
                            compression=compression,
                        )
                        return inner

                    stream = _ReconnectingStream(
                        open_inner, callback, self._resilience_for(resilience),
                        self._verbose)
                    stream.start()
                else:
                    stream = _InferStream(callback, self._verbose)
                    stream.start(
                        self._callable("ModelStreamInfer", streaming=True),
                        self._metadata(headers), stream_timeout,
                        compression=compression,
                    )
            except BaseException as e:
                if span is not None and self._telemetry is not None:
                    self._telemetry.finish_stream(span, error=e)
                raise
            if span is not None:
                stream_box["stream"] = stream
            self._stream = stream

    def async_stream_infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        enable_empty_final_response: bool = False,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Send one request on the open stream (sequences, decoupled models)."""
        with self._stream_lock:
            stream = self._stream
        if stream is None:
            raise InferenceServerException("stream not available: call start_stream first")
        # ensure-only arena binding: a stream request may be a region's
        # FIRST use against this endpoint (no promotion: the stream
        # outlives this call, so a transient lease could be reused before
        # the server reads it)
        self._arena_bind(inputs, outputs, promote=False)
        request = build_infer_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
        )
        if enable_empty_final_response:
            request.setdefault("parameters", {})[
                "triton_enable_empty_final_response"
            ] = {"bool_param": True}
        # a sequence request carries a server-side state transition and is
        # never re-sent by a reconnecting stream
        stream.enqueue(request, idempotent=sequence_id == 0)

    def stop_stream(self, cancel_requests: bool = False) -> None:
        with self._stream_lock:
            stream, self._stream = self._stream, None
            # the span outlives the stop for inspection (stream_span());
            # a new start_stream replaces it
            span = self._stream_span
        if stream is not None:
            stream.close(cancel_requests)
        tel = self._telemetry
        if span is not None and tel is not None:
            tel.finish_stream(span)

    def stream_span(self):
        """The active (or most recently stopped) stream's StreamSpan; None
        without telemetry."""
        return self._stream_span
