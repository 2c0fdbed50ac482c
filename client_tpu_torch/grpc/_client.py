"""Synchronous KServe v2 GRPC client.

The counterpart of ``client_tpu.grpc.InferenceServerClient``: infer,
async_infer (a cancellable CallContext), the bidi stream with sequence
support, and the admin surface (health, metadata, config, repository,
statistics, trace and log settings, system and cuda shared memory) over
generic grpc callables bound to the schema-driven wire codec (no generated
stubs). Request frames and metadata are byte-identical to the JAX
package's for the same inputs.

One attempt per call: retry policies, stream reconnection, telemetry and
response-integrity checks are layers the port does not carry yet. The tpu
shared-memory rpcs are left out; the port's device data plane is cuda.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import grpc

from .._base import InferenceServerClientBase, InferStat, Request, RequestTimers
from .._tensor import InferInput, InferRequestedOutput
from ..utils import InferenceServerException
from . import _messages as M
from ._infer import (
    InferResult,
    build_infer_request,
    from_infer_parameter,
    to_grpc_compression,
)
from ._stream import _InferStream
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
            return InferResult(self._future.result(timeout=timeout))
        except grpc.RpcError as e:
            raise _to_exception(e) from e


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
    ) -> Dict[str, Any]:
        if self._verbose:
            print(f"{method}, metadata {headers or {}}\n{request}")
        try:
            response = self._callable(method)(
                request,
                metadata=self._metadata(headers),
                timeout=client_timeout,
                compression=to_grpc_compression(compression_algorithm),
            )
        except grpc.RpcError as e:
            raise _to_exception(e) from e
        if self._verbose:
            print(response)
        return response

    # -- health / metadata -------------------------------------------------
    def is_server_live(self, headers=None, client_timeout=None) -> bool:
        return bool(self._call("ServerLive", {}, headers, client_timeout).get("live", False))

    def is_server_ready(self, headers=None, client_timeout=None) -> bool:
        return bool(self._call("ServerReady", {}, headers, client_timeout).get("ready", False))

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
        return self._call(
            "ModelMetadata", {"name": model_name, "version": model_version},
            headers, client_timeout,
        )

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
        self._call(
            "SystemSharedMemoryRegister",
            {"name": name, "key": key, "offset": offset, "byte_size": byte_size},
            headers, client_timeout,
        )

    def unregister_system_shared_memory(self, name="", headers=None, client_timeout=None) -> None:
        self._call("SystemSharedMemoryUnregister", {"name": name}, headers, client_timeout)

    def get_cuda_shared_memory_status(self, region_name="", headers=None, client_timeout=None):
        return self._shm_status("CudaSharedMemoryStatus", region_name, headers, client_timeout)

    def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, client_timeout=None
    ) -> None:
        """Register a cuda_shared_memory region by its base64 raw handle
        (see ``utils.cuda_shared_memory.get_raw_handle``)."""
        self._call("CudaSharedMemoryRegister",
                   cuda_register_request(name, raw_handle, device_id, byte_size),
                   headers, client_timeout)

    def unregister_cuda_shared_memory(self, name="", headers=None, client_timeout=None) -> None:
        self._call("CudaSharedMemoryUnregister", {"name": name}, headers, client_timeout)

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
    ) -> InferResult:
        """Run a synchronous inference."""
        timers = RequestTimers()
        timers.capture(RequestTimers.REQUEST_START)
        request = build_infer_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
        )
        timers.capture(RequestTimers.SEND_START)
        response = self._call("ModelInfer", request, headers, client_timeout,
                              compression_algorithm)
        timers.capture(RequestTimers.SEND_END)
        timers.capture(RequestTimers.RECV_START)
        result = InferResult(response)
        timers.capture(RequestTimers.RECV_END)
        timers.capture(RequestTimers.REQUEST_END)
        self._infer_stat.update(timers)
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
        request = build_infer_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
        )
        future = self._callable("ModelInfer").future(
            request,
            metadata=self._metadata(headers),
            timeout=client_timeout,
            compression=to_grpc_compression(compression_algorithm),
        )
        if callback is not None:
            def _done(f):
                result, error = None, None
                try:
                    result = InferResult(f.result())
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
    ) -> None:
        """Open the bidi stream; ``callback(result, error)`` per response.

        ``auto_reconnect=True`` needs a resilience policy with a RetryPolicy,
        which the port does not have yet: it raises."""
        with self._stream_lock:
            if self._stream is not None:
                raise InferenceServerException(
                    "cannot start a stream: one is already active; stop it first"
                )
            if auto_reconnect:
                raise InferenceServerException(
                    "auto_reconnect requires a resilience policy with a RetryPolicy"
                )
            stream = _InferStream(callback, self._verbose)
            stream.start(
                self._callable("ModelStreamInfer", streaming=True),
                self._metadata(headers), stream_timeout,
                compression=to_grpc_compression(compression_algorithm),
            )
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
        request = build_infer_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
        )
        if enable_empty_final_response:
            request.setdefault("parameters", {})[
                "triton_enable_empty_final_response"
            ] = {"bool_param": True}
        stream.enqueue(request)

    def stop_stream(self, cancel_requests: bool = False) -> None:
        with self._stream_lock:
            stream, self._stream = self._stream, None
        if stream is not None:
            stream.close(cancel_requests)
