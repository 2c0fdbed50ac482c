"""Asyncio KServe v2 GRPC client (mirrors ``client_tpu.grpc.aio``).

The grpc.aio twin of the sync client over the same schema-driven wire codec
and request builders, so its frames are the sync client's. ``stream_infer``
is the bidi stream as an async iterator of (result, error) pairs.

One attempt per call and a stream without reconnection: retry policies and
telemetry are layers the port does not carry yet.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

import grpc
import grpc.aio

from ..._base import InferenceServerClientBase, Request
from ..._tensor import InferInput, InferRequestedOutput
from ...utils import InferenceServerException
from .._client import (
    KeepAliveOptions,
    _to_exception,
    callables_for,
    channel_options,
    cuda_register_request,
    load_request,
    log_request,
    log_settings_of,
    ssl_credentials,
    trace_request,
    trace_settings_of,
    unload_request,
)
from .._infer import InferResult, build_infer_request, to_grpc_compression

__all__ = [
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "InferenceServerClient",
    "KeepAliveOptions",
]


class _ResponseIterator:
    """Async iterator of (result, error) pairs over a bidi call, with
    ``cancel()``."""

    def __init__(self, rpc_call):
        self._call = rpc_call

    def cancel(self) -> bool:
        return self._call.cancel()

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            response = await self._call.read()
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.CANCELLED:
                raise StopAsyncIteration
            raise _to_exception(e) from e
        if response is grpc.aio.EOF:
            raise StopAsyncIteration
        err = response.get("error_message")
        if err:
            return None, InferenceServerException(err)
        return InferResult(response.get("infer_response", {})), None


class InferenceServerClient(InferenceServerClientBase):
    """Asyncio client for the KServe v2 GRPC protocol."""

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
            self._channel = grpc.aio.secure_channel(url, creds, options=options)
        else:
            self._channel = grpc.aio.insecure_channel(url, options=options)
        self._callables: Dict[str, Any] = {}

    async def close(self) -> None:
        await self._channel.close()

    async def __aenter__(self) -> "InferenceServerClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

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

    async def _call(self, method, request, headers=None, client_timeout=None,
                    compression_algorithm=None):
        if self._verbose:
            print(f"{method}, metadata {headers or {}}\n{request}")
        try:
            response = await self._callable(method)(
                request,
                metadata=self._metadata(headers),
                timeout=client_timeout,
                compression=to_grpc_compression(compression_algorithm),
            )
        except grpc.aio.AioRpcError as e:
            raise _to_exception(e) from e
        if self._verbose:
            print(response)
        return response

    # -- health / metadata ---------------------------------------------------
    async def is_server_live(self, headers=None, client_timeout=None) -> bool:
        resp = await self._call("ServerLive", {}, headers, client_timeout)
        return bool(resp.get("live", False))

    async def is_server_ready(self, headers=None, client_timeout=None) -> bool:
        resp = await self._call("ServerReady", {}, headers, client_timeout)
        return bool(resp.get("ready", False))

    async def is_model_ready(self, model_name, model_version="", headers=None,
                             client_timeout=None) -> bool:
        resp = await self._call(
            "ModelReady", {"name": model_name, "version": model_version}, headers,
            client_timeout)
        return bool(resp.get("ready", False))

    async def get_server_metadata(self, headers=None, client_timeout=None):
        return await self._call("ServerMetadata", {}, headers, client_timeout)

    async def get_model_metadata(self, model_name, model_version="", headers=None,
                                 client_timeout=None):
        return await self._call(
            "ModelMetadata", {"name": model_name, "version": model_version}, headers,
            client_timeout)

    async def get_model_config(self, model_name, model_version="", headers=None,
                               client_timeout=None):
        return await self._call(
            "ModelConfig", {"name": model_name, "version": model_version}, headers,
            client_timeout)

    # -- repository / statistics / settings ----------------------------------
    async def get_model_repository_index(self, headers=None, client_timeout=None):
        resp = await self._call("RepositoryIndex", {}, headers, client_timeout)
        return resp.get("models", [])

    async def load_model(self, model_name, headers=None, config=None, files=None,
                         client_timeout=None):
        await self._call("RepositoryModelLoad", load_request(model_name, config, files),
                         headers, client_timeout)

    async def unload_model(self, model_name, headers=None, unload_dependents=False,
                           client_timeout=None):
        await self._call("RepositoryModelUnload",
                         unload_request(model_name, unload_dependents), headers,
                         client_timeout)

    async def get_inference_statistics(self, model_name="", model_version="", headers=None,
                                       client_timeout=None):
        return await self._call(
            "ModelStatistics", {"name": model_name, "version": model_version}, headers,
            client_timeout)

    async def update_trace_settings(self, model_name=None, settings=None, headers=None,
                                    client_timeout=None):
        return trace_settings_of(await self._call(
            "TraceSetting", trace_request(model_name, settings), headers, client_timeout))

    async def get_trace_settings(self, model_name=None, headers=None, client_timeout=None):
        req = {"model_name": model_name} if model_name else {}
        return trace_settings_of(await self._call("TraceSetting", req, headers, client_timeout))

    async def update_log_settings(self, settings, headers=None, client_timeout=None):
        return log_settings_of(await self._call(
            "LogSettings", log_request(settings), headers, client_timeout))

    async def get_log_settings(self, headers=None, client_timeout=None):
        return log_settings_of(await self._call("LogSettings", {}, headers, client_timeout))

    # -- shared memory --------------------------------------------------------
    async def _shm_status(self, method, region_name, headers, client_timeout):
        resp = await self._call(method, {"name": region_name}, headers, client_timeout)
        return list(resp.get("regions", {}).values())

    async def get_system_shared_memory_status(self, region_name="", headers=None,
                                              client_timeout=None):
        return await self._shm_status("SystemSharedMemoryStatus", region_name, headers,
                                      client_timeout)

    async def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                            headers=None, client_timeout=None):
        await self._call(
            "SystemSharedMemoryRegister",
            {"name": name, "key": key, "offset": offset, "byte_size": byte_size},
            headers, client_timeout)

    async def unregister_system_shared_memory(self, name="", headers=None,
                                              client_timeout=None):
        await self._call("SystemSharedMemoryUnregister", {"name": name}, headers,
                         client_timeout)

    async def get_cuda_shared_memory_status(self, region_name="", headers=None,
                                            client_timeout=None):
        return await self._shm_status("CudaSharedMemoryStatus", region_name, headers,
                                      client_timeout)

    async def register_cuda_shared_memory(self, name, raw_handle, device_id, byte_size,
                                          headers=None, client_timeout=None):
        await self._call("CudaSharedMemoryRegister",
                         cuda_register_request(name, raw_handle, device_id, byte_size),
                         headers, client_timeout)

    async def unregister_cuda_shared_memory(self, name="", headers=None, client_timeout=None):
        await self._call("CudaSharedMemoryUnregister", {"name": name}, headers,
                         client_timeout)

    # -- inference ---------------------------------------------------------
    async def infer(
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
        request = build_infer_request(
            model_name, inputs, model_version, outputs, request_id,
            sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
        )
        response = await self._call("ModelInfer", request, headers, client_timeout,
                                    compression_algorithm)
        return InferResult(response)

    async def stream_infer(
        self,
        inputs_iterator: AsyncIterator[Dict[str, Any]],
        stream_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        compression_algorithm: Optional[str] = None,
    ) -> AsyncIterator:
        """Bi-di streaming: consume request dicts, yield (result, error) pairs.

        Each item from ``inputs_iterator`` is a kwargs dict for
        ``build_infer_request`` (model_name, inputs, sequence_id, ...), plus
        an optional ``enable_empty_final_response``. The returned async
        iterator has ``cancel()`` (the consumer's next read then raises
        ``asyncio.CancelledError``).
        """

        async def request_gen():
            async for kwargs in inputs_iterator:
                enable_final = kwargs.pop("enable_empty_final_response", False)
                req = build_infer_request(**kwargs)
                if enable_final:
                    req.setdefault("parameters", {})[
                        "triton_enable_empty_final_response"
                    ] = {"bool_param": True}
                yield req

        call = self._callable("ModelStreamInfer", streaming=True)(
            request_gen(),
            metadata=self._metadata(headers),
            timeout=stream_timeout,
            compression=to_grpc_compression(compression_algorithm),
        )
        return _ResponseIterator(call)
