"""Asyncio KServe v2 GRPC client (mirrors ``client_tpu.grpc.aio``).

The grpc.aio twin of the sync client over the same schema-driven wire codec
and request builders, so its frames are the sync client's. ``stream_infer``
is the bidi stream as an async iterator of (result, error) pairs.

Every unary call runs under the client's resilience policy (retries with
span events per attempt), reports into its telemetry, and every
``InferResult`` is checked against its request (``integrity``). The stream
is traced as a ``StreamSpan``; it does not reconnect (as in the JAX
package's aio client).
"""

from __future__ import annotations

import time
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

import grpc
import grpc.aio

from ..._base import InferenceServerClientBase, Request
from ..._tensor import InferInput, InferRequestedOutput
from ...observe import TRACEPARENT_HEADER
from ...resilience import FATAL, AttemptBudget, classify_fault
from ...utils import InferenceServerException
from .._client import (
    KeepAliveOptions,
    _to_exception,
    callables_for,
    channel_options,
    cuda_register_request,
    flatten_metadata,
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
    ``cancel()``; closes the stream's span (if any) at its end."""

    def __init__(self, rpc_call, stream_span=None, telemetry=None):
        self._call = rpc_call
        self._span = stream_span
        self._telemetry = telemetry

    def _finish(self, error=None, abandoned=False):
        if self._span is not None and self._telemetry is not None:
            self._telemetry.finish_stream(self._span, error=error, abandoned=abandoned)

    def cancel(self) -> bool:
        self._finish(abandoned=True)
        return self._call.cancel()

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            response = await self._call.read()
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.CANCELLED:
                self._finish(abandoned=True)
                raise StopAsyncIteration
            err = _to_exception(e)
            self._finish(error=err)
            raise err from e
        if response is grpc.aio.EOF:
            self._finish()
            raise StopAsyncIteration
        err = response.get("error_message")
        if err:
            if self._span is not None:
                self._span.event("stream_error", error="InferenceServerException")
            return None, InferenceServerException(err)
        if self._span is not None:
            self._span.mark()
        return InferResult(response.get("infer_response", {})), None


class InferenceServerClient(InferenceServerClientBase):
    """Asyncio client for the KServe v2 GRPC protocol."""

    _FRONTEND = "grpc_aio"
    _BATCH_AIO = True

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
                    compression_algorithm=None, idempotent=True, resilience=None,
                    span=None, metadata_sink=None):
        """One unary call under the client's resilience policy (or the
        per-request ``resilience`` override; ``False`` bypasses it).

        ``metadata_sink``: when given, the response's initial and trailing
        metadata (string values only) land in the dict — the GRPC twin of
        HTTP response headers (e.g. ORCA's ``endpoint-load-metrics``)."""
        if self._verbose:
            print(f"{method}, metadata {headers or {}}\n{request}")
        policy = self._resilience_for(resilience)
        budget = AttemptBudget(policy, client_timeout)

        async def attempt():
            attempt_timeout = budget.attempt_timeout_s(status="StatusCode.DEADLINE_EXCEEDED")
            try:
                call = self._callable(method)(
                    request,
                    metadata=self._metadata(headers),
                    timeout=attempt_timeout,
                    compression=to_grpc_compression(compression_algorithm),
                )
                response = await call
                if metadata_sink is not None:
                    metadata_sink.clear()  # a retried attempt must not mix in
                    metadata_sink.update(flatten_metadata(
                        await call.initial_metadata(), await call.trailing_metadata()))
                return response
            except grpc.aio.AioRpcError as e:
                raise _to_exception(e) from e

        run_attempt = attempt
        on_retry = None
        if span is not None:
            async def run_attempt():
                t_a = time.perf_counter_ns()
                try:
                    result = await attempt()
                except BaseException:
                    span.phase("attempt", t_a, time.perf_counter_ns())
                    raise
                end = time.perf_counter_ns()
                span.phase("attempt", t_a, end)
                # a unary call: the successful attempt is the ttfb window (a
                # retried request must not fold failed attempts and backoff
                # into it)
                span.phase("ttfb", t_a, end)
                return result

            def on_retry(n, exc, delay):
                span.event("retry", attempt=n, backoff_s=round(delay, 6),
                           error=type(exc).__name__)

        if policy is None:
            response = await run_attempt()
        else:
            response = await policy.execute_async(
                run_attempt, idempotent=idempotent, timeout_s=client_timeout,
                on_retry=on_retry)
        if self._verbose:
            print(response)
        return response

    # -- health / metadata ---------------------------------------------------
    async def _health(self, method, field, headers, client_timeout, probe: bool) -> bool:
        """The sync client's ``_health``: transport failures raise by
        default; ``probe=True`` maps connect/transient/timeout-class failures
        to False and bypasses the resilience policy."""
        try:
            resp = await self._call(method, {}, headers, client_timeout,
                                    resilience=False if probe else None)
        except InferenceServerException as e:
            if probe and classify_fault(e) != FATAL:
                return False
            raise
        return bool(resp.get(field, False))

    async def is_server_live(self, headers=None, client_timeout=None,
                             probe: bool = False) -> bool:
        return await self._health("ServerLive", "live", headers, client_timeout, probe)

    async def is_server_ready(self, headers=None, client_timeout=None,
                              probe: bool = False) -> bool:
        return await self._health("ServerReady", "ready", headers, client_timeout, probe)

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
        metadata = await self._call(
            "ModelMetadata", {"name": model_name, "version": model_version}, headers,
            client_timeout)
        # captured into the integrity contract cache: later responses are
        # validated against this fetched truth (never the other way round)
        self._integrity_note_metadata(model_name, metadata)
        return metadata

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
        await self._shm_call_async(
            "system", "register", self._call, "SystemSharedMemoryRegister",
            {"name": name, "key": key, "offset": offset, "byte_size": byte_size},
            headers, client_timeout)

    async def unregister_system_shared_memory(self, name="", headers=None,
                                              client_timeout=None):
        await self._shm_call_async("system", "unregister", self._call,
                                   "SystemSharedMemoryUnregister", {"name": name}, headers,
                                   client_timeout, region_name=name)

    async def get_cuda_shared_memory_status(self, region_name="", headers=None,
                                            client_timeout=None):
        return await self._shm_status("CudaSharedMemoryStatus", region_name, headers,
                                      client_timeout)

    async def register_cuda_shared_memory(self, name, raw_handle, device_id, byte_size,
                                          headers=None, client_timeout=None):
        await self._shm_call_async("cuda", "register", self._call, "CudaSharedMemoryRegister",
                                   cuda_register_request(name, raw_handle, device_id,
                                                         byte_size),
                                   headers, client_timeout)

    async def unregister_cuda_shared_memory(self, name="", headers=None, client_timeout=None):
        await self._shm_call_async("cuda", "unregister", self._call,
                                   "CudaSharedMemoryUnregister", {"name": name}, headers,
                                   client_timeout, region_name=name)

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
        resilience=None,
        tenant: Optional[str] = None,
    ) -> InferResult:
        span = self._obs_begin(self._FRONTEND, model_name)
        if span is not None and tenant is not None:
            # client-side QoS attribution only (see client_tpu_torch.tenancy);
            # the tenant is never sent on the wire
            span.event("tenant", tenant=tenant)
        actx = None
        try:
            # arena data plane: promote staged binary inputs into leased
            # slabs and ensure (cached) region registrations BEFORE the
            # request is built, so it rides shm params
            actx = await self._arena_bind_async(inputs, outputs)
            request = build_infer_request(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority, timeout, parameters,
            )
            hdrs = self._orca_opt_in(dict(headers or {}))
            if span is not None:
                hdrs[TRACEPARENT_HEADER] = span.traceparent()
                span.phase("serialize", span.start_ns, time.perf_counter_ns())
            metadata_sink: Dict[str, str] = {}
            response = await self._call(
                "ModelInfer", request, hdrs, client_timeout, compression_algorithm,
                idempotent=sequence_id == 0, resilience=resilience, span=span,
                metadata_sink=metadata_sink,
            )
            if span is not None:
                t_deser = time.perf_counter_ns()
            result = InferResult(response)
            result._response_headers = metadata_sink
            if actx is not None:
                actx.finish(result)
            # the result never reaches the caller (nor the ORCA path below)
            # unchecked
            self._integrity_check(result, inputs, outputs, request_id, model_name)
        except BaseException as e:
            if span is not None:
                self._telemetry.finish(span, error=e)
            raise
        finally:
            if actx is not None:
                actx.settle()
        if span is not None:
            span.phase("deserialize", t_deser, time.perf_counter_ns())
            self._telemetry.finish(span)
        # after the phase capture: ORCA bookkeeping must not count as
        # deserialize time
        self._orca_ingest(result)
        return result

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

        With telemetry configured the stream is traced as a ``StreamSpan``
        and a stream-level ``traceparent`` metadata key joins every request
        on the call to the server's access records.
        """
        span = self._obs_begin_stream(self._FRONTEND, "", op="stream")
        self._last_stream_span = span
        if span is not None:
            headers = dict(headers or {})
            headers[TRACEPARENT_HEADER] = span.traceparent()

        async def request_gen():
            async for kwargs in inputs_iterator:
                enable_final = kwargs.pop("enable_empty_final_response", False)
                # ensure-only arena binding per stream request (no
                # promotion: the stream outlives each yielded request)
                await self._arena_bind_async(
                    kwargs.get("inputs") or (), kwargs.get("outputs"),
                    promote=False)
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
        return _ResponseIterator(call, span, self._telemetry)

    def stream_span(self):
        """The most recent ``stream_infer``'s StreamSpan (None without
        telemetry)."""
        return getattr(self, "_last_stream_span", None)
