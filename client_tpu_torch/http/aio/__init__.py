"""Asyncio KServe v2 HTTP client (mirrors ``client_tpu.http.aio``).

The aiohttp twin of the sync client, with ``async def`` methods over the
same routes. It shares the body builders, parsers and value model with the
sync client; only the transport differs, so request bodies and headers are
the sync client's.

Every call runs under the client's resilience policy with the sync
client's idempotency contract, reports into its telemetry, and every
``InferResult`` is checked against its request (``integrity``). The JAX
package's shm arena is not part of the port yet.
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from typing import Any, Dict, Optional, Sequence
from urllib.parse import quote

import aiohttp

from ..._base import SHM_FAMILY_OF, InferenceServerClientBase, Request
from ..._tensor import InferInput, InferRequestedOutput
from ...integrity import IntegrityError
from ...observe import TRACEPARENT_HEADER
from ...resilience import (
    FATAL,
    RETRYABLE_HTTP_STATUSES,
    AttemptBudget,
    RetryableStatusError,
    classify_fault,
)
from ...utils import InferenceServerException
from .._client import InferenceServerClient as _SyncClient
from .._infer_result import InferResult
from .._utils import (
    SSEDecoder,
    build_infer_body,
    compress_body,
    parse_sse_event,
    raise_if_error,
)

__all__ = [
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "InferenceServerClient",
]


class InferenceServerClient(InferenceServerClientBase):
    """Asyncio client for the KServe v2 HTTP/REST protocol."""

    _FRONTEND = "http_aio"

    def __init__(
        self,
        url: str,
        verbose: bool = False,
        conn_limit: int = 100,
        conn_timeout: float = 60.0,
        ssl: bool = False,
        ssl_context=None,
    ):
        super().__init__()
        if "://" in url:
            raise InferenceServerException(
                f"unexpected scheme in url '{url}' (pass host:port; use ssl=True for https)"
            )
        scheme = "https" if ssl else "http"
        self._url = url
        self._base = f"{scheme}://{url}"
        self._verbose = verbose
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=conn_limit, ssl=ssl_context),
            timeout=aiohttp.ClientTimeout(total=conn_timeout),
        )

    async def close(self) -> None:
        await self._session.close()

    async def __aenter__(self) -> "InferenceServerClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- transport ---------------------------------------------------------
    async def _request(
        self, method: str, path: str, body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
        idempotent: bool = True,
        resilience=None,
        span=None,
    ):
        """One HTTP round trip, (status, headers, body), under the client's
        resilience policy (the sync client's idempotency contract:
        in-flight failures and shed-load statuses re-attempt only for
        idempotent requests)."""
        url = f"{self._base}/{path}"
        policy = self._resilience_for(resilience)
        kwargs: Dict[str, Any] = dict(params=query_params)
        if body is not None:
            kwargs["data"] = body
        budget = AttemptBudget(policy, timeout)
        retry_statuses = policy is not None and policy.retry_http_statuses

        async def attempt():
            # the plugin runs per attempt: a token-refreshing plugin stamps
            # a fresh credential on every retry
            request = Request(dict(headers or {}))
            self._call_plugin(request)
            kwargs["headers"] = request.headers
            if self._verbose:
                print(f"{method} {url}, headers {request.headers}")
            remaining = budget.attempt_timeout_s(status="499")
            if remaining is not None:
                kwargs["timeout"] = aiohttp.ClientTimeout(total=remaining)
            try:
                t_send = time.perf_counter_ns() if span is not None else 0
                async with self._session.request(method, url, **kwargs) as resp:
                    if span is not None:
                        # headers arrived: request issue -> first byte
                        t_recv = time.perf_counter_ns()
                        span.phase("ttfb", t_send, t_recv)
                    data = await resp.read()
                    if span is not None:
                        span.phase("recv", t_recv, time.perf_counter_ns())
                    if self._verbose:
                        print(f"-> {resp.status}")
                    out = resp.status, dict(resp.headers), data
            except (TimeoutError, asyncio.TimeoutError) as e:
                # aiohttp raises TimeoutError on ClientTimeout(total=) expiry
                raise InferenceServerException("Deadline Exceeded", status="499") from e
            except aiohttp.ClientError as e:
                raise InferenceServerException(f"connection error: {e}") from e
            if retry_statuses and str(out[0]) in RETRYABLE_HTTP_STATUSES:
                raise RetryableStatusError(out[0], out)
            return out

        run_attempt = attempt
        if span is not None:
            async def run_attempt():
                t_a = time.perf_counter_ns()
                try:
                    return await attempt()
                finally:
                    span.phase("attempt", t_a, time.perf_counter_ns())

        if policy is None:
            return await run_attempt()
        on_retry = None
        if span is not None:
            def on_retry(n, exc, delay):
                span.event("retry", attempt=n, backoff_s=round(delay, 6),
                           error=type(exc).__name__)
        try:
            return await policy.execute_async(
                run_attempt, idempotent=idempotent, timeout_s=timeout,
                on_retry=on_retry)
        except RetryableStatusError as e:
            return e.response

    async def _get_json(self, path, headers=None, query_params=None):
        status, _, data = await self._request("GET", path, None, headers, query_params)
        raise_if_error(status, data)
        return json.loads(data) if data else {}

    async def _post_json(self, path, body, headers=None, query_params=None):
        status, _, data = await self._request("POST", path, body, headers, query_params)
        raise_if_error(status, data)
        return json.loads(data) if data else {}

    _model_path = staticmethod(_SyncClient._model_path)

    # -- health / metadata -------------------------------------------------
    async def _health(self, path, headers, query_params, probe: bool = False,
                      client_timeout: Optional[float] = None) -> bool:
        """Shared live/ready GET, the sync client's contract: transport
        failures raise by default; ``probe=True`` maps connect/transient/
        timeout-class failures to False and bypasses the resilience policy
        (a health poller must see the endpoint, not an open breaker)."""
        try:
            status, _, _ = await self._request(
                "GET", path, None, headers, query_params, timeout=client_timeout,
                resilience=False if probe else None)
        except InferenceServerException as e:
            if probe and classify_fault(e) != FATAL:
                return False
            raise
        return status == 200

    async def is_server_live(self, headers=None, query_params=None, probe: bool = False,
                             client_timeout: Optional[float] = None) -> bool:
        return await self._health("v2/health/live", headers, query_params, probe,
                                  client_timeout)

    async def is_server_ready(self, headers=None, query_params=None, probe: bool = False,
                              client_timeout: Optional[float] = None) -> bool:
        return await self._health("v2/health/ready", headers, query_params, probe,
                                  client_timeout)

    async def is_model_ready(self, model_name, model_version="", headers=None,
                             query_params=None) -> bool:
        return await self._health(
            self._model_path(model_name, model_version) + "/ready", headers, query_params)

    async def get_server_metadata(self, headers=None, query_params=None):
        return await self._get_json("v2", headers, query_params)

    async def get_model_metadata(self, model_name, model_version="", headers=None,
                                 query_params=None):
        metadata = await self._get_json(
            self._model_path(model_name, model_version), headers, query_params)
        # captured into the integrity contract cache: later responses are
        # validated against this fetched truth (never the other way round)
        self._integrity_note_metadata(model_name, metadata)
        return metadata

    async def get_model_config(self, model_name, model_version="", headers=None,
                               query_params=None):
        return await self._get_json(
            self._model_path(model_name, model_version) + "/config", headers, query_params)

    # -- repository / stats / settings --------------------------------------
    async def get_model_repository_index(self, headers=None, query_params=None):
        status, _, data = await self._request(
            "POST", "v2/repository/index", b"", headers, query_params)
        raise_if_error(status, data)
        return json.loads(data) if data else []

    async def load_model(self, model_name, headers=None, query_params=None, config=None,
                         files=None):
        params: Dict[str, Any] = {}
        if config is not None:
            params["config"] = config
        for p, content in (files or {}).items():
            params[p] = base64.b64encode(content).decode("ascii")
        body = json.dumps({"parameters": params} if params else {}).encode()
        await self._post_json(f"v2/repository/models/{quote(model_name)}/load", body,
                              headers, query_params)

    async def unload_model(self, model_name, headers=None, query_params=None,
                           unload_dependents=False):
        body = json.dumps({"parameters": {"unload_dependents": unload_dependents}}).encode()
        await self._post_json(f"v2/repository/models/{quote(model_name)}/unload", body,
                              headers, query_params)

    async def get_inference_statistics(self, model_name="", model_version="", headers=None,
                                       query_params=None):
        path = (self._model_path(model_name, model_version) + "/stats" if model_name
                else "v2/models/stats")
        return await self._get_json(path, headers, query_params)

    _trace_path = staticmethod(_SyncClient._trace_path)

    async def update_trace_settings(self, model_name=None, settings=None, headers=None,
                                    query_params=None):
        return await self._post_json(self._trace_path(model_name),
                                     json.dumps(settings or {}).encode(), headers, query_params)

    async def get_trace_settings(self, model_name=None, headers=None, query_params=None):
        return await self._get_json(self._trace_path(model_name), headers, query_params)

    async def update_log_settings(self, settings, headers=None, query_params=None):
        return await self._post_json("v2/logging", json.dumps(settings).encode(), headers,
                                     query_params)

    async def get_log_settings(self, headers=None, query_params=None):
        return await self._get_json("v2/logging", headers, query_params)

    # -- shared memory -----------------------------------------------------
    async def _shm_status(self, family, region_name, headers, query_params):
        path = f"v2/{family}"
        if region_name:
            path += f"/region/{quote(region_name)}"
        status, _, data = await self._request("GET", path + "/status", None, headers,
                                              query_params)
        raise_if_error(status, data)
        return json.loads(data) if data else []

    async def _shm_post(self, family, name, action, body, headers, query_params):
        """One register/unregister call, under data-plane accounting."""
        path = f"v2/{family}"
        if name:
            path += f"/region/{quote(name)}"
        await self._shm_call_async(
            SHM_FAMILY_OF[family], action, self._post_json,
            f"{path}/{action}", body, headers, query_params, region_name=name)

    async def get_system_shared_memory_status(self, region_name="", headers=None,
                                              query_params=None):
        return await self._shm_status("systemsharedmemory", region_name, headers, query_params)

    async def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                            headers=None, query_params=None):
        body = json.dumps({"key": key, "offset": offset, "byte_size": byte_size}).encode()
        await self._shm_post("systemsharedmemory", name, "register", body, headers,
                             query_params)

    async def unregister_system_shared_memory(self, name="", headers=None, query_params=None):
        await self._shm_post("systemsharedmemory", name, "unregister", b"", headers,
                             query_params)

    async def get_cuda_shared_memory_status(self, region_name="", headers=None,
                                            query_params=None):
        return await self._shm_status("cudasharedmemory", region_name, headers, query_params)

    async def register_cuda_shared_memory(self, name, raw_handle, device_id, byte_size,
                                          headers=None, query_params=None):
        body = json.dumps({"raw_handle": {"b64": raw_handle}, "device_id": device_id,
                           "byte_size": byte_size}).encode()
        await self._shm_post("cudasharedmemory", name, "register", body, headers,
                             query_params)

    async def unregister_cuda_shared_memory(self, name="", headers=None, query_params=None):
        await self._shm_post("cudasharedmemory", name, "unregister", b"", headers,
                             query_params)

    # -- inference ---------------------------------------------------------
    # offline marshaling statics (the sync client's)
    generate_request_body = staticmethod(_SyncClient.generate_request_body)
    parse_response_body = staticmethod(_SyncClient.parse_response_body)

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
        query_params: Optional[Dict[str, Any]] = None,
        request_compression_algorithm: Optional[str] = None,
        response_compression_algorithm: Optional[str] = None,
        parameters: Optional[Dict[str, Any]] = None,
        resilience=None,
    ) -> InferResult:
        span = self._obs_begin(self._FRONTEND, model_name)
        actx = None
        try:
            # arena data plane: promote staged binary inputs into leased
            # slabs and ensure (cached) region registrations BEFORE the
            # body is built, so the request rides shm params
            actx = await self._arena_bind_async(inputs, outputs)
            body, json_size = build_infer_body(
                inputs, outputs, request_id, sequence_id, sequence_start,
                sequence_end, priority, timeout, parameters,
            )
            hdrs = self._orca_opt_in(dict(headers or {}))
            body, encoding = compress_body(body, request_compression_algorithm)
            if encoding:
                hdrs["Content-Encoding"] = encoding
            if response_compression_algorithm in ("gzip", "deflate"):
                hdrs["Accept-Encoding"] = response_compression_algorithm
            if json_size is not None:
                hdrs["Inference-Header-Content-Length"] = str(json_size)
                hdrs["Content-Type"] = "application/octet-stream"
            else:
                hdrs["Content-Type"] = "application/json"
            if span is not None:
                hdrs[TRACEPARENT_HEADER] = span.traceparent()
                span.phase("serialize", span.start_ns, time.perf_counter_ns())
            status, resp_headers, data = await self._request(
                "POST", self._model_path(model_name, model_version) + "/infer", body, hdrs,
                query_params, timeout=client_timeout, idempotent=sequence_id == 0,
                resilience=resilience, span=span,
            )
            raise_if_error(status, data)  # aiohttp decodes Content-Encoding itself
            t_deser = time.perf_counter_ns() if span is not None else 0
            header_length = resp_headers.get("Inference-Header-Content-Length")
            try:
                result = InferResult.from_response_body(
                    data, int(header_length) if header_length is not None else None)
            except IntegrityError as e:
                # an undecodable body: attribute it to this endpoint and
                # account it like any other integrity violation
                self._integrity_parse_note(e)
                raise
            result._response_headers = resp_headers  # e.g. endpoint-load-metrics
            if actx is not None:
                actx.finish(result)
            # the result never reaches the caller (nor the ORCA and verbose
            # paths below) unchecked
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
        if self._verbose:
            print(result.get_response())
        return result

    # -- generate extension (LLM JSON API) ----------------------------------
    _generate_path = staticmethod(_SyncClient._generate_path)
    _generate_payload = staticmethod(_SyncClient._generate_payload)

    async def generate(
        self,
        model_name: str,
        inputs: Dict[str, Any],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """One-shot generate: flat JSON in, flat JSON out (the model must
        produce exactly one response; decoupled models need
        :meth:`generate_stream`)."""
        return await self._post_json(
            self._generate_path(model_name, model_version, stream=False),
            self._generate_payload(inputs, request_id, parameters),
            headers, query_params,
        )

    async def generate_stream(
        self,
        model_name: str,
        inputs: Dict[str, Any],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
    ):
        """Async iterator over generate-extension SSE events, one dict per
        streamed response. Abandoning the iterator mid-stream closes the
        connection, which the server counts as a client cancel. In-band
        error events raise.

        With telemetry configured the stream is traced as a ``StreamSpan``
        and a ``traceparent`` header joins it to the server's access record
        for the generation."""
        hdrs = dict(headers or {})
        span = self._obs_begin_stream(self._FRONTEND, model_name)
        self._last_stream_span = span
        if span is not None:
            hdrs[TRACEPARENT_HEADER] = span.traceparent()
        request = Request(hdrs)
        self._call_plugin(request)
        url = f"{self._base}/{self._generate_path(model_name, model_version, stream=True)}"
        body = self._generate_payload(inputs, request_id, parameters)
        tel = self._telemetry
        try:
            try:
                # no total timeout: generation streams for as long as it streams
                async with self._session.post(
                    url, data=body, headers=request.headers, params=query_params,
                    timeout=aiohttp.ClientTimeout(total=None),
                ) as resp:
                    if resp.status != 200:
                        raise_if_error(resp.status, await resp.read())
                        raise InferenceServerException(
                            f"unexpected generate_stream status {resp.status}")
                    decoder = SSEDecoder()
                    # marked at parse time (arrival), before the consumer runs
                    mark = span.mark if span is not None else None
                    # opt-in stream-index integrity; None when the policy is off
                    checker = self._integrity_stream_checker(model_name)
                    async for chunk in resp.content.iter_chunked(8192):
                        for payload in decoder.feed(chunk):
                            event = parse_sse_event(payload)
                            if checker is not None:
                                checker.observe(event)
                            if mark is not None:
                                mark()
                            yield event
                    for payload in decoder.flush():
                        event = parse_sse_event(payload)
                        if checker is not None:
                            checker.observe(event)
                        if mark is not None:
                            mark()
                        yield event
            except aiohttp.ClientError as e:
                raise InferenceServerException(f"connection error: {e}") from e
        except GeneratorExit:
            if span is not None:
                tel.finish_stream(span, abandoned=True)
            raise
        except BaseException as e:
            if span is not None:
                tel.finish_stream(span, error=e)
            raise
        if span is not None:
            tel.finish_stream(span)

    def last_stream_span(self):
        """The most recent ``generate_stream``'s StreamSpan (None without
        telemetry): harnesses read TTFT/ITL from it."""
        return getattr(self, "_last_stream_span", None)
