"""Synchronous KServe v2 HTTP/REST client.

The counterpart of ``client_tpu.http.InferenceServerClient`` for the routes
this port serves: health, metadata and config, ``infer`` and ``async_infer``
(a cancellable ``InferAsyncRequest`` on the client's thread pool), the
generate extension (``generate`` / ``generate_stream`` over SSE),
shared-memory registration for the system and cuda families, and the admin
routes (the repository index, load and unload, statistics, trace and log
settings). Request bodies and headers are byte-identical to the JAX
package's for the same inputs.

Transport: a urllib3 connection pool. Every call runs under the client's
resilience policy (``configure_resilience``, or the connect-only
``max_retries``), reports into its telemetry (``configure_telemetry``:
request spans, the ``traceparent`` header, ORCA endpoint load), and every
``InferResult`` is checked against its request (``integrity``) before the
caller sees it.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence
from urllib.parse import quote, urlencode

import urllib3

from .._base import (
    SHM_FAMILY_OF,
    InferenceServerClientBase,
    InferStat,
    Request,
    RequestTimers,
)
from .._tensor import InferInput, InferRequestedOutput
from ..integrity import IntegrityError
from ..observe import TRACEPARENT_HEADER
from ..resilience import (
    FATAL,
    RETRYABLE_HTTP_STATUSES,
    AttemptBudget,
    RetryableStatusError,
    classify_fault,
    connect_only_policy,
)
from ..utils import InferenceServerException
from ._infer_result import InferResult
from ._utils import (
    SSEDecoder,
    build_infer_body,
    compress_body,
    decompress_body,
    parse_sse_event,
    raise_if_error,
)


class _Response:
    """A fully-read HTTP response (body already Content-Encoding-decoded)."""

    __slots__ = ("status", "headers", "data")

    def __init__(self, status, headers, data):
        self.status = status
        self.headers = headers
        self.data = data


class InferAsyncRequest:
    """Handle for an in-flight async_infer; ``get_result`` blocks for the result."""

    def __init__(self, future: Future, verbose: bool = False):
        self._future = future
        self._verbose = verbose

    def get_result(self, block: bool = True, timeout: Optional[float] = None) -> InferResult:
        if not block and not self._future.done():
            raise InferenceServerException("inference request not yet completed")
        try:
            return self._future.result(timeout=timeout)
        except InferenceServerException:
            raise
        except Exception as e:  # transport-level failure
            raise InferenceServerException(f"inference request failed: {e}") from e

    def cancel(self) -> bool:
        return self._future.cancel()


class InferenceServerClient(InferenceServerClientBase):
    """Client for the KServe v2 HTTP/REST protocol.

    One instance should be driven from one thread at a time for sync calls;
    ``async_infer`` runs on a pool of ``concurrency`` threads.
    """

    _FRONTEND = "http"

    def __init__(
        self,
        url: str,
        verbose: bool = False,
        concurrency: int = 1,
        connection_timeout: float = 60.0,
        network_timeout: float = 60.0,
        max_greenlets: Optional[int] = None,  # accepted for API parity; unused
        ssl: bool = False,
        ssl_options: Optional[Dict[str, Any]] = None,
        ssl_context_factory: Any = None,
        insecure: bool = False,
        max_retries: int = 0,
    ):
        """``ssl``: speak HTTPS; ``ssl_options`` may hold ``keyfile``,
        ``certfile`` and ``ca_certs``, ``ssl_context_factory`` returns the
        ``ssl.SSLContext`` to use, and ``insecure`` skips the certificate
        check. ``max_retries``: re-attempts on *connect* failures (connection
        refused / DNS), where the request provably never reached the server.
        In-flight failures are never retried by this knob (inference is not
        idempotent for sequences); ``configure_resilience`` installs a
        fuller policy, which takes precedence."""
        super().__init__()
        if "://" in url:
            raise InferenceServerException(
                f"unexpected scheme in url '{url}' (pass host:port; use ssl=True for https)"
            )
        self._url = url
        self._verbose = verbose
        self._concurrency = max(1, concurrency)
        self._timeout = urllib3.Timeout(connect=connection_timeout, read=network_timeout)
        host, _, port = url.partition(":")
        pool_kwargs: Dict[str, Any] = dict(
            host=host,
            port=int(port) if port else (443 if ssl else 80),
            maxsize=self._concurrency,
            timeout=self._timeout,
            retries=False,
        )
        if ssl:
            opts = dict(ssl_options or {})
            if insecure:
                pool_kwargs["cert_reqs"] = "CERT_NONE"
            for option, keyword in (("keyfile", "key_file"), ("certfile", "cert_file"),
                                    ("ca_certs", "ca_certs")):
                if option in opts:
                    pool_kwargs[keyword] = opts[option]
            if ssl_context_factory is not None:
                pool_kwargs["ssl_context"] = ssl_context_factory()
            self._pool = urllib3.HTTPSConnectionPool(**pool_kwargs)
        else:
            self._pool = urllib3.HTTPConnectionPool(**pool_kwargs)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._executor_lock = threading.Lock()
        self._infer_stat = InferStat()
        # legacy knob as a policy: connect-only retries, no breaker
        self._legacy_policy = connect_only_policy(max(0, max_retries))

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._pool.close()

    def __enter__(self) -> "InferenceServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def client_infer_stat(self) -> Dict[str, int]:
        """Cumulative client-side inference statistics (see InferStat)."""
        return self._infer_stat.as_dict()

    # -- transport ---------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
        timers: Optional[RequestTimers] = None,
        idempotent: bool = True,
        resilience=None,
        span=None,
    ) -> _Response:
        """Issue one HTTP request; returns the response with the body read.

        Content-Encoding is decoded by urllib3, so ``data`` is always the
        plain payload. With ``timers``, SEND_END is captured once response
        headers arrive and RECV_START/END bracket the body read.

        The request runs under the client's resilience policy (or the
        per-request ``resilience`` override; ``False`` bypasses both it and
        ``max_retries``): connect failures are always re-attemptable;
        in-flight resets and shed-load statuses (408/429/502/503/504) only
        when ``idempotent`` — a sequence infer is never re-sent after its
        bytes may have landed.
        """
        uri = "/" + path
        if query_params:
            uri += "?" + urlencode(query_params)
        if resilience is False:
            policy = None
        else:
            policy = self._resilience_for(resilience) or self._legacy_policy
        kwargs: Dict[str, Any] = dict(preload_content=False)
        if body is not None:
            kwargs["body"] = body
        budget = AttemptBudget(policy, timeout)
        retry_statuses = policy is not None and policy.retry_http_statuses

        def attempt() -> _Response:
            # the plugin runs per attempt: a token-refreshing plugin stamps
            # a fresh credential on every retry
            request = Request(dict(headers or {}))
            self._call_plugin(request)
            kwargs["headers"] = request.headers
            if self._verbose:
                print(f"{method} {uri}, headers {request.headers}")
            remaining = budget.attempt_timeout_s(status="499")
            if remaining is not None:
                kwargs["timeout"] = urllib3.Timeout(connect=remaining, read=remaining)
            resp = None
            t_send = time.perf_counter_ns() if span is not None else 0
            try:
                try:
                    resp = self._pool.request(method, uri, **kwargs)
                except urllib3.exceptions.NewConnectionError as e:
                    # subclasses ConnectTimeoutError in urllib3, but "refused"
                    # isn't "timed out": classify_fault files it under connect
                    raise InferenceServerException(f"connection error: {e}") from e
                if span is not None:
                    # per attempt: a retried request must not fold its
                    # predecessors' failures and backoff into ttfb
                    t_hdrs = time.perf_counter_ns()
                    span.phase("ttfb", t_send, t_hdrs)
                if timers is not None:
                    timers.capture(RequestTimers.SEND_END)
                    timers.capture(RequestTimers.RECV_START)
                data = resp.read(decode_content=True)
                if span is not None:
                    span.phase("recv", t_hdrs, time.perf_counter_ns())
                if timers is not None:
                    timers.capture(RequestTimers.RECV_END)
            except urllib3.exceptions.TimeoutError as e:
                raise InferenceServerException("Deadline Exceeded", status="499") from e
            except urllib3.exceptions.HTTPError as e:
                raise InferenceServerException(f"connection error: {e}") from e
            finally:
                if resp is not None:
                    resp.release_conn()
            if self._verbose:
                print(f"-> {resp.status}, headers {dict(resp.headers)}")
            out = _Response(resp.status, resp.headers, data)
            if retry_statuses and str(resp.status) in RETRYABLE_HTTP_STATUSES:
                raise RetryableStatusError(resp.status, out)
            return out

        run_attempt = attempt
        if span is not None:
            def run_attempt():
                # each resilient attempt is its own interval on the timeline
                t_a = time.perf_counter_ns()
                try:
                    return attempt()
                finally:
                    span.phase("attempt", t_a, time.perf_counter_ns())

        if policy is None:
            return run_attempt()
        on_retry = None
        if self._verbose or span is not None:
            def on_retry(n, exc, delay):
                if span is not None:
                    span.event("retry", attempt=n, backoff_s=round(delay, 6),
                               error=type(exc).__name__)
                if self._verbose:
                    print(f"retrying after attempt {n + 1} failed ({exc}); "
                          f"backoff {delay:.3f}s")
        try:
            return policy.execute(run_attempt, idempotent=idempotent,
                                  timeout_s=timeout, on_retry=on_retry)
        except RetryableStatusError as e:
            # attempts exhausted on a shed-load status: hand the response
            # back so callers keep the plain raise_if_error path
            return e.response

    def _get(self, path, headers=None, query_params=None):
        return self._request("GET", path, headers=headers, query_params=query_params)

    def _post(self, path, body=b"", headers=None, query_params=None):
        return self._request("POST", path, body=body, headers=headers,
                             query_params=query_params)

    @staticmethod
    def _json_of(resp) -> Any:
        raise_if_error(resp.status, resp.data)
        return json.loads(resp.data) if resp.data else {}

    @staticmethod
    def _model_path(model_name: str, model_version: str) -> str:
        path = f"v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        return path

    # -- health / metadata -------------------------------------------------
    def _health(self, path, headers, query_params, probe: bool,
                client_timeout: Optional[float]) -> bool:
        """Shared live/ready GET. By default transport failures (connection
        refused, resets, timeouts) raise: callers tell "the server said not
        ready" from "could not ask". ``probe=True`` is the health-poller
        mode: connect/transient/timeout-class failures return False (a dead
        endpoint is not ready), and the request bypasses any resilience
        policy so the probe sees the endpoint, never a breaker's fast-fail.
        FATAL (application/protocol) errors still raise."""
        try:
            resp = self._request(
                "GET", path, headers=headers, query_params=query_params,
                timeout=client_timeout, resilience=False if probe else None)
        except InferenceServerException as e:
            if probe and classify_fault(e) != FATAL:
                return False
            raise
        return resp.status == 200

    def is_server_live(self, headers=None, query_params=None, probe: bool = False,
                       client_timeout: Optional[float] = None) -> bool:
        return self._health("v2/health/live", headers, query_params, probe, client_timeout)

    def is_server_ready(self, headers=None, query_params=None, probe: bool = False,
                        client_timeout: Optional[float] = None) -> bool:
        return self._health("v2/health/ready", headers, query_params, probe, client_timeout)

    def is_model_ready(self, model_name, model_version="", headers=None, query_params=None) -> bool:
        path = self._model_path(model_name, model_version) + "/ready"
        return self._get(path, headers, query_params).status == 200

    def get_server_metadata(self, headers=None, query_params=None) -> Dict[str, Any]:
        return self._json_of(self._get("v2", headers, query_params))

    def get_model_metadata(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> Dict[str, Any]:
        path = self._model_path(model_name, model_version)
        metadata = self._json_of(self._get(path, headers, query_params))
        # captured into the integrity contract cache: later responses are
        # validated against this fetched truth (never the other way round)
        self._integrity_note_metadata(model_name, metadata)
        return metadata

    def get_model_config(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> Dict[str, Any]:
        path = self._model_path(model_name, model_version) + "/config"
        return self._json_of(self._get(path, headers, query_params))

    # -- repository control ------------------------------------------------
    def get_model_repository_index(self, headers=None, query_params=None) -> List[Dict[str, Any]]:
        resp = self._post("v2/repository/index", b"", headers, query_params)
        raise_if_error(resp.status, resp.data)
        return json.loads(resp.data) if resp.data else []

    def load_model(
        self, model_name, headers=None, query_params=None, config: Optional[str] = None,
        files: Optional[Dict[str, bytes]] = None,
    ) -> None:
        """Load (or reload) a model; ``config`` is a JSON override of its
        config, ``files`` are sent base64-encoded by path."""
        params: Dict[str, Any] = {}
        if config is not None:
            params["config"] = config
        for path, content in (files or {}).items():
            params[path] = base64.b64encode(content).decode("ascii")
        body = {"parameters": params} if params else {}
        resp = self._post(f"v2/repository/models/{quote(model_name)}/load",
                          json.dumps(body).encode("utf-8"), headers, query_params)
        raise_if_error(resp.status, resp.data)

    def unload_model(
        self, model_name, headers=None, query_params=None, unload_dependents: bool = False
    ) -> None:
        body = {"parameters": {"unload_dependents": unload_dependents}}
        resp = self._post(f"v2/repository/models/{quote(model_name)}/unload",
                          json.dumps(body).encode("utf-8"), headers, query_params)
        raise_if_error(resp.status, resp.data)

    # -- statistics / trace / log -------------------------------------------
    def get_inference_statistics(
        self, model_name="", model_version="", headers=None, query_params=None
    ) -> Dict[str, Any]:
        path = (self._model_path(model_name, model_version) + "/stats" if model_name
                else "v2/models/stats")
        return self._json_of(self._get(path, headers, query_params))

    @staticmethod
    def _trace_path(model_name) -> str:
        return f"v2/models/{quote(model_name)}/trace/setting" if model_name else "v2/trace/setting"

    def update_trace_settings(
        self, model_name=None, settings: Optional[Dict[str, Any]] = None,
        headers=None, query_params=None,
    ) -> Dict[str, Any]:
        return self._json_of(self._post(
            self._trace_path(model_name), json.dumps(settings or {}).encode("utf-8"),
            headers, query_params))

    def get_trace_settings(self, model_name=None, headers=None, query_params=None) -> Dict[str, Any]:
        return self._json_of(self._get(self._trace_path(model_name), headers, query_params))

    def update_log_settings(
        self, settings: Dict[str, Any], headers=None, query_params=None
    ) -> Dict[str, Any]:
        return self._json_of(self._post(
            "v2/logging", json.dumps(settings).encode("utf-8"), headers, query_params))

    def get_log_settings(self, headers=None, query_params=None) -> Dict[str, Any]:
        return self._json_of(self._get("v2/logging", headers, query_params))

    # -- shared memory -----------------------------------------------------
    def _shm_status(self, family, region_name, headers, query_params) -> List[Dict[str, Any]]:
        path = f"v2/{family}"
        if region_name:
            path += f"/region/{quote(region_name)}"
        resp = self._get(path + "/status", headers, query_params)
        raise_if_error(resp.status, resp.data)
        return json.loads(resp.data) if resp.data else []

    def _shm_post(self, family, name, action, body, headers, query_params) -> None:
        """One register/unregister call, under data-plane accounting."""
        path = f"v2/{family}"
        if name:
            path += f"/region/{quote(name)}"

        def call():
            resp = self._post(f"{path}/{action}", body, headers, query_params)
            raise_if_error(resp.status, resp.data)

        self._shm_call(SHM_FAMILY_OF[family], action, call, region_name=name)

    def get_system_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ) -> List[Dict[str, Any]]:
        return self._shm_status("systemsharedmemory", region_name, headers, query_params)

    def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, query_params=None
    ) -> None:
        body = {"key": key, "offset": offset, "byte_size": byte_size}
        self._shm_post("systemsharedmemory", name, "register",
                       json.dumps(body).encode("utf-8"), headers, query_params)

    def unregister_system_shared_memory(self, name="", headers=None, query_params=None) -> None:
        self._shm_post("systemsharedmemory", name, "unregister", b"", headers, query_params)

    def get_cuda_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ) -> List[Dict[str, Any]]:
        return self._shm_status("cudasharedmemory", region_name, headers, query_params)

    def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, query_params=None
    ) -> None:
        """Register a cuda_shared_memory region (see utils.cuda_shared_memory).

        ``raw_handle`` is the base64 descriptor from ``get_raw_handle``.
        """
        body = {
            "raw_handle": {"b64": raw_handle},
            "device_id": device_id,
            "byte_size": byte_size,
        }
        self._shm_post("cudasharedmemory", name, "register",
                       json.dumps(body).encode("utf-8"), headers, query_params)

    def unregister_cuda_shared_memory(self, name="", headers=None, query_params=None) -> None:
        self._shm_post("cudasharedmemory", name, "unregister", b"", headers, query_params)

    # -- inference ---------------------------------------------------------
    @staticmethod
    def generate_request_body(
        inputs: Sequence[InferInput],
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        **kwargs,
    ):
        """Offline marshaling: returns (body, json_size)."""
        return build_infer_body(inputs, outputs, **kwargs)

    @staticmethod
    def parse_response_body(
        response_body: bytes, verbose: bool = False, header_length: Optional[int] = None,
        content_encoding: Optional[str] = None,
    ) -> InferResult:
        body = decompress_body(response_body, content_encoding)
        return InferResult.from_response_body(body, header_length)

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
        query_params: Optional[Dict[str, Any]] = None,
        request_compression_algorithm: Optional[str] = None,
        response_compression_algorithm: Optional[str] = None,
        parameters: Optional[Dict[str, Any]] = None,
        resilience=None,
        tenant: Optional[str] = None,
    ) -> InferResult:
        """Run a synchronous inference.

        ``resilience``: per-request ``ResiliencePolicy`` override (``False``
        bypasses the policy). Sequence requests (``sequence_id != 0``) are
        non-idempotent: only never-sent connect failures are retried.

        ``tenant``: client-side QoS attribution (see
        ``client_tpu_torch.tenancy``) — recorded on the request's span,
        NEVER sent on the wire; quota/fairness enforcement happens in the
        pool's admission gate, which consumes the kwarg before it
        reaches a frontend."""
        span = self._obs_begin(self._FRONTEND, model_name)
        if span is not None and tenant is not None:
            span.event("tenant", tenant=tenant)
        timers = RequestTimers()
        timers.capture(RequestTimers.REQUEST_START)
        actx = None
        try:
            # arena data plane: promote staged binary inputs into leased
            # slabs and ensure (cached) region registrations BEFORE the
            # body is built, so the request rides shm params
            actx = self._arena_bind(inputs, outputs)
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

            timers.capture(RequestTimers.SEND_START)
            resp = self._request(
                "POST", self._model_path(model_name, model_version) + "/infer",
                body=body, headers=hdrs, query_params=query_params,
                timeout=client_timeout, timers=timers,
                idempotent=sequence_id == 0, resilience=resilience, span=span,
            )
            raise_if_error(resp.status, resp.data)
            t_deser = time.perf_counter_ns() if span is not None else 0
            header_length = resp.headers.get("Inference-Header-Content-Length")
            try:
                result = InferResult.from_response_body(
                    resp.data, int(header_length) if header_length is not None else None)
            except IntegrityError as e:
                # an undecodable body: attribute it to this endpoint and
                # account it like any other integrity violation
                self._integrity_parse_note(e)
                raise
            result._response_headers = dict(resp.headers)  # e.g. endpoint-load-metrics
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
            # response fully received: promoted input leases release and
            # the inputs' wire staging is restored for reuse
            if actx is not None:
                actx.settle()
        timers.capture(RequestTimers.REQUEST_END)
        self._infer_stat.update(timers)
        if span is not None:
            span.phase("deserialize", t_deser, time.perf_counter_ns())
            self._telemetry.finish(span)
        # after the phase capture: ORCA bookkeeping must not count as
        # deserialize time
        self._orca_ingest(result)
        if self._verbose:
            print(result.get_response())
        return result

    def async_infer(self, model_name: str, inputs: Sequence[InferInput],
                    **kwargs) -> InferAsyncRequest:
        """Submit an inference on the client's thread pool; returns a handle."""
        with self._executor_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._concurrency, thread_name_prefix="client_tpu_torch_http")
        future = self._executor.submit(self.infer, model_name, inputs, **kwargs)
        return InferAsyncRequest(future, self._verbose)

    # -- generate extension (LLM JSON API) ----------------------------------
    @classmethod
    def _generate_path(cls, model_name: str, model_version: str, stream: bool) -> str:
        tail = "generate_stream" if stream else "generate"
        return f"{cls._model_path(model_name, model_version)}/{tail}"

    @staticmethod
    def _generate_payload(inputs, request_id, parameters) -> bytes:
        payload = dict(inputs)
        if request_id:
            payload["id"] = request_id
        if parameters:
            payload["parameters"] = parameters
        return json.dumps(payload).encode("utf-8")

    def generate(
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
        resp = self._request(
            "POST", self._generate_path(model_name, model_version, stream=False),
            self._generate_payload(inputs, request_id, parameters),
            headers, query_params,
        )
        raise_if_error(resp.status, resp.data)
        return json.loads(resp.data)

    def generate_stream(
        self,
        model_name: str,
        inputs: Dict[str, Any],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
        tenant: Optional[str] = None,
    ):
        """Iterator over generate-extension SSE events, one dict per
        streamed response. Abandoning the iterator mid-stream closes the
        connection, which the server sees as a client cancel. In-band error
        events raise.

        With telemetry configured the stream is traced as a ``StreamSpan``
        (open -> first-event TTFT -> per-event marks -> close/error/abandon)
        and a ``traceparent`` header joins it to the server's access record
        for the generation. ``tenant`` is client-side QoS attribution only
        (see ``client_tpu_torch.tenancy``) — marked on the stream span,
        never sent on the wire."""
        hdrs = dict(headers or {})
        span = self._obs_begin_stream(self._FRONTEND, model_name)
        self._last_stream_span = span
        if span is not None and tenant is not None:
            span.event("tenant", tenant=tenant)
        if span is not None:
            hdrs[TRACEPARENT_HEADER] = span.traceparent()
        request = Request(hdrs)
        self._call_plugin(request)
        uri = "/" + self._generate_path(model_name, model_version, stream=True)
        if query_params:
            uri += "?" + urlencode(query_params)
        tel = self._telemetry
        try:
            try:
                # no read deadline: generation streams for as long as it
                # streams; the pool's connect timeout still applies
                resp = self._pool.request(
                    "POST", uri,
                    body=self._generate_payload(inputs, request_id, parameters),
                    headers=request.headers, preload_content=False,
                    timeout=urllib3.Timeout(connect=self._timeout.connect_timeout, read=None),
                )
            except urllib3.exceptions.HTTPError as e:
                raise InferenceServerException(f"connection error: {e}") from e
            exhausted = False
            try:
                if resp.status != 200:
                    try:
                        data = resp.read(decode_content=True)
                    except urllib3.exceptions.HTTPError as e:
                        raise InferenceServerException(f"connection error: {e}") from e
                    raise_if_error(resp.status, data)
                    raise InferenceServerException(
                        f"unexpected generate_stream status {resp.status}")
                decoder = SSEDecoder()
                # marked at parse time (arrival), before the consumer runs
                mark = span.mark if span is not None else None
                # opt-in stream-index integrity; None when the policy is off
                checker = self._integrity_stream_checker(model_name)
                try:
                    for chunk in resp.stream(8192, decode_content=True):
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
                except urllib3.exceptions.HTTPError as e:
                    raise InferenceServerException(f"connection error: {e}") from e
                exhausted = True
            finally:
                if exhausted:
                    # fully-drained chunked body: the connection is reusable
                    resp.release_conn()
                else:
                    # an abandoned stream must tear the connection down so
                    # the server sees the disconnect
                    resp.close()
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
