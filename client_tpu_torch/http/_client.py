"""Synchronous KServe v2 HTTP/REST client.

The counterpart of ``client_tpu.http.InferenceServerClient`` for the routes
this port serves: health, metadata and config, ``infer``, the generate
extension (``generate`` / ``generate_stream`` over SSE) and shared-memory
registration for the system and cuda families. Request bodies and headers
are byte-identical to the JAX package's for the same inputs.

Transport: a urllib3 connection pool. One attempt per call: retry policies,
telemetry and response-integrity checks are layers the port does not carry
yet.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence
from urllib.parse import quote, urlencode

import urllib3

from .._base import InferenceServerClientBase, InferStat, Request, RequestTimers
from .._tensor import InferInput, InferRequestedOutput
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


class InferenceServerClient(InferenceServerClientBase):
    """Client for the KServe v2 HTTP/REST protocol.

    One instance should be driven from one thread at a time.
    """

    def __init__(
        self,
        url: str,
        verbose: bool = False,
        concurrency: int = 1,
        connection_timeout: float = 60.0,
        network_timeout: float = 60.0,
    ):
        super().__init__()
        if "://" in url:
            raise InferenceServerException(
                f"unexpected scheme in url '{url}' (pass host:port)"
            )
        self._url = url
        self._verbose = verbose
        self._timeout = urllib3.Timeout(connect=connection_timeout, read=network_timeout)
        host, _, port = url.partition(":")
        self._pool = urllib3.HTTPConnectionPool(
            host=host,
            port=int(port) if port else 80,
            maxsize=max(1, concurrency),
            timeout=self._timeout,
            retries=False,
        )
        self._infer_stat = InferStat()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
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
    ) -> _Response:
        """Issue one HTTP request; returns the response with the body read.

        Content-Encoding is decoded by urllib3, so ``data`` is always the
        plain payload. With ``timers``, SEND_END is captured once response
        headers arrive and RECV_START/END bracket the body read.
        """
        uri = "/" + path
        if query_params:
            uri += "?" + urlencode(query_params)
        request = Request(dict(headers or {}))
        self._call_plugin(request)
        kwargs: Dict[str, Any] = dict(preload_content=False, headers=request.headers)
        if body is not None:
            kwargs["body"] = body
        if timeout is not None:
            kwargs["timeout"] = urllib3.Timeout(connect=timeout, read=timeout)
        if self._verbose:
            print(f"{method} {uri}, headers {request.headers}")
        resp = None
        try:
            try:
                resp = self._pool.request(method, uri, **kwargs)
            except urllib3.exceptions.NewConnectionError as e:
                # subclasses ConnectTimeoutError in urllib3, but "refused"
                # isn't "timed out"
                raise InferenceServerException(f"connection error: {e}") from e
            if timers is not None:
                timers.capture(RequestTimers.SEND_END)
                timers.capture(RequestTimers.RECV_START)
            data = resp.read(decode_content=True)
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
        return _Response(resp.status, resp.headers, data)

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
    def is_server_live(self, headers=None, query_params=None) -> bool:
        return self._get("v2/health/live", headers, query_params).status == 200

    def is_server_ready(self, headers=None, query_params=None) -> bool:
        return self._get("v2/health/ready", headers, query_params).status == 200

    def is_model_ready(self, model_name, model_version="", headers=None, query_params=None) -> bool:
        path = self._model_path(model_name, model_version) + "/ready"
        return self._get(path, headers, query_params).status == 200

    def get_server_metadata(self, headers=None, query_params=None) -> Dict[str, Any]:
        return self._json_of(self._get("v2", headers, query_params))

    def get_model_metadata(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> Dict[str, Any]:
        path = self._model_path(model_name, model_version)
        return self._json_of(self._get(path, headers, query_params))

    def get_model_config(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> Dict[str, Any]:
        path = self._model_path(model_name, model_version) + "/config"
        return self._json_of(self._get(path, headers, query_params))

    # -- shared memory -----------------------------------------------------
    def _shm_status(self, family, region_name, headers, query_params) -> List[Dict[str, Any]]:
        path = f"v2/{family}"
        if region_name:
            path += f"/region/{quote(region_name)}"
        resp = self._get(path + "/status", headers, query_params)
        raise_if_error(resp.status, resp.data)
        return json.loads(resp.data) if resp.data else []

    def _shm_post(self, family, name, action, body, headers, query_params) -> None:
        path = f"v2/{family}"
        if name:
            path += f"/region/{quote(name)}"
        resp = self._post(f"{path}/{action}", body, headers, query_params)
        raise_if_error(resp.status, resp.data)

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
    ) -> InferResult:
        """Run a synchronous inference."""
        timers = RequestTimers()
        timers.capture(RequestTimers.REQUEST_START)
        body, json_size = build_infer_body(
            inputs, outputs, request_id, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters,
        )
        hdrs = dict(headers or {})
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

        timers.capture(RequestTimers.SEND_START)
        resp = self._request(
            "POST", self._model_path(model_name, model_version) + "/infer",
            body=body, headers=hdrs, query_params=query_params,
            timeout=client_timeout, timers=timers,
        )
        raise_if_error(resp.status, resp.data)
        header_length = resp.headers.get("Inference-Header-Content-Length")
        result = InferResult.from_response_body(
            resp.data, int(header_length) if header_length is not None else None)
        timers.capture(RequestTimers.REQUEST_END)
        self._infer_stat.update(timers)
        if self._verbose:
            print(result.get_response())
        return result

    # -- generate extension (LLM JSON API) ----------------------------------
    def _generate_path(self, model_name: str, model_version: str, stream: bool) -> str:
        tail = "generate_stream" if stream else "generate"
        return f"{self._model_path(model_name, model_version)}/{tail}"

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
    ):
        """Iterator over generate-extension SSE events, one dict per
        streamed response. Abandoning the iterator mid-stream closes the
        connection, which the server sees as a client cancel. In-band error
        events raise."""
        request = Request(dict(headers or {}))
        self._call_plugin(request)
        uri = "/" + self._generate_path(model_name, model_version, stream=True)
        if query_params:
            uri += "?" + urlencode(query_params)
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
            try:
                for chunk in resp.stream(8192, decode_content=True):
                    for payload in decoder.feed(chunk):
                        yield parse_sse_event(payload)
                for payload in decoder.flush():
                    yield parse_sse_event(payload)
            except urllib3.exceptions.HTTPError as e:
                raise InferenceServerException(f"connection error: {e}") from e
            exhausted = True
        finally:
            if exhausted:
                # fully-drained chunked body: the connection is reusable
                resp.release_conn()
            else:
                # an abandoned stream must tear the connection down so the
                # server sees the disconnect
                resp.close()
