"""Asyncio KServe v2 HTTP client (mirrors ``client_tpu.http.aio``).

The aiohttp twin of the sync client, with ``async def`` methods over the
same routes. It shares the body builders, parsers and value model with the
sync client; only the transport differs, so request bodies and headers are
the sync client's.

One attempt per call: retry policies, telemetry, response-integrity checks
and the shm arena are layers the port does not carry yet.
"""

from __future__ import annotations

import asyncio
import base64
import json
from typing import Any, Dict, Optional, Sequence
from urllib.parse import quote

import aiohttp

from ..._base import InferenceServerClientBase, Request
from ..._tensor import InferInput, InferRequestedOutput
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
    ):
        """One HTTP round trip: (status, headers, body)."""
        url = f"{self._base}/{path}"
        request = Request(dict(headers or {}))
        self._call_plugin(request)
        kwargs: Dict[str, Any] = dict(params=query_params, headers=request.headers)
        if body is not None:
            kwargs["data"] = body
        if timeout is not None:
            kwargs["timeout"] = aiohttp.ClientTimeout(total=timeout)
        if self._verbose:
            print(f"{method} {url}, headers {request.headers}")
        try:
            async with self._session.request(method, url, **kwargs) as resp:
                data = await resp.read()
                if self._verbose:
                    print(f"-> {resp.status}")
                return resp.status, dict(resp.headers), data
        except (TimeoutError, asyncio.TimeoutError) as e:
            # aiohttp raises TimeoutError on ClientTimeout(total=) expiry
            raise InferenceServerException("Deadline Exceeded", status="499") from e
        except aiohttp.ClientError as e:
            raise InferenceServerException(f"connection error: {e}") from e

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
    async def _status_of(self, path, headers, query_params, client_timeout=None) -> bool:
        status, _, _ = await self._request(
            "GET", path, None, headers, query_params, timeout=client_timeout)
        return status == 200

    async def is_server_live(self, headers=None, query_params=None,
                             client_timeout: Optional[float] = None) -> bool:
        return await self._status_of("v2/health/live", headers, query_params, client_timeout)

    async def is_server_ready(self, headers=None, query_params=None,
                              client_timeout: Optional[float] = None) -> bool:
        return await self._status_of("v2/health/ready", headers, query_params, client_timeout)

    async def is_model_ready(self, model_name, model_version="", headers=None,
                             query_params=None) -> bool:
        return await self._status_of(
            self._model_path(model_name, model_version) + "/ready", headers, query_params)

    async def get_server_metadata(self, headers=None, query_params=None):
        return await self._get_json("v2", headers, query_params)

    async def get_model_metadata(self, model_name, model_version="", headers=None,
                                 query_params=None):
        return await self._get_json(
            self._model_path(model_name, model_version), headers, query_params)

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

    async def _shm_unregister(self, family, name, headers, query_params):
        path = f"v2/{family}"
        if name:
            path += f"/region/{quote(name)}"
        await self._post_json(path + "/unregister", b"", headers, query_params)

    async def get_system_shared_memory_status(self, region_name="", headers=None,
                                              query_params=None):
        return await self._shm_status("systemsharedmemory", region_name, headers, query_params)

    async def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                            headers=None, query_params=None):
        body = json.dumps({"key": key, "offset": offset, "byte_size": byte_size}).encode()
        await self._post_json(f"v2/systemsharedmemory/region/{quote(name)}/register",
                              body, headers, query_params)

    async def unregister_system_shared_memory(self, name="", headers=None, query_params=None):
        await self._shm_unregister("systemsharedmemory", name, headers, query_params)

    async def get_cuda_shared_memory_status(self, region_name="", headers=None,
                                            query_params=None):
        return await self._shm_status("cudasharedmemory", region_name, headers, query_params)

    async def register_cuda_shared_memory(self, name, raw_handle, device_id, byte_size,
                                          headers=None, query_params=None):
        body = json.dumps({"raw_handle": {"b64": raw_handle}, "device_id": device_id,
                           "byte_size": byte_size}).encode()
        await self._post_json(f"v2/cudasharedmemory/region/{quote(name)}/register",
                              body, headers, query_params)

    async def unregister_cuda_shared_memory(self, name="", headers=None, query_params=None):
        await self._shm_unregister("cudasharedmemory", name, headers, query_params)

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
    ) -> InferResult:
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
        status, resp_headers, data = await self._request(
            "POST", self._model_path(model_name, model_version) + "/infer", body, hdrs,
            query_params, timeout=client_timeout,
        )
        raise_if_error(status, data)  # aiohttp decodes Content-Encoding itself
        header_length = resp_headers.get("Inference-Header-Content-Length")
        result = InferResult.from_response_body(
            data, int(header_length) if header_length is not None else None)
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
        error events raise."""
        request = Request(dict(headers or {}))
        self._call_plugin(request)
        url = f"{self._base}/{self._generate_path(model_name, model_version, stream=True)}"
        body = self._generate_payload(inputs, request_id, parameters)
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
                async for chunk in resp.content.iter_chunked(8192):
                    for payload in decoder.feed(chunk):
                        yield parse_sse_event(payload)
                for payload in decoder.flush():
                    yield parse_sse_event(payload)
        except aiohttp.ClientError as e:
            raise InferenceServerException(f"connection error: {e}") from e
