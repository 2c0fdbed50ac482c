"""HTTP/REST frontend for ServerCore: the KServe v2 protocol routes this port
serves.

The counterpart of ``client_tpu.server.http_server``: health, server and
model metadata, model config, shared-memory registration and status for the
system and cuda families, two-part binary inference bodies with
``Inference-Header-Content-Length``, the generate extension (``/generate``
and SSE ``/generate_stream``), and the admin routes: the repository index,
load and unload, statistics, trace settings and logging. Response bytes are
identical to the JAX server's for the same outputs (statistics differ in
their timing fields alone). ``close`` drains: ready answers 503 while
in-flight requests finish, then the listener closes.
"""

from __future__ import annotations

import gzip
import itertools
import json
import re
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import unquote

import numpy as np

from ..utils import triton_to_np_dtype
from .core import InferError, ServerCore, _array_to_bytes, _bytes_to_array

_MODEL_RE = re.compile(r"^/v2/models/([^/]+)(?:/versions/([^/]+))?(?:/(.*))?$")
_SHM_RE = re.compile(
    r"^/v2/(systemsharedmemory|cudasharedmemory)"
    r"(?:/region/([^/]+))?/(status|register|unregister)$"
)
_REPOSITORY_RE = re.compile(r"^/v2/repository/models/([^/]+)/(load|unload)$")
_MODEL_TRACE_RE = re.compile(r"^/v2/models/[^/]+/trace/setting$")
_FAMILY = {
    "systemsharedmemory": "system",
    "cudasharedmemory": "cuda",
}


def _generate_core_request(model, payload: Any) -> Dict[str, Any]:
    """Map a generate-extension JSON payload onto a core infer request.

    'id' and 'parameters' are reserved; every other key names an input
    tensor whose value is a JSON scalar or (nested) list, or an object
    referencing a registered shared-memory region (``shared_memory_region``,
    ``shared_memory_byte_size``, ``shared_memory_offset`` and an explicit
    ``shape``), resolved by the core like infer's shm parameters. Shapes are
    conformed to the model's metadata by prepending singleton dims
    ([1,2,3] -> [1,3] for an INT32[1,-1] input).
    """
    if not isinstance(payload, dict):
        raise InferError("generate request must be a JSON object", 400)
    specs = {s.name: s for s in model.inputs()}
    params = payload.get("parameters", {})
    if not isinstance(params, dict):
        raise InferError("generate 'parameters' must be an object", 400)
    req: Dict[str, Any] = {"inputs": [], "parameters": dict(params)}
    if payload.get("id"):
        req["id"] = str(payload["id"])
    for key, value in payload.items():
        if key in ("id", "parameters"):
            continue
        spec = specs.get(key)
        if spec is None:
            raise InferError(
                f"unexpected generate input '{key}' for model '{model.name}'", 400)
        if isinstance(value, dict):
            if "shared_memory_region" not in value:
                raise InferError(
                    f"generate input '{key}': object values must carry a "
                    "'shared_memory_region' reference", 400)
            shape = value.get("shape")
            if (not isinstance(shape, list) or not shape
                    or not all(isinstance(d, int) and not isinstance(d, bool)
                               and d >= 0 for d in shape)):
                raise InferError(
                    f"generate input '{key}': a shared-memory reference "
                    "needs an explicit 'shape' (list of non-negative "
                    "ints) — raw region bytes carry no shape", 400)
            req["inputs"].append({
                "name": key,
                "datatype": spec.datatype,
                "shape": list(shape),
                "shm": (
                    value["shared_memory_region"],
                    value.get("shared_memory_byte_size", 0),
                    value.get("shared_memory_offset", 0),
                ),
            })
            continue
        if spec.datatype == "BYTES":
            shaped = np.asarray(value, dtype=object)

            def as_bytes(v):
                if isinstance(v, str):
                    return v.encode("utf-8")
                if isinstance(v, (bytes, bytearray)):
                    return bytes(v)
                # JSON numbers/bools: their string form, NOT bytes(int)
                return str(v).encode("utf-8")

            arr = np.array(
                [as_bytes(v) for v in shaped.reshape(-1)], dtype=object
            ).reshape(shaped.shape)
        else:
            try:
                arr = np.asarray(value, dtype=triton_to_np_dtype(spec.datatype))
            except (TypeError, ValueError) as e:
                raise InferError(
                    f"generate input '{key}' does not parse as {spec.datatype}: {e}", 400)
        while arr.ndim < len(spec.shape):
            arr = arr[np.newaxis, ...]
        req["inputs"].append({
            "name": key,
            "datatype": spec.datatype,
            "shape": list(arr.shape),
            "array": arr,
        })
    return req


def _generate_event(resp: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one core response into the generate extension's JSON shape:
    metadata keys plus one flat key per output tensor (scalar when the
    tensor has a single element)."""
    out: Dict[str, Any] = {
        "model_name": resp["model_name"],
        "model_version": resp["model_version"],
    }
    if resp.get("id"):
        out["id"] = resp["id"]
    for entry in resp["outputs"]:
        arr = entry["array"]
        if entry["datatype"] == "BYTES":
            values = [
                v.decode("utf-8", "replace") if isinstance(v, (bytes, np.bytes_)) else str(v)
                for v in np.asarray(arr, dtype=object).reshape(-1)
            ]
        elif entry["datatype"] == "BF16":
            values = np.asarray(arr, dtype=np.float32).reshape(-1).tolist()
        else:
            values = np.asarray(arr).reshape(-1).tolist()
        out[entry["name"]] = values[0] if len(values) == 1 else values
    return out


def _sse_event(obj: Any) -> bytes:
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


def _generate_once(core: ServerCore, model_name: str, model_version: str,
                   core_req: Dict[str, Any]) -> Dict[str, Any]:
    """One-shot /generate: pull at most TWO responses — a second already
    proves the generation belongs on /generate_stream."""
    gen = core.infer_stream(model_name, model_version, core_req)
    try:
        responses = list(itertools.islice(gen, 2))
    finally:
        gen.close()
    if len(responses) != 1:
        detail = ("no response" if not responses
                  else "more than one; use /generate_stream")
        raise InferError(
            f"generate expects exactly one response but model "
            f"'{model_name}' produced {detail}", 400)
    return _generate_event(responses[0])


def _flatten(data):
    if isinstance(data, (list, tuple)):
        for item in data:
            yield from _flatten(item)
    else:
        yield data


def _decode_input(entry: Dict[str, Any], tail: memoryview, cursor: int) -> Tuple[Dict[str, Any], int]:
    """Convert one JSON input descriptor (+binary tail slice) to the core shape."""
    params = entry.get("parameters", {})
    out: Dict[str, Any] = {
        "name": entry["name"],
        "datatype": entry["datatype"],
        "shape": entry["shape"],
    }
    if "shared_memory_region" in params:
        out["shm"] = (
            params["shared_memory_region"],
            params.get("shared_memory_byte_size", 0),
            params.get("shared_memory_offset", 0),
        )
        return out, cursor
    size = params.get("binary_data_size")
    if size is not None:
        if isinstance(size, bool) or not isinstance(size, int) or size < 0:
            raise InferError(
                f"input '{entry['name']}': binary_data_size must be a "
                f"non-negative integer, got {size!r}", 400,
            )
        if cursor + size > len(tail):
            raise InferError(
                f"input '{entry['name']}': binary_data_size {size} overruns "
                f"the binary payload ({len(tail) - cursor} bytes remain)", 400,
            )
        raw = bytearray(tail[cursor : cursor + size])
        out["array"] = _bytes_to_array(raw, entry["datatype"], entry["shape"])
        return out, cursor + size
    data = entry.get("data")
    if data is None:
        raise InferError(f"input '{entry['name']}' has no data", 400)
    if entry["datatype"] == "BYTES":
        arr = np.array(
            [d.encode("utf-8") if isinstance(d, str) else bytes(d) for d in _flatten(data)],
            dtype=np.object_,
        ).reshape(entry["shape"])
    else:
        arr = np.array(data, dtype=triton_to_np_dtype(entry["datatype"])).reshape(entry["shape"])
    out["array"] = arr
    return out, cursor


def parse_infer_request(body: bytes, header_length: Optional[int]) -> Dict[str, Any]:
    """Parse a two-part infer body into the neutral core request dict."""
    if header_length is None:
        header = json.loads(body)
        tail = memoryview(b"")
    else:
        header = json.loads(body[:header_length])
        tail = memoryview(body)[header_length:]
    request: Dict[str, Any] = {
        "id": header.get("id", ""),
        "parameters": header.get("parameters", {}),
        "inputs": [],
    }
    cursor = 0
    for entry in header.get("inputs", []):
        decoded, cursor = _decode_input(entry, tail, cursor)
        request["inputs"].append(decoded)
    outputs = []
    binary_default = bool(request["parameters"].get("binary_data_output", False))
    for entry in header.get("outputs", []) or []:
        params = entry.get("parameters", {})
        spec: Dict[str, Any] = {
            "name": entry["name"],
            "binary": params.get("binary_data", binary_default),
            "classification": params.get("classification", 0),
        }
        if "shared_memory_region" in params:
            spec["shm"] = (
                params["shared_memory_region"],
                params.get("shared_memory_byte_size", 0),
                params.get("shared_memory_offset", 0),
            )
        outputs.append(spec)
    if outputs:
        request["outputs"] = outputs
    elif binary_default:
        request["outputs"] = None
        request["binary_default"] = True
    return request


def infer_request_encoding_prefs(request: Dict[str, Any]):
    """``(requested, binary_default)`` for ``encode_infer_response`` —
    shared by the HTTP frontend and the byzantine test server so identical
    request bytes always produce identically-encoded responses."""
    requested = request.get("outputs")
    binary_default = bool(
        request.get("binary_default")
        or request.get("parameters", {}).get("binary_data_output", False)
    )
    return requested, binary_default


def encode_infer_response(
    response: Dict[str, Any], requested: Optional[List[Dict[str, Any]]],
    binary_default: bool,
) -> Tuple[bytes, Optional[int]]:
    """Encode a core response dict into (body, json_header_length)."""
    req_by_name = {r["name"]: r for r in requested or []}
    header: Dict[str, Any] = {
        "model_name": response["model_name"],
        "model_version": response["model_version"],
    }
    if response.get("id"):
        header["id"] = response["id"]
    out_entries = []
    tails: List[bytes] = []
    for out in response["outputs"]:
        entry: Dict[str, Any] = {
            "name": out["name"],
            "datatype": out["datatype"],
            "shape": out["shape"],
        }
        if "shm" in out:
            region, byte_size, offset = out["shm"]
            entry["parameters"] = {
                "shared_memory_region": region,
                "shared_memory_byte_size": byte_size,
            }
            if offset:
                entry["parameters"]["shared_memory_offset"] = offset
        else:
            spec = req_by_name.get(out["name"], {})
            binary = spec.get("binary", binary_default)
            arr = out["array"]
            if out["datatype"] == "BF16":
                binary = True  # no JSON representation
            if binary:
                payload = _array_to_bytes(arr, out["datatype"])
                tails.append(payload)
                entry["parameters"] = {"binary_data_size": len(payload)}
            elif out["datatype"] == "BYTES":
                entry["data"] = [
                    e.decode("utf-8", errors="replace") if isinstance(e, bytes) else str(e)
                    for e in arr.reshape(-1).tolist()
                ]
            else:
                entry["data"] = [v.item() for v in np.nditer(arr, order="C")]
        out_entries.append(entry)
    header["outputs"] = out_entries
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if not tails:
        return hj, None
    return hj + b"".join(tails), len(hj)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: small control-message responses (the point of the shm
    # data plane) must not wait out Nagle + delayed ACK
    disable_nagle_algorithm = True
    core: ServerCore  # set by the server factory

    def log_message(self, fmt, *args):  # quiet unless verbose
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # -- plumbing ----------------------------------------------------------
    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        encoding = self.headers.get("Content-Encoding")
        if encoding == "gzip":
            body = gzip.decompress(body)
        elif encoding == "deflate":
            body = zlib.decompress(body)
        return body

    def _send(self, status: int, body: bytes = b"", headers: Optional[Dict[str, str]] = None):
        # honor Accept-Encoding; Inference-Header-Content-Length refers to
        # the *uncompressed* body, as the protocol says
        accept = self.headers.get("Accept-Encoding", "")
        headers = dict(headers or {})
        if body and "Content-Encoding" not in headers:
            if "gzip" in accept:
                body = gzip.compress(body)
                headers["Content-Encoding"] = "gzip"
            elif "deflate" in accept:
                body = zlib.compress(body)
                headers["Content-Encoding"] = "deflate"
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, obj: Any, status: int = 200):
        self._send(
            status,
            json.dumps(obj, separators=(",", ":")).encode("utf-8"),
            {"Content-Type": "application/json"},
        )

    def _send_error_json(self, e: Exception):
        status = e.status if isinstance(e, InferError) else 500
        self._send_json({"error": str(e)}, status)

    # -- GET ---------------------------------------------------------------
    def do_GET(self):
        self.server.request_began()
        try:
            self._route_get()
        finally:
            self.server.request_ended()

    def _route_get(self):
        core = self.core
        path = self.path.split("?", 1)[0]
        try:
            if path in ("/v2", "/v2/"):
                return self._send_json(core.server_metadata())
            if path == "/metrics":
                # the Prometheus scrape target; not gated on core.ready: a
                # scraper must see the drain (ready gauge 0), not errors
                return self._send(
                    200, core.metrics_registry().prometheus_text().encode(),
                    {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"})
            if path == "/v2/health/live":
                return self._send(200 if core.live else 503)
            if path == "/v2/health/ready":
                # drainable: drain()/close() flip core.ready
                return self._send(200 if (core.live and core.ready) else 503)
            if path == "/v2/models/stats":
                return self._send_json(core.statistics())
            if path == "/v2/trace/access":
                # traceparent-joined server spans (queue/compute ns and
                # wall_time_s)
                return self._send_json(core.access_records())
            if path == "/v2/trace/setting":
                return self._send_json(core.trace_settings)
            if path == "/v2/logging":
                return self._send_json(core.log_settings)
            m = _SHM_RE.match(path)
            if m and m.group(3) == "status":
                return self._send_json(
                    core.region_status(_FAMILY[m.group(1)], unquote(m.group(2) or "")))
            m = _MODEL_RE.match(path)
            if m:
                name, version, tail = unquote(m.group(1)), m.group(2) or "", m.group(3) or ""
                if tail == "ready":
                    return self._send(200 if core.model_ready(name, version) else 400)
                if tail == "config":
                    return self._send_json(core.model(name, version).config())
                if tail == "stats":
                    return self._send_json(core.statistics(name, version))
                if tail == "trace/setting":
                    return self._send_json(core.trace_settings)
                if tail == "":
                    return self._send_json(core.model(name, version).metadata())
            self._send_json({"error": f"unknown route {path}"}, 404)
        except Exception as e:
            self._send_error_json(e)

    # -- POST --------------------------------------------------------------
    def do_POST(self):
        self.server.request_began()
        try:
            self._route_post()
        finally:
            self.server.request_ended()

    def _route_post(self):
        core = self.core
        path = self.path.split("?", 1)[0]
        try:
            body = self._read_body()
            if path == "/v2/repository/index":
                return self._send_json(core.repository_index())
            m = _REPOSITORY_RE.match(path)
            if m:
                if m.group(2) == "load":
                    payload = json.loads(body) if body else {}
                    if not isinstance(payload, dict):
                        raise InferError("load request body must be a JSON object", 400)
                    config = payload.get("parameters", {}).get("config")
                    core.load_model(unquote(m.group(1)), config=config)
                else:
                    core.unload_model(unquote(m.group(1)))
                return self._send_json({})
            if path == "/v2/trace/setting" or _MODEL_TRACE_RE.match(path):
                settings = json.loads(body) if body else {}
                for k, v in settings.items():
                    core.trace_settings[k] = v
                return self._send_json(core.trace_settings)
            if path == "/v2/logging":
                settings = json.loads(body) if body else {}
                for k, v in settings.items():
                    core.log_settings[k] = v
                return self._send_json(core.log_settings)
            m = _SHM_RE.match(path)
            if m:
                family, action = _FAMILY[m.group(1)], m.group(3)
                region = unquote(m.group(2)) if m.group(2) else None
                payload = json.loads(body) if body else {}
                if action == "register":
                    if family == "system":
                        core.register_system_region(
                            region, payload["key"], payload.get("offset", 0),
                            payload["byte_size"])
                    else:
                        core.register_cuda_region(
                            region, payload["raw_handle"]["b64"],
                            payload.get("device_id", 0), payload["byte_size"])
                elif action == "unregister":
                    core.unregister_region(region or "", None if region else family)
                else:
                    return self._send_json({"error": f"unknown route {path}"}, 404)
                return self._send_json({})
            m = _MODEL_RE.match(path)
            tail = (m.group(3) or "") if m else None
            if tail == "infer":
                return self._do_infer(unquote(m.group(1)), m.group(2) or "", body)
            if tail in ("generate", "generate_stream"):
                return self._do_generate(
                    unquote(m.group(1)), m.group(2) or "", body,
                    stream=tail == "generate_stream")
            self._send_json({"error": f"unknown route {path}"}, 404)
        except InferError as e:
            self._send_error_json(e)
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            self._send_json({"error": f"failed to parse request: {e}"}, 400)
        except Exception as e:
            self._send_json({"error": f"internal error: {e}"}, 500)

    def _do_infer(self, model_name: str, model_version: str, body: bytes):
        header_length = self.headers.get("Inference-Header-Content-Length")
        request = parse_infer_request(
            body, int(header_length) if header_length is not None else None)
        traceparent = self.headers.get("traceparent")
        if traceparent:
            # W3C trace context: the core records a server-side span joined
            # on this trace id (ServerCore.access_records)
            request["traceparent"] = traceparent
        requested, binary_default = infer_request_encoding_prefs(request)
        response = self.core.infer(model_name, model_version, request)
        body_out, json_size = encode_infer_response(response, requested, binary_default)
        headers = {"Content-Type": "application/json"}
        if json_size is not None:
            headers = {
                "Content-Type": "application/octet-stream",
                "Inference-Header-Content-Length": str(json_size),
            }
        # ORCA per-response load metrics: the client opts in with the
        # endpoint-load-metrics-format request header
        orca_format = self.headers.get("endpoint-load-metrics-format")
        if orca_format in ("json", "text"):
            headers["endpoint-load-metrics"] = self.core.orca_report(orca_format, model_name)
        self._send(200, body_out, headers)

    def _do_generate(self, model_name: str, model_version: str, body: bytes, stream: bool):
        payload = json.loads(body) if body else {}
        core_req = _generate_core_request(self.core.model(model_name, model_version), payload)
        traceparent = self.headers.get("traceparent")
        if traceparent:
            # the whole generation (streamed or not) joins the client's
            # stream span in ServerCore.access_records
            core_req["traceparent"] = traceparent
        if not stream:
            return self._send_json(
                _generate_once(self.core, model_name, model_version, core_req))

        gen = self.core.infer_stream(model_name, model_version, core_req)

        # committed to a stream: chunked SSE, one event per response. The
        # 200 + event-stream headers go out BEFORE the first response is
        # computed; a failure after that becomes an in-band error event.
        # Once the headers are out nothing may escape to do_POST's handler
        # (its JSON error response would corrupt the chunked framing).
        def chunk(data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.flush()  # headers on the wire before next(gen) blocks
            item = None
            try:
                item = next(gen, None)
            except Exception as e:
                chunk(_sse_event({"error": str(e)}))
            while item is not None:
                chunk(_sse_event(_generate_event(item)))
                try:
                    item = next(gen, None)
                except Exception as e:
                    chunk(_sse_event({"error": str(e)}))
                    break
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            # client went away mid-stream: closing the generator below runs
            # the model's GeneratorExit path
            self.close_connection = True
        except Exception as e:
            # server-side failure after the headers: best-effort in-band
            # error, then drop the connection
            try:
                chunk(_sse_event({"error": str(e)}))
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                pass
            self.close_connection = True
        finally:
            gen.close()


class _TrackingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with an in-flight request counter, so a
    graceful close waits for outstanding requests instead of guessing."""

    # the stdlib's listen backlog of 5 resets bursts of concurrent connects
    request_queue_size = 128
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()

    def request_began(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()

    def request_ended(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        return self._idle.wait(timeout)


class HttpInferenceServer:
    """An in-process threaded v2 HTTP server bound to localhost.

    Usage::

        server = HttpInferenceServer(ServerCore(default_model_zoo())).start()
        client = InferenceServerClient(server.url)
        ...
        server.stop()         # immediate
        # or: server.close()  # graceful: drain ready, finish in-flight
    """

    def __init__(self, core: ServerCore, port: int = 0, verbose: bool = False):
        self.core = core
        handler = type("BoundHandler", (_Handler,), {"core": core})
        self._httpd = _TrackingHTTPServer(("127.0.0.1", port), handler)
        self._httpd.verbose = verbose
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "HttpInferenceServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="client_tpu_torch_http_server",
            daemon=True)
        self._thread.start()
        return self

    def drain(self, grace_s: float = 0.0) -> None:
        """Flip ``v2/health/ready`` to 503 (``core.ready = False``) and wait
        ``grace_s`` so pool ready-probes route away before the listener
        goes. Everything else keeps serving. ``core`` may be shared by
        several frontends: draining one drains them all."""
        self.core.ready = False
        if grace_s > 0:
            time.sleep(grace_s)

    def stop(self) -> None:
        """Immediate shutdown (in-flight requests may be cut); the graceful
        path is :meth:`close`."""
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd.server_close()

    def close(self, grace_s: float = 0.5) -> None:
        """Graceful shutdown: drain (ready -> 503), wait ``grace_s``, finish
        in-flight requests, then close the listener. While they finish,
        ``/metrics`` and the health routes still answer on fresh
        connections. SIGTERM handlers call this, not ``stop``."""
        self.drain(grace_s)
        self._httpd.wait_idle(timeout=10)
        self.stop()

    def __enter__(self) -> "HttpInferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
