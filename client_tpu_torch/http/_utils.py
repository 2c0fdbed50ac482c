"""KServe v2 HTTP/REST request bodies and response helpers.

The counterpart of ``client_tpu.http._utils``. Wire contract (identical to
the reference and to the JAX package, so bodies interoperate with a real
tritonserver and with ``client_tpu``'s server):

- Request body = UTF-8 JSON header, then the raw binary payloads of every
  input that staged binary data, concatenated in input order. When any binary
  payload is present the ``Inference-Header-Content-Length`` request header
  carries the JSON byte length.
- Response body = JSON header (+ binary tail located by the response's
  ``Inference-Header-Content-Length``), each binary output described by a
  ``binary_data_size`` parameter; outputs appear in the tail in order.
"""

from __future__ import annotations

import gzip
import json
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .._tensor import InferInput, InferRequestedOutput
from ..utils import RESERVED_REQUEST_PARAMETERS, InferenceServerException


def build_request_parameters(
    request_id: str = "",
    sequence_id: int = 0,
    sequence_start: bool = False,
    sequence_end: bool = False,
    priority: int = 0,
    timeout: Optional[int] = None,
    parameters: Optional[Dict[str, Any]] = None,
) -> Tuple[Optional[str], Dict[str, Any]]:
    """Validate custom parameters and assemble the request-level parameter bag."""
    out: Dict[str, Any] = {}
    if sequence_id:
        out["sequence_id"] = sequence_id
        out["sequence_start"] = sequence_start
        out["sequence_end"] = sequence_end
    if priority:
        out["priority"] = priority
    if timeout is not None:
        out["timeout"] = timeout
    if parameters:
        for key, value in parameters.items():
            if key in RESERVED_REQUEST_PARAMETERS:
                raise InferenceServerException(
                    f"parameter '{key}' is a reserved parameter and cannot be "
                    "specified as a custom parameter"
                )
            out[key] = value
    return (request_id if request_id else None), out


def build_infer_body(
    inputs: Sequence[InferInput],
    outputs: Optional[Sequence[InferRequestedOutput]] = None,
    request_id: str = "",
    sequence_id: int = 0,
    sequence_start: bool = False,
    sequence_end: bool = False,
    priority: int = 0,
    timeout: Optional[int] = None,
    parameters: Optional[Dict[str, Any]] = None,
) -> Tuple[bytes, Optional[int]]:
    """Build the two-part infer body.

    Returns ``(body, json_size)``; ``json_size`` is None when the body is pure
    JSON (no binary tensor payloads).
    """
    rid, params = build_request_parameters(
        request_id, sequence_id, sequence_start, sequence_end, priority, timeout, parameters
    )
    header: Dict[str, Any] = {}
    if rid is not None:
        header["id"] = rid

    if outputs:
        header["outputs"] = [o._get_tensor_json() for o in outputs]
    else:
        # No explicit outputs: ask the server to return everything as binary.
        params["binary_data_output"] = True

    if params:
        header["parameters"] = params

    header["inputs"] = [i._get_tensor_json() for i in inputs]

    json_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    chunks: List[bytes] = [json_bytes]
    has_binary = False
    for i in inputs:
        raw = i._get_binary_data()
        if raw is not None:
            has_binary = True
            chunks.append(raw if isinstance(raw, bytes) else bytes(raw))
    if not has_binary:
        return json_bytes, None
    return b"".join(chunks), len(json_bytes)


def compress_body(body: bytes, algorithm: Optional[str]) -> Tuple[bytes, Optional[str]]:
    """Compress a request body; returns (body, Content-Encoding header value)."""
    if algorithm is None or algorithm == "none":
        return body, None
    if algorithm == "gzip":
        return gzip.compress(body), "gzip"
    if algorithm == "deflate":
        return zlib.compress(body), "deflate"
    raise InferenceServerException(f"unsupported compression algorithm '{algorithm}'")


def decompress_body(body: bytes, content_encoding: Optional[str]) -> bytes:
    if not content_encoding or content_encoding == "identity":
        return body
    if content_encoding == "gzip":
        return gzip.decompress(body)
    if content_encoding == "deflate":
        return zlib.decompress(body)
    raise InferenceServerException(
        f"unsupported response Content-Encoding '{content_encoding}'"
    )


def raise_if_error(status: int, body: bytes) -> None:
    """Raise InferenceServerException for HTTP error statuses.

    The server reports errors as ``{"error": msg}``; tolerate non-JSON bodies.
    """
    if status < 400:
        return
    msg = None
    try:
        parsed = json.loads(body)
        if isinstance(parsed, dict):
            msg = parsed.get("error")
    except Exception:
        pass
    if msg is None:
        msg = body.decode("utf-8", errors="replace") if body else f"HTTP {status}"
    raise InferenceServerException(msg=msg, status=str(status))


class SSEDecoder:
    """Incremental SSE event-stream decoder shared by the sync and aio
    generate_stream clients (so framing behavior cannot drift between them).

    Spec-compliant framing: events end at a blank line under LF *or* CRLF
    framing (``\\r?\\n\\r?\\n``), and multiple ``data:`` lines within one
    event are joined with ``\\n`` per the SSE spec before parsing. Events
    are size-unbounded (the buffer grows to the event) — large streamed
    tensors must not hit a line-length ceiling. ``feed`` returns the
    ``data`` payload of each event completed by the chunk; ``flush``
    drains a final event whose terminating blank line never arrived
    (server closed after a partial flush).
    """

    __slots__ = ("_buf", "_scan")

    def __init__(self):
        self._buf = b""
        self._scan = 0  # resume boundary search here (avoid re-scanning)

    @staticmethod
    def _event_payload(raw: bytes) -> Optional[bytes]:
        datas = []
        for line in raw.split(b"\n"):
            line = line.rstrip(b"\r")
            if line.startswith(b"data:"):
                value = line[len(b"data:"):]
                if value.startswith(b" "):  # spec: strip ONE leading space
                    value = value[1:]
                datas.append(value.strip())
        if not datas:
            return None
        return b"\n".join(datas)

    def feed(self, chunk: bytes) -> List[bytes]:
        self._buf += chunk
        payloads: List[bytes] = []
        while True:
            # find the earliest \n\n / \r\n\r\n / \n\r\n / \r\n\n boundary
            i = self._buf.find(b"\n", self._scan)
            boundary = None
            while i != -1:
                rest = self._buf[i + 1:i + 3]
                if rest.startswith(b"\n"):
                    boundary = (i, i + 2)
                    break
                if rest.startswith(b"\r\n"):
                    boundary = (i, i + 3)
                    break
                if rest in (b"", b"\r"):
                    # possible boundary split across chunks: wait for more
                    break
                i = self._buf.find(b"\n", i + 1)
            if boundary is None:
                # nothing conclusive: resume next feed just before the tail
                # (a boundary can span at most 3 trailing bytes)
                self._scan = max(0, len(self._buf) - 3)
                return payloads
            end, nxt = boundary
            raw, self._buf = self._buf[:end], self._buf[nxt:]
            self._scan = 0
            payload = self._event_payload(raw)
            if payload is not None:
                payloads.append(payload)

    def flush(self) -> List[bytes]:
        """Parse a final unterminated event; must not silently drop it."""
        raw, self._buf, self._scan = self._buf, b"", 0
        payload = self._event_payload(raw)
        return [payload] if payload is not None else []


def parse_sse_event(payload: bytes):
    """Decode one generate-extension SSE ``data:`` payload.

    Shared by the sync and aio clients so hostile-input handling cannot
    drift between them: non-JSON and JSON-but-not-an-object payloads raise
    the typed client exception, and an in-band ``{"error": msg}`` event
    raises with the server's message.
    """
    try:
        event = json.loads(payload)
    except ValueError as e:
        raise InferenceServerException(
            f"malformed generate_stream event: {payload[:120]!r}") from e
    if not isinstance(event, dict):
        raise InferenceServerException(
            f"malformed generate_stream event (not an object): "
            f"{payload[:120]!r}")
    if set(event) == {"error"}:
        raise InferenceServerException(event["error"])
    return event
