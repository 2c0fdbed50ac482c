"""Byzantine fault server: a live v2 HTTP server that LIES.

The port of ``client_tpu.testing.byzantine`` over the port's
``HttpInferenceServer`` and ``ServerCore`` (whose ``infer`` returns one
response, not a list). A seeded plan corrupts the same bytes of the same
responses as the JAX server does.

The chaos proxy (:mod:`client_tpu_torch.testing.chaos`) breaks transport —
resets, stalls, blackholes — which the resilience layer already turns
into typed retryable faults. A byzantine replica is the opposite
failure: transport is perfectly healthy, health probes answer ready,
the breaker records successes — and the *payload* is wrong. This
module wraps the in-process HTTP server with a deterministic, seeded
corruption layer so the integrity subsystem (contract validation,
digests, quarantine) can be proven against live wire bytes instead of
hand-built mocks.

Fault vocabulary (``ByzantinePlan.kinds``):

- ``shape_lie``    — an output's JSON ``shape`` grows one element on its
  last axis while the payload stays put (size arithmetic and the cached
  metadata contract both catch it).
- ``dtype_lie``    — an output's ``datatype`` is swapped for a wider type
  (INT32→INT64 style: payload arithmetic catches it without metadata).
- ``truncate``     — the binary tail loses its final third (Content-Length
  is consistent with the SHORTENED body, so only the header-claim vs
  buffer-span check can notice).
- ``bit_flip``     — one seeded bit flips in the binary tail; every size
  and header claim stays consistent. Deliberately contract-UNdetectable:
  only a data-plane digest or a value check catches it (docs/integrity.md
  "detectability").
- ``wrong_id``     — the response echoes a request_id that is not yours.
- ``garbage_json`` — the JSON response header is replaced with invalid
  UTF-8 garbage (exercises the typed-error-not-UnicodeDecodeError path).
- ``dup_index``    — an SSE generate event is emitted twice with the same
  explicit ``index``.
- ``drop_index``   — an SSE generate event's ``index`` skips a value.

Determinism: one ``random.Random(seed)`` drives every choice (which
fault fires when ``kinds`` has several, which output entry is mutated,
which bit flips), and ``every``/``limit`` schedule which responses are
corrupted at all — so a bench replay with the same seed corrupts the
same responses the same way, run after run.

Usage::

    srv = ByzantineHttpServer(ServerCore(default_model_zoo()),
                              kinds=("shape_lie",), seed=7, every=1)
    srv.start()
    client = InferenceServerClient(srv.url)   # every response now lies
"""

from __future__ import annotations

import json
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..server.core import ServerCore
from ..server.http_server import (
    HttpInferenceServer,
    _generate_core_request,
    _generate_event,
    _Handler,
    _sse_event,
    _TrackingHTTPServer,
    encode_infer_response,
    infer_request_encoding_prefs,
    parse_infer_request,
)

__all__ = ["ByzantineHttpServer", "ByzantinePlan", "FAULT_KINDS"]

FAULT_KINDS = (
    "shape_lie", "dtype_lie", "truncate", "bit_flip",
    "wrong_id", "garbage_json", "dup_index", "drop_index",
)

# unary faults corrupt an encoded infer response; stream faults corrupt
# the SSE event sequence — a plan may mix both, each path draws only
# from the kinds it can express
_UNARY_KINDS = ("shape_lie", "dtype_lie", "truncate", "bit_flip",
                "wrong_id", "garbage_json")
_STREAM_KINDS = ("dup_index", "drop_index")

# dtype_lie swaps for a WIDER type so the size arithmetic disagrees
# without any cached metadata (a same-size swap like INT32→FP32 is only
# metadata-detectable; use note_metadata tests for that shape)
_DTYPE_LIES = {
    "INT8": "INT16", "INT16": "INT32", "INT32": "INT64",
    "UINT8": "UINT16", "UINT16": "UINT32", "UINT32": "UINT64",
    "FP16": "FP32", "BF16": "FP32", "FP32": "FP64", "BOOL": "INT16",
    "INT64": "INT32", "FP64": "FP32", "UINT64": "UINT32",
}


class ByzantinePlan:
    """Deterministic corruption schedule shared by a server's handlers.

    ``every``/``limit`` mirror the chaos :class:`~client_tpu_torch.testing.chaos.Fault`
    semantics: the ``every``-th response (1-based) is corrupted, at most
    ``limit`` times total (``None`` = unlimited). ``kinds`` restricts the
    vocabulary; with several kinds the seeded rng picks one per corrupted
    response."""

    def __init__(
        self,
        kinds: Sequence[str] = _UNARY_KINDS,
        seed: int = 0,
        every: int = 1,
        limit: Optional[int] = None,
    ):
        for kind in kinds:
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {FAULT_KINDS})")
        if every < 1:
            raise ValueError("every must be >= 1")
        self.kinds = tuple(kinds)
        self.seed = seed
        self.every = every
        self.limit = limit
        self._rng = random.Random(seed)
        self._responses = 0
        self._applied = 0
        self._lock = threading.Lock()
        # what actually fired, for bench provenance: [(response_index, kind)]
        self.log: List[Tuple[int, str]] = []

    def next_fault(self, pool: Sequence[str]) -> Optional[str]:
        """The fault for the next response, or None (honest). ``pool``
        narrows to the kinds the calling path can express."""
        with self._lock:
            self._responses += 1
            if self.limit is not None and self._applied >= self.limit:
                return None
            if self._responses % self.every != 0:
                return None
            candidates = [k for k in self.kinds if k in pool]
            if not candidates:
                return None
            self._applied += 1
            kind = self._rng.choice(candidates)
            self.log.append((self._responses, kind))
            return kind

    def rng(self) -> random.Random:
        return self._rng

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"responses": self._responses, "corrupted": self._applied}


def _corrupt_unary(
    kind: str, body: bytes, json_size: Optional[int], rng: random.Random,
) -> Tuple[bytes, Optional[int]]:
    """Apply one unary fault to an encoded (body, json_header_length)."""
    hdr_bytes = body[:json_size] if json_size is not None else body
    tail = body[json_size:] if json_size is not None else b""
    if kind == "garbage_json":
        # invalid JSON *and* invalid UTF-8: the client must raise a typed
        # error, not json.JSONDecodeError or UnicodeDecodeError
        garbage = b'{"model_name": \xff\xfe\x00 not json'
        size = len(garbage) if json_size is not None else None
        return garbage + tail, size
    header = json.loads(hdr_bytes)
    outs = [o for o in header.get("outputs", []) if "data" in o
            or "binary_data_size" in str(o.get("parameters", {}))
            or o.get("parameters", {}).get("binary_data_size") is not None]
    outs = outs or header.get("outputs", [])
    if kind == "wrong_id":
        header["id"] = (header.get("id") or "rq") + "-byz"
    elif kind == "shape_lie" and outs:
        entry = rng.choice(outs)
        shape = entry.get("shape") or [1]
        shape[-1] = int(shape[-1]) + 1
    elif kind == "dtype_lie" and outs:
        entry = rng.choice(outs)
        entry["datatype"] = _DTYPE_LIES.get(entry.get("datatype", ""),
                                            "INT64")
    new_hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if kind == "truncate":
        if tail:
            tail = tail[: len(tail) - max(1, len(tail) // 3)]
        elif len(new_hdr) > 4:
            new_hdr = new_hdr[:-4]  # JSON-only response: torn JSON
    elif kind == "bit_flip":
        if tail:
            buf = bytearray(tail)
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            tail = bytes(buf)
        else:
            # JSON data path: corrupt one value in place — every claim
            # stays consistent, only a value check can tell
            for entry in header.get("outputs", []):
                data = entry.get("data")
                if data:
                    idx = rng.randrange(len(data))
                    if isinstance(data[idx], (int, float)):
                        data[idx] = data[idx] + 1
                        break
            new_hdr = json.dumps(header, separators=(",", ":")).encode()
    size = len(new_hdr) if json_size is not None else None
    return new_hdr + tail, size


class _ByzantineHandler(_Handler):
    """The honest handler with a corruption step between encode and send."""

    plan: ByzantinePlan  # set by server factory

    def _do_infer(self, model_name: str, model_version: str, body: bytes):
        header_length = self.headers.get("Inference-Header-Content-Length")
        request = parse_infer_request(
            body, int(header_length) if header_length is not None else None)
        requested, binary_default = infer_request_encoding_prefs(request)
        response = self.core.infer(model_name, model_version, request)
        body_out, json_size = encode_infer_response(
            response, requested, binary_default)
        fault = self.plan.next_fault(_UNARY_KINDS)
        if fault is not None:
            body_out, json_size = _corrupt_unary(
                fault, body_out, json_size, self.plan.rng())
        headers = {"Content-Type": "application/json"}
        if json_size is not None:
            headers = {
                "Content-Type": "application/octet-stream",
                "Inference-Header-Content-Length": str(json_size),
            }
        self._send(200, body_out, headers)

    def _do_generate(self, model_name: str, model_version: str,
                     body: bytes, stream: bool):
        if not stream:
            return super()._do_generate(model_name, model_version, body,
                                        stream)
        # streamed: the honest SSE loop, but every event carries an
        # explicit monotone "index" (as real decoupled servers emit) so
        # dup_index/drop_index have something to corrupt
        payload = json.loads(body) if body else {}
        core_req = _generate_core_request(
            self.core.model(model_name, model_version), payload)
        gen = self.core.infer_stream(model_name, model_version, core_req)

        def chunk(data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.flush()
            index = 0
            for item in gen:
                event = _generate_event(item)
                # models that don't emit an index tensor themselves get a
                # monotone one injected (as real decoupled servers emit),
                # so the faults below always have an index to corrupt
                if not any(k in event
                           for k in ("INDEX", "index", "sequence_index")):
                    event["index"] = index
                index += 1
                fault = self.plan.next_fault(_STREAM_KINDS)
                if fault == "drop_index":
                    continue  # event swallowed whole: a gap on the wire
                chunk(_sse_event(event))
                if fault == "dup_index":
                    chunk(_sse_event(dict(event)))  # delivered twice
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            self.close_connection = True
        except Exception as e:
            try:
                chunk(_sse_event({"error": str(e)}))
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                pass
            self.close_connection = True
        finally:
            gen.close()


class ByzantineHttpServer(HttpInferenceServer):
    """An in-process v2 HTTP server whose responses are corrupted per a
    seeded :class:`ByzantinePlan`. Drop-in replacement for
    :class:`~client_tpu_torch.server.http_server.HttpInferenceServer` — same
    ``url``/``start``/``stop``/``close`` surface, so a pool test points
    one replica of three here and the other two at honest servers."""

    def __init__(
        self,
        core: ServerCore,
        plan: Optional[ByzantinePlan] = None,
        port: int = 0,
        verbose: bool = False,
        **plan_kwargs: Any,
    ):
        self.core = core
        self.plan = plan if plan is not None else ByzantinePlan(**plan_kwargs)
        handler = type(
            "BoundByzantineHandler", (_ByzantineHandler,),
            {"core": core, "plan": self.plan})
        self._httpd = _TrackingHTTPServer(("127.0.0.1", port), handler)
        self._httpd.verbose = verbose
        self._httpd.daemon_threads = True
        self._thread = None
