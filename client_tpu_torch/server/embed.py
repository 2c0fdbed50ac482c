"""In-process embedding entry points for non-Python hosts.

The counterpart of ``client_tpu.server.embed``. The port's C shim
(``client_tpu_torch/csrc/server_embed.cc``, built by
:mod:`client_tpu_torch.native_build`) implements the C API of
``native/include/client_tpu/server_embed.h``: it embeds CPython, imports
this module and calls these functions, so a C/C++/Java process hosts the
port's ServerCore, and its models run on the card, inside itself.

Contract choices keep the FFI surface flat and stable:
- requests/responses cross the boundary as the KServe v2 HTTP body format
  (JSON header + binary tails + header-length), reusing the exact
  marshaling both the HTTP frontend and every client already speak;
- admin surfaces cross as JSON strings;
- handles are opaque integers (an index into a process-global table) so
  the C side never touches Python object lifetimes.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Tuple

from .core import ServerCore

_cores: Dict[int, dict] = {}
_next_handle = 1
_lock = threading.Lock()


def create(options_json: str = "") -> int:
    """Create a ServerCore; returns an opaque handle.

    ``options_json``: ``{"models": ["simple", ...], "device": "cuda"}``
    selects models from the default zoo by name (empty/absent loads the
    full zoo) and places them on ``device`` (default ``"cuda"``).
    """
    from ..models import default_model_zoo

    global _next_handle
    opts = json.loads(options_json) if options_json.strip() else {}
    device = opts.get("device", "cuda")
    zoo = default_model_zoo(device)
    wanted = opts.get("models")
    if wanted is not None:
        by_name = {m.name: m for m in zoo}
        missing = [n for n in wanted if n not in by_name]
        if missing:
            raise ValueError(f"unknown models: {missing} "
                             f"(zoo: {sorted(by_name)})")
        zoo = [by_name[n] for n in wanted]
    core = ServerCore(zoo, device=device)
    with _lock:
        handle = _next_handle
        _next_handle += 1
        _cores[handle] = {"core": core, "http": None}
    return handle


def _entry(handle: int) -> dict:
    entry = _cores.get(handle)
    if entry is None:
        raise ValueError(f"invalid server handle {handle}")
    return entry


def infer(handle: int, model_name: str, model_version: str,
          body: bytes, header_length: int) -> Tuple[bytes, int]:
    """One inference round trip in the v2 two-part body format.

    ``header_length`` < 0 means the body is pure JSON. Returns
    ``(response_body, response_header_length)`` with header_length -1 when
    the response is pure JSON.
    """
    from .http_server import (
        encode_infer_response,
        infer_request_encoding_prefs,
        parse_infer_request,
    )

    core = _entry(handle)["core"]
    request = parse_infer_request(
        bytes(body), header_length if header_length >= 0 else None)
    requested, binary_default = infer_request_encoding_prefs(request)
    # the port's core returns the one response of a model that is not
    # decoupled (and refuses a decoupled one here)
    response = core.infer(model_name, model_version, request)
    out, json_size = encode_infer_response(response, requested, binary_default)
    return out, -1 if json_size is None else json_size


def metadata_json(handle: int, model_name: str = "") -> bytes:
    core = _entry(handle)["core"]
    # same documents the HTTP frontend serves (http_server.py GET routes)
    doc = (core.model(model_name).metadata() if model_name
           else core.server_metadata())
    return json.dumps(doc).encode()


def repository_index_json(handle: int) -> bytes:
    return json.dumps(_entry(handle)["core"].repository_index()).encode()


def statistics_json(handle: int, model_name: str = "") -> bytes:
    return json.dumps(_entry(handle)["core"].statistics(model_name)).encode()


def load_model(handle: int, model_name: str, config_json: str = "") -> None:
    _entry(handle)["core"].load_model(model_name, config_json or None)


def unload_model(handle: int, model_name: str) -> None:
    _entry(handle)["core"].unload_model(model_name)


def start_http(handle: int, port: int = 0) -> int:
    """Expose the embedded core over the network too; returns the port."""
    from .http_server import HttpInferenceServer

    entry = _entry(handle)
    if entry["http"] is None:
        entry["http"] = HttpInferenceServer(entry["core"], port=port).start()
    return entry["http"].port


def destroy(handle: int) -> None:
    with _lock:
        entry = _cores.pop(handle, None)
    if entry and entry["http"] is not None:
        entry["http"].stop()


def _selftest() -> str:
    """Exercised by the embed host before real traffic."""
    return "ok"


__all__ = ["create", "destroy", "infer", "load_model", "metadata_json",
           "repository_index_json", "start_http", "statistics_json", "unload_model"]
