"""GRPC frontend for ServerCore: ``inference.GRPCInferenceService``.

The counterpart of ``client_tpu.server.grpc_server``: the v2 rpcs (health,
metadata, config, infer, the bidi ``ModelStreamInfer`` with sequences and
decoupled models, repository, statistics, trace and log settings, system
and cuda shared memory) through generic method handlers bound to the
schema-driven wire codec. The Tpu shared-memory rpc pair answers
UNIMPLEMENTED, as the port's HTTP server answers 404 for the tpu routes.

Handler threads set the core's device as current before their first
request, so kernels launched from them run on that device.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import Any, Dict, List, Optional

import grpc
import numpy as np

from ..grpc import _messages as M
from ..grpc._infer import _CONTENTS_FIELD, from_infer_parameter, to_infer_parameter
from ..grpc._wire import decode_message, encode_message
from ..utils import triton_to_np_dtype
from .core import (
    InferError,
    ServerCore,
    _array_to_bytes,
    _bytes_to_array,
    bind_device,
    handler_device,
)

_STATUS_OF_HTTP = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    404: grpc.StatusCode.NOT_FOUND,
    499: grpc.StatusCode.CANCELLED,
    500: grpc.StatusCode.INTERNAL,
    503: grpc.StatusCode.UNAVAILABLE,
}

_CONFIG_TYPE_OF_TRITON = {name: i for i, name in enumerate(M.CONFIG_DATATYPE_NAMES)}


def _shm_of(params: Dict[str, Any]):
    return (
        params["shared_memory_region"],
        params.get("shared_memory_byte_size", 0),
        params.get("shared_memory_offset", 0),
    )


def _to_core_request(decoded: Dict[str, Any]) -> Dict[str, Any]:
    """ModelInferRequest dict -> the neutral ServerCore request shape."""
    params = {
        k: from_infer_parameter(v) for k, v in decoded.get("parameters", {}).items()
    }
    request: Dict[str, Any] = {
        "id": decoded.get("id", ""),
        "parameters": params,
        "inputs": [],
    }
    raw = decoded.get("raw_input_contents", [])
    raw_idx = 0
    for t in decoded.get("inputs", []):
        tp = {k: from_infer_parameter(v) for k, v in t.get("parameters", {}).items()}
        entry: Dict[str, Any] = {
            "name": t.get("name", ""),
            "datatype": t.get("datatype", ""),
            "shape": t.get("shape", []),
        }
        if "shared_memory_region" in tp:
            entry["shm"] = _shm_of(tp)
        elif t.get("contents"):
            field = _CONTENTS_FIELD.get(entry["datatype"])
            data = t["contents"].get(field, []) if field else []
            if entry["datatype"] == "BYTES":
                arr = np.array(data, dtype=np.object_).reshape(entry["shape"])
            else:
                arr = np.array(
                    data, dtype=triton_to_np_dtype(entry["datatype"])
                ).reshape(entry["shape"])
            entry["array"] = arr
        else:
            if raw_idx >= len(raw):
                raise InferError(
                    f"input '{entry['name']}' has no data (raw_input_contents "
                    f"has {len(raw)} entries)", 400,
                )
            # a bytearray gives a writable array, which torch takes as is
            entry["array"] = _bytes_to_array(
                bytearray(raw[raw_idx]), entry["datatype"], entry["shape"])
            raw_idx += 1
        request["inputs"].append(entry)

    outputs = []
    for o in decoded.get("outputs", []):
        op = {k: from_infer_parameter(v) for k, v in o.get("parameters", {}).items()}
        spec: Dict[str, Any] = {
            "name": o.get("name", ""),
            "binary": True,
            "classification": op.get("classification", 0),
        }
        if "shared_memory_region" in op:
            spec["shm"] = _shm_of(op)
        outputs.append(spec)
    if outputs:
        request["outputs"] = outputs
    return request


def _encode_core_response(resp: Dict[str, Any], final: Optional[bool] = None) -> Dict[str, Any]:
    """Neutral core response -> ModelInferResponse dict."""
    out: Dict[str, Any] = {
        "model_name": resp.get("model_name", ""),
        "model_version": resp.get("model_version", ""),
    }
    if resp.get("id"):
        out["id"] = resp["id"]
    params = {k: to_infer_parameter(v) for k, v in (resp.get("parameters") or {}).items()}
    if final is not None:
        params["triton_final_response"] = {"bool_param": final}
    if params:
        out["parameters"] = params
    outputs = []
    raws: List[bytes] = []
    for o in resp.get("outputs", []):
        entry: Dict[str, Any] = {
            "name": o["name"],
            "datatype": o["datatype"],
            "shape": list(o["shape"]),
        }
        if "shm" in o:
            region, byte_size, offset = o["shm"]
            p = {
                "shared_memory_region": to_infer_parameter(region),
                "shared_memory_byte_size": to_infer_parameter(int(byte_size)),
            }
            if offset:
                p["shared_memory_offset"] = to_infer_parameter(int(offset))
            entry["parameters"] = p
        else:
            raws.append(_array_to_bytes(np.asarray(o["array"]), o["datatype"]))
        outputs.append(entry)
    out["outputs"] = outputs
    if raws:
        out["raw_output_contents"] = raws
    return out


def _status_of(e: Exception):
    if isinstance(e, InferError):
        return _STATUS_OF_HTTP.get(e.status, grpc.StatusCode.INVALID_ARGUMENT)
    return grpc.StatusCode.INTERNAL


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class _Handlers(grpc.GenericRpcHandler):
    def __init__(self, core: ServerCore):
        self._core = core

    # -- routing -----------------------------------------------------------
    def service(self, handler_call_details):
        method = handler_call_details.method.rsplit("/", 1)[-1]
        specs = M.METHODS.get(method)
        if specs is None:
            return None
        req_spec, resp_spec = specs
        deserializer = lambda b: decode_message(req_spec, b)  # noqa: E731
        serializer = lambda d: encode_message(resp_spec, d)  # noqa: E731
        if method == "ModelStreamInfer":
            return grpc.stream_stream_rpc_method_handler(
                self._model_stream_infer,
                request_deserializer=deserializer,
                response_serializer=serializer,
            )
        # no handler (the Tpu rpcs): grpc answers UNIMPLEMENTED
        fn = getattr(self, f"_{_snake(method)}", None)
        if fn is None:
            return None
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=deserializer, response_serializer=serializer
        )

    @staticmethod
    def _abort(context, e: Exception):
        context.abort(_status_of(e), str(e))

    # -- health / metadata ---------------------------------------------------
    def _server_live(self, request, context):
        return {"live": bool(self._core.live)}

    def _server_ready(self, request, context):
        # drainable: drain()/close() flip core.ready
        return {"ready": bool(self._core.live and self._core.ready)}

    def _model_ready(self, request, context):
        return {"ready": self._core.model_ready(request.get("name", ""),
                                                request.get("version", ""))}

    def _server_metadata(self, request, context):
        return self._core.server_metadata()

    def _model_metadata(self, request, context):
        try:
            return self._core.model(request.get("name", ""),
                                    request.get("version", "")).metadata()
        except InferError as e:
            self._abort(context, e)

    def _model_config(self, request, context):
        try:
            cfg = self._core.model(request.get("name", ""),
                                   request.get("version", "")).config()
        except InferError as e:
            self._abort(context, e)
        # JSON-config -> proto-config field shapes

        def tensors(key):
            return [
                {
                    "name": t["name"],
                    "data_type": _CONFIG_TYPE_OF_TRITON.get(t["data_type"], 0),
                    "dims": t["dims"],
                }
                for t in cfg.get(key, [])
            ]

        config = {
            "name": cfg["name"],
            "platform": cfg.get("platform", ""),
            "backend": cfg.get("backend", ""),
            "max_batch_size": cfg.get("max_batch_size", 0),
            "input": tensors("input"),
            "output": tensors("output"),
            "model_transaction_policy": {
                "decoupled": cfg.get("model_transaction_policy", {}).get("decoupled", False)
            },
        }
        return {"config": config}

    # -- inference -----------------------------------------------------------
    @staticmethod
    def _metadata_value(context, wanted: str) -> Optional[str]:
        """One invocation-metadata value (the GRPC twin of an HTTP request
        header), or None when the client did not send it."""
        for key, value in (context.invocation_metadata() or ()):
            if key == wanted:
                return value
        return None

    def _model_infer(self, request, context):
        try:
            core_req = _to_core_request(request)
            traceparent = self._metadata_value(context, "traceparent")
            if traceparent:
                core_req["traceparent"] = traceparent
            model_name = request.get("model_name", "")
            response = self._core.infer(model_name, request.get("model_version", ""), core_req)
            orca_format = self._metadata_value(context, "endpoint-load-metrics-format")
            if orca_format in ("json", "text"):
                # ORCA per-response load metrics ride the trailing metadata
                # on GRPC (the header transport HTTP has)
                context.set_trailing_metadata((
                    ("endpoint-load-metrics", self._core.orca_report(orca_format, model_name)),
                ))
            return _encode_core_response(response)
        except InferError as e:
            self._abort(context, e)

    def _model_stream_infer(self, request_iterator, context):
        # triton_grpc_error mode: when the client sets this metadata key,
        # stream errors end the stream with a true grpc status instead of
        # an in-band message
        grpc_error_mode = any(
            key == "triton_grpc_error" and str(value).lower() == "true"
            for key, value in (context.invocation_metadata() or ())
        )
        traceparent = self._metadata_value(context, "traceparent")
        for request in request_iterator:
            model_name = request.get("model_name", "")
            model_version = request.get("model_version", "")
            try:
                core_req = _to_core_request(request)
                if traceparent:
                    # stream-level metadata: every request on the stream
                    # joins the same client trace id
                    core_req["traceparent"] = traceparent
                want_final = bool(
                    core_req["parameters"].get("triton_enable_empty_final_response"))
                model = self._core.model(model_name, model_version)
                # each decoupled response reaches the wire as the model
                # yields it
                stream = self._core.infer_stream(model_name, model_version, core_req)
                try:
                    for resp in stream:
                        # with the empty-final opt-in every response carries
                        # an explicit triton_final_response
                        final = (not model.decoupled) if want_final else None
                        yield {"infer_response": _encode_core_response(resp, final=final)}
                finally:
                    # a client cancel closes this generator at the yield;
                    # close the core stream now so its cancel is recorded
                    stream.close()
                if want_final and model.decoupled:
                    empty: Dict[str, Any] = {
                        "model_name": model_name,
                        "model_version": model_version or model.versions[-1],
                        "outputs": [],
                    }
                    if request.get("id"):
                        empty["id"] = request["id"]
                    yield {"infer_response": _encode_core_response(empty, final=True)}
            except Exception as e:
                if grpc_error_mode:
                    context.abort(_status_of(e), str(e))
                # in-band (default); the request id rides in the otherwise
                # empty infer_response so clients can attribute the error
                out: Dict[str, Any] = {"error_message": str(e)}
                if request.get("id"):
                    out["infer_response"] = {"id": request["id"]}
                yield out

    # -- repository ----------------------------------------------------------
    def _repository_index(self, request, context):
        return {"models": self._core.repository_index()}

    def _repository_model_load(self, request, context):
        try:
            config = request.get("parameters", {}).get("config", {}).get("string_param")
            self._core.load_model(request.get("model_name", ""), config=config)
        except InferError as e:
            self._abort(context, e)
        return {}

    def _repository_model_unload(self, request, context):
        try:
            self._core.unload_model(request.get("model_name", ""))
        except InferError as e:
            self._abort(context, e)
        return {}

    # -- statistics / trace / log ---------------------------------------------
    def _model_statistics(self, request, context):
        try:
            return self._core.statistics(request.get("name", ""), request.get("version", ""))
        except InferError as e:
            self._abort(context, e)

    def _trace_setting(self, request, context):
        settings = self._core.trace_settings
        for key, value in request.get("settings", {}).items():
            settings[key] = value.get("value", [])
        return {"settings": {
            key: {"value": value if isinstance(value, list) else [str(value)]}
            for key, value in settings.items()}}

    def _log_settings(self, request, context):
        settings = self._core.log_settings
        for key, value in request.get("settings", {}).items():
            settings[key] = from_infer_parameter(value)
        out = {}
        for key, value in settings.items():
            if isinstance(value, bool):
                out[key] = {"bool_param": value}
            elif isinstance(value, int):
                out[key] = {"uint32_param": value}
            else:
                out[key] = {"string_param": str(value)}
        return {"settings": out}

    # -- shared memory --------------------------------------------------------
    def _status(self, family, request):
        regions = self._core.region_status(family, request.get("name", ""))
        return {"regions": {r["name"]: r for r in regions}}

    def _unregister(self, family, request):
        name = request.get("name", "")
        self._core.unregister_region(name, None if name else family)
        return {}

    def _system_shared_memory_status(self, request, context):
        return self._status("system", request)

    def _system_shared_memory_register(self, request, context):
        try:
            self._core.register_system_region(
                request.get("name", ""),
                request.get("key", ""),
                request.get("offset", 0),
                request.get("byte_size", 0),
            )
        except InferError as e:
            self._abort(context, e)
        return {}

    def _system_shared_memory_unregister(self, request, context):
        return self._unregister("system", request)

    def _cuda_shared_memory_status(self, request, context):
        return self._status("cuda", request)

    def _cuda_shared_memory_register(self, request, context):
        try:
            raw = request.get("raw_handle", b"")
            self._core.register_cuda_region(
                request.get("name", ""),
                raw.decode("ascii") if isinstance(raw, bytes) else raw,
                request.get("device_id", 0),
                request.get("byte_size", 0),
            )
        except InferError as e:
            self._abort(context, e)
        return {}

    def _cuda_shared_memory_unregister(self, request, context):
        return self._unregister("cuda", request)


class GrpcInferenceServer:
    """An in-process v2 GRPC server bound to localhost.

    Usage::

        server = GrpcInferenceServer(ServerCore(default_model_zoo())).start()
        client = client_tpu_torch.grpc.InferenceServerClient(server.url)
        ...
        server.stop()         # immediate
        # or: server.close()  # graceful: drain ready, finish in-flight
    """

    def __init__(self, core: ServerCore, port: int = 0, max_workers: int = 8,
                 verbose: bool = False, compression=None, credentials=None):
        """``max_workers``: the handler threads; a bidi stream holds one for
        its life. ``verbose`` is accepted for parity with the JAX server and
        unused there too. ``compression``: a ``grpc.Compression`` (e.g.
        ``Gzip``) for the responses to clients that advertise it.
        ``credentials``: a ``grpc.ServerCredentials`` to serve TLS instead
        of cleartext h2c."""
        self.core = core
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="client_tpu_torch_grpc_server",
                initializer=bind_device, initargs=(handler_device(core),),
            ),
            options=[
                ("grpc.max_send_message_length", 2**31 - 1),
                ("grpc.max_receive_message_length", 2**31 - 1),
            ],
            compression=compression,
        )
        self._server.add_generic_rpc_handlers((_Handlers(core),))
        if credentials is not None:
            self._port = self._server.add_secure_port(f"127.0.0.1:{port}", credentials)
        else:
            self._port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"127.0.0.1:{self._port}"

    def start(self) -> "GrpcInferenceServer":
        self._server.start()
        return self

    def drain(self, grace_s: float = 0.0) -> None:
        """Flip ``ServerReady`` to false and wait ``grace_s`` so pool
        ready-probes route away before the port closes; everything keeps
        serving through the window. ``core`` may be shared by several
        frontends: draining one drains them all."""
        self.core.ready = False
        if grace_s > 0:
            time.sleep(grace_s)

    def stop(self, grace: Optional[float] = 1.0) -> None:
        self._server.stop(grace).wait()

    def close(self, grace_s: float = 0.5) -> None:
        """Graceful shutdown: drain, wait ``grace_s``, let in-flight RPCs
        finish (grpc's own stop grace), then release the port. SIGTERM
        handlers call this, not ``stop``."""
        self.drain(grace_s)
        self.stop(grace=10.0)

    def __enter__(self) -> "GrpcInferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
