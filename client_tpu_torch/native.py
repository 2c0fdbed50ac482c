"""ctypes binding to the native C++ clients (``native/``), built from source.

The counterpart of ``client_tpu.native``. The library is the flat C API of
``native/src/c_api.cc`` over the C++ HTTP and gRPC clients, plus the port's
``csrc/native_cuda_shm.cc``, which adds the cuda registration the port's
servers need (they serve the system and cuda shared-memory routes). It is
built by :mod:`client_tpu_torch.native_build` into ``build/torch_native/``
at the first :func:`load` (``g++``, no ``cmake``), never at import.

``load()`` returns the bound library or raises where it cannot be built
(the error names the missing header or library); ``available()`` probes
quietly. :class:`NativeCudaShmRegion` is a POSIX host window made by the C
library (``ctpu_shm_create``); its raw handle is read by
``client_tpu_torch.utils.cuda_shared_memory.attach_from_raw_handle``, so a
server of the port places what the window holds on its device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .utils import InferenceServerException, np_to_triton_dtype

# (user, InferResult*, error message or NULL) from the native stream reader
STREAM_CALLBACK = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p
)

# (user, InferResult*) from the native async completion-queue worker;
# failures arrive as a result whose ctpu_result_status is non-NULL
ASYNC_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)

_lib = None
_load_lock = threading.Lock()


def _bind(lib):
    lib.ctpu_last_error.restype = ctypes.c_char_p
    lib.ctpu_torch_last_error.restype = ctypes.c_char_p
    lib.ctpu_client_create.restype = ctypes.c_void_p
    lib.ctpu_client_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ctpu_client_create_ssl.restype = ctypes.c_void_p
    lib.ctpu_client_create_ssl.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.ctpu_client_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_server_live.argtypes = [ctypes.c_void_p]
    lib.ctpu_model_ready.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctpu_infer_raw.restype = ctypes.c_longlong
    lib.ctpu_infer_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_ulonglong,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_ulonglong,
    ]
    lib.ctpu_shm_create.restype = ctypes.c_void_p
    lib.ctpu_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong, ctypes.c_int]
    lib.ctpu_shm_attach.restype = ctypes.c_void_p
    lib.ctpu_shm_attach.argtypes = [ctypes.c_char_p]
    lib.ctpu_shm_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_shm_raw_handle.restype = ctypes.c_char_p
    lib.ctpu_shm_raw_handle.argtypes = [ctypes.c_void_p]
    lib.ctpu_shm_write.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong
    ]
    lib.ctpu_shm_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong
    ]
    lib.ctpu_register_system_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_ulonglong,
        ctypes.c_ulonglong,
    ]
    for name in ("ctpu_torch_register_cuda_shm", "ctpu_torch_grpc_register_cuda_shm"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_ulonglong,
        ]
    lib.ctpu_unregister_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    # full value-model surface
    lib.ctpu_input_create.restype = ctypes.c_void_p
    lib.ctpu_input_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int,
    ]
    lib.ctpu_input_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_input_append_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong
    ]
    lib.ctpu_input_set_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_ulonglong, ctypes.c_ulonglong
    ]
    lib.ctpu_output_create.restype = ctypes.c_void_p
    lib.ctpu_output_create.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong]
    lib.ctpu_output_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_output_set_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_ulonglong, ctypes.c_ulonglong
    ]
    lib.ctpu_options_create.restype = ctypes.c_void_p
    lib.ctpu_options_create.argtypes = [ctypes.c_char_p]
    lib.ctpu_options_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_options_set_request_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctpu_options_set_sequence.argtypes = [
        ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int
    ]
    lib.ctpu_options_set_timeouts.argtypes = [
        ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong
    ]
    lib.ctpu_infer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ctpu_result_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_result_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_ulonglong),
    ]
    lib.ctpu_result_shape.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int,
    ]
    lib.ctpu_result_shape.restype = ctypes.c_int
    lib.ctpu_result_datatype.restype = ctypes.c_char_p
    lib.ctpu_result_datatype.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctpu_result_output_name.restype = ctypes.c_char_p
    lib.ctpu_result_output_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ctpu_result_output_names.restype = ctypes.c_char_p
    lib.ctpu_result_output_names.argtypes = [ctypes.c_void_p]
    lib.ctpu_result_status.restype = ctypes.c_char_p
    lib.ctpu_result_status.argtypes = [ctypes.c_void_p]
    lib.ctpu_grpc_async_infer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ASYNC_CALLBACK, ctypes.c_void_p,
    ]
    lib.ctpu_grpc_set_async_concurrency.argtypes = [
        ctypes.c_void_p, ctypes.c_int
    ]
    lib.ctpu_grpc_set_compression.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    # grpc client (same value-model handles; results use ctpu_result_*)
    lib.ctpu_grpc_client_create.restype = ctypes.c_void_p
    lib.ctpu_grpc_client_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ctpu_grpc_client_create_ssl.restype = ctypes.c_void_p
    lib.ctpu_grpc_client_create_ssl.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.ctpu_grpc_client_destroy.argtypes = [ctypes.c_void_p]
    lib.ctpu_grpc_server_live.argtypes = [ctypes.c_void_p]
    lib.ctpu_grpc_model_ready.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctpu_grpc_infer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ctpu_grpc_register_system_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_ulonglong,
        ctypes.c_ulonglong,
    ]
    lib.ctpu_grpc_unregister_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    lib.ctpu_grpc_start_stream.argtypes = [
        ctypes.c_void_p, STREAM_CALLBACK, ctypes.c_void_p
    ]
    lib.ctpu_grpc_stream_infer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
    ]
    lib.ctpu_grpc_stop_stream.argtypes = [ctypes.c_void_p]
    lib.ctpu_set_header.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    lib.ctpu_grpc_set_header.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    return lib


def load():
    """Build (at first use) and load the native library, cached; raises
    InferenceServerException where it cannot be built."""
    global _lib
    with _load_lock:
        if _lib is None:
            from . import native_build

            try:
                path = native_build.build_http()["path"]
            except native_build.NativeBuildError as e:
                raise InferenceServerException(f"native library unavailable: {e}") from e
            _lib = _bind(ctypes.CDLL(path))
        return _lib


def available() -> bool:
    try:
        load()
        return True
    except InferenceServerException:
        return False


def _err(lib) -> str:
    return lib.ctpu_last_error().decode("utf-8", errors="replace")


def _decode_result(lib, result_ptr, names=None):
    """{output: np.ndarray} from a ctpu result handle.

    ``names=None`` enumerates every output the server returned. Raises
    InferenceServerException on accessor failures (both the blocking and
    streaming paths share these semantics).
    """
    from .utils import deserialize_bytes_tensor, triton_to_np_dtype

    decoded = {}
    if names is None:
        joined = lib.ctpu_result_output_names(result_ptr)
        names = [n for n in (joined.decode().split("\n") if joined else []) if n]
    for name in names:
        buf = ctypes.c_void_p()
        nbytes = ctypes.c_ulonglong()
        if lib.ctpu_result_raw(
            result_ptr, name.encode(), ctypes.byref(buf), ctypes.byref(nbytes)
        ) != 0:
            raise InferenceServerException(_err(lib))
        dims = (ctypes.c_longlong * 16)()
        ndim = lib.ctpu_result_shape(result_ptr, name.encode(), dims, 16)
        if ndim < 0:
            raise InferenceServerException(_err(lib))
        shape = [dims[i] for i in range(ndim)]
        datatype = lib.ctpu_result_datatype(result_ptr, name.encode()).decode()
        raw = ctypes.string_at(buf, nbytes.value)
        if datatype == "BYTES":
            decoded[name] = deserialize_bytes_tensor(raw).reshape(shape)
            continue
        np_dtype = triton_to_np_dtype(datatype)
        if np_dtype is None:
            raise InferenceServerException(
                f"output '{name}' has unknown datatype {datatype!r}"
            )
        decoded[name] = np.frombuffer(raw, dtype=np.dtype(np_dtype)).reshape(shape)
    return decoded


def _build_array_input(lib, name, value, keepalive):
    """A ctpu input handle for a host array, BYTES-serialized when needed."""
    from .utils import serialize_byte_tensor

    arr = np.ascontiguousarray(value)
    datatype = np_to_triton_dtype(arr.dtype)
    if datatype is None:
        raise InferenceServerException(
            f"input '{name}' has unsupported dtype {arr.dtype}"
        )
    if datatype == "BYTES":
        serialized = serialize_byte_tensor(arr)
        payload = np.frombuffer(
            serialized.item() if serialized.size else b"", dtype=np.uint8
        )
    else:
        payload = arr
    keepalive.append(payload)
    dims = (ctypes.c_longlong * arr.ndim)(*arr.shape)
    handle = lib.ctpu_input_create(
        name.encode(), datatype.encode(), dims, arr.ndim
    )
    lib.ctpu_input_append_raw(
        handle, payload.ctypes.data_as(ctypes.c_void_p), payload.nbytes
    )
    return handle


class NativeClient:
    """Thin Python handle over the native HTTP client."""

    # C entry points; NativeGrpcClient swaps in the grpc set (results and
    # the value-model handles are shared across both clients)
    _FN = {
        "create": "ctpu_client_create",
        "create_ssl": "ctpu_client_create_ssl",
        "destroy": "ctpu_client_destroy",
        "live": "ctpu_server_live",
        "ready": "ctpu_model_ready",
        "infer": "ctpu_infer",
        "register_system_shm": "ctpu_register_system_shm",
        "register_cuda_shm": "ctpu_torch_register_cuda_shm",
        "unregister_shm": "ctpu_unregister_shm",
        "set_header": "ctpu_set_header",
    }

    def __init__(self, url: str, verbose: bool = False, ssl: bool = False,
                 ssl_options: Optional[dict] = None):
        """``ssl=True`` (or an ``https://`` url) negotiates TLS.
        ``ssl_options`` keys (all optional): ``ca_cert``, ``client_cert``,
        ``client_key`` (PEM file paths), ``verify_peer``, ``verify_host``
        (bools, default True) — HttpSslOptions / grpc SslOptions parity."""
        self._lib = load()
        # eager, not lazy-on-first-use: concurrent async_infer calls racing
        # a lazy init could each install a fresh dict and orphan the other's
        # live callback trampoline (native callback into freed memory)
        self._async_pending = {}  # id -> trampoline (CFUNCTYPE unhashable)
        if ssl or url.startswith("https://") or ssl_options:
            if not url.startswith("https://"):
                # ssl=True must never downgrade to cleartext: the HTTP C
                # path's SSL options only configure verification, the scheme
                # is what selects TLS
                url = "https://" + url.removeprefix("http://")
            opts = ssl_options or {}
            self._handle = getattr(self._lib, self._FN["create_ssl"])(
                url.encode(), int(verbose),
                (opts.get("ca_cert") or "").encode() or None,
                (opts.get("client_cert") or "").encode() or None,
                (opts.get("client_key") or "").encode() or None,
                int(opts.get("verify_peer", True)),
                int(opts.get("verify_host", True)),
            )
        else:
            self._handle = getattr(self._lib, self._FN["create"])(
                url.encode(), int(verbose)
            )
        if not self._handle:
            raise InferenceServerException(f"native client create failed: {_err(self._lib)}")

    def close(self) -> None:
        if self._handle:
            getattr(self._lib, self._FN["destroy"])(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def set_header(self, key: str, value: str) -> None:
        """Attach ``key: value`` to every request (auth tokens etc. — the
        native twin of the Python plugin hook)."""
        getattr(self._lib, self._FN["set_header"])(
            self._handle, key.encode(), value.encode()
        )

    def is_server_live(self) -> bool:
        rc = getattr(self._lib, self._FN["live"])(self._handle)
        if rc < 0:
            raise InferenceServerException(_err(self._lib))
        return bool(rc)

    def is_model_ready(self, model_name: str) -> bool:
        rc = getattr(self._lib, self._FN["ready"])(self._handle, model_name.encode())
        if rc < 0:
            raise InferenceServerException(_err(self._lib))
        return bool(rc)

    def infer_raw(
        self,
        model_name: str,
        input_name: str,
        tensor: np.ndarray,
        output_name: str,
        output_dtype=None,
        output_capacity: Optional[int] = None,
    ) -> np.ndarray:
        """Single-tensor inference through the native data path."""
        datatype = np_to_triton_dtype(tensor.dtype)
        tensor = np.ascontiguousarray(tensor)
        shape = (ctypes.c_longlong * tensor.ndim)(*tensor.shape)
        capacity = output_capacity or max(tensor.nbytes * 2, 1 << 16)
        out = np.empty(capacity, dtype=np.uint8)
        nbytes = self._lib.ctpu_infer_raw(
            self._handle, model_name.encode(), input_name.encode(),
            datatype.encode(), shape, tensor.ndim,
            tensor.ctypes.data_as(ctypes.c_void_p), tensor.nbytes,
            output_name.encode(), out.ctypes.data_as(ctypes.c_void_p), capacity,
        )
        if nbytes < 0:
            raise InferenceServerException(_err(self._lib))
        np_dtype = np.dtype(output_dtype or tensor.dtype)
        return out[:nbytes].view(np_dtype)

    def infer(self, model_name: str, inputs, outputs=None, request_id: str = "",
              sequence=None, client_timeout_s: float = 0.0):
        """Full value-model inference through the native data path.

        ``inputs``: list of (name, np.ndarray) and/or
        (name, ("shm", region, byte_size, offset, datatype, shape)).
        ``outputs``: optional list of names or (name, ("shm", ...)) tuples.
        Returns {output_name: np.ndarray} for non-shm outputs.
        """
        lib = self._lib
        in_handles = []
        out_handles = []
        keepalive = []
        options = lib.ctpu_options_create(model_name.encode())
        try:
            if request_id:
                lib.ctpu_options_set_request_id(options, request_id.encode())
            if sequence is not None:
                seq_id, start, end = sequence
                lib.ctpu_options_set_sequence(options, seq_id, int(start), int(end))
            if client_timeout_s:
                if client_timeout_s < 0:
                    raise InferenceServerException(
                        "client_timeout_s must be non-negative"
                    )
                lib.ctpu_options_set_timeouts(
                    options, max(1, int(round(client_timeout_s * 1e6))), 0
                )
            out_names = []
            for name, value in inputs:
                if isinstance(value, tuple) and value and value[0] == "shm":
                    _, region, nbytes, offset, datatype, shape = value
                    dims = (ctypes.c_longlong * len(shape))(*shape)
                    handle = lib.ctpu_input_create(
                        name.encode(), datatype.encode(), dims, len(shape)
                    )
                    lib.ctpu_input_set_shm(handle, region.encode(), nbytes, offset)
                else:
                    handle = _build_array_input(lib, name, value, keepalive)
                if not handle:
                    raise InferenceServerException(_err(lib))
                in_handles.append(handle)
            for spec in outputs or []:
                if isinstance(spec, tuple):
                    name, shm_spec = spec
                    handle = lib.ctpu_output_create(name.encode(), 0)
                    _, region, nbytes, offset = shm_spec[:4]
                    lib.ctpu_output_set_shm(handle, region.encode(), nbytes, offset)
                else:
                    name = spec
                    handle = lib.ctpu_output_create(name.encode(), 0)
                    out_names.append(name)
                out_handles.append(handle)

            ins = (ctypes.c_void_p * len(in_handles))(*in_handles)
            outs = (ctypes.c_void_p * len(out_handles))(*out_handles)
            result_ptr = ctypes.c_void_p()
            rc = getattr(lib, self._FN["infer"])(
                self._handle, options, ins, len(in_handles), outs,
                len(out_handles), ctypes.byref(result_ptr),
            )
            if rc != 0:
                if result_ptr:
                    lib.ctpu_result_destroy(result_ptr)
                raise InferenceServerException(_err(lib))
            try:
                # shm-placed outputs live in regions; with explicit outputs
                # only the non-shm names decode
                return _decode_result(
                    lib, result_ptr, None if outputs is None else out_names
                )
            finally:
                lib.ctpu_result_destroy(result_ptr)
        finally:
            for handle in in_handles:
                lib.ctpu_input_destroy(handle)
            for handle in out_handles:
                lib.ctpu_output_destroy(handle)
            lib.ctpu_options_destroy(options)

    def register_system_shared_memory(
        self, name: str, key: str, byte_size: int, offset: int = 0
    ) -> None:
        if getattr(self._lib, self._FN["register_system_shm"])(
            self._handle, name.encode(), key.encode(), byte_size, offset
        ) != 0:
            raise InferenceServerException(_err(self._lib))

    def register_cuda_shared_memory(
        self, name: str, raw_handle: str, device_id: int, byte_size: int,
        headers=None, query_params=None,
    ) -> None:
        """Register a cuda region by its raw handle (a
        :class:`NativeCudaShmRegion`'s, or ``utils.cuda_shared_memory.
        get_raw_handle``'s), in the port's Python clients' signature. The
        native clients send no per-call headers or query parameters: set
        headers once with :meth:`set_header`."""
        if headers or query_params:
            raise InferenceServerException(
                "native clients take headers through set_header and no query parameters")
        if getattr(self._lib, self._FN["register_cuda_shm"])(
            self._handle, name.encode(), raw_handle.encode(), device_id, byte_size
        ) != 0:
            raise InferenceServerException(
                self._lib.ctpu_torch_last_error().decode("utf-8", errors="replace"))

    def unregister_shared_memory(self, family: str = "cuda", name: str = "") -> None:
        if getattr(self._lib, self._FN["unregister_shm"])(
            self._handle, family.encode(), name.encode()
        ) != 0:
            raise InferenceServerException(_err(self._lib))


class NativeGrpcClient(NativeClient):
    """Thin Python handle over the native GRPC client (h2c transport).

    Same value-model ``infer`` surface as :class:`NativeClient`; the wire
    underneath is hand-framed gRPC over the library's own HTTP/2
    (native/src/grpc_client.cc, native/src/h2.cc). Bi-di streaming mirrors
    the Python grpc client: ``start_stream(callback)`` /
    ``stream_infer(...)`` / ``stop_stream()`` with ``callback(outputs,
    error)`` fired from the native reader thread (outputs is a
    ``{name: np.ndarray}`` dict, or None with an error string).
    """

    _FN = {
        "create": "ctpu_grpc_client_create",
        "create_ssl": "ctpu_grpc_client_create_ssl",
        "destroy": "ctpu_grpc_client_destroy",
        "live": "ctpu_grpc_server_live",
        "ready": "ctpu_grpc_model_ready",
        "infer": "ctpu_grpc_infer",
        "register_system_shm": "ctpu_grpc_register_system_shm",
        "register_cuda_shm": "ctpu_torch_grpc_register_cuda_shm",
        "unregister_shm": "ctpu_grpc_unregister_shm",
        "set_header": "ctpu_grpc_set_header",
    }

    # -- async (completion-queue worker) -----------------------------------
    def async_infer(self, model_name: str, inputs, callback,
                    client_timeout_s: float = 0.0) -> None:
        """Queue one inference on the native async worker; returns at once.

        ``callback(outputs, error)`` fires from the worker thread when the
        RPC completes — ``outputs`` is ``{name: np.ndarray}``, or ``None``
        with an error string. The worker keeps many RPCs in flight on ONE
        multiplexed h2 connection (completion-queue model), so N queued
        requests against a slow model overlap rather than serialize.
        ``inputs``: list of (name, np.ndarray).
        """
        lib = self._lib
        pending = self._async_pending
        holder = []

        def on_complete(_user, result_ptr):
            try:
                if not result_ptr:
                    callback(None, "async infer returned no result")
                    return
                status = lib.ctpu_result_status(result_ptr)
                if status is not None:
                    callback(None, status.decode("utf-8", "replace"))
                    return
                try:
                    decoded = _decode_result(lib, result_ptr)
                except InferenceServerException as e:
                    callback(None, str(e))
                    return
                callback(decoded, None)
            finally:
                if result_ptr:
                    lib.ctpu_result_destroy(result_ptr)
                pending.pop(id(holder[0]), None)

        trampoline = ASYNC_CALLBACK(on_complete)
        holder.append(trampoline)
        in_handles = []
        keepalive = []
        options = lib.ctpu_options_create(model_name.encode())
        try:
            if client_timeout_s:
                lib.ctpu_options_set_timeouts(
                    options, max(1, int(round(client_timeout_s * 1e6))), 0
                )
            for name, value in inputs:
                handle = _build_array_input(lib, name, value, keepalive)
                if not handle:
                    raise InferenceServerException(_err(lib))
                in_handles.append(handle)
            ins = (ctypes.c_void_p * len(in_handles))(*in_handles)
            # the native side serializes the request before returning, so
            # the input handles and numpy buffers may be freed on return;
            # only the callback trampoline must outlive the RPC
            pending[id(trampoline)] = trampoline
            rc = lib.ctpu_grpc_async_infer(
                self._handle, options, ins, len(in_handles), None, 0,
                trampoline, None,
            )
            if rc != 0:
                pending.pop(id(trampoline), None)
                raise InferenceServerException(_err(lib))
        finally:
            for handle in in_handles:
                lib.ctpu_input_destroy(handle)
            lib.ctpu_options_destroy(options)

    def set_compression(self, algorithm: Optional[str]) -> None:
        """Default message compression for infer RPCs and streams:
        ``"gzip"``, ``"deflate"``, or ``None`` (off). The twin of the
        Python clients' ``compression_algorithm`` argument."""
        self._lib.ctpu_grpc_set_compression(
            self._handle, (algorithm or "").encode()
        )

    def set_async_concurrency(self, n: int) -> None:
        """In-flight window for :meth:`async_infer` (default 16): how many
        RPCs the native worker keeps open concurrently on its multiplexed
        connection, clamped to the server's advertised
        SETTINGS_MAX_CONCURRENT_STREAMS."""
        self._lib.ctpu_grpc_set_async_concurrency(self._handle, int(n))

    # -- bi-di streaming ---------------------------------------------------
    def start_stream(self, callback) -> None:
        """Open the ModelStreamInfer stream; ``callback(outputs, error)``
        per response from the native reader thread."""
        lib = self._lib
        if getattr(self, "_stream_cb", None) is not None:
            # never clobber a live trampoline: the active stream's reader
            # still holds its function pointer
            raise InferenceServerException(
                "cannot start a stream: one is already active; stop it first"
            )

        def on_response(_user, result_ptr, error_message):
            try:
                if error_message is not None:
                    callback(None, error_message.decode("utf-8", "replace"))
                    return
                try:
                    decoded = _decode_result(lib, result_ptr) if result_ptr else {}
                except InferenceServerException as e:
                    callback(None, str(e))
                    return
                callback(decoded, None)
            finally:
                if result_ptr:
                    lib.ctpu_result_destroy(result_ptr)

        # keep the CFUNCTYPE alive for the stream's lifetime
        trampoline = STREAM_CALLBACK(on_response)
        if lib.ctpu_grpc_start_stream(self._handle, trampoline, None) != 0:
            raise InferenceServerException(_err(lib))
        self._stream_cb = trampoline

    def stream_infer(self, model_name: str, inputs, sequence=None) -> None:
        """Send one request on the open stream. ``inputs``: list of
        (name, np.ndarray)."""
        lib = self._lib
        in_handles = []
        keepalive = []
        options = lib.ctpu_options_create(model_name.encode())
        try:
            if sequence is not None:
                seq_id, start, end = sequence
                lib.ctpu_options_set_sequence(options, seq_id, int(start), int(end))
            for name, value in inputs:
                in_handles.append(
                    _build_array_input(lib, name, value, keepalive)
                )
            ins = (ctypes.c_void_p * len(in_handles))(*in_handles)
            # the native client serializes the request before returning, so
            # the input handles (and numpy buffers) may be freed right after
            if lib.ctpu_grpc_stream_infer(
                self._handle, options, ins, len(in_handles), None, 0
            ) != 0:
                raise InferenceServerException(_err(lib))
        finally:
            for handle in in_handles:
                lib.ctpu_input_destroy(handle)
            lib.ctpu_options_destroy(options)

    def stop_stream(self) -> None:
        if getattr(self, "_stream_cb", None) is None:
            return
        rc = self._lib.ctpu_grpc_stop_stream(self._handle)
        self._stream_cb = None
        if rc != 0:
            raise InferenceServerException(_err(self._lib))

    def close(self) -> None:
        if self._handle and getattr(self, "_stream_cb", None) is not None:
            try:
                self.stop_stream()
            except InferenceServerException:
                pass
        super().close()

    def infer_raw(self, model_name, input_name, tensor, output_name,
                  output_dtype=None, output_capacity=None):
        """Single-tensor convenience over the full value-model path.

        Matches the base class contract: a flat 1-D array of the output
        bytes reinterpreted as ``output_dtype`` (default: the input dtype),
        bounded by ``output_capacity`` when given.
        """
        result = self.infer(
            model_name, [(input_name, tensor)], outputs=[output_name]
        )
        if output_name not in result:
            raise InferenceServerException(
                f"output '{output_name}' missing from response"
            )
        raw = np.ascontiguousarray(result[output_name]).tobytes()
        if output_capacity is not None and len(raw) > output_capacity:
            raise InferenceServerException("output buffer too small")
        np_dtype = np.dtype(output_dtype or tensor.dtype)
        return np.frombuffer(raw, dtype=np_dtype)


class NativeCudaShmRegion:
    """A cuda shared-memory region's host window, made by the C library.

    The region is POSIX shared memory (``ctpu_shm_create``); register it
    with ``register_cuda_shared_memory(name, region.raw_handle(),
    device_id, region.byte_size)``. A server of the port attaches it by
    that raw handle (``utils.cuda_shared_memory.attach_from_raw_handle``)
    and moves what the window holds to its device; this process never
    touches a device."""

    def __init__(self, name: str, byte_size: int, device_id: int = 0, _handle=None):
        self._lib = load()
        self.byte_size = byte_size
        if _handle is not None:
            self._handle = _handle
        else:
            self._handle = self._lib.ctpu_shm_create(name.encode(), byte_size, device_id)
        if not self._handle:
            raise InferenceServerException(f"shm create failed: {_err(self._lib)}")

    @classmethod
    def attach(cls, raw_handle: str, byte_size: int) -> "NativeCudaShmRegion":
        lib = load()
        handle = lib.ctpu_shm_attach(raw_handle.encode())
        if not handle:
            raise InferenceServerException(f"shm attach failed: {_err(lib)}")
        return cls("", byte_size, _handle=handle)

    def raw_handle(self) -> str:
        return self._lib.ctpu_shm_raw_handle(self._handle).decode()

    def write(self, arr: np.ndarray, offset: int = 0) -> None:
        arr = np.ascontiguousarray(arr)
        if self._lib.ctpu_shm_write(
            self._handle, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes, offset
        ) != 0:
            raise InferenceServerException(_err(self._lib))

    def read(self, dtype, shape, offset: int = 0) -> np.ndarray:
        out = np.empty(shape, dtype=dtype)
        if self._lib.ctpu_shm_read(
            self._handle, out.ctypes.data_as(ctypes.c_void_p), out.nbytes, offset
        ) != 0:
            raise InferenceServerException(_err(self._lib))
        return out

    def destroy(self) -> None:
        if self._handle:
            self._lib.ctpu_shm_destroy(self._handle)
            self._handle = None


__all__ = ["ASYNC_CALLBACK", "STREAM_CALLBACK", "NativeClient", "NativeCudaShmRegion",
           "NativeGrpcClient", "available", "load"]
