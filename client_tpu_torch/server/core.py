"""Protocol-neutral server core: model registry, shm data plane, infer.

The counterpart of ``client_tpu.server.core``. The HTTP frontend marshals
requests into the neutral dict shape consumed by :meth:`ServerCore.infer`;
the core resolves shared-memory placement, runs the model (sequence
parameters pass through to it; decoupled models stream), and applies the
classification extension. Model outputs may be torch tensors: they reach the
wire as host bytes, or stay on the device when the output lands in a cuda
shared-memory region.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.base import Model
from ..utils import (
    deserialize_bf16_tensor,
    deserialize_bytes_tensor,
    np_to_triton_dtype,
    serialize_bf16_tensor,
    serialize_byte_tensor,
    tensor_to_numpy,
    torch_to_triton_dtype,
    triton_to_np_dtype,
)


class InferError(Exception):
    """Server-side inference failure with an HTTP-ish status code."""

    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status


def _to_host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return tensor_to_numpy(value)
    return np.asarray(value)


def _triton_dtype(value) -> Optional[str]:
    if isinstance(value, torch.Tensor):
        return torch_to_triton_dtype(value.dtype)
    return np_to_triton_dtype(value.dtype)


class _Region:
    """A registered system shared-memory region the server can read/write."""

    def __init__(self, name: str, family: str, key: str, offset: int,
                 byte_size: int, device_id: int = 0):
        self.name = name
        self.family = family
        self.key = key
        self.offset = offset
        self.byte_size = byte_size
        self.device_id = device_id
        self._shm = None

    def _buffer(self) -> memoryview:
        if self._shm is None:
            from ..utils.shared_memory import attach_shared_memory

            self._shm = attach_shared_memory(self.key)
        return self._shm.buf

    def check_range(self, nbytes: int, offset: int, op: str) -> int:
        if offset < 0 or nbytes < 0 or nbytes + offset > self.byte_size:
            raise InferError(
                f"shared-memory {op} of {nbytes}B at offset {offset} exceeds "
                f"region '{self.name}' ({self.byte_size}B)", 400,
            )
        return self.offset + offset

    def read(self, byte_size: int, offset: int) -> memoryview:
        base = self.check_range(byte_size, offset, "read")
        return self._buffer()[base : base + byte_size]

    def write(self, data: bytes, offset: int) -> None:
        base = self.check_range(len(data), offset, "write")
        self._buffer()[base : base + len(data)] = data

    def read_tensor(self, datatype: str, shape, byte_size: int, offset: int):
        """Materialize a tensor of ``datatype``/``shape`` from the region."""
        return _bytes_to_array(bytearray(self.read(byte_size, offset)), datatype, shape)

    def write_tensor(self, arr, datatype: str, offset: int, limit: int, name: str = "?") -> int:
        """Serialize ``arr`` into the region; returns bytes written."""
        payload = _array_to_bytes(_to_host(arr), datatype)
        if len(payload) > limit:
            raise InferError(
                f"output '{name}' ({len(payload)}B) exceeds shared-memory region "
                f"allotment of {limit}B", 400,
            )
        self.write(payload, offset)
        return len(payload)

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close()
            self._shm = None

    def status(self) -> Dict[str, Any]:
        if self.family == "system":
            return {
                "name": self.name,
                "key": self.key,
                "offset": self.offset,
                "byte_size": self.byte_size,
            }
        return {
            "name": self.name,
            "device_id": self.device_id,
            "byte_size": self.byte_size,
        }


class _CudaRegion(_Region):
    """A registered cuda_shared_memory region — the device-aware data plane.

    In-process registrations resolve to the client's own
    ``CudaSharedMemoryRegion`` object, so tensors bound with
    ``set_shared_memory_region_from_torch`` reach the model as those very
    tensors (zero copies) and torch outputs are pinned back into the region's
    device cache. A region registered from another process is read through
    its host window onto the server's device.
    """

    def __init__(self, name: str, raw_handle_b64: str, device_id: int,
                 byte_size: int, device):
        from ..utils.cuda_shared_memory import attach_from_raw_handle

        self._region = attach_from_raw_handle(raw_handle_b64, device=device.type)
        super().__init__(name, "cuda", self._region.shm_key, 0, byte_size, device_id)

    def read(self, byte_size: int, offset: int) -> memoryview:
        return self._region.read_host(byte_size, offset)

    def write(self, data: bytes, offset: int) -> None:
        self._region.write_host(data, offset)

    def read_tensor(self, datatype: str, shape, byte_size: int, offset: int):
        if datatype == "BYTES":
            return super().read_tensor(datatype, shape, byte_size, offset)
        from ..utils.cuda_shared_memory import get_contents_as_torch

        nbytes = int(np.prod(shape)) * np.dtype(triton_to_np_dtype(datatype)).itemsize
        if nbytes > byte_size:
            raise InferError(
                f"shm input needs {nbytes}B for shape {list(shape)} {datatype} but "
                f"only {byte_size}B were supplied", 400,
            )
        return get_contents_as_torch(self._region, datatype, shape, offset)

    def write_tensor(self, arr, datatype: str, offset: int, limit: int, name: str = "?") -> int:
        if datatype != "BYTES" and isinstance(arr, torch.Tensor):
            from ..utils.cuda_shared_memory import set_shared_memory_region_from_torch

            nbytes = arr.element_size() * arr.numel()
            if nbytes > limit:
                raise InferError(
                    f"output '{name}' ({nbytes}B) exceeds shared-memory region "
                    f"allotment of {limit}B", 400,
                )
            set_shared_memory_region_from_torch(self._region, arr, offset)
            return nbytes
        return super().write_tensor(arr, datatype, offset, limit, name)

    def close(self) -> None:
        self._region.detach()


class ServerCore:
    """Registry + data plane + execution, shared by the protocol frontends.

    ``device``: where tensors read from cross-process cuda shared-memory
    regions are placed (the models carry their own device)."""

    def __init__(self, models: Optional[List[Model]] = None, device="cuda"):
        self._device = torch.device(device)
        self._lock = threading.Lock()
        self._models: Dict[str, Model] = {}
        self._regions: Dict[str, _Region] = {}
        for m in models or []:
            self.add_model(m)

    # -- registry ----------------------------------------------------------
    def add_model(self, model: Model) -> None:
        with self._lock:
            self._models[model.name] = model

    def model(self, name: str, version: str = "") -> Model:
        m = self._models.get(name)
        if m is None:
            raise InferError(f"Request for unknown model: '{name}' is not found", 400)
        if version and version not in m.versions:
            raise InferError(
                f"Request for unknown model: '{name}' version {version} is not found", 400
            )
        return m

    def model_ready(self, name: str, version: str = "") -> bool:
        try:
            return self.model(name, version).ready
        except InferError:
            return False

    def server_metadata(self) -> Dict[str, Any]:
        return {
            "name": "client_tpu_torch_server",
            "version": "2.x-client_tpu_torch",
            "extensions": [
                "classification",
                "sequence",
                "model_configuration",
                "system_shared_memory",
                "cuda_shared_memory",
                "binary_tensor_data",
                "parameters",
            ],
        }

    # -- shared memory -----------------------------------------------------
    def register_system_region(self, name: str, key: str, offset: int, byte_size: int) -> None:
        self._register(_Region(name, "system", key, offset, byte_size))

    def register_cuda_region(
        self, name: str, raw_handle_b64: str, device_id: int, byte_size: int
    ) -> None:
        """Register a cuda region from its serialized handle (the base64 JSON
        descriptor of ``utils.cuda_shared_memory.get_raw_handle``)."""
        try:
            region = _CudaRegion(name, raw_handle_b64, device_id, byte_size, self._device)
        except Exception as e:
            raise InferError(f"failed to attach cuda shared-memory region: {e}", 400)
        self._register(region)

    def _register(self, region: _Region) -> None:
        with self._lock:
            if region.name in self._regions:
                # Triton semantics: an active name must be unregistered first
                region.close()
                raise InferError(
                    f"shared memory region '{region.name}' already in manager", 400)
            self._regions[region.name] = region

    def unregister_region(self, name: str = "", family: Optional[str] = None) -> None:
        with self._lock:
            if name:
                r = self._regions.pop(name, None)
                if r is not None:
                    r.close()
            else:
                for key in list(self._regions):
                    if family is None or self._regions[key].family == family:
                        self._regions.pop(key).close()

    def region_status(self, family: str, name: str = "") -> List[Dict[str, Any]]:
        with self._lock:
            return [
                r.status()
                for r in self._regions.values()
                if r.family == family and (not name or r.name == name)
            ]

    def _region(self, name: str) -> _Region:
        with self._lock:
            r = self._regions.get(name)
        if r is None:
            raise InferError(f"Unable to find shared memory region: '{name}'", 400)
        return r

    # -- inference ---------------------------------------------------------
    def infer(self, model_name: str, model_version: str,
              request: Dict[str, Any]) -> Dict[str, Any]:
        """Execute one inference of a non-decoupled model.

        ``request``: {"id", "parameters", "inputs": [...], "outputs": [...]}
        where each input dict has name/datatype/shape plus exactly one of
        "array" (host ndarray) or "shm" ((region, byte_size, offset)).

        Returns the response dict: {"model_name", "model_version", "id",
        "outputs": [{name, datatype, shape, "array"|"shm"}]}.
        """
        model = self.model(model_name, model_version)
        if not model.ready:
            raise InferError(f"Request for unknown model: '{model_name}' is not ready", 400)
        if model.decoupled:
            raise InferError(
                f"model '{model_name}' is a decoupled model: use streaming inference", 400)
        try:
            inputs = self._resolve_inputs(model, request)
            raw = model.execute(inputs, request.get("parameters", {}))
        except InferError:
            raise
        except Exception as e:
            raise InferError(f"inference failed: {e}", 400)
        return self._build_response(model, model_version, request, raw)

    def infer_stream(self, model_name: str, model_version: str, request: Dict[str, Any]):
        """Incremental inference: a generator yielding response dicts AS the
        model produces them (decoupled models stream each response before
        the next is computed; others yield their single infer() response)."""
        model = self.model(model_name, model_version)
        if not model.decoupled:
            yield self.infer(model_name, model_version, request)
            return
        if not model.ready:
            raise InferError(f"Request for unknown model: '{model_name}' is not ready", 400)
        yield from self._decoupled_stream(model, model_version, request)

    def _decoupled_stream(self, model: Model, model_version: str, request: Dict[str, Any]):
        try:
            inputs = self._resolve_inputs(model, request)
            gen = model.execute_decoupled(inputs, request.get("parameters", {}))
            for raw in gen:
                yield self._build_response(model, model_version, request, raw)
        except InferError:
            raise
        except Exception as e:
            raise InferError(f"inference failed: {e}", 400)

    def _resolve_inputs(self, model: Model, request: Dict[str, Any]) -> Dict[str, Any]:
        specs = {s.name: s for s in model.inputs()}
        out: Dict[str, Any] = {}
        for inp in request.get("inputs", []):
            name = inp["name"]
            spec = specs.get(name)
            if spec is None:
                raise InferError(
                    f"unexpected inference input '{name}' for model '{model.name}'", 400)
            datatype = inp.get("datatype", spec.datatype)
            if datatype != spec.datatype:
                raise InferError(
                    f"inference input '{name}' has datatype {datatype}; "
                    f"model expects {spec.datatype}", 400,
                )
            shape = inp.get("shape", [])
            if not spec.matches(shape):
                raise InferError(
                    f"unexpected shape {shape} for input '{name}' "
                    f"(model expects {spec.shape})", 400,
                )
            shm = inp.get("shm")
            if shm is not None:
                region_name, byte_size, offset = shm
                region = self._region(region_name)
                region.check_range(byte_size, offset, "read")
                out[name] = region.read_tensor(datatype, shape, byte_size, offset)
            else:
                arr = inp.get("array")
                if arr is None:
                    raise InferError(f"input '{name}' has no data", 400)
                out[name] = arr
        missing = {s for s in set(specs) - set(out) if not specs[s].optional}
        if missing:
            raise InferError(
                f"expected {len(specs)} inputs but got {len(out)} inputs for "
                f"model '{model.name}' (missing: {sorted(missing)})", 400,
            )
        return out

    def _build_response(self, model: Model, model_version: str,
                        request: Dict[str, Any], raw: Dict[str, Any]) -> Dict[str, Any]:
        requested = request.get("outputs")
        if requested:
            for r in requested:
                if r["name"] not in raw:
                    raise InferError(
                        f"unexpected inference output '{r['name']}' for model "
                        f"'{model.name}'", 400,
                    )
            out_specs = requested
        else:
            out_specs = [{"name": n} for n in raw.keys()]

        outputs = []
        for spec in out_specs:
            name = spec["name"]
            arr = raw[name]  # np.ndarray or torch tensor (stays on its device)
            class_count = spec.get("classification", 0)
            if class_count:
                arr = _classification(
                    arr, class_count, model.labels(),
                    batched=model.effective_max_batch_size() > 0,
                )
                datatype = "BYTES"
            else:
                datatype = _triton_dtype(arr)
            entry: Dict[str, Any] = {
                "name": name,
                "datatype": datatype,
                "shape": list(arr.shape),
            }
            shm = spec.get("shm")
            if shm is not None:
                region_name, byte_size, offset = shm
                written = self._region(region_name).write_tensor(
                    arr, datatype, offset, byte_size, name)
                entry["shm"] = (region_name, written, offset)
            else:
                entry["array"] = _to_host(arr)
            outputs.append(entry)
        resp: Dict[str, Any] = {
            "model_name": model.name,
            "model_version": model_version or model.versions[-1],
            "outputs": outputs,
        }
        if request.get("id"):
            resp["id"] = request["id"]
        return resp


def _bytes_to_array(buf, datatype: str, shape) -> np.ndarray:
    """Decode wire bytes; a ``bytearray`` gives a writable array (which torch
    then takes without a further copy)."""
    if datatype == "BYTES":
        return deserialize_bytes_tensor(buf).reshape(shape)
    if datatype == "BF16":
        return deserialize_bf16_tensor(buf).reshape(shape)
    return np.frombuffer(buf, dtype=triton_to_np_dtype(datatype)).reshape(shape)


def _array_to_bytes(arr: np.ndarray, datatype: str) -> bytes:
    if datatype == "BYTES":
        s = serialize_byte_tensor(arr)
        return s.item() if s.size else b""
    if datatype == "BF16":
        s = serialize_bf16_tensor(arr)
        return s.item() if s.size else b""
    return np.ascontiguousarray(arr).tobytes()


def _classification(arr, k: int, labels: Optional[List[str]], batched: bool = False) -> np.ndarray:
    """classification extension: top-k "value:index[:label]" strings.

    For batched models the first dim is the batch and each element's
    (flattened) remainder is its class vector; for non-batched models the
    whole (flattened) tensor is one class vector. Ranking runs on the
    tensor's device with ``torch.topk``; only the k winners cross to the
    host.
    """
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    flat = t.reshape(t.shape[0], -1) if batched and t.dim() >= 1 else t.reshape(1, -1)
    k = min(k, flat.shape[-1])
    values, indices = torch.topk(flat, k, dim=-1)
    values, indices = _to_host(values), _to_host(indices)
    rows = []
    for row_values, row_indices in zip(values, indices):
        entries = []
        for value, i in zip(row_values, row_indices):
            s = f"{value:f}:{i}"
            if labels and i < len(labels):
                s += f":{labels[i]}"
            entries.append(s.encode("utf-8"))
        rows.append(entries)
    out = np.array(rows, dtype=np.object_)
    if not batched:
        return out.reshape(-1)
    return out.reshape((t.shape[0], k))
