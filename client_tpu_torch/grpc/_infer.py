"""GRPC request building and result decoding (dict-form messages).

The counterpart of ``client_tpu.grpc._infer``: builds ``ModelInferRequest``
dicts from the shared value model (binary tensors ride
``raw_input_contents``; JSON-mode data uses the typed
``InferTensorContents`` fields) and decodes ``ModelInferResponse`` dicts.
Inputs may be numpy arrays or torch tensors (CPU or CUDA), staged as the
HTTP path stages them; ``as_torch`` takes the place of ``as_jax``. The
request dicts, and so the frames, equal the JAX package's for the same
inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._tensor import InferInput, InferRequestedOutput
from ..utils import (
    RESERVED_REQUEST_PARAMETERS,
    InferenceServerException,
    deserialize_bf16_tensor,
    deserialize_bytes_tensor,
    numpy_to_tensor,
    triton_to_np_dtype,
)


def to_grpc_compression(algorithm: Optional[str]):
    """Map a ``compression_algorithm`` string to a ``grpc.Compression`` value.

    ``None`` maps to ``None`` (inherit the channel's default compression);
    ``"deflate"``/``"gzip"`` to the grpc enum; any other value warns and
    falls back to no compression.
    """
    import grpc

    if algorithm is None:
        return None
    if isinstance(algorithm, str):
        lowered = algorithm.lower()
        if lowered == "deflate":
            return grpc.Compression.Deflate
        if lowered == "gzip":
            return grpc.Compression.Gzip
    import warnings

    warnings.warn(
        f"unsupported client-side compression algorithm {algorithm!r}; "
        "using no compression",
        stacklevel=3,
    )
    return grpc.Compression.NoCompression


# typed-contents field per Triton datatype (InferTensorContents)
_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents",
    "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "UINT64": "uint64_contents",
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
    "BYTES": "bytes_contents",
}


def to_infer_parameter(value: Any) -> Dict[str, Any]:
    if isinstance(value, bool):
        return {"bool_param": value}
    if isinstance(value, int):
        return {"int64_param": value}
    if isinstance(value, float):
        return {"double_param": value}
    if isinstance(value, str):
        return {"string_param": value}
    raise InferenceServerException(
        f"unsupported parameter type {type(value).__name__} (bool/int/float/str)"
    )


def from_infer_parameter(param: Dict[str, Any]) -> Any:
    for key in (
        "bool_param",
        "int64_param",
        "string_param",
        "double_param",
        "uint64_param",
        "uint32_param",  # LogSettings oneof
    ):
        if key in param:
            return param[key]
    return None


def _shm_parameters(shm) -> Dict[str, Any]:
    region, byte_size, offset = shm
    params = {
        "shared_memory_region": to_infer_parameter(region),
        "shared_memory_byte_size": to_infer_parameter(int(byte_size)),
    }
    if offset:
        params["shared_memory_offset"] = to_infer_parameter(int(offset))
    return params


def build_infer_request(
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
    parameters: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build a ModelInferRequest dict for the wire codec."""
    request: Dict[str, Any] = {"model_name": model_name}
    if model_version:
        request["model_version"] = model_version
    if request_id:
        request["id"] = request_id

    params: Dict[str, Any] = {}
    if sequence_id:
        params["sequence_id"] = to_infer_parameter(int(sequence_id))
        params["sequence_start"] = to_infer_parameter(bool(sequence_start))
        params["sequence_end"] = to_infer_parameter(bool(sequence_end))
    if priority:
        params["priority"] = to_infer_parameter(int(priority))
    if timeout is not None:
        params["timeout"] = to_infer_parameter(int(timeout))
    if parameters:
        for key, value in parameters.items():
            if key in RESERVED_REQUEST_PARAMETERS:
                raise InferenceServerException(
                    f"parameter '{key}' is a reserved parameter and cannot be "
                    "specified as a custom parameter"
                )
            params[key] = to_infer_parameter(value)
    if params:
        request["parameters"] = params

    tensors = []
    raw_contents: List[bytes] = []
    for inp in inputs:
        tensor: Dict[str, Any] = {
            "name": inp.name(),
            "datatype": inp.datatype(),
            "shape": inp.shape(),
        }
        shm = inp._shared_memory_params()
        if shm is not None:
            tensor["parameters"] = _shm_parameters(shm)
        raw = inp._get_binary_data()
        if raw is not None:
            raw_contents.append(raw if isinstance(raw, bytes) else bytes(raw))
        elif shm is None and inp._json_data is not None:
            field = _CONTENTS_FIELD.get(inp.datatype())
            if field is None:
                raise InferenceServerException(
                    f"datatype {inp.datatype()} requires binary data on GRPC"
                )
            data = inp._json_data
            if field == "bytes_contents":
                data = [d.encode("utf-8") if isinstance(d, str) else bytes(d) for d in data]
            tensor["contents"] = {field: data}
        elif shm is None:
            raise InferenceServerException(f"input '{inp.name()}' has no data")
        tensors.append(tensor)
    if raw_contents and any(t.get("contents") for t in tensors):
        raise InferenceServerException(
            "inputs must be uniform: cannot mix raw binary and typed contents "
            "in one request"
        )
    request["inputs"] = tensors
    if raw_contents:
        request["raw_input_contents"] = raw_contents

    if outputs:
        out_tensors = []
        for out in outputs:
            entry: Dict[str, Any] = {"name": out.name()}
            shm = out._shared_memory_params()
            oparams = _shm_parameters(shm) if shm is not None else {}
            if out._class_count:
                oparams["classification"] = to_infer_parameter(int(out._class_count))
            if oparams:
                entry["parameters"] = oparams
            out_tensors.append(entry)
        request["outputs"] = out_tensors
    return request


class InferResult:
    """The result of an inference over GRPC (decoded ModelInferResponse)."""

    def __init__(self, response: Dict[str, Any]):
        self._response = response
        self._raw = response.get("raw_output_contents", [])

    @classmethod
    def from_response(cls, response: Dict[str, Any]) -> "InferResult":
        return cls(response)

    def get_response(self) -> Dict[str, Any]:
        return self._response

    def get_output(self, name: str) -> Optional[Dict[str, Any]]:
        for out in self._response.get("outputs", []):
            if out.get("name") == name:
                return out
        return None

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        """Decode output ``name``; None if it lives in a shared-memory region."""
        # raw_output_contents aligns with non-shared-memory outputs in order
        raw_index = 0
        out = None
        for candidate in self._response.get("outputs", []):
            in_shm = "shared_memory_region" in candidate.get("parameters", {})
            if candidate.get("name") == name:
                out = candidate
                break
            if not in_shm:
                raw_index += 1
        if out is None or "shared_memory_region" in out.get("parameters", {}):
            return None
        shape = out.get("shape", [])
        datatype = out.get("datatype", "")
        if raw_index < len(self._raw):
            raw = self._raw[raw_index]
            if datatype == "BYTES":
                return deserialize_bytes_tensor(raw).reshape(shape)
            if datatype == "BF16":
                return deserialize_bf16_tensor(raw).reshape(shape)
            return np.frombuffer(raw, dtype=triton_to_np_dtype(datatype)).reshape(shape)
        contents = out.get("contents")
        if contents:
            data = contents.get(_CONTENTS_FIELD.get(datatype), [])
            return np.array(data, dtype=triton_to_np_dtype(datatype)).reshape(shape)
        return None

    def as_torch(self, name: str, device="cuda") -> Optional[torch.Tensor]:
        """Decode output ``name`` and place it on ``device`` (one H2D copy)."""
        arr = self.as_numpy(name)
        if arr is None:
            return None
        if arr.dtype == np.object_:
            raise InferenceServerException("BYTES outputs cannot be placed on device")
        return numpy_to_tensor(arr, device)

    # decoupled-model helpers (reference: common.h IsFinalResponse/IsNullResponse)
    def is_final_response(self) -> bool:
        param = self._response.get("parameters", {}).get("triton_final_response", {})
        return bool(param.get("bool_param", False))

    def is_null_response(self) -> bool:
        return not self._response.get("outputs") and self.is_final_response()
