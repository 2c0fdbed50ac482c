"""Triton/KServe-v2 dtype mapping and tensor wire serialization (PyTorch port).

The counterpart of ``client_tpu.utils``: the same dtype maps, the same
BYTES/BF16 wire formats and the same ``InferenceServerException``, plus the
torch <-> Triton dtype maps and the host <-> device conversions the port's
data plane needs.

Wire formats (identical to the reference so payloads interoperate with a real
tritonserver and with ``client_tpu``):

- BYTES tensor: each element is a 4-byte little-endian length prefix followed
  by the raw bytes, elements concatenated in C (row-major) order.
- BF16 tensor: 2 bytes per element, little-endian, i.e. the raw bits of
  bfloat16.

BF16 on the numpy side is ``ml_dtypes.bfloat16``. torch bf16 tensors have no
``.numpy()``, so they cross to numpy as an int16 view reinterpreted as
bfloat16 (and back the same way): the bits never change.
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional

import numpy as np
import torch

try:  # ml_dtypes gives numpy a native bfloat16; without it BF16 is raw bits
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover - present wherever the tests run
    ml_dtypes = None
    _BFLOAT16 = None


# Request parameter names reserved by the protocol: users may not pass these
# through the custom-parameters bag.
RESERVED_REQUEST_PARAMETERS = frozenset(
    (
        "sequence_id",
        "sequence_start",
        "sequence_end",
        "priority",
        "binary_data_output",
    )
)


class InferenceServerException(Exception):
    """Exception carrying a message plus optional HTTP/GRPC status and debug detail."""

    def __init__(self, msg: str, status: Optional[str] = None, debug_details: Any = None):
        super().__init__(msg)
        self._msg = msg
        self._status = status
        self._debug_details = debug_details

    def __str__(self) -> str:
        out = self._msg if self._msg is not None else ""
        if self._status is not None:
            out = "[" + self._status + "] " + out
        return out

    def message(self) -> Optional[str]:
        return self._msg

    def status(self) -> Optional[str]:
        return self._status

    def debug_details(self) -> Any:
        return self._debug_details


def sorted_percentile(sorted_values, q: float) -> float:
    """The q-quantile of an ascending sequence by the index convention
    every harness/stats surface in this repo shares (min(int(n*q), n-1));
    0.0 when empty. Callers sort once and take several quantiles."""
    if not sorted_values:
        return 0.0
    idx = min(int(len(sorted_values) * q), len(sorted_values) - 1)
    return sorted_values[idx]


def raise_error(msg: str) -> "NoReturn":  # noqa: F821
    """Raise an InferenceServerException with ``msg``."""
    raise InferenceServerException(msg=msg)


# ---------------------------------------------------------------------------
# numpy dtype maps
# ---------------------------------------------------------------------------

_NP_TO_TRITON = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.uint16): "UINT16",
    np.dtype(np.uint32): "UINT32",
    np.dtype(np.uint64): "UINT64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
    np.dtype(np.object_): "BYTES",
}
if _BFLOAT16 is not None:
    _NP_TO_TRITON[_BFLOAT16] = "BF16"

_TRITON_TO_NP = {
    "BOOL": np.bool_,
    "INT8": np.int8,
    "INT16": np.int16,
    "INT32": np.int32,
    "INT64": np.int64,
    "UINT8": np.uint8,
    "UINT16": np.uint16,
    "UINT32": np.uint32,
    "UINT64": np.uint64,
    "FP16": np.float16,
    "FP32": np.float32,
    "FP64": np.float64,
    "BYTES": np.object_,
    "BF16": (_BFLOAT16 if _BFLOAT16 is not None else np.float32),
}

# Size in bytes of one element on the wire; BYTES is variable (None).
_TRITON_DTYPE_SIZES = {
    "BOOL": 1,
    "INT8": 1,
    "INT16": 2,
    "INT32": 4,
    "INT64": 8,
    "UINT8": 1,
    "UINT16": 2,
    "UINT32": 4,
    "UINT64": 8,
    "FP16": 2,
    "FP32": 4,
    "FP64": 8,
    "BF16": 2,
    "BYTES": None,
}


def np_to_triton_dtype(np_dtype) -> Optional[str]:
    """Map a numpy dtype (or dtype-like) to the Triton datatype string."""
    dt = np.dtype(np_dtype)
    if dt.kind in ("S", "U"):
        return "BYTES"
    return _NP_TO_TRITON.get(dt)


def triton_to_np_dtype(dtype: str):
    """Map a Triton datatype string to a numpy dtype (BF16 -> ml_dtypes.bfloat16)."""
    return _TRITON_TO_NP.get(dtype)


def triton_dtype_element_size(dtype: str) -> Optional[int]:
    """Bytes per element on the wire for ``dtype``; None for BYTES (variable)."""
    return _TRITON_DTYPE_SIZES.get(dtype)


def serialized_byte_size(np_array: np.ndarray) -> int:
    """Byte size this array will occupy on the wire."""
    if np_array.dtype == np.object_ or np_array.dtype.kind in ("S", "U"):
        serialized = serialize_byte_tensor(np_array)
        return len(serialized.item()) if serialized.size > 0 else 0
    return np_array.nbytes


# ---------------------------------------------------------------------------
# torch dtype maps and host <-> device conversion
# ---------------------------------------------------------------------------

_TORCH_TO_TRITON = {
    torch.bool: "BOOL",
    torch.int8: "INT8",
    torch.int16: "INT16",
    torch.int32: "INT32",
    torch.int64: "INT64",
    torch.uint8: "UINT8",
    torch.float16: "FP16",
    torch.float32: "FP32",
    torch.float64: "FP64",
    torch.bfloat16: "BF16",
}
# the wide unsigned types exist (with limited op support) in newer torch
for _name, _triton in (("uint16", "UINT16"), ("uint32", "UINT32"), ("uint64", "UINT64")):
    if hasattr(torch, _name):
        _TORCH_TO_TRITON[getattr(torch, _name)] = _triton
_TRITON_TO_TORCH = {v: k for k, v in _TORCH_TO_TRITON.items()}

# numpy has no bfloat16 of its own and torch's wide unsigned types have no
# .numpy(): both cross as a same-width signed view, reinterpreted
_SAME_WIDTH_SIGNED = {
    "BF16": (torch.int16, np.int16),
    "UINT16": (torch.int16, np.int16),
    "UINT32": (torch.int32, np.int32),
    "UINT64": (torch.int64, np.int64),
}


def torch_to_triton_dtype(dtype: torch.dtype) -> Optional[str]:
    """Map a torch dtype to the Triton datatype string (None if unmapped)."""
    return _TORCH_TO_TRITON.get(dtype)


def triton_to_torch_dtype(dtype: str) -> Optional[torch.dtype]:
    """Map a Triton datatype string to a torch dtype (None for BYTES/unmapped)."""
    return _TRITON_TO_TORCH.get(dtype)


def tensor_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """Host ndarray with ``tensor``'s bits: one D2H copy for a device tensor,
    zero-copy for a contiguous CPU tensor. BF16 comes back as
    ``ml_dtypes.bfloat16``."""
    t = tensor.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    triton = _TORCH_TO_TRITON.get(t.dtype)
    if triton in _SAME_WIDTH_SIGNED:
        signed_torch, _ = _SAME_WIDTH_SIGNED[triton]
        return t.view(signed_torch).numpy().view(np.dtype(triton_to_np_dtype(triton)))
    return t.numpy()


def numpy_to_tensor(arr: np.ndarray, device="cuda") -> torch.Tensor:
    """A torch tensor on ``device`` with ``arr``'s bits (BF16 from
    ``ml_dtypes.bfloat16``). Read-only arrays are copied first; a writable
    array shares memory with the result when ``device`` is the CPU."""
    arr = np.asarray(arr)
    triton = np_to_triton_dtype(arr.dtype)
    if triton is None or triton == "BYTES":
        raise InferenceServerException(
            f"dtype {arr.dtype} has no torch tensor representation")
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    if triton in _SAME_WIDTH_SIGNED:
        signed_torch, signed_np = _SAME_WIDTH_SIGNED[triton]
        t = torch.from_numpy(arr.view(signed_np)).view(_TRITON_TO_TORCH[triton])
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def as_device_tensor(value, device) -> torch.Tensor:
    """``value`` (torch tensor or host array) as a tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return numpy_to_tensor(value, device)


# ---------------------------------------------------------------------------
# BYTES tensors
# ---------------------------------------------------------------------------


def _element_to_bytes(obj: Any) -> bytes:
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, str):
        return obj.encode("utf-8")
    if isinstance(obj, np.bytes_):
        return bytes(obj)
    # numpy str scalar, numbers, etc.
    return str(obj).encode("utf-8")


def serialize_byte_tensor(input_tensor) -> np.ndarray:
    """Serialize a BYTES tensor to the 4-byte-LE-length-prefixed wire format.

    Returns a 1-element object ndarray whose ``.item()`` is the serialized
    buffer, or an empty array if the tensor has no elements.
    """
    arr = np.asarray(input_tensor)
    if arr.size == 0:
        return np.empty([0], dtype=np.object_)
    if not (arr.dtype == np.object_ or arr.dtype.kind in ("S", "U")):
        raise_error("cannot serialize bytes tensor: invalid datatype")
    chunks: List[bytes] = []
    for obj in np.nditer(arr, flags=["refs_ok"], order="C"):
        item = _element_to_bytes(obj.item())
        chunks.append(struct.pack("<I", len(item)))
        chunks.append(item)
    out = np.empty([1], dtype=np.object_)
    out[0] = b"".join(chunks)
    return out


def deserialize_bytes_tensor(encoded_tensor: bytes, count: Optional[int] = None) -> np.ndarray:
    """Deserialize a BYTES wire payload to a flat object ndarray of ``bytes``.

    ``count`` bounds the number of elements (used when reading from a region
    larger than the payload, e.g. shared memory)."""
    strs: List[bytes] = []
    buf = memoryview(encoded_tensor)
    offset = 0
    n = len(buf)
    while offset < n and (count is None or len(strs) < count):
        if offset + 4 > n:
            raise InferenceServerException(
                "malformed BYTES tensor: truncated length prefix"
            )
        (length,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        if offset + length > n:
            raise InferenceServerException("malformed BYTES tensor: truncated element")
        strs.append(bytes(buf[offset : offset + length]))
        offset += length
    return np.array(strs, dtype=np.object_)


# ---------------------------------------------------------------------------
# BF16 tensors
# ---------------------------------------------------------------------------


def serialize_bf16_tensor(input_tensor) -> np.ndarray:
    """Serialize a tensor to BF16 wire format (2 bytes/element, LE).

    Accepts bfloat16 arrays as they are, or any float array (converted with
    round-to-nearest-even). Returns a 1-element object ndarray whose
    ``.item()`` is the buffer.
    """
    arr = np.asarray(input_tensor)
    if arr.size == 0:
        return np.empty([0], dtype=np.object_)
    if _BFLOAT16 is None:
        raise_error("bfloat16 support requires ml_dtypes")
    if arr.dtype != _BFLOAT16:
        arr = arr.astype(_BFLOAT16)
    out = np.empty([1], dtype=np.object_)
    out[0] = np.ascontiguousarray(arr).tobytes()
    return out


def deserialize_bf16_tensor(encoded_tensor: bytes) -> np.ndarray:
    """Deserialize a BF16 wire payload to a flat bfloat16 ndarray (zero-copy)."""
    if _BFLOAT16 is None:
        return np.frombuffer(encoded_tensor, dtype=np.uint16).astype(np.float32)
    return np.frombuffer(encoded_tensor, dtype=_BFLOAT16)
