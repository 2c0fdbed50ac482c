"""HTTP InferResult: split the JSON header from the binary tail, decode tensors.

The counterpart of ``client_tpu.http._infer_result``: an offset map over the
binary tail, ``as_numpy`` frombuffer+reshape, and ``as_torch`` in place of
``as_jax`` — the decoded tensor placed on a torch device with one
host->device copy.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._tensor import ArenaOutputsMixin
from ..integrity import IntegrityError
from ..utils import (
    InferenceServerException,
    deserialize_bf16_tensor,
    deserialize_bytes_tensor,
    numpy_to_tensor,
    triton_to_np_dtype,
)


class InferResult(ArenaOutputsMixin):
    """The result of an inference request over HTTP.

    Body decoding raises a typed :class:`~client_tpu_torch.integrity.IntegrityError`
    (status ``INTEGRITY_VIOLATION``, a subclass of ``InferenceServerException``)
    for malformed responses — torn or non-UTF-8 JSON headers, header-length
    claims exceeding the body, binary sizes overrunning the buffer — so torn
    bytes classify into the ``invalid`` fault domain like the contract lies
    ``integrity.check_result`` catches after the parse. The decoder does not
    know its endpoint; the frontend stamps the url on through
    ``integrity.note_parse_violation``."""

    def __init__(self, response_body: bytes, header_length: Optional[int] = None):
        self._buffer = memoryview(response_body)
        if header_length is not None and header_length > len(response_body):
            raise IntegrityError(
                "malformed", "", "Inference-Header-Content-Length",
                f"<= {len(response_body)}", str(header_length))
        try:
            if header_length is None:
                self._response: Dict[str, Any] = json.loads(response_body)
                self._binary_start = len(response_body)
            else:
                self._response = json.loads(bytes(self._buffer[:header_length]))
                self._binary_start = header_length
        except (UnicodeDecodeError, ValueError) as e:
            raise IntegrityError(
                "malformed", "", "response header", "valid JSON", str(e)) from e
        if not isinstance(self._response, dict):
            raise IntegrityError(
                "malformed", "", "response header", "a JSON object",
                type(self._response).__name__)
        # Map output name -> (start, end) into the binary tail, walked in
        # output order using each output's binary_data_size parameter.
        self._offsets: Dict[str, Tuple[int, int]] = {}
        cursor = self._binary_start
        for output in self._response.get("outputs", []):
            if not isinstance(output, dict):
                raise IntegrityError(
                    "malformed", "", "outputs", "JSON objects", type(output).__name__)
            params = output.get("parameters", {})
            size = params.get("binary_data_size") if isinstance(params, dict) else None
            if size is None:
                continue
            name = output.get("name")
            if not isinstance(size, int) or isinstance(size, bool) or size < 0:
                raise IntegrityError(
                    "payload_size", "", str(name), "a non-negative integer",
                    f"invalid binary_data_size {size!r}")
            if cursor + size > len(response_body):
                raise IntegrityError(
                    "tail", "", str(name), f"{size} bytes within the body",
                    f"claim reaches beyond the body "
                    f"({len(response_body) - cursor} bytes remain)")
            if not isinstance(name, str) or not name:
                raise IntegrityError(
                    "output_name", "", "outputs", "a non-empty string name", repr(name))
            self._offsets[name] = (cursor, cursor + size)
            cursor += size

    @classmethod
    def from_response_body(
        cls, response_body: bytes, header_length: Optional[int] = None
    ) -> "InferResult":
        return cls(response_body, header_length)

    # -- accessors ---------------------------------------------------------
    def get_response(self) -> Dict[str, Any]:
        return self._response

    def get_response_header(self, name: str, default: Optional[str] = None) -> Optional[str]:
        """A transport response header (e.g. ORCA's ``endpoint-load-metrics``)."""
        headers = getattr(self, "_response_headers", None)
        if not headers:
            return default
        for key, value in headers.items():
            if key.lower() == name.lower():
                return value
        return default

    def get_output(self, name: str) -> Optional[Dict[str, Any]]:
        for output in self._response.get("outputs", []):
            if output.get("name") == name:
                return output
        return None

    def _decode(self, output: Dict[str, Any]) -> Optional[np.ndarray]:
        name = output.get("name")
        datatype = output.get("datatype")
        shape = output.get("shape")
        if not isinstance(datatype, str) or not isinstance(shape, list):
            raise IntegrityError(
                "malformed", "", f"output '{name}'",
                "datatype and shape fields", repr(sorted(output))[:120])
        params = output.get("parameters", {})
        if "shared_memory_region" in params:
            lease = self._arena_lease_for(name)
            if lease is not None:
                # arena fast path: a zero-copy view over the leased slab,
                # pinned by the lease (reading after its last release
                # raises arena.ArenaLeaseReleased)
                return lease.as_numpy(datatype, shape)
            return None  # contents live in the shared-memory region
        if name in self._offsets:
            start, end = self._offsets[name]
            raw = self._buffer[start:end]
            if datatype == "BYTES":
                arr = deserialize_bytes_tensor(raw)
            elif datatype == "BF16":
                arr = deserialize_bf16_tensor(raw)
            else:
                np_dtype = triton_to_np_dtype(datatype)
                if np_dtype is None:
                    raise InferenceServerException(
                        f"unknown datatype '{datatype}' for output '{name}'"
                    )
                arr = np.frombuffer(raw, dtype=np_dtype)
            return self._reshape(arr, shape, name)
        if "data" in output:
            if datatype == "BYTES":
                arr = np.array(
                    [d.encode("utf-8") if isinstance(d, str) else d for d in output["data"]],
                    dtype=np.object_,
                )
            else:
                np_dtype = triton_to_np_dtype(datatype)
                if np_dtype is None:
                    raise InferenceServerException(
                        f"unknown datatype '{datatype}' for output '{name}'"
                    )
                try:
                    arr = np.array(output["data"], dtype=np_dtype)
                except (ValueError, TypeError, OverflowError) as e:
                    raise IntegrityError(
                        "malformed", "", f"output '{name}' data", datatype, str(e)) from None
            return self._reshape(arr, shape, name)
        return None

    @staticmethod
    def _reshape(arr: np.ndarray, shape, name) -> np.ndarray:
        try:
            return arr.reshape(shape)
        except (ValueError, TypeError) as e:
            # element count vs claimed shape disagree: the header lied
            raise IntegrityError(
                "payload_size", "", f"output '{name}'", shape,
                f"{arr.size} elements ({e})") from None

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        """Decode output ``name`` as a numpy array (zero-copy for fixed-width
        binary outputs AND for arena-leased shared-memory outputs); None if
        the output lives in a non-arena shared-memory region."""
        output = self.get_output(name)
        if output is None:
            return None
        return self._decode(output)

    def as_torch(self, name: str, device="cuda") -> Optional[torch.Tensor]:
        """Decode output ``name`` and place it on ``device`` (one H2D copy)."""
        arr = self.as_numpy(name)
        if arr is None:
            return None
        if arr.dtype == np.object_:
            raise InferenceServerException("BYTES outputs cannot be placed on device")
        return numpy_to_tensor(arr, device)
