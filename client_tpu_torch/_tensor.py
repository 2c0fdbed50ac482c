"""Protocol-neutral tensor value model: InferInput / InferRequestedOutput.

The counterpart of ``client_tpu._tensor``. torch tensors are accepted
wherever numpy arrays are: a CPU tensor is read in place, a CUDA tensor
reaches host bytes by exactly one device->host copy. The bytes each input
stages are identical to the JAX package's for the same values. Inputs and
outputs may hold an arena lease (``client_tpu_torch.arena``), and results
serve zero-copy views over leased output slabs (``ArenaOutputsMixin``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils import (
    InferenceServerException,
    np_to_triton_dtype,
    serialize_bf16_tensor,
    serialize_byte_tensor,
    tensor_to_numpy,
)


def _release_quietly(lease) -> None:
    """Drop one lease reference, tolerating a lease some OTHER holder
    (e.g. ``InferResult.release_arena``) already fully released — the
    convenience release paths are ensure-gone, not strict handoffs."""
    from .arena import ArenaError

    try:
        lease.release()
    except ArenaError:
        pass


class ArenaOutputsMixin:
    """The result-side arena surface shared by the HTTP and GRPC
    ``InferResult`` classes: the frontends attach output leases here when
    requested outputs were bound via ``ArenaLease.bind_output`` /
    ``ShmArena.request_output``, and ``as_numpy`` serves zero-copy views
    through :meth:`_arena_lease_for`."""

    _arena_output_leases: Optional[Dict[str, Any]] = None
    _arena_released = False

    def _arena_lease_for(self, name: str):
        leases = self._arena_output_leases
        return leases.get(name) if leases else None

    def release_arena(self) -> None:
        """Release every output lease bound to this result (idempotent).
        The lease map is kept so a later ``as_numpy`` on one of these
        outputs raises the typed ``ArenaLeaseReleased`` instead of
        silently returning None."""
        if self._arena_released:
            return
        self._arena_released = True
        for lease in (self._arena_output_leases or {}).values():
            _release_quietly(lease)


def _to_host_ndarray(tensor: Any) -> np.ndarray:
    """Materialize ``tensor`` on host as a numpy ndarray with minimal copies."""
    if isinstance(tensor, np.ndarray):
        return tensor
    if isinstance(tensor, torch.Tensor):
        return tensor_to_numpy(tensor)
    return np.asarray(tensor)


def _shm_params(parameters: Dict[str, Any]) -> Optional[Tuple[str, int, int]]:
    """(region, byte_size, offset) of a tensor bound to a shared-memory
    region, else None."""
    region = parameters.get("shared_memory_region")
    if region is None:
        return None
    return (region, parameters.get("shared_memory_byte_size", 0),
            parameters.get("shared_memory_offset", 0))


class InferInput:
    """An input tensor for an inference request."""

    # arena fast path (client_tpu_torch.arena): a lease staged via
    # ``set_data_from_numpy(..., arena=...)`` or ``ArenaLease.bind_input``;
    # re-staging the input releases it
    _arena_lease = None

    def __init__(self, name: str, shape: Sequence[int], datatype: str):
        self._name = name
        self._shape = list(shape)
        self._datatype = datatype
        self._parameters: Dict[str, Any] = {}
        self._raw_data: Optional[bytes] = None
        self._json_data: Optional[List[Any]] = None

    # -- introspection -----------------------------------------------------
    def name(self) -> str:
        return self._name

    def datatype(self) -> str:
        return self._datatype

    def shape(self) -> List[int]:
        return self._shape

    def set_shape(self, shape: Sequence[int]) -> "InferInput":
        self._shape = list(shape)
        return self

    # -- data paths --------------------------------------------------------
    def set_data_from_numpy(self, input_tensor, binary_data: bool = True,
                            arena=None) -> "InferInput":
        """Stage tensor contents in the request (binary blob or JSON list).

        ``input_tensor``: a numpy array or a torch tensor (CPU or CUDA).
        ``arena``: a :class:`client_tpu_torch.arena.ShmArena` — the tensor
        is written ONCE straight into a leased slab and the input binds it
        via shared-memory params (no bytes on the wire); the region's
        server registration is ensured (and cached) at ``infer()`` time.
        The input holds the lease until re-staged or
        :meth:`release_arena_lease` is called."""
        input_tensor = _to_host_ndarray(input_tensor)
        dtype = np_to_triton_dtype(input_tensor.dtype)
        if dtype != self._datatype:
            raise InferenceServerException(
                f"got unexpected datatype {dtype} from numpy array; expected {self._datatype}"
            )
        self._validate_shape(input_tensor)

        if arena is not None:
            if not binary_data:
                raise InferenceServerException(
                    "arena staging requires binary_data=True")
            # BYTES/BF16 serialize exactly once (the payload sizes the
            # lease AND is the write); fixed-width dtypes skip the staging
            # copy entirely — write_numpy copies straight into the slab
            if self._datatype == "BYTES":
                s = serialize_byte_tensor(input_tensor)
                payload = s.item() if s.size else b""
            elif self._datatype == "BF16":
                s = serialize_bf16_tensor(input_tensor)
                payload = s.item() if s.size else b""
            else:
                payload = None
            nbytes = input_tensor.nbytes if payload is None else len(payload)
            lease = arena.lease(max(nbytes, 1))
            try:
                if payload is None:
                    lease.write_numpy(input_tensor)
                else:
                    lease.write(payload)
            except BaseException:
                lease.release()
                raise
            self._json_data = None
            self._raw_data = None
            lease.bind_input(self)  # releases any previous lease
            return self
        self._clear_shared_memory_params()
        self._json_data = None
        self._raw_data = None

        if not binary_data:
            if self._datatype == "BF16":
                raise InferenceServerException(
                    "BF16 inputs must use binary_data=True (no JSON representation)"
                )
            if self._datatype == "BYTES":
                data = []
                for obj in np.nditer(input_tensor, flags=["refs_ok"], order="C"):
                    item = obj.item()
                    if isinstance(item, bytes):
                        try:
                            data.append(item.decode("utf-8"))
                        except UnicodeDecodeError:
                            raise InferenceServerException(
                                "BYTES input with non-UTF8 data requires binary_data=True"
                            )
                    else:
                        data.append(str(item))
                self._json_data = data
            else:
                self._json_data = [v.item() for v in np.nditer(input_tensor, order="C")]
            return self

        if self._datatype == "BYTES":
            serialized = serialize_byte_tensor(input_tensor)
            self._raw_data = serialized.item() if serialized.size > 0 else b""
        elif self._datatype == "BF16":
            serialized = serialize_bf16_tensor(input_tensor)
            self._raw_data = serialized.item() if serialized.size > 0 else b""
        else:
            self._raw_data = np.ascontiguousarray(input_tensor).tobytes()
        self._parameters.pop("binary_data_size", None)
        return self

    def set_shared_memory(self, region_name: str, byte_size: int, offset: int = 0) -> "InferInput":
        """Reference tensor contents in a pre-registered shared-memory region."""
        self.release_arena_lease()
        self._json_data = None
        self._raw_data = None
        self._parameters.pop("binary_data_size", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset != 0:
            self._parameters["shared_memory_offset"] = offset
        return self

    def release_arena_lease(self) -> "InferInput":
        """Release the arena lease this input holds (no-op without one;
        idempotent even if the lease was already released elsewhere).
        Called automatically whenever the input is re-staged."""
        lease = self._arena_lease
        if lease is not None:
            self._arena_lease = None
            _release_quietly(lease)
        return self

    # -- encoder-facing private API ---------------------------------------
    def _validate_shape(self, tensor: np.ndarray) -> None:
        expected = 1
        for d in self._shape:
            expected *= d
        if tensor.size != expected:
            raise InferenceServerException(
                f"got {tensor.size} elements for input '{self._name}', "
                f"expected {expected} (shape {self._shape})"
            )

    def _clear_shared_memory_params(self) -> None:
        self.release_arena_lease()
        for k in ("shared_memory_region", "shared_memory_byte_size", "shared_memory_offset"):
            self._parameters.pop(k, None)

    def _get_binary_data(self) -> Optional[bytes]:
        return self._raw_data

    def _get_tensor_json(self) -> Dict[str, Any]:
        """The HTTP JSON descriptor for this input."""
        tensor: Dict[str, Any] = {
            "name": self._name,
            "shape": self._shape,
            "datatype": self._datatype,
        }
        params = dict(self._parameters)
        if self._raw_data is not None:
            params["binary_data_size"] = len(self._raw_data)
        if params:
            tensor["parameters"] = params
        if self._json_data is not None:
            tensor["data"] = self._json_data
        return tensor

    def _shared_memory_params(self) -> Optional[Tuple[str, int, int]]:
        return _shm_params(self._parameters)


class InferRequestedOutput:
    """A requested output tensor with optional classification / shm placement."""

    # arena fast path: a lease bound via ``ArenaLease.bind_output`` /
    # ``ShmArena.request_output``; the frontends attach it to the
    # InferResult so ``as_numpy`` serves a zero-copy view over the slab
    _arena_lease = None

    def __init__(self, name: str, binary_data: bool = True, class_count: int = 0):
        self._name = name
        self._binary_data = binary_data
        self._class_count = class_count
        self._parameters: Dict[str, Any] = {}

    def name(self) -> str:
        return self._name

    def set_shared_memory(self, region_name: str, byte_size: int, offset: int = 0) -> "InferRequestedOutput":
        self.release_arena_lease()
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset != 0:
            self._parameters["shared_memory_offset"] = offset
        return self

    def unset_shared_memory(self) -> "InferRequestedOutput":
        self.release_arena_lease()
        for k in ("shared_memory_region", "shared_memory_byte_size", "shared_memory_offset"):
            self._parameters.pop(k, None)
        return self

    def release_arena_lease(self) -> "InferRequestedOutput":
        """Release the arena lease this output holds (no-op without one;
        idempotent even if the lease was already released elsewhere)."""
        lease = self._arena_lease
        if lease is not None:
            self._arena_lease = None
            _release_quietly(lease)
        return self

    # -- encoder-facing private API ---------------------------------------
    def _in_shared_memory(self) -> bool:
        return "shared_memory_region" in self._parameters

    def _shared_memory_params(self) -> Optional[Tuple[str, int, int]]:
        return _shm_params(self._parameters)

    def _get_tensor_json(self) -> Dict[str, Any]:
        tensor: Dict[str, Any] = {"name": self._name}
        params = dict(self._parameters)
        if self._class_count != 0:
            params["classification"] = self._class_count
        if not self._in_shared_memory():
            params["binary_data"] = self._binary_data
        if params:
            tensor["parameters"] = params
        return tensor
