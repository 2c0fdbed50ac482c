"""CUDA shared memory: the zero-copy device data plane.

The counterpart of ``client_tpu.utils.tpu_shared_memory``, with the
function names of the reference's ``tritonclient.utils.cuda_shared_memory``
(``set_shared_memory_region_from_torch`` and ``get_contents_as_torch`` take
the place of the TPU package's ``..._from_jax`` / ``..._as_jax``). The design
is the TPU package's:

- A region is a **POSIX host window + device-entry cache**: the host window
  is a ``multiprocessing.shared_memory`` mapping (the cross-process
  transport), and the cache pins live CUDA tensors keyed by region offset.
- **Same process** (the in-process server, or any program embedding both
  client and server): registering the raw handle resolves to the very same
  region object, so a tensor bound with ``set_shared_memory_region_from_torch``
  reaches the model as that CUDA tensor itself, with zero copies.
- **Cross process**: the raw handle (base64 JSON descriptor carrying the
  host window's ``shm_key``) lets the peer attach the window; the transfer is
  one D2H copy on set and one H2D copy on get. The descriptor is the one the
  JAX package's server reads for its cuda family.
- ``colocated=True`` regions skip host mirroring on device writes: when both
  ends share the process, tensors never leave device memory.
- ``as_shared_memory_tensor`` exposes the host window as a DLPack producer
  (``torch.from_dlpack`` / ``np.from_dlpack`` consume it zero-copy) and
  ``set_shared_memory_region_from_dlpack`` ingests any producer, as in the
  TPU package; ``region_inventory`` lists this process's regions.

Export of real device memory through ``cudaIpcGetMemHandle`` is not done
here: like the TPU package, a region crosses processes through its host
window.
"""

from __future__ import annotations

import base64
import ctypes
import json
import threading
import uuid as _uuid
from multiprocessing import shared_memory as mpshm
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import (
    np_to_triton_dtype,
    numpy_to_tensor,
    serialize_byte_tensor,
    tensor_to_numpy,
    torch_to_triton_dtype,
    triton_to_np_dtype,
)
from ... import observe as _observe
from .._dlpack import SharedMemoryTensor, kDLCPU
from ..shared_memory import (
    SharedMemoryException,
    _owned_names,
    _posix_name,
    _safe_close,
    attach_shared_memory,
)


def _record_map(write: bool) -> None:
    # data-plane accounting, family "cuda": one op per public map-level
    # call; with no recorder installed one attribute load and a None check
    rec = _observe._DATAPLANE
    if rec is not None:
        rec.on_map("cuda", write)


def _as_u8(arr) -> np.ndarray:
    """Flat uint8 view of any host array (handles bfloat16 and friends)."""
    return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)


def _tensor_nbytes(tensor: torch.Tensor) -> int:
    return tensor.element_size() * tensor.numel()


class CudaSharedMemoryRegion:
    """A CUDA shared-memory region: host window + device-entry cache."""

    def __init__(
        self,
        triton_shm_name: str,
        shm_key: str,
        byte_size: int,
        device_id: int = 0,
        colocated: bool = False,
        device: str = "cuda",
    ):
        if device not in ("cuda", "cpu"):
            raise SharedMemoryException(
                f"cuda shared-memory device must be 'cuda' or 'cpu', got {device!r}")
        self._triton_shm_name = triton_shm_name
        self._shm_key = shm_key
        self._byte_size = byte_size
        self._device_id = device_id
        self._colocated = colocated
        self._device_type = device
        self._uuid = _uuid.uuid4().hex
        self._shm = None
        # False for cross-process attachments: another process can mutate the
        # host window invisibly, so pinned device entries must not be trusted
        self._cache_enabled = True
        # offset -> (tensor, nbytes); authoritative over the host window for
        # its byte range until flushed or overwritten
        self._device_entries: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._lock = threading.RLock()

    # -- accessors ---------------------------------------------------------
    @property
    def name(self) -> str:
        return self._triton_shm_name

    @property
    def shm_key(self) -> str:
        return self._shm_key

    @property
    def byte_size(self) -> int:
        return self._byte_size

    @property
    def device_id(self) -> int:
        return self._device_id

    @property
    def colocated(self) -> bool:
        return self._colocated

    def device(self) -> torch.device:
        if self._device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self._device_id)

    def _host_buf(self) -> memoryview:
        if self._shm is None:
            raise SharedMemoryException(
                f"cuda shared-memory region '{self._triton_shm_name}' is not mapped"
            )
        return self._shm.buf

    def host_buffer(self) -> memoryview:
        """The raw mapped host window. Does NOT flush cached device entries;
        use :meth:`read_host` for a coherent view."""
        return self._host_buf()

    def _check(self, nbytes: int, offset: int, op: str) -> None:
        if offset < 0 or nbytes < 0 or offset + nbytes > self._byte_size:
            raise SharedMemoryException(
                f"cuda shared-memory {op} of {nbytes}B at offset {offset} exceeds "
                f"region '{self._triton_shm_name}' ({self._byte_size}B)"
            )

    # -- device-entry cache ------------------------------------------------
    def _invalidate_overlapping(self, offset: int, nbytes: int) -> None:
        with self._lock:
            for off, (_, n) in list(self._device_entries.items()):
                if off < offset + nbytes and offset < off + n:
                    del self._device_entries[off]

    def _flush_overlapping(self, offset: int, nbytes: int) -> None:
        """Materialize overlapping device entries into the host window."""
        with self._lock:
            for off, (tensor, n) in list(self._device_entries.items()):
                if off < offset + nbytes and offset < off + n:
                    self._host_buf()[off : off + n] = _as_u8(tensor_to_numpy(tensor))[:n]
                    del self._device_entries[off]

    def _cache_device_entry(self, offset: int, tensor: torch.Tensor, nbytes: int) -> None:
        if not self._cache_enabled:
            return
        with self._lock:
            self._invalidate_overlapping(offset, nbytes)
            self._device_entries[offset] = (tensor, nbytes)

    def _device_entry(self, offset: int, nbytes: int) -> Optional[torch.Tensor]:
        if not self._cache_enabled:
            return None
        with self._lock:
            hit = self._device_entries.get(offset)
            if hit is not None and hit[1] == nbytes:
                return hit[0]
        return None

    # -- host paths (used by servers and byte-level access) ----------------
    def read_host(self, byte_size: int, offset: int = 0) -> memoryview:
        self._check(byte_size, offset, "read")
        self._flush_overlapping(offset, byte_size)
        return self._host_buf()[offset : offset + byte_size]

    def write_host(self, data, offset: int = 0) -> None:
        data = memoryview(data).cast("B")
        self._check(len(data), offset, "write")
        self._invalidate_overlapping(offset, len(data))
        self._host_buf()[offset : offset + len(data)] = data

    def detach(self) -> None:
        """Release a cross-process attachment (no-op for owned/in-process
        regions, whose lifetime belongs to their creator)."""
        if not self._cache_enabled and self._shm is not None:
            _safe_close(self._shm, unlink=False)
            self._shm = None
            rec = _observe._DATAPLANE
            if rec is not None:  # residency ended: accounted as a destroy
                rec.on_destroy("cuda", self._byte_size, key=id(self))

    def host_address(self, offset: int = 0) -> int:
        """Raw address of the host window at ``offset`` (for DLPack export)."""
        buf = self._host_buf()
        return ctypes.addressof(ctypes.c_char.from_buffer(buf)) + offset


# Process-global registry: in-process attach resolves to the same region
# object, which is what makes the zero-copy device handover possible.
_lock = threading.Lock()
_registry: Dict[str, CudaSharedMemoryRegion] = {}


def allocated_shared_memory_regions() -> List[str]:
    with _lock:
        return [r.name for r in _registry.values()]


def region_inventory() -> List[Dict[str, Any]]:
    """One dict per region allocated by this process (doctor inventory)."""
    with _lock:
        regions = list(_registry.values())
    return [
        {"family": "cuda", "name": r.name, "key": r.shm_key,
         "byte_size": r.byte_size, "device_id": r.device_id,
         "colocated": r.colocated,
         "device_entries": len(r._device_entries)}
        for r in regions
    ]


def create_shared_memory_region(
    triton_shm_name: str,
    byte_size: int,
    device_id: int = 0,
    colocated: bool = False,
    key: Optional[str] = None,
    device: str = "cuda",
) -> CudaSharedMemoryRegion:
    """Allocate a region: a POSIX host window bound to ``device``
    (``"cuda"`` = CUDA device ``device_id``; ``"cpu"`` for CPU-only runs).

    ``colocated=True`` promises that producer and consumer share this
    process; device writes then skip host mirroring.
    """
    if byte_size <= 0:
        raise SharedMemoryException("cuda shared-memory byte_size must be positive")
    shm_key = key or f"cudashm_{_uuid.uuid4().hex[:12]}"
    region = CudaSharedMemoryRegion(
        triton_shm_name, shm_key, byte_size, device_id, colocated, device)
    try:
        region._shm = mpshm.SharedMemory(name=shm_key, create=True, size=byte_size)
        _owned_names.add(_posix_name(shm_key))
    except FileExistsError:
        raise SharedMemoryException(
            f"unable to create cuda shared-memory region: key '{shm_key}' exists"
        )
    with _lock:
        _registry[shm_key] = region
    rec = _observe._DATAPLANE
    if rec is not None:
        rec.on_create("cuda", byte_size, key=id(region))
    return region


def get_raw_handle(shm_handle: CudaSharedMemoryRegion) -> str:
    """Serializable descriptor (base64 JSON) carrying the host window's key."""
    desc = {
        "kind": "cuda_shared_memory",
        "shm_key": shm_handle.shm_key,
        "byte_size": shm_handle.byte_size,
        "device_id": shm_handle.device_id,
        "uuid": shm_handle._uuid,
        "colocated": shm_handle.colocated,
    }
    return base64.b64encode(json.dumps(desc).encode("utf-8")).decode("ascii")


def attach_from_raw_handle(raw_handle: str, device: str = "cuda") -> CudaSharedMemoryRegion:
    """Attach to a region from its raw handle.

    Same process: returns the *original* region object (device cache and all).
    Other process: maps the host window read/write; tensors read from it are
    placed on ``device``.
    """
    try:
        desc = json.loads(base64.b64decode(raw_handle))
        shm_key = desc["shm_key"]
    except Exception as e:
        raise SharedMemoryException(f"invalid cuda shared-memory raw handle: {e}")
    with _lock:
        existing = _registry.get(shm_key)
    if existing is not None:
        return existing
    region = CudaSharedMemoryRegion(
        desc.get("name", shm_key),
        shm_key,
        int(desc["byte_size"]),
        int(desc.get("device_id", 0)),
        bool(desc.get("colocated", False)),
        device,
    )
    region._cache_enabled = False  # cross-process: host window is truth
    try:
        region._shm = attach_shared_memory(shm_key)
    except FileNotFoundError:
        raise SharedMemoryException(
            f"unable to attach cuda shared-memory region with key '{shm_key}'"
        )
    rec = _observe._DATAPLANE
    if rec is not None:
        rec.on_attach("cuda", region.byte_size, key=id(region))
    return region


def set_shared_memory_region(
    shm_handle: CudaSharedMemoryRegion, input_values, offset: int = 0
) -> None:
    """Copy host arrays into the region back-to-back (BYTES/BF16-aware).

    torch tensors are accepted and routed through the device cache instead
    (keeping the tensor live and mirroring to host unless colocated).
    """
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException("input_values must be a list of arrays")
    _record_map(write=True)
    cursor = offset
    for value in input_values:
        if isinstance(value, torch.Tensor):
            cursor = _set_from_torch(shm_handle, value, cursor)
            continue
        arr = np.asarray(value)
        if arr.dtype == np.object_ or arr.dtype.kind in ("S", "U"):
            s = serialize_byte_tensor(arr)
            payload = memoryview(s.item() if s.size else b"")
        else:
            payload = _as_u8(arr)
        shm_handle.write_host(payload, cursor)
        cursor += len(payload)


def set_shared_memory_region_from_torch(
    shm_handle: CudaSharedMemoryRegion, tensor: torch.Tensor, offset: int = 0
) -> int:
    """Bind a torch tensor into the region at ``offset``; returns the end offset.

    The tensor is pinned in the region's cache (in-process consumers get it
    back with zero copies). Unless the region is colocated, the bytes are
    also mirrored into the host window for cross-process consumers — one D2H
    copy, the same hop the reference's cudashm pays in ``cudaMemcpy``.
    """
    _record_map(write=True)
    return _set_from_torch(shm_handle, tensor, offset)


def _set_from_torch(shm_handle, tensor, offset=0) -> int:
    if not tensor.is_contiguous():
        tensor = tensor.contiguous()
    nbytes = _tensor_nbytes(tensor)
    shm_handle._check(nbytes, offset, "write")
    shm_handle._cache_device_entry(offset, tensor, nbytes)
    if not shm_handle.colocated or not shm_handle._cache_enabled:
        shm_handle._host_buf()[offset : offset + nbytes] = _as_u8(tensor_to_numpy(tensor))
    return offset + nbytes


def set_shared_memory_region_from_dlpack(
    shm_handle: CudaSharedMemoryRegion, tensor, offset: int = 0
) -> None:
    """Ingest any ``__dlpack__`` producer: a torch tensor is bound through
    the device cache (as ``set_shared_memory_region_from_torch``), any
    other producer (numpy, a host DLPack tensor) is copied into the host
    window."""
    _record_map(write=True)
    if isinstance(tensor, torch.Tensor):
        _set_from_torch(shm_handle, tensor, offset)
        return
    try:
        arr = np.from_dlpack(tensor)
    except Exception as e:
        raise SharedMemoryException(f"cannot consume dlpack tensor: {e}")
    shm_handle.write_host(memoryview(np.ascontiguousarray(arr)).cast("B"), offset)


def get_contents_as_numpy(
    shm_handle: CudaSharedMemoryRegion, datatype, shape, offset: int = 0
) -> np.ndarray:
    """Host view of the region contents (flushes device entries first)."""
    _record_map(write=False)
    if isinstance(datatype, str):
        triton_dtype = datatype
    else:
        triton_dtype = np_to_triton_dtype(np.dtype(datatype))
    n_elems = int(np.prod(shape)) if len(shape) else 1
    if triton_dtype == "BYTES":
        from .. import deserialize_bytes_tensor

        raw = shm_handle.read_host(shm_handle.byte_size - offset, offset)
        return deserialize_bytes_tensor(bytes(raw), count=n_elems).reshape(shape)
    np_dtype = np.dtype(triton_to_np_dtype(triton_dtype))
    nbytes = n_elems * np_dtype.itemsize
    raw = shm_handle.read_host(nbytes, offset)
    return np.frombuffer(raw, dtype=np_dtype, count=n_elems).reshape(shape)


def get_contents_as_torch(
    shm_handle: CudaSharedMemoryRegion, datatype: str, shape, offset: int = 0
) -> torch.Tensor:
    """Device view of the region contents (``datatype``: a Triton string).

    Cache hit (the producer was a torch tensor in this process): returns the
    pinned tensor — zero copies. Otherwise: one H2D copy from the host
    window onto the region's device.
    """
    _record_map(write=False)
    np_dtype = np.dtype(triton_to_np_dtype(datatype))
    n_elems = int(np.prod(shape)) if len(shape) else 1
    nbytes = n_elems * np_dtype.itemsize
    shm_handle._check(nbytes, offset, "read")
    cached = shm_handle._device_entry(offset, nbytes)
    if cached is not None and torch_to_triton_dtype(cached.dtype) == datatype:
        return cached.reshape(shape)
    host = np.frombuffer(
        shm_handle.read_host(nbytes, offset), dtype=np_dtype, count=n_elems
    ).reshape(shape)
    out = numpy_to_tensor(host, shm_handle.device())
    # the result must not alias the host window (.to(cuda) already copied)
    return out.clone() if out.device.type == "cpu" else out


def as_shared_memory_tensor(
    shm_handle: CudaSharedMemoryRegion, datatype: str, shape: Sequence[int], offset: int = 0
) -> SharedMemoryTensor:
    """Expose the host window as a DLPack producer (``torch.from_dlpack`` and
    ``np.from_dlpack`` consume it zero-copy); overlapping device entries are
    flushed into the window first."""
    _record_map(write=False)
    np_dtype = np.dtype(triton_to_np_dtype(datatype))
    n_elems = int(np.prod(shape)) if len(shape) else 1
    nbytes = n_elems * np_dtype.itemsize
    shm_handle._check(nbytes, offset, "read")
    shm_handle._flush_overlapping(offset, nbytes)
    return SharedMemoryTensor(
        shm_handle.host_address(offset), datatype, shape, owner=shm_handle,
        device=(kDLCPU, 0),
    )


def destroy_shared_memory_region(shm_handle: CudaSharedMemoryRegion) -> None:
    """Drop device entries, unmap the window, unlink if we created it."""
    with _lock:
        owned = _registry.pop(shm_handle.shm_key, None) is not None
    with shm_handle._lock:
        shm_handle._device_entries.clear()
    if shm_handle._shm is not None:
        if owned:
            _owned_names.discard(_posix_name(shm_handle.shm_key))
        _safe_close(shm_handle._shm, unlink=owned)
        shm_handle._shm = None
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_destroy("cuda", shm_handle.byte_size, key=id(shm_handle))

