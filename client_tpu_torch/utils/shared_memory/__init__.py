"""System (POSIX) shared-memory regions for the zero-copy data plane.

The counterpart of ``client_tpu.utils.shared_memory`` (function for function
the reference's ``tritonclient.utils.shared_memory``): create/set/get/destroy
plus the process-global key bookkeeping that makes multiple handles over one
key safe. Backed by ``multiprocessing.shared_memory`` (no C extension).

Flow: create a region here, ``register_system_shared_memory`` it with the
server, point ``InferInput.set_shared_memory`` /
``InferRequestedOutput.set_shared_memory`` at it, and tensor bytes never ride
the wire.
"""

from __future__ import annotations

import threading
from multiprocessing import shared_memory as mpshm
from typing import Any, Dict, List, Optional

import numpy as np

from .. import (
    InferenceServerException,
    serialize_bf16_tensor,
    serialize_byte_tensor,
    triton_to_np_dtype,
)
# data-plane accounting: every lifecycle/map op consults the process-global
# recorder (observe._DATAPLANE); with none installed the cost is one module
# attribute load and a None check per op
from ... import observe as _observe


class SharedMemoryException(InferenceServerException):
    """Raised on shared-memory lifecycle/bounds errors."""


def _posix_name(key: str) -> str:
    # POSIX shm keys are conventionally written "/name"; the stdlib module
    # wants the bare name.
    return key.lstrip("/")


def _untrack(shm: mpshm.SharedMemory) -> None:
    # Python 3.12's resource_tracker registers every mapping (even attaches)
    # and unlinks at process exit; ownership here is explicit, so deregister.
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


# POSIX names created (and therefore legitimately resource-tracked) by this
# process; attaches to these must NOT untrack, or the tracker loses the
# creator's entry (tracker state is a set keyed by name).
_owned_names: set = set()


def attach_shared_memory(key: str) -> mpshm.SharedMemory:
    """Attach to an existing POSIX region without taking unlink ownership."""
    shm = mpshm.SharedMemory(name=_posix_name(key))
    if _posix_name(key) not in _owned_names:
        _untrack(shm)
    return shm


# Mappings whose close() failed because zero-copy numpy views still alias
# them; kept referenced so the views stay valid, retried on later closes,
# unmapped at process exit at the latest.
_deferred_unmaps: List[mpshm.SharedMemory] = []
_deferred_lock = threading.Lock()


def _sweep_deferred() -> None:
    """Retry deferred unmaps whose aliasing views have since died, so a
    register/read/unregister churn does not leak one mapping + fd per cycle."""
    with _deferred_lock:
        parked, _deferred_unmaps[:] = list(_deferred_unmaps), []
    survivors = []
    try:
        for old in parked:
            try:
                # the instance's close was neutralized when parked; go
                # through the class so the retry actually runs
                mpshm.SharedMemory.close(old)
            except BufferError:
                survivors.append(old)
            except Exception:
                survivors.append(old)
    finally:
        with _deferred_lock:
            _deferred_unmaps.extend(survivors)


def _safe_close(shm: mpshm.SharedMemory, unlink: bool) -> None:
    _sweep_deferred()
    if unlink:
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
    try:
        shm.close()
    except BufferError:
        # np.frombuffer views over the mapping are still alive; the POSIX
        # object is already unlinked (if owned) — park the mapping so the
        # views stay valid, neutralize __del__'s retry so it can't raise,
        # and let a later sweep (or process exit) finish the unmap.
        shm.close = lambda: None
        with _deferred_lock:
            _deferred_unmaps.append(shm)


class SharedMemoryRegion:
    """Handle to a created-or-attached system shared-memory region."""

    def __init__(self, triton_shm_name: str, shm_key: str):
        self._triton_shm_name = triton_shm_name
        self._shm_key = shm_key
        self._shm: Optional[mpshm.SharedMemory] = None
        self._byte_size = 0

    @property
    def name(self) -> str:
        return self._triton_shm_name

    @property
    def key(self) -> str:
        return self._shm_key

    @property
    def byte_size(self) -> int:
        return self._byte_size

    def buf(self) -> memoryview:
        if self._shm is None:
            raise SharedMemoryException("shared-memory region is not mapped")
        return self._shm.buf

    def __repr__(self) -> str:
        return (
            f"SharedMemoryRegion(name={self._triton_shm_name!r}, "
            f"key={self._shm_key!r}, byte_size={self._byte_size})"
        )


# Process-global bookkeeping: one underlying mapping may back several handles
# (attach-or-create); unlink only when the last handle is destroyed.
_lock = threading.Lock()
_key_refcount: Dict[str, int] = {}
_active_regions: List[SharedMemoryRegion] = []


def create_shared_memory_region(
    triton_shm_name: str, key: str, byte_size: int, create_only: bool = False
) -> SharedMemoryRegion:
    """Create (or attach to) the POSIX region ``key`` of ``byte_size`` bytes."""
    if byte_size <= 0:
        raise SharedMemoryException("shared-memory byte_size must be positive")
    handle = SharedMemoryRegion(triton_shm_name, key)
    name = _posix_name(key)
    with _lock:
        try:
            # created regions stay resource-tracked: unlink() deregisters, and
            # the tracker cleans up if the process dies before destroy
            handle._shm = mpshm.SharedMemory(name=name, create=True, size=byte_size)
            _owned_names.add(name)
        except FileExistsError:
            if create_only:
                raise SharedMemoryException(
                    f"unable to create the shared memory region with key '{key}': "
                    "already exists"
                )
            try:
                handle._shm = attach_shared_memory(key)
            except FileNotFoundError:
                raise SharedMemoryException(
                    f"unable to attach to shared memory region with key '{key}'"
                )
            if handle._shm.size < byte_size:
                handle._shm.close()
                raise SharedMemoryException(
                    f"existing shared memory region with key '{key}' is smaller "
                    f"({handle._shm.size}B) than requested ({byte_size}B)"
                )
            created = False
        else:
            created = True
        handle._byte_size = byte_size
        _key_refcount[key] = _key_refcount.get(key, 0) + 1
        _active_regions.append(handle)
    rec = _observe._DATAPLANE
    if rec is not None:
        if created:
            rec.on_create("system", byte_size, key=id(handle))
        else:
            rec.on_attach("system", byte_size, key=id(handle))
    return handle


def set_shared_memory_region(
    shm_handle: SharedMemoryRegion, input_values, offset: int = 0
) -> None:
    """Copy each array in ``input_values`` into the region back-to-back."""
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException("input_values must be a list of numpy arrays")
    rec = _observe._DATAPLANE
    if rec is not None:
        rec.on_map("system", write=True)
    cursor = offset
    buf = shm_handle.buf()
    for value in input_values:
        arr = np.asarray(value)
        if arr.dtype == np.object_ or arr.dtype.kind in ("S", "U"):
            s = serialize_byte_tensor(arr)
            payload = s.item() if s.size else b""
        elif arr.dtype == np.dtype(triton_to_np_dtype("BF16")) and arr.dtype != np.float32:
            payload = serialize_bf16_tensor(arr).item()
        else:
            payload = np.ascontiguousarray(arr).tobytes()
        end = cursor + len(payload)
        if end > shm_handle.byte_size:
            raise SharedMemoryException(
                f"unable to set shared memory region: write of {len(payload)}B at "
                f"offset {cursor} exceeds region size {shm_handle.byte_size}B"
            )
        buf[cursor:end] = payload
        cursor = end


def get_contents_as_numpy(
    shm_handle: SharedMemoryRegion, datatype, shape, offset: int = 0
) -> np.ndarray:
    """A numpy view over the region (zero-copy for fixed-width dtypes).

    ``datatype`` may be a numpy dtype or a Triton datatype string.
    """
    rec = _observe._DATAPLANE
    if rec is not None:
        rec.on_map("system", write=False)
    if isinstance(datatype, str):
        np_dtype = np.dtype(triton_to_np_dtype(datatype))
        is_bytes = datatype == "BYTES"
    else:
        np_dtype = np.dtype(datatype)
        is_bytes = np_dtype == np.object_
    buf = shm_handle.buf()
    n_elems = int(np.prod(shape)) if len(shape) else 1
    if is_bytes:
        from .. import deserialize_bytes_tensor

        arr = deserialize_bytes_tensor(
            bytes(buf[offset : shm_handle.byte_size]), count=n_elems
        )
        return arr.reshape(shape)
    nbytes = n_elems * np_dtype.itemsize
    if offset + nbytes > shm_handle.byte_size:
        raise SharedMemoryException(
            f"unable to read {nbytes}B at offset {offset} from region of "
            f"{shm_handle.byte_size}B"
        )
    return np.frombuffer(buf, dtype=np_dtype, count=n_elems, offset=offset).reshape(shape)


def mapped_shared_memory_regions() -> List[str]:
    """Names of regions currently mapped by this process."""
    with _lock:
        return [r.name for r in _active_regions]


def region_inventory() -> List[Dict[str, Any]]:
    """One dict per live handle (name/key/bytes) — the shm inventory a
    doctor snapshot reports beside the data-plane counters."""
    with _lock:
        return [
            {"family": "system", "name": r.name, "key": r.key,
             "byte_size": r.byte_size}
            for r in _active_regions
        ]


def destroy_shared_memory_region(shm_handle: SharedMemoryRegion) -> None:
    """Unmap; unlink the underlying POSIX object when this is the last handle."""
    with _lock:
        if shm_handle._shm is None:
            return
        try:
            _active_regions.remove(shm_handle)
        except ValueError:
            pass
        key = shm_handle.key
        remaining = _key_refcount.get(key, 1) - 1
        if remaining <= 0:
            _key_refcount.pop(key, None)
            _owned_names.discard(_posix_name(key))
        else:
            _key_refcount[key] = remaining
        _safe_close(shm_handle._shm, unlink=remaining <= 0)
        shm_handle._shm = None
    rec = _observe._DATAPLANE
    if rec is not None:
        rec.on_destroy("system", shm_handle.byte_size, key=id(shm_handle))
