"""ctypes implementation of the DLPack ABI for shared-memory interop.

Lets a raw host window (a shared-memory region slice) act as a DLPack
*producer* so torch and numpy can consume it zero-copy:
``np.from_dlpack(SharedMemoryTensor(...))`` or
``torch.from_dlpack(...)``. A copy of ``client_tpu.utils._dlpack``; its
consumer in the port is the cuda shm host window
(``cuda_shared_memory.as_shared_memory_tensor``).
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Sequence, Tuple

from . import InferenceServerException

_c_str_dltensor = b"dltensor"
_c_str_used_dltensor = b"used_dltensor"


class DLDevice(ctypes.Structure):
    _fields_ = [("device_type", ctypes.c_int32), ("device_id", ctypes.c_int32)]


class DLDataType(ctypes.Structure):
    _fields_ = [
        ("type_code", ctypes.c_uint8),
        ("bits", ctypes.c_uint8),
        ("lanes", ctypes.c_uint16),
    ]


class DLTensor(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("device", DLDevice),
        ("ndim", ctypes.c_int32),
        ("dtype", DLDataType),
        ("shape", ctypes.POINTER(ctypes.c_int64)),
        ("strides", ctypes.POINTER(ctypes.c_int64)),
        ("byte_offset", ctypes.c_uint64),
    ]


class DLManagedTensor(ctypes.Structure):
    pass


_DELETER_TYPE = ctypes.CFUNCTYPE(None, ctypes.POINTER(DLManagedTensor))

DLManagedTensor._fields_ = [
    ("dl_tensor", DLTensor),
    ("manager_ctx", ctypes.c_void_p),
    ("deleter", _DELETER_TYPE),
]

# DLDeviceType values (dlpack.h)
kDLCPU = 1
kDLCUDA = 2

# DLDataTypeCode values
kDLInt = 0
kDLUInt = 1
kDLFloat = 2
kDLBfloat = 4
kDLBool = 6

_TRITON_TO_DL = {
    "BOOL": (kDLBool, 8),
    "INT8": (kDLInt, 8),
    "INT16": (kDLInt, 16),
    "INT32": (kDLInt, 32),
    "INT64": (kDLInt, 64),
    "UINT8": (kDLUInt, 8),
    "UINT16": (kDLUInt, 16),
    "UINT32": (kDLUInt, 32),
    "UINT64": (kDLUInt, 64),
    "FP16": (kDLFloat, 16),
    "FP32": (kDLFloat, 32),
    "FP64": (kDLFloat, 64),
    "BF16": (kDLBfloat, 16),
}


def triton_to_dlpack_dtype(dtype: str) -> DLDataType:
    entry = _TRITON_TO_DL.get(dtype)
    if entry is None:
        raise InferenceServerException(f"datatype '{dtype}' has no DLPack representation")
    code, bits = entry
    return DLDataType(code, bits, 1)


# Keep every exported manager alive until its deleter runs.
_live_managers: dict = {}


class _Manager:
    """Owns the ctypes storage for one exported DLManagedTensor."""

    def __init__(self, owner: Any, shape: Sequence[int]):
        self.owner = owner  # keeps the memory mapping alive
        n = len(shape)
        self.shape_arr = (ctypes.c_int64 * max(n, 1))(*([int(s) for s in shape] or [0]))
        self.managed = DLManagedTensor()

        live = _live_managers  # bound here: the deleter may run at shutdown

        def _deleter(ptr):
            live.pop(id(self), None)

        self._deleter_ref = _DELETER_TYPE(_deleter)


_pycapsule_new = ctypes.pythonapi.PyCapsule_New
_pycapsule_new.restype = ctypes.py_object
_pycapsule_new.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p]

_pycapsule_is_valid = ctypes.pythonapi.PyCapsule_IsValid
_pycapsule_is_valid.restype = ctypes.c_int
_pycapsule_is_valid.argtypes = [ctypes.py_object, ctypes.c_char_p]

_pycapsule_get_pointer = ctypes.pythonapi.PyCapsule_GetPointer
_pycapsule_get_pointer.restype = ctypes.c_void_p
_pycapsule_get_pointer.argtypes = [ctypes.py_object, ctypes.c_char_p]

# Raw-pointer variants for use inside the capsule destructor (separate PyDLL
# handle so the py_object argtypes above are untouched).
_capsule_api = ctypes.PyDLL(None)
_raw_is_valid = _capsule_api.PyCapsule_IsValid
_raw_is_valid.restype = ctypes.c_int
_raw_is_valid.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
_raw_get_pointer = _capsule_api.PyCapsule_GetPointer
_raw_get_pointer.restype = ctypes.c_void_p
_raw_get_pointer.argtypes = [ctypes.c_void_p, ctypes.c_char_p]

_PYCAPSULE_DESTRUCTOR = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


@_PYCAPSULE_DESTRUCTOR
def _capsule_destructor(capsule_ptr):
    # DLPack contract: if the capsule is garbage-collected while still named
    # 'dltensor' (never consumed), the producer must invoke the deleter.
    try:
        if _raw_is_valid(capsule_ptr, _c_str_dltensor):
            ptr = _raw_get_pointer(capsule_ptr, _c_str_dltensor)
            if ptr:
                managed = ctypes.cast(ptr, ctypes.POINTER(DLManagedTensor))
                if managed.contents.deleter:
                    managed.contents.deleter(managed)
    except Exception:
        pass


def make_capsule(
    data_ptr: int,
    dtype: str,
    shape: Sequence[int],
    owner: Any,
    device: Tuple[int, int] = (kDLCPU, 0),
):
    """Build a 'dltensor' PyCapsule over raw contiguous memory at ``data_ptr``.

    ``owner`` is any object whose lifetime must cover the capsule's (e.g. the
    shared-memory mapping).
    """
    mgr = _Manager(owner, shape)
    t = mgr.managed.dl_tensor
    t.data = ctypes.c_void_p(data_ptr)
    t.device = DLDevice(device[0], device[1])
    t.ndim = len(shape)
    t.dtype = triton_to_dlpack_dtype(dtype)
    t.shape = ctypes.cast(mgr.shape_arr, ctypes.POINTER(ctypes.c_int64))
    t.strides = None  # NULL => compact row-major
    t.byte_offset = 0
    mgr.managed.manager_ctx = None
    mgr.managed.deleter = mgr._deleter_ref
    _live_managers[id(mgr)] = mgr
    return _pycapsule_new(
        ctypes.cast(ctypes.byref(mgr.managed), ctypes.c_void_p),
        _c_str_dltensor,
        ctypes.cast(_capsule_destructor, ctypes.c_void_p),
    )


def managed_tensor_from_capsule(capsule) -> DLManagedTensor:
    """Borrow the DLManagedTensor from a 'dltensor' capsule (for inspection)."""
    if not _pycapsule_is_valid(capsule, _c_str_dltensor):
        raise InferenceServerException("invalid or already-consumed dltensor capsule")
    ptr = _pycapsule_get_pointer(capsule, _c_str_dltensor)
    return ctypes.cast(ptr, ctypes.POINTER(DLManagedTensor)).contents


class SharedMemoryTensor:
    """DLPack producer over a slice of a host shared-memory region.

    Implements ``__dlpack__``/``__dlpack_device__`` so the region can be
    consumed directly by ``np.from_dlpack`` or ``torch.from_dlpack``
    without copying the payload.
    """

    def __init__(
        self,
        data_ptr: int,
        dtype: str,
        shape: Sequence[int],
        owner: Any,
        device: Tuple[int, int] = (kDLCPU, 0),
    ):
        self._data_ptr = data_ptr
        self._dtype = dtype
        self._shape = list(shape)
        self._owner = owner
        self._device = device

    def __dlpack__(self, stream: Optional[int] = None, **kwargs):
        return make_capsule(
            self._data_ptr, self._dtype, self._shape, self._owner, self._device
        )

    def __dlpack_device__(self) -> Tuple[int, int]:
        return self._device

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._shape)

    @property
    def triton_dtype(self) -> str:
        return self._dtype
