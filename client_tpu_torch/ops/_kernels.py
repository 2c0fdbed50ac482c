"""Build and load the port's hand-written CUDA kernels.

Every ``client_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of their
source, the shared headers (``csrc/*.cuh``) and the flags, at first use
(or by :func:`build_all`). Nothing builds when a module is imported, so the
package imports on machines with no ``nvcc``.

A wrapper reaches its entry point through :func:`function`, which sets the
ctypes signature once, and calls it through :func:`launch`, the one launch
path of every wrapper: it passes the tensor's device's current stream as a
raw handle, makes the device current only when it is not already, raises
on a launch error and counts the launch. :func:`sm_count` reads a device's
SM count once, for the wrappers that size their grids from it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills in the log
]

# the H100's SM count: the default of the grid and split plans, which take
# the card's own count from sm_count on the card
H100_SMS = 132

# the element-type codes the kernels take (dispatch_input in
# csrc/elementwise.cuh; the attention kernels take the first three): every
# dtype of ops.PLAIN_DTYPES, a bool read as its byte
ELEMENT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.uint8: 3,
                 torch.int8: 4, torch.int16: 5, torch.int32: 6, torch.bool: 7}
FLOAT_CODES = {dtype: code for dtype, code in ELEMENT_CODES.items() if dtype.is_floating_point}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_sm_counts: Dict[int, int] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit is "
        "installed")


def sources() -> Dict[str, Path]:
    """Kernel name (source stem) -> source path."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: named by a hash of its
    source, every header beside it (``csrc/*.cuh``, which a source may
    include) and the flags."""
    parts = [sources()[name].read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing: one ``nvcc`` per
    source, all started together. Returns name -> compiler log for the
    sources built now; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    started: List = []
    try:
        for name, src in sources().items():
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started.append((name, proc, tmp, target))
        logs: Dict[str, str] = {}
        failures = []
        for name, proc, tmp, target in started:
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)  # atomic: concurrent builds agree
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        return logs
    finally:
        for _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """Entry point ``symbol`` of kernel library ``name`` (built and loaded
    on first use), its ``argtypes`` set and ``restype`` int (a
    ``cudaError_t``) the first time it is asked for."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def launch(fn: ctypes._CFuncPtr, counter, tensor: torch.Tensor, *args) -> None:
    """Launch a kernel: ``fn(*args, stream)`` on the CUDA device of
    ``tensor``, with that device's current stream, then add one to
    ``counter``. The device is made current only when it is not already.
    Raises if ``fn`` returns a ``cudaError_t`` other than 0 (nothing is
    counted then)."""
    index = tensor.get_device()
    # torch.cuda.current_stream(index).cuda_stream builds a torch.cuda.Stream
    # object on every call to hand out this integer; the private
    # _cuda_getCurrentRawStream returns the raw handle alone (PyTorch's own
    # generated kernels launch with it), and no public call does
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {err}")
    counter.add()


def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once per device."""
    count = _sm_counts.get(index)
    if count is None:
        count = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return count


def loaded() -> List[str]:
    """Names of the kernel libraries loaded in this process."""
    with _lock:
        return sorted(_libs)
