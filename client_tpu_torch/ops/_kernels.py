"""Build and load the port's hand-written CUDA kernels.

Every ``client_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of their
source and flags, at first use (or by :func:`build_all`). Nothing builds when
a module is imported, so the package imports on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills in the log
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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
    src = sources()[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
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


def loaded() -> List[str]:
    """Names of the kernel libraries loaded in this process."""
    with _lock:
        return sorted(_libs)
