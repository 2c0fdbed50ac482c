"""Device ops of the PyTorch port: hand-written Hopper kernels and their
plain PyTorch versions.

Each kernel wrapper launches its CUDA kernel for CUDA tensors (or raises),
takes the plain version only for CPU tensors, and counts its launches in a
:class:`LaunchCounter`, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """A thread-safe count of kernel launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def add(self) -> None:
        with self._lock:
            self._count += 1

    def reset(self) -> None:
        with self._lock:
            self._count = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count
