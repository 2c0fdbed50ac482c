"""Device ops of the PyTorch port: hand-written Hopper kernels and their
plain PyTorch versions.

Each kernel wrapper launches its CUDA kernel for CUDA tensors (or raises),
takes the plain version only for CPU tensors, and counts its launches in a
:class:`LaunchCounter`, so a run can show that its main path went through the
kernel. As ``client_tpu.ops`` does, the package exposes ``flash_attention``,
``quantize_int8`` and ``dequantize_int8`` by name (so ``ops.flash_attention``
is the function; its module, with the counter and the plain version, is
imported as ``client_tpu_torch.ops.flash_attention``).
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


# after LaunchCounter, which these modules import from the package
from .flash_attention import flash_attention  # noqa: E402
from .quantize import dequantize_int8, quantize_int8  # noqa: E402

__all__ = ["LaunchCounter", "dequantize_int8", "flash_attention", "quantize_int8"]
