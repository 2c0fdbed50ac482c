"""Device ops of the PyTorch port: hand-written Hopper kernels and their
plain PyTorch versions.

Each kernel wrapper launches its CUDA kernel for CUDA tensors (or raises),
takes the plain version only for CPU tensors, and counts its launches in a
:class:`LaunchCounter`, so a run can show that its main path went through the
kernel. The plain versions take every dtype of ``PLAIN_DTYPES``, as the JAX
ops do, and so does every kernel, the attention kernels at any head dim
(integer and bool attention follows JAX's key tiles, on which its result
depends). What a wrapper refuses on a CUDA tensor is what the JAX op
refuses on any device: other dtypes, mixed dtypes, bad shapes and (flash)
block sizes the sequence cannot be cut into.

As ``client_tpu.ops`` does, the package exposes its ops by name:
``flash_attention``, ``normalize_image``, ``softmax_probabilities``,
``quantize_int8`` / ``dequantize_int8``, and the image and classification
ops of :mod:`.image` (``resize_nearest``, ``preprocess_image``,
``topk_classification``, ``to_bf16`` / ``from_bf16``, ``stage_to_device``).
So ``ops.flash_attention`` is the function; its module, with the counter
and the plain version, is imported as ``client_tpu_torch.ops.flash_attention``.
The launch counters of the other kernels are ``ops.normalize.LAUNCHES``,
``ops.softmax.LAUNCHES`` and ``ops.quantize.QUANTIZE_LAUNCHES`` /
``DEQUANTIZE_LAUNCHES``.
"""

from __future__ import annotations

import threading

import torch

# the dtypes the plain versions take on the CPU: those the JAX package's ops
# compute (its 64-bit types are off, so no float64 or int64 reaches them)
PLAIN_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
                torch.float16, torch.bfloat16, torch.float32)


def _names(dtypes) -> str:
    return ", ".join(str(d).replace("torch.", "") for d in dtypes)


def check_plain_dtype(op: str, dtype) -> None:
    """Raise ``TypeError`` unless ``dtype`` is one of ``PLAIN_DTYPES``."""
    if dtype not in PLAIN_DTYPES:
        raise TypeError(f"{op} takes {_names(PLAIN_DTYPES)}, not {dtype}")


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
from .image import (  # noqa: E402
    from_bf16,
    preprocess_image,
    resize_nearest,
    stage_to_device,
    to_bf16,
    topk_classification,
)
from .normalize import normalize_image  # noqa: E402
from .quantize import dequantize_int8, quantize_int8  # noqa: E402
from .softmax import softmax_probabilities  # noqa: E402

__all__ = [
    "LaunchCounter",
    "PLAIN_DTYPES",
    "dequantize_int8",
    "flash_attention",
    "from_bf16",
    "normalize_image",
    "preprocess_image",
    "quantize_int8",
    "resize_nearest",
    "softmax_probabilities",
    "stage_to_device",
    "to_bf16",
    "topk_classification",
]
