"""Image and classification ops around the kernels (the counterparts of the
non-Pallas ops of ``client_tpu.ops``): nearest resize, the ensemble's
preprocess, top-k classification, bf16 casts and host-to-device staging.

They are PyTorch calls on the tensor's own device, except that
:func:`preprocess_image` scales through ``normalize_image``, the Hopper
kernel on a CUDA tensor (the JAX package computes that step in plain XLA;
the results are the same).
"""

from __future__ import annotations

import numpy as np
import torch

from .normalize import normalize_image


def _nearest_indices(size: int, out_size: int, device) -> torch.Tensor:
    """``clip(int(i * f32(size / out_size) + 0.5), 0, size - 1)`` with the
    multiply-add rounded once to float32 (XLA fuses it, as in the JAX op)."""
    ratio = float(np.float32(size / out_size))
    exact = torch.arange(out_size, dtype=torch.float64, device=device) * ratio + 0.5
    return exact.float().to(torch.int64).clamp_(0, size - 1)


def resize_nearest(img, out_h: int = 224, out_w: int = 224):
    """Nearest-neighbour resize of an HWC image (any dtype) by two index
    selections; the pixels are copied, never interpolated."""
    h, w = img.shape[0], img.shape[1]
    ys = _nearest_indices(h, out_h, img.device)
    xs = _nearest_indices(w, out_w, img.device)
    return img.index_select(0, ys).index_select(1, xs)


def preprocess_image(img, out_h: int = 224, out_w: int = 224, scale: float = 2.0 / 255.0,
                     shift: float = -1.0, out_dtype=torch.float32):
    """resize -> ``normalize_image`` -> HWC to CHW: the ensemble's front
    stage. ``img`` is HWC float32, bfloat16 or uint8; the result is a
    contiguous CHW tensor on ``img``'s device."""
    x = resize_nearest(img, out_h, out_w)
    x = normalize_image(x, scale=scale, shift=shift, out_dtype=torch.float32)
    return x.permute(2, 0, 1).contiguous().to(out_dtype)


def topk_classification(logits, k: int):
    """(values, indices) of the top-k logits along the last axis, ranked on
    the logits' device, ties lowest index first, as ``jax.lax.top_k`` ranks
    them: a stable descending sort, cut to k (``torch.topk`` promises no
    order among ties)."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def to_bf16(x):
    """bfloat16 cast (round to nearest even)."""
    return x.to(torch.bfloat16)


def from_bf16(x):
    """bfloat16 -> float32."""
    return x.to(torch.float32)


def stage_to_device(host_array, device="cuda"):
    """Asynchronous host -> device copy of a tensor or numpy array (returns
    at once; work queued after it on the device's stream sees the data)."""
    t = host_array if isinstance(host_array, torch.Tensor) else torch.from_numpy(
        np.asarray(host_array))
    return t.to(device, non_blocking=True)
