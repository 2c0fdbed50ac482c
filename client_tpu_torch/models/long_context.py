"""Long-context encoder: one self-attention layer behind the v2 protocol.

The counterpart of ``client_tpu.models.long_context``: ``long_context_encoder``
takes FP32 ``sequence`` [-1, dim] and returns FP32 ``encoded`` [-1, dim] —
four fp32 projections (``torch.matmul``, as the JAX package leaves them to
XLA outside any kernel) around the attention of the model's mode:

- "flash" (the port's default): ``ops.flash_attention``, the Hopper kernel
  on a CUDA device and its plain version on the CPU, on one device, any
  sequence length >= 1 and, as JAX's model, any ``dim`` that ``heads``
  divides (the kernel takes head dims up to 256: Phi-3-mini's 3072 / 32 =
  96 and Gemma-2B's 2048 / 8 = 256 among them);
- "ring", "ulysses" and "auto" (the JAX model's default is "ring"): the
  sequence split over the ``data`` axis of a flat (n, 1) mesh and attended
  by ``parallel.ring`` / ``parallel.ulysses`` (``sequence_parallel_attention``);
  the length must divide by n.

The port keeps "flash" as the default: it is the one-card kernel every
earlier use of the model (and ``serve --long-context``) was built on, and
on a one-card host the mesh modes run on a mesh of one shard.

Weights: the JAX model draws its projections with ``jax.random``, which
torch cannot reproduce. :func:`draw_params` is the port's own seeded draw
(numpy), and :func:`load_jax_params` loads the JAX model's projections,
exported to numpy, so both packages can run on the same weights, in every
mode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from ..parallel import Mesh, take_devices
from ..parallel.ulysses import sequence_parallel_attention
from ..utils import numpy_to_tensor
from .base import Model, TensorSpec

WEIGHTS = ("wq", "wk", "wv", "wo")
MESH_MODES = ("ring", "ulysses", "auto")


def draw_params(dim: int, seed: int) -> Dict[str, np.ndarray]:
    """The port's default projections: four float32 [dim, dim] draws from
    ``np.random.default_rng(seed)`` in the order wq, wk, wv, wo, each
    scaled by ``dim**-0.5`` as the JAX model scales its own."""
    rng = np.random.default_rng(seed)
    scale = np.float32(dim ** -0.5)
    return {name: rng.standard_normal((dim, dim)).astype(np.float32) * scale
            for name in WEIGHTS}


class LongContextEncoder(nn.Module):
    """Multi-head self-attention without bias or norm, for inference:
    x [S, dim] fp32 -> (attention(x wq, x wk, x wv) over ``heads`` heads) wo.
    ``mesh``: attend with the ``attention`` mode's sequence-parallel scheme
    over its ``data`` axis; None: flash attention on x's device."""

    def __init__(self, dim: int = 64, heads: int = 4, device="cuda",
                 mesh: Optional[Mesh] = None, attention: str = "flash"):
        super().__init__()
        if heads < 1 or dim % heads:
            raise ValueError(f"dim {dim} must divide into {heads} heads")
        self.dim = dim
        self.heads = heads
        self.mesh = mesh
        self.attention = attention
        for name in WEIGHTS:
            self.register_parameter(name, nn.Parameter(
                torch.zeros((dim, dim), dtype=torch.float32, device=device),
                requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.shape[0]
        head_dim = self.dim // self.heads

        def project(w):
            return (x @ w).reshape(1, seq, self.heads, head_dim)

        q, k, v = project(self.wq), project(self.wk), project(self.wv)
        if self.mesh is None:
            out = flash_attention(q, k, v)
        else:
            out = sequence_parallel_attention(q, k, v, self.mesh, axis="data",
                                              mode=self.attention).full(x.device)
        return out.reshape(seq, self.dim) @ self.wo


class LongContextEncoderModel(Model):
    """``long_context_encoder``: FP32 [seq, dim] -> attended [seq, dim]."""

    name = "long_context_encoder"

    def __init__(self, dim: int = 64, heads: int = 4, seed: int = 0, n_devices: int = 0,
                 attention: str = "flash", *, device="cuda", mesh: Optional[Mesh] = None):
        """JAX's positional order, ``(dim, heads, seed, n_devices,
        attention)``; the port's own ``device`` and ``mesh`` are keywords.
        ``attention``: "flash" (the port's default, one device, any
        length), or "ring", "ulysses" or "auto" over ``mesh`` (its ``data``
        axis), else over a flat (n, 1) mesh of the first ``n_devices`` of
        ``local_devices(device)`` (0: all of them). Weights come from
        :func:`draw_params` with ``seed`` until :func:`load_jax_params`
        replaces them."""
        super().__init__()
        if attention not in MESH_MODES + ("flash",):
            raise ValueError(f"attention must be ring|ulysses|auto|flash, got {attention!r}")
        if attention == "flash":
            mesh = None
        elif mesh is None:
            mesh = Mesh([[d] for d in take_devices(n_devices, device)], ("data", "model"))
        self.platform = ("pytorch_flash_attention" if mesh is None
                         else f"pytorch_{attention}_attention")
        self._device = (torch.device(device) if mesh is None
                        else mesh.axis_devices("data")[0])
        self.mesh = mesh
        self.encoder = LongContextEncoder(dim, heads, self._device, mesh, attention)
        load_jax_params(self, draw_params(dim, seed))

    @property
    def mesh_degrees(self) -> Optional[Dict[str, int]]:
        return None if self.mesh is None else dict(self.mesh.shape)

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("sequence", "FP32", [-1, self.encoder.dim])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("encoded", "FP32", [-1, self.encoder.dim])]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        x = inputs["sequence"]
        if self.mesh is not None and x.shape[0] % self.mesh.shape["data"] != 0:
            # only the mesh modes split the sequence and need it to divide
            raise ValueError(
                f"sequence length {x.shape[0]} must divide by the mesh's data-axis size "
                f"{self.mesh.shape['data']}")
        if isinstance(x, torch.Tensor):
            # a cuda shared-memory input already on the device is used in place
            x = x.to(self._device, torch.float32)
        else:
            x = numpy_to_tensor(np.asarray(x, dtype=np.float32), self._device)
        # the output stays a device tensor (pinned in a cuda shm region, or
        # brought to the host when the response is encoded)
        return {"encoded": self.encoder(x)}


def load_jax_params(model: LongContextEncoderModel, params: Mapping[str, np.ndarray]) -> None:
    """Copy four float32 [dim, dim] projections (``wq``, ``wk``, ``wv``,
    ``wo``: numpy arrays, e.g. the JAX model's weights through ``np.asarray``)
    into ``model``."""
    encoder = model.encoder
    for name in WEIGHTS:
        arr = np.asarray(params[name])
        if arr.dtype != np.float32 or arr.shape != (encoder.dim, encoder.dim):
            raise ValueError(
                f"{name} must be float32 [{encoder.dim}, {encoder.dim}], got "
                f"{arr.dtype} {list(arr.shape)}")
        getattr(encoder, name).copy_(numpy_to_tensor(arr, "cpu"))
