"""Long-context encoder: one self-attention layer behind the v2 protocol.

The counterpart of ``client_tpu.models.long_context`` in its flash mode:
``long_context_encoder`` takes FP32 ``sequence`` [-1, dim] and returns FP32
``encoded`` [-1, dim] — four fp32 projections (``torch.matmul``, as the JAX
package leaves them to XLA outside any kernel) around ``ops.flash_attention``,
which is the Hopper kernel on a CUDA device and its plain version on the
CPU. Any sequence length >= 1 runs on one device.

The JAX model's default mode, ring attention over a device mesh, and its
"ulysses" and "auto" modes are multi-device schemes of ``parallel/`` that the
port does not have yet (ROADMAP.md queue A, "Multi-device models and
parallel/"): asking for them raises ``NotImplementedError``, and the port's
default is "flash".

Weights: the JAX model draws its projections with ``jax.random``, which
torch cannot reproduce. :func:`draw_params` is the port's own seeded draw
(numpy), and :func:`load_jax_params` loads the JAX model's projections,
exported to numpy, so both packages can run on the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import SUPPORTED_DIMS, flash_attention
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
    x [S, dim] fp32 -> (attention(x wq, x wk, x wv) over ``heads`` heads) wo."""

    def __init__(self, dim: int = 64, heads: int = 4, device="cuda"):
        super().__init__()
        if heads < 1 or dim % heads or dim // heads not in SUPPORTED_DIMS:
            raise ValueError(
                f"dim {dim} over {heads} heads must give a head dim in {SUPPORTED_DIMS}")
        self.dim = dim
        self.heads = heads
        for name in WEIGHTS:
            self.register_parameter(name, nn.Parameter(
                torch.zeros((dim, dim), dtype=torch.float32, device=device),
                requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.shape[0]
        head_dim = self.dim // self.heads

        def project(w):
            return (x @ w).reshape(1, seq, self.heads, head_dim)

        out = flash_attention(project(self.wq), project(self.wk), project(self.wv))
        return out.reshape(seq, self.dim) @ self.wo


class LongContextEncoderModel(Model):
    """``long_context_encoder``: FP32 [seq, dim] -> attended [seq, dim]."""

    name = "long_context_encoder"
    platform = "pytorch_flash_attention"

    def __init__(self, dim: int = 64, heads: int = 4, seed: int = 0,
                 attention: str = "flash", device="cuda"):
        """``attention``: only "flash" (one device, any length); the mesh
        modes of the JAX model raise ``NotImplementedError``. Weights come
        from :func:`draw_params` with ``seed`` until :func:`load_jax_params`
        replaces them."""
        super().__init__()
        if attention in MESH_MODES:
            raise NotImplementedError(
                f"attention={attention!r} is a multi-device scheme the port does not "
                "have yet (ROADMAP.md queue A, 'Multi-device models and parallel/'); "
                "use attention='flash'")
        if attention != "flash":
            raise ValueError(f"attention must be flash (or a mesh mode), got {attention!r}")
        self._device = torch.device(device)
        self.encoder = LongContextEncoder(dim, heads, self._device)
        load_jax_params(self, draw_params(dim, seed))

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("sequence", "FP32", [-1, self.encoder.dim])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("encoded", "FP32", [-1, self.encoder.dim])]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        x = inputs["sequence"]
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
