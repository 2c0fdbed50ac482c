"""Mixture-of-experts model behind the v2 protocol.

The counterpart of ``client_tpu.models.moe``: ``moe_ffn``, FP32 ``tokens``
[-1, dim] -> ``routed`` [-1, dim], a top-1 routed MoE FFN whose experts are
split over the ``model`` axis of a (1, n) mesh, the tokens dispatched with
tiled all-to-alls (``parallel/moe.py``). A fixture with seeded weights that
exercises expert parallelism in serving, not a trained model.

Weights: the JAX model draws with ``jax.random``, which torch cannot
reproduce. :func:`draw_params` is the port's seeded numpy draw (the same
shapes and scales), and :func:`load_jax_params` loads the JAX model's
arrays, exported to numpy. The expert count is ``experts_per_device`` times
the mesh size, so the weights depend on it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..parallel import Mesh, split, take_devices
from ..parallel.moe import moe_ffn
from ..utils import numpy_to_tensor
from .base import Model, TensorSpec

WEIGHTS = ("gate_w", "w1", "w2")


def draw_params(dim: int, hidden: int, n_experts: int, seed: int) -> Dict[str, np.ndarray]:
    """float32 ``gate_w`` [dim, E], ``w1`` [E, dim, hidden] and ``w2``
    [E, hidden, dim] from ``np.random.default_rng(seed)`` in that order,
    each scaled by ``dim**-0.5`` as the JAX model scales its own."""
    rng = np.random.default_rng(seed)
    scale = np.float32(dim ** -0.5)
    shapes = {"gate_w": (dim, n_experts), "w1": (n_experts, dim, hidden),
              "w2": (n_experts, hidden, dim)}
    return {name: rng.standard_normal(shapes[name]).astype(np.float32) * scale
            for name in WEIGHTS}


class MoEFFNModel(Model):
    """``moe_ffn``: FP32 [tokens, dim] -> routed expert outputs, same shape.

    ``tokens`` must divide by the mesh axis size (the dispatch splits the
    token dim): another count is a 400."""

    name = "moe_ffn"
    platform = "pytorch_moe_ep"

    def __init__(self, dim: int = 32, hidden: int = 64, experts_per_device: int = 2,
                 seed: int = 0, n_devices: int = 0, device="cuda", mesh: Optional[Mesh] = None):
        """The experts are split over ``mesh``'s ``model`` axis, or over a
        (1, n) mesh of the first ``n_devices`` of ``local_devices(device)``
        (0: all of them)."""
        super().__init__()
        if mesh is None:
            mesh = Mesh([take_devices(n_devices, device)], ("data", "model"))
        self.mesh = mesh
        self._dim = dim
        self._hidden = hidden
        self._device = mesh.axis_devices("model")[0]
        self.n_experts = experts_per_device * mesh.shape["model"]
        load_jax_params(self, draw_params(dim, hidden, self.n_experts, seed))

    @property
    def mesh_degrees(self) -> Dict[str, int]:
        return dict(self.mesh.shape)

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("tokens", "FP32", [-1, self._dim])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("routed", "FP32", [-1, self._dim])]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        x = inputs["tokens"]
        n = self.mesh.shape["model"]
        if x.shape[0] % n != 0:
            from ..server.core import InferError

            raise InferError(
                f"token count {x.shape[0]} must divide by the mesh axis size {n}", 400)
        if isinstance(x, torch.Tensor):
            x = x.to(self._device, torch.float32)
        else:
            x = numpy_to_tensor(np.asarray(x, dtype=np.float32), self._device)
        out = moe_ffn(x, self.gate_w, self.w1, self.w2, self.mesh, axis="model")
        return {"routed": out.full(self._device)}


def load_jax_params(model: MoEFFNModel, params: Mapping[str, np.ndarray]) -> None:
    """Load float32 ``gate_w``, ``w1`` and ``w2`` (numpy arrays, e.g. the
    JAX model's through ``np.asarray``) into ``model``: ``gate_w`` on the
    mesh's first device, each shard's experts of ``w1`` / ``w2`` on its own."""
    E, dim, hidden = model.n_experts, model._dim, model._hidden
    shapes = {"gate_w": (dim, E), "w1": (E, dim, hidden), "w2": (E, hidden, dim)}
    for name in WEIGHTS:
        arr = np.asarray(params[name])
        if arr.dtype != np.float32 or arr.shape != shapes[name]:
            raise ValueError(f"{name} must be float32 {list(shapes[name])}, got "
                             f"{arr.dtype} {list(arr.shape)}")
    devices = model.mesh.axis_devices("model")
    model.gate_w = numpy_to_tensor(np.asarray(params["gate_w"]), model._device)
    model.w1 = split(numpy_to_tensor(np.asarray(params["w1"]), "cpu"), devices, 0)
    model.w2 = split(numpy_to_tensor(np.asarray(params["w2"]), "cpu"), devices, 0)
