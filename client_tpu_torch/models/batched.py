"""Batchable matmul model: the dynamic batcher's showcase fixture.

The counterpart of ``client_tpu.models.batched``: ``batched_matmul``, X
FP32[-1, 64] @ W[64, 16] -> Y FP32[-1, 16], with ``max_batch_size`` declared
so the server core's dynamic batcher coalesces concurrent [1, 64] requests
into one [k, 64] execution. W is drawn from ``np.random.default_rng(seed)``
as in the JAX model, and the product is one ``torch.matmul`` on the model's
device (the JAX model leaves it to XLA, outside any kernel). Y stays a
device tensor; the batcher hands each caller its rows as a view.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..utils import as_device_tensor
from .base import Model, TensorSpec


class BatchedMatMulModel(Model):
    name = "batched_matmul"
    max_batch_size = 32

    IN_DIM = 64
    OUT_DIM = 16

    def __init__(self, seed: int = 0, delay_s: float = 0.0, device="cuda"):
        """``delay_s`` simulates per-EXECUTION cost (not per row), so that
        coalescing shows in wall time."""
        super().__init__()
        self._delay_s = delay_s
        self._device = torch.device(device)
        self._lock = threading.Lock()
        self._w = None
        rng = np.random.default_rng(seed)
        self._w_np = rng.standard_normal((self.IN_DIM, self.OUT_DIM)).astype(np.float32)
        self.executed_batches: List[int] = []  # rows per execution, for tests

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("X", "FP32", [-1, self.IN_DIM])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("Y", "FP32", [-1, self.OUT_DIM])]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        x = as_device_tensor(inputs["X"], self._device).float()
        with self._lock:
            if self._w is None:
                self._w = torch.from_numpy(self._w_np).to(self._device)
            self.executed_batches.append(int(x.shape[0]))
        if self._delay_s:
            time.sleep(self._delay_s)
        return {"Y": x @ self._w}
