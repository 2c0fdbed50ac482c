"""Model abstraction for the in-process server backend (the counterpart of
``client_tpu.models.base``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TensorSpec:
    """Metadata for one model input or output (KServe v2 TensorMetadata)."""

    name: str
    datatype: str
    shape: List[int]  # -1 for dynamic dims
    optional: bool = False  # model tolerates this input being absent

    def metadata(self) -> Dict[str, Any]:
        return {"name": self.name, "datatype": self.datatype, "shape": self.shape}

    def matches(self, shape: Sequence[int]) -> bool:
        if len(shape) != len(self.shape):
            return False
        return all(s == d or d == -1 for s, d in zip(shape, self.shape))


class Model:
    """Base class for server-side models.

    ``execute`` receives the input tensors (host ndarrays from the wire, or
    torch tensors from a cuda shared-memory region) plus the request
    parameter bag and returns output ndarrays or torch tensors. Decoupled
    models override ``execute_decoupled`` to yield multiple responses per
    request.
    """

    name: str = "model"
    platform: str = "pytorch"
    versions: List[str] = ["1"]
    max_batch_size: int = 0
    decoupled: bool = False
    stateful: bool = False

    def __init__(self):
        self._ready = True
        # load-time config override (reference: LoadModel config param,
        # http_client.cc:1496-1540) — merged over config() output
        self.config_override: Dict[str, Any] = {}

    # -- registry-facing ---------------------------------------------------
    @property
    def ready(self) -> bool:
        return self._ready

    def load(self) -> None:
        self._ready = True

    def unload(self) -> None:
        self._ready = False

    def inputs(self) -> List[TensorSpec]:
        raise NotImplementedError

    def outputs(self) -> List[TensorSpec]:
        raise NotImplementedError

    def metadata(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "versions": self.versions,
            "platform": self.platform,
            "inputs": [t.metadata() for t in self.inputs()],
            "outputs": [t.metadata() for t in self.outputs()],
        }

    def config(self) -> Dict[str, Any]:
        cfg = {
            "name": self.name,
            "platform": self.platform,
            "backend": "pytorch",
            "max_batch_size": self.max_batch_size,
            "input": [
                {"name": t.name, "data_type": "TYPE_" + t.datatype, "dims": t.shape}
                for t in self.inputs()
            ],
            "output": [
                {"name": t.name, "data_type": "TYPE_" + t.datatype, "dims": t.shape}
                for t in self.outputs()
            ],
            "model_transaction_policy": {"decoupled": self.decoupled},
        }
        cfg.update(self.config_override)
        return cfg

    def labels(self) -> Optional[List[str]]:
        """Classification labels (for the classification extension); None if n/a."""
        return None

    def effective_max_batch_size(self) -> int:
        """max_batch_size honoring any load-time config override — the value
        behavior must use (config() reports the same one)."""
        return int(self.config_override.get("max_batch_size", self.max_batch_size))

    # -- execution ---------------------------------------------------------
    def execute(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def execute_decoupled(
        self, inputs: Dict[str, np.ndarray], parameters: Dict[str, Any]
    ) -> Iterable[Dict[str, np.ndarray]]:
        """Yield one response dict per emitted message (decoupled models)."""
        yield self.execute(inputs, parameters)
