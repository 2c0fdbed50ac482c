"""Fixture-contract models on a torch device.

The counterparts of ``client_tpu.models.simple``'s ``simple`` (INT32
sum/diff) and identity fixtures. Their outputs stay device tensors, as the
JAX package's stay ``jax.Array``s: the cuda shared-memory response path pins
them in the region, wire paths bring them to the host when the response is
encoded.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils import as_device_tensor
from .base import Model, TensorSpec


class AddSubModel(Model):
    """``simple``: INPUT0,INPUT1 INT32[1,16] -> OUTPUT0=sum, OUTPUT1=diff."""

    name = "simple"

    SHAPE = [1, 16]

    def __init__(self, device="cuda"):
        super().__init__()
        self._device = torch.device(device)

    def inputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("INPUT0", "INT32", list(self.SHAPE)),
            TensorSpec("INPUT1", "INT32", list(self.SHAPE)),
        ]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("OUTPUT0", "INT32", list(self.SHAPE)),
            TensorSpec("OUTPUT1", "INT32", list(self.SHAPE)),
        ]

    def execute(self, inputs, parameters):
        a = as_device_tensor(inputs["INPUT0"], self._device)
        b = as_device_tensor(inputs["INPUT1"], self._device)
        return {"OUTPUT0": a + b, "OUTPUT1": a - b}


class IdentityModel(Model):
    """Passthrough INPUT0 -> OUTPUT0 (``identity_fp32``, ``identity_bf16``,
    ``identity_int8``).

    Fixed-width inputs go to the model's device (a cuda shared-memory input
    already there is returned as the very same tensor); BYTES pass through
    on the host.
    """

    def __init__(self, name: str, datatype: str, device="cuda"):
        super().__init__()
        self.name = name
        self._datatype = datatype
        self._device = torch.device(device)

    def inputs(self):
        return [TensorSpec("INPUT0", self._datatype, [-1, -1])]

    def outputs(self):
        return [TensorSpec("OUTPUT0", self._datatype, [-1, -1])]

    def execute(self, inputs, parameters):
        arr = inputs["INPUT0"]
        if not (isinstance(arr, np.ndarray) and arr.dtype == np.object_):
            arr = as_device_tensor(arr, self._device)
        return {"OUTPUT0": arr}


def default_model_zoo(device="cuda") -> List[Model]:
    """The models this port serves, on ``device``."""
    from .decoder import TinyDecoderModel
    from .generate import TinyGenerateModel

    decoder = TinyDecoderModel(device=device)
    return [
        AddSubModel(device=device),
        IdentityModel("identity_fp32", "FP32", device=device),
        IdentityModel("identity_bf16", "BF16", device=device),
        IdentityModel("identity_int8", "INT8", device=device),
        decoder,
        TinyGenerateModel(decoder=decoder),
    ]
