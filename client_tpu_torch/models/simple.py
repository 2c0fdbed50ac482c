"""Fixture-contract models on a torch device.

The counterparts of ``client_tpu.models.simple``'s fixtures (the contracts of
the tritonserver QA models the reference examples target): ``simple`` (INT32
sum/diff), ``simple_string`` (the same over BYTES), the identity
passthroughs, ``simple_sequence`` (a stateful per-sequence accumulator) and
``repeat_int32`` (a decoupled N-response streamer). Numeric outputs stay
device tensors where the JAX package's stay ``jax.Array``s: the cuda
shared-memory response path pins them in the region, wire paths bring them
to the host when the response is encoded.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from ..utils import as_device_tensor
from .base import Model, TensorSpec
from .decoder import _host_ints


class AddSubModel(Model):
    """``simple``: INPUT0,INPUT1 INT32[batch_dim, width] -> OUTPUT0=sum,
    OUTPUT1=diff ([1, 16] by default, as JAX's)."""

    name = "simple"

    def __init__(self, batch_dim: int = 1, width: int = 16, *, device="cuda"):
        super().__init__()
        self._shape = [batch_dim, width]
        self._device = torch.device(device)

    def inputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("INPUT0", "INT32", list(self._shape)),
            TensorSpec("INPUT1", "INT32", list(self._shape)),
        ]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("OUTPUT0", "INT32", list(self._shape)),
            TensorSpec("OUTPUT1", "INT32", list(self._shape)),
        ]

    def execute(self, inputs, parameters):
        a = as_device_tensor(inputs["INPUT0"], self._device)
        b = as_device_tensor(inputs["INPUT1"], self._device)
        return {"OUTPUT0": a + b, "OUTPUT1": a - b}


class StringAddSubModel(Model):
    """``simple_string``: BYTES-encoded integers in, sum/diff as BYTES out."""

    name = "simple_string"

    def inputs(self):
        return [
            TensorSpec("INPUT0", "BYTES", [1, 16]),
            TensorSpec("INPUT1", "BYTES", [1, 16]),
        ]

    def outputs(self):
        return [
            TensorSpec("OUTPUT0", "BYTES", [1, 16]),
            TensorSpec("OUTPUT1", "BYTES", [1, 16]),
        ]

    def execute(self, inputs, parameters):
        a = np.vectorize(int)(inputs["INPUT0"]).astype(np.int32)
        b = np.vectorize(int)(inputs["INPUT1"]).astype(np.int32)
        to_bytes = np.vectorize(lambda v: str(int(v)).encode(), otypes=[np.object_])
        return {"OUTPUT0": to_bytes(a + b), "OUTPUT1": to_bytes(a - b)}


class IdentityModel(Model):
    """Passthrough ``input_name`` -> ``output_name`` (``simple_identity``,
    ``custom_identity_int32``, ``identity_fp32``, ``identity_bf16``,
    ``identity_fp16``, ``identity_int8``).

    Fixed-width inputs go to the model's device (a cuda shared-memory input
    already there is returned as the very same tensor); BYTES pass through
    on the host. ``delay_s`` simulates a slow model for client and stream
    timeout tests (reference: client_timeout_test.cc against
    custom_identity_int32).
    """

    def __init__(self, name: str = "simple_identity", datatype: str = "BYTES",
                 input_name: str = "INPUT0", output_name: str = "OUTPUT0",
                 delay_s: float = 0.0, device="cuda"):
        super().__init__()
        self.name = name
        self._datatype = datatype
        self._input_name = input_name
        self._output_name = output_name
        self.delay_s = delay_s
        self._device = torch.device(device)

    def inputs(self):
        return [TensorSpec(self._input_name, self._datatype, [-1, -1])]

    def outputs(self):
        return [TensorSpec(self._output_name, self._datatype, [-1, -1])]

    def execute(self, inputs, parameters):
        if self.delay_s:
            time.sleep(self.delay_s)
        arr = inputs[self._input_name]
        if not (isinstance(arr, np.ndarray) and arr.dtype == np.object_):
            arr = as_device_tensor(arr, self._device)
        return {self._output_name: arr}


class SequenceAccumulatorModel(Model):
    """``simple_sequence``: per-sequence running INT32 accumulator.

    ``sequence_start`` resets the accumulator, every request adds its input
    value, the response carries the running total, ``sequence_end`` drops
    the sequence state.
    """

    name = "simple_sequence"
    stateful = True

    def __init__(self):
        super().__init__()
        self._state: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def inputs(self):
        return [TensorSpec("INPUT", "INT32", [1, 1])]

    def outputs(self):
        return [TensorSpec("OUTPUT", "INT32", [1, 1])]

    def execute(self, inputs, parameters):
        seq_id = parameters.get("sequence_id", 0)
        start = parameters.get("sequence_start", False)
        end = parameters.get("sequence_end", False)
        if not seq_id:
            raise ValueError("simple_sequence requires a sequence_id")
        value = int(_host_ints(inputs["INPUT"])[0])
        with self._lock:
            acc = 0 if start else self._state.get(seq_id, 0)
            acc += value
            if end:
                self._state.pop(seq_id, None)
            else:
                self._state[seq_id] = acc
        return {"OUTPUT": np.array([[acc]], dtype=np.int32)}


class RepeatModel(Model):
    """``repeat_int32``: decoupled, one response per input element.

    Inputs: IN (INT32[-1]), DELAY (UINT32[-1], per-response delay in ms),
    WAIT (UINT32[1], initial wait in ms). Output: OUT (INT32[1]) streamed
    len(IN) times, plus IDX (UINT32[1]) with the response index.
    """

    name = "repeat_int32"
    decoupled = True

    def inputs(self):
        return [
            TensorSpec("IN", "INT32", [-1]),
            TensorSpec("DELAY", "UINT32", [-1], optional=True),
            TensorSpec("WAIT", "UINT32", [1], optional=True),
        ]

    def outputs(self):
        return [TensorSpec("OUT", "INT32", [1]), TensorSpec("IDX", "UINT32", [1])]

    def execute(self, inputs, parameters):
        raise ValueError("repeat_int32 is a decoupled model; use streaming infer")

    def execute_decoupled(self, inputs, parameters) -> Iterable[Dict[str, np.ndarray]]:
        values = _host_ints(inputs["IN"])
        delays = _host_ints(inputs.get("DELAY", np.zeros(len(values), np.uint32)))
        wait = int(_host_ints(inputs.get("WAIT", np.zeros(1, np.uint32)))[0])
        if wait:
            time.sleep(wait / 1000.0)
        for idx, v in enumerate(values):
            if idx < len(delays) and delays[idx]:
                time.sleep(int(delays[idx]) / 1000.0)
            yield {
                "OUT": np.array([v], dtype=np.int32),
                "IDX": np.array([idx], dtype=np.uint32),
            }


def default_model_zoo(device="cuda") -> List[Model]:
    """The fixture set every test and example expects to find on the server,
    on ``device``: the JAX package's ``default_model_zoo``, in its order.
    ``decoder_lm_tp_prefill`` shards over the local devices of ``device``
    (the largest divisor of the decoder's heads that fits: 4 of the CPU's 8
    mesh entries, 1 on a one-card host)."""
    from .batched import BatchedMatMulModel
    from .chain import (
        ChainEmbedModel,
        ChainFusedModel,
        ChainRerankModel,
        ChainTokenizeModel,
        chain_core,
    )
    from .decoder import TinyDecoderModel
    from .decoder_batched import BatchedDecoderModel
    from .decoder_prefill import PrefillDecoderModel
    from .disagg import DisaggPrefillModel, KvDecodeModel
    from .generate import TinyGenerateModel

    decoder = TinyDecoderModel(device=device)
    chain = chain_core(device)
    return [
        BatchedMatMulModel(device=device),
        AddSubModel(device=device),
        StringAddSubModel(),
        IdentityModel("simple_identity", "BYTES", device=device),
        IdentityModel("custom_identity_int32", "INT32", delay_s=0.0, device=device),
        IdentityModel("identity_fp32", "FP32", device=device),
        IdentityModel("identity_bf16", "BF16", device=device),
        IdentityModel("identity_fp16", "FP16", device=device),
        IdentityModel("identity_int8", "INT8", device=device),
        SequenceAccumulatorModel(),
        RepeatModel(),
        decoder,
        TinyGenerateModel(decoder=decoder),
        # its own decoder from the same seed (the slots hold their own cache)
        BatchedDecoderModel(device=device),
        # stateless batched prompt scoring over the shared decoder
        PrefillDecoderModel(decoder=decoder),
        PrefillDecoderModel(tp=True, device=device),
        # the disaggregated prefill/decode pair, sharing the decoder's weights
        # so the split stream equals tiny_lm_generate's bit for bit
        DisaggPrefillModel(decoder=decoder),
        KvDecodeModel(decoder=decoder),
        # the pipeline chain: three stages plus the fused reference, all
        # over one shared ChainCore so DAG runs equal the single-model call
        ChainTokenizeModel(chain),
        ChainEmbedModel(chain),
        ChainRerankModel(chain),
        ChainFusedModel(chain),
    ]
