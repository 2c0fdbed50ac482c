"""Stateless batched prompt scoring over the decoder.

The counterpart of ``client_tpu.models.decoder_prefill``'s
``decoder_lm_prefill``: TOKENS INT32 ``[-1, T]`` (a batch of equal-length
prompts) -> LOGITS FP32 ``[-1, VOCAB]`` + NEXT_TOKEN INT32 ``[-1, 1]``. Each
row is scored on its own, through the decoder's single-sequence
:meth:`TinyDecoderModel.step` over the prompt with a fresh KV cache: the
step ``decoder_lm`` serves, so row b's logits are the same bits as scoring
that prompt in one start+end request on the same device. Rows are
independent, so a client may split the batch axis across replicas.

``decoder_lm_tp_prefill`` (``tp=True``) is the same contract over
``decoder_lm_tp``'s mesh-sharded step (models/decoder_tp.py), whose rows a
sharded scatter-gather client holds against a local ``decoder_lm_prefill``.
Its executions are serialised by a process-wide lock, as JAX's: replicas
hosted in one process share the mesh's devices.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import tensor_to_numpy
from .base import Model, TensorSpec
from .decoder import TinyDecoderModel, _host_ints
from .decoder_tp import TPDecoderModel


class PrefillDecoderModel(Model):
    """``decoder_lm_prefill`` / ``decoder_lm_tp_prefill``: batched stateless
    prompt scoring (one fresh-cache decode per row)."""

    max_batch_size = 0
    stateful = False

    _TP_EXEC_LOCK = threading.Lock()

    def __init__(self, tp: bool = False, seed: int = 0, mesh=None, axis: str = "model",
                 tp_degree: Optional[int] = None, *, decoder: TinyDecoderModel = None,
                 device="cuda"):
        """JAX's positional order, ``(tp, seed, mesh, axis, tp_degree)``;
        the port's own ``decoder`` and ``device`` are keywords.
        ``decoder``: share the zoo's ``decoder_lm`` (its weights); a new
        one from ``seed`` on ``device`` when None. ``tp=True``: a new
        :class:`TPDecoderModel` from ``seed``, over ``mesh``'s ``axis`` or
        ``tp_degree`` of the local devices of ``device``."""
        super().__init__()
        self._tp = tp
        if tp:
            self._decoder = TPDecoderModel(seed=seed, tp=tp_degree, mesh=mesh, axis=axis,
                                           device=device)
        else:
            self._decoder = decoder if decoder is not None else TinyDecoderModel(
                seed=seed, device=device)
        self.name = "decoder_lm_tp_prefill" if tp else "decoder_lm_prefill"

    @property
    def tp_degree(self) -> int:
        """The mesh axis size of ``decoder_lm_tp_prefill`` (1 without tp)."""
        return self._decoder.tp_degree if self._tp else 1

    @property
    def mesh_degrees(self) -> Optional[Dict[str, int]]:
        return self._decoder.mesh_degrees

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("TOKENS", "INT32", [-1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("LOGITS", "FP32", [-1, self._decoder.VOCAB]),
            TensorSpec("NEXT_TOKEN", "INT32", [-1, 1]),
        ]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        dec = self._decoder
        shape = tuple(inputs["TOKENS"].shape)
        if len(shape) != 2 or shape[1] < 1:
            raise ValueError(f"TOKENS must be [batch, prompt_len >= 1], got {list(shape)}")
        if shape[1] > dec.MAX_LEN:
            raise ValueError(f"prompt longer than max_len {dec.MAX_LEN}")
        tokens = _host_ints(inputs["TOKENS"]).reshape(shape)
        if np.any(tokens < 0) or np.any(tokens >= dec.VOCAB):
            raise ValueError(f"tokens out of range [0, {dec.VOCAB})")
        # one step per token, fresh cache per row: the same step (and so the
        # same bits) as serving the row through the sequence API
        with self._TP_EXEC_LOCK if self._tp else contextlib.nullcontext():
            rows = [dec.prefill(dec.fresh_cache(), row, 0) for row in tokens]
        logits_np = tensor_to_numpy(torch.stack(rows))  # an empty batch fails, as in JAX
        return {
            "LOGITS": logits_np,
            "NEXT_TOKEN": logits_np.argmax(axis=1).astype(np.int32).reshape(-1, 1),
        }
