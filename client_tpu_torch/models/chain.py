"""The 3-stage chain fixtures behind ``client_tpu_torch.pipeline``'s proofs.

The counterpart of ``client_tpu.models.chain``: four models over ONE shared
parameter/step core (:class:`ChainCore`):

- ``chain_tokenize``: RAW INT32[B,L] -> TOKENS INT32[B,L], a fixed
  affine hash into the vocab (``(RAW * 31 + 7) % VOCAB``).
- ``chain_embed``: TOKENS INT32[B,L] -> EMBED FP32[B,L,32], a seeded
  embedding-table gather.
- ``chain_rerank``: EMBED FP32[B,L,32] -> SCORES FP32[B,L], a seeded
  linear projection.
- ``chain_fused``: RAW INT32[B,L] -> SCORES FP32[B,L], the monolithic
  reference running the SAME three step functions end to end.

The weights are drawn from ``np.random.default_rng(20260807)`` in the JAX
core's order and moved to the core's device on first use. The steps are
plain torch functions on that device: int32 arithmetic wraps as XLA's does,
and ``%`` takes the divisor's sign in both (a negative RAW maps into
``[0, VOCAB)``). Bit-exactness between a pipeline run of the three stages
and one ``chain_fused`` call is by construction, not by tolerance: the fused
model composes the very callables the stage models serve.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from ..utils import as_device_tensor
from .base import Model, TensorSpec

VOCAB = 997
EMBED_DIM = 32
_SEED = 20260807


class ChainCore:
    """Shared seeded parameters + lazily built step functions for the chain
    fixtures on ``device``. ONE instance backs all four models so
    stage-by-stage and fused execution run the same steps."""

    def __init__(self, seed: int = _SEED, device="cuda"):
        rng = np.random.default_rng(seed)
        self.table = rng.standard_normal(
            (VOCAB, EMBED_DIM)).astype(np.float32)
        self.proj = rng.standard_normal((EMBED_DIM,)).astype(np.float32)
        self.bias = np.float32(rng.standard_normal())
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._fns = None

    def fns(self):
        with self._lock:
            if self._fns is None:
                device = self.device
                table = torch.from_numpy(self.table).to(device)
                proj = torch.from_numpy(self.proj).to(device)
                bias = torch.tensor(self.bias, dtype=torch.float32, device=device)

                def tokenize(raw):
                    raw = as_device_tensor(raw, device).to(torch.int32)
                    return (raw * 31 + 7) % VOCAB

                def embed(tokens):
                    tokens = as_device_tensor(tokens, device).to(torch.int32)
                    return table[tokens % VOCAB]

                def rerank(embedded):
                    embedded = as_device_tensor(embedded, device).to(torch.float32)
                    return torch.einsum("ble,e->bl", embedded, proj) + bias

                self._fns = (tokenize, embed, rerank)
            return self._fns


_CORES: Dict[str, ChainCore] = {}
_CORES_LOCK = threading.Lock()


def chain_core(device="cuda") -> ChainCore:
    """The module-level shared core on ``device`` (models default to it)."""
    key = str(torch.device(device))
    with _CORES_LOCK:
        core = _CORES.get(key)
        if core is None:
            core = _CORES[key] = ChainCore(device=device)
        return core


class _ChainModel(Model):
    def __init__(self, core: ChainCore = None, device="cuda"):
        super().__init__()
        self.core = core or chain_core(device)


class ChainTokenizeModel(_ChainModel):
    """``chain_tokenize``: RAW INT32[B,L] -> TOKENS INT32[B,L]."""

    name = "chain_tokenize"

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("RAW", "INT32", [-1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("TOKENS", "INT32", [-1, -1])]

    def execute(self, inputs, parameters):
        tokenize, _, _ = self.core.fns()
        return {"TOKENS": tokenize(inputs["RAW"])}


class ChainEmbedModel(_ChainModel):
    """``chain_embed``: TOKENS INT32[B,L] -> EMBED FP32[B,L,32]."""

    name = "chain_embed"

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("TOKENS", "INT32", [-1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("EMBED", "FP32", [-1, -1, EMBED_DIM])]

    def execute(self, inputs, parameters):
        _, embed, _ = self.core.fns()
        return {"EMBED": embed(inputs["TOKENS"])}


class ChainRerankModel(_ChainModel):
    """``chain_rerank``: EMBED FP32[B,L,32] -> SCORES FP32[B,L]."""

    name = "chain_rerank"

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("EMBED", "FP32", [-1, -1, EMBED_DIM])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("SCORES", "FP32", [-1, -1])]

    def execute(self, inputs, parameters):
        _, _, rerank = self.core.fns()
        return {"SCORES": rerank(inputs["EMBED"])}


class ChainFusedModel(_ChainModel):
    """``chain_fused``: the monolithic RAW -> SCORES reference, running
    the same steps the three stage models serve."""

    name = "chain_fused"

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("RAW", "INT32", [-1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("SCORES", "FP32", [-1, -1])]

    def execute(self, inputs, parameters):
        tokenize, embed, rerank = self.core.fns()
        return {"SCORES": rerank(embed(tokenize(inputs["RAW"])))}
