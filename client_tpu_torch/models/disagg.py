"""Disaggregated prefill/decode model pair over the decoder_lm weights.

The counterpart of ``client_tpu.models.disagg``: the server fixtures for both
halves of a prefill/decode split, sharing weights (and the single decode
step) with the zoo's ``decoder_lm`` / ``tiny_lm_generate``, so the split
token stream equals monolithic generation bit for bit:

- ``decoder_lm_disagg_prefill``: stateless prefill that runs the prompt
  through a fresh KV cache and RETURNS the cache (plus the first greedy
  token and the fill position). A pure function of the prompt, so re-running
  it over prompt + emitted tokens rebuilds the state a lost decode replica
  held.
- ``decoder_lm_kv_decode``: decoupled decode from a handed-off cache; it
  streams greedy tokens exactly as ``tiny_lm_generate``'s per-token path
  (one response per token, INDEX offset by ``START_INDEX``).

The KV travels as FP32 ``[LAYERS*2, HEADS, MAX_LEN, Dh]`` (row ``2l`` is
layer ``l``'s K, row ``2l+1`` its V): widening bf16 to fp32 is exact and so
is narrowing it back. The exported KV stays a device tensor, so a cuda
shared-memory output region receives it without a host copy.

Wire contracts:
  decoder_lm_disagg_prefill (unary):
    inputs:  TOKENS     INT32[1, -1]  prompt token ids
    outputs: KV         FP32[L*2, H, M, Dh]  the filled cache
             NEXT_TOKEN INT32[1, 1]   greedy argmax after the last token
             POS        INT32[1, 1]   tokens consumed (cache fill level)
  decoder_lm_kv_decode (decoupled: use streaming inference):
    inputs:  KV          FP32[L*2, H, M, Dh]  handed-off cache
             POS         INT32[1]     cache fill level
             FIRST_TOKEN INT32[1]     first pending (un-emitted) token
             MAX_TOKENS  INT32[1]     tokens to emit (optional, default 16)
             END_ID      INT32[1]     stop token id (optional; stops AFTER
                                      emitting it)
             START_INDEX INT32[1]     INDEX of the first emitted token
                                      (optional, default 0)
    outputs: NEXT_TOKEN  INT32[1, 1]  one generated token per response
             INDEX       INT32[1, 1]  global position of that token
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from ..utils import as_device_tensor
from .base import Model, TensorSpec
from .decoder import TinyDecoderModel, _host_ints


def _kv_shape(dec: TinyDecoderModel) -> List[int]:
    return [dec.LAYERS * 2, dec.HEADS, dec.MAX_LEN, dec.D_MODEL // dec.HEADS]


class DisaggPrefillModel(Model):
    """``decoder_lm_disagg_prefill``: stateless prompt prefill that exports
    the KV cache for handoff to a decode-role replica."""

    name = "decoder_lm_disagg_prefill"
    max_batch_size = 0

    def __init__(self, seed: int = 0, decoder: TinyDecoderModel = None, device="cuda"):
        super().__init__()
        # weights shared by composition: bit-exactness across serving styles
        # needs ONE parameter set
        self._decoder = decoder if decoder is not None else TinyDecoderModel(
            seed=seed, device=device)

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("TOKENS", "INT32", [1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("KV", "FP32", _kv_shape(self._decoder)),
            TensorSpec("NEXT_TOKEN", "INT32", [1, 1]),
            TensorSpec("POS", "INT32", [1, 1]),
        ]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        dec = self._decoder
        tokens = _host_ints(inputs["TOKENS"])
        if tokens.size == 0:
            raise ValueError("empty prompt")
        if np.any(tokens < 0) or np.any(tokens >= dec.VOCAB):
            raise ValueError(f"tokens out of range [0, {dec.VOCAB})")
        if tokens.size >= dec.MAX_LEN:
            raise ValueError(f"prompt longer than max_len {dec.MAX_LEN}")
        # the step the monolithic paths run: the cache is the state
        # tiny_lm_generate holds after the same tokens
        caches = dec.fresh_cache()
        logits = dec.prefill(caches, tokens, 0)
        # [L*2, H, M, Dh] fp32 on the device: the exact widening of the cache
        kv = torch.stack([c[half] for c in caches for half in ("k", "v")]).float()
        return {
            "KV": kv,
            "NEXT_TOKEN": np.array([[int(logits.argmax())]], dtype=np.int32),
            "POS": np.array([[tokens.size]], dtype=np.int32),
        }


class KvDecodeModel(Model):
    """``decoder_lm_kv_decode``: decoupled greedy decode resuming from a
    handed-off KV cache (the decode half of the split)."""

    name = "decoder_lm_kv_decode"
    max_batch_size = 0
    decoupled = True

    DEFAULT_MAX_TOKENS = 16

    def __init__(self, seed: int = 0, decoder: TinyDecoderModel = None, device="cuda"):
        super().__init__()
        self._decoder = decoder if decoder is not None else TinyDecoderModel(
            seed=seed, device=device)

    def inputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("KV", "FP32", _kv_shape(self._decoder)),
            TensorSpec("POS", "INT32", [1]),
            TensorSpec("FIRST_TOKEN", "INT32", [1]),
            TensorSpec("MAX_TOKENS", "INT32", [1], optional=True),
            TensorSpec("END_ID", "INT32", [1], optional=True),
            TensorSpec("START_INDEX", "INT32", [1], optional=True),
        ]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("NEXT_TOKEN", "INT32", [1, 1]),
            TensorSpec("INDEX", "INT32", [1, 1]),
        ]

    def execute(self, inputs, parameters):
        raise ValueError(
            "decoder_lm_kv_decode is a decoupled model; use streaming inference")

    def execute_decoupled(
        self, inputs: Dict[str, Any], parameters: Dict[str, Any]
    ) -> Iterable[Dict[str, np.ndarray]]:
        dec = self._decoder
        L, H, M = dec.LAYERS, dec.HEADS, dec.MAX_LEN
        Dh = dec.D_MODEL // H

        kv = as_device_tensor(inputs["KV"], dec.device).float()
        if tuple(kv.shape) != (L * 2, H, M, Dh):
            raise ValueError(
                f"KV shape {tuple(kv.shape)} != expected {(L * 2, H, M, Dh)}")
        pos = int(_host_ints(inputs["POS"])[0])
        if not 0 < pos <= M:
            raise ValueError(f"POS out of range (0, {M}]")
        next_token = int(_host_ints(inputs["FIRST_TOKEN"])[0])
        if not 0 <= next_token < dec.VOCAB:
            raise ValueError(f"FIRST_TOKEN out of range [0, {dec.VOCAB})")
        budget = int(_host_ints(inputs.get("MAX_TOKENS", self.DEFAULT_MAX_TOKENS))[0])
        if budget < 1:
            raise ValueError("MAX_TOKENS must be >= 1")
        end_id = None
        if "END_ID" in inputs:
            end_id = int(_host_ints(inputs["END_ID"])[0])
        start_index = int(_host_ints(inputs.get("START_INDEX", 0))[0])
        if start_index < 0:
            raise ValueError("START_INDEX must be >= 0")

        # narrowed back to the bf16 the cache was exported from (exact): the
        # step sees the state of the monolithic decode loop
        caches = [{"k": kv[2 * layer].to(torch.bfloat16),
                   "v": kv[2 * layer + 1].to(torch.bfloat16)}
                  for layer in range(L)]

        def response(token_id: int, index: int):
            return {
                "NEXT_TOKEN": np.array([[token_id]], dtype=np.int32),
                "INDEX": np.array([[index]], dtype=np.int32),
            }

        # tiny_lm_generate's per-token path: budget, END_ID emitted then
        # stop, one step per emitted token
        emitted = 0
        while emitted < budget:
            yield response(next_token, start_index + emitted)
            emitted += 1
            if emitted >= budget or (end_id is not None and next_token == end_id):
                return
            if pos >= M:
                return  # static cache exhausted
            logits = dec.prefill(caches, np.array([next_token]), pos)
            pos += 1
            next_token = int(logits.argmax())
