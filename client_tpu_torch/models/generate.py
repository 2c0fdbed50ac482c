"""Decoupled autoregressive generation — the LLM serving pattern.

The counterpart of ``client_tpu.models.generate``: ``tiny_lm_generate``
takes one request carrying the prompt and ``MAX_TOKENS`` and streams one
response per generated token, sharing weights with the stateful
``decoder_lm`` so greedy generation agrees token for token across both
serving styles.

- one decode step serves the prompt and every generated token;
- with the request parameter ``chunk`` > 1, K tokens are decoded by a loop
  whose greedy argmax and feed-back stay on the device (the host reads the K
  token ids once per chunk); chunk=1 (the default) reads each token as it is
  made, which is what a streaming-latency harness should measure.

Wire contract (decoupled — use streaming inference):
  inputs:  TOKENS     INT32[1, -1]  prompt token ids
           MAX_TOKENS INT32[1]      max tokens to generate (optional,
                                    default 16, clamped to cache room)
           END_ID     INT32[1]      stop token id (optional; generation
                                    stops AFTER emitting it)
  outputs: NEXT_TOKEN INT32[1, 1]   one generated token per response
           INDEX      INT32[1, 1]   0-based position of that token
  request parameters: "chunk": int — tokens per device loop (default 1)
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np

from .base import Model, TensorSpec
from .decoder import TinyDecoderModel, _host_ints


class TinyGenerateModel(Model):
    """``tiny_lm_generate``: decoupled streaming generation over the
    decoder_lm transformer (same seed -> identical weights)."""

    name = "tiny_lm_generate"
    max_batch_size = 0
    decoupled = True

    DEFAULT_MAX_TOKENS = 16

    def __init__(self, seed: int = 0, decoder: TinyDecoderModel = None, device="cuda"):
        super().__init__()
        # weight sharing by composition: pass the zoo's decoder_lm instance
        # (its weights are read-only at serving time; every request gets
        # its own cache)
        self._decoder = decoder if decoder is not None else TinyDecoderModel(
            seed=seed, device=device)

    def inputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("TOKENS", "INT32", [1, -1]),
            TensorSpec("MAX_TOKENS", "INT32", [1], optional=True),
            TensorSpec("END_ID", "INT32", [1], optional=True),
        ]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("NEXT_TOKEN", "INT32", [1, 1]),
            TensorSpec("INDEX", "INT32", [1, 1]),
        ]

    def execute(self, inputs, parameters):
        raise ValueError(
            "tiny_lm_generate is a decoupled model; use streaming inference")

    def execute_decoupled(
        self, inputs: Dict[str, Any], parameters: Dict[str, Any]
    ) -> Iterable[Dict[str, np.ndarray]]:
        dec = self._decoder
        max_len = dec.MAX_LEN

        tokens = _host_ints(inputs["TOKENS"])
        if tokens.size == 0:
            raise ValueError("empty prompt")
        if np.any(tokens < 0) or np.any(tokens >= dec.VOCAB):
            raise ValueError(f"tokens out of range [0, {dec.VOCAB})")
        if tokens.size >= max_len:
            raise ValueError(f"prompt longer than max_len {max_len}")

        max_tokens = int(_host_ints(inputs.get("MAX_TOKENS", self.DEFAULT_MAX_TOKENS))[0])
        if max_tokens < 1:
            raise ValueError("MAX_TOKENS must be >= 1")
        end_id = None
        if "END_ID" in inputs:
            end_id = int(_host_ints(inputs["END_ID"])[0])
        chunk = int(parameters.get("chunk", 1))
        if chunk < 1:
            raise ValueError("chunk parameter must be >= 1")

        # room left in the static cache bounds generation length
        budget = min(max_tokens, max_len - int(tokens.size))

        caches = dec.fresh_cache()
        logits = dec.prefill(caches, tokens, 0)
        pos = int(tokens.size)

        def response(token_id: int, index: int):
            return {
                "NEXT_TOKEN": np.array([[token_id]], dtype=np.int32),
                "INDEX": np.array([[index]], dtype=np.int32),
            }

        emitted = 0
        next_token = int(logits.argmax())
        if chunk == 1:
            # one streamed response per device step: honest TTFT and
            # inter-token latency for a perf harness
            while emitted < budget:
                yield response(next_token, emitted)
                emitted += 1
                if emitted >= budget or (end_id is not None and next_token == end_id):
                    return
                logits = dec.prefill(caches, np.array([next_token]), pos)
                pos += 1
                next_token = int(logits.argmax())
            return

        # chunked: the first token came from the prompt; later tokens arrive
        # K at a time from one device loop and stream out burst-wise
        yield response(next_token, emitted)
        emitted += 1
        if end_id is not None and next_token == end_id:
            return
        while emitted < budget:
            k = min(chunk, budget - emitted, max_len - pos)
            if k <= 0:
                return
            toks = dec.greedy(caches, next_token, pos, k)
            pos += k
            for t in toks:
                yield response(t, emitted)
                emitted += 1
                if end_id is not None and t == end_id:
                    return
            next_token = toks[-1]
