"""Autoregressive decoder with a KV cache behind the v2 sequence API.

The counterpart of ``client_tpu.models.decoder``: ``decoder_lm``, a 2-layer
pre-norm transformer decoder whose per-sequence KV cache lives in
server-side sequence state, driven one token per request the way an LLM
serving loop drives it. Same widths, same weights (drawn from the same numpy
seed, or carried over from the JAX model by :func:`load_jax_params`), same
wire contract:

  inputs:  TOKENS INT32[1, -1] — full prompt when sequence_start, exactly
           one token otherwise
  outputs: LOGITS FP32[1, vocab] (next-token logits, fp32)
           NEXT_TOKEN INT32[1, 1] (greedy argmax, a convenience)

Weights and math are bf16 on the model's device with fp32 norm statistics,
softmax and logits. Attention goes through ``ops.decode_attention`` only: on
a CUDA device that is the Hopper kernel, on the CPU its plain version. The
JAX package's ``attention_impl`` switch ("einsum", its default, or "pallas")
chose between two versions of that same function; the port takes and checks
the keyword as JAX does, and both values run ``ops.decode_attention``. The
position travels as a device int32 tensor, so neither the cache update nor
the kernel waits on the host.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.decode_attention import decode_attention
from ..utils import numpy_to_tensor, tensor_to_numpy
from .base import Model, TensorSpec

Params = Dict[str, Any]  # "embed", "pos", "unembed": tensors; "layers": [dict]

_LAYER_KEYS = ("qkv", "proj", "mlp_in", "mlp_out")


def draw_params(seed: int, device="cuda") -> Params:
    """The decoder's weights from ``np.random.default_rng(seed)``, drawn in the
    JAX package's order and rounded to bf16 the same way (nearest even), so
    the bytes equal the JAX model's."""
    D, L, V, M = (TinyDecoderModel.D_MODEL, TinyDecoderModel.LAYERS,
                  TinyDecoderModel.VOCAB, TinyDecoderModel.MAX_LEN)
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale if scale is not None else (shape[0] ** -0.5)
        host = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(host).to(torch.bfloat16).to(device)

    return {
        "embed": w(V, D, scale=0.02),
        "pos": w(M, D, scale=0.02),
        "layers": [
            {
                "qkv": w(D, 3 * D),
                "proj": w(D, D),
                "mlp_in": w(D, 4 * D),
                "mlp_out": w(4 * D, D),
            }
            for _ in range(L)
        ],
        "unembed": w(D, V, scale=0.02),
    }


def load_jax_params(params_np: Params, device="cuda") -> Params:
    """The port's weights from the JAX decoder's parameter tree, exported
    leaf by leaf with ``np.asarray`` (bf16 as ``ml_dtypes.bfloat16``)."""
    def leaf(arr):
        arr = np.asarray(arr)
        if arr.dtype.name != "bfloat16":
            raise TypeError(f"decoder weights are bfloat16, got {arr.dtype}")
        return numpy_to_tensor(arr, device)

    return {
        "embed": leaf(params_np["embed"]),
        "pos": leaf(params_np["pos"]),
        "layers": [{k: leaf(layer[k]) for k in _LAYER_KEYS}
                   for layer in params_np["layers"]],
        "unembed": leaf(params_np["unembed"]),
    }


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Normalize over the last axis in fp32 (population variance, as
    ``jnp.var``), returned in the input dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def _host_ints(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = tensor_to_numpy(value)
    return np.asarray(value).reshape(-1).astype(np.int64)


class TinyDecoderModel(Model):
    """``decoder_lm``: 2-layer pre-norm transformer decoder fixture."""

    name = "decoder_lm"
    max_batch_size = 0
    stateful = True

    VOCAB = 256
    D_MODEL = 128
    HEADS = 4
    LAYERS = 2
    MAX_LEN = 128

    # the JAX model's attention_impl values: its dense einsum path and its
    # Pallas kernel, the same function
    ATTENTION_IMPLS = ("einsum", "pallas")

    def __init__(self, seed: int = 0, attention_impl: str = "einsum", *, device="cuda",
                 params: Optional[Params] = None):
        """``attention_impl``: "einsum" (JAX's default) or "pallas", checked
        as JAX checks it; both run ``ops.decode_attention`` (the Hopper kernel
        on a CUDA device). ``params``: weights from :func:`load_jax_params`
        (or :func:`draw_params`); drawn from ``seed`` on first use when
        None."""
        if attention_impl not in self.ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        super().__init__()
        self._seed = seed
        self.attention_impl = attention_impl
        self._device = torch.device(device)
        self._lock = threading.Lock()
        self._params = params
        self._sequences: Dict[Any, Dict[str, Any]] = {}
        # per-sequence serialization: concurrent requests on one sequence_id
        # must not interleave read-compute-write (lost KV updates otherwise)
        self._seq_locks: Dict[Any, threading.Lock] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("TOKENS", "INT32", [1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("LOGITS", "FP32", [1, self.VOCAB]),
            TensorSpec("NEXT_TOKEN", "INT32", [1, 1]),
        ]

    # -- model ---------------------------------------------------------------
    def params(self) -> Params:
        with self._lock:
            if self._params is None:
                self._params = draw_params(self._seed, self._device)
            return self._params

    def fresh_cache(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer static KV cache, k/v [H, MAX_LEN, Dh] bf16."""
        Dh = self.D_MODEL // self.HEADS
        return [
            {
                "k": torch.zeros((self.HEADS, self.MAX_LEN, Dh), dtype=torch.bfloat16,
                                 device=self._device),
                "v": torch.zeros((self.HEADS, self.MAX_LEN, Dh), dtype=torch.bfloat16,
                                 device=self._device),
            }
            for _ in range(self.LAYERS)
        ]

    def step(self, caches, token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One decode step: ``token`` int64 [1] and ``pos`` int32 [1], both on
        the model's device. Writes this position's k/v into ``caches`` IN
        PLACE (the JAX step returns an updated copy; a sequence owns its
        cache here, under its lock) and returns fp32 logits [VOCAB]."""
        params = self.params()
        D, H = self.D_MODEL, self.HEADS
        Dh = D // H
        slot = pos.long()
        x = params["embed"].index_select(0, token)[0] + params["pos"].index_select(0, slot)[0]
        for layer, cache in zip(params["layers"], caches):
            h = _norm(x)
            q, k_new, v_new = (h @ layer["qkv"]).split(D)  # q, k, v order
            cache["k"].index_copy_(1, slot, k_new.view(H, 1, Dh))
            cache["v"].index_copy_(1, slot, v_new.view(H, 1, Dh))
            attn = decode_attention(
                q.view(1, H, Dh), cache["k"][None], cache["v"][None], pos,
            )[0]  # [H, Dh], bf16 (fp32 accumulation inside)
            x = x + attn.reshape(D) @ layer["proj"]
            h2 = _norm(x)
            x = x + F.gelu(h2 @ layer["mlp_in"], approximate="tanh") @ layer["mlp_out"]
        return (_norm(x) @ params["unembed"]).float()

    def fresh_batched_cache(self, slots: int) -> List[torch.Tensor]:
        """Per-layer static KV cache of ``slots`` sequences: one bf16 tensor
        [2, slots, H, MAX_LEN, Dh] a layer, K at index 0 and V at 1 (each a
        contiguous [slots, H, MAX_LEN, Dh], as the kernel takes them), so one
        ``index_copy_`` writes a round's keys and values."""
        Dh = self.D_MODEL // self.HEADS
        return [
            torch.zeros((2, slots, self.HEADS, self.MAX_LEN, Dh), dtype=torch.bfloat16,
                        device=self._device)
            for _ in range(self.LAYERS)
        ]

    def batched_step(self, caches, tokens: np.ndarray, pos: np.ndarray,
                     active: np.ndarray) -> torch.Tensor:
        """One decode step of every slot of :meth:`fresh_batched_cache`
        ``caches``: host arrays ``tokens`` [S], ``pos`` [S] and ``active``
        [S] bool; returns fp32 logits [S, VOCAB] on the device.

        Every slot is computed, so the shapes do not depend on ``active``
        (as the JAX model's ``vmap`` of :meth:`step`), and attention is one
        ``decode_attention`` call a layer at B = S. Only the active slots'
        cache rows are written (IN PLACE): an inactive slot's cache is left
        as it was and its logits mean nothing. Positions are clipped to
        ``MAX_LEN - 1`` before any indexing, so a live slot that has filled
        its cache (pos == MAX_LEN) rides along inactive. The tokens, the
        clipped positions and the active rows' source and target rows go
        to the device in one copy of a fresh host array."""
        params = self.params()
        D, H, M = self.D_MODEL, self.HEADS, self.MAX_LEN
        Dh = D // H
        S = len(tokens)
        slot = np.minimum(np.asarray(pos, np.int64), M - 1)
        rows = np.flatnonzero(active)[None, :, None]
        half = np.arange(2)[:, None, None]  # 0: K, 1: V
        head = np.arange(H)[None, None, :]
        # rows of qkv [S, 3D] viewed [S*3*H, Dh] (q, k, v order) and of the
        # cache [2, S, H, M, Dh] viewed [2*S*H*M, Dh], as (K/V, slot, head)
        src = ((rows * 3 + 1 + half) * H + head).reshape(-1)
        dst = (((half * S + rows) * H + head) * M + slot[rows]).reshape(-1)
        packed = torch.from_numpy(np.concatenate(
            [np.asarray(tokens, np.int64), slot, src, dst])).to(self._device)
        toks, slots, src, dst = packed.split([S, S, src.size, dst.size])
        positions = slots.int()
        x = params["embed"].index_select(0, toks) + params["pos"].index_select(0, slots)
        for layer, kv in zip(params["layers"], caches):
            h = _norm(x)
            qkv = h @ layer["qkv"]  # [S, 3D]
            kv.view(-1, Dh).index_copy_(0, dst, qkv.view(-1, Dh).index_select(0, src))
            q = qkv[:, :D].reshape(S, H, Dh).contiguous()
            attn = decode_attention(q, kv[0], kv[1], positions)  # [S, H, Dh]
            x = x + attn.reshape(S, D) @ layer["proj"]
            h2 = _norm(x)
            x = x + F.gelu(h2 @ layer["mlp_in"], approximate="tanh") @ layer["mlp_out"]
        return (_norm(x) @ params["unembed"]).float()

    def prefill(self, caches, tokens: np.ndarray, start: int) -> torch.Tensor:
        """Run ``tokens`` through :meth:`step` from position ``start`` (the
        same step serves prompt and decode); returns the last logits."""
        toks = torch.as_tensor(tokens, dtype=torch.int64).to(self._device)
        positions = torch.arange(start, start + len(tokens), dtype=torch.int32).to(self._device)
        logits = None
        for i in range(len(tokens)):
            logits = self.step(caches, toks[i:i + 1], positions[i:i + 1])
        return logits

    def greedy(self, caches, token: int, pos: int, count: int) -> List[int]:
        """``count`` greedy tokens fed back on the device (argmax never
        leaves it); one host sync for the lot."""
        tok = torch.tensor([token], dtype=torch.int64).to(self._device)
        slot = torch.tensor([pos], dtype=torch.int32).to(self._device)
        out = []
        for _ in range(count):
            tok = self.step(caches, tok, slot).argmax().view(1)
            slot = slot + 1
            out.append(tok)
        return torch.cat(out).tolist()

    # -- serving -------------------------------------------------------------
    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        seq_id = parameters.get("sequence_id", 0)
        start = parameters.get("sequence_start", False)
        end = parameters.get("sequence_end", False)
        if not seq_id:
            raise ValueError("decoder_lm requires a sequence_id")

        tokens = _host_ints(inputs["TOKENS"])
        if np.any(tokens < 0) or np.any(tokens >= self.VOCAB):
            raise ValueError(f"tokens out of range [0, {self.VOCAB})")

        with self._lock:
            seq_lock = self._seq_locks.setdefault(seq_id, threading.Lock())

        # the whole read-compute-write is serialized PER SEQUENCE (other
        # sequences decode concurrently)
        with seq_lock:
            with self._lock:
                if start:
                    state = None
                else:
                    state = self._sequences.get(seq_id)
                    if state is None:
                        raise ValueError(
                            f"sequence {seq_id} has no live state "
                            "(missing sequence_start?)")
                    if len(tokens) != 1:
                        raise ValueError(
                            "continuation requests carry exactly one token")
                if (0 if state is None else state["pos"]) + len(tokens) > self.MAX_LEN:
                    raise ValueError(
                        f"sequence longer than max_len {self.MAX_LEN}")
            if state is None:
                state = {"caches": self.fresh_cache(), "pos": 0}

            logits = self.prefill(state["caches"], tokens, state["pos"])
            pos = state["pos"] + len(tokens)

            with self._lock:
                if end:
                    self._sequences.pop(seq_id, None)
                    self._seq_locks.pop(seq_id, None)
                else:
                    self._sequences[seq_id] = {"caches": state["caches"], "pos": pos}

        logits_np = tensor_to_numpy(logits).reshape(1, self.VOCAB)
        return {
            "LOGITS": logits_np,
            "NEXT_TOKEN": np.array([[int(logits_np.argmax())]], dtype=np.int32),
        }

    def live_sequences(self) -> int:
        with self._lock:
            return len(self._sequences)
