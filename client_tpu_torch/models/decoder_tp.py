"""Tensor-parallel autoregressive decode behind the v2 sequence API.

The counterpart of ``client_tpu.models.decoder_tp``: ``decoder_lm_tp``, the
decode step of ``decoder_lm`` (same weights, same wire contract, the same
sequence table and locks, inherited) run over a mesh axis of ``n`` shards,
Megatron's layout made explicit:

- attention is head-sharded: shard j holds the q, k and v columns of heads
  ``[j*H/n, (j+1)*H/n)`` (head-major ``wq/wk/wv [D, H, Dh]`` sliced on H) and
  each sequence's KV caches ``[H/n, MAX_LEN, Dh]`` bf16 on its device, so the
  cache update and attention are local: one ``ops.decode_attention`` call a
  shard a layer (the Hopper kernel on a CUDA shard, its plain version on the
  CPU), at ``q [1, H/n, Dh]``;
- ``mlp_in`` is column-parallel: each shard computes its slice of the
  ``[4D]`` activation;
- the row-side contractions (the attention output projection and
  ``mlp_out``) run whole on all-gathered activations, as JAX's: no
  contraction is split into partial sums, so no reduction is re-associated;
- the embeddings, norms and unembedding are replicated, computed once on
  the mesh's first device (the "home" device).

Per head the attention bits do not depend on the head count at the served
shape (one split: ``MAX_LEN`` is below ``MIN_SPLIT``). The column slices of
the projections could pick another matmul kernel than the whole products
and so give other bits; on the CPU and on an H100 the logits came out
bit-equal to ``decoder_lm``'s at 1, 2 and 4 shards, and the tests (on the
CPU) and ``chip_smoke.py`` (on the card) hold them so; against JAX's
``TPDecoderModel`` the tests hold the tokens equal and the logits within
their stated bound.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops.decode_attention import decode_attention
from ..parallel import Mesh, all_gather, local_devices
from .decoder import Params, TinyDecoderModel, _norm


class TPDecoderModel(TinyDecoderModel):
    """``decoder_lm_tp``: :class:`TinyDecoderModel` sharded over a mesh axis."""

    name = "decoder_lm_tp"

    def __init__(self, seed: int = 0, tp: Optional[int] = None, mesh: Optional[Mesh] = None,
                 axis: str = "model", device="cuda", params: Optional[Params] = None):
        """``mesh`` + ``axis``: serve over that mesh axis; else ``tp``: a 1-D
        mesh over the first ``tp`` of ``local_devices(device)`` (None: the
        largest divisor of HEADS that fits). HEADS (4) must divide by the
        axis size. The mesh is resolved at the first build, as JAX's."""
        if mesh is not None:
            device = mesh.axis_devices(axis)[0]
        super().__init__(seed=seed, device=device, params=params)
        self._mesh = mesh
        self._axis = axis
        self._tp = tp
        self._mesh_lock = threading.Lock()
        self._shards: Optional[List[Dict[str, Any]]] = None

    def _ensure_mesh(self) -> Mesh:
        with self._mesh_lock:
            if self._mesh is None:
                devices = local_devices(self._device)
                tp = self._tp or max(d for d in range(1, self.HEADS + 1)
                                     if self.HEADS % d == 0 and d <= max(len(devices), 1))
                if tp > len(devices):
                    raise ValueError(f"tp={tp} but only {len(devices)} devices")
                self._mesh = Mesh(devices[:tp], (self._axis,))
            size = self._mesh.shape[self._axis]
            if self.HEADS % size:
                raise ValueError(f"HEADS={self.HEADS} not divisible by {self._axis} axis "
                                 f"size {size}")
            return self._mesh

    @property
    def tp_degree(self) -> int:
        return self._ensure_mesh().shape[self._axis]

    @property
    def mesh_degrees(self) -> Dict[str, int]:
        return {self._axis: self.tp_degree}

    @property
    def shard_devices(self) -> List[torch.device]:
        return self._ensure_mesh().axis_devices(self._axis)

    def shard_weights(self) -> List[Dict[str, Any]]:
        """Each shard's weights on its device: per layer ``qkv`` [D, 3D/n]
        (its heads' q, k and v columns, in that order) and ``mlp_in``
        [D, 4D/n]. The mesh is checked before any weight is drawn."""
        devices = self.shard_devices
        with self._mesh_lock:
            if self._shards is not None:
                return self._shards
        params = self.params()
        D, n = self.D_MODEL, len(devices)
        width = D // n
        shards = []
        for j, dev in enumerate(devices):
            cols = slice(j * width, (j + 1) * width)
            layers = []
            for layer in params["layers"]:
                qkv = layer["qkv"]
                mlp = layer["mlp_in"]
                hidden = mlp.shape[1] // n
                layers.append({
                    "qkv": torch.cat([qkv[:, part * D:(part + 1) * D][:, cols]
                                      for part in range(3)], 1).to(dev),
                    "mlp_in": mlp[:, j * hidden:(j + 1) * hidden].contiguous().to(dev),
                })
            shards.append({"device": dev, "layers": layers})
        with self._mesh_lock:
            if self._shards is None:
                self._shards = shards
            return self._shards

    def fresh_cache(self) -> List[List[Dict[str, torch.Tensor]]]:
        """Per layer, per shard: k/v [H/n, MAX_LEN, Dh] bf16 on the shard's device."""
        devices = self.shard_devices
        heads, Dh = self.HEADS // len(devices), self.D_MODEL // self.HEADS
        return [[{name: torch.zeros((heads, self.MAX_LEN, Dh), dtype=torch.bfloat16,
                                    device=dev) for name in ("k", "v")}
                 for dev in devices]
                for _ in range(self.LAYERS)]

    def step(self, caches, token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The decode step of :meth:`TinyDecoderModel.step` over the shards:
        ``token`` int64 [1] and ``pos`` int32 [1] on the home device; each
        shard writes its heads' k/v IN PLACE and returns fp32 logits [VOCAB]
        on the home device."""
        params = self.params()
        shards = self.shard_weights()
        devices = [s["device"] for s in shards]
        home = self._device
        heads, Dh = self.HEADS // len(shards), self.D_MODEL // self.HEADS
        width = heads * Dh
        slot = pos.long()
        at = {dev: (pos.to(dev), slot.to(dev)) for dev in set(devices)}
        x = params["embed"].index_select(0, token)[0] + params["pos"].index_select(0, slot)[0]
        for index, (layer, layer_caches) in enumerate(zip(params["layers"], caches)):
            h = _norm(x)
            attn = []
            for shard, cache in zip(shards, layer_caches):
                dev = shard["device"]
                pos_d, slot_d = at[dev]
                q, k_new, v_new = (h.to(dev) @ shard["layers"][index]["qkv"]).split(width)
                cache["k"].index_copy_(1, slot_d, k_new.view(heads, 1, Dh))
                cache["v"].index_copy_(1, slot_d, v_new.view(heads, 1, Dh))
                attn.append(decode_attention(q.view(1, heads, Dh), cache["k"][None],
                                             cache["v"][None], pos_d)[0])  # [H/n, Dh]
            # gather the heads, then contract whole on the home device
            gathered = all_gather(attn, 0, [home])[0]
            x = x + gathered.reshape(self.D_MODEL) @ layer["proj"]
            h2 = _norm(x)
            mid = [F.gelu(h2.to(shard["device"]) @ shard["layers"][index]["mlp_in"],
                          approximate="tanh") for shard in shards]
            x = x + all_gather(mid, 0, [home])[0] @ layer["mlp_out"]
        return (_norm(x) @ params["unembed"]).float()
