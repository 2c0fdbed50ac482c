"""Slot-based sequence batcher: concurrent decodes share one step.

The counterpart of ``client_tpu.models.decoder_batched``: ``decoder_lm_batched``
serves the ``decoder_lm`` contract (sequence_id / start / end, TOKENS in,
LOGITS and NEXT_TOKEN out), but every live sequence holds a slot of one
stacked KV cache ([2, slots, heads, max_len, head_dim] bf16 per layer), a
coalescer thread gathers the sequence requests in flight inside a short
window (``max_delay_s``), and one batched step
(:meth:`TinyDecoderModel.batched_step`) advances them all: one
``decode_attention`` launch a layer a round at B = slots. Slots with no
request in a round ride along inactive and their caches are not written, so
the shapes never change. Prompts longer than one token run in lockstep: each
round consumes the next token of every request in the window.

Positions live on the host (0 on start, +1 per active round) and go to the
device as a fresh copy each round; a window's logits come back to the host
in one copy. Weights come from a composed :class:`TinyDecoderModel` (same
seed, or the same ``params``, as ``decoder_lm``), so greedy tokens match the
unbatched model.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import tensor_to_numpy
from .base import Model, TensorSpec
from .decoder import Params, TinyDecoderModel, _host_ints


class _SeqRequest:
    __slots__ = ("seq_id", "tokens", "start", "end", "future")

    def __init__(self, seq_id, tokens, start, end):
        self.seq_id = seq_id
        self.tokens = tokens  # list of ints, consumed one per round
        self.start = start
        self.end = end
        self.future: Future = Future()

    # The caller may cancel() the future (on its timeout) at any moment:
    # set_result/set_exception on a cancelled future raises
    # InvalidStateError, and an unguarded raise inside the worker's
    # resolution loop would strand every later request in the window.
    def resolve(self, value) -> None:
        try:
            if not self.future.done():
                self.future.set_result(value)
        except InvalidStateError:
            pass  # caller cancelled between the check and the set

    def fail(self, exc: BaseException) -> None:
        try:
            if not self.future.done():
                self.future.set_exception(exc)
        except InvalidStateError:
            pass


class BatchedDecoderModel(Model):
    """``decoder_lm_batched``: the decoder_lm contract, slot-batched."""

    name = "decoder_lm_batched"
    max_batch_size = 0
    stateful = True

    # how long a caller waits to enqueue (503 after) and for its result
    # (504 after)
    QUEUE_TIMEOUT_S = 30.0
    RESULT_TIMEOUT_S = 120.0

    def __init__(self, seed: int = 0, slots: int = 8, max_delay_s: float = 0.002,
                 attention_impl: str = "einsum", idle_ttl_s: float = 300.0, *, device="cuda",
                 params: Optional[Params] = None):
        """JAX's parameters in JAX's order; ``attention_impl`` is checked as
        :class:`TinyDecoderModel` checks it, and both values run
        ``ops.decode_attention``."""
        super().__init__()
        self._decoder = TinyDecoderModel(seed=seed, attention_impl=attention_impl,
                                         device=device, params=params)
        self.slots = int(slots)
        self._max_delay_s = max_delay_s
        # idle-sequence reaper TTL (tritonserver's sequence batcher:
        # max_sequence_idle_microseconds); must exceed the caller's result
        # timeout so a slot whose window is merely slow is never reclaimed
        # under an in-flight step
        self._idle_ttl_s = float(idle_ttl_s)
        self._last_seen: Dict[Any, float] = {}
        self._lock = threading.Lock()
        self._built = False
        self._queue: "queue.Queue[Optional[_SeqRequest]]" = queue.Queue(maxsize=1024)
        self._closed = False
        self._carry: List[_SeqRequest] = []
        # rounds executed per batch width (active slots)
        self.batch_histogram: Dict[int, int] = {}
        self._worker = None  # started with the first build

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("TOKENS", "INT32", [1, -1])]

    def outputs(self) -> List[TensorSpec]:
        return [
            TensorSpec("LOGITS", "FP32", [1, self._decoder.VOCAB]),
            TensorSpec("NEXT_TOKEN", "INT32", [1, 1]),
        ]

    def _ensure_built(self):
        with self._lock:
            if self._built:
                return
            dec = self._decoder
            dec.params()
            self._caches = dec.fresh_batched_cache(self.slots)
            # positions live on the host: 0 on start, +1 per active round,
            # known without reading the device back
            self._pos = np.zeros((self.slots,), np.int32)
            self._slot_of: Dict[Any, int] = {}
            self._free = list(range(self.slots))
            device = dec.device
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._worker = threading.Thread(
                target=self._run, args=(device,), name="sequence-batcher", daemon=True)
            self._worker.start()
            self._built = True

    # -- serving (caller side) ----------------------------------------------
    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        self._ensure_built()
        seq_id = parameters.get("sequence_id", 0)
        if not seq_id:
            raise ValueError("decoder_lm_batched requires a sequence_id")
        start = bool(parameters.get("sequence_start", False))
        end = bool(parameters.get("sequence_end", False))
        tokens = _host_ints(inputs["TOKENS"])
        if tokens.size == 0:
            raise ValueError("empty prompt")
        if np.any(tokens < 0) or np.any(tokens >= self._decoder.VOCAB):
            raise ValueError(f"tokens out of range [0, {self._decoder.VOCAB})")
        if not start and len(tokens) != 1:
            raise ValueError("continuation requests carry exactly one token")
        if self._closed:
            raise ValueError("model is shutting down")
        from ..server.core import InferError

        req = _SeqRequest(seq_id, tokens.tolist(), start, end)
        try:
            # bounded: with a wedged worker the queue fills, and overload
            # must surface as a typed 503, not a hung caller
            self._queue.put(req, timeout=self.QUEUE_TIMEOUT_S)
        except queue.Full:
            raise InferError("sequence batcher queue full (worker stalled?)", 503) from None
        if self._closed:
            # unload() raced us: the worker may already be past its
            # sentinel, leaving this request stranded behind it
            req.fail(ValueError("model is shutting down"))
        try:
            logits = req.future.result(timeout=self.RESULT_TIMEOUT_S)
        except FuturesTimeout:
            # the slot is NOT freed here: the window may still be in flight,
            # and a new sequence in the slot would share its cache; the
            # window's own error path (or sequence_end, or the reaper)
            # reclaims it
            req.future.cancel()
            raise InferError(
                f"batched decode timed out after {self.RESULT_TIMEOUT_S:g}s", 504) from None
        logits_np = logits.reshape(1, self._decoder.VOCAB)
        return {
            "LOGITS": logits_np,
            "NEXT_TOKEN": np.array([[int(logits_np.argmax())]], dtype=np.int32),
        }

    def live_sequences(self) -> int:
        self._ensure_built()
        with self._lock:
            return len(self._slot_of)

    def unload(self) -> None:
        self._closed = True
        self._queue.put(None)
        if self._worker is not None:
            self._worker.join(timeout=10)
        # fail anything that slipped in behind the sentinel (the worker has
        # exited; nothing else will resolve those futures)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.fail(ValueError("model is shutting down"))
        super().unload()

    # -- coalescer worker ----------------------------------------------------
    def _collect(self) -> List[_SeqRequest]:
        """One window: at most one request per sequence (a sequence's second
        request must see the first one's cache, so it waits for the next
        round, as the reference sequence batcher serializes per CORRID)."""
        window, seen, still_carried = [], set(), []
        for req in self._carry:
            if req.seq_id in seen:
                still_carried.append(req)  # FIFO within a sequence
            else:
                window.append(req)
                seen.add(req.seq_id)
        self._carry = still_carried
        if not window:
            first = self._queue.get()
            if first is None:
                return []
            window.append(first)
            seen.add(first.seq_id)
        deadline = time.monotonic() + self._max_delay_s
        while len(window) < self.slots:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)
                break
            if nxt.seq_id in seen:
                # serialize per CORRID but keep collecting: one client's
                # back-to-back request must not shut others out of the round
                self._carry.append(nxt)
                continue
            window.append(nxt)
            seen.add(nxt.seq_id)
        return window

    def _admit(self, req: _SeqRequest) -> int:
        """The request's slot (allocated on sequence_start)."""
        with self._lock:
            if req.start:
                if req.seq_id in self._slot_of:
                    slot = self._slot_of[req.seq_id]  # restart in place
                elif self._free:
                    slot = self._free.pop()
                    self._slot_of[req.seq_id] = slot
                else:
                    raise ValueError(
                        f"no free sequence slot (capacity {self.slots}); "
                        "end a sequence first")
                self._last_seen[req.seq_id] = time.monotonic()
                return slot
            slot = self._slot_of.get(req.seq_id)
            if slot is None:
                raise ValueError(
                    f"sequence {req.seq_id} has no live state "
                    "(missing sequence_start?)")
            self._last_seen[req.seq_id] = time.monotonic()
            return slot

    def _reap_idle(self, exclude) -> None:
        """Free the slots of sequences idle past the TTL (a client that timed
        out mid-sequence and walked away). Sequences with a request in this
        window or carried to the next are excluded."""
        now = time.monotonic()
        with self._lock:
            for seq_id, last in list(self._last_seen.items()):
                if seq_id not in exclude and now - last > self._idle_ttl_s:
                    self._free_slot(seq_id)

    def _run(self, device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.set_device(device)  # the worker owns its device
        while True:
            window = self._collect()
            if not window:
                return
            try:
                self._run_window(window)
            except Exception as e:  # the worker must never die: a dead
                # coalescer wedges every later request on the model
                for req in window:
                    req.fail(e)

    def _run_window(self, window: List[_SeqRequest]) -> None:
        # reap BEFORE admitting, so a full house of abandoned sequences frees
        # up for this window's sequence_start requests
        self._reap_idle(
            exclude={req.seq_id for req in window} | {r.seq_id for r in self._carry})

        dec = self._decoder
        active_reqs: List[tuple] = []  # (req, slot)
        for req in window:
            try:
                slot = self._admit(req)
            except Exception as e:
                req.fail(e)
                continue
            if req.start:
                # the cache rows are overwritten as the prompt streams in,
                # and attention never reads past pos, so stale rows are
                # harmless
                self._pos[slot] = 0
            if int(self._pos[slot]) + len(req.tokens) > dec.MAX_LEN:
                req.fail(ValueError(f"sequence longer than max_len {dec.MAX_LEN}"))
                with self._lock:
                    self._free_slot(req.seq_id)
                continue
            active_reqs.append((req, slot))

        # lockstep rounds: each consumes ONE token of every request that has
        # tokens left; a request's answer is its last round's logits
        rounds: List[torch.Tensor] = []
        last_round: Dict[int, int] = {}  # slot -> index into rounds
        try:
            while any(req.tokens for req, _ in active_reqs):
                tokens = np.zeros((self.slots,), np.int64)
                active = np.zeros((self.slots,), bool)
                for req, slot in active_reqs:
                    if req.tokens:
                        tokens[slot] = req.tokens.pop(0)
                        active[slot] = True
                        last_round[slot] = len(rounds)
                rounds.append(dec.batched_step(self._caches, tokens, self._pos, active))
                self._pos[active] += 1
                width = int(active.sum())
                self.batch_histogram[width] = self.batch_histogram.get(width, 0) + 1
            answered = [(req, slot) for req, slot in active_reqs if slot in last_round]
            host = (tensor_to_numpy(torch.stack(
                [rounds[last_round[slot]][slot] for _, slot in answered]))
                if answered else None)
        except Exception as e:  # a failed step must not strand callers
            for req, _ in active_reqs:
                req.fail(e)
                # a failed step ends the sequence whatever req.end says: the
                # cache may be partly written, and keeping the slot would
                # leak capacity one failed window at a time
                with self._lock:
                    self._free_slot(req.seq_id)
            return

        logits_of = {slot: host[i] for i, (_, slot) in enumerate(answered)}
        for req, slot in active_reqs:
            if req.end:
                with self._lock:
                    self._free_slot(req.seq_id)
            if slot in logits_of:
                req.resolve(logits_of[slot])
            else:
                req.fail(ValueError("request executed no decode step"))

    def _free_slot(self, seq_id) -> None:
        slot = self._slot_of.pop(seq_id, None)
        self._last_seen.pop(seq_id, None)
        if slot is not None:
            self._free.append(slot)
