"""Dynamic batcher: coalesce concurrent single requests into one execution.

The counterpart of ``client_tpu.server.batcher`` (tritonserver's dynamic
batcher role). Requests enter a queue; the worker pops the first, then keeps
collecting until ``max_batch`` rows are in hand or ``max_delay_s`` passes.
Compatible requests (same input names, dtypes and per-request non-batch dims,
and identical parameters) are stacked along axis 0, executed ONCE, and the
output rows are handed back to each caller's Future. A request incompatible
with the rest of the window forms its own group: nothing blocks behind shape
mismatches.

Inputs may be host arrays (from the wire) or torch tensors: host arrays
stack with ``np.concatenate``, tensors with ``torch.cat`` on their device
(the two never share a group, as their dtypes differ), and each caller gets
row views of the outputs. Eligibility is decided by the core.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class _Pending:
    __slots__ = ("inputs", "parameters", "future", "enqueued_ns", "rows")

    def __init__(self, inputs, parameters):
        self.inputs = inputs
        self.parameters = parameters
        self.future: Future = Future()
        self.enqueued_ns = time.perf_counter_ns()
        # rows this request contributes to the stacked batch (axis 0)
        first = next(iter(inputs.values()))
        self.rows = int(first.shape[0]) if first.ndim else 1


def _compat_key(inputs: Dict[str, Any], parameters: Dict[str, Any]) -> Tuple:
    """Requests merge ONLY when their inputs line up AND their parameters are
    identical: execute() may honor any parameter, so merging across
    differing parameters would compute under the wrong ones."""
    return (
        tuple(sorted(
            (name, str(arr.dtype), tuple(arr.shape[1:]))
            for name, arr in inputs.items())),
        repr(sorted(parameters.items(), key=lambda kv: kv[0])),
    )


def _stack(arrays: List[Any]):
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(arrays, dim=0)
    return np.concatenate(arrays, axis=0)


class DynamicBatcher:
    """Per-model batching queue in front of ``execute``.

    ``report``: optional callback ``(batch_rows, exec_ns, queue_ns_total,
    n_requests)`` invoked once per executed batch (the JAX core feeds it into
    the protocol's ``InferBatchStatistics``).
    """

    def __init__(
        self,
        execute: Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]],
        max_batch: int,
        max_delay_s: float = 0.002,
        max_queue: int = 1024,
        report: Optional[Callable[[int, int, int, int], None]] = None,
    ):
        self._execute = execute
        self._max_batch = max(int(max_batch), 1)
        self._max_delay_s = max_delay_s
        self._report = report
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._carry: Optional[_Pending] = None  # did not fit the last window's cap
        self._worker = threading.Thread(target=self._run, name="dynamic-batcher", daemon=True)
        self._worker.start()

    # -- caller side --------------------------------------------------------
    def submit(self, inputs: Dict[str, Any], parameters: Dict[str, Any]) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        item = _Pending(inputs, parameters)
        self._queue.put(item)
        return item.future

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=5)
        # a submit() that passed the _closed check right before close() may
        # have enqueued behind the sentinel: fail it rather than strand it
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))

    # -- worker -------------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            first = self._queue.get()
        if first is None:
            return []
        window = [first]
        rows = first.rows
        deadline = time.monotonic() + self._max_delay_s
        while rows < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-signal shutdown after this batch
                break
            if rows + nxt.rows > self._max_batch:
                # would overflow the model's declared cap: it starts the next
                # window instead
                self._carry = nxt
                break
            window.append(nxt)
            rows += nxt.rows
        return window

    def _run(self) -> None:
        while True:
            window = self._collect()
            if not window:
                return
            # group by compatibility; each group executes once
            groups: Dict[Tuple, List[_Pending]] = {}
            for item in window:
                groups.setdefault(_compat_key(item.inputs, item.parameters), []).append(item)
            for items in groups.values():
                self._run_group(items)

    def _run_group(self, items: List[_Pending]) -> None:
        t0 = time.perf_counter_ns()
        queue_ns = sum(t0 - it.enqueued_ns for it in items)
        try:
            if len(items) == 1:
                stacked = items[0].inputs
            else:
                stacked = {name: _stack([it.inputs[name] for it in items])
                           for name in items[0].inputs}
            # safe: the group key pins identical parameters across items
            outputs = self._execute(stacked, items[0].parameters)
            exec_ns = time.perf_counter_ns() - t0
            if self._report is not None:
                self._report(sum(it.rows for it in items), exec_ns, queue_ns, len(items))
            offset = 0
            for it in items:
                it.future.set_result({
                    name: (arr if isinstance(arr, torch.Tensor) else np.asarray(arr))
                    [offset:offset + it.rows]
                    for name, arr in outputs.items()})
                offset += it.rows
        except Exception as e:  # noqa: BLE001 (every caller must hear it)
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
