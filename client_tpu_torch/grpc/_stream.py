"""Bi-directional streaming machinery for GRPC inference.

The counterpart of ``client_tpu.grpc._stream`` without its reconnecting
stream: a request queue drained by a ``_RequestIterator`` feeding the bidi
call, and a reader thread dispatching ``callback(result, error)`` per
response. Stream death marks the stream inactive; a new stream must be
started (the port has no resilience policy to reconnect under yet).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

import grpc

from ..utils import InferenceServerException
from ._infer import InferResult


class _RequestIterator:
    """Blocking iterator over enqueued request dicts; ``None`` closes it."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()

    def put(self, request: Optional[Dict[str, Any]]) -> None:
        self._queue.put(request)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        return item


class _InferStream:
    """One live bidi ModelStreamInfer call."""

    def __init__(self, callback: Callable[[Optional[InferResult], Optional[Exception]], None],
                 verbose: bool = False):
        self._callback = callback
        self._verbose = verbose
        self._requests = _RequestIterator()
        self._call = None
        self._reader: Optional[threading.Thread] = None
        self._active = True
        self._lock = threading.Lock()

    def start(self, stream_callable, metadata, timeout, compression=None) -> None:
        self._call = stream_callable(
            self._requests, metadata=metadata, timeout=timeout,
            compression=compression,
        )
        self._reader = threading.Thread(
            target=self._read_loop, name="client_tpu_torch_grpc_stream", daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            for response in self._call:
                err_msg = response.get("error_message")
                if err_msg:
                    error = InferenceServerException(err_msg)
                    # servers may attach the failing request's id in the
                    # otherwise-empty infer_response
                    rid = response.get("infer_response", {}).get("id")
                    if rid:
                        error.request_id = rid
                    self._callback(None, error)
                    continue
                result = InferResult(response.get("infer_response", {}))
                if self._verbose:
                    print(result.get_response())
                self._callback(result, None)
        except grpc.RpcError as rpc_error:
            # deliver the true grpc status to the callback, CANCELLED
            # included (StatusCode.CANCELLED / StatusCode.UNAVAILABLE)
            with self._lock:
                self._active = False
            code = rpc_error.code() if hasattr(rpc_error, "code") else None
            details = (
                rpc_error.details() if hasattr(rpc_error, "details") else str(rpc_error)
            )
            if code == grpc.StatusCode.CANCELLED:
                error = InferenceServerException(
                    details or "Locally cancelled by application!",
                    status="StatusCode.CANCELLED",
                )
            else:
                error = InferenceServerException(
                    details or f"stream closed: {rpc_error}",
                    status=f"StatusCode.{code.name}" if code else None,
                )
            self._callback(None, error)
        except Exception as e:  # never kill the thread silently
            with self._lock:
                self._active = False
            self._callback(None, InferenceServerException(f"stream failure: {e}"))

    def is_active(self) -> bool:
        with self._lock:
            return self._active

    def enqueue(self, request: Dict[str, Any]) -> None:
        if not self.is_active():
            raise InferenceServerException(
                "the stream is no longer in a valid state; start a new stream"
            )
        self._requests.put(request)

    def close(self, cancel_requests: bool = False) -> None:
        if cancel_requests and self._call is not None:
            self._call.cancel()
        self._requests.put(None)
        if self._reader is not None:
            self._reader.join(timeout=30)
            self._reader = None
        with self._lock:
            self._active = False
