"""Bi-directional streaming machinery for GRPC inference.

The counterpart of ``client_tpu.grpc._stream``: a request queue drained by a
``_RequestIterator`` feeding the bidi call, and a reader thread dispatching
``callback(result, error)`` per response. Stream death marks the stream
inactive; a new stream must be started — unless the client opened the
stream with ``auto_reconnect=True``, in which case
:class:`_ReconnectingStream` re-establishes the bidi call under the client's
resilience policy and surfaces a typed ``resilience.StreamReconnected``
event through the callback.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import grpc

from ..resilience import StreamReconnected
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

    def __init__(self, callback: Callable[[Optional[InferResult], Optional[Exception]], None], verbose: bool = False):
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
                    # otherwise-empty infer_response; expose it so a
                    # reconnecting wrapper can retire the exact pending
                    # entry instead of guessing by order
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
        except Exception as e:  # defensive: never kill the thread silently
            with self._lock:
                self._active = False
            self._callback(None, InferenceServerException(f"stream failure: {e}"))

    def is_active(self) -> bool:
        with self._lock:
            return self._active

    def enqueue(self, request: Dict[str, Any], idempotent: bool = True) -> None:
        # ``idempotent`` is meaningful for _ReconnectingStream (same
        # signature so the client treats both stream kinds uniformly)
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


class _PendingRequest:
    """One in-flight stream request tracked for reconnect accounting."""

    __slots__ = ("request", "idempotent", "sent")

    def __init__(self, request: Dict[str, Any], idempotent: bool):
        self.request = request
        self.idempotent = idempotent
        self.sent = False  # placed on a live stream's request queue


class _ReconnectingStream:
    """A bidi stream that survives transport death.

    Wraps ``_InferStream``: every enqueued request is tracked until a
    response with its id arrives (requests without an id get an
    auto-assigned ``_ctpu_rc_N`` — the server echoes it back). When the
    inner stream dies with a retryable fault, a new bidi call is opened
    after the policy's backoff and the callback receives a
    ``StreamReconnected`` event (as the result, ``error=None``). In-flight
    idempotent requests are transparently re-sent in order; in-flight
    NON-idempotent requests (sequence infers: the server may already have
    applied their state transition) are NEVER silently re-sent — their ids
    arrive in ``StreamReconnected.abandoned_request_ids`` and the
    application owns re-driving the sequence.

    Decoupled caveat: a request's pending entry is retired at its final
    response (``triton_final_response``; absent means unary-per-request),
    so a decoupled generation interrupted mid-stream is re-issued from the
    start if idempotent, never resumed from the middle.
    """

    def __init__(self, open_fn: Callable[[Callable], _InferStream],
                 callback: Callable, policy, verbose: bool = False):
        if policy is None or policy.retry is None:
            raise InferenceServerException(
                "auto_reconnect requires a resilience policy with a RetryPolicy"
            )
        self._open_fn = open_fn
        self._callback = callback
        self._policy = policy
        self._verbose = verbose
        self._lock = threading.Lock()
        self._pending: "OrderedDict[str, _PendingRequest]" = OrderedDict()
        self._auto_id = itertools.count(1)
        self._closed = False
        self._dead = False
        self._closing = threading.Event()  # wakes a sleeping backoff
        self._inner: Optional[_InferStream] = None
        self._attempt = 0  # consecutive reconnects without a response

    def start(self) -> None:
        self._inner = self._open_fn(self._on_event)

    def is_active(self) -> bool:
        with self._lock:
            if self._closed or self._dead:
                return False
        inner = self._inner
        return inner is not None and inner.is_active()

    def enqueue(self, request: Dict[str, Any], idempotent: bool = True) -> None:
        with self._lock:
            if self._closed or self._dead:
                raise InferenceServerException(
                    "the stream is no longer in a valid state; start a new stream"
                )
            rid = request.get("id")
            if not rid:
                rid = f"_ctpu_rc_{next(self._auto_id)}"
                request["id"] = rid
            pending = _PendingRequest(request, idempotent)
            # sent is marked BEFORE the put: once the request is on the live
            # queue the gRPC sender may transmit it immediately, and a
            # reconnect racing this thread must err toward "may have reached
            # the server" (abandon) — never toward a silent re-send
            pending.sent = True
            self._pending[rid] = pending
            inner = self._inner
        try:
            inner.enqueue(request)
        except InferenceServerException:
            # the inner stream died before the put: the request provably
            # never left this process. Downgrade sent only if no reconnect
            # has intervened — a racing reconnect may already have
            # snapshotted (or re-sent) this entry, and a late sent=False
            # would schedule a duplicate send at the next reconnect.
            with self._lock:
                if self._inner is inner and rid in self._pending:
                    pending.sent = False

    def close(self, cancel_requests: bool = False) -> None:
        with self._lock:
            self._closed = True
            inner = self._inner
        self._closing.set()  # interrupt a reader thread mid-backoff
        if inner is not None:
            inner.close(cancel_requests)

    # -- event path (runs on the inner stream's reader thread) --------------
    def _on_event(self, result: Optional[InferResult], error) -> None:
        if error is None:
            resp = result.get_response() if result is not None else {}
            rid = resp.get("id")
            tfr = resp.get("parameters", {}).get("triton_final_response")
            final = True if tfr is None else bool(tfr.get("bool_param", False))
            with self._lock:
                if rid and final:
                    self._pending.pop(rid, None)
                self._attempt = 0  # the transport is demonstrably healthy
            self._callback(result, None)
            return
        inner = self._inner
        if inner is not None and inner.is_active():
            # per-request in-band error (_read_loop dispatched an
            # error_message response and kept reading): the bidi call is
            # healthy — surface the error, do NOT tear down or reconnect.
            # Retire the errored request's pending entry: exactly, when the
            # server attached its id (this framework's server does); else
            # the OLDEST sent entry (requests are processed in order). A
            # mis-retire errs fail-safe — at worst a request is NOT re-sent
            # after a reconnect, never double-applied — and pending cannot
            # grow unboundedly on an error-heavy stream.
            rid = getattr(error, "request_id", None)
            with self._lock:
                if rid is None:
                    rid = next(
                        (r for r, p in self._pending.items() if p.sent), None)
                if rid is not None:
                    self._pending.pop(rid, None)
            self._callback(None, error)
            return
        with self._lock:
            if self._closed:
                give_up = True  # user-initiated teardown: pass through
            else:
                domain = self._policy.classify(error)
                retry = self._policy.retry
                # idempotent=True: request-level idempotency is handled by
                # the resend/abandon split below, so only the policy's
                # domain gates decide whether the STREAM comes back (e.g.
                # retry_timeouts=False keeps stream_timeout terminal)
                give_up = (
                    not retry.retries_domain(domain, True)
                    or self._attempt + 1 >= retry.max_attempts
                )
            if give_up:
                self._dead = True
        if give_up:
            self._callback(None, error)
            return
        delay = retry.backoff_s(self._attempt)
        if self._verbose:
            print(f"stream died ({error}); reconnecting in {delay:.3f}s")
        # interruptible: close() must not wait out a long backoff
        self._closing.wait(delay)
        with self._lock:
            if self._closed:  # torn down during the backoff sleep
                self._dead = True
                return
        try:
            new_inner = self._open_fn(self._on_event)
        except Exception as e:  # channel-level failure opening the call
            with self._lock:
                self._dead = True
            self._callback(None, InferenceServerException(
                f"stream reconnect failed: {e}"))
            return
        with self._lock:
            if self._closed:  # close() raced the open: tear the call down
                self._dead = True
                closed_late = True
                self._pending.clear()
            else:
                closed_late = False
                self._attempt += 1
                attempt = self._attempt
                # swap + snapshot in ONE critical section: a concurrent
                # enqueue() is either in the snapshot (added before this
                # block) or targets new_inner (added after) — never both.
                # An enqueue racing the dead inner's put is handled on its
                # side: the sent=False downgrade applies only if no
                # reconnect intervened, so the failure direction here is
                # abandon/fail-safe (a sequence request that never left the
                # process may be reported abandoned), never a double-apply.
                self._inner = new_inner
                resend, abandoned = [], []
                for rid, pending in list(self._pending.items()):
                    if pending.sent and not pending.idempotent:
                        # may have reached the server: re-sending could
                        # apply a sequence state transition twice —
                        # surface, don't send
                        abandoned.append(rid)
                        del self._pending[rid]
                    else:
                        resend.append(pending)
        if closed_late:
            new_inner.close()
            return
        event = StreamReconnected(
            attempt=attempt,
            resent_request_ids=[p.request["id"] for p in resend],
            abandoned_request_ids=abandoned,
            cause=error,
        )
        observer = getattr(self._policy, "observer", None)
        if observer is not None:
            # exactly-once telemetry bridge: the observer (observe.
            # Telemetry) counts the reconnect + abandoned sequences here,
            # BEFORE the user callback can swallow or re-raise on the
            # event; the traced callback only annotates the span
            try:
                observer.on_stream_reconnect(event)
            except TypeError:
                # duck-typed observer protocol: a pre-event observer takes
                # no arguments — its reconnect accounting must keep firing
                try:
                    observer.on_stream_reconnect()
                except Exception:
                    pass
            except Exception:
                pass
        # event BEFORE the resends hit the wire: the app learns which ids
        # are being re-sent before the new reader thread can deliver any of
        # their responses (the new stream carries no requests until below)
        self._callback(event, None)
        for pending in resend:
            pending.sent = True  # on the wire the instant the put lands
            try:
                new_inner.enqueue(pending.request)
            except InferenceServerException:
                pending.sent = False  # never left: the next reconnect resends
