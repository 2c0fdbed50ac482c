"""Client base: plugin hook, auth, request bag, cumulative client statistics.

The counterpart of ``client_tpu._base``: the plugin/auth hook, the request
header bag, ``RequestTimers`` (with the host<->device transfer points) and
``InferStat``. The layers the JAX package hangs off this base (telemetry,
resilience, integrity, the shm arena, batching, caching) are not part of the
port yet; the base carries none of their hooks.
"""

from __future__ import annotations

import abc
import base64
import threading
import time
from typing import Dict, Optional

# wire family segment -> data-plane family
SHM_FAMILY_OF = {
    "systemsharedmemory": "system",
    "cudasharedmemory": "cuda",
}


class Request:
    """A mutable view of an outgoing request handed to plugins (headers bag)."""

    def __init__(self, headers: Dict[str, str]):
        self.headers = headers


class InferenceServerClientPlugin(abc.ABC):
    """A plugin is invoked with the Request before every network operation.

    Subclass and implement ``__call__`` to mutate headers (auth tokens,
    tracing ids, ...).
    """

    @abc.abstractmethod
    def __call__(self, request: Request) -> None:
        ...


class BasicAuth(InferenceServerClientPlugin):
    """HTTP basic auth plugin: sets the ``authorization`` header."""

    def __init__(self, username: str, password: str):
        creds = f"{username}:{password}".encode("utf-8")
        self._auth_header = "Basic " + base64.b64encode(creds).decode("ascii")

    def __call__(self, request: Request) -> None:
        request.headers["authorization"] = self._auth_header


class InferenceServerClientBase:
    """Holds the (single) registered plugin and applies it before network ops."""

    def __init__(self):
        self._plugin: Optional[InferenceServerClientPlugin] = None

    def _call_plugin(self, request: Request) -> None:
        if self._plugin is not None:
            self._plugin(request)

    def register_plugin(self, plugin: InferenceServerClientPlugin) -> None:
        if plugin is None:
            raise ValueError("cannot register a null plugin")
        if self._plugin is not None:
            raise ValueError("A plugin is already registered. Unregister it first.")
        self._plugin = plugin

    def plugin(self) -> Optional[InferenceServerClientPlugin]:
        return self._plugin

    def unregister_plugin(self) -> None:
        if self._plugin is None:
            raise ValueError("No plugin is registered.")
        self._plugin = None


class RequestTimers:
    """Per-request monotonic nanosecond timestamps.

    The reference's six points plus two device-transfer points (host->device
    and device->host staging around the wire/shm hop).
    """

    REQUEST_START = "REQUEST_START"
    REQUEST_END = "REQUEST_END"
    SEND_START = "SEND_START"
    SEND_END = "SEND_END"
    RECV_START = "RECV_START"
    RECV_END = "RECV_END"
    H2D_START = "H2D_START"  # host->device staging
    H2D_END = "H2D_END"
    D2H_START = "D2H_START"  # device->host staging
    D2H_END = "D2H_END"

    __slots__ = ("_ts",)

    def __init__(self):
        self._ts: Dict[str, int] = {}

    def capture(self, kind: str) -> None:
        self._ts[kind] = time.perf_counter_ns()

    def get(self, kind: str) -> Optional[int]:
        return self._ts.get(kind)

    def duration_ns(self, start_kind: str, end_kind: str) -> int:
        s, e = self._ts.get(start_kind), self._ts.get(end_kind)
        if s is None or e is None or e < s:
            return 0
        return e - s


class InferStat:
    """Cumulative client-side inference statistics (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.completed_request_count = 0
        self.cumulative_total_request_time_ns = 0
        self.cumulative_send_time_ns = 0
        self.cumulative_receive_time_ns = 0
        self.cumulative_h2d_time_ns = 0
        self.cumulative_d2h_time_ns = 0

    def update(self, timers: RequestTimers) -> None:
        with self._lock:
            self.completed_request_count += 1
            self.cumulative_total_request_time_ns += timers.duration_ns(
                RequestTimers.REQUEST_START, RequestTimers.REQUEST_END
            )
            self.cumulative_send_time_ns += timers.duration_ns(
                RequestTimers.SEND_START, RequestTimers.SEND_END
            )
            self.cumulative_receive_time_ns += timers.duration_ns(
                RequestTimers.RECV_START, RequestTimers.RECV_END
            )
            self.cumulative_h2d_time_ns += timers.duration_ns(
                RequestTimers.H2D_START, RequestTimers.H2D_END
            )
            self.cumulative_d2h_time_ns += timers.duration_ns(
                RequestTimers.D2H_START, RequestTimers.D2H_END
            )

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return {
                "completed_request_count": self.completed_request_count,
                "cumulative_total_request_time_ns": self.cumulative_total_request_time_ns,
                "cumulative_send_time_ns": self.cumulative_send_time_ns,
                "cumulative_receive_time_ns": self.cumulative_receive_time_ns,
                "cumulative_h2d_time_ns": self.cumulative_h2d_time_ns,
                "cumulative_d2h_time_ns": self.cumulative_d2h_time_ns,
            }

    def __str__(self) -> str:
        d = self.as_dict()
        n = max(d["completed_request_count"], 1)
        return (
            f"completed_request_count {d['completed_request_count']}\n"
            f"avg_request_time_us {d['cumulative_total_request_time_ns'] // n // 1000}\n"
            f"avg_send_time_us {d['cumulative_send_time_ns'] // n // 1000}\n"
            f"avg_receive_time_us {d['cumulative_receive_time_ns'] // n // 1000}\n"
            f"avg_h2d_time_us {d['cumulative_h2d_time_ns'] // n // 1000}\n"
            f"avg_d2h_time_us {d['cumulative_d2h_time_ns'] // n // 1000}"
        )
