"""In-process TCP fault-injection proxy (toxiproxy-style).

A localhost TCP proxy that sits between a client and a real server and
injects transport faults on command, so ``tests/test_resilience.py`` can
prove retry / circuit-breaker / stream-reconnect behavior against live
HTTP and GRPC servers instead of mocks. Works for any byte protocol —
it never parses what it forwards.

Fault vocabulary (see :class:`Fault`):

- ``latency``   — delay every forwarded chunk by ``latency_s``.
- ``reset``     — hard TCP reset (RST via SO_LINGER 0) once ``after_bytes``
  total bytes have crossed the proxy in either direction. ``after_bytes=0``
  resets immediately after accept (connect succeeds, then dies).
- ``blackhole`` — accept, read and discard client bytes, never connect
  upstream, never answer (exercises read-timeout paths).
- ``stall``     — forward the request, deliver ``after_bytes`` of the
  response, then stop forwarding while holding the socket open
  (partial-write-then-stall).
- ``flap``      — reset at accept on every ``every``-th connection
  (connection flapping).
- ``corrupt``   — deliver the response intact up to ``after_bytes``
  (skip the HTTP headers), then corrupt the next ``corrupt_bytes``
  response bytes: seeded deterministic bit-flips
  (``corrupt_mode="flip"``, the default) or a clean FIN truncation
  (``corrupt_mode="truncate"`` — the body ends short of its
  Content-Length). Transport stays perfectly healthy either way; only
  the payload lies — the integrity layer's problem, not the retry
  layer's.

``Fault.limit`` bounds how many connections a fault is applied to
(``None`` = unlimited) — set ``limit=1`` to fault exactly the first
connection and let retries through, or clear ``proxy.fault = None`` to
heal. ``reset_active()`` RSTs currently-established connections (kills a
live GRPC stream mid-flight).

Usage::

    proxy = ChaosProxy("127.0.0.1", server.port).start()
    client = InferenceServerClient(proxy.url)
    proxy.fault = Fault("reset", after_bytes=64, limit=1)
    ...
    proxy.stop()
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["ChaosCell", "ChaosProxy", "Fault"]

_KINDS = ("latency", "reset", "blackhole", "stall", "flap", "corrupt")


class Fault:
    """One fault rule applied to connections accepted while it is set."""

    def __init__(
        self,
        kind: str,
        after_bytes: int = 0,
        latency_s: float = 0.0,
        every: int = 1,
        limit: Optional[int] = None,
        corrupt_bytes: int = 1,
        corrupt_mode: str = "flip",
        seed: int = 0,
    ):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {_KINDS})")
        if every < 1:
            raise ValueError("every must be >= 1")
        if corrupt_mode not in ("flip", "truncate"):
            raise ValueError(
                f"corrupt_mode must be 'flip' or 'truncate', "
                f"not {corrupt_mode!r}")
        if corrupt_bytes < 1:
            raise ValueError("corrupt_bytes must be >= 1")
        self.kind = kind
        self.after_bytes = after_bytes
        self.latency_s = latency_s
        self.every = every
        self.limit = limit
        self.corrupt_bytes = corrupt_bytes
        self.corrupt_mode = corrupt_mode
        self.seed = seed
        # seeded once per Fault: the same rule corrupts the same offsets
        # with the same bit patterns, run after run (bench replayability)
        self._rng = random.Random(seed)
        self._applied = 0
        self._lock = threading.Lock()

    def claim(self, conn_index: int) -> bool:
        """Whether this connection (1-based accept index) gets the fault."""
        with self._lock:
            if self.limit is not None and self._applied >= self.limit:
                return False
            if conn_index % self.every != 0:
                return False
            self._applied += 1
            return True

    def __repr__(self) -> str:
        return (f"Fault({self.kind!r}, after_bytes={self.after_bytes}, "
                f"latency_s={self.latency_s}, every={self.every}, "
                f"limit={self.limit})")


def _rst_close(sock: socket.socket) -> None:
    """Close with an RST instead of FIN (SO_LINGER onoff=1, linger=0)."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _Connection:
    """One proxied connection: two pump threads + shared fault state."""

    def __init__(self, proxy: "ChaosProxy", client: socket.socket,
                 fault: Optional[Fault]):
        self.proxy = proxy
        self.client = client
        self.fault = fault
        self.upstream: Optional[socket.socket] = None
        self.total_bytes = 0
        self._lock = threading.Lock()
        self._dead = False
        self._threads: List[threading.Thread] = []
        # corrupt-fault state (s2c): where the first response's header
        # block ends and how many body bytes have been forwarded since
        self._hdr_done = False
        self._hdr_scan = b""
        self._body_seen = 0

    def run(self) -> None:
        fault = self.fault
        if fault is not None and fault.kind == "flap":
            self.proxy._note_fault()
            _rst_close(self.client)
            return
        if fault is not None and fault.kind == "blackhole":
            self.proxy._note_fault()
            # own thread: swallowing this client until it gives up must not
            # block the accept loop (later connections would stall unproxied)
            t = threading.Thread(
                target=self._blackhole, name="chaos_blackhole", daemon=True)
            self._threads.append(t)
            t.start()
            return
        try:
            self.upstream = socket.create_connection(
                (self.proxy.upstream_host, self.proxy.upstream_port),
                timeout=10,
            )
            self.upstream.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # short poll timeout, NOT blocking recv: a pump blocked in
            # recv() pins the fd in the kernel, deferring kill()'s RST
            # until data arrives — which for an idle connection is never
            self.upstream.settimeout(0.2)
            self.client.settimeout(0.2)
        except OSError:
            _rst_close(self.client)
            return
        if fault is not None:
            self.proxy._note_fault()
        for src, dst, direction in (
            (self.client, self.upstream, "c2s"),
            (self.upstream, self.client, "s2c"),
        ):
            t = threading.Thread(
                target=self._pump, args=(src, dst, direction),
                name=f"chaos_{direction}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    def _blackhole(self) -> None:
        try:
            # inside the try: a kill() racing this thread's start may have
            # closed the socket already
            self.client.settimeout(0.2)
            while not self._dead:
                try:
                    if not self.client.recv(65536):
                        break
                except socket.timeout:
                    continue
        except OSError:
            pass
        finally:
            _rst_close(self.client)

    def _pump(self, src: socket.socket, dst: socket.socket, direction: str) -> None:
        fault = self.fault
        try:
            while True:
                try:
                    data = src.recv(65536)
                except socket.timeout:
                    if self._dead:
                        return
                    continue
                while self.proxy.pause_forwarding and not self._dead:
                    time.sleep(0.005)  # freeze established flows on command
                if self._dead:
                    return
                if not data:
                    try:
                        dst.shutdown(socket.SHUT_WR)  # propagate half-close
                    except OSError:
                        pass
                    return
                if fault is not None and fault.kind == "latency":
                    time.sleep(fault.latency_s)
                if fault is not None and fault.kind == "reset":
                    with self._lock:
                        self.total_bytes += len(data)
                        tripped = self.total_bytes >= fault.after_bytes
                    if tripped:
                        self.kill()
                        return
                if fault is not None and fault.kind == "corrupt" and direction == "s2c":
                    data, close_after = self._corrupt_s2c(data, fault)
                    if data:
                        dst.sendall(data)
                    if close_after:
                        # clean FIN: the client sees a short body against
                        # its Content-Length — a payload lie, not a reset
                        try:
                            dst.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                        return
                    continue
                if fault is not None and fault.kind == "stall" and direction == "s2c":
                    with self._lock:
                        budget = fault.after_bytes - self.total_bytes
                        self.total_bytes += len(data)
                    if budget <= 0:
                        # hold the socket open, forward nothing more
                        while not self._dead:
                            time.sleep(0.05)
                        return
                    data = data[:budget]
                dst.sendall(data)
        except OSError:
            self.kill()

    def _corrupt_s2c(self, data: bytes, fault: Fault) -> "Tuple[bytes, bool]":
        """Apply the corrupt fault to one s2c chunk.

        Returns ``(bytes_to_forward, close_after)``. The first response's
        HTTP header block passes through untouched (found by scanning for
        the first blank line, spanning chunk boundaries); body bytes then
        count toward the corruption window ``[after_bytes,
        after_bytes + corrupt_bytes)``. ``flip`` XORs each window byte
        with a seeded nonzero mask and forwards everything else intact —
        sizes, framing and Content-Length all stay consistent, only the
        payload lies. ``truncate`` forwards up to the window and then
        FINs, a short read against the declared Content-Length."""
        if not self._hdr_done:
            merged = self._hdr_scan + data
            pos = merged.find(b"\r\n\r\n")
            if pos < 0:
                self._hdr_scan = merged[-3:]
                return data, False  # still inside the header block
            self._hdr_done = True
            body_at = pos + 4 - len(self._hdr_scan)
            self._hdr_scan = b""
            head, body = data[:body_at], data[body_at:]
        else:
            head, body = b"", data
        lo = fault.after_bytes - self._body_seen
        hi = lo + fault.corrupt_bytes
        self._body_seen += len(body)
        if fault.corrupt_mode == "truncate":
            if lo >= len(body):
                return head + body, False  # window not reached yet
            return head + body[:max(0, lo)], True
        out = bytearray(body)
        for j in range(max(0, lo), min(len(out), hi)):
            out[j] ^= fault._rng.randrange(1, 256)
        return head + bytes(out), False

    def kill(self) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
        _rst_close(self.client)
        if self.upstream is not None:
            _rst_close(self.upstream)


class ChaosProxy:
    """A localhost TCP proxy with runtime-injectable faults.

    ``fault`` may be swapped at any time; it applies to connections
    accepted from then on (use :meth:`reset_active` to also kill
    already-established ones). Thread-per-pump keeps it simple and is
    plenty for test traffic.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 listen_port: int = 0):
        self.upstream_host = upstream_host
        self.upstream_port = upstream_port
        self.fault: Optional[Fault] = None
        # freeze established connections (bytes buffer, nothing forwarded)
        # without killing them — pairs with reset_active() to make in-flight
        # requests provably un-delivered before the connection dies
        self.pause_forwarding = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", listen_port))
        self._listener.listen(128)
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        self._conns: List[_Connection] = []
        self.stats: Dict[str, int] = {"connections": 0, "faulted": 0}

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    @property
    def url(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "ChaosProxy":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaos_accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.reset_active()

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def reset_active(self) -> None:
        """RST every currently-established proxied connection (kills live
        streams mid-flight; new connections are unaffected)."""
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.kill()

    def heal(self) -> None:
        """Clear the fault rule; subsequent connections pass through clean."""
        self.fault = None

    def _note_fault(self) -> None:
        with self._lock:
            self.stats["faulted"] += 1

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self.stats["connections"] += 1
                index = self.stats["connections"]
            fault = self.fault
            if fault is not None and not fault.claim(index):
                fault = None
            conn = _Connection(self, client, fault)
            with self._lock:
                self._conns = [c for c in self._conns if not c._dead]
                self._conns.append(conn)
            conn.run()


class ChaosCell:
    """Cell-scale fault orchestration: fault a GROUP of proxies as one.

    A multi-cell federation test needs to kill a whole cell — every
    replica's proxy, in one call, mid-replay — not flip proxies one by
    one while traffic threads the gaps. ``ChaosCell`` groups existing
    :class:`ChaosProxy` instances (one per replica of the "cell") and
    applies each fault verb to all of them atomically: the fault rule is
    installed on EVERY proxy first, and only then are the established
    connections of every proxy reset — so no request accepted after the
    call sees a healthy replica of a cell that is supposed to be dead.

    Reuses the per-proxy fault vocabulary verbatim::

        cell = ChaosCell([proxy_a1, proxy_a2])
        cell.blackhole()        # the whole cell goes dark mid-flight
        cell.heal()             # and comes back
        cell.kill()             # RST storm: reset at accept + live RSTs
        cell.latency(0.05)      # uniform 50 ms added per forwarded chunk
        cell.flap(3)            # every 3rd connection RSTs at accept

    Independent of the federation layer: any test driving a pool (or a
    bare client) across several proxies can group them."""

    def __init__(self, proxies: Sequence[ChaosProxy]):
        if not proxies:
            raise ValueError("a chaos cell needs at least one proxy")
        self.proxies: List[ChaosProxy] = list(proxies)

    @property
    def urls(self) -> List[str]:
        return [p.url for p in self.proxies]

    def _apply(self, fault_factory, reset_active: bool) -> None:
        """Install one independently-constructed Fault per proxy (a
        shared Fault object would pool its ``limit``/counters across the
        cell), then reset established connections — faults first, so a
        connection racing the call lands on an already-faulted proxy."""
        for proxy in self.proxies:
            proxy.fault = fault_factory()
        if reset_active:
            for proxy in self.proxies:
                proxy.reset_active()

    def blackhole(self, reset_active: bool = True) -> None:
        """The whole cell goes dark: new connections are accepted and
        swallowed (never answered), established ones are RST (unless
        ``reset_active=False`` — then in-flight requests run out their
        own timeouts, the slow-blackhole shape)."""
        self._apply(lambda: Fault("blackhole"), reset_active)

    def kill(self) -> None:
        """RST storm: every new connection resets immediately after
        accept, every established one resets now."""
        self._apply(lambda: Fault("reset", after_bytes=0), True)

    def latency(self, latency_s: float) -> None:
        """Uniform added latency per forwarded chunk, cell-wide."""
        self._apply(
            lambda: Fault("latency", latency_s=latency_s), False)

    def flap(self, every: int = 2) -> None:
        """Connection flapping cell-wide (every ``every``-th accept
        RSTs)."""
        self._apply(lambda: Fault("flap", every=every), False)

    def heal(self, reset_active: bool = False) -> None:
        """Clear every proxy's fault (and un-pause forwarding);
        subsequent connections pass through clean. ``reset_active=True``
        also drops connections established while faulted — a blackholed
        socket a client is still waiting on does NOT recover by itself."""
        for proxy in self.proxies:
            proxy.fault = None
            proxy.pause_forwarding = False
        if reset_active:
            for proxy in self.proxies:
                proxy.reset_active()

    def pause(self) -> None:
        """Freeze every established flow (bytes buffer, nothing
        forwarded) without killing anything; :meth:`heal` releases."""
        for proxy in self.proxies:
            proxy.pause_forwarding = True

    def reset_active(self) -> None:
        """RST every currently-established connection, cell-wide."""
        for proxy in self.proxies:
            proxy.reset_active()

    def stats(self) -> Dict[str, int]:
        """Aggregated accept/fault counters across the cell's proxies."""
        out = {"connections": 0, "faulted": 0}
        for proxy in self.proxies:
            for key in out:
                out[key] += proxy.stats.get(key, 0)
        return out
