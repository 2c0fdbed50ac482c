"""Standalone server CLI: serve the port's model zoo over HTTP and GRPC.

The counterpart of ``client_tpu.serve``, a server in a process of its own
for examples, the perf harness and development::

    python -m client_tpu_torch.serve --http-port 8000 --grpc-port 8001 [--vision]

Models run on the card unless ``--device cpu`` is given; with no card the
default fails rather than serving on the CPU. Port 0 binds a free port, and
the printed URLs carry the bound one.

Ctrl-C stops it at once. SIGTERM drains: ``v2/health/ready`` and
``ServerReady`` turn not-ready first (so multi-endpoint pools route away),
in-flight requests finish, then the listeners close. Readiness turns at
the signal's arrival, not when the main thread gets to run its handler
(see ``SignalDrainedCore``). The kernel may hand the signal to any thread
of the process; one that lands on another thread does not wake the main
thread, which therefore sleeps ``SIGNAL_POLL_S`` at a time and runs the
handler at its next wake.

The zoo is the port's ``default_model_zoo``, the JAX package's model for
model. ``--moe`` (``moe_ffn``), ``--tensor-parallel N`` (the vision model's
channels over N devices) and the mesh modes of ``--attention`` (ring,
ulysses, auto) build their meshes over the local devices of ``--device``:
every visible card, or eight mesh entries of the one CPU; the degrees chosen
are printed. ``--attention`` defaults to ``flash``, the one-card kernel
(the JAX CLI's default is ``ring``).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import List, Optional

from .server import ServerCore

# how long the main thread sleeps at a time while it serves: a signal that
# another thread takes trips the Python handler but does not end the main
# thread's sleep, so the handler runs at its next wake
SIGNAL_POLL_S = 0.2


class SignalDrainedCore(ServerCore):
    """A ``ServerCore`` whose ``ready`` reads False from the moment SIGTERM
    arrives. ``signal.set_wakeup_fd`` makes the C-level signal handler
    write the signal's number to a pipe, at once and without the
    interpreter lock, in whatever thread takes the signal; a readiness read
    (``v2/health/ready``, ``ServerReady``, ``/metrics``) drains that pipe and
    turns not-ready on a SIGTERM byte. The Python handler in the main thread
    then drains as before (it sets ``ready`` too)."""

    signal_fd: Optional[int] = None  # the read end of the wakeup pipe

    @property
    def ready(self) -> bool:
        if self._ready and self.signal_fd is not None:
            try:
                if signal.SIGTERM in os.read(self.signal_fd, 64):
                    self._ready = False
            except BlockingIOError:  # no signal has arrived
                pass
        return self._ready

    @ready.setter
    def ready(self, value: bool) -> None:
        self._ready = value


def _mesh_degrees(models) -> str:
    """The mesh size each multi-device model chose, as ``name axis=size``."""
    return ", ".join(f"{m.name} " + " ".join(f"{k}={v}" for k, v in m.mesh_degrees.items())
                     for m in models if m.mesh_degrees)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="client_tpu_torch.serve")
    parser.add_argument("--http-port", type=int, default=8000)
    parser.add_argument("--grpc-port", type=int, default=8001)
    parser.add_argument("--no-http", action="store_true")
    parser.add_argument("--no-grpc", action="store_true")
    parser.add_argument("--vision", action="store_true",
                        help="also serve the image ensemble (preprocess, densenet_onnx, "
                        "ensemble_image)")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="shard vision-model weights over N devices (serving-side tp; "
                        "at most the local devices)")
    parser.add_argument("--identity-fp32", action="store_true",
                        help="also serve a dynamic-shape FP32 identity model")
    parser.add_argument("--long-context", action="store_true",
                        help="also serve long_context_encoder")
    parser.add_argument("--attention", choices=("ring", "ulysses", "auto", "flash"),
                        default="flash",
                        help="attention of --long-context: flash (the one-card kernel), "
                        "or the sequence-parallel ring, ulysses or auto over the local "
                        "devices")
    parser.add_argument("--moe", action="store_true",
                        help="also serve the expert-parallel moe_ffn model over the local "
                        "devices")
    parser.add_argument("--http-frontend", choices=("threaded", "aio"), default="threaded",
                        help="threaded: best single-client latency; aio: an event loop "
                        "for many concurrent connections")
    parser.add_argument("--device", default="cuda",
                        help="where the models run (default cuda; cpu for tests)")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("client_tpu_torch.serve: no CUDA device; pass --device cpu to serve on the "
              "CPU", file=sys.stderr)
        return 2

    from .models import default_model_zoo
    from .models.simple import IdentityModel
    from .server import GrpcInferenceServer, HttpInferenceServer

    models = default_model_zoo(device)
    if args.identity_fp32:
        models.append(IdentityModel("identity_fp32", "FP32", device=device))
    if args.vision:
        from .models.ensemble import build_image_ensemble

        models.extend(build_image_ensemble(tensor_parallel=args.tensor_parallel,
                                           device=device))
    if args.long_context:
        from .models.long_context import LongContextEncoderModel

        models.append(LongContextEncoderModel(attention=args.attention, device=device))
    if args.moe:
        from .models.moe import MoEFFNModel

        models.append(MoEFFNModel(device=device))
    core = SignalDrainedCore(models, device=device)
    degrees = _mesh_degrees(models)

    servers = []
    if not args.no_http:
        if args.http_frontend == "aio":
            from .server import AioHttpInferenceServer

            http = AioHttpInferenceServer(core, port=args.http_port)
        else:
            http = HttpInferenceServer(core, port=args.http_port, verbose=args.verbose)
        http.start()
        servers.append(http)
        print(f"HTTP  server ({args.http_frontend}) listening on {http.url}", flush=True)
    if not args.no_grpc:
        grpc_srv = GrpcInferenceServer(core, port=args.grpc_port)
        grpc_srv.start()
        servers.append(grpc_srv)
        print(f"GRPC  server listening on {grpc_srv.url}", flush=True)
    print(f"models: {', '.join(m.name for m in models)}", flush=True)
    if degrees:
        print(f"mesh degrees: {degrees}", flush=True)

    class _Drain(Exception):
        pass

    def on_sigterm(signum, frame):
        # disarmed first: stop sequences often deliver repeated SIGTERMs,
        # and a second one must not abort the graceful close under way
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise _Drain()

    signal.signal(signal.SIGTERM, on_sigterm)
    # the C-level handler's byte, for readiness reads on any thread
    wake_r, wake_w = os.pipe()
    os.set_blocking(wake_r, False)
    os.set_blocking(wake_w, False)
    signal.set_wakeup_fd(wake_w, warn_on_full_buffer=False)
    core.signal_fd = wake_r
    draining = False
    try:
        while True:
            time.sleep(SIGNAL_POLL_S)
    except KeyboardInterrupt:
        pass
    except _Drain:
        draining = True
    finally:
        # shutdown is under way: no further signal may abort it, and every
        # server stops on any exit path
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        if draining:
            # ready goes first everywhere, so pool probes route away; then
            # each frontend finishes its in-flight work and closes
            print("SIGTERM: draining (ready -> not-ready, finishing in-flight)", flush=True)
            core.ready = False
            time.sleep(1.0)
        for s in servers:
            try:
                if draining:
                    s.close(grace_s=0.0)
                else:
                    s.stop()
            except Exception as e:
                print(f"error stopping {type(s).__name__}: {e}", flush=True)
        core.signal_fd = None
        signal.set_wakeup_fd(-1)
        os.close(wake_r)
        os.close(wake_w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
