"""The standalone server ``client_tpu_torch.serve`` and the graceful drain of
the port's three frontends, against the JAX package's.

- the drain of ``tests/test_pool.py`` on the threaded HTTP, the aiohttp and
  the GRPC frontends: ``drain()`` flips ready and not live while requests
  still serve; during ``close()`` with a slow request in flight, the
  health routes (and ``/metrics``, whose ready gauge reads 0) answer on
  fresh connections as the JAX server's do, and the slow request
  completes. Each sequence of statuses is held to the JAX server's;
- the SIGTERM window is read from the child's side (its draining line, and
  listeners that still answer), never against this process's own clock;
- ``python -m client_tpu_torch.serve --device cpu`` as a subprocess: the
  printed lines, the served model list (the JAX zoo, name for name and in
  order), SIGTERM
  (ready 503 and live 200 inside the grace window, then exit 0; a second
  SIGTERM ignored), SIGINT (exit at once), ``--http-frontend aio``, the
  mesh flags (``--moe``, ``--tensor-parallel``, ``--attention
  ring|ulysses|auto``) serving and answering as the same models built in
  this process, and the default device on a machine without a card.
"""

import json
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import client_tpu.grpc as jax_grpc
import client_tpu.http as jax_http
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
import client_tpu_torch.utils as port_utils
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.models.simple import AddSubModel as JaxAddSub
from client_tpu.server import AioHttpInferenceServer as JaxAio
from client_tpu.server import GrpcInferenceServer as JaxGrpc
from client_tpu.server import HttpInferenceServer as JaxHttp
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import AddSubModel
from client_tpu_torch.server import (
    AioHttpInferenceServer,
    GrpcInferenceServer,
    HttpInferenceServer,
    ServerCore,
)
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

REPO = Path(__file__).resolve().parent.parent
# the JAX zoo's models the port's zoo lacks: none since the mesh models came
NOT_IN_THE_PORT = set()
FRONTENDS = {
    "threaded": (HttpInferenceServer, JaxHttp),
    "aio": (AioHttpInferenceServer, JaxAio),
    "grpc": (GrpcInferenceServer, JaxGrpc),
}


def _server(pkg, frontend):
    """A server of ``frontend`` serving ``simple`` from package ``pkg``."""
    port_cls, jax_cls = FRONTENDS[frontend]
    if pkg == "port":
        return port_cls(ServerCore([AddSubModel(device="cpu")], device="cpu")).start()
    return jax_cls(JaxCore([JaxAddSub()])).start()


def _modules(pkg, frontend):
    if frontend == "grpc":
        return port_grpc if pkg == "port" else jax_grpc
    return port_http if pkg == "port" else jax_http


def _simple(mod, client):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    inputs = [mod.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
              for n in ("INPUT0", "INPUT1")]
    return np.array_equal(client.infer("simple", inputs).as_numpy("OUTPUT0"), 2 * a)


def _get(url, path):
    """(status, body) of a GET on a fresh connection; None if refused."""
    try:
        with urllib.request.urlopen(f"http://{url}{path}", timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except (urllib.error.URLError, ConnectionError):
        return None, ""


def _gauges(text):
    return [line for line in text.splitlines()
            if line.startswith(("client_tpu_server_live ", "client_tpu_server_ready "))]


def _probe(frontend, url, mod):
    """The health as a fresh client sees it: statuses (HTTP) or the rpcs'
    answers (GRPC), with ``/metrics``' live and ready gauges."""
    if frontend == "grpc":
        with mod.InferenceServerClient(url) as client:
            return ["live", client.is_server_live(), "ready", client.is_server_ready()]
    live, ready = _get(url, "/v2/health/live"), _get(url, "/v2/health/ready")
    metrics = _get(url, "/metrics")
    return ["live", live[0], "ready", ready[0], "metrics", metrics[0], _gauges(metrics[1])]


# -- drain: tests/test_pool.py's drain cases on the three frontends -------------


def _drain_sequence(pkg, frontend):
    server = _server(pkg, frontend)
    mod = _modules(pkg, frontend)
    seen = []
    try:
        with mod.InferenceServerClient(server.url) as client:
            seen += ["ready", client.is_server_ready(), "live", client.is_server_live()]
            seen += _probe(frontend, server.url, mod)
            server.drain()
            seen += ["ready", client.is_server_ready(), "live", client.is_server_live()]
            seen += ["serves", _simple(mod, client)]  # still serving
            seen += _probe(frontend, server.url, mod)
    finally:
        server.stop()
    return seen


@pytest.mark.parametrize("frontend", list(FRONTENDS))
def test_drain_flips_ready_not_live(frontend):
    ours = _drain_sequence("port", frontend)
    assert ours == _drain_sequence("jax", frontend)
    assert ours[:4] == ["ready", True, "live", True]
    assert ours[ours.index("serves") - 4:ours.index("serves") + 2] == [
        "ready", False, "live", True, "serves", True]
    if frontend != "grpc":
        assert ours[-1] == ["client_tpu_server_live 1", "client_tpu_server_ready 0"]


def _close_sequence(pkg, frontend, grace_s, probe_at_s):
    """close() with a slow request in flight: what a fresh client sees
    ``probe_at_s`` into it, and how the slow request ends."""
    server = _server(pkg, frontend)
    mod = _modules(pkg, frontend)
    model = server.core.model("simple")
    execute = model.execute

    def slow(inputs, params):
        time.sleep(0.8)  # holds the request in flight through close()
        return execute(inputs, params)

    model.execute = slow
    outcome = []

    def slow_infer():
        try:
            with mod.InferenceServerClient(server.url) as client:
                outcome.append(_simple(mod, client))
        except Exception as e:  # recorded: the caller asserts on it
            outcome.append(repr(e))

    worker = threading.Thread(target=slow_infer)
    closer = threading.Thread(target=server.close, args=(grace_s,))
    worker.start()
    time.sleep(0.2)  # the slow request is in flight
    t0 = time.monotonic()
    closer.start()
    time.sleep(probe_at_s)
    seen = _probe(frontend, server.url, mod)
    in_window = time.monotonic() - t0 < grace_s + 0.5
    worker.join(15)
    closer.join(20)
    return seen, outcome, in_window


@pytest.mark.parametrize("frontend,grace_s,probe_at_s", [
    # the threaded server: past the grace, while close() waits on the request
    ("threaded", 0.05, 0.2),
    # every frontend: inside the grace window
    ("threaded", 0.6, 0.1), ("aio", 0.6, 0.1), ("grpc", 0.6, 0.1),
])
def test_health_answers_while_closing_with_a_request_in_flight(frontend, grace_s, probe_at_s):
    ours, ours_outcome, in_window = _close_sequence("port", frontend, grace_s, probe_at_s)
    theirs, theirs_outcome, _ = _close_sequence("jax", frontend, grace_s, probe_at_s)
    assert in_window
    assert ours == theirs
    assert ours_outcome == theirs_outcome == [True]
    if frontend == "grpc":
        assert ours == ["live", True, "ready", False]
    else:
        assert ours == ["live", 200, "ready", 503, "metrics", 200,
                        ["client_tpu_server_live 1", "client_tpu_server_ready 0"]]


@pytest.mark.parametrize("frontend", list(FRONTENDS))
def test_metrics_gauges_read_the_core(frontend):
    core = ServerCore([AddSubModel(device="cpu")], device="cpu")
    text = core.metrics_registry().prometheus_text
    assert _gauges(text()) == ["client_tpu_server_live 1", "client_tpu_server_ready 1"]
    server = FRONTENDS[frontend][0](core).start()
    try:
        server.drain()
        assert core.ready is False and core.live is True
        assert _gauges(text()) == ["client_tpu_server_live 1", "client_tpu_server_ready 0"]
        core.live = False
        assert _gauges(text()) == ["client_tpu_server_live 0", "client_tpu_server_ready 0"]
        if frontend != "grpc":
            assert _get(server.url, "/v2/health/live")[0] == 503
    finally:
        server.stop()


# -- python -m client_tpu_torch.serve -----------------------------------------


class Serve:
    """``python -m client_tpu_torch.serve ARGS`` with its output read line by
    line."""

    def __init__(self, *args, command=("-m", "client_tpu_torch.serve")):
        self.proc = subprocess.Popen(
            [sys.executable, *command, *args], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, prefix, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.lines):
                if line.startswith(prefix):
                    return line
            if self.proc.poll() is not None and not self._reader.is_alive():
                break
            time.sleep(0.02)
        raise AssertionError(f"no {prefix!r} line: {self.lines} {self.proc.stderr.read()}")

    def urls(self, frontend="threaded"):
        http = self.wait_for(f"HTTP  server ({frontend}) listening on ").rsplit(" ", 1)[1]
        grpc = self.wait_for("GRPC  server listening on ").rsplit(" ", 1)[1]
        return http, grpc

    def finish(self, timeout=15):
        rc = self.proc.wait(timeout)
        self._reader.join(5)
        return rc, self.proc.stderr.read()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)


@pytest.fixture
def serve_cpu():
    started = []

    def start(*args):
        started.append(Serve("--http-port", "0", "--grpc-port", "0", "--device", "cpu", *args))
        return started[-1]

    yield start
    for s in started:
        s.kill()


DRAINING = "SIGTERM: draining (ready -> not-ready, finishing in-flight)"


def _held_request(http_url):
    """A ``simple`` infer whose body is still on its way: the threaded
    frontend counts it in flight from its headers on, and serve's close
    waits for in-flight requests before the listener goes, so the drain
    window lasts until the body is finished. (The aio frontend closes its
    listener first; gRPC, closed after HTTP, stays up either way.)"""
    a = list(range(16))
    body = json.dumps({"inputs": [
        {"name": n, "shape": [1, 16], "datatype": "INT32", "data": a}
        for n in ("INPUT0", "INPUT1")]}).encode()
    host, port = http_url.split(":")
    sock = socket.create_connection((host, int(port)), timeout=30)
    sock.sendall(b"POST /v2/models/simple/infer HTTP/1.1\r\nHost: %s\r\n"
                 b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                 % (http_url.encode(), len(body)) + body[:8])
    # one round trip on a second connection: the held one was accepted first
    assert _get(http_url, "/v2/health/ready")[0] == 200
    return sock, body[8:]


def _grpc_health(grpc_url):
    """(ready, live) over gRPC, or None when the listener is gone."""
    try:
        with port_grpc.InferenceServerClient(grpc_url) as g:
            return g.is_server_ready(), g.is_server_live()
    except Exception:
        return None


def _observe_drain(serve, http_url, grpc_url):
    """SIGTERM, then what a client sees inside serve's grace window, read
    from the child's side: the window opens with the child's draining line
    and lasts while its listeners answer (they close only after the
    grace). None when a listener was already gone: the window passed
    before this process could look, which says nothing of the server."""
    sock, rest = _held_request(http_url)
    try:
        serve.proc.send_signal(signal.SIGTERM)
        serve.wait_for(DRAINING)
        ready = _get(http_url, "/v2/health/ready")[0]
        while ready == 200:  # the line is printed just before ready flips
            time.sleep(0.01)
            ready = _get(http_url, "/v2/health/ready")[0]
        live, metrics = _get(http_url, "/v2/health/live"), _get(http_url, "/metrics")
        grpc = _grpc_health(grpc_url)
    finally:
        try:
            sock.sendall(rest)
            sock.recv(65536)
        except OSError:
            pass
        sock.close()
    if None in (ready, live[0], metrics[0], grpc):
        return None
    return {"ready": ready, "live": live[0], "gauges": _gauges(metrics[1]),
            "grpc_ready": grpc[0], "grpc_live": grpc[1]}


def _sigterm_window(serve_cpu, serve, args=(), frontend="threaded"):
    """``(serve, http_url, seen)``: the drain as a client sees it. A window
    that passed unobserved (this process was descheduled past the child's
    grace) is taken again on a fresh child, at most twice more; a window
    that was observed is returned as it was, right or wrong."""
    for _ in range(3):
        http_url, grpc_url = serve.urls(frontend)
        seen = _observe_drain(serve, http_url, grpc_url)
        if seen is not None:
            return serve, http_url, seen
        rc, err = serve.finish()
        assert rc == 0, err
        serve = serve_cpu(*args)
    raise AssertionError("three drain windows closed before this process could observe them")


def test_serve_prints_serves_and_drains_on_sigterm(serve_cpu):
    serve = serve_cpu()
    http_url, grpc_url = serve.urls()
    for url in (http_url, grpc_url):
        assert re.fullmatch(r"127\.0\.0\.1:[1-9][0-9]*", url)
    models = serve.wait_for("models: ")[len("models: "):].split(", ")
    jax_names = [m.name for m in jax_zoo()]
    assert set(jax_names) - set(models) == NOT_IN_THE_PORT
    assert set(models) == set(jax_names) - NOT_IN_THE_PORT
    assert models == [n for n in jax_names if n not in NOT_IN_THE_PORT]
    with port_http.InferenceServerClient(http_url) as h, \
            port_grpc.InferenceServerClient(grpc_url) as g:
        assert h.is_server_ready() and g.is_server_ready()
        assert _simple(port_http, h) and _simple(port_grpc, g)
    serve, http_url, seen = _sigterm_window(serve_cpu, serve)
    serve.proc.send_signal(signal.SIGTERM)  # a repeated SIGTERM is ignored
    assert seen == {"ready": 503, "live": 200, "gauges": ["client_tpu_server_live 1",
                                                          "client_tpu_server_ready 0"],
                    "grpc_ready": False, "grpc_live": True}
    rc, err = serve.finish()
    assert rc == 0, err
    assert DRAINING in serve.lines
    assert _get(http_url, "/v2/health/live")[0] is None  # the listener is gone


def test_serve_aio_frontend_with_the_extra_models(serve_cpu):
    serve = serve_cpu("--http-frontend", "aio", "--identity-fp32", "--long-context",
                      "--attention", "flash")
    http_url, grpc_url = serve.urls("aio")
    models = serve.wait_for("models: ")
    assert models.endswith(", identity_fp32, long_context_encoder")
    x = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    with port_http.InferenceServerClient(http_url) as h:
        assert _simple(port_http, h)
        inp = port_http.InferInput("sequence", [16, 64], "FP32").set_data_from_numpy(x)
        out = h.infer("long_context_encoder", [inp]).as_numpy("encoded")
    assert out.shape == (16, 64) and np.isfinite(out).all()
    with jax_http.InferenceServerClient(http_url) as h:  # the JAX client too
        assert _simple(jax_http, h)
    args = ("--http-frontend", "aio", "--identity-fp32", "--long-context", "--attention", "flash")
    serve, http_url, seen = _sigterm_window(serve_cpu, serve, args, "aio")
    assert seen["ready"] == 503
    assert seen["live"] == 200 and not seen["grpc_ready"] and seen["grpc_live"]
    assert seen["gauges"] == ["client_tpu_server_live 1", "client_tpu_server_ready 0"]
    rc, err = serve.finish()
    assert rc == 0, err


def test_serve_sigint_stops_at_once(serve_cpu):
    serve = serve_cpu("--no-grpc")
    http_url = serve.wait_for("HTTP  server (threaded) listening on ").rsplit(" ", 1)[1]
    serve.wait_for("models: ")
    assert not any(line.startswith("GRPC") for line in serve.lines)
    t0 = time.monotonic()
    serve.proc.send_signal(signal.SIGINT)
    rc, err = serve.finish()
    assert rc == 0, err
    assert time.monotonic() - t0 < 5.0  # no grace window, no wait on requests
    assert not any(line.startswith("SIGTERM") for line in serve.lines)
    assert _get(http_url, "/v2/health/live")[0] is None


def _flag_answer(flags, http_url):
    """The answer of the model ``flags`` add (``simple`` where they add
    none), beside the same model built in this process on the CPU: (got,
    want, rtol / atol)."""
    rng = np.random.default_rng(5)
    with port_http.InferenceServerClient(http_url) as h:
        if "--moe" in flags:
            from client_tpu_torch.models.moe import MoEFFNModel

            x = rng.standard_normal((64, 32)).astype(np.float32)
            bad = port_http.InferInput("tokens", [63, 32], "FP32").set_data_from_numpy(x[:63])
            with pytest.raises(port_utils.InferenceServerException, match="divide") as err:
                h.infer("moe_ffn", [bad])
            assert err.value.status() == "400"
            inp = port_http.InferInput("tokens", [64, 32], "FP32").set_data_from_numpy(x)
            want = MoEFFNModel(device="cpu").execute({"tokens": x}, {})["routed"].numpy()
            return h.infer("moe_ffn", [inp]).as_numpy("routed"), want, 2e-5
        if "--long-context" in flags:
            from client_tpu_torch.models import LongContextEncoderModel

            mode = flags[flags.index("--attention") + 1]
            x = rng.standard_normal((64, 64)).astype(np.float32)
            inp = port_http.InferInput("sequence", [64, 64], "FP32").set_data_from_numpy(x)
            want = LongContextEncoderModel(attention=mode, device="cpu").execute(
                {"sequence": x}, {})["encoded"].numpy()
            return h.infer("long_context_encoder", [inp]).as_numpy("encoded"), want, 2e-5
        if "--vision" in flags:
            from client_tpu_torch.models import DenseNetModel

            x = rng.standard_normal((3, 224, 224)).astype(np.float32)
            inp = port_http.InferInput("data_0", [3, 224, 224], "FP32").set_data_from_numpy(x)
            want = DenseNetModel(device="cpu").execute({"data_0": x}, {})["fc6_1"].numpy()
            got = h.infer("densenet_onnx", [inp]).as_numpy("fc6_1")
            assert got.argmax() == want.argmax()
            return got, want, 2e-2  # tensor_parallel=4 against tp = 1
        assert _simple(port_http, h)
        return np.zeros(1), np.zeros(1), 0.0


@pytest.mark.parametrize("flags,degrees", [
    (["--moe"], "moe_ffn data=1 model=8"),
    (["--tensor-parallel", "2"], "decoder_lm_tp_prefill model=4"),
    (["--attention", "ring"], "decoder_lm_tp_prefill model=4"),
    (["--attention", "ulysses"], "decoder_lm_tp_prefill model=4"),
    (["--attention", "auto"], "decoder_lm_tp_prefill model=4"),
    (["--vision", "--tensor-parallel", "4"], "densenet_onnx data=1 model=4"),
    (["--long-context", "--attention", "ring"], "long_context_encoder data=8 model=1"),
])
def test_serve_flags_of_a9_fail_before_any_listener(serve_cpu, flags, degrees):
    """The mesh flags, which exited before any listener until their models
    were ported, now serve: the child prints the mesh degrees it chose over
    the CPU's eight mesh entries and answers as the same model built here."""
    serve = serve_cpu(*flags)
    http_url, _ = serve.urls()
    assert degrees in serve.wait_for("mesh degrees: ")
    got, want, tol = _flag_answer(flags, http_url)
    np.testing.assert_allclose(got, want, rtol=tol if tol < 1e-2 else 0, atol=tol)
    serve.proc.send_signal(signal.SIGINT)
    rc, err = serve.finish()
    assert rc == 0, err


def test_serve_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this test checks a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.serve", "--http-port", "0", "--grpc-port",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "listening" not in proc.stdout


# a serve child whose main thread blocks SIGTERM once it waits, so the
# kernel hands the signal to another thread of the process (every frontend
# thread was started with it unblocked)
MAIN_BLOCKS_SIGTERM = r"""
import signal, sys, threading, time
sys.path.insert(0, sys.argv[1])
from client_tpu_torch import serve
real_sleep = time.sleep
def sleep(s):
    if threading.current_thread() is threading.main_thread():
        signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
    return real_sleep(s)
serve.time.sleep = sleep
sys.exit(serve.main(sys.argv[2:]))
"""


def test_sigterm_taken_by_another_thread_drains_and_exits():
    """SIGTERM delivered to a thread other than the main one (here forced:
    the main thread blocks it while it waits) still drains: readiness turns
    at once, the main thread runs the handler at its next wake, prints the
    draining line and exits 0, as when it takes the signal itself."""
    serve = Serve("--http-port", "0", "--grpc-port", "0", "--device", "cpu",
                  command=("-c", MAIN_BLOCKS_SIGTERM, str(REPO)))
    try:
        http_url, _ = serve.urls()
        assert _get(http_url, "/v2/health/ready")[0] == 200
        serve.proc.send_signal(signal.SIGTERM)
        serve.wait_for(DRAINING, timeout=10)
        rc, err = serve.finish()
        assert rc == 0, err
    finally:
        serve.kill()


def test_readiness_turns_at_the_signal_byte():
    """``serve``'s core turns not-ready on the byte the C-level SIGTERM
    handler writes to the wakeup pipe, read by a frontend thread, without
    the main thread running its Python handler (which, under load, can
    wait over a second for the interpreter lock while the frontends answer
    200); another signal's byte (SIGINT) leaves it ready, and the main
    thread's own ``ready = False`` / ``True`` still sets it."""
    import os

    from client_tpu_torch.serve import SignalDrainedCore

    core = SignalDrainedCore([AddSubModel(device="cpu")], device="cpu")
    r, w = os.pipe()
    os.set_blocking(r, False)
    try:
        assert core.ready  # no pipe yet
        core.signal_fd = r
        seen = []

        def probe():
            seen.append(core.ready)

        os.write(w, bytes([signal.SIGINT]))
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        os.write(w, bytes([signal.SIGTERM]))
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        assert seen == [True, False]
        assert core.ready is False  # stays drained: the byte was read once
        core.ready = True  # the setter still rules
        assert core.ready is True
        core.ready = False
        assert core.ready is False
    finally:
        os.close(r)
        os.close(w)
