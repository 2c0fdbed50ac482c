"""The standalone server ``client_tpu_torch.serve`` and the graceful drain of
the port's three frontends, against the JAX package's.

- the drain of ``tests/test_pool.py`` on the threaded HTTP, the aiohttp and
  the GRPC frontends: ``drain()`` flips ready and not live while requests
  still serve; during ``close()`` with a slow request in flight, the
  health routes (and ``/metrics``, whose ready gauge reads 0) answer on
  fresh connections as the JAX server's do, and the slow request
  completes. Each sequence of statuses is held to the JAX server's;
- ``python -m client_tpu_torch.serve --device cpu`` as a subprocess: the
  printed lines, the served model list (the JAX zoo less
  ``decoder_lm_tp_prefill``), SIGTERM
  (ready 503 and live 200 inside the grace window, then exit 0; a second
  SIGTERM ignored), SIGINT (exit at once), ``--http-frontend aio``, the
  flags that wait for ROADMAP A9, and the default device on a machine
  without a card.
"""

import re
import signal
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
# the JAX zoo's models that wait for a later item of ROADMAP.md queue A
NOT_IN_THE_PORT = {"decoder_lm_tp_prefill"}
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

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "client_tpu_torch.serve", *args], cwd=REPO,
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


def _sigterm_window(serve, http_url, grpc_url):
    """SIGTERM, then what a client sees inside serve's 1 s grace window."""
    t0 = time.monotonic()
    serve.proc.send_signal(signal.SIGTERM)
    with port_http.InferenceServerClient(http_url) as h:
        while h.is_server_ready():
            assert time.monotonic() - t0 < 1.0, "ready still 200 after the grace window"
            time.sleep(0.01)
    live, metrics = _get(http_url, "/v2/health/live"), _get(http_url, "/metrics")
    with port_grpc.InferenceServerClient(grpc_url) as g:
        seen = {"live": live[0], "gauges": _gauges(metrics[1]),
                "grpc_ready": g.is_server_ready(), "grpc_live": g.is_server_live()}
    assert time.monotonic() - t0 < 1.0, "the checks outran the grace window"
    return seen


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
    seen = _sigterm_window(serve, http_url, grpc_url)
    serve.proc.send_signal(signal.SIGTERM)  # a repeated SIGTERM is ignored
    assert seen == {"live": 200, "gauges": ["client_tpu_server_live 1",
                                            "client_tpu_server_ready 0"],
                    "grpc_ready": False, "grpc_live": True}
    rc, err = serve.finish()
    assert rc == 0, err
    assert "SIGTERM: draining (ready -> not-ready, finishing in-flight)" in serve.lines
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
    seen = _sigterm_window(serve, http_url, grpc_url)
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


@pytest.mark.parametrize("flags", [
    ["--moe"], ["--tensor-parallel", "2"], ["--attention", "ring"],
    ["--attention", "ulysses"], ["--attention", "auto"],
    ["--vision", "--tensor-parallel", "4"], ["--long-context", "--attention", "ring"],
])
def test_serve_flags_of_a9_fail_before_any_listener(flags):
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.serve", "--http-port", "0", "--grpc-port",
         "0", "--device", "cpu", *flags], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "ROADMAP.md A9" in proc.stderr and flags[-1] in proc.stderr
    assert "listening" not in proc.stdout


def test_serve_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this test checks a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.serve", "--http-port", "0", "--grpc-port",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "listening" not in proc.stdout
