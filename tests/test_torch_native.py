"""The port's native clients (``client_tpu_torch.native``) on the CPU.

The C++ clients of ``native/`` built from source by
``client_tpu_torch.native_build`` (``g++``, no cmake), with the port's cuda
registration entry points. The 2x2 matrix: the port's ``NativeClient`` /
``NativeGrpcClient`` against the JAX package's servers and the port's, their
outputs equal across the two. Then ``tests/test_native.py``'s ctypes checks
one by one against the port's servers (the tpu family there is the cuda
family here: the port's servers serve no tpusharedmemory route).
"""

import queue
import socket
import threading
import time

import numpy as np
import pytest
import torch

from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import native
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.models.simple import IdentityModel
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from test_grpc_compression import _CapturingProxy
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

A = np.arange(16, dtype=np.int32).reshape(1, 16)
B = np.ones((1, 16), dtype=np.int32)


@pytest.fixture(autouse=True, scope="module")
def _built():
    """The library built once for the file (a parallel worker's build is
    waited for under the file lock), before any test's time limit."""
    native.load()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def servers():
    """{(package, protocol): server}: each package's default zoo over HTTP
    and gRPC."""
    port_core = ServerCore(default_model_zoo("cpu"), device="cpu")
    jax_core = JaxCore(jax_zoo())
    made = {("port", "http"): HttpInferenceServer(port_core).start(),
            ("port", "grpc"): GrpcInferenceServer(port_core).start(),
            ("jax", "http"): JaxHttpServer(jax_core).start(),
            ("jax", "grpc"): JaxGrpcServer(jax_core).start()}
    yield made
    for server in made.values():
        server.stop()


CLIENTS = {"http": native.NativeClient, "grpc": native.NativeGrpcClient}


def _client(servers, package, protocol):
    return CLIENTS[protocol](servers[(package, protocol)].url)


def _matrix_outputs(client):
    """What the matrix compares: the value model, BYTES, a sequence, an
    identity of each fixed width, and a typed error's message."""
    out = {}
    got = client.infer("simple", [("INPUT0", A), ("INPUT1", B)],
                       outputs=["OUTPUT0", "OUTPUT1"], request_id="m-1")
    out["simple"] = {k: v.tolist() for k, v in got.items()}
    got = client.infer("simple", [("INPUT0", A), ("INPUT1", B)])
    out["enumerated"] = sorted(got)
    words = np.array([[str(i) for i in range(16)]], dtype=np.object_)
    ones = np.array([["1"] * 16], dtype=np.object_)
    out["string"] = client.infer("simple_string", [("INPUT0", words), ("INPUT1", ones)])[
        "OUTPUT0"].tolist()
    for start, end in [(True, False), (False, True)]:
        seq = client.infer("simple_sequence", [("INPUT", np.array([[4]], np.int32))],
                           sequence=(777, start, end))
    out["sequence"] = seq["OUTPUT"].tolist()
    x = np.linspace(-3, 3, 1024, dtype=np.float32).reshape(1, 1024)
    out["identity_fp32"] = client.infer("identity_fp32", [("INPUT0", x)])["OUTPUT0"].tolist()
    out["raw"] = client.infer_raw("custom_identity_int32", "INPUT0",
                                  np.arange(32, dtype=np.int32).reshape(1, 32),
                                  "OUTPUT0").tolist()
    out["live"], out["ready"] = client.is_server_live(), client.is_model_ready("simple")
    out["missing_ready"] = client.is_model_ready("missing")
    with pytest.raises(InferenceServerException) as err:
        client.infer("missing", [("INPUT0", A)])
    out["error"] = str(err.value)
    return out


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_matrix_outputs_equal_on_both_servers(servers, protocol):
    """The port's native client against the JAX package's server and the
    port's: the same outputs (and the same error text)."""
    got = {}
    for package in ("jax", "port"):
        with _client(servers, package, protocol) as client:
            got[package] = _matrix_outputs(client)
    assert got["port"] == got["jax"]
    assert got["port"]["simple"]["OUTPUT0"] == (A + B).tolist()
    assert got["port"]["sequence"] == [[8]] and got["port"]["live"] and got["port"]["ready"]
    assert not got["port"]["missing_ready"] and "missing" in got["port"]["error"]


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_matrix_cuda_shm_round_trip(servers, package, protocol):
    """A ``NativeCudaShmRegion`` registered through the port's cuda entry
    points on either package's server: the input read from the window, the
    output written back into another."""
    x = np.arange(64, dtype=np.float32).reshape(1, 64) * 0.25
    tag = f"{package}{protocol}{time.monotonic_ns()}"
    regions = {n: native.NativeCudaShmRegion(n + tag, x.nbytes) for n in ("in", "out")}
    try:
        with _client(servers, package, protocol) as client:
            for n, region in regions.items():
                client.register_cuda_shared_memory(n + tag, region.raw_handle(), 0, x.nbytes)
            regions["in"].write(x)
            out = client.infer(
                "identity_fp32", [("INPUT0", ("shm", "in" + tag, x.nbytes, 0, "FP32", [1, 64]))],
                outputs=[("OUTPUT0", ("shm", "out" + tag, x.nbytes, 0))])
            assert out == {}
            np.testing.assert_array_equal(regions["out"].read(np.float32, [1, 64]), x)
            client.unregister_shared_memory("cuda", "")
    finally:
        for region in regions.values():
            region.destroy()


def test_ctypes_binding(servers):
    with native.NativeClient(servers[("port", "http")].url) as client:
        assert client.is_server_live()
        assert client.is_model_ready("simple")
        assert not client.is_model_ready("missing")
        data = np.arange(32, dtype=np.int32).reshape(1, 32)
        out = client.infer_raw("custom_identity_int32", "INPUT0", data, "OUTPUT0")
        np.testing.assert_array_equal(out, data.reshape(-1))


def test_ctypes_cuda_shm_interop(servers):
    """A native region's bytes read through ``attach_from_raw_handle``, and
    the reverse."""
    region = native.NativeCudaShmRegion("interop", 64)
    try:
        data = np.arange(16, dtype=np.int32)
        region.write(data)
        attached = cudashm.attach_from_raw_handle(region.raw_handle(), device="cpu")
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(attached, "INT32", [16]), data)
        attached.write_host(np.full(16, 9, dtype=np.int32).tobytes())
        np.testing.assert_array_equal(region.read(np.int32, [16]), np.full(16, 9))
        attached.detach()
    finally:
        region.destroy()


def test_ctypes_python_region_read_by_native_attach():
    """The reverse direction of the handle: a Python cuda region's raw
    handle attached by the C library (``NativeCudaShmRegion.attach``)."""
    py_region = cudashm.create_shared_memory_region("pyside", 64, device="cpu")
    try:
        cudashm.set_shared_memory_region(py_region, [np.arange(16, dtype=np.int32) * 3])
        attached = native.NativeCudaShmRegion.attach(cudashm.get_raw_handle(py_region), 64)
        try:
            np.testing.assert_array_equal(attached.read(np.int32, [16]),
                                          np.arange(16) * 3)
        finally:
            attached.destroy()
    finally:
        cudashm.destroy_shared_memory_region(py_region)


def test_ctypes_full_value_model(servers):
    """Multi-input infer with options + output enumeration via the C API."""
    with native.NativeClient(servers[("port", "http")].url) as client:
        out = client.infer("simple", [("INPUT0", A), ("INPUT1", B)],
                           outputs=["OUTPUT0", "OUTPUT1"], request_id="capi-1")
        np.testing.assert_array_equal(out["OUTPUT0"], A + B)
        np.testing.assert_array_equal(out["OUTPUT1"], A - B)
        out = client.infer("simple", [("INPUT0", A), ("INPUT1", B)])
        assert set(out) == {"OUTPUT0", "OUTPUT1"}
        np.testing.assert_array_equal(out["OUTPUT1"], A - B)
        for start, end in [(True, False), (False, True)]:
            seq_out = client.infer("simple_sequence", [("INPUT", np.array([[4]], np.int32))],
                                   sequence=(778, start, end))
        assert seq_out["OUTPUT"][0, 0] == 8
        with pytest.raises(InferenceServerException, match="unknown model"):
            client.infer("missing", [("INPUT0", A)])


def test_ctypes_bytes_and_shm_outputs(servers):
    """BYTES wire format + all-shm outputs through the C API."""
    with native.NativeClient(servers[("port", "http")].url) as client:
        data = np.array([[str(i) for i in range(16)]], dtype=np.object_)
        ones = np.array([["1"] * 16], dtype=np.object_)
        out = client.infer("simple_string", [("INPUT0", data), ("INPUT1", ones)])
        assert out["OUTPUT0"][0, 5] == b"6"
        region = cudashm.create_shared_memory_region("capi_out", 128, device="cpu")
        try:
            client.register_cuda_shared_memory("capi_out", cudashm.get_raw_handle(region), 0,
                                               128)
            out = client.infer("simple", [("INPUT0", A), ("INPUT1", B)],
                               outputs=[("OUTPUT0", ("shm", "capi_out", 64, 0))])
            assert out == {}
            np.testing.assert_array_equal(
                cudashm.get_contents_as_numpy(region, "INT32", [1, 16]), A + B)
            client.unregister_shared_memory("cuda", "capi_out")
        finally:
            cudashm.destroy_shared_memory_region(region)


def test_register_cuda_refuses_per_call_headers(servers):
    with native.NativeClient(servers[("port", "http")].url) as client:
        with pytest.raises(InferenceServerException, match="set_header"):
            client.register_cuda_shared_memory("x", "e30=", 0, 4, headers={"a": "b"})


def test_register_cuda_error_names_the_server_message(servers):
    """A bad raw handle: the server's refusal reaches the caller through
    the port's own error slot."""
    with native.NativeGrpcClient(servers[("port", "grpc")].url) as client:
        with pytest.raises(InferenceServerException) as err:
            client.register_cuda_shared_memory("bad", "bm90IGpzb24=", 0, 64)
        assert str(err.value)


def test_ctypes_grpc_client(servers):
    """The ctypes NativeGrpcClient speaks real gRPC to the port's server."""
    with native.NativeGrpcClient(servers[("port", "grpc")].url) as client:
        assert client.is_server_live()
        assert client.is_model_ready("simple")
        assert not client.is_model_ready("missing")
        out = client.infer("simple", [("INPUT0", A), ("INPUT1", B)],
                           outputs=["OUTPUT0", "OUTPUT1"], request_id="grpc-capi-1")
        np.testing.assert_array_equal(out["OUTPUT0"], A + B)
        np.testing.assert_array_equal(out["OUTPUT1"], A - B)
        out = client.infer("simple", [("INPUT0", A), ("INPUT1", B)])
        assert set(out) == {"OUTPUT0", "OUTPUT1"}
        for start, end in [(True, False), (False, True)]:
            seq_out = client.infer("simple_sequence", [("INPUT", np.array([[6]], np.int32))],
                                   sequence=(888, start, end))
        assert seq_out["OUTPUT"][0, 0] == 12
        with pytest.raises(InferenceServerException, match="StatusCode"):
            client.infer("missing", [("INPUT0", A)])


def test_ctypes_grpc_shm_flow(servers):
    """cuda-shm registration + shm-placed IO through the native grpc client."""
    with native.NativeGrpcClient(servers[("port", "grpc")].url) as client:
        region = cudashm.create_shared_memory_region("grpc_capi", 128, device="cpu")
        try:
            client.register_cuda_shared_memory("grpc_capi", cudashm.get_raw_handle(region), 0,
                                               128)
            out = client.infer("simple", [("INPUT0", A), ("INPUT1", B)],
                               outputs=[("OUTPUT0", ("shm", "grpc_capi", 64, 0))])
            assert out == {}
            np.testing.assert_array_equal(
                cudashm.get_contents_as_numpy(region, "INT32", [1, 16]), A + B)
            client.unregister_shared_memory("cuda", "grpc_capi")
        finally:
            cudashm.destroy_shared_memory_region(region)


def test_ctypes_grpc_streaming(servers):
    """Bi-di streaming: a stateful sequence accumulates across stream
    messages, callbacks from the native reader thread; a second stream on
    the same client works."""
    results = queue.Queue()
    with native.NativeGrpcClient(servers[("port", "grpc")].url) as client:
        client.start_stream(lambda outputs, error: results.put((outputs, error)))
        with pytest.raises(InferenceServerException, match="already active"):
            client.start_stream(lambda outputs, error: None)
        for start, end in [(True, False), (False, False), (False, True)]:
            client.stream_infer("simple_sequence", [("INPUT", np.array([[4]], np.int32))],
                                sequence=(515, start, end))
        sums = []
        for _ in range(3):
            outputs, error = results.get(timeout=30)
            assert error is None, error
            sums.append(int(outputs["OUTPUT"][0, 0]))
        assert sums == [4, 8, 12]
        client.stop_stream()
        client.start_stream(lambda outputs, error: results.put((outputs, error)))
        client.stream_infer("simple_sequence", [("INPUT", np.array([[7]], np.int32))],
                            sequence=(516, True, True))
        outputs, error = results.get(timeout=30)
        assert error is None and int(outputs["OUTPUT"][0, 0]) == 7
        client.stop_stream()


def test_ctypes_grpc_async_infer_multiplexes():
    """ONE client keeps many AsyncInfer RPCs in flight on its multiplexed
    h2 connection: 8 requests against a 0.3 s model overlap."""
    delay, n = 0.3, 8
    core = ServerCore([IdentityModel("identity_slow", "INT32", delay_s=delay, device="cpu")],
                      device="cpu")
    server = GrpcInferenceServer(core, max_workers=n + 2).start()
    try:
        with native.NativeGrpcClient(server.url) as client:
            results = queue.Queue()
            payloads = [np.full((1, 16), i, dtype=np.int32) for i in range(n)]
            t0 = time.monotonic()
            for i in range(n):
                client.async_infer("identity_slow", [("INPUT0", payloads[i])],
                                   lambda outputs, error, i=i: results.put((i, outputs, error)))
            seen = {}
            for _ in range(n):
                i, outputs, error = results.get(timeout=30)
                assert error is None, error
                seen[i] = outputs["OUTPUT0"]
            elapsed = time.monotonic() - t0
    finally:
        server.stop()
    for i in range(n):
        np.testing.assert_array_equal(seen[i], payloads[i])
    # serialized would be >= n * delay = 2.4 s
    assert elapsed < (n * delay) / 2, f"8 async infers took {elapsed:.2f}s"


def test_ctypes_grpc_async_infer_error_path(servers):
    """Async failures arrive as callback(None, error) via result status."""
    results = queue.Queue()
    with native.NativeGrpcClient(servers[("port", "grpc")].url) as client:
        client.async_infer("no_such_model", [("INPUT0", np.zeros((1, 4), dtype=np.int32))],
                           lambda outputs, error: results.put((outputs, error)))
        outputs, error = results.get(timeout=30)
    assert outputs is None
    assert error and "no_such_model" in error


def test_native_grpc_compression_on_the_wire(servers):
    """set_compression('gzip'): the request rides the wire compressed."""
    proxy = _CapturingProxy(servers[("port", "grpc")].port)
    try:
        payload = np.zeros((1, 65536), dtype=np.int32)  # 256 KiB of zeros
        with native.NativeGrpcClient(f"127.0.0.1:{proxy.port}") as client:
            client.set_compression("gzip")
            out = client.infer("custom_identity_int32", [("INPUT0", payload)],
                               outputs=["OUTPUT0"])
        np.testing.assert_array_equal(out["OUTPUT0"].reshape(payload.shape), payload)
        captured = proxy.snapshot()
        assert b"grpc-encoding" in captured and b"gzip" in captured
        assert len(captured) < payload.nbytes // 4, len(captured)
    finally:
        proxy.close()


def test_native_grpc_decompresses_compressed_responses():
    """The port's server configured to gzip responses round-trips through
    the native client on the unary, async and streaming receive paths, with
    gzip and deflate requests."""
    import grpc as grpc_mod

    core = ServerCore(default_model_zoo("cpu"), device="cpu")
    server = GrpcInferenceServer(core, compression=grpc_mod.Compression.Gzip).start()
    data = np.arange(4096, dtype=np.int32).reshape(1, 4096)
    try:
        with native.NativeGrpcClient(server.url) as client:
            for algorithm in ("gzip", "deflate", None):
                client.set_compression(algorithm)
                out = client.infer("custom_identity_int32", [("INPUT0", data)],
                                   outputs=["OUTPUT0"])
                np.testing.assert_array_equal(out["OUTPUT0"].reshape(data.shape), data)
            client.set_compression("gzip")
            noise = np.random.default_rng(3).integers(-2**31, 2**31 - 1, size=(1, 4096),
                                                      dtype=np.int32)
            out = client.infer("custom_identity_int32", [("INPUT0", noise)],
                               outputs=["OUTPUT0"])
            np.testing.assert_array_equal(out["OUTPUT0"].reshape(noise.shape), noise)
            results = queue.Queue()
            client.async_infer("custom_identity_int32", [("INPUT0", data)],
                               lambda outputs, error: results.put((outputs, error)))
            outputs, error = results.get(timeout=30)
            assert error is None, error
            np.testing.assert_array_equal(outputs["OUTPUT0"].reshape(data.shape), data)
            client.start_stream(lambda outputs, error: results.put((outputs, error)))
            client.stream_infer("simple_sequence", [("INPUT", np.array([[9]], np.int32))],
                                sequence=(901, True, True))
            outputs, error = results.get(timeout=30)
            assert error is None, error
            assert int(outputs["OUTPUT"][0, 0]) == 9
            client.stop_stream()
    finally:
        server.stop()


def test_native_default_headers_on_the_wire(servers):
    """set_header attaches to every request in both native clients, seen at
    the byte level."""
    captured = {"ready": threading.Event()}

    def http_capture():
        listener = socket.socket()
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        captured["port"] = listener.getsockname()[1]
        captured["ready"].set()
        conn, _ = listener.accept()
        conn.settimeout(10)
        data = b""
        while b"\r\n\r\n" not in data:
            data += conn.recv(4096)
        captured["request"] = data
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n")
        conn.close()
        listener.close()

    t = threading.Thread(target=http_capture, daemon=True)
    t.start()
    captured["ready"].wait(10)
    with native.NativeClient(f"127.0.0.1:{captured['port']}") as client:
        client.set_header("Authorization", "Bearer sekrit-http")
        assert client.is_server_live()
    t.join(timeout=10)
    assert b"Authorization: Bearer sekrit-http" in captured["request"]

    proxy = _CapturingProxy(servers[("port", "grpc")].port)
    try:
        with native.NativeGrpcClient(f"127.0.0.1:{proxy.port}") as client:
            client.set_header("authorization", "Bearer sekrit-grpc")
            assert client.is_server_live()
        wire = proxy.snapshot()
        assert b"authorization" in wire and b"Bearer sekrit-grpc" in wire
    finally:
        proxy.close()


def test_load_and_available():
    assert native.available()
    assert native.load() is native.load()
