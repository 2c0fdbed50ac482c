"""The port's import surface against the JAX package's, for the paths a
``tritonclient`` user imports: the auth plugins of every client, the HTTP
namespace's ``InferAsyncRequest``, the GRPC namespace's ``proto_path()`` and
the system shm module's ``region_inventory()``.

Each case names the same module or function in both packages and holds
the port's to the JAX one: the same exported names, the same proto bytes,
the same inventory rows for the same region.

Then the API faults the port had against the JAX package, each held
against it: ``InferInput.set_data_from_dlpack`` (the same request bytes),
TLS on the sync HTTP client (the same keywords, behind an HTTPS front with
an ``openssl`` self-signed certificate), ``GrpcInferenceServer``'s
``compression`` (a gzip'd response both packages' gRPC clients decode) and
JAX's constructor order, ``ServerCore(name=...)``,
``sharded_forward(module_apply=...)``, ``infer(decoupled_ok=True)`` and JAX's
positional order in ``LongContextEncoderModel`` and ``PrefillDecoderModel``.
"""

import importlib
import tomllib
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

import client_tpu.grpc as jax_grpc
import client_tpu.http as jax_http
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
from client_tpu.utils import shared_memory as jax_shm
from client_tpu_torch.utils import shared_memory as port_shm
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

REPO = Path(__file__).resolve().parent.parent
AUTH = ["http.auth", "http.aio.auth", "grpc.auth", "grpc.aio.auth"]


@pytest.mark.parametrize("path", AUTH)
def test_auth_modules_export_what_the_jax_ones_do(path):
    port = importlib.import_module(f"client_tpu_torch.{path}")
    jax = importlib.import_module(f"client_tpu.{path}")
    assert port.__all__ == jax.__all__ == ["BasicAuth", "InferenceServerClientPlugin"]
    from client_tpu_torch import _base

    assert port.BasicAuth is _base.BasicAuth
    assert port.InferenceServerClientPlugin is _base.InferenceServerClientPlugin


@pytest.mark.parametrize("path", AUTH)
def test_auth_plugin_sets_the_header_as_the_jax_one(path):
    port = importlib.import_module(f"client_tpu_torch.{path}")
    jax = importlib.import_module(f"client_tpu.{path}")
    headers = []
    for mod in (port, jax):
        request = type("Request", (), {"headers": {}})()
        mod.BasicAuth("user", "pa:ss")(request)
        headers.append(request.headers)
    assert headers[0] == headers[1] and headers[0]


@pytest.mark.parametrize("port,jax", [(port_http, jax_http), (port_grpc, jax_grpc)],
                         ids=["http", "grpc"])
def test_namespaces_export_the_jax_names(port, jax):
    assert sorted(port.__all__) == sorted(jax.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_infer_async_request_is_exported():
    from client_tpu_torch.http._client import InferAsyncRequest

    assert port_http.InferAsyncRequest is InferAsyncRequest
    assert "InferAsyncRequest" in port_http.__all__


def test_proto_path_bytes_equal_the_jax_proto():
    path = Path(port_grpc.proto_path())
    assert path.name == Path(jax_grpc.proto_path()).name == "grpc_service.proto"
    assert path.parent == REPO / "client_tpu_torch" / "grpc"
    assert path.read_bytes() == Path(jax_grpc.proto_path()).read_bytes()


def test_packaging_names_the_new_modules():
    config = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    for path in AUTH:
        assert f"client_tpu_torch.{path}" in config["packages"]
    assert config["package-data"]["client_tpu_torch.grpc"] == ["grpc_service.proto"]
    assert config["package-data"]["client_tpu.grpc"] == ["grpc_service.proto"]


@pytest.mark.parametrize("size", [64, 4096])
def test_region_inventory_equals_the_jax_one(size):
    key = f"inv_{uuid.uuid4().hex[:12]}"
    rows = []
    for mod in (port_shm, jax_shm):
        region = mod.create_shared_memory_region(key, "/" + key, size)
        try:
            rows.append([r for r in mod.region_inventory() if r["name"] == key])
        finally:
            mod.destroy_shared_memory_region(region)
        assert not [r for r in mod.region_inventory() if r["name"] == key]
    assert rows[0] == rows[1] == [
        {"family": "system", "name": key, "key": "/" + key, "byte_size": size}]
    assert list(rows[0][0]) == list(rows[1][0])  # the keys in the same order


# -- the API faults repaired against the JAX package (ROADMAP C5-C9) ----------


def _bodies(port_input, jax_input):
    from client_tpu.http._utils import build_infer_body as jax_body
    from client_tpu_torch.http._utils import build_infer_body as port_body

    return port_body([port_input]), jax_body([jax_input])


@pytest.mark.parametrize("dtype,datatype", [(np.float32, "FP32"), (np.int64, "INT64"),
                                            (np.uint8, "UINT8"), (np.bool_, "BOOL")])
def test_set_data_from_dlpack_body_equals_jax(dtype, datatype):
    """C5: the same numpy array through both packages' ``set_data_from_dlpack``
    gives the same HTTP body byte for byte (tests/test_infer_body.py:99), and
    a contiguous host tensor is wrapped without a copy."""
    from client_tpu._tensor import InferInput as JaxInput
    from client_tpu_torch._tensor import InferInput

    arr = (np.arange(12) % 3).astype(dtype).reshape(3, 4)
    ours = InferInput("IN", [3, 4], datatype).set_data_from_dlpack(arr)
    theirs = JaxInput("IN", [3, 4], datatype).set_data_from_dlpack(arr)
    assert _bodies(ours, theirs)[0] == _bodies(ours, theirs)[1]
    assert np.shares_memory(np.frombuffer(ours._raw_data, np.uint8), arr)
    tensor = torch.from_numpy(arr.copy())
    staged = InferInput("IN", [3, 4], datatype).set_data_from_dlpack(tensor)
    assert np.shares_memory(np.frombuffer(staged._raw_data, np.uint8), tensor.numpy())
    assert _bodies(staged, theirs)[0] == _bodies(ours, theirs)[1]
    # a non-contiguous view is copied once, into the same bytes
    strided = InferInput("IN", [3, 2], datatype).set_data_from_dlpack(arr[:, ::2])
    assert _bodies(strided, JaxInput("IN", [3, 2], datatype).set_data_from_dlpack(
        arr[:, ::2]))[0] == _bodies(strided, JaxInput("IN", [3, 2], datatype)
                                    .set_data_from_dlpack(arr[:, ::2]))[1]


def test_set_data_from_dlpack_errors_and_bindings_as_jax():
    """C5: JAX's dtype message, the shape check, BF16 from a torch tensor
    (bytes as JAX's for the ml_dtypes array), the gRPC request's raw
    contents, and a shared-memory binding cleared."""
    import ml_dtypes

    from client_tpu._tensor import InferInput as JaxInput
    from client_tpu.grpc._infer import build_infer_request as jax_request
    from client_tpu.utils import InferenceServerException as JaxError
    from client_tpu_torch._tensor import InferInput
    from client_tpu_torch.grpc._infer import build_infer_request as port_request
    from client_tpu_torch.utils import InferenceServerException

    arr = np.arange(4, dtype=np.int64)
    with pytest.raises(InferenceServerException) as ours:
        InferInput("IN", [4], "FP32").set_data_from_dlpack(arr)
    with pytest.raises(JaxError) as theirs:
        JaxInput("IN", [4], "FP32").set_data_from_dlpack(arr)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(InferenceServerException, match="got 4 elements"):
        InferInput("IN", [5], "INT64").set_data_from_dlpack(arr)

    # numpy's DLPack has no bf16 (JAX's method raises BufferError for an
    # ml_dtypes array): a torch bf16 tensor stages the bytes JAX's
    # set_data_from_numpy stages for the same values
    values = np.array([1.5, -2.25, 3.0], np.float32)
    bf16 = InferInput("IN", [3], "BF16").set_data_from_dlpack(
        torch.from_numpy(values).to(torch.bfloat16))
    jax_bf16 = JaxInput("IN", [3], "BF16").set_data_from_numpy(
        values.astype(ml_dtypes.bfloat16))
    assert _bodies(bf16, jax_bf16)[0] == _bodies(bf16, jax_bf16)[1]

    ours_in = InferInput("IN", [4], "INT64").set_shared_memory("region", 32)
    ours_in.set_data_from_dlpack(arr)
    assert ours_in._shared_memory_params() is None
    theirs_in = JaxInput("IN", [4], "INT64").set_data_from_dlpack(arr)
    assert port_request("m", [ours_in])["raw_input_contents"] == \
        jax_request("m", [theirs_in])["raw_input_contents"] == [arr.tobytes()]


class _TlsFront:
    """An HTTPS front for a plain HTTP server: each request is read,
    forwarded to the backend and its response relayed (HTTP/1.1)."""

    def __init__(self, backend_url, cert, key):
        import http.server
        import ssl
        import threading

        import urllib3

        backend = urllib3.HTTPConnectionPool(*backend_url.split(":"), maxsize=4)

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _relay(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else None
                headers = {k: v for k, v in self.headers.items() if k.lower() != "host"}
                resp = backend.request(self.command, self.path, body=body, headers=headers,
                                       decode_content=False, retries=False)
                self.send_response(resp.status)
                for k, v in resp.headers.items():
                    if k.lower() not in ("transfer-encoding", "content-length", "connection"):
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(resp.data)))
                self.end_headers()
                self.wfile.write(resp.data)

            do_GET = do_POST = _relay

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(cert, key)
        self.server.socket = context.wrap_socket(self.server.socket, server_side=True)
        self.url = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(scope="module")
def tls_front(tmp_path_factory):
    """A self-signed certificate for 127.0.0.1 (made by ``openssl``, as
    tests/test_native_robustness.py's) in front of the port's HTTP server
    over the default zoo."""
    import subprocess

    from client_tpu_torch.models import default_model_zoo
    from client_tpu_torch.server import HttpInferenceServer, ServerCore

    d = tmp_path_factory.mktemp("tls_http")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                    "-out", cert, "-days", "2", "-subj", "/CN=127.0.0.1",
                    "-addext", "subjectAltName=IP:127.0.0.1,DNS:localhost"],
                   check=True, capture_output=True)
    server = HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
    front = _TlsFront(server.url, cert, key)
    yield front.url, cert
    front.close()
    server.stop()


@pytest.mark.parametrize("how", ["ca_certs", "insecure", "context_factory"])
def test_sync_http_client_speaks_tls_as_jax(tls_front, how):
    """C6: both packages' sync HTTP clients over HTTPS with the same
    keywords (``ssl``, ``ssl_options``, ``insecure``,
    ``ssl_context_factory``) get the same ``simple`` outputs; with
    verification on and no CA both refuse the self-signed certificate."""
    import ssl

    url, cert = tls_front
    kwargs = {"ca_certs": {"ssl_options": {"ca_certs": cert}},
              "insecure": {"insecure": True},
              "context_factory": {"ssl_context_factory": lambda: ssl.create_default_context(
                  cafile=cert)}}[how]
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    outputs = []
    for mod in (port_http, jax_http):
        with mod.InferenceServerClient(url, ssl=True, max_greenlets=4, **kwargs) as client:
            assert client.is_server_live()
            inputs = [mod.InferInput(name, [1, 16], "INT32").set_data_from_numpy(a)
                      for name in ("INPUT0", "INPUT1")]
            result = client.infer("simple", inputs)
            outputs.append((result.as_numpy("OUTPUT0"), result.as_numpy("OUTPUT1")))
    for ours, theirs in zip(*outputs):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(outputs[0][0], a + a)
    if how == "ca_certs":
        for mod in (port_http, jax_http):
            with mod.InferenceServerClient(url, ssl=True) as client:
                with pytest.raises(Exception):
                    client.is_server_live()


def test_sync_http_client_keywords_are_jax_ones():
    import inspect

    ours = inspect.signature(port_http.InferenceServerClient.__init__).parameters
    theirs = inspect.signature(jax_http.InferenceServerClient.__init__).parameters
    assert list(ours) == list(theirs)
    assert [p.default for p in ours.values()] == [p.default for p in theirs.values()]


class _CountingRelay:
    """A TCP relay that counts the bytes the server sends back."""

    def __init__(self, backend_url):
        import socket
        import threading

        self.received = 0
        self._lock = threading.Lock()
        host, port = backend_url.split(":")
        self._backend = (host, int(port))
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.url = f"127.0.0.1:{self._listener.getsockname()[1]}"
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        import socket
        import threading

        while True:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            server = socket.create_connection(self._backend)
            threading.Thread(target=self._pump, args=(client, server, False), daemon=True).start()
            threading.Thread(target=self._pump, args=(server, client, True), daemon=True).start()

    def _pump(self, src, dst, count):
        try:
            while data := src.recv(65536):
                if count:
                    with self._lock:
                        self.received += len(data)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass

    def close(self):
        self._listener.close()


def test_grpc_server_compression_reaches_both_clients():
    """C7: ``GrpcInferenceServer(core, port, max_workers, verbose,
    compression, credentials)`` in JAX's order; with ``compression=Gzip``
    an identity of 1 MiB of zeros comes back gzip'd (a few KiB cross the
    wire, against over 1 MiB without) and both packages' gRPC clients
    decode the same array."""
    import inspect

    import grpc

    from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
    from client_tpu_torch.models import default_model_zoo
    from client_tpu_torch.server import GrpcInferenceServer, ServerCore

    ours = inspect.signature(GrpcInferenceServer.__init__).parameters
    theirs = inspect.signature(JaxGrpcServer.__init__).parameters
    assert list(ours) == list(theirs)
    assert [p.default for p in ours.values()] == [p.default for p in theirs.values()]

    zeros = np.zeros((1, 256 * 1024), np.float32)
    received = {}
    for compression in (grpc.Compression.Gzip, None):
        core = ServerCore(default_model_zoo("cpu"), device="cpu")
        server = GrpcInferenceServer(core, 0, 4, True, compression).start()
        relay = _CountingRelay(server.url)
        try:
            for mod in (port_grpc, jax_grpc):
                with mod.InferenceServerClient(relay.url) as client:
                    inp = mod.InferInput("INPUT0", list(zeros.shape), "FP32")
                    got = client.infer("identity_fp32", [inp.set_data_from_numpy(zeros)])
                    np.testing.assert_array_equal(got.as_numpy("OUTPUT0"), zeros)
            received[compression] = relay.received
        finally:
            relay.close()
            server.stop()
    assert received[grpc.Compression.Gzip] < 64 * 1024 < 2 * zeros.nbytes < received[None]


def test_server_core_name_as_jax():
    """C7: ``ServerCore(models, name=...)`` names the server's metadata as
    JAX's does; the default stays the port's own name."""
    from client_tpu.server import ServerCore as JaxCore
    from client_tpu_torch.server import ServerCore

    assert ServerCore([], name="edge-7", device="cpu").server_metadata()["name"] == \
        JaxCore([], name="edge-7").server_metadata()["name"] == "edge-7"
    assert ServerCore([], device="cpu").server_metadata()["name"] == "client_tpu_torch_server"


def test_sharded_forward_takes_module_apply():
    """C8: ``sharded_forward(module_apply=..., mesh=...)`` as JAX's."""
    import inspect

    from client_tpu import parallel as jax_parallel
    from client_tpu_torch import parallel

    assert list(inspect.signature(parallel.sharded_forward).parameters) == \
        list(inspect.signature(jax_parallel.sharded_forward).parameters) == ["module_apply", "mesh"]
    run = parallel.sharded_forward(module_apply=lambda p, x: x * p,
                                   mesh=parallel.make_mesh(8, device="cpu"))
    np.testing.assert_array_equal(run(2.0, torch.arange(4.0)).numpy(), [0.0, 2.0, 4.0, 6.0])


def test_decoupled_ok_runs_the_stream_to_a_list():
    """C9: ``ServerCore.infer(..., decoupled_ok=True)`` runs a decoupled
    model's stream to the list of its responses, as JAX's; without it both
    raise the same error."""
    from client_tpu.models import default_model_zoo as jax_zoo
    from client_tpu.server import ServerCore as JaxCore
    from client_tpu.server.core import InferError as JaxInferError
    from client_tpu_torch.models import default_model_zoo
    from client_tpu_torch.server import ServerCore
    from client_tpu_torch.server.core import InferError

    values = np.array([4, 1, 9], np.int32)
    request = {"inputs": [{"name": "IN", "datatype": "INT32", "shape": [3], "array": values}]}
    ours = ServerCore(default_model_zoo("cpu"), device="cpu")
    theirs = JaxCore(jax_zoo())
    with pytest.raises(InferError) as port_error:
        ours.infer("repeat_int32", "", request)
    with pytest.raises(JaxInferError) as jax_error:
        theirs.infer("repeat_int32", "", request)
    assert str(port_error.value) == str(jax_error.value)
    got = ours.infer("repeat_int32", "", request, decoupled_ok=True)
    want = theirs.infer("repeat_int32", "", request, decoupled_ok=True)
    assert isinstance(got, list) and len(got) == len(want) == 3

    def outputs(responses):
        return [{o["name"]: np.asarray(torch.as_tensor(o["array"])).tolist()
                 for o in r["outputs"]} for r in responses]

    assert outputs(got) == outputs(want)
    assert ours.statistics("repeat_int32")["model_stats"][0]["inference_count"] == \
        theirs.statistics("repeat_int32")["model_stats"][0]["inference_count"] == 1


# -- JAX's positional order in two model constructors (ROADMAP C11-C12) --------


def _positional(cls):
    """The names a caller may pass by position, in order."""
    import inspect

    return [name for name, p in inspect.signature(cls.__init__).parameters.items()
            if name != "self" and p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]


@pytest.mark.parametrize("module,cls", [("long_context", "LongContextEncoderModel"),
                                        ("decoder_prefill", "PrefillDecoderModel")])
def test_model_positional_parameters_are_jax_ones(module, cls):
    """C11, C12: the positional parameters of both constructors are JAX's,
    in JAX's order; the port's own (``device``, ``mesh``, ``decoder``) are
    keyword-only."""
    port = getattr(importlib.import_module(f"client_tpu_torch.models.{module}"), cls)
    jax_cls = getattr(importlib.import_module(f"client_tpu.models.{module}"), cls)
    assert _positional(port) == _positional(jax_cls)


def test_long_context_encoder_takes_n_devices_fourth():
    """C11: ``LongContextEncoderModel(64, 4, 0, 1)`` builds the same encoder in
    both packages: JAX's takes ``n_devices`` = 1 in fourth place (its default
    mode, ring, over one device), the port's too (its default mode, flash, on
    one device; ``attention`` is JAX's fifth parameter and a keyword here). On
    the JAX model's weights both give the same encoding within the JAX flash
    tests' 2e-5."""
    import jax
    import jax.numpy as jnp

    from client_tpu.models.long_context import LongContextEncoderModel as JaxEncoder
    from client_tpu_torch.models.long_context import LongContextEncoderModel, load_jax_params

    port = LongContextEncoderModel(64, 4, 0, 1, device="cpu")
    jax_model = JaxEncoder(64, 4, 0, 1)
    assert (port.encoder.dim, port.encoder.heads, port.encoder.attention) == (64, 4, "flash")
    assert [(t.name, t.datatype, t.shape) for t in port.inputs() + port.outputs()] == \
        [(t.name, t.datatype, t.shape) for t in jax_model.inputs() + jax_model.outputs()]
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    load_jax_params(port, {name: np.asarray(jax.random.normal(key, (64, 64), jnp.float32)
                                            * 64 ** -0.5)
                           for name, key in zip(("wq", "wk", "wv", "wo"), keys)})
    x = np.random.default_rng(11).standard_normal((96, 64)).astype(np.float32)
    got = port.execute({"sequence": x}, {})["encoded"]
    want = np.asarray(jax_model.execute({"sequence": x}, {})["encoded"])
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got)), want, atol=2e-5, rtol=2e-5)


def test_prefill_decoder_takes_a_positional_mesh():
    """C12: ``PrefillDecoderModel(True, 0, mesh)`` builds its TP model over
    that mesh in both packages (a 2-way ``model`` axis of CPU devices)."""
    import jax

    from client_tpu.models.decoder_prefill import PrefillDecoderModel as JaxPrefill
    from client_tpu_torch.models.decoder_prefill import PrefillDecoderModel
    from client_tpu_torch.parallel import Mesh, take_devices

    jax_mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:2]), ("model",))
    mesh = Mesh(take_devices(2, "cpu"), ("model",))
    theirs = JaxPrefill(True, 0, jax_mesh)
    ours = PrefillDecoderModel(True, 0, mesh)
    assert theirs._inner._mesh is jax_mesh
    assert ours._decoder._mesh is mesh
    assert ours.name == theirs.name == "decoder_lm_tp_prefill"
    assert ours.tp_degree == 2 and ours.mesh_degrees == {"model": 2}
