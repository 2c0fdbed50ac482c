"""The port's server and data plane against the JAX package's.

- the 2x2 matrix: port and JAX clients against port and JAX servers on
  ``simple`` and ``identity_fp32``;
- the classification extension's tie order, served and on both of the JAX
  server's ranking paths (device array and numpy);
- the port server's system and cuda shared-memory paths (cuda regions on the
  CPU device here: in one process the client's tensor reaches the model as
  that very tensor), and raw handles read across the two packages;
- the generate extension: SSE framing byte-identical to the JAX server's,
  the one-shot route, and the sequence API's error cases over HTTP.

Servers bind ephemeral ports; every shm key is uuid-named and every region
is destroyed.
"""

import json
import uuid

import numpy as np
import pytest
import torch
import urllib3

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models.generate import TinyGenerateModel as JaxGenerate
from client_tpu.models.simple import AddSubModel as JaxAddSub
from client_tpu.models.simple import IdentityModel as JaxIdentity
from client_tpu.server import HttpInferenceServer as JaxServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu.utils import shared_memory as jax_shm
from client_tpu.utils import tpu_shared_memory as jax_tpushm
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as shm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def port_server():
    server = HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_server():
    core = JaxCore([JaxAddSub(), JaxIdentity("identity_fp32", "FP32"), JaxGenerate(seed=0)])
    server = JaxServer(core).start()
    yield server
    server.stop()


@pytest.fixture
def port_client(port_server):
    client = port_http.InferenceServerClient(port_server.url)
    yield client
    client.close()


def _key(tag):
    return f"{tag}_{uuid.uuid4().hex[:12]}"


# -- the 2x2 client/server matrix --------------------------------------------


def _infer(http, url, model):
    client = http.InferenceServerClient(url)
    try:
        if model == "simple":
            a = np.arange(16, dtype=np.int32).reshape(1, 16)
            b = np.full((1, 16), 3, dtype=np.int32)
            inputs = [http.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                      http.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]
            result = client.infer("simple", inputs)
            return {n: result.as_numpy(n) for n in ("OUTPUT0", "OUTPUT1")}, {
                "OUTPUT0": a + b, "OUTPUT1": a - b}
        x = np.random.default_rng(5).standard_normal((3, 257)).astype(np.float32)
        inputs = [http.InferInput("INPUT0", [3, 257], "FP32").set_data_from_numpy(x)]
        result = client.infer("identity_fp32", inputs)
        return {"OUTPUT0": result.as_numpy("OUTPUT0")}, {"OUTPUT0": x}
    finally:
        client.close()


@pytest.mark.parametrize("model", ["simple", "identity_fp32"])
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_client_server_matrix(port_server, jax_server, client, server, model):
    http = port_http if client == "port" else jax_http
    url = (port_server if server == "port" else jax_server).url
    got, expected = _infer(http, url, model)
    for name, arr in expected.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape
        np.testing.assert_array_equal(got[name], arr)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_outputs_match_the_jax_server_bit_for_bit(port_server, jax_server, client):
    http = port_http if client == "port" else jax_http
    for model in ("simple", "identity_fp32"):
        ours, _ = _infer(http, port_server.url, model)
        theirs, _ = _infer(http, jax_server.url, model)
        for name in theirs:
            assert ours[name].tobytes() == theirs[name].tobytes()


def test_classification_matches_the_jax_server(port_server, jax_server):
    x = np.array([[0.5, 3.0, -1.0, 2.0, 9.0, 0.0]], dtype=np.float32)
    results = []
    for url in (port_server.url, jax_server.url):
        client = port_http.InferenceServerClient(url)
        try:
            inp = port_http.InferInput("INPUT0", [1, 6], "FP32").set_data_from_numpy(x)
            out = port_http.InferRequestedOutput("OUTPUT0", class_count=3)
            results.append(client.infer("identity_fp32", [inp], outputs=[out]).as_numpy("OUTPUT0"))
        finally:
            client.close()
    assert results[0].tolist() == results[1].tolist()
    assert results[0].tolist()[0].startswith(b"9.000000:4")


@pytest.mark.parametrize("k", [1, 3, 5])
def test_classification_ties_match_the_jax_server(port_server, jax_server, k):
    """identity_fp32 returns a device tensor on both servers (a torch tensor,
    a jax.Array), so both rank ties lowest index first: the same entries,
    and the same set of classes where k cuts through a tie."""
    x = np.array([[1.0, 3.0, 3.0, 1.0, 3.0, 0.0]], dtype=np.float32)
    results = []
    for url in (port_server.url, jax_server.url):
        client = port_http.InferenceServerClient(url)
        try:
            inp = port_http.InferInput("INPUT0", [1, 6], "FP32").set_data_from_numpy(x)
            out = port_http.InferRequestedOutput("OUTPUT0", class_count=k)
            results.append(client.infer("identity_fp32", [inp], outputs=[out]).as_numpy("OUTPUT0"))
        finally:
            client.close()
    assert results[0].tolist() == results[1].tolist()
    assert [e.split(b":")[1] for e in results[0].reshape(-1)][:3] == [b"1", b"2", b"4"][:k]


# tied class vectors: int32 and float, all equal; unbatched and batched
TIES = {"int32": np.array([1, 3, 3, 1, 3], np.int32),
        "float": np.array([0.0, 2.0, 0.5, 2.0, 2.0, 0.5], np.float32),
        "all_equal": np.zeros(8, np.float32),
        "batched": np.array([[2, 2, 0, 2], [1, 1, 1, 1], [0, 5, 5, 0]], np.int32)}


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", list(TIES))
def test_classification_ranks_ties_as_the_jax_server(rows, k):
    """The extension's strings against the JAX server's own function on
    both of its paths: a tensor output against a jax.Array (lax.top_k,
    ties lowest index first), a numpy output against a numpy output (the
    host argsort, ties highest index first)."""
    import jax.numpy as jnp

    from client_tpu.server.core import _classification as jax_classification
    from client_tpu_torch.server.core import _classification

    x = TIES[rows]
    batched = x.ndim == 2
    labels = [f"class{i}" for i in range(x.shape[-1] - 1)]  # one index without a label
    on_device = _classification(torch.from_numpy(x), k, labels, batched)
    want_device = jax_classification(jnp.asarray(x), k, labels, batched)
    assert on_device.tolist() == want_device.tolist()
    on_host = _classification(x, k, labels, batched)
    want_host = jax_classification(x, k, labels, batched)
    assert on_host.tolist() == want_host.tolist()
    if rows == "all_equal" and k == 3:
        assert [e.split(b":")[1] for e in on_device] == [b"0", b"1", b"2"]
        assert [e.split(b":")[1] for e in on_host] == [b"7", b"6", b"5"]


def test_health_and_metadata(port_client):
    assert port_client.is_server_live() and port_client.is_server_ready()
    assert port_client.is_model_ready("decoder_lm")
    assert not port_client.is_model_ready("no_such_model")
    meta = port_client.get_server_metadata()
    assert "cuda_shared_memory" in meta["extensions"]
    model = port_client.get_model_metadata("decoder_lm")
    assert model["inputs"] == [{"name": "TOKENS", "datatype": "INT32", "shape": [1, -1]}]
    config = port_client.get_model_config("tiny_lm_generate")
    assert config["model_transaction_policy"] == {"decoupled": True}


# -- shared memory -------------------------------------------------------------


@pytest.mark.parametrize("http", [port_http, jax_http], ids=["port_client", "jax_client"])
def test_system_shared_memory_round_trip(port_server, http):
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    nbytes = x.nbytes
    shm_mod = shm if http is port_http else jax_shm
    name_in, name_out = _key("sin"), _key("sout")
    region_in = shm_mod.create_shared_memory_region(name_in, "/" + name_in, nbytes)
    region_out = shm_mod.create_shared_memory_region(name_out, "/" + name_out, nbytes)
    client = http.InferenceServerClient(port_server.url)
    try:
        shm_mod.set_shared_memory_region(region_in, [x])
        client.register_system_shared_memory(name_in, "/" + name_in, nbytes)
        client.register_system_shared_memory(name_out, "/" + name_out, nbytes)
        status = {r["name"] for r in client.get_system_shared_memory_status()}
        assert {name_in, name_out} <= status
        inp = http.InferInput("INPUT0", [2, 12], "FP32").set_shared_memory(name_in, nbytes)
        out = http.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(name_out, nbytes)
        result = client.infer("identity_fp32", [inp], outputs=[out])
        assert result.as_numpy("OUTPUT0") is None  # contents live in the region
        params = result.get_output("OUTPUT0")["parameters"]
        assert params == {"shared_memory_region": name_out, "shared_memory_byte_size": nbytes}
        np.testing.assert_array_equal(
            shm_mod.get_contents_as_numpy(region_out, "FP32", [2, 12]), x)
    finally:
        client.unregister_system_shared_memory()
        client.close()
        shm_mod.destroy_shared_memory_region(region_in)
        shm_mod.destroy_shared_memory_region(region_out)


@pytest.mark.parametrize("colocated", [True, False])
def test_cuda_shared_memory_hands_the_tensor_through(port_server, port_client, colocated):
    x = torch.randn(4, 33)
    nbytes = x.numel() * x.element_size()
    name_in, name_out = _key("cin"), _key("cout")
    region_in = cudashm.create_shared_memory_region(name_in, nbytes, device="cpu",
                                                    colocated=colocated)
    region_out = cudashm.create_shared_memory_region(name_out, nbytes, device="cpu",
                                                     colocated=colocated)
    try:
        assert cudashm.set_shared_memory_region_from_torch(region_in, x) == nbytes
        for name, region in ((name_in, region_in), (name_out, region_out)):
            port_client.register_cuda_shared_memory(
                name, cudashm.get_raw_handle(region), 0, nbytes)
        assert {r["name"] for r in port_client.get_cuda_shared_memory_status()} == {
            name_in, name_out}
        inp = port_http.InferInput("INPUT0", [4, 33], "FP32").set_shared_memory(name_in, nbytes)
        out = port_http.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(name_out, nbytes)
        port_client.infer("identity_fp32", [inp], outputs=[out])
        y = cudashm.get_contents_as_torch(region_out, "FP32", [4, 33])
        # zero copies: the model received the client's tensor and returned it
        assert y.data_ptr() == x.data_ptr() and torch.equal(y, x)
        window = np.frombuffer(region_in.host_buffer(), dtype=np.float32).copy()
        if colocated:
            assert not window.any()  # no host mirror taken
        else:
            np.testing.assert_array_equal(window.reshape(4, 33), x.numpy())
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(region_out, "FP32", [4, 33]), x.numpy())
    finally:
        port_client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(region_in)
        cudashm.destroy_shared_memory_region(region_out)
    assert port_client.get_cuda_shared_memory_status() == []


def test_cuda_region_of_host_bytes_reaches_the_model_as_a_tensor(port_server, port_client):
    """A region filled from host bytes is read onto the server's device."""
    x = np.arange(16, dtype=np.int32).reshape(1, 16)
    name = _key("cbytes")
    region = cudashm.create_shared_memory_region(name, 2 * x.nbytes, device="cpu")
    try:
        cudashm.set_shared_memory_region(region, [x, x * 2])
        port_client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0,
                                                2 * x.nbytes)
        inputs = [port_http.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(
                      name, x.nbytes),
                  port_http.InferInput("INPUT1", [1, 16], "INT32").set_shared_memory(
                      name, x.nbytes, offset=x.nbytes)]
        result = port_client.infer("simple", inputs)
        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), 3 * x)
        np.testing.assert_array_equal(result.as_numpy("OUTPUT1"), -x)
    finally:
        port_client.unregister_cuda_shared_memory(name)
        cudashm.destroy_shared_memory_region(region)


def test_jax_tpu_region_handle_is_read_by_the_port_server(port_server, port_client):
    """A raw handle from the JAX package's tpu_shared_memory names a host
    window the port server attaches as a cross-process cuda region."""
    x = np.linspace(0, 1, 30, dtype=np.float32).reshape(3, 10)
    region = jax_tpushm.create_shared_memory_region(_key("jaxtpu"), 2 * x.nbytes)
    name = _key("xpkg")
    try:
        jax_tpushm.set_shared_memory_region(region, [x])
        port_client.register_cuda_shared_memory(
            name, jax_tpushm.get_raw_handle(region), 0, 2 * x.nbytes)
        inp = port_http.InferInput("INPUT0", [3, 10], "FP32").set_shared_memory(name, x.nbytes)
        out = port_http.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(name, x.nbytes, offset=x.nbytes)
        port_client.infer("identity_fp32", [inp], outputs=[out])
        np.testing.assert_array_equal(
            jax_tpushm.get_contents_as_numpy(region, "FP32", [3, 10], offset=x.nbytes), x)
    finally:
        port_client.unregister_cuda_shared_memory(name)
        jax_tpushm.destroy_shared_memory_region(region)


def test_port_cuda_handle_is_read_by_the_jax_server(jax_server):
    """The port's raw handle is the descriptor the JAX server's cuda family
    decodes: it maps the region's host window."""
    x = np.arange(16, dtype=np.int32).reshape(1, 16)
    name = _key("tojax")
    region = cudashm.create_shared_memory_region(name, 2 * x.nbytes, device="cpu")
    client = jax_http.InferenceServerClient(jax_server.url)
    try:
        cudashm.set_shared_memory_region(region, [x, x + 100])
        client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, 2 * x.nbytes)
        inputs = [jax_http.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(
                      name, x.nbytes),
                  jax_http.InferInput("INPUT1", [1, 16], "INT32").set_shared_memory(
                      name, x.nbytes, offset=x.nbytes)]
        result = client.infer("simple", inputs)
        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), 2 * x + 100)
    finally:
        client.unregister_cuda_shared_memory(name)
        client.close()
        cudashm.destroy_shared_memory_region(region)


@pytest.mark.parametrize("case", ["unknown_region", "overrun", "duplicate", "bad_handle"])
def test_shared_memory_errors(port_client, case):
    name = _key("err")
    region = cudashm.create_shared_memory_region(name, 64, device="cpu")
    try:
        handle = cudashm.get_raw_handle(region)
        inp = port_http.InferInput("INPUT0", [1, 16], "FP32")
        if case == "unknown_region":
            inp.set_shared_memory("never_registered", 64)
            call = lambda: port_client.infer("identity_fp32", [inp])  # noqa: E731
        elif case == "overrun":
            port_client.register_cuda_shared_memory(name, handle, 0, 64)
            inp.set_shared_memory(name, 64, offset=32)
            call = lambda: port_client.infer("identity_fp32", [inp])  # noqa: E731
        elif case == "duplicate":
            port_client.register_cuda_shared_memory(name, handle, 0, 64)
            call = lambda: port_client.register_cuda_shared_memory(name, handle, 0, 64)  # noqa: E731
        else:
            call = lambda: port_client.register_cuda_shared_memory(name, "not-base64!", 0, 64)  # noqa: E731
        with pytest.raises(InferenceServerException, match="400"):
            call()
    finally:
        port_client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(region)


# -- generate extension and the sequence API -----------------------------------


def _raw_stream(url, model, payload):
    host, port = url.split(":")
    pool = urllib3.HTTPConnectionPool(host, int(port), retries=False)
    try:
        resp = pool.request("POST", f"/v2/models/{model}/generate_stream", body=payload,
                            headers={"Content-Type": "application/json"})
        return resp.status, resp.headers.get("Content-Type"), resp.data
    finally:
        pool.close()


@pytest.mark.parametrize("payload", [
    b'{"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 4}',
    b'{"TOKENS": [[5, 6, 7]], "MAX_TOKENS": 5, "id": "req-9"}',
    b'{"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 8, "END_ID": 69, "parameters": {"chunk": 3}}',
])
def test_generate_stream_sse_is_byte_identical(port_server, jax_server, payload):
    ours = _raw_stream(port_server.url, "tiny_lm_generate", payload)
    theirs = _raw_stream(jax_server.url, "tiny_lm_generate", payload)
    assert ours == theirs
    assert ours[0] == 200 and ours[1] == "text/event-stream"
    assert ours[2].startswith(b'data: {"model_name":"tiny_lm_generate"')


def test_generate_stream_through_the_port_client(port_client):
    events = list(port_client.generate_stream(
        "tiny_lm_generate", {"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 4}))
    expected = [e["NEXT_TOKEN"] for e in JaxGenerate(seed=0).execute_decoupled(
        {"TOKENS": np.array([[1, 2, 3, 4]], np.int32),
         "MAX_TOKENS": np.array([4], np.int32)}, {})]
    assert [e["NEXT_TOKEN"] for e in events] == [int(t[0, 0]) for t in expected]
    assert [e["INDEX"] for e in events] == [0, 1, 2, 3]


def test_generate_stream_error_is_in_band(port_client):
    with pytest.raises(InferenceServerException, match="MAX_TOKENS"):
        list(port_client.generate_stream(
            "tiny_lm_generate", {"TOKENS": [1, 2], "MAX_TOKENS": 0}))


def test_one_shot_generate(port_client):
    event = port_client.generate("tiny_lm_generate", {"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 1})
    assert event["INDEX"] == 0 and isinstance(event["NEXT_TOKEN"], int)
    with pytest.raises(InferenceServerException, match="more than one"):
        port_client.generate("tiny_lm_generate", {"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 3})


def _tokens(http, values):
    arr = np.array([values], dtype=np.int32)
    return [http.InferInput("TOKENS", list(arr.shape), "INT32").set_data_from_numpy(arr)]


def test_sequence_over_http_matches_the_model(port_client):
    first = port_client.infer("decoder_lm", _tokens(port_http, [1, 2, 3, 4]),
                              sequence_id=77, sequence_start=True)
    tok = int(first.as_numpy("NEXT_TOKEN")[0, 0])
    second = port_client.infer("decoder_lm", _tokens(port_http, [tok]),
                               sequence_id=77, sequence_end=True)
    assert first.as_numpy("LOGITS").shape == (1, 256)
    stream = [e["NEXT_TOKEN"] for e in port_client.generate_stream(
        "tiny_lm_generate", {"TOKENS": [1, 2, 3, 4], "MAX_TOKENS": 2})]
    assert stream == [tok, int(second.as_numpy("NEXT_TOKEN")[0, 0])]


@pytest.mark.parametrize("case,match", [
    ("no_sequence_id", "sequence_id"),
    ("no_start", "no live state"),
    ("two_token_continuation", "exactly one token"),
    ("out_of_range", "out of range"),
    ("decoupled_via_infer", "decoupled"),
    ("unknown_model", "unknown model"),
    ("wrong_dtype", "datatype"),
])
def test_sequence_error_cases(port_client, case, match):
    kwargs = {}
    model, inputs = "decoder_lm", _tokens(port_http, [1])
    if case == "no_start":
        kwargs = dict(sequence_id=123456)
    elif case == "two_token_continuation":
        port_client.infer("decoder_lm", _tokens(port_http, [1]), sequence_id=55,
                          sequence_start=True)
        inputs, kwargs = _tokens(port_http, [1, 2]), dict(sequence_id=55)
    elif case == "out_of_range":
        inputs, kwargs = _tokens(port_http, [300]), dict(sequence_id=56, sequence_start=True)
    elif case == "decoupled_via_infer":
        model = "tiny_lm_generate"
    elif case == "unknown_model":
        model = "no_such_model"
    elif case == "wrong_dtype":
        arr = np.array([[1.0]], dtype=np.float32)
        inputs = [port_http.InferInput("TOKENS", [1, 1], "FP32").set_data_from_numpy(arr)]
        kwargs = dict(sequence_id=57, sequence_start=True)
    with pytest.raises(InferenceServerException, match=match) as err:
        port_client.infer(model, inputs, **kwargs)
    assert err.value.status() == "400"


# -- simple at JAX's batch_dim / width parameters ------------------------------


def _raw_infer(url, model, body, headers):
    host, port = url.split(":")
    pool = urllib3.HTTPConnectionPool(host, int(port), retries=False)
    try:
        resp = pool.request("POST", f"/v2/models/{model}/infer", body=body, headers=headers)
        return resp.status, resp.headers.get("Inference-Header-Content-Length"), resp.data
    finally:
        pool.close()


def _simple_request(shape, binary):
    """``simple``'s request body at ``shape``: numpy-seeded INT32 inputs,
    as JSON data or as binary tails."""
    rng = np.random.default_rng(shape[-1])
    a, b = (rng.integers(-1000, 1000, shape).astype(np.int32) for _ in range(2))
    if not binary:
        inputs = [{"name": name, "shape": list(shape), "datatype": "INT32",
                   "data": x.reshape(-1).tolist()} for name, x in (("INPUT0", a), ("INPUT1", b))]
        return json.dumps({"inputs": inputs}).encode(), {"Content-Type": "application/json"}
    header = json.dumps({
        "inputs": [{"name": name, "shape": list(shape), "datatype": "INT32",
                    "parameters": {"binary_data_size": x.nbytes}}
                   for name, x in (("INPUT0", a), ("INPUT1", b))],
        "outputs": [{"name": name, "parameters": {"binary_data": True}}
                    for name in ("OUTPUT0", "OUTPUT1")]}).encode()
    return header + a.tobytes() + b.tobytes(), {
        "Content-Type": "application/octet-stream",
        "Inference-Header-Content-Length": str(len(header))}


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
@pytest.mark.parametrize("batch_dim,width", [(1, 64), (2, 16), (1, 16)])
def test_simple_takes_jax_batch_dim_and_width(batch_dim, width, binary):
    """``AddSubModel(batch_dim, width)`` as JAX's: specs [batch_dim, width],
    and the port's server answers a request of that shape with a body
    byte-identical to the JAX server's (``simple`` at width 64 among
    them); a request of another shape is refused by both."""
    from client_tpu_torch.models.simple import AddSubModel

    port = HttpInferenceServer(ServerCore([AddSubModel(batch_dim, width, device="cpu")],
                                          device="cpu")).start()
    jax = JaxServer(JaxCore([JaxAddSub(batch_dim=batch_dim, width=width)])).start()
    try:
        assert [s.shape for s in AddSubModel(batch_dim, width, device="cpu").inputs()] == \
            [[batch_dim, width]] * 2
        body, headers = _simple_request((batch_dim, width), binary)
        ours = _raw_infer(port.url, "simple", body, headers)
        theirs = _raw_infer(jax.url, "simple", body, headers)
        assert ours[0] == 200 and ours == theirs
        body, headers = _simple_request((batch_dim, width + 1), binary)
        assert _raw_infer(port.url, "simple", body, headers)[0] == \
            _raw_infer(jax.url, "simple", body, headers)[0] == 400
    finally:
        port.stop()
        jax.stop()
