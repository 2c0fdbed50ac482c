"""Wire parity: the port's client speaks byte for byte what the JAX package's
client speaks.

Both clients send the same requests to a capturing HTTP endpoint, and the
recorded request lines, headers and bodies must be identical — for INT32,
FP32, BF16 and BYTES tensors, binary and JSON, numpy and torch inputs,
requested outputs, sequence and custom parameters, shared-memory
references, compression and auth plugins. The serializers, dtype maps,
response decoding and SSE framing are held against the JAX package's too
(the patterns of tests/test_infer_body.py).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu.utils as jax_utils
import client_tpu_torch.http as port_http
import client_tpu_torch.utils as port_utils
from client_tpu.http._utils import SSEDecoder as JaxSSEDecoder
from client_tpu.http._utils import build_infer_body as jax_build
from client_tpu_torch.http._utils import SSEDecoder as PortSSEDecoder
from client_tpu_torch.http._utils import build_infer_body as port_build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Capture(BaseHTTPRequestHandler):
    """Records every request, answers 400 (so no response decoding runs)."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _record(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        self.server.seen.append((self.command, self.path, dict(self.headers), body))
        payload = b'{"error":"captured"}'
        self.send_response(400)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_POST = _record


@pytest.fixture(scope="module")
def capture():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Capture)
    server.seen = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def _send(capture, client_cls, call):
    url = f"127.0.0.1:{capture.server_address[1]}"
    capture.seen.clear()
    client = client_cls(url)
    try:
        try:
            result = call(client)
            if hasattr(result, "__next__"):
                list(result)
        except Exception:
            pass  # the capture endpoint always answers 400
    finally:
        client.close()
    assert len(capture.seen) == 1
    return capture.seen[0]


A_INT = np.arange(12, dtype=np.int32).reshape(3, 4)
A_FP = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
A_BF = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16)
A_BYTES = np.array([[b"alpha", b"", "gamma".encode(), b"\x00\xff"]], dtype=np.object_)
A_STR = np.array([["a", "bb", "ccc"]], dtype=np.object_)


def _inputs(http, case):
    """(inputs, outputs, infer kwargs) for one wire case in package ``http``;
    the port gets torch tensors where the case says so."""
    port = http is port_http

    def inp(name, arr, datatype, binary=True, torch_in=False):
        x = http.InferInput(name, list(arr.shape), datatype)
        value = arr
        if torch_in and port:
            value = port_utils.numpy_to_tensor(arr, "cpu")
        return x.set_data_from_numpy(value, binary_data=binary)

    outputs, kwargs = None, {}
    if case == "int32_binary":
        inputs = [inp("INPUT0", A_INT, "INT32"), inp("INPUT1", A_INT + 1, "INT32")]
    elif case == "int32_json":
        inputs = [inp("INPUT0", A_INT, "INT32", binary=False)]
    elif case == "fp32_binary":
        inputs = [inp("INPUT0", A_FP, "FP32")]
    elif case == "fp32_json":
        inputs = [inp("INPUT0", A_FP, "FP32", binary=False)]
    elif case == "fp32_torch":
        inputs = [inp("INPUT0", A_FP, "FP32", torch_in=True)]
    elif case == "bf16_binary":
        inputs = [inp("INPUT0", A_BF, "BF16")]
    elif case == "bf16_torch":
        inputs = [inp("INPUT0", A_BF, "BF16", torch_in=True)]
    elif case == "int32_torch_json":
        inputs = [inp("INPUT0", A_INT, "INT32", binary=False, torch_in=True)]
    elif case == "bytes_binary":
        inputs = [inp("INPUT0", A_BYTES, "BYTES")]
    elif case == "bytes_json":
        inputs = [inp("INPUT0", A_STR, "BYTES", binary=False)]
    elif case == "mixed_outputs":
        inputs = [inp("INPUT0", A_FP, "FP32"), inp("INPUT1", A_STR, "BYTES", binary=False)]
        outputs = [http.InferRequestedOutput("OUTPUT0"),
                   http.InferRequestedOutput("OUTPUT1", binary_data=False),
                   http.InferRequestedOutput("OUTPUT2", class_count=3)]
    elif case == "sequence_params":
        inputs = [inp("TOKENS", A_INT[:1], "INT32")]
        kwargs = dict(request_id="rq-7", sequence_id=42, sequence_start=True,
                      sequence_end=False, priority=2, timeout=5000,
                      parameters={"chunk": 4, "tag": "x"})
    elif case == "shared_memory":
        x = http.InferInput("INPUT0", [3, 4], "FP32")
        x.set_data_from_numpy(A_FP)
        inputs = [x.set_shared_memory("in_region", 48, offset=16)]
        out = http.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory("out_region", 48)
        outputs = [out]
    elif case == "deflate":
        inputs = [inp("INPUT0", A_FP, "FP32")]
        kwargs = dict(request_compression_algorithm="deflate",
                      response_compression_algorithm="gzip")
    elif case == "custom_headers":
        inputs = [inp("INPUT0", A_INT, "INT32")]
        kwargs = dict(headers={"x-trace": "abc"}, model_version="3")
    else:
        raise AssertionError(case)
    return inputs, outputs, kwargs


WIRE_CASES = [
    "int32_binary", "int32_json", "fp32_binary", "fp32_json", "fp32_torch",
    "bf16_binary", "bf16_torch", "int32_torch_json", "bytes_binary", "bytes_json",
    "mixed_outputs", "sequence_params", "shared_memory", "deflate", "custom_headers",
]


@pytest.mark.parametrize("case", WIRE_CASES)
def test_infer_request_is_byte_identical(capture, case):
    seen = []
    for http in (jax_http, port_http):
        inputs, outputs, kwargs = _inputs(http, case)
        seen.append(_send(capture, http.InferenceServerClient,
                          lambda c: c.infer("m", inputs, outputs=outputs, **kwargs)))
    assert seen[0] == seen[1]
    assert seen[1][0] == "POST" and seen[1][1].endswith("/infer")


@pytest.mark.parametrize("case", ["int32_binary", "bytes_json", "mixed_outputs",
                                  "sequence_params", "shared_memory"])
def test_offline_body_is_byte_identical(case):
    jax_in, jax_out, kwargs = _inputs(jax_http, case)
    port_in, port_out, _ = _inputs(port_http, case)
    kwargs = {k: v for k, v in kwargs.items()
              if k in ("request_id", "sequence_id", "sequence_start", "sequence_end",
                       "priority", "timeout", "parameters")}
    assert port_build(port_in, port_out, **kwargs) == jax_build(jax_in, jax_out, **kwargs)


def test_basic_auth_plugin_headers_match(capture):
    seen = []
    for http in (jax_http, port_http):
        def call(client, http=http):
            client.register_plugin(http.BasicAuth("user", "pw"))
            return client.get_model_metadata("simple")
        seen.append(_send(capture, http.InferenceServerClient, call))
    assert seen[0] == seen[1]
    assert seen[1][2]["authorization"].startswith("Basic ")


@pytest.mark.parametrize("op", [
    "health_live", "health_ready", "model_ready", "server_metadata", "model_config",
    "register_system", "unregister_system", "system_status",
    "register_cuda", "unregister_cuda", "cuda_status",
    "generate", "generate_stream",
])
def test_control_requests_are_byte_identical(capture, op):
    handle = "eyJzaG1fa2V5IjogImsifQ=="  # any base64 descriptor
    calls = {
        "health_live": lambda c: c.is_server_live(),
        "health_ready": lambda c: c.is_server_ready(),
        "model_ready": lambda c: c.is_model_ready("simple", "1"),
        "server_metadata": lambda c: c.get_server_metadata(),
        "model_config": lambda c: c.get_model_config("decoder_lm"),
        "register_system": lambda c: c.register_system_shared_memory("r0", "/k0", 64, offset=8),
        "unregister_system": lambda c: c.unregister_system_shared_memory("r0"),
        "system_status": lambda c: c.get_system_shared_memory_status("r0"),
        "register_cuda": lambda c: c.register_cuda_shared_memory("c0", handle, 0, 128),
        "unregister_cuda": lambda c: c.unregister_cuda_shared_memory(),
        "cuda_status": lambda c: c.get_cuda_shared_memory_status(),
        "generate": lambda c: c.generate("tiny_lm_generate", {"TOKENS": [1, 2], "MAX_TOKENS": 1}),
        "generate_stream": lambda c: c.generate_stream(
            "tiny_lm_generate", {"TOKENS": [1, 2, 3], "MAX_TOKENS": 4},
            request_id="g1", parameters={"chunk": 2}),
    }
    seen = [_send(capture, http.InferenceServerClient, calls[op])
            for http in (jax_http, port_http)]
    assert seen[0] == seen[1]


# -- serializers and dtype maps ----------------------------------------------


@pytest.mark.parametrize("arr", [
    A_BYTES, A_STR, np.array([], dtype=np.object_),
    np.array([[1, 22], [333, 4444]], dtype=np.object_),
], ids=["bytes", "str", "empty", "ints"])
def test_bytes_serializer_matches(arr):
    ours, theirs = port_utils.serialize_byte_tensor(arr), jax_utils.serialize_byte_tensor(arr)
    assert ours.size == theirs.size
    if ours.size:
        assert ours.item() == theirs.item()
        np.testing.assert_array_equal(
            port_utils.deserialize_bytes_tensor(ours.item()),
            jax_utils.deserialize_bytes_tensor(theirs.item()))


@pytest.mark.parametrize("arr", [A_BF, A_FP, np.array([1e-40, 65504.0, -0.0], np.float32)],
                         ids=["bf16", "fp32_rounded", "edge"])
def test_bf16_serializer_matches(arr):
    ours = port_utils.serialize_bf16_tensor(arr).item()
    assert ours == jax_utils.serialize_bf16_tensor(arr).item()
    np.testing.assert_array_equal(
        port_utils.deserialize_bf16_tensor(ours).view(np.uint16),
        jax_utils.deserialize_bf16_tensor(ours).view(np.uint16))


TORCH_DTYPES = [
    (torch.bool, "BOOL"), (torch.int8, "INT8"), (torch.int16, "INT16"),
    (torch.int32, "INT32"), (torch.int64, "INT64"), (torch.uint8, "UINT8"),
    (torch.float16, "FP16"), (torch.float32, "FP32"), (torch.float64, "FP64"),
    (torch.bfloat16, "BF16"),
]


@pytest.mark.parametrize("dtype,triton", TORCH_DTYPES, ids=[t for _, t in TORCH_DTYPES])
def test_torch_dtype_maps_and_host_roundtrip(dtype, triton):
    assert port_utils.torch_to_triton_dtype(dtype) == triton
    assert port_utils.triton_to_torch_dtype(triton) == dtype
    assert port_utils.triton_to_np_dtype(triton) == jax_utils.triton_to_np_dtype(triton)
    t = (torch.arange(-3, 9) % 2 == 0) if dtype == torch.bool else torch.arange(-3, 9).to(dtype)
    host = port_utils.tensor_to_numpy(t)
    assert np.dtype(host.dtype) == np.dtype(jax_utils.triton_to_np_dtype(triton))
    back = port_utils.numpy_to_tensor(host, "cpu")
    assert back.dtype == dtype and torch.equal(back, t)


def test_np_dtype_maps_match():
    for triton in ("BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
                   "UINT32", "UINT64", "FP16", "FP32", "FP64", "BYTES", "BF16"):
        np_dtype = port_utils.triton_to_np_dtype(triton)
        assert np_dtype == jax_utils.triton_to_np_dtype(triton)
        assert port_utils.np_to_triton_dtype(np_dtype) == jax_utils.np_to_triton_dtype(np_dtype)
        assert (port_utils.triton_dtype_element_size(triton)
                == jax_utils.triton_dtype_element_size(triton))


def test_bf16_tensor_crosses_to_numpy_bit_exact():
    t = torch.tensor([1.0, -2.5, 3.140625, float("inf")], dtype=torch.bfloat16)
    host = port_utils.tensor_to_numpy(t)
    assert host.dtype == ml_dtypes.bfloat16
    assert host.view(np.uint16).tolist() == t.view(torch.int16).numpy().view(np.uint16).tolist()


# -- responses -----------------------------------------------------------------


def _response_body():
    out_bin = np.arange(6, dtype=np.float32).reshape(2, 3)
    out_bf = A_BF[:1]
    header = {
        "model_name": "m", "model_version": "1", "id": "r1",
        "outputs": [
            {"name": "B", "datatype": "FP32", "shape": [2, 3],
             "parameters": {"binary_data_size": out_bin.nbytes}},
            {"name": "H", "datatype": "BF16", "shape": [1, 4],
             "parameters": {"binary_data_size": out_bf.nbytes}},
            {"name": "J", "datatype": "INT32", "shape": [2], "data": [7, 8]},
            {"name": "S", "datatype": "BYTES", "shape": [2], "data": ["x", "yz"]},
            {"name": "M", "datatype": "FP32", "shape": [2],
             "parameters": {"shared_memory_region": "r0", "shared_memory_byte_size": 8}},
        ],
    }
    hj = json.dumps(header).encode()
    return hj + out_bin.tobytes() + out_bf.tobytes(), len(hj)


@pytest.mark.parametrize("name", ["B", "H", "J", "S", "M", "absent"])
def test_result_decoding_matches(name):
    body, hl = _response_body()
    ours = port_http.InferResult.from_response_body(body, hl)
    theirs = jax_http.InferResult.from_response_body(body, hl)
    a, b = ours.as_numpy(name), theirs.as_numpy(name)
    if b is None:
        assert a is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.object_:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()
        t = ours.as_torch(name, device="cpu")
        assert t.dtype == port_utils.triton_to_torch_dtype(ours.get_output(name)["datatype"])
        assert port_utils.tensor_to_numpy(t).tobytes() == b.tobytes()


@pytest.mark.parametrize("body,hl", [
    (b"{not json", None),
    (b"[1, 2]", None),
    (b'{"outputs": [{"name": "B", "parameters": {"binary_data_size": 99}}]}', None),
    (b"{}", 10),
])
def test_malformed_responses_raise_typed(body, hl):
    with pytest.raises(port_utils.InferenceServerException):
        port_http.InferResult.from_response_body(body, hl)


@pytest.mark.parametrize("chunking", [1, 3, 7, 1000])
def test_sse_decoder_matches(chunking):
    stream = (b'data: {"a":1}\n\ndata: {"b":2}\r\n\r\n: comment\n\n'
              b'data: {"c":\ndata: 3}\n\ndata: {"tail":true}')
    results = []
    for decoder in (JaxSSEDecoder(), PortSSEDecoder()):
        events = []
        for i in range(0, len(stream), chunking):
            events += decoder.feed(stream[i:i + chunking])
        results.append(events + decoder.flush())
    assert results[0] == results[1]
    assert len(results[1]) == 4

