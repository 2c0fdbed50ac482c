"""GRPC wire parity: the port's codec and sync GRPC client speak byte for byte
what the JAX package's speak.

- the codec: every message spec of ``_messages`` has the same fields in both
  packages; random messages drawn from each spec encode to the same bytes and
  decode to the same dicts (the patterns of tests/test_wire_codec.py and
  tests/test_wire_fuzz.py), and byte soup decodes alike or fails alike;
- the client: a capturing generic GRPC handler records the method, request
  frame and invocation metadata of both sync clients for INT32, FP32, BF16
  and BYTES tensors, raw and typed contents, numpy and torch inputs,
  requested outputs, sequence and custom parameters, shared-memory
  references, compression, the auth plugin and every admin rpc, unary,
  async and on the bidi stream. Each pair must be identical.
"""

import queue
import random
import string
import threading
from concurrent import futures

import grpc
import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.grpc as jax_grpc
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.utils as port_utils
from client_tpu.grpc import _infer as jax_infer
from client_tpu.grpc import _messages as jax_M
from client_tpu.grpc import _wire as jax_wire
from client_tpu_torch.grpc import _infer as port_infer
from client_tpu_torch.grpc import _messages as port_M
from client_tpu_torch.grpc import _wire as port_wire


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the codec -----------------------------------------------------------------


def _specs(module):
    return {name: value for name, value in vars(module).items()
            if isinstance(value, module.MessageSpec)}


SPEC_NAMES = sorted(_specs(jax_M))


def _shape_of(spec, depth=0):
    """A spec's fields, recursively, as plain tuples."""
    if depth > 6:
        return spec.name
    out = []
    for f in spec.fields:
        sub = None
        if f.msg is not None:
            sub = _shape_of(f.msg, depth + 1)
        elif f.map_kv is not None:
            kf, vf = f.map_kv
            sub = (kf.kind, vf.kind, _shape_of(vf.msg, depth + 1) if vf.msg else None)
        out.append((f.name, f.num, f.kind, f.repeated, f.oneof, sub))
    return (spec.name, tuple(out))


def test_spec_tables_match():
    assert sorted(_specs(port_M)) == SPEC_NAMES
    assert port_M.METHODS.keys() == jax_M.METHODS.keys()
    for method, (req, resp) in jax_M.METHODS.items():
        ours = port_M.METHODS[method]
        assert (_shape_of(ours[0]), _shape_of(ours[1])) == (_shape_of(req), _shape_of(resp))
        assert port_M.method_path(method) == jax_M.method_path(method)
    assert port_M.CONFIG_DATATYPE_NAMES == jax_M.CONFIG_DATATYPE_NAMES


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_spec_fields_match(name):
    assert _shape_of(_specs(port_M)[name]) == _shape_of(_specs(jax_M)[name])


_ALPHABET = string.ascii_letters + string.digits + " _-/"


def _scalar(rng, kind):
    if kind in ("int32", "enum"):
        return rng.randint(-(1 << 31), (1 << 31) - 1) if kind == "int32" else rng.randint(0, 20)
    if kind == "int64":
        return rng.randint(-(1 << 62), 1 << 62)
    if kind == "uint32":
        return rng.randint(0, (1 << 32) - 1)
    if kind == "uint64":
        return rng.randint(0, (1 << 64) - 1)
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "float":
        return float(np.float32(rng.uniform(-1e6, 1e6)))
    if kind == "double":
        return rng.uniform(-1e300, 1e300)
    if kind == "string":
        return "".join(rng.choice(_ALPHABET) for _ in range(rng.randint(0, 10)))
    if kind == "bytes":
        return rng.randbytes(rng.randint(0, 24))
    raise AssertionError(kind)


def _message(rng, spec, depth=0):
    """A random dict for ``spec``: each field present at random, one member
    of each oneof group, sub-messages and maps to depth 3."""
    out, oneofs = {}, set()
    for f in spec.fields:
        if rng.random() < 0.35:
            continue
        if f.oneof is not None:
            if f.oneof in oneofs:
                continue
            oneofs.add(f.oneof)
        if f.kind == "message":
            if depth >= 3:
                continue
            n = rng.randint(0, 2) if f.repeated else 1
            items = [_message(rng, f.msg, depth + 1) for _ in range(n)]
            out[f.name] = items if f.repeated else items[0]
        elif f.kind == "map":
            if depth >= 3:
                continue
            kf, vf = f.map_kv
            entries = {}
            for _ in range(rng.randint(0, 2)):
                key = _scalar(rng, kf.kind)
                entries[key] = (_message(rng, vf.msg, depth + 1) if vf.kind == "message"
                                else _scalar(rng, vf.kind))
            out[f.name] = entries
        elif f.repeated:
            out[f.name] = [_scalar(rng, f.kind) for _ in range(rng.randint(0, 3))]
        else:
            out[f.name] = _scalar(rng, f.kind)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_random_messages_encode_and_decode_alike(name, seed):
    rng = random.Random(f"{name}:{seed}")
    message = _message(rng, _specs(jax_M)[name])
    ours = port_wire.encode_message(_specs(port_M)[name], message)
    theirs = jax_wire.encode_message(_specs(jax_M)[name], message)
    assert ours == theirs
    assert (port_wire.decode_message(_specs(port_M)[name], ours)
            == jax_wire.decode_message(_specs(jax_M)[name], theirs))


def _decode_or_error(wire, spec, raw):
    try:
        return "ok", wire.decode_message(spec, raw)
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("case", range(60))
def test_garbage_decodes_alike(case):
    rng = random.Random(0x7A11 + case)
    raw = rng.randbytes(rng.randint(0, 48))
    if rng.random() < 0.5:
        raw = bytes([(rng.randint(1, 15) << 3) | rng.choice([0, 1, 2, 5])]) + raw
    for name in ("MODEL_INFER_REQUEST", "MODEL_INFER_RESPONSE", "MODEL_STATISTICS_RESPONSE"):
        assert (_decode_or_error(port_wire, _specs(port_M)[name], raw)
                == _decode_or_error(jax_wire, _specs(jax_M)[name], raw))


@pytest.mark.parametrize("value", [True, False, 0, -7, 1 << 40, 2.5, "", "abc"])
def test_infer_parameters_match(value):
    assert port_infer.to_infer_parameter(value) == jax_infer.to_infer_parameter(value)
    param = jax_infer.to_infer_parameter(value)
    assert port_infer.from_infer_parameter(param) == jax_infer.from_infer_parameter(param)


def test_bad_parameter_type_raises_alike():
    with pytest.raises(Exception) as ours:
        port_infer.to_infer_parameter([1])
    with pytest.raises(Exception) as theirs:
        jax_infer.to_infer_parameter([1])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("algorithm", [None, "gzip", "deflate", "GZIP", "Deflate"])
def test_compression_maps_match(algorithm):
    assert (port_infer.to_grpc_compression(algorithm)
            == jax_infer.to_grpc_compression(algorithm))


def test_unknown_compression_warns_alike():
    with pytest.warns(UserWarning) as ours:
        a = port_infer.to_grpc_compression("brotli")
    with pytest.warns(UserWarning) as theirs:
        b = jax_infer.to_grpc_compression("brotli")
    assert a == b == grpc.Compression.NoCompression
    assert str(ours[0].message) == str(theirs[0].message)


# -- the sync client against a capturing handler --------------------------------


class _Capture(grpc.GenericRpcHandler):
    """Records (method, request frame, invocation metadata) of every call and
    answers with an empty message (every response spec decodes it)."""

    def __init__(self):
        self.seen = []
        self.lock = threading.Lock()

    def _record(self, method, frame, context):
        metadata = tuple(sorted(
            (k, v) for k, v in (context.invocation_metadata() or ())
            if k != "user-agent"))
        with self.lock:
            self.seen.append((method, bytes(frame), metadata))

    def service(self, details):
        method = details.method

        def unary(frame, context):
            self._record(method, frame, context)
            return b""

        def stream(frames, context):
            for frame in frames:
                self._record(method, frame, context)
            return iter(())

        if method.endswith("/ModelStreamInfer"):
            return grpc.stream_stream_rpc_method_handler(stream)
        return grpc.unary_unary_rpc_method_handler(unary)


@pytest.fixture(scope="module")
def capture():
    handler = _Capture()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    handler.url = f"127.0.0.1:{port}"
    yield handler
    server.stop(0).wait()


def _send(capture, mod, call, expect=1):
    """Run ``call(client)`` against the capture; the recorded calls."""
    capture.seen.clear()
    client = mod.InferenceServerClient(capture.url)
    try:
        try:
            call(client)
        except Exception:
            pass  # the empty answers are not always a valid result
    finally:
        client.close()
    assert len(capture.seen) == expect, capture.seen
    return list(capture.seen)


A_INT = np.arange(12, dtype=np.int32).reshape(3, 4)
A_FP = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
A_BF = A_FP.astype(ml_dtypes.bfloat16)
A_BYTES = np.array([[b"alpha", b"", "gamma".encode(), b"\x00\xff"]], dtype=np.object_)
A_STR = np.array([["a", "bb", "ccc"]], dtype=np.object_)


def _inputs(mod, case):
    """(inputs, outputs, infer kwargs) for one wire case in package ``mod``;
    the port gets torch tensors where the case says so."""
    port = mod is port_grpc

    def inp(name, arr, datatype, binary=True, torch_in=False):
        x = mod.InferInput(name, list(arr.shape), datatype)
        value = port_utils.numpy_to_tensor(arr, "cpu") if torch_in and port else arr
        return x.set_data_from_numpy(value, binary_data=binary)

    outputs, kwargs = None, {}
    if case == "int32_raw":
        inputs = [inp("INPUT0", A_INT, "INT32"), inp("INPUT1", A_INT + 1, "INT32")]
    elif case == "int32_typed":
        inputs = [inp("INPUT0", A_INT, "INT32", binary=False),
                  inp("INPUT1", A_INT - 3, "INT32", binary=False)]
    elif case == "fp32_raw":
        inputs = [inp("INPUT0", A_FP, "FP32")]
    elif case == "fp32_typed":
        inputs = [inp("INPUT0", A_FP, "FP32", binary=False)]
    elif case == "fp32_torch":
        inputs = [inp("INPUT0", A_FP, "FP32", torch_in=True)]
    elif case == "bf16_raw":
        inputs = [inp("INPUT0", A_BF, "BF16")]
    elif case == "bf16_torch":
        inputs = [inp("INPUT0", A_BF, "BF16", torch_in=True)]
    elif case == "int32_torch_typed":
        inputs = [inp("INPUT0", A_INT, "INT32", binary=False, torch_in=True)]
    elif case == "bytes_raw":
        inputs = [inp("INPUT0", A_BYTES, "BYTES")]
    elif case == "bytes_typed":
        inputs = [inp("INPUT0", A_STR, "BYTES", binary=False)]
    elif case == "requested_outputs":
        inputs = [inp("INPUT0", A_FP, "FP32")]
        outputs = [mod.InferRequestedOutput("OUTPUT0"),
                   mod.InferRequestedOutput("OUTPUT1", binary_data=False),
                   mod.InferRequestedOutput("OUTPUT2", class_count=3)]
    elif case == "sequence_params":
        inputs = [inp("TOKENS", A_INT[:1], "INT32")]
        kwargs = dict(request_id="rq-7", sequence_id=42, sequence_start=True,
                      sequence_end=False, priority=2, timeout=5000,
                      parameters={"chunk": 4, "tag": "x", "ratio": 0.5, "flag": True})
    elif case == "shared_memory":
        x = mod.InferInput("INPUT0", [3, 4], "FP32").set_data_from_numpy(A_FP)
        inputs = [x.set_shared_memory("in_region", 48, offset=16),
                  mod.InferInput("INPUT1", [3, 4], "FP32").set_shared_memory("in_region", 48)]
        out = mod.InferRequestedOutput("OUTPUT0", class_count=2)
        out.set_shared_memory("out_region", 48, offset=8)
        outputs = [out, mod.InferRequestedOutput("OUTPUT1").set_shared_memory("o2", 4)]
    elif case == "gzip":
        inputs = [inp("INPUT0", A_FP, "FP32")]
        kwargs = dict(compression_algorithm="gzip")
    elif case == "custom_headers":
        inputs = [inp("INPUT0", A_INT, "INT32")]
        kwargs = dict(headers={"x-trace": "abc", "triton_grpc_error": "true"},
                      model_version="3")
    else:
        raise AssertionError(case)
    return inputs, outputs, kwargs


WIRE_CASES = [
    "int32_raw", "int32_typed", "fp32_raw", "fp32_typed", "fp32_torch", "bf16_raw",
    "bf16_torch", "int32_torch_typed", "bytes_raw", "bytes_typed", "requested_outputs",
    "sequence_params", "shared_memory", "gzip", "custom_headers",
]


@pytest.mark.parametrize("case", WIRE_CASES)
def test_infer_frame_is_byte_identical(capture, case):
    seen = []
    for mod in (jax_grpc, port_grpc):
        inputs, outputs, kwargs = _inputs(mod, case)
        seen.append(_send(capture, mod, lambda c: c.infer("m", inputs, outputs=outputs,
                                                           **kwargs)))
    assert seen[0] == seen[1]
    assert seen[1][0][0] == "/inference.GRPCInferenceService/ModelInfer"


@pytest.mark.parametrize("case", ["int32_raw", "bytes_typed", "sequence_params",
                                  "shared_memory", "custom_headers"])
def test_async_infer_frame_is_byte_identical(capture, case):
    seen = []
    for mod in (jax_grpc, port_grpc):
        inputs, outputs, kwargs = _inputs(mod, case)
        kwargs.pop("compression_algorithm", None)
        done = queue.Queue()

        def call(c, inputs=inputs, outputs=outputs, kwargs=kwargs, done=done):
            c.async_infer("m", inputs, callback=lambda r, e: done.put(e),
                          outputs=outputs, **kwargs)
            done.get(timeout=30)

        seen.append(_send(capture, mod, call))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("case", ["int32_raw", "sequence_params", "bf16_raw",
                                  "shared_memory"])
def test_stream_frames_are_byte_identical(capture, case):
    seen = []
    for mod in (jax_grpc, port_grpc):
        inputs, outputs, kwargs = _inputs(mod, case)
        kwargs.pop("headers", None)

        def call(c, inputs=inputs, outputs=outputs, kwargs=kwargs):
            c.start_stream(lambda r, e: None, headers={"x-stream": "1"})
            c.async_stream_infer("m", inputs, outputs=outputs, **kwargs)
            c.async_stream_infer("repeat_int32", inputs, request_id="second",
                                 enable_empty_final_response=True)
            c.stop_stream()

        seen.append(_send(capture, mod, call, expect=2))
    assert seen[0] == seen[1]


def test_basic_auth_metadata_matches(capture):
    seen = []
    for mod in (jax_grpc, port_grpc):
        def call(client, mod=mod):
            client.register_plugin(mod.BasicAuth("user", "pw"))
            return client.get_model_metadata("simple", "2")
        seen.append(_send(capture, mod, call))
    assert seen[0] == seen[1]
    assert dict(seen[1][0][2])["authorization"].startswith("Basic ")


def test_auth_namespace_matches():
    import client_tpu.grpc.auth as jax_auth
    import client_tpu_torch.grpc.auth as port_auth

    assert sorted(port_auth.__all__) == sorted(jax_auth.__all__)


HANDLE = "eyJzaG1fa2V5IjogImsifQ=="  # any base64 descriptor

ADMIN_CALLS = {
    "server_live": lambda c: c.is_server_live(),
    "server_ready": lambda c: c.is_server_ready(headers={"k": "v"}),
    "model_ready": lambda c: c.is_model_ready("simple", "1"),
    "server_metadata": lambda c: c.get_server_metadata(),
    "model_metadata": lambda c: c.get_model_metadata("decoder_lm"),
    "model_config": lambda c: c.get_model_config("decoder_lm", "1"),
    "repository_index": lambda c: c.get_model_repository_index(),
    "load_model": lambda c: c.load_model("simple"),
    "load_model_config": lambda c: c.load_model(
        "simple", config='{"max_batch_size": 4}', files={"1/model.bin": b"\x00\x01"}),
    "unload_model": lambda c: c.unload_model("simple"),
    "unload_dependents": lambda c: c.unload_model("simple", unload_dependents=True),
    "statistics_all": lambda c: c.get_inference_statistics(),
    "statistics_model": lambda c: c.get_inference_statistics("simple", "1"),
    "trace_get": lambda c: c.get_trace_settings(),
    "trace_get_model": lambda c: c.get_trace_settings(model_name="simple"),
    "trace_update": lambda c: c.update_trace_settings(
        settings={"trace_level": ["TIMESTAMPS", "TENSORS"], "trace_rate": 10,
                  "trace_file": None}),
    "trace_update_model": lambda c: c.update_trace_settings(
        model_name="simple", settings={"trace_count": "5"}),
    "log_get": lambda c: c.get_log_settings(),
    "log_update": lambda c: c.update_log_settings(
        {"log_info": False, "log_verbose_level": 2, "log_format": "ISO8601"}),
    "system_status": lambda c: c.get_system_shared_memory_status("r0"),
    "system_status_all": lambda c: c.get_system_shared_memory_status(),
    "register_system": lambda c: c.register_system_shared_memory("r0", "/k0", 64, offset=8),
    "unregister_system": lambda c: c.unregister_system_shared_memory("r0"),
    "unregister_system_all": lambda c: c.unregister_system_shared_memory(),
    "cuda_status": lambda c: c.get_cuda_shared_memory_status("c0"),
    "register_cuda": lambda c: c.register_cuda_shared_memory("c0", HANDLE, 0, 128),
    "register_cuda_bytes": lambda c: c.register_cuda_shared_memory(
        "c1", HANDLE.encode("ascii"), 1, 1 << 33),
    "unregister_cuda": lambda c: c.unregister_cuda_shared_memory(),
}


@pytest.mark.parametrize("op", sorted(ADMIN_CALLS))
def test_admin_frames_are_byte_identical(capture, op):
    seen = [_send(capture, mod, ADMIN_CALLS[op]) for mod in (jax_grpc, port_grpc)]
    assert seen[0] == seen[1]


def test_result_decoding_matches():
    """The same ModelInferResponse through both packages' InferResult."""
    raw = [A_INT.tobytes(), port_utils.serialize_bf16_tensor(A_BF).item(),
           port_utils.serialize_byte_tensor(A_BYTES).item()]
    response = {
        "model_name": "m", "model_version": "1", "id": "r",
        "parameters": {"triton_final_response": {"bool_param": True}},
        "outputs": [
            {"name": "I", "datatype": "INT32", "shape": [3, 4]},
            {"name": "S", "datatype": "FP32", "shape": [2], "parameters": {
                "shared_memory_region": {"string_param": "r0"},
                "shared_memory_byte_size": {"int64_param": 8}}},
            {"name": "H", "datatype": "BF16", "shape": [3, 4]},
            {"name": "B", "datatype": "BYTES", "shape": [1, 4]},
        ],
        "raw_output_contents": raw,
    }
    frame = jax_wire.encode_message(jax_M.MODEL_INFER_RESPONSE, response)
    ours = port_grpc.InferResult(port_wire.decode_message(port_M.MODEL_INFER_RESPONSE, frame))
    theirs = jax_grpc.InferResult(jax_wire.decode_message(jax_M.MODEL_INFER_RESPONSE, frame))
    for name in ("I", "S", "H", "B", "absent"):
        a, b = ours.as_numpy(name), theirs.as_numpy(name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape and a.tolist() == b.tolist()
    assert ours.is_final_response() and theirs.is_final_response()
    assert ours.is_null_response() == theirs.is_null_response()
    t = ours.as_torch("H", device="cpu")
    assert t.dtype == torch.bfloat16
    assert port_utils.tensor_to_numpy(t).tobytes() == theirs.as_numpy("H").tobytes()
    with pytest.raises(port_utils.InferenceServerException, match="BYTES"):
        ours.as_torch("B", device="cpu")


def test_typed_contents_decode_alike():
    response = {"outputs": [{"name": "T", "datatype": "FP32", "shape": [3],
                             "contents": {"fp32_contents": [1.5, -2.0, 3.25]}}]}
    ours = port_grpc.InferResult(response).as_numpy("T")
    theirs = jax_grpc.InferResult(response).as_numpy("T")
    assert ours.dtype == theirs.dtype and ours.tolist() == theirs.tolist()


@pytest.mark.parametrize("kwargs", [
    dict(parameters={"sequence_id": 1}),
    dict(parameters={"priority": 1}),
    dict(parameters={"bad": [1]}),
])
def test_request_builder_errors_match(kwargs):
    def build(mod, infer):
        x = mod.InferInput("INPUT0", [3, 4], "INT32").set_data_from_numpy(A_INT)
        try:
            infer.build_infer_request("m", [x], **kwargs)
        except Exception as e:
            return type(e).__name__, str(e)
        return None

    assert build(port_grpc, port_infer) == build(jax_grpc, jax_infer) is not None


def test_mixed_raw_and_typed_inputs_raise_alike():
    def build(mod, infer):
        a = mod.InferInput("A", [3, 4], "INT32").set_data_from_numpy(A_INT)
        b = mod.InferInput("B", [3, 4], "INT32").set_data_from_numpy(A_INT, binary_data=False)
        c = mod.InferInput("C", [3, 4], "INT32")
        out = []
        for inputs in ([a, b], [c]):
            with pytest.raises(Exception) as err:
                infer.build_infer_request("m", inputs)
            out.append(str(err.value))
        return out

    assert build(port_grpc, port_infer) == build(jax_grpc, jax_infer)
