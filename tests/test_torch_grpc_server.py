"""The port's GRPC server and sync GRPC client against the JAX package's.

- the 2x2 matrix (port and JAX clients against port and JAX GRPC servers)
  for the cases of tests/test_grpc_e2e.py: every combination must give what
  the JAX client gets from the JAX server — outputs, response ids, error
  messages and status codes. Its tpu shared-memory case runs as cuda shared
  memory (a port ``cuda_shared_memory`` region on the CPU, whose handle the
  JAX server's cuda branch reads through the host window);
- the port server's own contracts: the Tpu rpcs answer UNIMPLEMENTED, a
  killed server ends the stream with UNAVAILABLE, statistics count what
  was sent, ``auto_reconnect`` raises as the JAX client does without a
  policy;
- ``decoder_lm`` over one bidi stream and ``decoder_lm_batched`` over
  concurrent streams: greedy tokens equal to JAX's (but at the known near
  ties, ``NEAR_TIES``), logits within 5e-2, and equal to the port's HTTP
  path exactly.

Servers bind ephemeral ports; every shm key is uuid-named (region names in
the matrix are fixed, as they appear in error messages) and every region is
destroyed.
"""

import queue
import threading
import uuid

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import client_tpu.grpc as jax_grpc
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
from client_tpu.models import simple as jax_simple
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import (
    AddSubModel,
    BatchedDecoderModel,
    IdentityModel,
    RepeatModel,
    SequenceAccumulatorModel,
    StringAddSubModel,
    TinyDecoderModel,
    load_jax_params,
)
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as shm
from test_torch_decoder_batched import NEAR_TIES, SCHEDULES, _near_ties

WAIT_S = 60
LOGIT_ATOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_models():
    return [AddSubModel(device="cpu"), StringAddSubModel(),
            IdentityModel("simple_identity", "BYTES", device="cpu"),
            IdentityModel("identity_bf16", "BF16", device="cpu"),
            SequenceAccumulatorModel(), RepeatModel()]


def _jax_models():
    return [jax_simple.AddSubModel(), jax_simple.StringAddSubModel(),
            jax_simple.IdentityModel("simple_identity", "BYTES"),
            jax_simple.IdentityModel("identity_bf16", "BF16"),
            jax_simple.SequenceAccumulatorModel(), jax_simple.RepeatModel()]


def _port_server():
    return GrpcInferenceServer(ServerCore(_port_models(), device="cpu")).start()


def _jax_server():
    return JaxGrpcServer(JaxCore(_jax_models())).start()


@pytest.fixture(scope="module")
def servers():
    port, theirs = _port_server(), _jax_server()
    yield {"port": port, "jax": theirs}
    port.stop()
    theirs.stop()


MODS = {"port": port_grpc, "jax": jax_grpc}


def _key(tag):
    return f"{tag}_{uuid.uuid4().hex[:12]}"


def _simple_inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return a, b, [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                  mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


def _error(fn):
    """(status, message) of the InferenceServerException ``fn`` raises."""
    with pytest.raises(Exception) as err:
        fn()
    assert type(err.value).__name__ == "InferenceServerException", err.value
    return err.value.status(), err.value.message()


class _Collector:
    def __init__(self):
        self.queue = queue.Queue()

    def __call__(self, result, error):
        self.queue.put((result, error))

    def get(self, timeout=WAIT_S):
        return self.queue.get(timeout=timeout)


def _event(item):
    """A stream callback's (result, error) as comparable plain values."""
    result, error = item
    if error is not None:
        return "error", type(error).__name__, error.status(), error.message()
    response = result.get_response()
    outputs = {o["name"]: result.as_numpy(o["name"]).tolist()
               for o in response.get("outputs", [])}
    return ("result", response.get("id", ""), response.get("model_name"), outputs,
            result.is_final_response(), result.is_null_response())


# -- the cases of tests/test_grpc_e2e.py, each returning comparable values -------


def case_health_and_metadata(mod, client, url):
    metadata = client.get_model_metadata("simple")
    metadata.pop("platform")  # "jax" / "pytorch" by design
    return [client.is_server_live(), client.is_server_ready(),
            client.is_model_ready("simple"), client.is_model_ready("nope"),
            client.is_model_ready("simple", "1"), client.is_model_ready("simple", "9"),
            metadata, _error(lambda: client.get_model_metadata("nope"))]


def case_model_config(mod, client, url):
    cfg = client.get_model_config("simple")["config"]
    assert cfg.pop("platform") in ("jax", "pytorch") and cfg.pop("backend") in ("jax", "pytorch")
    repeat = client.get_model_config("repeat_int32")["config"]
    return [cfg, repeat["model_transaction_policy"], repeat["input"],
            _error(lambda: client.get_model_config("nope"))]


def case_infer_binary(mod, client, url):
    _, _, inputs = _simple_inputs(mod)
    result = client.infer("simple", inputs, request_id="g1")
    return [result.as_numpy("OUTPUT0").tolist(), result.as_numpy("OUTPUT1").tolist(),
            result.get_response()["id"], result.get_response()["model_version"]]


def case_infer_typed_contents(mod, client, url):
    a, b, _ = _simple_inputs(mod)
    in0 = mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a, binary_data=False)
    in1 = mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b, binary_data=False)
    result = client.infer("simple", [in0, in1])
    return result.as_numpy("OUTPUT0").tolist()


def case_infer_bytes_model(mod, client, url):
    payload = np.array([[b"ab", b"\x00\xff"]], dtype=np.object_)
    inp = mod.InferInput("INPUT0", [1, 2], "BYTES").set_data_from_numpy(payload)
    out = client.infer("simple_identity", [inp]).as_numpy("OUTPUT0")
    strings = np.array([["1", "2"]], dtype=np.object_)
    ins = [mod.InferInput(n, [1, 2], "BYTES").set_data_from_numpy(strings, binary_data=False)
           for n in ("INPUT0", "INPUT1")]
    typed = client.infer("simple_identity", ins[:1]).as_numpy("OUTPUT0")
    return [out.dtype.str, out.tolist(), typed.tolist()]


def case_async_infer_callback_and_future(mod, client, url):
    _, _, inputs = _simple_inputs(mod)
    results = queue.Queue()
    client.async_infer("simple", inputs, callback=lambda r, e: results.put((r, e)),
                       request_id="cb")
    r, e = results.get(timeout=WAIT_S)
    assert e is None
    ctx = client.async_infer("simple", inputs)
    bad = queue.Queue()
    client.async_infer("nope", inputs, callback=lambda r, e: bad.put((r, e)))
    r_bad, e_bad = bad.get(timeout=WAIT_S)
    return [r.as_numpy("OUTPUT0").tolist(), r.get_response()["id"],
            ctx.get_result(timeout=WAIT_S).as_numpy("OUTPUT1").tolist(),
            r_bad, e_bad.status(), e_bad.message(),
            _error(lambda: client.async_infer("nope", inputs).get_result(timeout=WAIT_S))]


def case_error_unknown_model(mod, client, url):
    _, _, inputs = _simple_inputs(mod)
    wrong = [mod.InferInput("INPUT0", [1, 4], "INT32").set_data_from_numpy(
        np.zeros((1, 4), np.int32))]
    return [_error(lambda: client.infer("missing_model", inputs)),
            _error(lambda: client.infer("simple", inputs, model_version="7")),
            _error(lambda: client.infer("simple", wrong)),
            _error(lambda: client.infer("repeat_int32", wrong))]


def case_classification(mod, client, url):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    z = np.zeros((1, 16), dtype=np.int32)
    ins = [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
           mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(z)]
    outputs = [mod.InferRequestedOutput("OUTPUT0", class_count=2),
               mod.InferRequestedOutput("OUTPUT1", class_count=3)]
    result = client.infer("simple", ins, outputs=outputs)
    return [result.as_numpy("OUTPUT0").tolist(), result.as_numpy("OUTPUT1").tolist()]


def case_system_shm(mod, client, url):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    # a fixed region name (it appears in error messages); a fresh key
    name, key = "gshm", "/" + _key("grpc_shm_io")
    region = shm.create_shared_memory_region(name, key, 256)
    try:
        shm.set_shared_memory_region(region, [a, b])
        client.register_system_shared_memory(name, key, 256)
        status = client.get_system_shared_memory_status()
        dup = _error(lambda: client.register_system_shared_memory(name, key, 256))
        in0 = mod.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(name, 64)
        in1 = mod.InferInput("INPUT1", [1, 16], "INT32").set_shared_memory(name, 64, offset=64)
        out0 = mod.InferRequestedOutput("OUTPUT0")
        out0.set_shared_memory(name, 64, offset=128)
        result = client.infer("simple", [in0, in1], outputs=[out0])
        got = shm.get_contents_as_numpy(region, np.int32, [1, 16], offset=128).tolist()
        out_params = result.get_output("OUTPUT0")["parameters"]
        small = mod.InferRequestedOutput("OUTPUT0")
        small.set_shared_memory(name, 16, offset=128)
        too_small = _error(lambda: client.infer("simple", [in0, in1], outputs=[small]))
        missing = mod.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory("nowhere", 64)
        no_region = _error(lambda: client.infer("simple", [missing, in1]))
        client.unregister_system_shared_memory()
        after = client.get_system_shared_memory_status()
    finally:
        shm.destroy_shared_memory_region(region)
    return [[(s["name"] == name, s["key"] == key, s.get("offset", 0), s["byte_size"])
             for s in status],
            dup, result.as_numpy("OUTPUT0"), got, out_params, too_small, no_region, after]


def case_device_shm(mod, client, url):
    """test_tpu_shm_over_grpc with a cuda region: the port's region (CPU
    device, host window mirrored) registered through the cuda rpcs."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    name = "gcuda"
    region = cudashm.create_shared_memory_region(name, 256, device="cpu")
    try:
        cudashm.set_shared_memory_region(region, [a, b])
        client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, 256)
        status = client.get_cuda_shared_memory_status()
        in0 = mod.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(name, 64)
        in1 = mod.InferInput("INPUT1", [1, 16], "INT32").set_shared_memory(name, 64, offset=64)
        out0 = mod.InferRequestedOutput("OUTPUT0")
        out0.set_shared_memory(name, 64, offset=128)
        result = client.infer("simple", [in0, in1], outputs=[out0])
        got = cudashm.get_contents_as_numpy(region, "INT32", [1, 16], offset=128).tolist()
        client.unregister_cuda_shared_memory(name)
        after = client.get_cuda_shared_memory_status()
    finally:
        cudashm.destroy_shared_memory_region(region)
    return [[(s["name"] == name, s["byte_size"]) for s in status], result.as_numpy("OUTPUT0"), got,
            after]


def case_bf16_identity(mod, client, url):
    data = np.array([[0.5, -1.5, 2.0, -4.0]], dtype=ml_dtypes.bfloat16)
    inp = mod.InferInput("INPUT0", [1, 4], "BF16").set_data_from_numpy(data)
    out = client.infer("identity_bf16", [inp]).as_numpy("OUTPUT0")
    return [out.dtype.str, out.view(np.uint16).tolist()]


def case_async_infer_cancellation(mod, client, url):
    _, _, inputs = _simple_inputs(mod)
    ctx = client.async_infer("simple", inputs)
    if not ctx.cancel():
        assert ctx.get_result(timeout=WAIT_S).as_numpy("OUTPUT0") is not None
    return "ok"


def case_stream_sequence(mod, client, url):
    collector = _Collector()
    client.start_stream(collector)
    try:
        for i, (start, end) in enumerate([(True, False), (False, False), (False, True)]):
            inp = mod.InferInput("INPUT", [1, 1], "INT32")
            inp.set_data_from_numpy(np.array([[i + 2]], dtype=np.int32))
            client.async_stream_infer("simple_sequence", [inp], sequence_id=1001,
                                      sequence_start=start, sequence_end=end,
                                      request_id=f"s{i}")
        return [_event(collector.get()) for _ in range(3)]
    finally:
        client.stop_stream()


def case_stream_decoupled_repeat(mod, client, url):
    collector = _Collector()
    client.start_stream(collector)
    try:
        values = np.array([4, 5, 6], dtype=np.int32)
        in0 = mod.InferInput("IN", [3], "INT32").set_data_from_numpy(values)
        client.async_stream_infer("repeat_int32", [in0], enable_empty_final_response=True,
                                  request_id="rep")
        events = []
        while True:
            events.append(_event(collector.get()))
            if events[-1][0] != "result" or events[-1][5]:
                break
        client.async_stream_infer("repeat_int32", [in0])  # no empty final
        events += [_event(collector.get()) for _ in range(3)]
        return events
    finally:
        client.stop_stream()


def case_stream_error_in_band(mod, client, url):
    collector = _Collector()
    client.start_stream(collector)
    try:
        inp = mod.InferInput("INPUT", [1, 1], "INT32")
        inp.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        client.async_stream_infer("simple_sequence", [inp], request_id="bad")
        client.async_stream_infer("nope", [inp])
        events = [collector.get() for _ in range(2)]
        ids = [getattr(e, "request_id", None) for _, e in events]
        return [_event(e) for e in events] + [ids, client._stream.is_active()]
    finally:
        client.stop_stream()


def case_stream_restart_after_stop(mod, client, url):
    collector = _Collector()
    client.start_stream(collector)
    client.stop_stream()
    client.start_stream(collector)
    try:
        _, _, inputs = _simple_inputs(mod)
        client.async_stream_infer("simple", inputs)
        return _event(collector.get())
    finally:
        client.stop_stream()


def case_double_start_stream_rejected(mod, client, url):
    collector = _Collector()
    client.start_stream(collector)
    try:
        err = _error(lambda: client.start_stream(collector))
    finally:
        client.stop_stream()
    return [err, _error(lambda: client.async_stream_infer("simple", []))]


def case_stream_triton_grpc_error_mode(mod, client, url):
    with mod.InferenceServerClient(url) as c:
        collector = _Collector()
        c.start_stream(collector, headers={"triton_grpc_error": "true"})
        inp = mod.InferInput("INPUT", [1, 1], "INT32")
        inp.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        c.async_stream_infer("simple_sequence", [inp])
        first = _event(collector.get())
        active = c._stream.is_active()
        rejected = _error(lambda: c.async_stream_infer("simple_sequence", [inp]))
        c.stop_stream()
        collector2 = _Collector()
        c.start_stream(collector2)
        try:
            _, _, inputs = _simple_inputs(mod)
            c.async_stream_infer("simple", inputs)
            second = _event(collector2.get())
        finally:
            c.stop_stream()
    return [first, active, rejected, second]


def case_stream_cancel_delivers_cancelled_status(mod, client, url):
    with mod.InferenceServerClient(url) as c:
        collector = _Collector()
        c.start_stream(collector)
        c.stop_stream(cancel_requests=True)
        result, error = collector.get()
    return [result, error.status()]


MATRIX_CASES = {name[len("case_"):]: fn for name, fn in globals().items()
                if name.startswith("case_")}


def _run(case, client_kind, server):
    mod = MODS[client_kind]
    with mod.InferenceServerClient(server.url) as client:
        return MATRIX_CASES[case](mod, client, server.url)


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_grpc_matrix(servers, client, server, case):
    """Every client against every server gives what the JAX client gets from
    the JAX server: outputs, ids, error messages and status codes."""
    got = _run(case, client, servers[server])
    want = _run(case, "jax", servers["jax"])
    assert _plain(got) == _plain(want)


def _plain(value):
    """Arrays as (dtype, shape, values) so results compare with ==."""
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tolist())
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def test_expected_values_hold(servers):
    """The matrix compares with the JAX pair; the values themselves."""
    with port_grpc.InferenceServerClient(servers["port"].url) as c:
        got = case_stream_sequence(port_grpc, c, servers["port"].url)
        assert [e[3]["OUTPUT"] for e in got] == [[[2]], [[5]], [[9]]]
        assert [e[1] for e in got] == ["s0", "s1", "s2"]
        rep = case_stream_decoupled_repeat(port_grpc, c, servers["port"].url)
        assert [e[3].get("OUT") for e in rep[:4]] == [[4], [5], [6], None]
        assert rep[3][4] and rep[3][5]  # the empty final response
        errors = case_stream_error_in_band(port_grpc, c, servers["port"].url)
        assert "sequence_id" in errors[0][3] and errors[2] == ["bad", None]
        assert errors[3] is True  # the stream survived
        top = case_classification(port_grpc, c, servers["port"].url)[0]
        assert [int(s.split(b":")[1]) for s in top] == [15, 14]
        mode = case_stream_triton_grpc_error_mode(port_grpc, c, servers["port"].url)
        assert mode[0][2] == "StatusCode.INVALID_ARGUMENT" and mode[1] is False
        assert "no longer in a valid" in mode[2][1]
        cancelled = case_stream_cancel_delivers_cancelled_status(
            port_grpc, c, servers["port"].url)
        assert cancelled == [None, "StatusCode.CANCELLED"]
        status, message = case_error_unknown_model(port_grpc, c, servers["port"].url)[0]
        assert status == "StatusCode.INVALID_ARGUMENT" and "unknown model" in message


# -- the port server's own contracts ----------------------------------------------


def test_server_metadata_names_the_port_surface(servers):
    with port_grpc.InferenceServerClient(servers["port"].url) as c:
        md = c.get_server_metadata()
    assert md["name"] == "client_tpu_torch_server"
    assert "tpu_shared_memory" not in md["extensions"]
    for ext in ("cuda_shared_memory", "statistics", "model_repository", "trace", "logging"):
        assert ext in md["extensions"]


@pytest.mark.parametrize("method", ["TpuSharedMemoryStatus", "TpuSharedMemoryRegister",
                                    "TpuSharedMemoryUnregister"])
def test_tpu_rpcs_are_unimplemented(servers, method):
    with jax_grpc.InferenceServerClient(servers["port"].url) as c:
        call = {"TpuSharedMemoryStatus": c.get_tpu_shared_memory_status,
                "TpuSharedMemoryRegister": lambda: c.register_tpu_shared_memory(
                    "t", "eyJzaG1fa2V5IjogImsifQ==", 0, 8),
                "TpuSharedMemoryUnregister": c.unregister_tpu_shared_memory}[method]
        status, _ = _error(call)
    assert status == "StatusCode.UNIMPLEMENTED"


def test_auto_reconnect_needs_a_policy(servers):
    for mod in (port_grpc, jax_grpc):
        with mod.InferenceServerClient(servers["port"].url) as c:
            assert _error(lambda: c.start_stream(lambda r, e: None, auto_reconnect=True)) == (
                None, "auto_reconnect requires a resilience policy with a RetryPolicy")
            assert c._stream is None


@pytest.mark.parametrize("client", ["port", "jax"])
def test_statistics_count_the_requests(client):
    """A fresh server of each package: the same statistics (timings aside)
    after the same requests, and success counts equal to what was sent."""
    mod = MODS[client]
    rows = []
    for server in (_port_server(), _jax_server()):
        try:
            with mod.InferenceServerClient(server.url) as c:
                _, _, inputs = _simple_inputs(mod)
                for _ in range(3):
                    c.infer("simple", inputs)
                bad = [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(
                    np.zeros((1, 16), np.int32))]
                _error(lambda: c.infer("simple", bad))
                collector = _Collector()
                c.start_stream(collector)
                c.async_stream_infer("repeat_int32", [mod.InferInput(
                    "IN", [2], "INT32").set_data_from_numpy(np.array([1, 2], np.int32))])
                [collector.get() for _ in range(2)]
                c.stop_stream()
                stats = c.get_inference_statistics()
                one = c.get_inference_statistics("simple", "1")
                missing = _error(lambda: c.get_inference_statistics("nope"))
        finally:
            server.stop()
        rows.append((_untimed(stats), _untimed(one), missing))
    assert rows[0] == rows[1]
    simple = rows[0][1]["model_stats"][0]
    assert simple["inference_count"] == simple["execution_count"] == 3
    assert simple["inference_stats"]["success"]["count"] == 3
    assert simple["inference_stats"]["fail"]["count"] == 1
    repeat = [r for r in rows[0][0]["model_stats"] if r["name"] == "repeat_int32"][0]
    assert repeat["inference_stats"]["success"]["count"] == 1


def _untimed(stats):
    """Statistics with the timing fields (``ns``, ``last_inference``) set to
    0 or 1 by whether they were nonzero."""
    if isinstance(stats, dict):
        return {k: (int(bool(v)) if k in ("ns", "last_inference") else _untimed(v))
                for k, v in stats.items()}
    if isinstance(stats, list):
        return [_untimed(v) for v in stats]
    return stats


@pytest.mark.parametrize("client", ["port", "jax"])
def test_settings_and_repository_control(client):
    """A fresh server of each package: trace and log settings, the repository
    index, unload and load (with a config override) answer alike."""
    mod = MODS[client]
    rows = []
    for server in (_port_server(), _jax_server()):
        try:
            with mod.InferenceServerClient(server.url) as c:
                row = [c.get_trace_settings(),
                       c.update_trace_settings(settings={"trace_level": ["TIMESTAMPS"],
                                                         "trace_rate": 2}),
                       c.update_trace_settings(model_name="simple",
                                               settings={"trace_level": ["OFF"]}),
                       c.get_trace_settings(model_name="simple"),
                       c.get_log_settings(),
                       c.update_log_settings({"log_verbose_level": 3, "log_info": False,
                                              "log_format": "ISO8601"}),
                       c.get_model_repository_index()]
                c.unload_model("simple_string")
                row.append(c.is_model_ready("simple_string"))
                row.append(c.get_model_repository_index())
                _, _, inputs = _simple_inputs(mod)
                row.append(_error(lambda: c.infer("simple_string", inputs)))
                c.load_model("simple_string")
                row.append(c.is_model_ready("simple_string"))
                c.load_model("simple", config='{"max_batch_size": 4}')
                row.append(c.get_model_config("simple")["config"].get("max_batch_size", 0))
                c.load_model("simple")
                row.append(c.get_model_config("simple")["config"].get("max_batch_size", 0))
                row += [_error(lambda: c.load_model("simple", config='{"name": "x"}')),
                        _error(lambda: c.load_model("simple", config="[1]")),
                        _error(lambda: c.load_model("nope")),
                        _error(lambda: c.unload_model("nope"))]
        finally:
            server.stop()
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0][7] is False and rows[0][10] is True
    assert rows[0][11] == 4 and rows[0][12] == 0


def test_serves_a_core_left_at_its_default_device():
    """``GrpcInferenceServer(ServerCore(default_model_zoo("cpu")))``: the
    core's device stays at its default, and the models' CPU tensors serve."""
    from client_tpu_torch.models import default_model_zoo

    with GrpcInferenceServer(ServerCore(default_model_zoo("cpu"))) as server:
        with port_grpc.InferenceServerClient(server.url) as c:
            a, b, inputs = _simple_inputs(port_grpc)
            assert c.infer("simple", inputs).as_numpy("OUTPUT0").tolist() == (a + b).tolist()


def test_killed_server_ends_the_stream():
    """Server death mid-stream: the callback gets a true grpc status, the
    stream is inactive, and a new stream against a new server works."""
    server = _port_server()
    client = port_grpc.InferenceServerClient(server.url)
    collector = _Collector()
    client.start_stream(collector)
    a, b, inputs = _simple_inputs(port_grpc)
    client.async_stream_infer("simple", inputs)
    assert collector.get()[1] is None
    server.stop(grace=0)
    result, error = collector.get()
    assert result is None
    assert error.status() in ("StatusCode.UNAVAILABLE", "StatusCode.CANCELLED"), error.status()
    assert not client._stream.is_active()
    with pytest.raises(InferenceServerException, match="no longer in a valid"):
        client.async_stream_infer("simple", inputs)
    client.stop_stream()
    client.close()
    fresh = _port_server()
    try:
        with port_grpc.InferenceServerClient(fresh.url) as c2:
            collector2 = _Collector()
            c2.start_stream(collector2)
            c2.async_stream_infer("simple", inputs)
            result, error = collector2.get()
            c2.stop_stream()
        assert error is None and result.as_numpy("OUTPUT0").tolist() == (a + b).tolist()
    finally:
        fresh.stop()


def test_cuda_shm_hands_the_tensor_through():
    """In one process the port server's cuda branch hands the client's own
    tensor to the model and back (here on the CPU device)."""
    server = _port_server()
    name_in, name_out = _key("cin"), _key("cout")
    x = torch.arange(16, dtype=torch.int32).reshape(1, 16)
    region_in = cudashm.create_shared_memory_region(name_in, 128, device="cpu", colocated=True)
    region_out = cudashm.create_shared_memory_region(name_out, 64, device="cpu",
                                                     colocated=True)
    try:
        with port_grpc.InferenceServerClient(server.url) as c:
            cudashm.set_shared_memory_region_from_torch(region_in, x)
            cudashm.set_shared_memory_region_from_torch(region_in, x * 2, offset=64)
            for name, region, size in ((name_in, region_in, 128), (name_out, region_out, 64)):
                c.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, size)
            ins = [port_grpc.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(
                       name_in, 64),
                   port_grpc.InferInput("INPUT1", [1, 16], "INT32").set_shared_memory(
                       name_in, 64, offset=64)]
            out = port_grpc.InferRequestedOutput("OUTPUT0").set_shared_memory(name_out, 64)
            c.infer("simple", ins, outputs=[out])
            y = cudashm.get_contents_as_torch(region_out, "INT32", [1, 16])
            assert torch.equal(y, x * 3)
            # colocated regions are never mirrored to the host
            assert not np.frombuffer(region_out.host_buffer(), np.uint8).any()
            c.unregister_cuda_shared_memory()
    finally:
        cudashm.destroy_shared_memory_region(region_in)
        cudashm.destroy_shared_memory_region(region_out)
        server.stop()


# -- the decoder family over GRPC streams ------------------------------------------


@pytest.fixture(scope="module")
def jax_params_np():
    model = JaxDecoder(seed=0)
    model._ensure_built()
    return jax.tree.map(np.asarray, model._params)


@pytest.fixture(scope="module")
def decoder_servers(jax_params_np):
    """Port GRPC and HTTP servers over one core holding decoder_lm and
    decoder_lm_batched with the JAX weights; a JAX GRPC server with JAX's
    decoder_lm."""
    params = load_jax_params(jax_params_np, "cpu")
    batched = BatchedDecoderModel(device="cpu", params=params, slots=8, max_delay_s=0.05)
    core = ServerCore([TinyDecoderModel(device="cpu", params=params), batched], device="cpu")
    port = GrpcInferenceServer(core, max_workers=16).start()
    http = HttpInferenceServer(core).start()
    theirs = JaxGrpcServer(JaxCore([JaxDecoder(seed=0)])).start()
    yield {"port": port, "http": http, "jax": theirs, "batched": batched}
    port.stop()
    http.stop()
    theirs.stop()
    batched.unload()


# the prompts and request counts of the "full_house" schedule, whose near
# ties (NEAR_TIES) the two packages' decoders share
FULL_HOUSE = {seq: prompt for seq, prompt, _ in SCHEDULES["full_house"][0]}
STEPS = len(SCHEDULES["full_house"])


def _stream_decode(mod, url, model, seq_base, prompts, feed=None):
    """Each prompt's sequence over one bidi stream, in the
    grpc_decoder_stream_client.py way: the prompt, then each greedy token
    fed back (``feed``: another run's rows, whose greedy tokens are sent
    instead). Returns, per sequence, (tokens sent, logits, greedy) rows."""
    out = {}
    with mod.InferenceServerClient(url) as client:
        collector = _Collector()
        client.start_stream(collector)
        try:
            for seq, prompt in prompts.items():
                rows, tokens = [], list(prompt)
                for i in range(STEPS):
                    inp = mod.InferInput("TOKENS", [1, len(tokens)], "INT32")
                    inp.set_data_from_numpy(np.array([tokens], np.int32))
                    client.async_stream_infer(model, [inp], sequence_id=seq_base + seq,
                                              sequence_start=i == 0,
                                              sequence_end=i == STEPS - 1)
                    result, error = collector.get()
                    assert error is None, error
                    logits = result.as_numpy("LOGITS").astype(np.float32).reshape(-1)
                    greedy = int(result.as_numpy("NEXT_TOKEN")[0, 0])
                    rows.append((tokens, logits, greedy))
                    tokens = [feed[seq][i][2] if feed is not None else greedy]
                out[seq] = rows
        finally:
            client.stop_stream()
    return out


def test_decoder_lm_over_a_grpc_stream(decoder_servers):
    """decoder_lm over one bidi stream: JAX's greedy tokens but at the two
    known near ties, logits within 5e-2; with the port's own continuations,
    the port's GRPC and HTTP paths give the same tokens and logits bit for
    bit, whichever client drives them."""
    theirs = _stream_decode(jax_grpc, decoder_servers["jax"].url, "decoder_lm", 0, FULL_HOUSE)
    ours = _stream_decode(port_grpc, decoder_servers["port"].url, "decoder_lm", 100,
                          FULL_HOUSE, feed=theirs)
    ties = _near_ties(ours, theirs)
    assert {(seq, i) for seq, i, _, _ in ties} == NEAR_TIES["full_house"], ties
    for seq in theirs:
        for mine, other in zip(ours[seq], theirs[seq]):
            np.testing.assert_allclose(mine[1], other[1], atol=LOGIT_ATOL, rtol=0)
    port_own = _stream_decode(port_grpc, decoder_servers["port"].url, "decoder_lm", 200,
                              FULL_HOUSE)
    jax_client = _stream_decode(jax_grpc, decoder_servers["port"].url, "decoder_lm", 300,
                                FULL_HOUSE)
    over_http = _http_decode(decoder_servers["http"].url, "decoder_lm", 400, FULL_HOUSE)
    for seq in FULL_HOUSE:
        for runs in (jax_client, over_http):
            assert [r[2] for r in runs[seq]] == [r[2] for r in port_own[seq]]
            assert all(a[1].tobytes() == b[1].tobytes()
                       for a, b in zip(runs[seq], port_own[seq]))


def _http_decode(url, model, seq_base, prompts):
    out = {}
    with port_http.InferenceServerClient(url) as client:
        for seq, prompt in prompts.items():
            rows, tokens = [], list(prompt)
            for i in range(STEPS):
                inp = port_http.InferInput("TOKENS", [1, len(tokens)], "INT32")
                inp.set_data_from_numpy(np.array([tokens], np.int32))
                r = client.infer(model, [inp], sequence_id=seq_base + seq,
                                 sequence_start=i == 0, sequence_end=i == STEPS - 1)
                greedy = int(r.as_numpy("NEXT_TOKEN")[0, 0])
                rows.append((tokens, r.as_numpy("LOGITS").astype(np.float32).reshape(-1),
                             greedy))
                tokens = [greedy]
            out[seq] = rows
    return out


def _gate_first_window(model, size):
    """Hold the batched worker before its next window until ``size``
    requests are queued."""
    real = model._collect
    gate = threading.Event()

    def gated():
        deadline = threading.Event()
        for _ in range(WAIT_S * 1000):
            if model._queue.qsize() >= size:
                break
            deadline.wait(0.001)
        model._collect = real
        gate.set()
        return real()

    model._collect = gated
    return gate


def test_decoder_lm_batched_over_concurrent_grpc_streams(decoder_servers):
    """decoder_lm_batched with the 8 full_house sequences, each on a stream
    and client of its own, the first window holding all 8 starts: every
    sequence's tokens equal decoder_lm's over GRPC and the port's HTTP path,
    and JAX's but at the near ties; a round of width 8 ran."""
    batched = decoder_servers["batched"]
    before = dict(batched.batch_histogram)
    gate = _gate_first_window(batched, len(FULL_HOUSE))
    results, errors = {}, []

    def run(seq, prompt):
        try:
            results[seq] = _stream_decode(port_grpc, decoder_servers["port"].url,
                                          "decoder_lm_batched", 500, {seq: prompt})[seq]
        except Exception as e:  # surfaced below
            errors.append((seq, repr(e)))

    threads = [threading.Thread(target=run, args=item) for item in FULL_HOUSE.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 2)
    assert gate.is_set() and not errors and not any(t.is_alive() for t in threads), errors
    unbatched = _stream_decode(port_grpc, decoder_servers["port"].url, "decoder_lm", 600,
                               FULL_HOUSE)
    over_http = _http_decode(decoder_servers["http"].url, "decoder_lm_batched", 700,
                             FULL_HOUSE)
    theirs = _stream_decode(jax_grpc, decoder_servers["jax"].url, "decoder_lm", 800,
                            FULL_HOUSE)
    for seq in FULL_HOUSE:
        assert [r[2] for r in results[seq]] == [r[2] for r in unbatched[seq]], seq
        assert [r[2] for r in over_http[seq]] == [r[2] for r in results[seq]], seq
        for a, b in zip(results[seq], unbatched[seq]):
            np.testing.assert_allclose(a[1], b[1], atol=1e-5, rtol=0)
    fed = _stream_decode(port_grpc, decoder_servers["port"].url, "decoder_lm_batched", 900,
                         FULL_HOUSE, feed=theirs)
    ties = _near_ties(fed, theirs)
    assert {(seq, i) for seq, i, _, _ in ties} == NEAR_TIES["full_house"], ties
    widths = {w: n - before.get(w, 0) for w, n in batched.batch_histogram.items()}
    assert widths.get(8, 0) >= 1, batched.batch_histogram
    assert batched.live_sequences() == 0
