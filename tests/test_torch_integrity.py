"""The port's response-integrity layer against the JAX package's.

- crafted HTTP bodies and GRPC response messages (honest, and each lie the
  contract layer knows: names, dtypes, shapes, payload sizes, the binary
  tail, BYTES framing, the request id, torn and overrunning bodies) get the
  same verdict — ``kind``, ``field``, ``expected``, ``actual``, or the same
  check count when honest — from both packages' decoders and validators,
  with the same metadata primed, and leave the same ``IntegrityStats``;
- both packages' HTTP clients raise the same ``IntegrityError`` kinds
  against JAX's ``ByzantineHttpServer`` under the same seeded plans, unary
  and streamed;
- ``StreamChecker`` gives the same outcome over the same event sequences;
- data-plane digests came with the shm arena: ``digests=True`` is taken
  as in the JAX package (``tests/test_torch_arena.py`` holds the sealed
  output slabs of both packages' clients to the same verdicts).
"""

import copy
import json
import struct

import numpy as np
import pytest

import client_tpu.grpc as jax_grpc
import client_tpu.http as jax_http
import client_tpu.integrity as jax_integrity
import client_tpu.resilience as jax_res
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
import client_tpu_torch.integrity as port_integrity
import client_tpu_torch.resilience as port_res
from client_tpu.models import simple as jax_simple
from client_tpu.server import ServerCore as JaxCore
from client_tpu.testing import ByzantineHttpServer
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

CALL_S = 10.0

PKG = {
    "port": (port_http, port_grpc, port_integrity, port_res),
    "jax": (jax_http, jax_grpc, jax_integrity, jax_res),
}

METADATA = {
    "name": "simple",
    "outputs": [
        {"name": "OUTPUT0", "datatype": "INT32", "shape": [-1, 16]},
        {"name": "OUTPUT1", "datatype": "INT32", "shape": [-1, 16]},
        {"name": "TEXT", "datatype": "BYTES", "shape": [2]},
    ],
}


# -- crafted responses --------------------------------------------------------
def _bytes_elems(*items: bytes) -> bytes:
    return b"".join(struct.pack("<I", len(x)) + x for x in items)


_SUM = np.arange(16, dtype=np.int32).reshape(1, 16).tobytes()
_DIFF = (np.arange(16, dtype=np.int32) - 1).reshape(1, 16).tobytes()


def _out(name, datatype="INT32", shape=(1, 16), size=64, **extra):
    entry = {"name": name, "datatype": datatype, "shape": list(shape)}
    if size is not None:
        entry["parameters"] = {"binary_data_size": size}
    entry.update(extra)
    return entry


def _http(outputs, tail, rid="rq", header=None, header_length=True):
    head = header if header is not None else json.dumps(
        {"id": rid, "model_name": "simple", "outputs": outputs}).encode()
    return head + tail, (len(head) if header_length else None)


HTTP_CASES = {
    "honest": _http([_out("OUTPUT0"), _out("OUTPUT1")], _SUM + _DIFF),
    "honest_json": _http([_out("OUTPUT0", size=None, data=list(range(16))),
                          _out("OUTPUT1", size=None, data=[0] * 16)], b"",
                         header_length=False),
    "honest_bytes": _http([_out("TEXT", "BYTES", (2,), 16)], _bytes_elems(b"abc", b"defgh")),
    "wrong_name": _http([_out("OUTPUTX"), _out("OUTPUT1")], _SUM + _DIFF),
    "missing_output": _http([_out("OUTPUT0")], _SUM),
    "duplicate_name": _http([_out("OUTPUT0"), _out("OUTPUT0")], _SUM + _DIFF),
    "dtype_lie": _http([_out("OUTPUT0", "INT64"), _out("OUTPUT1")], _SUM + _DIFF),
    "dtype_lie_sized": _http([_out("OUTPUT0", "FP32"), _out("OUTPUT1")], _SUM + _DIFF),
    "shape_lie": _http([_out("OUTPUT0", shape=(1, 17)), _out("OUTPUT1")], _SUM + _DIFF),
    "rank_lie": _http([_out("OUTPUT0", shape=(16,)), _out("OUTPUT1")], _SUM + _DIFF),
    "negative_dim": _http([_out("OUTPUT0", shape=(1, -16)), _out("OUTPUT1")], _SUM + _DIFF),
    "payload_short": _http([_out("OUTPUT0", size=60), _out("OUTPUT1", size=68)], _SUM + _DIFF),
    "tail_extra": _http([_out("OUTPUT0"), _out("OUTPUT1")], _SUM + _DIFF + b"\0" * 8),
    "size_overrun": _http([_out("OUTPUT0"), _out("OUTPUT1", size=96)], _SUM + _DIFF),
    "size_negative": _http([_out("OUTPUT0", size=-1), _out("OUTPUT1")], _SUM + _DIFF),
    "size_bool": _http([_out("OUTPUT0", size=True), _out("OUTPUT1")], _SUM + _DIFF),
    "unnamed_binary": _http([{"datatype": "INT32", "shape": [1, 16],
                              "parameters": {"binary_data_size": 64}}], _SUM),
    "bytes_framing": _http([_out("TEXT", "BYTES", (2,), 16)],
                           struct.pack("<I", 3) + b"abc" + struct.pack("<I", 9) + b"defgh"),
    "bytes_count": _http([_out("TEXT", "BYTES", (3,), 16)], _bytes_elems(b"abc", b"defgh")),
    "wrong_id": _http([_out("OUTPUT0"), _out("OUTPUT1")], _SUM + _DIFF, rid="other"),
    "unknown_dtype": _http([_out("OUTPUT0", "FOO"), _out("OUTPUT1")], _SUM + _DIFF),
    "torn_json": (b'{"id": "rq", "outputs": [' + _SUM, 30),
    "non_utf8": (b"\xff\xfe{}" + _SUM, 4),
    "json_list": (b"[1, 2]", None),
    "output_not_object": (json.dumps({"outputs": [1]}).encode(), None),
    "header_overrun": (b"{}", 10),
}


def _verdict(exc_or_none, checks=None):
    if exc_or_none is None:
        return ("ok", checks)
    e = exc_or_none
    return (type(e).__name__, e.kind, e.field, repr(e.expected), repr(e.actual), e.status())


def _check_http(pkg, case):
    http, _, integrity, _ = PKG[pkg]
    body, header_length = HTTP_CASES[case]
    policy = integrity.IntegrityPolicy(stats=integrity.IntegrityStats())
    policy.note_metadata("simple", METADATA)
    requested = [http.InferRequestedOutput(n) for n in ("OUTPUT0", "OUTPUT1")] \
        if case not in ("honest_bytes", "bytes_framing", "bytes_count") else None
    try:
        result = http.InferResult.from_response_body(body, header_length)
        checks = integrity.validate_result(
            result, None, requested, "rq", url="h:1", model_name="simple", policy=policy)
        decoded = {}
        for out in result.get_response().get("outputs", []):
            arr = result.as_numpy(out["name"])
            decoded[out["name"]] = arr.tolist()
    except integrity.IntegrityError as e:
        return _verdict(e)
    return _verdict(None, checks) + (decoded,)


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_http_verdicts_equal(case):
    ours, theirs = _check_http("port", case), _check_http("jax", case)
    assert ours == theirs
    if case.startswith("honest"):
        assert ours[0] == "ok"
    else:
        assert ours[0] == "IntegrityError", ours


def _grpc_response(outputs, raw, rid="rq"):
    return {"id": rid, "model_name": "simple", "outputs": outputs,
            "raw_output_contents": raw}


def _gout(name, datatype="INT32", shape=(1, 16), **extra):
    entry = {"name": name, "datatype": datatype, "shape": list(shape)}
    entry.update(extra)
    return entry


GRPC_CASES = {
    "honest": _grpc_response([_gout("OUTPUT0"), _gout("OUTPUT1")], [_SUM, _DIFF]),
    "honest_contents": _grpc_response(
        [_gout("OUTPUT0", contents={"int_contents": list(range(16))}),
         _gout("OUTPUT1")], [_DIFF]),
    "honest_shm": _grpc_response(
        [_gout("OUTPUT0", parameters={"shared_memory_region": {"string_param": "r"}}),
         _gout("OUTPUT1")], [_DIFF]),
    "raw_count": _grpc_response([_gout("OUTPUT0"), _gout("OUTPUT1")], [_SUM]),
    "raw_short": _grpc_response([_gout("OUTPUT0"), _gout("OUTPUT1")], [_SUM[:60], _DIFF]),
    "wrong_name": _grpc_response([_gout("OUTPUTX"), _gout("OUTPUT1")], [_SUM, _DIFF]),
    "dtype_lie": _grpc_response([_gout("OUTPUT0", "INT16"), _gout("OUTPUT1")], [_SUM, _DIFF]),
    "shape_lie": _grpc_response([_gout("OUTPUT0", shape=(2, 16)), _gout("OUTPUT1")],
                                [_SUM, _DIFF]),
    "wrong_id": _grpc_response([_gout("OUTPUT0"), _gout("OUTPUT1")], [_SUM, _DIFF], "x"),
    "bytes_framing": _grpc_response(
        [_gout("OUTPUT0"), _gout("OUTPUT1"), _gout("TEXT", "BYTES", (2,))],
        [_SUM, _DIFF, struct.pack("<I", 40) + b"abc"]),
}


def _check_grpc(pkg, case):
    _, grpc_mod, integrity, _ = PKG[pkg]
    policy = integrity.IntegrityPolicy(stats=integrity.IntegrityStats())
    policy.note_metadata("simple", METADATA)
    result = grpc_mod.InferResult(copy.deepcopy(GRPC_CASES[case]))
    requested = None
    if case != "bytes_framing":
        requested = [grpc_mod.InferRequestedOutput(n) for n in ("OUTPUT0", "OUTPUT1")]
    try:
        checks = integrity.validate_result(
            result, None, requested, "rq", url="g:1", model_name="simple", policy=policy)
    except integrity.IntegrityError as e:
        return _verdict(e)
    return _verdict(None, checks)


@pytest.mark.parametrize("case", sorted(GRPC_CASES))
def test_grpc_verdicts_equal(case):
    ours, theirs = _check_grpc("port", case), _check_grpc("jax", case)
    assert ours == theirs
    assert (ours[0] == "ok") == case.startswith("honest"), ours


def _stats_after(pkg):
    """check_result and note_parse_violation over every crafted HTTP body
    on one fresh policy: the accounting they leave."""
    http, _, integrity, _ = PKG[pkg]
    stats = integrity.IntegrityStats()
    policy = integrity.IntegrityPolicy(stats=stats)
    policy.note_metadata("simple", METADATA)
    for case in sorted(HTTP_CASES):
        body, header_length = HTTP_CASES[case]
        try:
            result = http.InferResult.from_response_body(body, header_length)
        except integrity.IntegrityError as e:
            integrity.note_parse_violation(e, url="h:1", policy=policy)
            continue
        try:
            integrity.check_result(result, None, None, "rq", url="h:1",
                                   model_name="simple", policy=policy)
        except integrity.IntegrityError:
            pass
    snap = stats.snapshot()
    return {k: v for k, v in snap.items() if "overhead" not in k}


def test_stats_equal_after_the_same_responses():
    ours, theirs = _stats_after("port"), _stats_after("jax")
    assert ours == theirs
    assert ours["violations"] > 10


def test_violation_classifies_invalid():
    for _, _, integrity, res in PKG.values():
        err = integrity.IntegrityError("shape", "u", "OUTPUT0", [1, 16], [1, 17])
        assert res.classify_fault(err) == res.INVALID
        assert err.status() == integrity.INTEGRITY_VIOLATION_STATUS


def test_digests_wait_for_the_arena():
    """The arena has come: ``digests=True`` is taken as JAX's policy takes
    it, and the default stays off in both packages."""
    for _, _, integrity, _ in PKG.values():
        assert integrity.IntegrityPolicy(digests=True).digests is True
        assert integrity.IntegrityPolicy().digests is False


# -- stream index checks --------------------------------------------------------
STREAMS = {
    "monotone": [{"INDEX": [i]} for i in range(4)] + [{"no_index": 1}],
    "duplicate": [{"INDEX": [0]}, {"INDEX": [1]}, {"INDEX": [1]}],
    "gap": [{"index": 0}, {"index": 2}],
    "regression": [{"sequence_index": "5"}, {"sequence_index": "6"}, {"sequence_index": 4}],
    "late_base": [{"x": 1}, {"INDEX": [7]}, {"INDEX": [8]}],
    "bad_value": [{"INDEX": ["zz"]}, {"INDEX": [0]}],
}


def _run_stream(integrity, events):
    checker = integrity.StreamChecker("s:1", integrity.IntegrityPolicy(
        stats=integrity.IntegrityStats()))
    seen = []
    for event in events:
        try:
            checker.observe(event)
            seen.append(("ok", integrity.event_index(event)))
        except integrity.IntegrityError as e:
            seen.append(_verdict(e))
            break
    return seen, checker.events


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_checker_equal(name):
    assert _run_stream(port_integrity, STREAMS[name]) == \
        _run_stream(jax_integrity, STREAMS[name])


# -- both clients against the JAX byzantine server ------------------------------
def _simple_inputs(http):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    return [http.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
            http.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]


def _byzantine_unary(pkg, kind):
    http, _, integrity, res = PKG[pkg]
    server = ByzantineHttpServer(JaxCore([jax_simple.AddSubModel()]), kinds=(kind,), seed=7)
    server.start()
    try:
        policy = integrity.IntegrityPolicy(stats=integrity.IntegrityStats())
        with http.InferenceServerClient(server.url) as client:
            client.configure_integrity(policy)
            try:
                client.infer("simple", _simple_inputs(http), request_id="rq-byz",
                             client_timeout=CALL_S)
                return ("delivered",)
            except integrity.IntegrityError as e:
                return (e.kind, e.field, res.classify_fault(e), bool(e.url),
                        policy.stats.snapshot()["violations"])
    finally:
        server.stop()


@pytest.mark.parametrize("kind", ["shape_lie", "dtype_lie", "truncate", "wrong_id",
                                  "garbage_json", "bit_flip"])
def test_byzantine_unary_kinds_equal(kind):
    ours, theirs = _byzantine_unary("port", kind), _byzantine_unary("jax", kind)
    assert ours == theirs
    if kind == "bit_flip":
        assert ours == ("delivered",)  # the contract layer's documented limit
    else:
        assert ours[2] == "invalid" and ours[4] == 1


def _byzantine_stream(pkg, kind):
    http, _, integrity, _ = PKG[pkg]
    server = ByzantineHttpServer(JaxCore([jax_simple.RepeatModel()]), kinds=(kind,),
                                 every=3, seed=7)
    server.start()
    try:
        with http.InferenceServerClient(server.url) as client:
            client.configure_integrity(integrity.IntegrityPolicy(
                contract=True, stream_index=True, stats=integrity.IntegrityStats()))
            seen = []
            try:
                for event in client.generate_stream("repeat_int32", {"IN": [1, 2, 3, 4, 5, 6]}):
                    seen.append(integrity.event_index(event))
            except integrity.IntegrityError as e:
                return seen, (e.kind, e.expected, e.actual)
            return seen, None
    finally:
        server.stop()


@pytest.mark.parametrize("kind", ["dup_index", "drop_index"])
def test_byzantine_stream_kinds_equal(kind):
    ours, theirs = _byzantine_stream("port", kind), _byzantine_stream("jax", kind)
    assert ours == theirs
    assert ours[1] is not None and ours[1][0] == "stream_index"
