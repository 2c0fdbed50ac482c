"""The port's ``decoder_lm_batched`` against the JAX package's and its own
``decoder_lm``.

Both packages get the same weights (``load_jax_params`` of the JAX decoder's
tree) and the same windows. Coalescing is driven deterministically: a window
is handed to ``_run_window`` directly, or, where the worker runs, the worker
is held at a gate until every request of the window is queued. Greedy tokens
must be identical; logits agree within 5e-2 with JAX (the bound of
tests/test_torch_decoder.py) and within 1e-5 with the port's unbatched
decoder. Every wait has a timeout and nothing asserts on wall-clock time.
"""

import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models import decoder_batched as jax_batched
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu_torch.models import decoder as port_decoder
from client_tpu_torch.models import decoder_batched as port_batched
from client_tpu_torch.models.decoder import TinyDecoderModel, load_jax_params
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.server.core import InferError

LOGIT_ATOL = 5e-2
SELF_ATOL = 1e-5
WAIT_S = 60
M = TinyDecoderModel.MAX_LEN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_params_np():
    model = JaxDecoder(seed=0)
    model._ensure_built()
    return jax.tree.map(np.asarray, model._params)


@pytest.fixture(scope="module")
def port_params(jax_params_np):
    return load_jax_params(jax_params_np, "cpu")


@pytest.fixture(scope="module")
def reference(port_params):
    """The port's unbatched decoder_lm with the same weights."""
    return TinyDecoderModel(device="cpu", params=port_params)


def _port(port_params, **kwargs):
    return port_batched.BatchedDecoderModel(device="cpu", params=port_params, **kwargs)


# -- windows handed to _run_window directly -----------------------------------

# a schedule is a list of windows; a window lists (seq_id, prompt or None, end):
# a prompt starts (or restarts) the sequence, None continues it with the
# sequence's last greedy token
SCHEDULES = {
    "together": [
        [(1, [1, 2, 3], False), (2, [9, 8, 7, 6], False), (3, [42], False)],
        *[[(1, None, i == 4), (2, None, i == 4), (3, None, i == 4)] for i in range(5)],
    ],
    "staggered": [
        [(1, [5, 6], False)],
        [(1, None, False), (2, [200, 3, 3, 3, 3, 3, 3], False)],
        [(1, None, False), (2, None, False), (3, [0], False)],
        [(2, None, True), (3, None, False)],
        [(1, None, False), (3, None, False), (4, [17, 18], False)],
        [(1, None, True), (3, None, True), (4, None, True)],
    ],
    "restart": [
        [(1, [1, 2, 3], False), (2, [4], False)],
        [(1, None, False), (2, None, False)],
        [(1, [7, 7], False), (2, None, False)],  # seq 1 restarts in place
        [(1, None, True), (2, None, True)],
    ],
    "full_house": [
        [(s, [s, s + 1, 250 - s][: 1 + s % 3], False) for s in range(1, 9)],
        *[[(s, None, i == 2) for s in range(1, 9)] for i in range(3)],
    ],
}


def _run_schedule(model, request_cls, schedule, feed=None):
    """Every window through ``model._run_window``; returns, per sequence, the
    list of (tokens sent, logits [VOCAB] fp32, greedy token) per request.
    ``feed``: another run's result, whose greedy tokens are sent as the
    continuations here (both runs then see the same inputs)."""
    model._ensure_built()
    last, out = {}, {}
    for window in schedule:
        reqs = []
        for seq, prompt, end in window:
            if feed is not None and prompt is None:
                last[seq] = feed[seq][len(out[seq]) - 1][2]
            tokens = list(prompt) if prompt is not None else [last[seq]]
            reqs.append((seq, tokens, request_cls(seq, list(tokens), prompt is not None, end)))
        model._run_window([r for _, _, r in reqs])
        for seq, tokens, req in reqs:
            logits = np.asarray(req.future.result(timeout=WAIT_S), np.float32).reshape(-1)
            last[seq] = int(logits.argmax())
            out.setdefault(seq, []).append((tokens, logits, last[seq]))
    return out


def _unbatched(reference, schedule, seq_base):
    """The same requests, sequence by sequence, through decoder_lm."""
    out = {}
    for window in schedule:
        for seq, prompt, end in window:
            out.setdefault(seq, []).append((prompt, end))
    results = {}
    for seq, reqs in out.items():
        toks, rows = None, []
        for prompt, end in reqs:
            tokens = prompt if prompt is not None else [toks]
            o = reference.execute({"TOKENS": np.array([tokens], np.int32)},
                                  {"sequence_id": seq_base + seq,
                                   "sequence_start": prompt is not None,
                                   "sequence_end": end})
            toks = int(o["NEXT_TOKEN"][0, 0])
            rows.append((tokens, o["LOGITS"].reshape(-1), toks))
        results[seq] = rows
    return results


def _margins(rows):
    top = np.sort(np.stack([r[1] for r in rows]), axis=-1)
    return (top[:, -1] - top[:, -2]).tolist()


def _near_ties(ours, theirs):
    """(seq, request, JAX's top-2 margin, the row's largest logit
    difference) where the greedy tokens differ. A difference is allowed only
    at a near tie: where JAX's margin between its pick and the port's is
    below twice the row's logit difference, which is then enough to swap
    the two."""
    ties = []
    for seq in theirs:
        for i, (mine, other) in enumerate(zip(ours[seq], theirs[seq])):
            if mine[2] == other[2]:
                continue
            margin = float(other[1][other[2]] - other[1][mine[2]])
            diff = float(np.abs(mine[1] - other[1]).max())
            assert margin < 2 * diff, (
                f"seq {seq} request {i}: greedy token {mine[2]} where JAX picks "
                f"{other[2]} by a margin of {margin}, beyond the logit difference {diff}")
            ties.append((seq, i, margin, diff))
    return ties


# (seq, request) where the two packages' greedy tokens differ, each a near
# tie: "full_house" seq 6 (prompt [6]) at a JAX margin of 0.0011 against a
# logit difference of 0.0073, seq 8 (prompt [8, 9, 242]) at 0.0034 against
# 0.0084; the unbatched decoders differ at the same requests
NEAR_TIES = {"full_house": {(6, 2), (8, 3)}}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_batched_matches_jax(jax_params_np, port_params, schedule):
    """The same windows through both packages' batched models; the port's
    continuations carry JAX's greedy tokens, so every request sees the same
    inputs in both. Greedy tokens are equal but at the near ties of
    ``NEAR_TIES`` (see ``_near_ties``), and logits agree within 5e-2."""
    slots = 8
    jax_model = jax_batched.BatchedDecoderModel(seed=0, slots=slots)
    port_model = _port(port_params, slots=slots)
    theirs = _run_schedule(jax_model, jax_batched._SeqRequest, SCHEDULES[schedule])
    ours = _run_schedule(port_model, port_batched._SeqRequest, SCHEDULES[schedule],
                         feed=theirs)
    assert ours.keys() == theirs.keys()
    for seq in theirs:
        assert [r[0] for r in ours[seq]] == [r[0] for r in theirs[seq]]  # same inputs
        np.testing.assert_allclose(np.stack([r[1] for r in ours[seq]]),
                                   np.stack([r[1] for r in theirs[seq]]),
                                   atol=LOGIT_ATOL, rtol=0)
    ties = _near_ties(ours, theirs)
    assert {(seq, i) for seq, i, _, _ in ties} == NEAR_TIES.get(schedule, set()), ties
    assert port_model.live_sequences() == jax_model.live_sequences() == 0
    assert port_model.batch_histogram == jax_model.batch_histogram
    jax_model.unload()
    port_model.unload()


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_batched_matches_the_unbatched_decoder(port_params, reference, schedule):
    model = _port(port_params, slots=8)
    ours = _run_schedule(model, port_batched._SeqRequest, SCHEDULES[schedule])
    alone = _unbatched(reference, SCHEDULES[schedule], seq_base=1000 * (
        1 + list(SCHEDULES).index(schedule)))
    for seq, rows in alone.items():
        assert [r[0] for r in ours[seq]] == [r[0] for r in rows]  # same tokens sent
        assert [r[2] for r in ours[seq]] == [r[2] for r in rows], seq
        np.testing.assert_allclose(np.stack([r[1] for r in ours[seq]]),
                                   np.stack([r[1] for r in rows]), atol=SELF_ATOL, rtol=0)
    model.unload()


# one sequence (id 1, prompt [3, 1, 4], 6 requests) beside different company
COMPANY = {
    "alone": {},
    "one_other": {2: ([9, 9], 0)},
    "three_others": {2: ([9, 9], 0), 3: ([1], 2), 4: ([100, 101, 102, 103], 1)},
    "seven_others": {s: ([s * 7 % 256] * (1 + s % 4), s % 3) for s in range(2, 9)},
}


@pytest.mark.parametrize("company", list(COMPANY))
def test_window_composition_does_not_change_tokens(port_params, company):
    """Which sequences share a round, and how many, changes nothing of a
    sequence's tokens or logits."""
    model = _port(port_params, slots=8)
    others = COMPANY[company]
    schedule = []
    for i in range(6):
        window = [(1, [3, 1, 4] if i == 0 else None, i == 5)]
        for seq, (prompt, joins) in others.items():
            if i == joins:
                window.append((seq, prompt, False))
            elif i > joins:
                window.append((seq, None, i == 5))
        schedule.append(window)
    got = _run_schedule(model, port_batched._SeqRequest, schedule)[1]
    alone = _run_schedule(_port(port_params, slots=8), port_batched._SeqRequest,
                          [[(1, [3, 1, 4] if i == 0 else None, i == 5)] for i in range(6)])[1]
    assert [r[2] for r in got] == [r[2] for r in alone]
    np.testing.assert_allclose(np.stack([r[1] for r in got]),
                               np.stack([r[1] for r in alone]), atol=SELF_ATOL, rtol=0)
    assert max(model.batch_histogram) == 1 + len(others)
    model.unload()


def test_full_slot_rides_along_untouched(port_params, reference):
    """A sequence that fills its cache to MAX_LEN stays live (no
    sequence_end) and rides along inactive at pos == MAX_LEN while another
    decodes: no error, the other's tokens are unchanged and the full slot's
    cache is not written."""
    model = _port(port_params, slots=2)
    full_prompt = [(7 * i) % 256 for i in range(M)]
    first = _run_schedule(model, port_batched._SeqRequest, [[(1, full_prompt, False)]])
    slot = model._slot_of[1]
    assert model._pos[slot] == M
    before = [kv[:, slot].clone() for kv in model._caches]
    schedule = [[(2, [5, 6, 7], False)], *[[(2, None, i == 3)] for i in range(4)]]
    got = _run_schedule(model, port_batched._SeqRequest, schedule)[2]
    for kv, old in zip(model._caches, before):
        assert torch.equal(kv[:, slot], old)
    alone = _unbatched(reference, schedule, seq_base=9000)[2]
    assert [r[2] for r in got] == [r[2] for r in alone]
    np.testing.assert_allclose(np.stack([r[1] for r in got]),
                               np.stack([r[1] for r in alone]), atol=SELF_ATOL, rtol=0)
    # the full sequence is still live; its next token overflows, which frees it
    assert model.live_sequences() == 1 and model._pos[slot] == M
    full_alone = _unbatched(reference, [[(1, full_prompt, True)]], seq_base=9100)[1]
    assert first[1][0][2] == full_alone[0][2]
    req = port_batched._SeqRequest(1, [first[1][0][2]], False, False)
    model._run_window([req])
    with pytest.raises(ValueError, match="max_len"):
        req.future.result(timeout=WAIT_S)
    assert model.live_sequences() == 0
    model.unload()


def test_batched_step_writes_only_active_rows(port_params):
    dec = TinyDecoderModel(device="cpu", params=port_params)
    caches = dec.fresh_batched_cache(4)
    for kv in caches:
        kv.normal_()
    before = [kv.clone() for kv in caches]
    tokens = np.array([1, 2, 3, 4])
    pos = np.array([0, 5, M, 9], np.int32)
    active = np.array([True, False, False, True])
    logits = dec.batched_step(caches, tokens, pos, active)
    assert logits.shape == (4, TinyDecoderModel.VOCAB) and logits.dtype == torch.float32
    for kv, old in zip(caches, before):
        changed = (kv != old).any(dim=-1)  # [2, S, H, M]
        assert changed[:, [1, 2]].sum() == 0
        assert changed[:, 0, :, 1:].sum() == 0 and changed[:, 3, :, :9].sum() == 0
        assert changed[:, 3, :, 10:].sum() == 0
        assert changed[:, 0, :, 0].all() and changed[:, 3, :, 9].all()


def test_one_attention_launch_per_layer_per_round(monkeypatch, port_params):
    """Each round calls ops.decode_attention once per layer at B = slots,
    with the positions as a device int32 tensor."""
    calls = []
    real = port_decoder.decode_attention

    def spy(q, k, v, pos):
        calls.append((tuple(q.shape), tuple(k.shape), pos.dtype, pos.device.type))
        return real(q, k, v, pos)

    monkeypatch.setattr(port_decoder, "decode_attention", spy)
    model = _port(port_params, slots=8)
    _run_schedule(model, port_batched._SeqRequest, SCHEDULES["together"])
    rounds = sum(model.batch_histogram.values())
    assert rounds == 4 + 5  # the longest prompt, then five decode windows
    assert len(calls) == rounds * TinyDecoderModel.LAYERS
    assert set(calls) == {((8, 4, 32), (8, 4, M, 32), torch.int32, "cpu")}
    model.unload()


# -- the contracts of tests/test_decoder_batched.py ---------------------------


def _call(model, seq, tokens, start=False, end=False):
    return model.execute({"TOKENS": np.array([tokens], np.int32)},
                         {"sequence_id": seq, "sequence_start": start, "sequence_end": end})


def test_slot_exhaustion_is_a_request_error(port_params):
    model = _port(port_params, slots=2)
    for seq in (1, 2):
        _call(model, seq, [5], start=True)
    with pytest.raises(ValueError, match="no free sequence slot"):
        _call(model, 3, [5], start=True)
    _call(model, 1, [6], end=True)  # ending one frees its slot
    _call(model, 3, [5], start=True, end=True)
    _call(model, 2, [6], end=True)
    assert model.live_sequences() == 0
    model.unload()


@pytest.mark.parametrize("tokens,params,match", [
    ([1], {}, "sequence_id"),
    ([1], {"sequence_id": 77}, "no live state"),
    ([1, 2], {"sequence_id": 77}, "exactly one token"),
    ([999], {"sequence_id": 77, "sequence_start": True}, "out of range"),
    ([-1], {"sequence_id": 77, "sequence_start": True}, "out of range"),
    ([], {"sequence_id": 77, "sequence_start": True}, "empty prompt"),
])
def test_validation_errors_match_jax(port_params, tokens, params, match):
    """The same request fails the same way in both packages, and the model
    still serves afterwards (the worker is alive)."""
    arr = np.array([tokens], np.int32).reshape(1, len(tokens))
    errors = []
    for model in (jax_batched.BatchedDecoderModel(seed=0, slots=2), _port(port_params, slots=2)):
        with pytest.raises(ValueError, match=match) as err:
            model.execute({"TOKENS": arr}, params)
        errors.append(str(err.value))
        out = _call(model, 78, [3], start=True, end=True)
        assert out["NEXT_TOKEN"].shape == (1, 1)
        model.unload()
    assert errors[0] == errors[1]


def test_overflow_frees_the_slot(port_params):
    model = _port(port_params, slots=1)
    with pytest.raises(ValueError, match="max_len"):
        _call(model, 5, list(range(10, 10 + M + 1)), start=True)
    _call(model, 6, [5], start=True, end=True)  # the failed start leaked nothing
    assert model.live_sequences() == 0
    model.unload()


def _drive(model, seq, prompt, n):
    out = _call(model, seq, prompt, start=True)
    toks = [int(out["NEXT_TOKEN"][0, 0])]
    for i in range(n - 1):
        out = _call(model, seq, [toks[-1]], end=i == n - 2)
        toks.append(int(out["NEXT_TOKEN"][0, 0]))
    return toks


def test_restart_in_place(port_params, reference):
    model = _port(port_params, slots=2)
    _call(model, 9, [4], start=True)
    slot = model._slot_of[9]
    toks = _drive(model, 9, [1, 2, 3], n=4)  # restarts seq 9 in its slot
    assert toks == _drive(reference, 9, [1, 2, 3], n=4)
    assert model.live_sequences() == 0 and model._free.count(slot) == 1
    model.unload()


def test_unload_rejects_and_strands_nothing(port_params):
    model = _port(port_params, slots=2)
    _call(model, 1, [3], start=True, end=True)
    model.unload()
    assert not model._worker.is_alive()
    with pytest.raises(ValueError, match="shutting down"):
        _call(model, 2, [3], start=True)


def test_idle_sequences_are_reaped(port_params):
    """Sequences idle past the TTL (their clocks set back) free their slots
    at the next window; the window's own sequences are never reaped."""
    slots = 3
    model = _port(port_params, slots=slots, idle_ttl_s=300.0)
    for seq in range(1, slots + 1):
        _call(model, seq, [5], start=True)
    with pytest.raises(ValueError, match="no free sequence slot"):
        _call(model, 100, [5], start=True)
    with model._lock:
        for seq in model._last_seen:
            model._last_seen[seq] -= 301.0
    for seq in range(201, 201 + slots):
        out = _call(model, seq, [7], start=True, end=True)
        assert out["NEXT_TOKEN"].shape == (1, 1)
    assert model.live_sequences() == 0
    model.unload()


def test_active_sequences_survive_the_reaper(port_params, reference):
    """A sequence's requests refresh its idle clock, and a sequence with a
    request in the window is never reaped, even past the TTL."""
    model = _port(port_params, slots=2, idle_ttl_s=300.0)
    _call(model, 11, [1, 2, 3], start=True)
    _call(model, 12, [3], start=True)
    with model._lock:
        model._last_seen[11] -= 299.0
        model._last_seen[12] -= 301.0
    _call(model, 500, [3], start=True, end=True)  # reaps 12 only
    assert set(model._slot_of) == {11}
    with model._lock:
        model._last_seen[11] -= 2.0  # past the TTL, but its request is in the window
    ours = _call(model, 11, [9])
    with model._lock:
        assert time.monotonic() - model._last_seen[11] < 300.0
    reference.execute({"TOKENS": np.array([[1, 2, 3]], np.int32)},
                      {"sequence_id": 502, "sequence_start": True})
    theirs = reference.execute({"TOKENS": np.array([[9]], np.int32)},
                               {"sequence_id": 502, "sequence_end": True})
    assert int(ours["NEXT_TOKEN"][0, 0]) == int(theirs["NEXT_TOKEN"][0, 0])
    _call(model, 11, [1], end=True)
    assert model.live_sequences() == 0
    model.unload()


# -- the worker: gated coalescing, typed errors, HTTP -------------------------


def _gate(model):
    """Hold the worker before each window until the returned event is set."""
    gate = threading.Event()
    real = model._collect

    def gated():
        if not gate.wait(WAIT_S):
            raise AssertionError("the test never opened the gate")
        return real()

    model._collect = gated
    return gate


def _queued(model, n):
    deadline = time.monotonic() + WAIT_S
    while model._queue.qsize() < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"{n} requests never reached the queue")
        time.sleep(0.001)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_served_over_http(port_params, reference, client):
    """Three sequences over HTTP: the first window holds all three starts
    (the worker waits at a gate until they are queued), and every sequence's
    tokens equal decoder_lm's."""
    http = port_http if client == "port" else jax_http
    model = _port(port_params, slots=3, max_delay_s=1.0)
    gate = _gate(model)
    server = HttpInferenceServer(ServerCore([model], device="cpu")).start()
    prompts = {21: [1, 2, 3], 22: [9, 8, 7, 6], 23: [42]}
    results, errors = {}, []

    def run(seq, prompt):
        c = http.InferenceServerClient(server.url, network_timeout=WAIT_S)
        try:
            toks = []
            for i in range(4):
                tokens = prompt if i == 0 else [toks[-1]]
                arr = np.array([tokens], np.int32)
                inp = http.InferInput("TOKENS", list(arr.shape), "INT32")
                inp.set_data_from_numpy(arr)
                r = c.infer("decoder_lm_batched", [inp], sequence_id=seq,
                            sequence_start=i == 0, sequence_end=i == 3)
                toks.append(int(r.as_numpy("NEXT_TOKEN")[0, 0]))
            results[seq] = toks
        except Exception as e:  # surfaced below
            errors.append((seq, e))
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=item) for item in prompts.items()]
    try:
        for t in threads:
            t.start()
        _queued(model, 3)
        gate.set()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        gate.set()
        server.stop()
        model.unload()
    assert not errors, errors
    for seq, prompt in prompts.items():
        assert results[seq] == _drive(reference, 100 + seq, prompt, n=4), seq
    assert model.batch_histogram.get(3, 0) >= 1, model.batch_histogram
    assert model.live_sequences() == 0


def test_stalled_worker_gives_typed_504_and_503(port_params):
    """A caller whose window never runs gets a 504; with the queue full, the
    next caller gets a 503. The worker then serves both queued requests."""
    model = _port(port_params, slots=2)
    model._queue = queue.Queue(maxsize=1)
    gate = _gate(model)
    model.RESULT_TIMEOUT_S = 0.2
    model.QUEUE_TIMEOUT_S = 0.2
    try:
        with pytest.raises(InferError) as err:
            _call(model, 1, [3], start=True)
        assert err.value.status == 504 and "timed out" in str(err.value)
        with pytest.raises(InferError) as err:
            _call(model, 2, [3], start=True)
        assert err.value.status == 503 and "queue full" in str(err.value)
    finally:
        gate.set()
    model.RESULT_TIMEOUT_S = model.QUEUE_TIMEOUT_S = WAIT_S
    # the timed-out request still ran (its caller was gone): seq 1 is live
    out = _call(model, 1, [4], end=True)
    assert out["LOGITS"].shape == (1, TinyDecoderModel.VOCAB)
    assert model.live_sequences() == 0
    model.unload()


def test_failed_step_fails_the_window_and_frees_its_slots(monkeypatch, port_params):
    model = _port(port_params, slots=2)
    _call(model, 1, [3], start=True)

    def broken(*args):
        raise RuntimeError("device lost")

    monkeypatch.setattr(model._decoder, "batched_step", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        _call(model, 1, [4])
    assert model.live_sequences() == 0
    monkeypatch.undo()
    assert _call(model, 2, [5], start=True, end=True)["NEXT_TOKEN"].shape == (1, 1)
    model.unload()


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_positional_parameters_in_jax_order(port_params, impl):
    """JAX's ``BatchedDecoderModel(seed, slots, max_delay_s, attention_impl,
    idle_ttl_s)`` by position: the fourth is attention_impl (it used to land
    in idle_ttl_s), the fifth idle_ttl_s, each as JAX's model reads them."""
    ours = port_batched.BatchedDecoderModel(0, 2, 0.004, impl, 7.5, device="cpu",
                                            params=port_params)
    theirs = jax_batched.BatchedDecoderModel(0, 2, 0.004, impl, 7.5)
    # neither has built or started its worker: nothing to stop
    for model in (ours, theirs):
        assert model.slots == 2 and model._max_delay_s == 0.004
        assert model._idle_ttl_s == 7.5
    assert ours._decoder.attention_impl == impl == theirs._decoder._attention_impl
    with pytest.raises(ValueError) as port_err:
        port_batched.BatchedDecoderModel(0, 2, 0.004, "flash", device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_batched.BatchedDecoderModel(0, 2, 0.004, "flash")
    assert str(port_err.value) == str(jax_err.value)
