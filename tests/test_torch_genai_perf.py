"""``client_tpu_torch.genai_perf`` against ``client_tpu.genai_perf``.

``GenAiPerfRunner`` in its three modes — ``decoupled`` (``tiny_lm_generate``
over a GRPC bidi stream), ``sequence`` (``decoder_lm`` and
``decoder_lm_batched`` over the stateful sequence API) and ``generate``
(the HTTP SSE generate extension) — the port's runner against the port's
CPU server beside the JAX runner against the JAX server, and the JAX
runner against the port's server. The rows must have the same keys, the
same sessions and token counts (sessions x output tokens), no errors, and
every session's streamed tokens must equal the JAX package's for the same
prompt, but at a documented near tie (ROADMAP C: the two packages' logits
differ by ~0.008, which can swap a top-2 pair within that margin).
"""

import threading

import numpy as np
import pytest
import torch

from client_tpu import genai_perf as jax_genai
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.models.decoder_batched import BatchedDecoderModel as JaxBatched
from client_tpu.models.generate import TinyGenerateModel as JaxGenerate
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import genai_perf as port_genai
from client_tpu_torch.models import BatchedDecoderModel, TinyDecoderModel, TinyGenerateModel
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PROMPT, OUTPUT = 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def servers():
    decoder = TinyDecoderModel(device="cpu")
    batched = [BatchedDecoderModel(device="cpu"), JaxBatched()]
    port_core = ServerCore([decoder, TinyGenerateModel(decoder=decoder), batched[0]],
                           device="cpu")
    jax_decoder = JaxDecoder()
    jax_core = JaxCore([jax_decoder, JaxGenerate(decoder=jax_decoder), batched[1]])
    made = {("port", "http"): HttpInferenceServer(port_core).start(),
            ("port", "grpc"): GrpcInferenceServer(port_core, max_workers=16).start(),
            ("jax", "http"): JaxHttpServer(jax_core).start(),
            ("jax", "grpc"): JaxGrpcServer(jax_core, max_workers=16).start()}
    yield made
    for server in made.values():
        server.stop()
    for model in batched:  # their slot workers end with them
        model.unload()


class _Tap:
    """A response queue that records each session's NEXT_TOKENs."""

    def __init__(self, responses, local):
        self._responses = responses
        self._local = local

    def get(self, timeout=None):
        result, error = self._responses.get(timeout=timeout)
        if error is None and result is not None:
            token = result.as_numpy("NEXT_TOKEN")
            if token is not None:
                self._local.tokens.append(int(token.reshape(-1)[0]))
        return result, error


class _GenerateTap:
    """A client whose generate_stream records each event's NEXT_TOKEN."""

    def __init__(self, client, local):
        self._client = client
        self._local = local

    def generate_stream(self, *args, **kwargs):
        for event in self._client.generate_stream(*args, **kwargs):
            self._local.tokens.append(int(event["NEXT_TOKEN"]))
            yield event

    def __getattr__(self, name):
        return getattr(self._client, name)


def _recording(cls):
    """``cls`` with each session's prompt and streamed tokens recorded."""

    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.streams = {}
            self._local = threading.local()
            self._streams_lock = threading.Lock()

        def _prompt(self, rng):
            prompt = super()._prompt(rng)
            self._local.tokens = []
            with self._streams_lock:
                self.streams[tuple(prompt.reshape(-1).tolist())] = self._local.tokens
            return prompt

        def _run_decoupled_session(self, client, infer_input, sess, responses, rng):
            super()._run_decoupled_session(client, infer_input, sess,
                                           _Tap(responses, self._local), rng)

        def _run_sequence_session(self, client, infer_input, sess, responses, sequence_id,
                                  rng):
            super()._run_sequence_session(client, infer_input, sess,
                                          _Tap(responses, self._local), sequence_id, rng)

        def _run_generate_session(self, client, sess, rng):
            super()._run_generate_session(_GenerateTap(client, self._local), sess, rng)

    return Recording


RUNNERS = {"port": _recording(port_genai.GenAiPerfRunner),
           "jax": _recording(jax_genai.GenAiPerfRunner)}
MODES = [("decoupled", "tiny_lm_generate", "grpc"),
         ("sequence", "decoder_lm", "grpc"),
         ("sequence", "decoder_lm_batched", "grpc"),
         ("generate", "tiny_lm_generate", "http")]


def _keys(row):
    if isinstance(row, dict):
        return {k: _keys(v) for k, v in row.items()}
    return None


@pytest.fixture(scope="module")
def decoders():
    return {"port": TinyDecoderModel(device="cpu"), "jax": JaxDecoder()}


def _logits(decoder, tokens, seq_id):
    """Each greedy step's logits of ``decoder`` over ``tokens`` (the prompt
    first, then one token a step)."""
    rows = []
    for i, start in enumerate(range(PROMPT - 1, len(tokens))):
        chunk = tokens[:PROMPT] if i == 0 else tokens[start:start + 1]
        out = decoder.execute({"TOKENS": np.array([chunk], np.int32)},
                              {"sequence_id": seq_id, "sequence_start": i == 0,
                               "sequence_end": start == len(tokens) - 1})
        rows.append(np.asarray(out["LOGITS"], np.float32).reshape(-1))
    return rows


def _equal_or_near_tie(prompt, ours, theirs, decoders):
    """Equal streams, or streams that part at a near tie: JAX's margin
    between its pick and the port's below twice the row's logit
    difference (as ``test_torch_decoder_batched._near_ties`` allows)."""
    if ours == theirs:
        return True
    step = next(i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b)
    tokens = list(prompt) + theirs[:step]
    mine = _logits(decoders["port"], tokens, 7001)[-1]
    other = _logits(decoders["jax"], tokens, 7002)[-1]
    margin = float(other[theirs[step]] - other[ours[step]])
    return margin < 2 * float(np.abs(mine - other).max())


@pytest.mark.parametrize("mode, model, protocol", MODES,
                         ids=[f"{m}-{model}" for m, model, _ in MODES])
@pytest.mark.parametrize("concurrency", [1, 3])
def test_rows_tokens_and_sessions_equal(servers, decoders, mode, model, protocol, concurrency):
    sessions = 3
    rows, streams = {}, {}
    for pkg, server in (("port", "port"), ("jax", "jax"), ("jax on port", "port")):
        runner = RUNNERS[pkg.split()[0]](servers[(server, protocol)].url, model, mode,
                                         PROMPT, OUTPUT, seed=3)
        rows[pkg] = runner.run(concurrency, sessions)
        streams[pkg] = runner.streams
    for pkg, row in rows.items():
        assert row["errors"] == 0 and row["incomplete"] == 0, (pkg, row["error_sample"])
        assert row["sessions"] == sessions
        assert sum(len(t) for t in streams[pkg].values()) == sessions * OUTPUT
        assert _keys(row) == _keys(rows["jax"])
    # the same seeded prompts in every run
    assert sorted(streams["port"]) == sorted(streams["jax"]) == sorted(streams["jax on port"])
    for prompt, tokens in streams["port"].items():
        # the JAX runner against the port's server streams the port's tokens
        assert streams["jax on port"][prompt] == tokens
        assert _equal_or_near_tie(prompt, tokens, streams["jax"][prompt], decoders), (
            prompt, tokens, streams["jax"][prompt])


@pytest.mark.parametrize("mode", ["decoupled", "generate"])
def test_observe_sources_the_stream_span(servers, mode):
    protocol = "grpc" if mode == "decoupled" else "http"
    rows = {}
    for pkg, mod in (("port", port_genai), ("jax", jax_genai)):
        runner = mod.GenAiPerfRunner(servers[(pkg, protocol)].url, "tiny_lm_generate", mode,
                                     PROMPT, OUTPUT, observe=True)
        rows[pkg] = runner.run(1, 2)
    assert _keys(rows["port"]) == _keys(rows["jax"])
    assert rows["port"]["telemetry_source"] == "stream_span"
    assert rows["port"]["sessions"] == 2


@pytest.mark.parametrize("kwargs, message", [
    ({"mode": "nope"}, "unknown mode"),
    ({"output_tokens": 0}, "output_tokens"),
    ({"prompt_tokens": 0}, "prompt_tokens"),
    ({"mode": "sequence", "observe": True}, "observe"),
])
def test_validation_as_jax(kwargs, message):
    args = {"url": "127.0.0.1:1", "model_name": "m", "mode": "decoupled",
            "prompt_tokens": 4, "output_tokens": 4, **kwargs}
    errors = []
    for mod in (port_genai, jax_genai):
        with pytest.raises(ValueError, match=message) as exc:
            mod.GenAiPerfRunner(**args)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_unreachable_server_counts_errors_not_hangs():
    runner = port_genai.GenAiPerfRunner("127.0.0.1:1", "tiny_lm_generate", "generate", 2, 2)
    row = runner.run(1, 2)
    assert row["sessions"] == 0 and row["errors"] == 2


def test_cli_json(servers, capsys):
    import json

    rc = port_genai.main(["-u", servers[("port", "grpc")].url, "--mode", "decoupled",
                          "--sessions", "2", "--prompt-tokens", "3", "--output-tokens", "3",
                          "--warmup-sessions", "1", "--concurrency-range", "1:2", "-f", "json"])
    rows = json.loads(capsys.readouterr().out)
    assert rc == 0 and [r["concurrency"] for r in rows] == [1, 2]
    assert all(r["sessions"] == 2 and r["errors"] == 0 for r in rows)


def test_near_tie_check_refuses_a_clear_difference(decoders):
    """The near-tie allowance itself: JAX's own greedy stream against a
    stream that parts from it at a token far below JAX's pick is refused."""
    prompt = (5, 17, 200, 3)
    logits = _logits(decoders["jax"], list(prompt), 7003)[-1]
    theirs = [int(np.argmax(logits))]
    ours = [int(np.argmin(logits))]
    assert _equal_or_near_tie(prompt, theirs, theirs, decoders)
    assert not _equal_or_near_tie(prompt, ours, theirs, decoders)
