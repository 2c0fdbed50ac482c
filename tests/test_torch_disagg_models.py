"""The port's ``decoder_lm_prefill`` and disagg pair against the JAX
package's, and against the port's own ``decoder_lm`` / ``tiny_lm_generate``.

Weights come from ``load_jax_params`` of the JAX decoder's tree; every
prompt is a fixed list or drawn from a numpy seed. Against JAX: logits within
5e-2 (tests/test_torch_decoder.py's bound), and so is the exported KV (XLA
and torch round the bf16 products apart, and layer 2's inputs carry layer
1's differences), greedy tokens equal. Against the port's own decoder: bit
for bit. The KV handoff runs through a cuda shared-memory region on the CPU
device, in process, as on the card.
"""

import uuid

import jax
import numpy as np
import pytest
import torch

import client_tpu_torch.http as port_http
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.models.decoder_prefill import PrefillDecoderModel as JaxPrefill
from client_tpu.models.disagg import DisaggPrefillModel as JaxDisaggPrefill
from client_tpu.models.disagg import KvDecodeModel as JaxKvDecode
from client_tpu_torch.models.decoder import TinyDecoderModel, load_jax_params
from client_tpu_torch.models.decoder_prefill import PrefillDecoderModel
from client_tpu_torch.models.disagg import DisaggPrefillModel, KvDecodeModel
from client_tpu_torch.models.generate import TinyGenerateModel
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.utils import cuda_shared_memory as cudashm

LOGIT_ATOL = 5e-2
M = TinyDecoderModel.MAX_LEN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_decoder():
    model = JaxDecoder(seed=0)
    model._ensure_built()
    return model


@pytest.fixture(scope="module")
def decoder(jax_decoder):
    params = load_jax_params(jax.tree.map(np.asarray, jax_decoder._params), "cpu")
    return TinyDecoderModel(device="cpu", params=params)


def _tokens(rows):
    return {"TOKENS": np.array(rows, np.int32)}


def _drawn(seed, rows, length):
    return np.random.default_rng(seed).integers(0, 256, (rows, length)).tolist()


PREFILL_BATCHES = {
    "one_row": [[1, 2, 3, 4]],
    "three_rows": [[5, 6, 7], [1, 2, 3], [200, 0, 9]],
    "zeros": [[0] * 10],
    "single_tokens": [[42], [7], [255]],
    "drawn_4x12": _drawn(3, 4, 12),
    "full_length": _drawn(4, 2, M),
}


@pytest.mark.parametrize("batch", list(PREFILL_BATCHES))
def test_prefill_rows_are_decoder_lm_bit_for_bit(decoder, batch):
    rows = PREFILL_BATCHES[batch]
    out = PrefillDecoderModel(decoder=decoder).execute(_tokens(rows), {})
    assert out["LOGITS"].shape == (len(rows), 256) and out["LOGITS"].dtype == np.float32
    assert out["NEXT_TOKEN"].shape == (len(rows), 1) and out["NEXT_TOKEN"].dtype == np.int32
    for b, row in enumerate(rows):
        one = decoder.execute(_tokens([row]), {"sequence_id": 700 + b, "sequence_start": True,
                                               "sequence_end": True})
        assert out["LOGITS"][b].tobytes() == one["LOGITS"][0].tobytes()
        assert out["NEXT_TOKEN"][b, 0] == one["NEXT_TOKEN"][0, 0]


def _check_tokens_against_jax(ours_logits, theirs_logits, ours_tok, theirs_tok):
    """Greedy tokens equal, or a near tie: JAX's margin between the two picks
    is below twice the row's logit difference."""
    for mine, other, a, b in zip(ours_logits, theirs_logits, ours_tok, theirs_tok):
        if a != b:
            margin = float(other[b] - other[a])
            diff = float(np.abs(mine - other).max())
            assert margin < 2 * diff, f"token {a} against JAX's {b}: margin {margin}, diff {diff}"


@pytest.mark.parametrize("batch", list(PREFILL_BATCHES))
def test_prefill_matches_jax(jax_decoder, decoder, batch):
    rows = PREFILL_BATCHES[batch]
    ours = PrefillDecoderModel(decoder=decoder).execute(_tokens(rows), {})
    theirs = JaxPrefill(tp=False).execute(_tokens(rows), {})
    np.testing.assert_allclose(ours["LOGITS"], theirs["LOGITS"], atol=LOGIT_ATOL, rtol=0)
    _check_tokens_against_jax(ours["LOGITS"], theirs["LOGITS"], ours["NEXT_TOKEN"][:, 0],
                              theirs["NEXT_TOKEN"][:, 0])


@pytest.mark.parametrize("tokens,match", [
    (np.zeros((2, 0), np.int32), "prompt_len >= 1"),
    (np.zeros((3,), np.int32), "prompt_len >= 1"),
    (np.zeros((1, M + 1), np.int32), "max_len"),
    (np.array([[1, 256]], np.int32), "out of range"),
    (np.array([[-1, 2]], np.int32), "out of range"),
])
def test_prefill_errors_match_jax(decoder, tokens, match):
    with pytest.raises(ValueError, match=match) as ours:
        PrefillDecoderModel(decoder=decoder).execute({"TOKENS": tokens}, {})
    with pytest.raises(ValueError) as theirs:
        JaxPrefill(tp=False).execute({"TOKENS": tokens}, {})
    assert str(ours.value) == str(theirs.value)


def test_tensor_parallel_prefill_waits_for_the_multi_device_item(decoder):
    """``decoder_lm_tp_prefill``, which raised until the mesh models were
    ported: over four CPU shards its rows are ``decoder_lm_prefill``'s bit
    for bit, and its NEXT_TOKEN is JAX's (logits within 5e-2)."""
    tp = PrefillDecoderModel(tp=True, device="cpu")
    assert tp.name == "decoder_lm_tp_prefill" and tp.tp_degree == 4
    tokens = np.array(_drawn(9, 3, 6), np.int32)
    ours = tp.execute({"TOKENS": tokens}, {})
    single = PrefillDecoderModel(decoder=decoder).execute({"TOKENS": tokens}, {})
    for key in ("LOGITS", "NEXT_TOKEN"):
        np.testing.assert_array_equal(ours[key], single[key])
    theirs = JaxPrefill(tp=True).execute({"TOKENS": tokens}, {})
    np.testing.assert_allclose(ours["LOGITS"], theirs["LOGITS"], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(ours["NEXT_TOKEN"], theirs["NEXT_TOKEN"])


# -- the disagg pair ------------------------------------------------------------

PROMPTS = {"four": [1, 2, 3, 4], "three": [5, 6, 7], "one": [200], "drawn_40": _drawn(5, 1, 40)[0]}


def _kv_rows(caches):
    return [c[half] for c in caches for half in ("k", "v")]


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_disagg_prefill_exports_the_decoders_cache(decoder, prompt):
    tokens = PROMPTS[prompt]
    out = DisaggPrefillModel(decoder=decoder).execute(_tokens([tokens]), {})
    kv = out["KV"]
    assert isinstance(kv, torch.Tensor) and kv.dtype == torch.float32
    assert tuple(kv.shape) == (4, 4, M, 32)
    caches = decoder.fresh_cache()
    logits = decoder.prefill(caches, np.array(tokens), 0)
    assert torch.equal(kv, torch.stack(_kv_rows(caches)).float())
    assert torch.equal(kv.to(torch.bfloat16).float(), kv)  # bf16 values, exactly
    assert out["NEXT_TOKEN"].tolist() == [[int(logits.argmax())]]
    assert out["POS"].tolist() == [[len(tokens)]]


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_disagg_prefill_matches_jax(jax_decoder, decoder, prompt):
    tokens = _tokens([PROMPTS[prompt]])
    ours = DisaggPrefillModel(decoder=decoder).execute(tokens, {})
    theirs = JaxDisaggPrefill(decoder=jax_decoder).execute(tokens, {})
    kv = ours["KV"].numpy()
    assert kv.shape == theirs["KV"].shape
    np.testing.assert_allclose(kv, theirs["KV"], atol=LOGIT_ATOL, rtol=0)
    assert ours["POS"].tolist() == theirs["POS"].tolist()
    assert ours["NEXT_TOKEN"].tolist() == theirs["NEXT_TOKEN"].tolist()


def _stream(model, inputs, params=None):
    responses = list(model.execute_decoupled(inputs, params or {}))
    return ([int(r["NEXT_TOKEN"][0, 0]) for r in responses],
            [int(r["INDEX"][0, 0]) for r in responses])


def _decode_inputs(prefill_out, max_tokens=None, end_id=None, start_index=None):
    inputs = {"KV": prefill_out["KV"],
              "POS": np.asarray(prefill_out["POS"]).reshape(1),
              "FIRST_TOKEN": np.asarray(prefill_out["NEXT_TOKEN"]).reshape(1)}
    for name, value in (("MAX_TOKENS", max_tokens), ("END_ID", end_id),
                        ("START_INDEX", start_index)):
        if value is not None:
            inputs[name] = np.array([value], np.int32)
    return inputs


STREAMS = [
    ("four", 4, None, None),
    ("three", 6, None, None),
    ("four", 8, 69, None),
    ("four", 5, None, 7),
    ("one", None, None, None),
    ("drawn_40", 12, None, 3),
]


@pytest.mark.parametrize("prompt,max_tokens,end_id,start_index", STREAMS)
def test_kv_decode_stream_is_tiny_lm_generate(decoder, prompt, max_tokens, end_id, start_index):
    tokens = PROMPTS[prompt]
    handoff = DisaggPrefillModel(decoder=decoder).execute(_tokens([tokens]), {})
    got, index = _stream(KvDecodeModel(decoder=decoder),
                         _decode_inputs(handoff, max_tokens, end_id, start_index))
    gen_inputs = _tokens([tokens])
    if max_tokens is not None:
        gen_inputs["MAX_TOKENS"] = np.array([max_tokens], np.int32)
    if end_id is not None:
        gen_inputs["END_ID"] = np.array([end_id], np.int32)
    want, _ = _stream(TinyGenerateModel(decoder=decoder), gen_inputs)
    assert got == want
    assert index == list(range(start_index or 0, (start_index or 0) + len(got)))
    if end_id is not None and end_id in want:
        assert got[-1] == end_id


@pytest.mark.parametrize("prompt,max_tokens,end_id,start_index", STREAMS)
def test_kv_decode_stream_matches_jax(jax_decoder, decoder, prompt, max_tokens, end_id,
                                      start_index):
    """Both packages decode from the same handed-off KV (JAX's export)."""
    handoff = JaxDisaggPrefill(decoder=jax_decoder).execute(_tokens([PROMPTS[prompt]]), {})
    inputs = _decode_inputs(handoff, max_tokens, end_id, start_index)
    assert _stream(KvDecodeModel(decoder=decoder), inputs) == _stream(
        JaxKvDecode(decoder=jax_decoder), inputs)


def test_kv_decode_stops_at_the_end_of_the_cache(decoder):
    tokens = _drawn(6, 1, M - 2)[0]
    handoff = DisaggPrefillModel(decoder=decoder).execute(_tokens([tokens]), {})
    got, _ = _stream(KvDecodeModel(decoder=decoder), _decode_inputs(handoff, max_tokens=10))
    assert len(got) == 3  # the first token, then one step per free slot


def _kv_cases():
    good = {"KV": np.zeros((4, 4, M, 32), np.float32), "POS": np.array([3], np.int32),
            "FIRST_TOKEN": np.array([5], np.int32)}
    return {
        "kv_shape": ({**good, "KV": np.zeros((4, 4, M, 16), np.float32)}, "KV shape"),
        "pos_zero": ({**good, "POS": np.array([0], np.int32)}, "POS out of range"),
        "pos_past": ({**good, "POS": np.array([M + 1], np.int32)}, "POS out of range"),
        "first_token": ({**good, "FIRST_TOKEN": np.array([256], np.int32)}, "FIRST_TOKEN"),
        "budget": ({**good, "MAX_TOKENS": np.array([0], np.int32)}, "MAX_TOKENS"),
        "start_index": ({**good, "START_INDEX": np.array([-1], np.int32)}, "START_INDEX"),
    }


@pytest.mark.parametrize("case", list(_kv_cases()))
def test_kv_decode_errors_match_jax(jax_decoder, decoder, case):
    inputs, match = _kv_cases()[case]
    with pytest.raises(ValueError, match=match) as ours:
        list(KvDecodeModel(decoder=decoder).execute_decoupled(inputs, {}))
    with pytest.raises(ValueError) as theirs:
        list(JaxKvDecode(decoder=jax_decoder).execute_decoupled(inputs, {}))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("tokens,match", [
    ([], "empty prompt"), ([1, 300], "out of range"), ([0] * M, "max_len")])
def test_disagg_prefill_errors_match_jax(jax_decoder, decoder, tokens, match):
    inputs = {"TOKENS": np.array(tokens, np.int32).reshape(1, len(tokens))}
    with pytest.raises(ValueError, match=match) as ours:
        DisaggPrefillModel(decoder=decoder).execute(inputs, {})
    with pytest.raises(ValueError) as theirs:
        JaxDisaggPrefill(decoder=jax_decoder).execute(inputs, {})
    assert str(ours.value) == str(theirs.value)


def test_kv_decode_is_decoupled_only(decoder):
    with pytest.raises(ValueError, match="decoupled"):
        KvDecodeModel(decoder=decoder).execute({}, {})


@pytest.mark.parametrize("colocated", [True, False])
def test_handoff_through_a_cuda_shm_region(decoder, colocated):
    """The prefill writes KV into a cuda shm output region over HTTP; the
    decode streams from that region through ServerCore.infer_stream. In one
    process the region hands over the prefill's own tensor."""
    core = ServerCore([DisaggPrefillModel(decoder=decoder), KvDecodeModel(decoder=decoder)],
                      device="cpu")
    server = HttpInferenceServer(core).start()
    client = port_http.InferenceServerClient(server.url)
    nbytes = 4 * 4 * M * 32 * 4
    name = f"kv_{uuid.uuid4().hex[:12]}"
    region = cudashm.create_shared_memory_region(name, nbytes, device="cpu",
                                                 colocated=colocated)
    prompt = [1, 2, 3, 4]
    try:
        client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)
        arr = np.array([prompt], np.int32)
        inp = port_http.InferInput("TOKENS", [1, 4], "INT32").set_data_from_numpy(arr)
        kv_out = port_http.InferRequestedOutput("KV")
        kv_out.set_shared_memory(name, nbytes)
        result = client.infer("decoder_lm_disagg_prefill", [inp], outputs=[
            kv_out, port_http.InferRequestedOutput("NEXT_TOKEN"),
            port_http.InferRequestedOutput("POS")])
        assert result.as_numpy("KV") is None  # the contents live in the region
        first, pos = int(result.as_numpy("NEXT_TOKEN")[0, 0]), int(result.as_numpy("POS")[0, 0])
        kv = cudashm.get_contents_as_torch(region, "FP32", [4, 4, M, 32])
        request = {"inputs": [
            {"name": "KV", "datatype": "FP32", "shape": [4, 4, M, 32], "shm": (name, nbytes, 0)},
            {"name": "POS", "datatype": "INT32", "shape": [1], "array": np.array([pos], np.int32)},
            {"name": "FIRST_TOKEN", "datatype": "INT32", "shape": [1],
             "array": np.array([first], np.int32)},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "array": np.array([8], np.int32)},
        ]}
        stream = [int(r["outputs"][0]["array"][0, 0])
                  for r in core.infer_stream("decoder_lm_kv_decode", "", request)]
    finally:
        client.unregister_cuda_shared_memory()
        client.close()
        server.stop()
        cudashm.destroy_shared_memory_region(region)
    caches = decoder.fresh_cache()
    decoder.prefill(caches, np.array(prompt), 0)
    assert torch.equal(kv, torch.stack(_kv_rows(caches)).float())
    want, _ = _stream(TinyGenerateModel(decoder=decoder),
                      {**_tokens([prompt]), "MAX_TOKENS": np.array([8], np.int32)})
    assert stream == want
