"""The port's decoder family against the JAX package's.

The same weights go into both packages (``load_jax_params`` from the JAX
``TinyDecoderModel(seed=0)``'s parameter tree, or the port's own seeded
redraw, which must give identical bytes), and the same requests drive both:
logits must agree within 5e-2 (the JAX package's own bound between its
kernel and einsum paths, tests/test_decode_attention.py) and greedy tokens
must be identical. The port runs on the CPU here, where attention is the
plain version of the Hopper kernel.
"""

import jax
import numpy as np
import pytest
import torch

from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.models.generate import TinyGenerateModel as JaxGenerate
from client_tpu_torch.models import decoder as port_decoder
from client_tpu_torch.models.decoder import TinyDecoderModel, draw_params, load_jax_params
from client_tpu_torch.models.generate import TinyGenerateModel

LOGIT_ATOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
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
def jax_params_np(jax_decoder):
    return jax.tree.map(np.asarray, jax_decoder._params)


@pytest.fixture(scope="module")
def port_decoder_model(jax_params_np):
    return TinyDecoderModel(device="cpu", params=load_jax_params(jax_params_np, "cpu"))


def _drive(model, prompt, n, seq_id=11):
    """Sequence API: the prompt starts the sequence, then n-1 greedy steps."""
    params = {"sequence_id": seq_id, "sequence_start": True, "sequence_end": False}
    out = model.execute({"TOKENS": np.array([prompt], np.int32)}, params)
    logits, toks = [out["LOGITS"]], [int(out["NEXT_TOKEN"][0, 0])]
    for i in range(n - 1):
        params = {"sequence_id": seq_id, "sequence_start": False,
                  "sequence_end": i == n - 2}
        out = model.execute({"TOKENS": np.array([[toks[-1]]], np.int32)}, params)
        logits.append(out["LOGITS"])
        toks.append(int(out["NEXT_TOKEN"][0, 0]))
    return toks, np.concatenate(logits)


def _margins(logits):
    top = np.sort(logits, axis=-1)
    return (top[:, -1] - top[:, -2]).tolist()


@pytest.mark.parametrize("prompt", [[5, 6, 7], [1, 2, 3, 4], [200], [0] * 10])
def test_load_jax_params_matches_jax(jax_decoder, port_decoder_model, prompt):
    toks_j, logits_j = _drive(jax_decoder, prompt, n=8)
    toks_p, logits_p = _drive(port_decoder_model, prompt, n=8)
    assert logits_p.dtype == np.float32 and logits_p.shape == (8, 256)
    assert toks_p == toks_j, (
        f"greedy tokens differ; JAX top-2 margins {_margins(logits_j)}, "
        f"max logit diff {np.abs(logits_p - logits_j).max()}")
    np.testing.assert_allclose(logits_p, logits_j, atol=LOGIT_ATOL, rtol=0)


def _leaves(params):
    yield "embed", params["embed"]
    yield "pos", params["pos"]
    for i, layer in enumerate(params["layers"]):
        for key in ("qkv", "proj", "mlp_in", "mlp_out"):
            yield f"layers.{i}.{key}", layer[key]
    yield "unembed", params["unembed"]


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_redraw_is_byte_identical(seed):
    jax_model = JaxDecoder(seed=seed)
    jax_model._ensure_built()
    jax_leaves = dict(_leaves(jax.tree.map(np.asarray, jax_model._params)))
    port_leaves = dict(_leaves(draw_params(seed, "cpu")))
    assert jax_leaves.keys() == port_leaves.keys()
    for name, arr in jax_leaves.items():
        assert port_leaves[name].dtype == torch.bfloat16
        assert np.array_equal(_bits(arr), _bits(port_leaves[name])), name


def test_load_jax_params_is_the_redraw(jax_params_np):
    loaded = dict(_leaves(load_jax_params(jax_params_np, "cpu")))
    drawn = dict(_leaves(draw_params(0, "cpu")))
    for name in loaded:
        assert torch.equal(loaded[name], drawn[name]), name


def _stream(model, prompt, max_tokens, end_id=None, chunk=1):
    inputs = {"TOKENS": np.array([prompt], np.int32),
              "MAX_TOKENS": np.array([max_tokens], np.int32)}
    if end_id is not None:
        inputs["END_ID"] = np.array([end_id], np.int32)
    responses = list(model.execute_decoupled(inputs, {"chunk": chunk}))
    assert [int(r["INDEX"][0, 0]) for r in responses] == list(range(len(responses)))
    return [int(r["NEXT_TOKEN"][0, 0]) for r in responses]


@pytest.mark.parametrize("prompt,max_tokens,end_id", [
    ([1, 2, 3, 4], 4, None),
    ([5, 6, 7], 6, None),
    ([1, 2, 3, 4], 8, 69),
])
def test_generate_stream_matches_jax(jax_decoder, port_decoder_model, prompt, max_tokens, end_id):
    expected = _stream(JaxGenerate(decoder=jax_decoder), prompt, max_tokens, end_id)
    got = _stream(TinyGenerateModel(decoder=port_decoder_model), prompt, max_tokens, end_id)
    assert got == expected
    if end_id is not None and end_id in expected:
        assert got[-1] == end_id


@pytest.mark.parametrize("chunk", [2, 3, 5])
def test_chunked_equals_per_token(port_decoder_model, chunk):
    model = TinyGenerateModel(decoder=port_decoder_model)
    per_token = _stream(model, [9, 8, 7], 11)
    assert _stream(model, [9, 8, 7], 11, chunk=chunk) == per_token


def test_generation_agrees_with_the_sequence_api(port_decoder_model):
    toks, _ = _drive(port_decoder_model, [1, 2, 3, 4], n=6, seq_id=99)
    assert _stream(TinyGenerateModel(decoder=port_decoder_model), [1, 2, 3, 4], 6) == toks


def test_generation_is_clamped_to_cache_room(port_decoder_model):
    prompt = list(range(120))
    out = _stream(TinyGenerateModel(decoder=port_decoder_model), prompt, 50)
    assert len(out) == TinyDecoderModel.MAX_LEN - len(prompt)


@pytest.mark.parametrize("inputs,params,match", [
    ({"TOKENS": [[1, 2]]}, {}, "sequence_id"),
    ({"TOKENS": [[1, 256]]}, {"sequence_id": 5, "sequence_start": True}, "out of range"),
    ({"TOKENS": [[-1]]}, {"sequence_id": 5, "sequence_start": True}, "out of range"),
    ({"TOKENS": [[1]]}, {"sequence_id": 404}, "no live state"),
    ({"TOKENS": [[0] * 129]}, {"sequence_id": 5, "sequence_start": True}, "max_len"),
])
def test_decoder_rejects_bad_requests(port_decoder_model, inputs, params, match):
    inputs = {k: np.asarray(v, np.int32) for k, v in inputs.items()}
    with pytest.raises(ValueError, match=match):
        port_decoder_model.execute(inputs, params)


def test_continuation_carries_one_token(port_decoder_model):
    start = {"sequence_id": 6, "sequence_start": True}
    port_decoder_model.execute({"TOKENS": np.array([[1, 2]], np.int32)}, start)
    with pytest.raises(ValueError, match="exactly one token"):
        port_decoder_model.execute({"TOKENS": np.array([[1, 2]], np.int32)},
                                   {"sequence_id": 6})
    port_decoder_model.execute({"TOKENS": np.array([[3]], np.int32)},
                               {"sequence_id": 6, "sequence_end": True})


@pytest.mark.parametrize("inputs,params,match", [
    ({"TOKENS": np.zeros((1, 0), np.int32)}, {}, "empty prompt"),
    ({"TOKENS": np.zeros((1, 128), np.int32)}, {}, "max_len"),
    ({"TOKENS": np.ones((1, 2), np.int32), "MAX_TOKENS": np.array([0], np.int32)}, {}, "MAX_TOKENS"),
    ({"TOKENS": np.ones((1, 2), np.int32)}, {"chunk": 0}, "chunk"),
])
def test_generate_rejects_bad_requests(port_decoder_model, inputs, params, match):
    with pytest.raises(ValueError, match=match):
        list(TinyGenerateModel(decoder=port_decoder_model).execute_decoupled(inputs, params))


def test_generate_is_decoupled_only(port_decoder_model):
    with pytest.raises(ValueError, match="decoupled"):
        TinyGenerateModel(decoder=port_decoder_model).execute({}, {})


def test_sequences_do_not_share_state(port_decoder_model):
    alone_a, _ = _drive(port_decoder_model, [3, 4], n=4, seq_id=21)
    alone_b, _ = _drive(port_decoder_model, [7], n=4, seq_id=22)
    a = port_decoder_model.execute({"TOKENS": np.array([[3, 4]], np.int32)},
                                   {"sequence_id": 31, "sequence_start": True})
    b = port_decoder_model.execute({"TOKENS": np.array([[7]], np.int32)},
                                   {"sequence_id": 32, "sequence_start": True})
    toks_a, toks_b = [int(a["NEXT_TOKEN"][0, 0])], [int(b["NEXT_TOKEN"][0, 0])]
    for i in range(3):
        for seq, toks in ((31, toks_a), (32, toks_b)):
            out = port_decoder_model.execute(
                {"TOKENS": np.array([[toks[-1]]], np.int32)},
                {"sequence_id": seq, "sequence_end": i == 2})
            toks.append(int(out["NEXT_TOKEN"][0, 0]))
    assert (toks_a, toks_b) == (alone_a, alone_b)
    assert port_decoder_model.live_sequences() == 0


def test_attention_goes_through_the_kernel_op(monkeypatch, jax_params_np):
    """Every decode step calls ops.decode_attention once per layer, with the
    position as a device int32 tensor."""
    calls = []
    real = port_decoder.decode_attention

    def spy(q, k, v, pos):
        calls.append((tuple(q.shape), tuple(k.shape), pos.dtype, pos.device.type))
        return real(q, k, v, pos)

    monkeypatch.setattr(port_decoder, "decode_attention", spy)
    model = TinyDecoderModel(device="cpu", params=load_jax_params(jax_params_np, "cpu"))
    _drive(model, [1, 2, 3], n=3, seq_id=44)
    tokens_stepped = 3 + 2
    assert len(calls) == tokens_stepped * TinyDecoderModel.LAYERS
    assert set(calls) == {((1, 4, 32), (1, 4, 128, 32), torch.int32, "cpu")}


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_attention_impl_runs_the_kernel_op(monkeypatch, jax_decoder, jax_params_np, impl):
    """JAX's ``TinyDecoderModel(seed, attention_impl)``: the port takes the
    keyword in JAX's position, and both values run ops.decode_attention
    (the Hopper kernel on a CUDA device; "einsum", JAX's default, never
    goes around it), with JAX's tokens and logits within 5e-2 of JAX's
    model at the same value."""
    calls = []
    real = port_decoder.decode_attention
    monkeypatch.setattr(port_decoder, "decode_attention",
                        lambda *args: calls.append(1) or real(*args))
    model = TinyDecoderModel(0, impl, device="cpu", params=load_jax_params(jax_params_np, "cpu"))
    assert model.attention_impl == impl
    toks, logits = _drive(model, [1, 2, 3], n=4, seq_id=45)
    assert len(calls) == (3 + 3) * TinyDecoderModel.LAYERS
    ref = jax_decoder if impl == "einsum" else JaxDecoder(seed=0, attention_impl=impl)
    toks_j, logits_j = _drive(ref, [1, 2, 3], n=4, seq_id=45)
    assert toks == toks_j
    np.testing.assert_allclose(logits, logits_j, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["flash", "dense", ""])
def test_attention_impl_refused_as_jax(impl):
    """An unknown value raises JAX's ValueError, with JAX's message, before
    anything is built."""
    with pytest.raises(ValueError) as ours:
        TinyDecoderModel(attention_impl=impl, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxDecoder(attention_impl=impl)
    assert str(ours.value) == str(theirs.value) == f"unknown attention_impl {impl!r}"
