"""The port's ``chain_*`` models against ``client_tpu.models.chain``.

The same RAW inputs, drawn from a numpy seed or picked at the edges of
int32 (negative values, values whose ``RAW * 31`` wraps), go through the JAX
models and the port's on the CPU. TOKENS and EMBED must be equal element for
element; SCORES within atol = rtol = 1e-5 (a 32-term fp32 dot product summed
in another order). Within the port, the staged chain equals ``chain_fused``
bit for bit, from host arrays and from torch tensors alike. The zoo carries
the four models in the JAX zoo's order over one shared core.
"""

import numpy as np
import pytest
import torch

from client_tpu.models import chain as jax_chain
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu_torch import pipeline as port_pipeline
from client_tpu_torch.models import chain as port_chain
from client_tpu_torch.models import default_model_zoo

SCORE_TOL = 1e-5
I32 = np.iinfo(np.int32)

RAWS = {
    "seeded_1x16": np.random.default_rng(0).integers(0, 5000, (1, 16)),
    "seeded_3x7": np.random.default_rng(1).integers(-10**6, 10**6, (3, 7)),
    "negative": -np.arange(1, 17).reshape(1, 16) * 997 - 3,
    "near_int32_max": np.array([[I32.max, I32.max - 1, I32.max // 31, I32.max // 31 + 1]]),
    "near_int32_min": np.array([[I32.min, I32.min + 1, I32.min // 31, I32.min // 31 - 1]]),
    "wraps": np.random.default_rng(2).integers(I32.min, I32.max, (2, 9), endpoint=True),
    "one_element": np.array([[0]]),
}


@pytest.fixture(scope="module")
def models():
    jax_core = jax_chain.ChainCore()
    port_core = port_chain.ChainCore(device="cpu")
    names = ("ChainTokenizeModel", "ChainEmbedModel", "ChainRerankModel", "ChainFusedModel")
    return ({n: getattr(jax_chain, n)(jax_core) for n in names},
            {n: getattr(port_chain, n)(port_core) for n in names})


def _np(value):
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def test_weights_are_the_jax_draw():
    jax_core, port_core = jax_chain.ChainCore(), port_chain.ChainCore(device="cpu")
    np.testing.assert_array_equal(port_core.table, jax_core.table)
    np.testing.assert_array_equal(port_core.proj, jax_core.proj)
    assert port_core.bias == jax_core.bias and port_core.bias.dtype == np.float32
    assert (port_chain.VOCAB, port_chain.EMBED_DIM) == (jax_chain.VOCAB, jax_chain.EMBED_DIM)
    assert port_pipeline.EMBED_DIM == port_chain.EMBED_DIM


@pytest.mark.parametrize("case", list(RAWS))
def test_chain_models_match_jax(models, case):
    jax_m, port_m = models
    raw = RAWS[case].astype(np.int32)
    tokens = port_m["ChainTokenizeModel"].execute({"RAW": raw}, {})["TOKENS"]
    ref_tokens = _np(jax_m["ChainTokenizeModel"].execute({"RAW": raw}, {})["TOKENS"])
    assert tokens.dtype == torch.int32 and tokens.shape == raw.shape
    np.testing.assert_array_equal(_np(tokens), ref_tokens)
    assert _np(tokens).min() >= 0 and _np(tokens).max() < port_chain.VOCAB

    embed = port_m["ChainEmbedModel"].execute({"TOKENS": ref_tokens}, {})["EMBED"]
    ref_embed = _np(jax_m["ChainEmbedModel"].execute({"TOKENS": ref_tokens}, {})["EMBED"])
    assert embed.dtype == torch.float32 and embed.shape == raw.shape + (port_chain.EMBED_DIM,)
    np.testing.assert_array_equal(_np(embed), ref_embed)

    scores = port_m["ChainRerankModel"].execute({"EMBED": ref_embed}, {})["SCORES"]
    ref_scores = _np(jax_m["ChainRerankModel"].execute({"EMBED": ref_embed}, {})["SCORES"])
    assert scores.dtype == torch.float32 and scores.shape == raw.shape
    np.testing.assert_allclose(_np(scores), ref_scores, atol=SCORE_TOL, rtol=SCORE_TOL)

    fused = port_m["ChainFusedModel"].execute({"RAW": raw}, {})["SCORES"]
    ref_fused = _np(jax_m["ChainFusedModel"].execute({"RAW": raw}, {})["SCORES"])
    np.testing.assert_allclose(_np(fused), ref_fused, atol=SCORE_TOL, rtol=SCORE_TOL)


@pytest.mark.parametrize("case", list(RAWS))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["host", "tensor"])
def test_staged_equals_fused_bit_for_bit(models, case, as_tensor):
    """Each stage's output handed on as a host array (the wire) or as the
    tensor itself (a colocated shm slab): the staged SCORES equal one
    ``chain_fused`` call's."""
    _, port_m = models
    raw = RAWS[case].astype(np.int32)
    feed = torch.from_numpy(raw) if as_tensor else raw
    hand = (lambda t: t) if as_tensor else _np
    tokens = port_m["ChainTokenizeModel"].execute({"RAW": feed}, {})["TOKENS"]
    embed = port_m["ChainEmbedModel"].execute({"TOKENS": hand(tokens)}, {})["EMBED"]
    scores = port_m["ChainRerankModel"].execute({"EMBED": hand(embed)}, {})["SCORES"]
    fused = port_m["ChainFusedModel"].execute({"RAW": feed}, {})["SCORES"]
    np.testing.assert_array_equal(_np(scores), _np(fused))


def test_model_signatures_match_jax(models):
    jax_m, port_m = models
    for name in jax_m:
        ours, theirs = port_m[name], jax_m[name]
        assert ours.name == theirs.name
        for a, b in ((ours.inputs(), theirs.inputs()), (ours.outputs(), theirs.outputs())):
            assert [(t.name, t.datatype, t.shape) for t in a] == \
                [(t.name, t.datatype, t.shape) for t in b]


def test_zoo_carries_the_chain_in_jax_order_over_one_core():
    chain_names = [m.name for m in jax_zoo() if m.name.startswith("chain_")]
    assert chain_names == ["chain_tokenize", "chain_embed", "chain_rerank", "chain_fused"]
    zoo = default_model_zoo("cpu")
    assert [m.name for m in zoo if m.name.startswith("chain_")] == chain_names
    cores = {id(m.core) for m in zoo if m.name.startswith("chain_")}
    assert len(cores) == 1
    core = next(m.core for m in zoo if m.name == "chain_fused")
    assert core is port_chain.chain_core("cpu") and core.device == torch.device("cpu")
