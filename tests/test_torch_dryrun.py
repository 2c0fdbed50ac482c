"""``client_tpu_torch.dryrun`` against ``__graft_entry__``.

- ``dryrun_multichip(8, device="cpu")`` runs every check at JAX's tolerance
  and prints JAX's summary line: the mesh, batch, stage, sequence, head,
  expert and shard counts equal the line of JAX's own
  ``dryrun_multichip(8)`` on its eight virtual devices, and the served
  tokens for the prompt [1, 2, 3] equal JAX's but where the two greedy
  choices are a near tie (the port's top two logits within
  ``NEAR_TIE``, which is above the ~0.008 the two decoders' logits differ
  by on the CPU). The loss differs by design: each package draws its own
  densenet weights.
- ``entry(device="cpu")``: the forward of ``densenet_onnx`` (1000 classes,
  width 32) with JAX's weights carried across is within 2e-2 of JAX's
  ``entry()`` forward, on the example zero batch and on a random one.
"""

import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from client_tpu.models import vision as jax_vision
from client_tpu_torch import dryrun
from client_tpu_torch.models.decoder import TinyDecoderModel
from client_tpu_torch.models.vision import load_jax_params
from client_tpu_torch.server import ServerCore

NEAR_TIE = 1e-2
FIELDS = ("mesh", "devices", "batch", "pp_stages", "ring_seq", "ulysses_heads",
          "moe_experts", "served_tp_decode")


def _fields(line):
    body = line.split("dryrun_multichip: ", 1)[1]
    return dict(re.findall(r"(\w+)=(\{[^}]*\}|\[[^\]]*\]|\S+)", body))


BUILD_FLAX = jax_vision._build_flax_model


def _jitted_init(*args, **kwargs):
    """The flax module with its init traced under jit (the same params;
    run op by op it takes tens of seconds on the tests' CPU mesh)."""
    module = BUILD_FLAX(*args, **kwargs)
    object.__setattr__(module, "init", jax.jit(module.init))
    return module


def _port_gaps(prompt, n):
    """The port's decoder_lm top-two logit gap at each greedy step."""
    core = ServerCore([TinyDecoderModel(seed=0, device="cpu")], device="cpu")
    gaps, tok = [], None
    for i in range(n):
        arr = np.array([prompt] if i == 0 else [[tok]], np.int32)
        resp = core.infer("decoder_lm", "", {
            "inputs": [{"name": "TOKENS", "datatype": "INT32", "shape": list(arr.shape),
                        "array": arr}],
            "parameters": {"sequence_id": 5, "sequence_start": i == 0,
                           "sequence_end": i == n - 1}})
        outs = {o["name"]: np.asarray(torch.as_tensor(o["array"])) for o in resp["outputs"]}
        logits = np.sort(outs["LOGITS"].reshape(-1))[::-1]
        gaps.append(float(logits[0] - logits[1]))
        tok = int(outs["NEXT_TOKEN"].reshape(-1)[0])
    return gaps


def test_dryrun_multichip_matches_jax(capsys):
    with mock.patch.object(jax_vision, "_build_flax_model", _jitted_init):
        jax_entry.dryrun_multichip(8)
    theirs = _fields(capsys.readouterr().out.strip().splitlines()[-1])
    result = dryrun.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    ours = _fields(line)
    assert sorted(ours) == sorted(theirs)
    for key in FIELDS:
        assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    assert float(ours["loss"]) == pytest.approx(result["loss"], abs=1e-4)
    assert np.isfinite(result["loss"]) and 0 < result["loss"] < 10
    port_tokens, jax_tokens = result["tokens"], eval(theirs["tokens"])  # noqa: S307
    assert ours["tokens"] == str(port_tokens)
    gaps = _port_gaps([1, 2, 3], len(port_tokens))
    for step, (a, b, gap) in enumerate(zip(port_tokens, jax_tokens, gaps)):
        if gap >= NEAR_TIE:
            assert a == b, (step, port_tokens, jax_tokens, gaps)
        elif a != b:
            # a near tie may differ, and every later step follows it
            break
    assert result["fed_tokens"] == 6 and result["layers"] == 2
    # on the CPU the wrappers run their plain versions: no kernel launch
    assert result["decode_attention_launches"] == {"served": 0, "reference": 0}


def test_dryrun_mesh_factorises_as_make_mesh():
    mesh = dryrun.dryrun_mesh(8, device="cpu")
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    assert dict(dryrun.dryrun_mesh(6, device="cpu").shape) == {"data": 3, "model": 2}
    with pytest.raises(ValueError, match="only 8 available"):
        dryrun.dryrun_mesh(16, device="cpu")


def test_entry_matches_jax_with_its_weights():
    with mock.patch.object(jax_vision, "_build_flax_model", _jitted_init):
        jax_fn, (jax_params, jax_images) = jax_entry.entry()
    fn, (params, images) = dryrun.entry(device="cpu")
    assert tuple(images.shape) == tuple(jax_images.shape) == (4, 3, 224, 224)
    assert images.dtype == torch.float32 and not images.any()
    # carry JAX's weights into the port's model, then take its forward again
    model = dryrun.DenseNetModel(num_classes=1000, width=32, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax_params))
    fn, params = model.forward_fn()
    rng = np.random.default_rng(2)
    random = rng.standard_normal((4, 3, 224, 224)).astype(np.float32)
    for batch in (np.zeros((4, 3, 224, 224), np.float32), random):
        want = np.asarray(jax_fn(jax_params, batch))
        with torch.no_grad():
            got = fn(params, torch.from_numpy(batch)).numpy()
        assert got.shape == want.shape == (4, 1000) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-2)
