"""Entry points of the port: the single-device forward and the mesh dry run.

The counterpart of ``__graft_entry__.py`` (which stays the JAX package's):

- :func:`entry` gives the forward of the flagship vision model
  (``DenseNetModel(num_classes=1000, width=32)``, the ``densenet_onnx``
  contract) with an example (4, 3, 224, 224) fp32 batch.
- :func:`dryrun_multichip` runs, over an ``n_devices`` (data x model) mesh:
  one dp + tp training step of the width-8, 16-class densenet, the
  4-microbatch pipeline, ring and Ulysses attention over ``data``,
  ``moe_ffn`` over ``model``, and ``decoder_lm_tp`` served over ``model``
  through :class:`~client_tpu_torch.server.ServerCore`, whose greedy tokens
  must equal ``decoder_lm``'s. Each check holds JAX's tolerance, and the
  run prints JAX's summary line.

On the card the mesh takes the visible cards and repeats them when there
are fewer than ``n_devices`` (one H100 holds all eight shards); on the CPU
it takes :func:`~client_tpu_torch.parallel.local_devices`' eight entries.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List

import numpy as np
import torch

from . import parallel
from .models.decoder import TinyDecoderModel
from .models.decoder_tp import TPDecoderModel
from .models.vision import DenseNetModel, FunctionalDenseNet
from .ops.decode_attention import LAUNCHES as DECODE_LAUNCHES
from .parallel.moe import dense_moe_reference, moe_ffn
from .parallel.pipeline import mlp_stage_params, pipeline_forward, sequential_mlp
from .parallel.ring import full_attention, place_sharded, ring_attention
from .parallel.ulysses import ulysses_attention
from .server import ServerCore


def entry(device="cuda"):
    """``(fn, (params, images))``: the forward of the flagship vision model
    and a zero CHW fp32 batch of four 224 x 224 images, the fixture's wire
    layout (``fn(params, images)`` gives [4, 1000] fp32 logits)."""
    model = DenseNetModel(num_classes=1000, width=32, device=device)
    fn, params = model.forward_fn()
    images = torch.zeros((4, 3, 224, 224), dtype=torch.float32, device=device)
    return fn, (params, images)


def dryrun_mesh(n_devices: int, device="cuda") -> parallel.Mesh:
    """``parallel.make_mesh(n_devices)``; on the card with fewer cards than
    ``n_devices``, the cards repeat in the same (dp, tp) factorisation."""
    devices = parallel.local_devices(device)
    if torch.device(device).type != "cuda" or len(devices) >= n_devices:
        return parallel.make_mesh(n_devices, device=device)
    if not devices:
        raise RuntimeError("no CUDA device")
    tp = next((cand for cand in (4, 2) if n_devices % cand == 0), 1)
    grid = np.empty(n_devices, dtype=object)
    grid[:] = [devices[i % len(devices)] for i in range(n_devices)]
    return parallel.Mesh(grid.reshape(n_devices // tp, tp), ("data", "model"))


def _serve_tokens(core: ServerCore, model: str, prompt: List[int], n: int) -> List[int]:
    tokens, tok = [], None
    for i in range(n):
        arr = np.array([prompt] if i == 0 else [[tok]], np.int32)
        resp = core.infer(model, "", {
            "inputs": [{"name": "TOKENS", "datatype": "INT32", "shape": list(arr.shape),
                        "array": arr}],
            "parameters": {"sequence_id": 31, "sequence_start": i == 0,
                           "sequence_end": i == n - 1}})
        out = next(o for o in resp["outputs"] if o["name"] == "NEXT_TOKEN")
        tok = int(np.asarray(torch.as_tensor(out["array"]).cpu()).reshape(-1)[0])
        tokens.append(tok)
    return tokens


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, Any]:
    """One sharded training step and the mesh algorithms over an
    ``n_devices`` mesh (tiny shapes, as JAX's). Prints JAX's summary line and
    returns its values, with the decode_attention launches of the served
    decode and of its reference."""
    mesh = dryrun_mesh(n_devices, device)
    first = mesh.axis_devices("data")[0]
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)

    # the training step: width-8 densenet, 16 classes, batch 2 a device
    num_classes = 16
    module = FunctionalDenseNet(num_classes=num_classes, width=8)
    batch = n_devices * 2  # divisible by the data axis
    images = torch.from_numpy(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)).to(
        device=first, dtype=torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, num_classes, batch)).to(first)
    params = parallel.shard_params(module.init(0, images[:1]), mesh)
    step = parallel.sharded_train_step(module.apply,
                                       functools.partial(torch.optim.SGD, lr=1e-3), mesh)
    params, _, loss = step(params, None, images, labels)
    loss_val = float(loss)
    if not np.isfinite(loss_val):
        raise AssertionError(f"loss is {loss_val}")

    # pipeline parallelism over the model axis (GPipe microbatch streaming)
    n_stages = mesh.shape["model"]
    w, b = mlp_stage_params(0, n_stages=n_stages, dim=16)
    w, b = w.to(first), b.to(first)
    px = torch.randn((8, 16), generator=gen).to(first)
    pp_out = pipeline_forward(w, b, px, mesh, axis="model", n_microbatches=4)
    np.testing.assert_allclose(pp_out.cpu().numpy(), sequential_mlp(w, b, px).cpu().numpy(),
                               atol=1e-5)

    # context parallelism over the data axis (ring attention)
    dp = mesh.shape["data"]
    seq = max(8 * dp, 16)
    q = torch.randn((1, seq, 2, 8), generator=gen).to(first)
    rq = place_sharded(q, mesh, axis="data")
    ring_out = ring_attention(rq, rq, rq, mesh, axis="data").full(first)
    np.testing.assert_allclose(ring_out.cpu().numpy(), full_attention(q, q, q).cpu().numpy(),
                               atol=2e-5)

    # sequence parallelism via all-to-all head repartition (Ulysses)
    uq = torch.randn((1, seq, 2 * dp, 8), generator=gen).to(first)
    us = place_sharded(uq, mesh, axis="data")
    ulysses_out = ulysses_attention(us, us, us, mesh, axis="data").full(first)
    np.testing.assert_allclose(ulysses_out.cpu().numpy(),
                               full_attention(uq, uq, uq).cpu().numpy(), atol=2e-5)

    # expert parallelism over the model axis (all_to_all token dispatch)
    ep = mesh.shape["model"]
    n_tokens, d_model, n_experts = 8 * ep, 16, 2 * ep
    tokens_arr = torch.randn((n_tokens, d_model), generator=gen).to(first)
    gate_w = torch.randn((d_model, n_experts), generator=gen).to(first)
    ew1 = (torch.randn((n_experts, d_model, 32), generator=gen) * 0.1).to(first)
    ew2 = (torch.randn((n_experts, 32, d_model), generator=gen) * 0.1).to(first)
    moe_out = moe_ffn(tokens_arr, gate_w, ew1, ew2, mesh, axis="model").full(first)
    np.testing.assert_allclose(moe_out.cpu().numpy(),
                               dense_moe_reference(tokens_arr, gate_w, ew1, ew2).cpu().numpy(),
                               atol=2e-5)

    # served tensor-parallel decode: the same mesh's model axis drives a
    # head-sharded decoder behind the sequence protocol; its greedy tokens
    # must equal the single-device decoder's
    prompt, n_steps = [1, 2, 3], 4
    core = ServerCore([TPDecoderModel(seed=0, mesh=mesh, axis="model")], device=first)
    before = DECODE_LAUNCHES.count
    served = _serve_tokens(core, "decoder_lm_tp", prompt, n_steps)
    served_launches = DECODE_LAUNCHES.count - before
    ref_core = ServerCore([TinyDecoderModel(seed=0, device=first)], device=first)
    before = DECODE_LAUNCHES.count
    ref_toks = _serve_tokens(ref_core, "decoder_lm", prompt, n_steps)
    ref_launches = DECODE_LAUNCHES.count - before
    if served != ref_toks:
        raise AssertionError(f"served tokens {served} != decoder_lm's {ref_toks}")

    print(f"dryrun_multichip: mesh={dict(mesh.shape)} devices={n_devices} "
          f"batch={batch} loss={loss_val:.4f} pp_stages={n_stages} "
          f"ring_seq={seq} ulysses_heads={2 * dp} moe_experts={n_experts} "
          f"served_tp_decode={mesh.shape['model']}x tokens={served}", flush=True)
    return {"mesh": dict(mesh.shape), "devices": n_devices, "batch": batch, "loss": loss_val,
            "pp_stages": n_stages, "ring_seq": seq, "ulysses_heads": 2 * dp,
            "moe_experts": n_experts, "tokens": served,
            "fed_tokens": len(prompt) + n_steps - 1, "layers": TinyDecoderModel.LAYERS,
            "decode_attention_launches": {"served": served_launches,
                                          "reference": ref_launches}}


__all__ = ["dryrun_mesh", "dryrun_multichip", "entry"]
