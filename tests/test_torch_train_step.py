"""``parallel.sharded_train_step`` and the trainable densenet against JAX's.

The same numpy inputs through ``client_tpu.parallel.sharded_train_step``
(optax SGD) and the port's (``torch.optim.SGD``) on eight-position meshes
(the JAX tests' virtual CPU devices, the port's ``local_devices("cpu")``):

- an fp32 linear classifier at ``make_mesh(8)`` (dp 2 x tp 4): the updates
  equal within 1e-5;
- the width-8, 16-class densenet of ``__graft_entry__.dryrun_multichip``
  with JAX's ``module.init`` tree carried across by ``params_to_torch``:
  the logits within 2e-2 and the loss within 2e-2, and each leaf's update
  held by direction and size (see ``test_densenet_step_equals_jax``);
- the port's dp 2 x tp 4 step against its own one-shard step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from client_tpu.models.vision import _build_flax_model
from client_tpu.parallel import make_mesh as jax_make_mesh
from client_tpu.parallel import shard_params as jax_shard_params
from client_tpu.parallel import sharded_train_step as jax_train_step
from client_tpu_torch import parallel
from client_tpu_torch.models.vision import DenseNetish, FunctionalDenseNet, params_to_torch

LR = 1e-3
CLASSES, WIDTH, BATCH = 16, 8, 16


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def _numpy(leaf):
    if isinstance(leaf, parallel.Sharded):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.float32)


@pytest.fixture(scope="module")
def jax_densenet():
    """JAX's dry-run densenet: params from its init, one step of its
    sharded train step at make_mesh(8), and its logits, on bf16 images."""
    module = _build_flax_model(num_classes=CLASSES, width=WIDTH)
    rng = jax.random.PRNGKey(0)
    images = jax.random.normal(rng, (BATCH, 32, 32, 3), jnp.bfloat16)
    labels = jax.random.randint(rng, (BATCH,), 0, CLASSES)
    params = jax.jit(module.init)(rng, images[:1])  # jitted: eager init takes ~30 s here
    logits = np.asarray(jax.jit(module.apply)(params, images))
    mesh = jax_make_mesh(8)
    opt = optax.sgd(LR)
    placed = jax_shard_params(params, mesh)
    new, _, loss = jax_train_step(module.apply, opt, mesh)(placed, opt.init(placed), images,
                                                          labels)
    as_np = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float32))
    return {"params": as_np(params), "new": as_np(new), "loss": float(loss), "logits": logits,
            "images": torch.from_numpy(np.array(images.astype(jnp.float32)))
            .to(torch.bfloat16),
            "labels": torch.from_numpy(np.asarray(labels)).long()}


def _port_step(jax_densenet, mesh):
    module = FunctionalDenseNet(CLASSES, WIDTH)
    params = parallel.shard_params(params_to_torch(jax_densenet["params"], "cpu"), mesh)
    step = parallel.sharded_train_step(module.apply, functools.partial(torch.optim.SGD, lr=LR),
                                       mesh)
    params, opt, loss = step(params, None, jax_densenet["images"], jax_densenet["labels"])
    return params, opt, float(loss)


def test_linear_step_equals_jax():
    """fp32 throughout: a linear classifier whose 16 classes split over the
    four model shards, the batch over the two data shards; the updates
    and the loss equal JAX's within 1e-5."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((12, 16)).astype(np.float32) * np.float32(0.3)
    x = rng.standard_normal((16, 12)).astype(np.float32)
    labels = rng.integers(0, 16, 16)
    opt = optax.sgd(0.5)
    jmesh = jax_make_mesh(8)
    jparams = jax_shard_params({"w": jnp.asarray(w0)}, jmesh)
    new, _, jloss = jax_train_step(lambda p, xb: xb @ p["w"], opt, jmesh)(
        jparams, opt.init(jparams), jnp.asarray(x), jnp.asarray(labels, jnp.int32))

    mesh = parallel.make_mesh(8, device="cpu")
    params = parallel.shard_params({"w": torch.from_numpy(w0).requires_grad_(True)}, mesh)
    assert isinstance(params["w"], parallel.Sharded) and len(params["w"].shards) == 4
    step = parallel.sharded_train_step(lambda p, xb: xb @ p["w"].full(),
                                       functools.partial(torch.optim.SGD, lr=0.5), mesh)
    params, opt_state, loss = step(params, None, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(_numpy(params["w"]) - w0, np.asarray(new["w"]) - w0, atol=1e-5)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    # a second step reuses the optimizer it returned
    _, again, _ = step(params, opt_state, torch.from_numpy(x), torch.from_numpy(labels))
    assert again is opt_state


def test_shard_params_gives_trainable_leaves():
    """Every block of a split leaf and every copy is a leaf tensor of its
    own that requires grad, so the optimizer sees each shard."""
    mesh = parallel.make_mesh(8, device="cpu")
    tree = params_to_torch({"k": np.ones((3, 3, 2, 8), np.float32),
                            "b": np.zeros(8, np.float32)}, "cpu")
    placed = parallel.shard_params(tree, mesh)
    leaves = parallel.train_leaves(placed)
    assert len(leaves) == 4 + 1
    assert all(t.is_leaf and t.requires_grad for t in leaves)
    assert len({t.data_ptr() for t in leaves[:4]}) == 4
    frozen = parallel.shard_params({"k": torch.ones(2, 8)}, mesh)
    assert parallel.train_leaves(frozen) == []


def test_functional_densenet_forward_equals_jax(jax_densenet):
    """JAX's carried weights through ``FunctionalDenseNet.apply`` against
    the flax module (2e-2, JAX's bound) and against the served
    ``DenseNetish`` loaded with the same tree (the same ops in bf16)."""
    params = params_to_torch(jax_densenet["params"], "cpu", requires_grad=False)
    got = FunctionalDenseNet(CLASSES, WIDTH).apply(params, jax_densenet["images"]).numpy()
    np.testing.assert_allclose(got, jax_densenet["logits"], atol=2e-2)
    served = DenseNetish(CLASSES, WIDTH, device="cpu")
    served.load(jax_densenet["params"])
    with torch.no_grad():
        nchw = served(jax_densenet["images"].permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, nchw, atol=2e-2)


def test_densenet_step_equals_jax(jax_densenet):
    """One step of both packages at dp 2 x tp 4 from the same weights and
    batch. The loss is within 2e-2. Each leaf's update (new - old) is held
    by direction and size: cosine similarity >= 0.95 with JAX's, and no
    element more than 0.35 of the leaf's largest JAX update away. Both
    packages compute the densenet in bf16 (fp32 params), and their bf16
    convolutions round differently, so the gradients of the deeper leaves
    differ by up to ~27% of their largest element while pointing the same
    way (cosine >= 0.98 on this batch); the dense layer's, next to the
    loss, agree within 1%."""
    params, _, loss = _port_step(jax_densenet, parallel.make_mesh(8, device="cpu"))
    assert loss == pytest.approx(jax_densenet["loss"], abs=2e-2)
    before = _flat(jax_densenet["params"])
    theirs, ours = _flat(jax_densenet["new"]), _flat(params)
    assert sorted(theirs) == sorted(ours) and len(ours) == 30
    for name in sorted(before):
        d_jax = theirs[name] - before[name]
        d_port = _numpy(ours[name]) - before[name]
        cosine = float((d_jax * d_port).sum() / np.sqrt((d_jax ** 2).sum() * (d_port ** 2).sum()))
        assert cosine >= 0.95, (name, cosine)
        assert np.abs(d_port - d_jax).max() <= 0.35 * np.abs(d_jax).max(), name
        if name.startswith("/params/Dense_0"):
            assert np.abs(d_port - d_jax).max() <= 0.02 * np.abs(d_jax).max(), name


def test_densenet_step_dp_tp_equals_one_shard(jax_densenet):
    """The port's dp 2 x tp 4 step against its one-shard step on the same
    weights: the loss within 1e-5 and every update within 5% of the leaf's
    largest (the split batch and channels change only the bf16 order)."""
    params, _, loss = _port_step(jax_densenet, parallel.make_mesh(8, device="cpu"))
    one, _, one_loss = _port_step(jax_densenet, parallel.Mesh([["cpu"]], ("data", "model")))
    assert loss == pytest.approx(one_loss, abs=1e-5)
    before = _flat(jax_densenet["params"])
    for name, leaf in _flat(one).items():
        d_one = _numpy(leaf) - before[name]
        d_mesh = _numpy(_flat(params)[name]) - before[name]
        assert np.abs(d_mesh - d_one).max() <= 0.05 * np.abs(d_one).max(), name
