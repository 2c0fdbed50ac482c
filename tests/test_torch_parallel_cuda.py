"""``client_tpu_torch.parallel`` on CUDA shards: what only a card can show.

Marked ``cuda``: each test skips without a card. On the card:
``python -m pytest -m cuda tests/test_torch_parallel_cuda.py``. This file
imports no JAX; it compares with plain PyTorch on the same card."""

import pytest
import torch

from client_tpu_torch import parallel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("read", ["numpy", "full_cpu"])
def test_card_shards_read_back_whole_on_the_host(card, read):
    """The shards are the outputs of matmuls still queued on the card when
    they are read back to the host: the host copy holds every element."""
    devices = [card] * 4
    a = torch.randn(4096, 4096, device=card)
    blocks = [a @ a + i for i in range(len(devices))]  # queued, not finished
    sharded = parallel.Sharded(blocks, 0)
    got = sharded.numpy() if read == "numpy" else sharded.full("cpu").numpy()
    want = torch.cat(blocks, 0).cpu().numpy()
    assert got.shape == (4 * 4096, 4096)
    assert (got == want).all()


def test_train_step_stays_on_the_card(card):
    """``sharded_train_step`` over dp 2 x tp 4 with every shard on the card:
    the loss, every leaf and its gradient stay there, and the update equals
    the one-shard step's (fp32, a linear classifier)."""
    import functools

    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn(32, 16, generator=gen) * 0.1
    x = torch.randn(16, 32, generator=gen).to(card)
    labels = torch.randint(0, 16, (16,), generator=gen).to(card)
    results = []
    for mesh in (parallel.Mesh([[card] * 4] * 2, ("data", "model")),
                 parallel.Mesh([[card]], ("data", "model"))):
        params = parallel.shard_params({"w": w0.to(card).requires_grad_(True)}, mesh)
        step = parallel.sharded_train_step(lambda p, xb: xb @ p["w"].full(),
                                           functools.partial(torch.optim.SGD, lr=0.5), mesh)
        params, _, loss = step(params, None, x, labels)
        leaves = parallel.train_leaves(params)
        assert loss.device.type == "cuda"
        assert all(t.device.type == "cuda" and t.grad.device.type == "cuda" for t in leaves)
        results.append((params["w"].full().detach().cpu(), float(loss)))
    assert torch.allclose(results[0][0], results[1][0], rtol=1e-5, atol=1e-6)
    assert abs(results[0][1] - results[1][1]) <= 1e-5
