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
