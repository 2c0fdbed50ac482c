"""``InferInput.set_data_from_dlpack`` on a tensor on the card: the request
bytes equal the host tensor's, with one copy to the host.

Marked ``cuda``: each test skips without a card. On the card:
``python -m pytest -m cuda tests/test_torch_tensor_cuda.py``. This file
imports no JAX; the CPU tests hold the host path against the JAX package."""

import pytest
import torch

from client_tpu_torch._tensor import InferInput
from client_tpu_torch.http._utils import build_infer_body

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype,datatype", [(torch.float32, "FP32"), (torch.bfloat16, "BF16"),
                                            (torch.int64, "INT64")])
def test_card_tensor_stages_the_host_bytes(dtype, datatype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host = (torch.arange(24) % 7).to(dtype).reshape(4, 6)
    on_card = host.to("cuda")
    ours = InferInput("IN", [4, 6], datatype).set_data_from_dlpack(on_card)
    ref = InferInput("IN", [4, 6], datatype).set_data_from_dlpack(host)
    assert build_infer_body([ours]) == build_infer_body([ref])
    assert bytes(ours._raw_data) == host.view(torch.uint8).numpy().tobytes()
