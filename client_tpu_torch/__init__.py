"""client_tpu_torch — the PyTorch/CUDA port of ``client_tpu``.

The KServe v2 client framework of ``client_tpu``, with its compute in
PyTorch on an NVIDIA GPU and its Pallas TPU kernels rewritten by hand in
CUDA C++ for Hopper. Module names follow ``client_tpu``'s, so each piece has
an obvious counterpart:

- ``client_tpu_torch.http`` and ``http.aio``: the HTTP/REST clients, sync
  and asyncio (health, metadata, infer, the generate extension,
  shared-memory registration, the repository, statistics, trace and log
  calls);
- ``client_tpu_torch.grpc`` and ``grpc.aio``: the GRPC clients, sync (with
  the bidi stream) and asyncio, over an own copy of the schema-driven wire
  codec;
- ``client_tpu_torch.utils``: dtype maps (numpy and torch) and the
  BYTES/BF16 wire serializers; ``utils.shared_memory`` (POSIX system
  shared memory) and ``utils.cuda_shared_memory`` (host window + device
  tensor cache: in one process a CUDA tensor crosses the API itself);
- ``client_tpu_torch.server``: the in-process v2 server (``ServerCore``, the
  threaded HTTP frontend and the GRPC frontend);
- ``client_tpu_torch.models``: ``simple``, the identity fixtures and the
  decoder family (``decoder_lm``, ``tiny_lm_generate``);
- ``client_tpu_torch.ops``: the hand-written kernels (``decode_attention``)
  with their plain PyTorch versions, built from ``csrc/`` at first use.

Entry points take a ``device`` that defaults to ``"cuda"``; pass
``device="cpu"`` to run on the CPU. This package never imports JAX or
``client_tpu``.
"""

__version__ = "0.1.0"
