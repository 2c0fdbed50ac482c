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
  the bidi stream and its ``auto_reconnect``) and asyncio, over an own copy
  of the schema-driven wire codec;
- ``client_tpu_torch.resilience``, ``observe``, ``flight`` and
  ``integrity``: the layers every client runs under (retries and circuit
  breakers, spans, metrics and the ``traceparent``, per-request flight
  timelines, response contract validation); ``client_tpu_torch.testing``:
  the chaos fault-injection proxy; ``admission``: the adaptive admission
  controller;
- ``client_tpu_torch.utils``: dtype maps (numpy and torch) and the
  BYTES/BF16 wire serializers; ``utils.shared_memory`` (POSIX system
  shared memory) and ``utils.cuda_shared_memory`` (host window + device
  tensor cache: in one process a CUDA tensor crosses the API itself; a
  DLPack producer over the window, ``utils._dlpack``);
- ``client_tpu_torch.arena``: the pooled shm arena (size-class slabs,
  ref-counted leases with their ``LeaseDigest``, cached registrations;
  families ``system`` and ``cuda``), which every client takes with
  ``configure_arena``;
- ``client_tpu_torch.perf``, ``genai_perf`` and ``trace``: the measurement
  harness (closed and open loops, trace replay, TTFT and inter-token
  latency) and its seeded, replayable workload traces;
- ``client_tpu_torch.server``: the in-process v2 server (``ServerCore`` with
  traceparent-joined access records, the threaded HTTP frontend with
  ``/metrics``, and the GRPC frontend);
- ``client_tpu_torch.models``: the default zoo (``simple``, the identity
  fixtures, the decoder family), ``long_context_encoder`` and the vision
  models;
- ``client_tpu_torch.ops``: the hand-written kernels (``decode_attention``,
  ``flash_attention``, ``normalize_image``, ``softmax_probabilities``,
  ``quantize_int8``, ``dequantize_int8``) with their plain PyTorch
  versions, built from ``csrc/`` at first use.

Entry points take a ``device`` that defaults to ``"cuda"``; pass
``device="cpu"`` to run on the CPU. This package never imports JAX or
``client_tpu``.
"""

__version__ = "0.1.0"
