#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``client_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: every kernel under ``client_tpu_torch/csrc`` (decode_attention,
   flash_attention, normalize_image, quantize_int8, softmax) built from
   source with nvcc into ``build/torch_kernels/``, one compiler per source,
   with ptxas's lines (registers, static shared memory and spills) for each
   entry function, and the flash kernels' dynamic shared memory at each
   padded head dim;
3. kernels: each kernel wrapper against its plain PyTorch version on the
   card, with the kernel, the plain version and one PyTorch library call
   (where one computes the same function) timed by CUDA events beside the
   least time the card could take:
   - decode_attention at the reference test shapes, the decoder's shape,
     the batched decode step's (8, 4, 128, 32) at mixed positions (0, 127
     and an idle slot among them) and large cache shapes; split-K cases
     (positions on a split boundary, a position inside the first of many
     splits so the rest are empty, a cache length that splits unevenly) and
     a short cache in fp32, bf16 and fp16 at D = 32, 64 and 128, and at the
     head dims the kernel took last (``NEW_HEAD_DIMS``: 3, 8, 10, 24, 80,
     96, 256) on a ragged cache, a short one and a prime split one in every
     float dtype; the device time (profiler) of the large shapes beside the
     per-call time, and fp16 and D = 96 and 256 timed beside their bounds;
   - flash_attention in fp32 at the JAX tests' shapes, block pairs and
     causal settings (the result must not depend on the blocks), in bf16 at
     the JAX chip benchmark's (4, 2048, 8, 128), and at the served
     long_context_encoder shape (1, S, 4, 16) for S = 100, 4096, 8192, and
     at ragged lengths S = 1, 63, 65, 130 for D = 16, 32, 64, 128, every
     float dtype and both causal settings (the bf16 / fp16 tensor-core
     kernel and the fp32 kernels), at S = 1, 65, 130 for every head dim of
     ``NEW_HEAD_DIMS`` (rows of 3 and 10 elements are no whole 16-byte
     vector), fp32 at D = 33 and 42 (the 3xTF32 kernel's 4- and 8-byte row
     copies) and in fp16 at (4, 2048, 8, 128); in bf16 and fp16 also
     against the tiled plain version (p rounded before PV), at one ulp; in
     fp32 at head dims 33-256 also against the 3xTF32 emulation
     (``TF32_EMULATION_TOLERANCE``); timed at the wide encoder's (1, 8192,
     32, 96) and (1, 8192, 8, 256) and at (1, 4096, 8, 128) and (1, 4096, 8,
     64) in fp32 (bound: 3xTF32 at the TF32 peak, the FMA bound beside) and
     at S = 4096 in bf16 and fp16, beside SDPA;
   - the dtypes and head dims the attention kernels took last: integer and
     bool attention (bool, int8, uint8, int16, int32; the tiled kernels,
     JAX's key tiles in order) at block_k 128, 16 and 48, decode at (2, 2,
     300, 16) and flash at (2, 300, 2, 16) full and causal, and int8 past
     one slab of output columns, each against its tiled plain version
     element for element but where l's summation order explains a
     difference of 1 (counted and printed); head dims 257, 300, 512, 576
     and 1024 in fp32, bf16 and fp16, decode on a ragged and a prime split
     cache and at D = 2048, flash at (1, 130, 2, D) and (2, 40, 3, D) full
     and causal, and at D = 2048 and 2304 (two and three cluster groups of
     the wide kernels), within TOLERANCE of the dense plain versions; one
     launch counted a call; each flash case run twice with the same bits
     (no atomics), on the cluster size and groups ``wide_plan`` gives (the
     launch reports them); then each timed per call and on the device
     beside its bound, its plain version and, for float inputs, SDPA (none
     takes integer input), flash up to (1, 2048, 2, 2048);
   - quantize_int8 element-exact (exact half-steps, values past the clip;
     fp32, bf16 and fp16 in; uint8, int32, bool, int8 and int16 over their
     whole range) at (1, 8192), a ragged length, 64 MiB and an unaligned
     view; dequantize_int8 element-exact to fp32, bf16 and fp16 over every
     int8 value, at (1, 8192), a ragged length, one below and one above a
     whole word and a whole grid step, 64 MiB, and with the input off
     16-byte alignment, and from every other input dtype;
     ``torch.quantize_per_tensor`` timed as quantize's library call, with
     the count of its int8 values that differ from the kernel's;
   - normalize_image element-exact (fp32, uint8, bf16, fp16, int32, bool,
     int8 and int16 in; fp32, bf16 and fp16 out; INCEPTION and NONE) at
     (224, 224, 3), (7, 13,
     3), 64 MiB of fp32 and an unaligned view, int32 past 2**24, and every
     path one below and one above a whole vector and a whole grid step;
     softmax_probabilities within rtol 1e-5 at the served (1, 1000) and at
     (8, 1000), (3, 50) x 30, (1000,), bf16, a long row and (16384, 1000),
     then at widths from 1 to 8200 columns at 1, 8 and 16384 rows in fp32,
     bf16 and fp16, and at 1 and 8 rows in uint8, int32, bool, int8 and
     int16 (every variant, warps and vectors count of ``softmax_plan`` must
     occur), an unaligned row and rows of -inf, NaN and +inf; the new input
     dtypes of the four kernels timed at 16 Mi elements beside their bounds;
   - classification ties on the card: ``ops.topk_classification`` and the
     server's classification extension on tied rows (int32, float, all
     equal, bf16-rounded logits) and on rows without ties give the CPU's
     order, lowest index first (how ``torch.topk`` orders the same ties on
     the card is recorded); then ``ops.topk_classification`` (a stable
     sort) and ``torch.topk``, each alone and with its copies to the host,
     timed at (1, 1000), (64, 1000) and (16384, 1000): wall per call in
     interleaved rounds, and on the device (profiler);
   - no fallback: what JAX refuses on any device, a CUDA tensor refuses and
     launches nothing (float64 attention; flash block sizes the sequence
     cannot be cut into); decode and flash views off 16-byte alignment run
     on aligned copies and agree with the plain versions;
   - the small kernels (normalize, softmax, quantize, dequantize, and
     dequantize to bf16 at 64 MiB) and their library calls each timed per
     call, on the device (profiler) and, at the served shapes, on the host
     per call (enqueue, no sync), beside the card's write ceiling (``fill_``
     of 64 MiB); the host time of one
     normalize_image call split into its pieces, before and after the
     wrappers shared one launch path;
4. server: the port's HTTP server with its model zoo and
   ``long_context_encoder`` on the GPU, driven by the port's client, each
   path with every launch count set to 0 just before it and read just
   after:
   - ``simple`` over the wire; ``identity_fp32`` at 4 MiB and 64 MiB over
     the wire, system shared memory and colocated cuda shared memory;
     ``decoder_lm`` over the sequence API and ``tiny_lm_generate`` over
     ``generate_stream``, checked against a CPU run of the port with the
     same weights (decode_attention launches = tokens x layers);
   - ``decoder_lm_batched`` over HTTP to 8 concurrent sequences (prompts
     of 1-8 tokens, then 8 greedy continuations; the first window holds
     all 8 starts), each sequence's tokens equal to ``decoder_lm``'s on the
     card and to a CPU run's, logits within 5e-2, a round of width >= 4,
     decode_attention launches = rounds x layers; in process, a sequence
     at pos == MAX_LEN riding along untouched while another decodes;
     ``decoder_lm_prefill`` rows bit-equal to ``decoder_lm``; the disagg
     pair's KV handed over on the device through a colocated cuda shm
     region into ``ServerCore.infer_stream``, the stream equal to
     ``tiny_lm_generate``'s; batched rounds timed in process at 1, 2, 4
     and 8 active sequences, with the device time and idle share of a
     round at 8;
   - ``long_context_encoder`` (flash, dim 64, heads 4) at S = 100, 4096 and
     8192 over the wire and colocated cuda shared memory, checked against a
     CPU run of the port with the same weights (flash_attention launches =
     requests), with its request p50 by data plane;
   - the int8 wire path of ``examples/quantized_wire_client.py``: quantize
     on the card, INT8 through ``identity_int8``, dequantize, error within
     half a step (one quantize and one dequantize launch per round trip);
   - the vision path, ``build_image_ensemble`` at width 96 / 1000 classes
     (weights from seed 0) in a server of its own: the image_client flow
     (normalize on the card, ``densenet_onnx`` over the wire and colocated
     cuda shm, softmax of the logits in the output region) and the
     ensemble_image flow (raw UINT8 over the wire), each checked against a
     CPU run of the port with the same weights (top-1 equal, logits within
     5e-2; normalize launches = requests, softmax launches = calls), with
     the p50 of each plane and an in-process profile of densenet_onnx.

5. GRPC: the port's GRPC server over ``ServerCore(default_model_zoo("cuda"))``
   plus the vision models, driven by the port's GRPC clients, each path with
   every launch count set to 0 just before it and read just after:
   - ``simple``, then health, metadata, config, the repository index,
     unload and load, and statistics (success count = requests sent);
   - ``identity_fp32`` at 4 MiB and 64 MiB over the GRPC wire, system shm
     and colocated cuda shm (host windows all-zero), p50 beside HTTP's;
   - ``decoder_lm`` over one bidi stream, the tokens equal to the HTTP
     phase's and the CPU run's (decode_attention launches = tokens x
     layers);
   - ``decoder_lm_batched`` over 8 concurrent streams (the first window
     holding all 8 starts), each sequence's tokens equal to ``decoder_lm``'s
     on the card, a round of width >= 4 (launches = rounds x layers);
   - the image_client flow with input and logits in colocated cuda shm
     (normalize and softmax on the card; top-1 equal to the CPU run;
     normalize launches = requests, softmax launches = calls);
   - ``grpc.aio`` and ``http.aio`` (an HTTP frontend on the same core) each
     sending ``simple`` and ``identity_fp32`` (cuda shm) requests through
     ``asyncio.gather``, their outputs equal.

6. resilience and observability: the port's HTTP and GRPC servers over the
   default zoo plus the vision models, the port's ``testing.ChaosProxy`` in
   front of each, every client with contract validation on
   (``integrity``), a process-wide data-plane recorder; each path with every
   launch count set to 0 just before it and read just after, decode_attention
   launches held to what the server ran (its execution count and each
   request's tokens, times the layers):
   - the image_client flow (normalize and softmax on the card, the image over
     the wire) under ``flap`` and ``reset@N`` with a seeded ``RetryPolicy``:
     zero errors, top-1 equal to the CPU run;
   - a ``decoder_lm`` sequence under ``reset@N``: the faulted request makes
     one attempt and raises (never re-sent), the tokens before it equal the
     CPU run's;
   - ``decoder_lm`` over a GRPC bidi stream with ``auto_reconnect=True``
     under a reset: one ``StreamReconnected`` naming the in-flight sequence
     request as abandoned, the sequence re-driven to the CPU run's tokens, a
     ``StreamChecker`` on each wire stream's response ids;
   - a ``CircuitBreaker`` under ``blackhole``: it opens, fast-fails without
     a connection and is half-open probed once; the ``FlightRecorder``
     retains each failure the caller saw;
   - ``Telemetry`` at ratio 1.0 on identity_fp32 at 4 MiB (wire and
     colocated cuda shm), decoder_lm per token and the image_client flow
     (cuda shm): client phase p50s beside the server's queue and compute
     time, joined by trace id, and one request's ``compute_ns`` beside its
     device time from the profiler;
   - the hooks' host cost: identity_fp32 over cuda shm and decoder_lm per
     token with no hooks and with telemetry, resilience and integrity, in
     interleaved rounds;
   - ``/metrics`` counts equal to the statistics, the cuda data-plane
     counters equal to the creates, registers, destroys and requests made,
     zero integrity violations.

7. the measurement harness: the port's ``perf``, ``genai_perf`` and
   ``trace`` against its HTTP and GRPC servers over the default zoo, the
   image ensemble and ``long_context_encoder`` (``serve_harness``), each
   path with every launch count set to 0 just before it and read just
   after:
   - ``PerfRunner`` closed loops at concurrency 1, 2 and 4: identity_fp32
     at 4 MiB over shm none, system and cuda (and cuda over GRPC),
     ensemble_image at (224, 224, 3) and long_context_encoder at S = 8192
     over cuda shm (normalize_image launches = the ensemble's executions,
     flash_attention = the encoder's);
   - one poisson open loop on identity_fp32 over cuda shm at half the
     closed loop's rate at concurrency 1;
   - the replay of a seeded mixed trace (unary, sequence and streamed
     generations) over HTTP (decode_attention launches = the layers times
     the streams' prompt and generated tokens but the last);
   - ``GenAiPerfRunner``: decoupled ``tiny_lm_generate`` over GRPC,
     ``decoder_lm_batched`` sequences at 1 and 8 concurrent sessions
     (launches = rounds x layers) and the HTTP generate extension, the
     tokens received = sessions x output tokens;
   every row with 0 errors and the server's success count equal to the
   requests sent, the cuda arenas' regions equal to what their size
   classes need (not the requests), none resident after the arenas close.

8. the standalone server: ``client_tpu_torch.serve`` (``SERVE_ARGS``: the
   default zoo, identity_fp32, the image ensemble and long_context_encoder
   with flash) in processes of its own on the card, this process the client
   (``serve_process``); the child's ports come from port 0, read back from
   the lines it prints:
   - the threaded child: simple, identity_fp32 at 4 and 64 MiB over the
     wire, system shm and cuda shm with ``colocated=False`` (the host window
     crosses the processes; input window and output checked) over HTTP and
     GRPC; decoder_lm over the HTTP generate route and a GRPC stream,
     long_context_encoder at S = 8192 over cuda shm (2e-5) and
     ensemble_image (224, 224, 3) over cuda shm, each against a CPU run of
     the port with the same seed-0 weights (the same top-1); the int8 wire
     path (quantize and dequantize launched here, once a round trip); then
     ``PerfRunner`` closed loops at concurrency 1, 2, 4 and 8 on
     identity_fp32 4 MiB (cuda shm and the wire), ensemble_image and
     long_context_encoder (cuda shm), beside phase 7's in-process rows;
   - the aio child (``--http-frontend aio``): the same loops,
     ``GenAiPerfRunner`` on decoder_lm_batched at 8 sessions over GRPC and
     ``python -m client_tpu_torch.perf`` as a third process;
   - SIGTERM under load (4 clients on the encoder and the ensemble): inside
     serve's 1 s grace window HTTP ready 503, live 200, ``/metrics``
     ``client_tpu_server_ready 0`` and GRPC ``ServerReady`` false; every
     request completes with a correct output; exit 0 within 15 s;
   - each child's final report: its launches equal its executions
     (decode_attention = layers x tokens stepped or batched rounds,
     flash_attention = the encoder's, normalize_image = the ensemble's), on
     the card this process runs on.

9. the routing and serving layers: two ``serve`` children (``SERVE_ARGS``,
   threaded HTTP) started at once, this process the client of both
   (``serve_pool``), each output against the CPU run of the port:
   - round robin over HTTP: ensemble_image split evenly between them;
   - a decoder_lm sequence through ``PoolClient.infer`` pinned to one child;
   - ``routing="affinity"``: each key's encoder (S = 8192) requests on one
     child;
   - a ``HedgePolicy`` of delay 0 over the wire: both children execute;
   - ``PoolClient(...).caching()``: 16 identical encoder requests are one
     wire request and 15 collapsed, then 16 hits bit-equal to the miss;
   - ``.coalescing()`` on batched_matmul: 8 one-row calls in fewer
     executions, each row within 1e-5 of a solo call;
   - an ``AdmissionController`` from a two-tenant spec string: the metered
     tenant (5/s, burst 5) offered 40 requests in 1 s sheds at least 30 as
     ``over_quota`` with ``retry_after_s > 0``, the other none;
   - ``AioPoolClient`` over both GRPC ports: outputs equal row 1's;
   - ``PerfRunner`` on the encoder, one child and the pool of two, at
     concurrency 1, 2, 4 and 8 (readings);
   - SIGTERM to one child under 4 pool workers: 0 errors, one
     ``EndpointHealthChanged(healthy=False)``, then every request on the
     survivor; both exit 0, and each child's launches equal its executions.

10. the orchestration layers: four ``serve`` children (``SERVE_ARGS``,
   threaded HTTP) started at once, this process the client of all
   (``serve_orchestration``); the first two serve every row and drain at the
   end, the other two are SIGKILLed in rows 2 and 3; each output against
   the CPU run of the port with the same seeded weights:
   - ``DisaggClient``, the prefill role on child 1 and the decode role on
     child 2, over an arena pool (the KV slab in system shm, sent to the
     decode leg as a shared-memory reference on ``/generate_stream``): 3
     prompts of 16 tokens, 16 tokens each, equal to ``tiny_lm_generate``
     on child 1 and to the CPU run (but at a near tie), no region created
     and no registration issued after the first session, the same streams
     through ``AioDisaggClient``, a tampered slab refused as
     ``HandoffCorrupt`` before any token;
   - ``chain_pipeline()`` over the two children: SCORES bit-equal to
     ``chain_fused`` on child 1, no region or registration after the first
     run, each run's peak arena residency the plan's high water; a declared
     ``preprocess -> densenet_onnx`` pipeline on a (224, 224, 3) image:
     top-1 equal to the CPU run, logits within 5e-2, beside ensemble_image;
   - ``PerfRunner`` with ``shard_layout`` (decoder_lm_prefill, 8 x 16),
     ``roles`` and ``pipeline="chain"`` at concurrency 1 and 2 (20 a
     level), and the replay of a mixed trace with sharded, prefill_decode
     and pipeline records: 0 errors, the children's successes equal to the
     wire requests sent;
   - recovery: the decode leg on a victim child SIGKILLed after 4 tokens
     resumes on child 2 through re-prefill, every index once; a lone
     decode child killed mid-stream raises ``DecodeAbandoned`` naming it;
   - ``ShardedClient`` over children 1 and 2 on ``decoder_lm_prefill`` (8
     rows) and ``batched_matmul``: the gather bit-equal to the per-shard
     calls, NEXT_TOKEN equal to one call, logits within 5e-2; a layout
     with the SIGKILLed child as shard 1 raises ``ShardFailed`` naming it;
   - each drained child's launches equal its executions: decode_attention
     = layers x its decoder steps, normalize_image = its preprocess and
     ensemble_image executions.

11. federation, watch, doctor and the byzantine server: four ``serve``
   children (``SERVE_ARGS``, threaded HTTP) started at once, each behind a
   ``ChaosProxy`` of this process, as three cells: home (children 1 and 2,
   a ``ChaosCell``), away (child 3) and canary (child 4)
   (``serve_federation``); each output against the CPU run of the port:
   - ``FederatedClient`` on the encoder (S = 8192): every request served by
     home, no spill;
   - home blackholed after request 10 and healed after 25 of 40: 0 caller
     errors, each spilled request on child 3 with a typed ``CellSpill``,
     the spill counter in the registry's text, and the requests it took to
     return home;
   - a decoder_lm sequence pinned to home takes 4 tokens, then home resets:
     one ``CellSequenceAbandoned`` naming it, child 3 never steps it;
   - ``ShadowPolicy("away", ratio=1.0)``: every mirror matches bit for bit;
   - ``CanaryPolicy("canary", weight=0.5)`` under a latency SLO the healthy
     cells meet, then a latency fault on child 4's proxy: one
     ``CanaryRolledBack``, weight 0, 0 caller errors, child 4 idle after;
   - the port's ``ByzantineHttpServer`` in this process (the encoder on the
     card, shape_lie and truncate, seed 7) as the home cell ``liar``: its
     ``IntegrityError``s quarantine it and traffic spills to away, no
     corrupt output returned, this process's flash launches = its core's
     executions (the only row that launches here);
   - a ``Watchtower`` with a black box under ``build/`` over a pool of
     children 1 and 2: a latency fault on child 2's proxy trips it naming that
     URL (past 16 batches the row goes on only while the ``slo_burn`` alert
     fires, waiting for its flight divergence, 16 more at most); the ring
     gives back timelines, metrics and the alerts, and
     ``python -m client_tpu_torch.doctor --blackbox`` renders it;
   - ``PerfRunner`` with cells, home, shadow and canary cells and
     ``watch=True`` at concurrency 1 and 2: 0 errors, the children's
     successes = the requests sent plus their mirrors;
   - ``python -m client_tpu_torch.doctor --cells`` lists the three cells and
     exits 0; after child 4 is SIGKILLed, ``--fail-on-anomaly`` exits 1
     with ``cell_down`` naming canary;
   - children 1-3 drain, each child's launches equal its executions
     (decode_attention = layers x decoder steps, flash_attention = the
     encoder's).

12. the mesh models (``client_tpu_torch.parallel``) in this process
   (``serve_mesh``); every mesh's shards share the one card (``Mesh([cuda:0]
   * n)``), so no time here is a collective's cost; each row with the
   launch counts set to 0 just before it and read just after:
   - ``decoder_lm_tp`` (the decoder's full width) over meshes of 1, 2 and 4
     shards: three 6-token prompts and 5 greedy steps each, then a 4-way
     concurrent run; tokens and logits of every sequence bit-equal to
     ``decoder_lm``'s on the card, tokens equal to its CPU run but at a near
     tie, decode_attention launches = tokens x layers x shards; ms a token
     beside ``decoder_lm``'s;
   - the zoo's ``decoder_lm_tp_prefill`` over HTTP (its degree from the
     local devices) and a 4-shard one in process on 8 x 16 prompts: LOGITS
     and NEXT_TOKEN bit-equal to ``decoder_lm_prefill``'s, launches =
     tokens x layers x shards;
   - ``long_context_encoder`` in ring, ulysses and auto over 4 shards at
     S = 8192 against flash on the card, and at S = 256 against the CPU
     run in the same mode (atol = rtol = 2e-5), each mode's served p50
     beside flash's and its peak memory beside the reckoning; the causal
     ring and Ulysses against ``full_attention`` on (1, 1024, 4, 16);
   - ``moe_ffn`` over 4 shards (8 experts) over HTTP at 1024 tokens against
     the dense reference (2e-5); at half the busiest (shard, expert) load,
     each kept row the dense row and each dropped row 0; 1023 tokens a 400;
   - ``pipeline_forward``: 4 stages, 4 microbatches, within 1e-5 of
     ``sequential_mlp``;
   - ``densenet_onnx`` (1000 classes, width 96) at ``tensor_parallel=2``
     over 2 shards against tp = 1: top-1 equal, logits within 2e-2, p50s;
   - a ``serve`` child with ``--long-context --attention ring --moe
     --tensor-parallel 2 --vision``: the degrees it prints are those the
     card count gives, the encoder, ``moe_ffn`` and ``densenet_onnx``
     answer as the same models here, and it drains.

13. the training step, the dry run, multihost and ``entry()``
   (``serve_training``), each row with the launch counts set to 0 just
   before it and read just after:
   - ``dryrun.dryrun_multichip(8)`` over dp 2 x tp 4 with every shard on
     the card: the width-8 densenet's sharded step, the pipeline, ring,
     Ulysses, ``moe_ffn`` and the served ``decoder_lm_tp`` decode, whose
     tokens equal ``decoder_lm``'s; decode_attention launches = fed tokens
     x layers x shards (and x 1 for the reference decoder), nothing else;
   - the sharded training step at the served densenet's width (1000
     classes, width 96, 224 x 224, global batch 16, SGD 1e-3) at dp 2 x
     tp 4 and at one shard: the loss and every leaf's update of the first
     step against the one shard's, and the one-shard step at batch 2
     against the CPU's (``TRAIN_TOLERANCE``); ms a step, peak memory and
     one profiled step's device idle share for each layout;
   - ``python -m client_tpu_torch.parallel.multihost_check`` in a child
     through the ``CLIENT_TPU_*`` variables at world size 1 on NCCL: the
     global mesh, psum, the data-parallel step (rtol 2e-4 against the
     full-batch step), the train step, ring and Ulysses;
   - ``dryrun.entry()``: the (4, 1000) logits, a random batch within 5e-2
     of the CPU run with the same weights, the forward's p50.

14. the native clients and the embedded server (``serve_native``), each row
   with the launch counts set to 0 just before it and read just after:
   - (a) ``native_build.probe()`` (compilers, ``curl/curl.h``, ``zlib.h``,
     ``libcurl``, ``libz``, ``Python.h``, ``libpython``) and the builds with
     ``g++`` / ``gcc`` into ``build/torch_native/``, their seconds and
     command lines;
   - (b) the embed library dlopened in this process (``EmbeddedServer``, the
     C API of ``server_embed.h`` through ctypes) hosting ``simple`` and
     ``decoder_lm`` on the card: the prompt [1, 2, 3, 4] and 8 greedy
     steps, tokens and logits bit-equal to ``decoder_lm`` in this process,
     decode_attention launches = 12 tokens x 2 layers, the statistics
     counting the requests;
   - (c) ``csrc/embed_host.c`` as a child process hosting the same server on
     the card: exit 0, tokens and logits bit-equal to (b);
   - (d) where the probe finds curl's and zlib's headers: the native HTTP and
     gRPC clients against the port's HTTP and gRPC servers on the card:
     identity_fp32 at 4 MiB over the wire and over two
     ``NativeCudaShmRegion`` host windows (p50 beside phases 4 and 5's
     Python clients), ``long_context_encoder`` at S = 8192 over native cuda
     shm within 2e-5 of the CPU run, ``ensemble_image`` top-1 equal to the
     CPU run, a ``decoder_lm`` sequence over the native gRPC stream (tokens
     = phase 5's), ``PerfRunner`` with ``-i native-grpc --shared-memory
     cuda`` at concurrency 1, 2 and 4 (0 errors, the server's successes =
     the requests sent); launches = the server's executions. Where a header
     is missing, one line names it and (d) does not run.

15. The wide encoder (``serve_wide_encoder``): ``long_context_encoder``
   (flash, seed-0 weights) through ``ServerCore`` and the port's HTTP
   server in this process at two published widths whose head dims fill
   a padded width of the kernel, depth and width not cut: Phi-3-mini (dim 3072, 32
   heads, head dim 96) and Gemma-2B (dim 2048, 8 heads, head dim 256), at
   S = 8192 over colocated cuda shm, and at a width the JAX constructor
   takes whose head dim is past 256 (dim 2048, 4 heads, head dim 512; the
   wide flash kernel), at S = 1024; at each, over colocated cuda shm
   against the plain version (``flash_attention_reference`` between the
   same projections) on the card, with the p50 of 10 requests, one request
   profiled (device time and idle share) and, for the published widths,
   one request profiled in a process of its own (``WIDE_PROFILE_CHILD``: in
   this process the trace has held no kernel of phase 15 so far), and S =
   1024 over the wire against a CPU run of the port, each within 2e-5;
   flash_attention launches = the server's executions in each row and the
   statistics count the requests; the attention's and the projections'
   fp32 bounds beside the times, and the flash kernel alone at the row's
   attention shape, per call.

It then prints one ``{"kernels": [...]}`` line and, last, one line
``{"ok": true, "device": {...}}``. Details go to ``build/chip_smoke.json``.
Without a CUDA device it fails. The build fails if ptxas reports a spill in
the softmax, normalize or int8 kernels, in the two wide flash kernels or in
the fp32 flash kernel for head dims 33-256
(``--kernel-times`` prints the lines and goes on: it times earlier trees too).

``python3 chip_smoke.py --kernel-times`` builds the kernels and times the
small kernels, the wrappers' host cost and the two attention kernels at
the head dims and dtypes they ran before they took every float dtype and
head dim up to 256 (the same rows as phase 3) and, in a tree whose
wrappers take them, at the integer dtypes and head dims past 256
(``time_new_attention``), ending with one ``{"kernel_times": ...}`` line. It calls only the port's public wrappers,
so a copy of this file placed in an earlier tree of the port times that
tree, for a comparison inside one run.
"""

from __future__ import annotations

import asyncio
import collections
import ctypes
import functools
import json
import os
import queue
import random
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import client_tpu_torch.grpc as grpcclient  # noqa: E402
import client_tpu_torch.grpc.aio as grpc_aio  # noqa: E402
import client_tpu_torch.http as httpclient  # noqa: E402
import client_tpu_torch.http.aio as http_aio  # noqa: E402
import client_tpu_torch.ops.quantize as qz  # noqa: E402
from client_tpu_torch import ops  # noqa: E402
from client_tpu_torch.models import DenseNetModel, ImagePreprocessModel  # noqa: E402
from client_tpu_torch.models import LongContextEncoderModel, default_model_zoo  # noqa: E402
from client_tpu_torch.models import build_image_ensemble  # noqa: E402
from client_tpu_torch.models.vision import FunctionalDenseNet, draw_params  # noqa: E402
from client_tpu_torch.models.vision import flops_per_image, params_to_torch  # noqa: E402
from client_tpu_torch import dryrun  # noqa: E402
from client_tpu_torch import native, native_build  # noqa: E402
from client_tpu_torch.ops import normalize as nz  # noqa: E402
from client_tpu_torch.ops import softmax as sm  # noqa: E402
from client_tpu_torch.models.long_context import WEIGHTS, load_jax_params  # noqa: E402
from client_tpu_torch.models.chain import ChainFusedModel, chain_core  # noqa: E402
from client_tpu_torch.models.decoder import TinyDecoderModel  # noqa: E402
from client_tpu_torch.models.decoder_prefill import PrefillDecoderModel  # noqa: E402
from client_tpu_torch.models.decoder_tp import TPDecoderModel  # noqa: E402
from client_tpu_torch.models.moe import MoEFFNModel  # noqa: E402
from client_tpu_torch import parallel  # noqa: E402
from client_tpu_torch.parallel import Mesh  # noqa: E402
from client_tpu_torch.parallel import moe as parallel_moe  # noqa: E402
from client_tpu_torch.parallel import multihost  # noqa: E402
from client_tpu_torch.parallel import pipeline as parallel_pipeline  # noqa: E402
from client_tpu_torch.parallel import ring as parallel_ring  # noqa: E402
from client_tpu_torch.parallel import ulysses as parallel_ulysses  # noqa: E402
from client_tpu_torch.models.decoder_batched import _SeqRequest  # noqa: E402
from client_tpu_torch.models.generate import TinyGenerateModel  # noqa: E402
from client_tpu_torch.ops import _kernels  # noqa: E402
from client_tpu_torch.ops import decode_attention as da  # noqa: E402
# the module's names (ops.flash_attention itself is the function)
from client_tpu_torch.ops.flash_attention import LAUNCHES as FLASH_LAUNCHES  # noqa: E402
from client_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
    flash_attention_tiled_reference,
)
from client_tpu_torch import trace as trace_mod  # noqa: E402
from client_tpu_torch.flight import FlightRecorder  # noqa: E402
from client_tpu_torch.genai_perf import GenAiPerfRunner  # noqa: E402
from client_tpu_torch.integrity import IntegrityPolicy, IntegrityStats, StreamChecker  # noqa: E402
from client_tpu_torch.perf import PerfRunner  # noqa: E402
from client_tpu_torch.admission import AdmissionController, AdmissionRejected  # noqa: E402
from client_tpu_torch.pool import AioPoolClient, EndpointHealthChanged  # noqa: E402
from client_tpu_torch.pool import EndpointSpec, HedgePolicy, PoolClient  # noqa: E402
from client_tpu_torch.disagg import (  # noqa: E402
    AioDisaggClient,
    DecodeAbandoned,
    DisaggClient,
    HandoffCorrupt,
)
from client_tpu_torch.pipeline import Pipeline, PipelineClient, Stage, chain_pipeline  # noqa: E402
from client_tpu_torch.federation import (  # noqa: E402
    CanaryPolicy,
    CanaryRolledBack,
    CellSequenceAbandoned,
    CellSpill,
    FederatedClient,
    ShadowPolicy,
)
from client_tpu_torch.shard import ShardFailed, ShardLayout, ShardedClient  # noqa: E402
from client_tpu_torch.observe import (  # noqa: E402
    Telemetry,
    dataplane,
    enable_dataplane,
    install_dataplane,
)
from client_tpu_torch.resilience import (  # noqa: E402
    AttemptBudget,
    CircuitBreaker,
    CircuitOpenError,
    ResiliencePolicy,
    RetryPolicy,
    StreamReconnected,
    classify_fault,
)
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore  # noqa: E402
from client_tpu_torch.testing import ByzantineHttpServer, ChaosCell, ChaosProxy, Fault  # noqa: E402
from client_tpu_torch.utils import InferenceServerException  # noqa: E402
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402
from client_tpu_torch.utils import numpy_to_tensor, torch_to_triton_dtype  # noqa: E402
from client_tpu_torch.utils import shared_memory as shm  # noqa: E402
from client_tpu_torch.watch import Watchtower, blackbox_report, read_blackbox  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM bandwidth and dense peaks, per dtype
# (float32 at the CUDA cores' FMA rate: the port's fp32 kernels use no
# one-pass TF32), and the TF32 tensor-core peak: fp32 flash attention at
# head dims 33-256 runs in 3xTF32, three TF32 products for each product
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              # integer attention: 1-byte inputs at the int8 tensor-core peak
              # (exact products, int32 sums); int16 and int32 at the fp32
              # CUDA-core peak, the rate of the fp32 FMAs the tiled kernels
              # compute them with (no int16 or int32 tensor-core product)
              "bool": 1979e12, "int8": 1979e12, "uint8": 1979e12,
              "int16": 67e12, "int32": 67e12}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the small kernels' float types (fp16 too)
FLOATS = {**DTYPES, "float16": torch.float16}
# kernel against its plain version, per kernel and dtype:
# - decode_attention: max |out - ref| < tol (tests/test_decode_attention.py);
#   in fp16 2^-7: kernel and plain version both sum in fp32 (the kernel does
#   not round p) and round the output once, so they differ by the sums'
#   order and at most an output ulp or two (2^-8 at |out| < 4);
# - flash_attention: |out - ref| <= tol + tol * |ref| elementwise, the JAX
#   tests' atol = rtol (tests/test_utils.py: 2e-5 in fp32); in bf16 2e-2, as
#   the kernel rounds p to bf16 before PV and the output to bf16, where the
#   plain version keeps fp32; in fp16 atol 2^-9 * max|v| and rtol 2^-10
#   (FLASH_FP16, the CPU tests' bound against the Pallas kernel: p rounded to
#   fp16 moves the output by at most 2^-11 * max|v|, plus an output ulp);
# - quantize_int8 / dequantize_int8: element exact;
# - normalize_image: element exact (both round f32(x)*scale+shift once);
# - softmax_probabilities: rtol 1e-5, atol 1e-30 (tests/test_utils.py's
#   bound against JAX; exp and the sums differ in the last bits).
TOLERANCE = {
    "decode_attention": {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2.0 ** -7},
    "flash_attention": {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2.0 ** -9},
    "quantize_int8": 0.0,
    "dequantize_int8": 0.0,
    "normalize_image": 0.0,
    "softmax_probabilities": {"rtol": 1e-5, "atol": 1e-30},
}
# flash_attention in bf16 and fp16 against its tiled plain version (the
# same 64-key tiles, p rounded to the dtype before PV), elementwise
# |out - ref| <= atol + rtol * |ref|: rtol one output ulp (bf16 2^-7, fp16
# 2^-10, as the CPU tests hold the tiled version against the Pallas
# kernel), atol 2^-9, the largest difference seen on the card over every
# bf16 case (PERF.md): the two differ only in fp32 rounding, which flips a
# few p or outputs by one ulp
TILED_TOLERANCE = {"bfloat16": {"atol": 2.0 ** -9, "rtol": 2.0 ** -7},
                   "float16": {"atol": 2.0 ** -9, "rtol": 2.0 ** -10}}
# fp32 flash_attention at head dims 33-256 against its 3xTF32 emulation
# (flash_attention_3xtf32_reference: the same exact TF32 products),
# elementwise |out - emulation| <= atol + rtol * |emulation|, atol = rtol =
# half the dense gate: the two differ only in the order of their fp32 sums
# (the emulation normalises p before PV, the kernel after it) and in exp2
# against exp, while one-pass TF32 misses even the dense gate
# (tests/test_torch_flash_attention.py)
TF32_EMULATION_TOLERANCE = 1e-5
# the head dims the attention kernels took last (every D up to 256): JAX's
# test width 8, Pythia's 80, Phi-3-mini's 96, Gemma-2B's 256, 24, and rows
# that are no whole 16-byte vector (D = 3 and 10: 2-byte copies and 4-byte
# copies in bf16 and fp16, 4- and 8-byte in fp32)
NEW_HEAD_DIMS = (3, 8, 10, 24, 80, 96, 256)
# the integer and bool dtypes the attention kernels took last (the tiled
# kernels, JAX's key tiles in order), the block_k they are held at (48
# divides neither M = 300 nor S = 300), and the head dims past 256 they
# took last (the split kernel's widths 512 and 1024 and the flash kernels'
# slabs of 256 columns); decode also at WIDEST_DECODE_DIM (the split
# kernel's slabs of 1024 columns)
INTEGER_ATTENTION = {"bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
                     "int16": torch.int16, "int32": torch.int32}
INTEGER_BLOCKS = (128, 16, 48)
WIDE_HEAD_DIMS = (257, 300, 512, 576, 1024)
WIDEST_DECODE_DIM = 2048
# flash past what one cluster of the wide kernels covers (8 blocks of 128
# columns): two cluster groups at 2048, three at 2304, each recomputing QK^T
WIDEST_FLASH_DIMS = (2048, 2304)
ATTENTION_DTYPES = {**FLOATS, **INTEGER_ATTENTION}
# the kernels redesigned since their port, and how (their earlier times
# are in PERF.md)
REDESIGNED = {"decode_attention": "split-K over the cache",
              "flash_attention": "bf16 on the tensor cores; fp32 at head dims 33-256 on the "
                                 "tensor cores in 3xTF32; past D = 256 thread-block clusters, "
                                 "one QK^T pass",
              "normalize_image": "a lane per 16-byte output word",
              "softmax_probabilities": "rows held in registers",
              "dequantize_int8": "a lane per 16-byte output word (normalize's word loop)"}
# launch counters of the kernel wrappers, by kernel name
COUNTERS = {
    "decode_attention": da.LAUNCHES,
    "flash_attention": FLASH_LAUNCHES,
    "quantize_int8": qz.QUANTIZE_LAUNCHES,
    "dequantize_int8": qz.DEQUANTIZE_LAUNCHES,
    "normalize_image": nz.LAUNCHES,
    "softmax_probabilities": sm.LAUNCHES,
}

MIB = 1 << 20


def reset_counts() -> None:
    for counter in COUNTERS.values():
        counter.reset()


def read_counts():
    return {name: counter.count for name, counter in COUNTERS.items()}


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def demangle(names):
    """Readable names of mangled entry functions, by the CUDA toolkit's
    ``cu++filt -p``; the mangled names where it is missing."""
    tool = os.path.join(os.path.dirname(_kernels.nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return list(names)
    out = subprocess.run([tool, "-p", *names], capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_lines(name: str, log: str):
    """ptxas's registers / static shared memory line and its stack and
    spill line, per entry function of one source."""
    lines, entry = [], "?"
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            entry = found.group(1)
        elif "registers" in line or "spill" in line:
            lines.append((entry, line.strip()))
    entries = sorted({entry for entry, _ in lines})
    readable = dict(zip(entries, demangle(entries)))
    return [f"{name}: {readable[entry]}: {text}" for entry, text in lines]


def ptxas_spills(ptxas):
    """The ptxas lines that report a spill in a kernel the build holds to
    none: the softmax, normalize and int8 kernels, the two wide flash
    kernels and the fp32 flash kernel for head dims 33-256 (3xTF32)."""
    return [line for line in ptxas
            if (line.startswith(("softmax:", "normalize_image:", "quantize_int8:"))
                or re.match(r"flash_attention: .*(_wide_kernel|_f32_tc_kernel)\b", line))
            and re.search(r"[1-9]\d* bytes spill", line)]


def build_kernels(check_spills: bool = True):
    """Build every kernel; fail on a spill ptxas reports in the kernels
    held to none (``ptxas_spills``) unless ``check_spills`` is False
    (``--kernel-times``, which times whatever tree it sits in: an earlier
    tree's wide flash kernels spill)."""
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [line for name, text in logs.items() for line in ptxas_lines(name, text)]
    spills = ptxas_spills(ptxas)
    if spills and check_spills:
        raise AssertionError(f"ptxas spills in the softmax, normalize, int8, wide flash or "
                             f"fp32 3xTF32 flash kernels: {spills}")
    return seconds, ptxas


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 10000, batch: int = 100) -> float:
    """Median host time in microseconds to enqueue one call of ``fn`` (no
    synchronisation inside the timed call), over ``calls`` calls made in
    batches of ``batch``; the device is drained between batches, untimed,
    so the launch queue never fills."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls // batch):
        for _ in range(batch):
            t0 = time.perf_counter_ns()
            fn()
            times.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def sms() -> int:
    """The card's SM count (what the decode wrapper plans its splits for)."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def attention_inputs(batch, heads, max_len, dim, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((batch, heads, dim), generator=gen, device="cuda").to(dtype)
    k = torch.randn((batch, heads, max_len, dim), generator=gen, device="cuda").to(dtype)
    v = torch.randn((batch, heads, max_len, dim), generator=gen, device="cuda").to(dtype)
    return q, k, v


def attention_bound_ms(batch, heads, max_len, dim, positions, itemsize, dtype_name) -> float:
    """Least time: every live cache row, q and pos read once, the output
    written once, over the HBM rate — or the flops over the peak, if larger."""
    live = sum(min(p, max_len - 1) + 1 for p in positions) * heads
    nbytes = (2 * live * dim + 2 * batch * heads * dim) * itemsize + 4 * batch
    flops = 4 * live * dim
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]) * 1e3


def check_decode_attention():
    """Every case: the kernel against the plain version on the same inputs,
    in fp32, bf16 and fp16; the head dims of NEW_HEAD_DIMS at the reference
    test's ragged (3, 2, 200) with mixed positions, a short cache and a
    prime, split cache (4099 slots)."""
    dtypes = FLOATS
    tol = TOLERANCE["decode_attention"]
    cases = []
    for (b, h, m, d) in ((1, 4, 128, 32), (3, 2, 200, 64), (2, 8, 384, 128)):
        for p in (0, m - 1):
            for name in dtypes:
                cases.append(("reference", (b, h, m, d), [p] * b, name))
    # the reference test's own mixed positions within a batch
    for shape, positions in (((1, 4, 128, 32), [5]), ((3, 2, 200, 64), [0, 99, 199]),
                             ((2, 8, 384, 128), [100, 383])):
        for name in dtypes:
            cases.append(("reference", shape, positions, name))
    # the decoder's own shape at a mid-run position, and the batched step's
    # (B = slots) at mixed positions in both dtypes
    cases.append(("decoder", (1, 4, 128, 32), [11], "bfloat16"))
    # decoder_lm_tp's per-shard shapes (H/n heads at 2 and 4 shards) at a
    # mid-run position and at a full cache
    for h in (2, 1):
        for p in (63, 127):
            for name in dtypes:
                cases.append(("decoder_tp_shard", (1, h, 128, 32), [p], name))
    for name in dtypes:
        cases.append(("batched", BATCHED_SHAPE, BATCHED_POS, name))
    # one split over a cache so short that the kernel unrolls less: at M = 24
    # a lane group loads 1, 2 or 4 slots at a time, by D and dtype
    for d in (32, 64, 128):
        for name in dtypes:
            cases.append(("short_cache", (2, 2, 24, d), [23, 5], name))
    # split-K: 4099 slots (prime: every split boundary is ragged) with the
    # two sequences' last slots on either side of the first boundary, or one
    # at the end and one mid-way; 65536 slots in as many splits as the plan
    # allows with pos inside the first, so every other partial is empty
    for d in (32, 64, 128):
        for name in dtypes:
            first = da.split_bounds(4099, da.split_plan(2, 2, 4099, sms()))[1][0]
            cases.append(("split_boundary", (2, 2, 4099, d), [first - 1, first], name))
            cases.append(("split_ragged", (2, 2, 4099, d), [4098, 1366], name))
            cases.append(("split_first_of_many", (1, 1, 65536, d), [5], name))
    for d in NEW_HEAD_DIMS:
        for name in dtypes:
            cases.append(("new_head_dim", (3, 2, 200, d), [0, 99, 199], name))
            cases.append(("new_head_dim_short_cache", (2, 2, 24, d), [23, 5], name))
            cases.append(("new_head_dim_split_ragged", (2, 2, 4099, d), [4098, 1366], name))
    rows = []
    worst = {}
    for i, (kind, (b, h, m, d), positions, name) in enumerate(cases):
        q, k, v = attention_inputs(b, h, m, d, dtypes[name], seed=i)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        splits = da.split_plan(b, h, m, sms())
        out = da.decode_attention(q, k, v, pos)
        ref = da.decode_attention_reference(q, k, v, pos)
        split_ref = da.decode_attention_split_reference(q, k, v, pos, splits)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        split_err = (out.float() - split_ref.float()).abs().max().item()
        rows.append({"case": kind, "shape": [b, h, m, d], "pos": positions, "splits": splits,
                     "dtype": name, "max_abs_err": err, "max_abs_err_vs_split_plain": split_err,
                     "tol": tol[name]})
        worst[name] = max(worst.get(name, 0.0), err)
        if not (err < tol[name] and split_err < tol[name]) or out.dtype != q.dtype:
            raise AssertionError(f"decode_attention disagrees with its plain version: {rows[-1]}")

    # junk in the unwritten tail (slots > pos) must not leak into the output
    for name, dtype in dtypes.items():
        q, k, v = attention_inputs(1, 2, 96, 32, dtype, seed=100)
        pos = torch.tensor([40], dtype=torch.int32, device="cuda")
        base = da.decode_attention(q, k, v, pos)
        k[:, :, 41:] = 1e4
        v[:, :, 41:] = -1e4
        junk = da.decode_attention(q, k, v, pos)
        err = (base.float() - junk.float()).abs().max().item()
        rows.append({"case": "junk_tail", "shape": [1, 2, 96, 32], "pos": [40],
                     "dtype": name, "max_abs_err": err, "tol": 0.0})
        if err != 0.0:
            raise AssertionError(f"cache tail leaked into the output: {rows[-1]}")
        # pos 0 attends one slot: the output is v[:, :, 0]
        zero = da.decode_attention(q, k, v, torch.zeros(1, dtype=torch.int32, device="cuda"))
        err = (zero.float() - v[:, :, 0].float()).abs().max().item()
        rows.append({"case": "pos_zero", "shape": [1, 2, 96, 32], "pos": [0],
                     "dtype": name, "max_abs_err": err, "tol": tol[name]})
        if not err < tol[name]:
            raise AssertionError(f"pos 0 is not v[:, :, 0]: {rows[-1]}")
    return rows, worst


def time_decode_attention(shape, positions, iters, name="bfloat16"):
    """Kernel, plain version and the SDPA yardstick on the same inputs (bf16
    unless ``name`` says otherwise)."""
    b, h, m, d = shape
    q, k, v = attention_inputs(b, h, m, d, FLOATS[name], seed=7)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    out = da.decode_attention(q, k, v, pos)
    ref = da.decode_attention_reference(q, k, v, pos)
    err = (out.float() - ref.float()).abs().max().item()
    if not err < TOLERANCE["decode_attention"][name]:
        raise AssertionError(f"decode_attention {shape} pos {positions}: error {err}")
    mask = (torch.arange(m, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    row = {
        "shape": list(shape), "pos": positions, "dtype": name,
        "splits": da.split_plan(b, h, m, sms()),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: da.decode_attention(q, k, v, pos), iters),
        # both phases' device time per call (profiler)
        "device_ms": device_ms_per_call(lambda: da.decode_attention(q, k, v, pos),
                                        "decode_attention_", 20),
        "plain_ms": cuda_ms(lambda: da.decode_attention_reference(q, k, v, pos),
                            max(iters // 4, 3)),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask), iters),
        "bound_ms": attention_bound_ms(b, h, m, d, positions, q.element_size(), name),
    }
    return row


def flash_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))


def flash_agrees(out, ref, atol, rtol=None):
    """(max |out - ref|, every element within atol + rtol * |ref|; rtol =
    atol unless given)."""
    rtol = atol if rtol is None else rtol
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.float().abs()).all())


def flash_tolerance(name, v):
    """(atol, rtol) of flash_attention against its dense plain version in
    dtype ``name`` (TOLERANCE; in fp16 atol scales with max|v|)."""
    tol = TOLERANCE["flash_attention"][name]
    if name == "float16":
        return tol * v.float().abs().max().item(), 2.0 ** -10
    return tol, tol


def runs_3xtf32(dim, dtype_name) -> bool:
    """Whether this tree's flash_attention runs ``dtype_name`` at head dim
    ``dim`` in 3xTF32 (``runs_3xtf32`` of its module); a tree without that
    function (``--kernel-times`` in an earlier tree) runs fp32 on the CUDA
    cores."""
    runs = getattr(sys.modules["client_tpu_torch.ops.flash_attention"], "runs_3xtf32", None)
    return runs is not None and runs(dim, ATTENTION_DTYPES[dtype_name])


def flash_flops(shape, causal):
    """4*B*H*D flops per live (query, key) pair (S(S+1)/2 pairs when causal)."""
    b, s, h, d = shape
    return 4 * b * h * (s * (s + 1) // 2 if causal else s * s) * d


def flash_bound(shape, causal, dtype_name):
    """Least time and what sets it: q, k, v read once and the output written
    once over the HBM rate, or the flops (``flash_flops``) over the rate of
    the kernel's arithmetic, whichever is larger: the dtype's peak, and for
    fp32 at head dims 33-256 three TF32 products per product over the TF32
    tensor-core peak (``flash_bound_basis``)."""
    b, s, h, d = shape
    nbytes = 4 * b * s * h * d * ATTENTION_DTYPES[dtype_name].itemsize
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if runs_3xtf32(d, dtype_name):
        by_ops = 3 * flash_flops(shape, causal) / PEAK_TF32_FLOPS * 1e3
    else:
        by_ops = flash_flops(shape, causal) / PEAK_FLOPS[dtype_name] * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes else "bytes")


def flash_bound_basis(shape, causal, dtype_name):
    """What ``flash_bound``'s operations are counted at, and for the 3xTF32
    kernel the fp32 FMA bound beside it (the CUDA cores' rate)."""
    if runs_3xtf32(shape[3], dtype_name):
        return {"bound_basis": "3xTF32: 3 x flops over the 495 TFLOP/s TF32 peak",
                "fma_bound_ms": flash_flops(shape, causal) / PEAK_FLOPS["float32"] * 1e3}
    return {"bound_basis": f"flops over the {dtype_name} peak "
                           f"({PEAK_FLOPS[dtype_name] / 1e12:g} TFLOP/s)"}


def check_flash_attention():
    """The kernel against the plain version at every listed shape and mode;
    one input per (shape, dtype, causal), so the block pairs must give the
    very same output."""
    cases = [("reference", (2, 128, 2, 32), "float32", causal, blocks)
             for causal in (False, True) for blocks in ((128, 128), (64, 32), (32, 64))]
    cases += [("ragged", (1, 100, 2, 16), "float32", causal, (64, 64)) for causal in (False, True)]
    cases += [("chip_bench", (4, 2048, 8, 128), "bfloat16", causal, (128, 128))
              for causal in (False, True)]
    cases += [("served", (1, s, 4, 16), "float32", False, (128, 128)) for s in (100, 4096, 8192)]
    # ragged lengths around the 64-row tiles, every D, both dtypes (the bf16
    # tensor-core kernel, the fp32 kernels for D <= 32 and D >= 64)
    cases += [("ragged_tiles", (2, s, 3, d), name, causal, (128, 128))
              for name in ("bfloat16", "float16", "float32") for d in (16, 32, 64, 128)
              for s in (1, 63, 65, 130) for causal in (False, True)]
    cases += [("chip_bench", (4, 2048, 8, 128), "float16", causal, (128, 128))
              for causal in (False, True)]
    # the fp32 tensor-core kernel's row copies of 4 and 8 bytes (D = 33 and
    # 42; D = 40, 80 and the full widths copy 16)
    cases += [("tf32_copy_width", (2, s, 3, d), "float32", causal, (128, 128))
              for d in (33, 42) for s in (1, 65, 130) for causal in (False, True)]
    # the head dims the kernels took last, in every float dtype, at ragged
    # lengths (one row, a partial second tile, three tiles)
    cases += [("new_head_dim", (2, s, 3, d), name, causal, (128, 128))
              for name in FLOATS for d in NEW_HEAD_DIMS for s in (1, 65, 130)
              for causal in (False, True)]
    # here, not at the top: --kernel-times runs this file in trees without it
    from client_tpu_torch.ops.flash_attention import flash_attention_3xtf32_reference

    rows = []
    first = {}
    for kind, shape, name, causal, (bq, bk) in cases:
        q, k, v = flash_inputs(shape, FLOATS[name], seed=shape[1] + causal)
        out = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
        ref = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        atol, rtol = flash_tolerance(name, v)
        err, ok = flash_agrees(out, ref, atol, rtol)
        rows.append({"case": kind, "shape": list(shape), "dtype": name, "causal": causal,
                     "blocks": [bq, bk], "max_abs_err": err, "tol": [atol, rtol]})
        if name in TILED_TOLERANCE:
            # against the plain form of the kernel's loop (p rounded to v's
            # dtype before PV): in bf16 and fp16 a gate of its own, far
            # tighter than the dense version's
            tiled = flash_attention_tiled_reference(q, k, v, causal=causal)
            tiled_tol = TILED_TOLERANCE[name]
            tiled_err, tiled_ok = flash_agrees(out, tiled, tiled_tol["atol"], tiled_tol["rtol"])
            rows[-1]["max_abs_err_vs_tiled_plain"] = tiled_err
            if not tiled_ok:
                raise AssertionError(
                    f"flash_attention disagrees with its tiled plain version: {rows[-1]}")
        if runs_3xtf32(shape[3], name):
            # the 3xTF32 kernel against its emulation: a gate of its own,
            # half the dense one
            emulated = flash_attention_3xtf32_reference(q, k, v, causal=causal)
            emu_err, emu_ok = flash_agrees(out, emulated, TF32_EMULATION_TOLERANCE)
            rows[-1]["max_abs_err_vs_3xtf32"] = emu_err
            if not emu_ok:
                raise AssertionError(
                    f"flash_attention disagrees with its 3xTF32 emulation: {rows[-1]}")
        if not ok or out.dtype != q.dtype or not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention disagrees with its plain version: {rows[-1]}")
        key = (shape, name, causal)
        if key in first and not torch.equal(first[key], out):
            raise AssertionError(f"flash_attention depends on its block arguments: {rows[-1]}")
        first.setdefault(key, out)
    return rows


def time_flash_attention(shape, name, causal, iters):
    """Kernel, plain version and the SDPA yardstick on the same inputs."""
    q, k, v = flash_inputs(shape, FLOATS[name], seed=99)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_reference(q, k, v, causal=causal)
    err, ok = flash_agrees(out, ref, *flash_tolerance(name, v))
    if not ok:
        raise AssertionError(f"flash_attention {shape} {name} causal={causal}: error {err}")
    # SDPA takes [B,H,S,D]: the transposes are views of the same inputs
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = flash_bound(shape, causal, name)
    return {
        "shape": list(shape), "dtype": name, "causal": causal, "max_abs_err": err,
        **flash_bound_basis(shape, causal, name),
        "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal), iters),
        # the kernel's device time per call (profiler)
        "device_ms": device_ms_per_call(lambda: flash_attention(q, k, v, causal=causal),
                                        "flash_attention", 5),
        "plain_ms": cuda_ms(lambda: flash_attention_reference(q, k, v, causal=causal),
                            max(iters // 4, 3)),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def integer_attention_input(shape, name, gen):
    """Seeded integers in -7..8 (uint8 0..8, bool 0/1) on the card."""
    low, high = {"bool": (0, 2), "uint8": (0, 9)}.get(name, (-7, 9))
    x = torch.randint(low, high, shape, generator=gen, device="cuda", dtype=torch.int32)
    return x.bool() if name == "bool" else x.to(INTEGER_ATTENTION[name])


def tiled_mismatches(out, ref, quotient):
    """Elements where an integer kernel's output differs from its tiled plain
    version, and those of them no rounding explains. The two compute the
    same fp32 operations in the same order but l, the sum of p over a tile,
    which PyTorch reduces in another order: l may differ by a few ulps, and
    that moves trunc(acc / l) only where the plain version's quotient lies
    within 2^-18 (relative) of an integer, and then by 1. A mismatch
    elsewhere, or by more than 1, is a fault."""
    if out.dtype == torch.bool:
        diff = out != ref
        return int(diff.sum()), int(diff.sum())
    diff = (out.long() - ref.long()).abs()
    near = (quotient - quotient.round()).abs() <= quotient.abs().clamp_min(1.0) * 2.0 ** -18
    return int((diff > 0).sum()), int(((diff > 1) | ((diff == 1) & ~near)).sum())


def check_integer_attention():
    """Integer and bool attention on the card (the tiled kernels) against
    the tiled plain versions on the same inputs at JAX's tiles of block_k
    128, 16 and 48 keys: decode at (2, 2, 300, 16) with pos 150 and 299,
    flash at (2, 300, 2, 16) full and causal, every dtype of
    INTEGER_ATTENTION; then int8 past one slab of output columns (decode
    D = 1100, flash D = 300 at S = 300) at block_k 48. Element-exact but where
    ``tiled_mismatches`` explains a difference (counted); one launch a
    call."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = [("decode", (2, 2, 300, 16), name, None, bk)
             for name in INTEGER_ATTENTION for bk in INTEGER_BLOCKS]
    cases += [("flash", (2, 300, 2, 16), name, causal, bk)
              for name in INTEGER_ATTENTION for causal in (False, True) for bk in INTEGER_BLOCKS]
    cases += [("decode", (1, 2, 100, 1100), "int8", None, 48),
              ("flash", (1, 300, 2, 300), "int8", False, 48),
              ("flash", (1, 300, 2, 300), "int8", True, 48)]
    rows = []
    for op, shape, name, causal, bk in cases:
        if op == "decode":
            b, h, m, d = shape
            q = integer_attention_input((b, h, d), name, gen)
            k, v = (integer_attention_input(shape, name, gen) for _ in range(2))
            pos = torch.tensor([m // 2, m - 1][:b], dtype=torch.int32, device="cuda")
            before = da.LAUNCHES.count
            out = da.decode_attention(q, k, v, pos, block_k=bk)
            launches = da.LAUNCHES.count - before
            ref = da.decode_attention_tiled_reference(q, k, v, pos, bk)
            quotient = da.decode_attention_tiled_reference(q, k, v, pos, bk, torch.float32)
        else:
            q, k, v = (integer_attention_input(shape, name, gen) for _ in range(3))
            before = FLASH_LAUNCHES.count
            out = flash_attention(q, k, v, causal=causal, block_k=bk)
            launches = FLASH_LAUNCHES.count - before
            tile = min(bk, shape[1])
            ref = flash_attention_tiled_reference(q, k, v, causal, tile)
            quotient = flash_attention_tiled_reference(q, k, v, causal, tile, torch.float32)
        torch.cuda.synchronize()
        mismatches, unexplained = tiled_mismatches(out, ref, quotient)
        rows.append({"op": op, "shape": list(shape), "dtype": name, "causal": causal,
                     "block_k": bk, "launches": launches, "mismatches": mismatches,
                     "unexplained": unexplained,
                     "max_abs_err": (out.float() - ref.float()).abs().max().item()})
        if out.dtype != q.dtype or out.shape != q.shape or unexplained or launches != 1:
            raise AssertionError(f"{op}_attention {name} disagrees with its tiled plain "
                                 f"version: {rows[-1]}")
    return rows


def check_wide_attention():
    """Head dims past 256 in fp32, bf16 and fp16 against the dense plain
    versions (TOLERANCE): decode at WIDE_HEAD_DIMS on a ragged cache (2, 2,
    300, D) at pos 150 and 299 (one split) and a prime split one (2, 2,
    4099, D) at pos 4098 and 1366 (the merge of D columns), and at
    WIDEST_DECODE_DIM (two slabs of 1024 columns); flash at (1, 130, 2,
    D) full and causal (three key tiles, the last ragged) and at (2, 40, 3,
    D) (batch and heads > 1, one ragged key tile), for D in WIDE_HEAD_DIMS
    and WIDEST_FLASH_DIMS (two and three cluster groups), bf16 and fp16
    also against the tiled plain version (reported). One launch a call;
    ``kernels`` is how many kernels it ran (2 where decode merges). A flash
    case runs twice and must give the same bits both times (no atomics),
    on the cluster size and groups of ``wide_plan`` (the launch reports
    them, with the clusters the card holds at once), and the plan's shared
    memory must be the kernel's (``flash_attention_smem_bytes``)."""
    rows = []
    tol = TOLERANCE["decode_attention"]
    decode_cases = [((2, 2, m, d), positions) for d in WIDE_HEAD_DIMS
                    for m, positions in ((300, [150, 299]), (4099, [4098, 1366]))]
    decode_cases += [((2, 2, 300, WIDEST_DECODE_DIM), [150, 299])]
    for i, ((b, h, m, d), positions) in enumerate(decode_cases):
        for name, dtype in FLOATS.items():
            q, k, v = attention_inputs(b, h, m, d, dtype, seed=200 + i)
            pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
            before = da.LAUNCHES.count
            out = da.decode_attention(q, k, v, pos)
            launches = da.LAUNCHES.count - before
            ref = da.decode_attention_reference(q, k, v, pos)
            torch.cuda.synchronize()
            splits = da.split_plan(b, h, m, sms())
            err = (out.float() - ref.float()).abs().max().item()
            rows.append({"op": "decode", "shape": [b, h, m, d], "pos": positions, "dtype": name,
                         "splits": splits, "kernels": 2 if splits > 1 else 1,
                         "launches": launches, "max_abs_err": err, "tol": tol[name]})
            if not err < tol[name] or out.dtype != q.dtype or launches != 1:
                raise AssertionError(f"decode_attention disagrees with its plain version: "
                                     f"{rows[-1]}")
    # here, not at the top: --kernel-times runs this file in trees without it
    from client_tpu_torch.ops.flash_attention import wide_plan

    last_wide = _kernels.function("flash_attention", "flash_attention_last_wide_launch",
                                  [ctypes.POINTER(ctypes.c_int)] * 3)
    smem = _kernels.function("flash_attention", "flash_attention_smem_bytes",
                             (ctypes.c_int, ctypes.c_int))
    # (shape, seed): the cases held since the kernels took head dims past
    # 256 (seed D + causal), then the dims past one cluster group, and batch
    # and heads > 1 over one ragged key tile
    flash_cases = [((1, 130, 2, d), d) for d in WIDE_HEAD_DIMS + WIDEST_FLASH_DIMS]
    flash_cases += [((2, 40, 3, d), d + 7) for d in WIDE_HEAD_DIMS + WIDEST_FLASH_DIMS]
    for shape, seed in flash_cases:
        for name, dtype in FLOATS.items():
            for causal in (False, True):
                q, k, v = flash_inputs(shape, dtype, seed=seed + causal)
                before = FLASH_LAUNCHES.count
                out = flash_attention(q, k, v, causal=causal)
                launches = FLASH_LAUNCHES.count - before
                again = flash_attention(q, k, v, causal=causal)
                launches_again = FLASH_LAUNCHES.count - before - launches
                ref = flash_attention_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                plan = wide_plan(shape[3], dtype)
                ran = [ctypes.c_int() for _ in range(3)]
                last_wide(*(ctypes.byref(x) for x in ran))
                atol, rtol = flash_tolerance(name, v)
                err, ok = flash_agrees(out, ref, atol, rtol)
                row = {"op": "flash", "shape": list(shape), "dtype": name, "causal": causal,
                       "kernels": 1, "launches": launches, "max_abs_err": err,
                       "tol": [atol, rtol], "bits_equal_twice": torch.equal(out, again),
                       "plan": {"cluster": plan.cluster, "width": plan.width,
                                "groups": plan.groups, "block_q": plan.block_q,
                                "smem_bytes": plan.smem_bytes,
                                "kernel_smem_bytes": smem(_kernels.FLOAT_CODES[dtype],
                                                          shape[3])},
                       "launched": {"cluster": ran[0].value, "groups": ran[1].value,
                                    "active_clusters": ran[2].value}}
                if name in TILED_TOLERANCE:
                    tiled = flash_attention_tiled_reference(q, k, v, causal=causal)
                    row["max_abs_err_vs_tiled_plain"] = flash_agrees(out, tiled, 0.0)[0]
                rows.append(row)
                if (not ok or out.dtype != q.dtype or not torch.isfinite(out).all()
                        or (launches, launches_again) != (1, 1) or not row["bits_equal_twice"]
                        or (ran[0].value, ran[1].value) != (plan.cluster, plan.groups)
                        or plan.smem_bytes != row["plan"]["kernel_smem_bytes"]):
                    raise AssertionError(f"flash_attention disagrees with its plain version, "
                                         f"with itself or with its plan: {row}")
    return rows


def time_new_attention(iters: int = 10):
    """The cases the attention kernels took last, timed per call (CUDA
    events) and on the device (profiler) beside their bound, their plain
    version and, for float inputs, SDPA (none takes integer input): integer
    and bool decode at (8, 8, 4096, 128) full caches and flash at (1, 2048,
    4, 64) full and causal, block_k 128; fp32, bf16 and fp16 decode on full
    caches at every D of WIDE_HEAD_DIMS ((8, 8, 4096, D), D = 1024 at 4
    heads) and at WIDEST_DECODE_DIM ((4, 4, 4096, D)), and flash full and
    causal at (1, 1024, 4, D) (the served wide encoder's at D = 512) and
    (1, 2048, 2, 1024)."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(23)

    def timed(op, shape, name, kernel, plain, library, bound, extra):
        row = {"op": op, "shape": list(shape), "dtype": name, **extra,
               "ms": cuda_ms(kernel, iters),
               "device_ms": device_ms_per_call(kernel, f"{op}_attention", 5),
               "plain_ms": cuda_ms(plain, max(iters // 4, 2)),
               "library_ms": None if library is None else cuda_ms(library, iters)}
        row["bound_ms"], row["bound_by"] = bound
        rows.append(row)

    def decode_row(shape, name, q, k, v, positions, block_k=128):
        b, h, m, d = shape
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        dense = q.dtype.is_floating_point
        mask = (torch.arange(m, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        live = sum(min(p, m - 1) + 1 for p in positions) * h
        nbytes = (2 * live * d + 2 * b * h * d) * q.element_size() + 4 * b
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = 4 * live * d / PEAK_FLOPS[name] * 1e3
        timed("decode", shape, name, lambda: da.decode_attention(q, k, v, pos, block_k=block_k),
              (lambda: da.decode_attention_reference(q, k, v, pos)) if dense else
              (lambda: da.decode_attention_tiled_reference(q, k, v, pos, block_k)),
              (lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)) if dense
              else None,
              (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"),
              {"pos": positions, "block_k": None if dense else block_k})

    def flash_row(shape, name, q, k, v, causal, block_k=128):
        dense = q.dtype.is_floating_point
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        timed("flash", shape, name,
              lambda: flash_attention(q, k, v, causal=causal, block_k=block_k),
              (lambda: flash_attention_reference(q, k, v, causal=causal)) if dense else
              (lambda: flash_attention_tiled_reference(q, k, v, causal,
                                                       min(block_k, shape[1]))),
              (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)) if dense
              else None,
              flash_bound(shape, causal, name),
              {"causal": causal, "block_k": None if dense else block_k})

    for name in INTEGER_ATTENTION:
        shape = (8, 8, 4096, 128)
        q = integer_attention_input((8, 8, 128), name, gen)
        k, v = (integer_attention_input(shape, name, gen) for _ in range(2))
        decode_row(shape, name, q, k, v, [4095] * 8)
    for name in INTEGER_ATTENTION:
        shape = (1, 2048, 4, 64)
        q, k, v = (integer_attention_input(shape, name, gen) for _ in range(3))
        for causal in (False, True):
            flash_row(shape, name, q, k, v, causal)
    for name, dtype in FLOATS.items():
        for shape in [(8, 8, 4096, d) for d in WIDE_HEAD_DIMS if d < 1024] + [
                (8, 4, 4096, 1024), (4, 4, 4096, WIDEST_DECODE_DIM)]:
            q, k, v = attention_inputs(*shape, dtype, seed=shape[3])
            decode_row(shape, name, q, k, v, [shape[2] - 1] * shape[0])
        for shape in [(1, 1024, 4, d) for d in WIDE_HEAD_DIMS if d < 1024] + [
                (1, 2048, 2, 1024)] + ([(1, 2048, 2, WIDEST_FLASH_DIMS[0])]
                                       if name != "float16" else []):
            q, k, v = flash_inputs(shape, dtype, seed=shape[3])
            for causal in (False, True):
                flash_row(shape, name, q, k, v, causal)
    return rows


def new_cases(op, integer_rows, wide_rows):
    """The kernels line's record of every case of ``op`` that
    check_integer_attention and check_wide_attention held, a row a case
    under its fields (the line stays short; build/chip_smoke.json has each
    case in full)."""
    return {
        "integer": {"fields": ["dtype", "shape", "causal", "block_k", "mismatches"],
                    "rows": [[r["dtype"], r["shape"], r["causal"], r["block_k"], r["mismatches"]]
                             for r in integer_rows if r["op"] == op]},
        "wide": {"fields": ["dtype", "shape", "causal", "max_abs_err"],
                 "rows": [[r["dtype"], r["shape"], r.get("causal"),
                           float(f"{r['max_abs_err']:.4g}")]
                          for r in wide_rows if r["op"] == op]},
    }


def log_new_attention(checks, wide, timed_rows):
    """Phase 3's lines for the cases the attention kernels took last."""
    mismatched = [r for r in checks if r["mismatches"]]
    if checks:
        log(f"kernel attention integer and bool: {len(checks)} cases (decode and flash full / "
            f"causal; {', '.join(INTEGER_ATTENTION)}; block_k {INTEGER_BLOCKS}) against the "
            f"tiled plain versions: {sum(r['mismatches'] for r in checks)} elements differ "
            f"({sum(r['unexplained'] for r in checks)} unexplained) in {len(mismatched)} "
            "cases; one launch a call")
    for row in mismatched:
        log(f"  mismatch {row['op']} {row['shape']} {row['dtype']} causal={row['causal']} "
            f"block_k {row['block_k']}: {row['mismatches']} elements, max |diff| "
            f"{row['max_abs_err']:g} (l's order; within 2^-18 of an integer)")
    for row in wide:
        extra = ""
        if row["op"] == "decode":
            extra = f" pos {row['pos']} splits {row['splits']} ({row['kernels']} kernels)"
        else:
            extra = f" causal={row['causal']}"
            if "plan" in row:
                plan, ran = row["plan"], row["launched"]
                extra += (f"; cluster {ran['cluster']} (plan {plan['cluster']}) x groups "
                          f"{ran['groups']} (plan {plan['groups']}), slabs of <= {plan['width']} "
                          f"columns, {ran['active_clusters']} clusters at once; the same bits "
                          f"twice: {row['bits_equal_twice']}")
            if "max_abs_err_vs_tiled_plain" in row:
                extra += f"; vs the tiled plain version {row['max_abs_err_vs_tiled_plain']:.3g}"
        log(f"kernel {row['op']}_attention wide {row['shape']} {row['dtype']}{extra}: "
            f"max_abs_err {row['max_abs_err']:.3g} (tol {row['tol']}), {row['launches']} launch")
    for row in timed_rows:
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        mode = (f" causal={row['causal']}" if "causal" in row else "") + (
            f" block_k {row['block_k']}" if row.get("block_k") else "")
        log(f"time {row['op']}_attention {row['shape']} {row['dtype']}{mode}: kernel "
            f"{row['ms']:.4f} ms per call ({ms_text(row['device_ms'])} on the device), plain "
            f"{row['plain_ms']:.4f} ms, sdpa {library}, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} of bound)")


def quantize_inputs(n, dtype, scale, seed):
    """Seeded normals spread past the clip range, with exact half-steps
    (k + 0.5) * scale, +-127.5 * scale and far-out values mixed in."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda") * (60 * scale)
    special = torch.cat([
        torch.arange(-130, 130, device="cuda", dtype=torch.float32) + 0.5,
        torch.tensor([127.5, -127.5, 1e4, -1e4, 0.0], device="cuda"),
    ]) * scale
    m = min(n, special.numel())
    x[torch.randperm(n, generator=gen, device="cuda")[:m]] = special[:m]
    return x.to(dtype)


def check_quantize():
    """quantize_int8 and dequantize_int8 element-exact against their plain
    versions. Quantize: fp32, bf16 and fp16 in, a power-of-two scale (exact
    half-steps after the multiply) and the example's max/127 scale, at the
    wire shape, a ragged length (the scalar tail), 64 MiB of fp32 and a
    view one element off 16-byte alignment (the scalar way), each
    dequantized back to its own dtype. Dequantize: fp32, bf16 and fp16 out
    over every int8 value, at the wire shape, a ragged length, one below
    and one above a whole word and a whole step of the largest grid (a word
    for every thread), 64 MiB, and with the input one byte off alignment
    (the scalar way; the wrapper allocates its output aligned)."""
    rows = []
    for name, dtype in FLOATS.items():
        for n in (8192, 8195, 16 * MIB, "unaligned"):
            for scale_kind in ("pow2", "fit"):
                base = quantize_inputs(8196 if n == "unaligned" else n, dtype, 2.0 ** -5,
                                       seed=len(rows))
                x = base[1:] if n == "unaligned" else base
                scale = 2.0 ** -5 if scale_kind == "pow2" else x.float().abs().max().item() / 127
                q = qz.quantize_int8(x, scale)
                q_ref = qz.quantize_int8_reference(x, scale)
                back = qz.dequantize_int8(q, scale, dtype)
                back_ref = qz.dequantize_int8_reference(q, scale, dtype)
                torch.cuda.synchronize()
                row = {"n": n, "dtype": name, "scale": scale,
                       "quantize_mismatches": int((q != q_ref).sum().item()),
                       "dequantize_mismatches": bit_mismatches(back, back_ref)}
                rows.append(row)
                if row["quantize_mismatches"] or row["dequantize_mismatches"]:
                    raise AssertionError(f"int8 kernels disagree with their plain versions: {row}")
    # integer and bool input: the whole range with a scale of 2 (odd values
    # land on exact half-steps, which round to even) and the example's
    # max/127 scale, then dequantized back to fp32
    for name, dtype in ELEMENT_IN.items():
        if dtype.is_floating_point:
            continue
        for n in (8192, 8195, 16 * MIB, "unaligned"):
            gen = torch.Generator(device="cuda").manual_seed(len(rows))
            base = integer_input((8196 if n == "unaligned" else n,), dtype, gen)
            x = base[1:] if n == "unaligned" else base
            for scale in (2.0, max(x.float().abs().max().item(), 1.0) / 127):
                q = qz.quantize_int8(x, scale)
                q_ref = qz.quantize_int8_reference(x, scale)
                torch.cuda.synchronize()
                row = {"n": n, "dtype": name, "scale": scale,
                       "quantize_mismatches": int((q != q_ref).sum().item())}
                rows.append(row)
                if row["quantize_mismatches"]:
                    raise AssertionError(f"quantize_int8 disagrees with its plain version: {row}")
    every = torch.arange(-128, 128, dtype=torch.int8, device="cuda")
    for name, dtype in FLOATS.items():
        word = qz.dequantize_plan(1, dtype, True).elements
        step = word * nz.THREADS * qz.dequantize_plan(1 << 40, dtype, True, sms()).blocks
        for n in (8192, 8195, word - 1, word + 1, step - 1, step + 1, 16 * MIB, "unaligned"):
            length = 8193 if n == "unaligned" else n
            gen = torch.Generator(device="cuda").manual_seed(length)
            q = torch.randint(-128, 128, (length,), generator=gen, device="cuda",
                              dtype=torch.int8)
            q[:min(256, length)] = every[:min(256, length)]
            q = q[1:] if n == "unaligned" else q
            rows.append(dequantize_case(q, 0.37, name, n))
    # dequantize from every other input dtype, to each output dtype: around
    # a whole word and a whole grid step of its own plan, 16 Mi, unaligned
    for in_name, in_dtype in ELEMENT_IN.items():
        if in_dtype == torch.int8:
            continue
        for name, dtype in FLOATS.items():
            word = qz.dequantize_plan(1, dtype, True, in_dtype=in_dtype).elements
            step = word * nz.THREADS * qz.dequantize_plan(1 << 40, dtype, True, sms(),
                                                          in_dtype).blocks
            for n in (8195, word - 1, word + 1, step - 1, step + 1, 16 * MIB, "unaligned"):
                length = 8193 if n == "unaligned" else n
                q = image_input((length,), in_dtype, seed=length)
                q = q[1:] if n == "unaligned" else q
                rows.append(dequantize_case(q, 0.37, name, n, in_name))
    return rows


def dequantize_case(q, scale, out_name, n, in_name="int8"):
    """One dequantize_int8 call against its plain version; raises unless
    every element's bits agree."""
    out_dtype = FLOATS[out_name]
    out = qz.dequantize_int8(q, scale, out_dtype)
    ref = qz.dequantize_int8_reference(q, scale, out_dtype)
    torch.cuda.synchronize()
    row = {"n": n, "in": in_name, "out": out_name, "aligned": q.data_ptr() % 16 == 0,
           "mismatches": bit_mismatches(out, ref)}
    if row["mismatches"] or out.dtype != out_dtype or out.shape != q.shape:
        raise AssertionError(f"dequantize_int8 disagrees with its plain version: {row}")
    return row


def check_ties():
    """Classification ties on the card: ``ops.topk_classification`` and the
    server's classification extension (batched) on tied rows, against the
    same calls on the CPU (ties lowest index first, as the CPU tests hold
    them to ``jax.lax.top_k``): int32 and float rows with ties across k,
    all-equal rows, bf16-rounded logits (densenet's logits are bf16) and
    rows of four values, rows without ties, and a batch where two rows of
    eight tie at their maximum. Beside each: how many rows ``torch.topk`` on the
    card gives in another order (recorded, not gated: the port does not
    call it)."""
    from client_tpu_torch.server.core import _classification

    gen = torch.Generator().manual_seed(40)
    tied = {
        "int32": torch.tensor([[1, 3, 3, 1, 3], [2, 2, 0, 2, 2]], dtype=torch.int32),
        "float": torch.tensor([[0.5, 2.0, 0.5, 2.0, 2.0, -1.0], [1.0, 0.0, 1.0, 1.0, 0.0, 1.0]]),
        "all_equal": torch.zeros(3, 8),
        "bf16_logits": (torch.randn(16, 1000, generator=gen) * 0.05).bfloat16().float(),
        "four_values": torch.randint(0, 4, (16, 1000), generator=gen, dtype=torch.int32),
        "distinct": torch.randn(64, 1000, generator=gen),
        "mixed": torch.randn(8, 1000, generator=gen),
    }
    for row, at in ((1, 7), (4, 900)):  # two rows whose maximum also stands elsewhere
        tied["mixed"][row, at] = tied["mixed"][row].max()
    rows = []
    for name, x in tied.items():
        for k in (1, 3, 5):
            k = min(k, x.shape[-1])
            values, indices = ops.topk_classification(x, k)
            dev_values, dev_indices = ops.topk_classification(x.to("cuda"), k)
            torch_topk = torch.topk(x.to("cuda"), k).indices.cpu()
            row = {"rows": name, "shape": list(x.shape), "k": k,
                   "equal": bool(torch.equal(dev_indices.cpu(), indices)
                                 and torch.equal(dev_values.cpu(), values)),
                   "strings_equal": (_classification(x.to("cuda"), k, None, True).tolist()
                                     == _classification(x, k, None, True).tolist()),
                   "torch_topk_rows_in_another_order": int((torch_topk != indices).any(-1)
                                                           .sum().item())}
            rows.append(row)
            if not (row["equal"] and row["strings_equal"]):
                raise AssertionError(f"classification ties rank otherwise on the card: {row}")
    return rows


def interleaved_ms(calls, rounds: int, batch: int):
    """Wall time per call of each of ``calls`` (name -> function): in each
    of ``rounds`` rounds every function runs ``batch`` calls and a
    synchronize, in an order rotated round by round, so the host clock's
    drift falls on all of them alike. Returns name -> the rounds' times,
    sorted."""
    names = list(calls)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            for _ in range(batch):
                calls[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / batch * 1e3)
    return {name: sorted(t) for name, t in times.items()}


def time_classification(k: int = 5):
    """The classification extension's ranking on the card, fp32 logits,
    k = 5: ``ops.topk_classification`` (a stable sort cut to k) and
    ``torch.topk`` (its library call; it leaves the order of ties open),
    each alone and with its two copies to the host (the first is the
    extension's ranking, the second the one it had before it ranked ties
    as ``jax.lax.top_k``): wall time per call with the device drained
    (median and quartiles of interleaved rounds, ``interleaved_ms``) and
    the device time per call (profiler, every kernel and copy)."""
    from client_tpu_torch.server.core import _to_host

    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = []
    for shape in ((1, VISION_CLASSES), (64, VISION_CLASSES), (16384, VISION_CLASSES)):
        x = torch.randn(shape, generator=gen, device="cuda")
        calls = {"sort": lambda: ops.topk_classification(x, k),
                 "torch_topk": lambda: torch.topk(x, k, dim=-1),
                 "sort_to_host": lambda: [_to_host(t) for t in ops.topk_classification(x, k)],
                 "topk_to_host": lambda: [_to_host(t) for t in torch.topk(x, k, dim=-1)]}
        row = {"shape": list(shape), "k": k}
        wall = interleaved_ms(calls, rounds=21, batch=50 if shape[0] <= 64 else 5)
        for name, fn in calls.items():
            t = wall[name]
            row[name] = {"ms": statistics.median(t), "ms_quartiles": [t[5], t[15]],
                         "device_ms": device_ms_per_call(fn, "", 20)}
        rows.append(row)
    return rows


def check_no_fallback():
    """What the JAX functions refuse on any device, a CUDA tensor refuses
    too, and launches nothing (there is no fallback to the plain version):
    float64 attention (TypeError) and flash block sizes the sequence cannot
    be cut into (ValueError: (40, 128, 16) and (100, 64, 48) as (seq,
    block_q, block_k)). Then q, k and v views 2 or 4 bytes off 16-byte
    alignment run decode_attention and flash_attention on aligned copies,
    one launch each, within the plain versions' tolerance."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    f64, pos = torch.float64, torch.zeros(1, dtype=torch.int32, device="cuda")
    cases = [
        ("decode_attention float64", lambda: da.decode_attention(
            z(1, 1, 32, dtype=f64), z(1, 1, 8, 32, dtype=f64), z(1, 1, 8, 32, dtype=f64),
            pos), TypeError),
        ("flash_attention float64", lambda: flash_attention(
            *(z(1, 8, 2, 16, dtype=f64) for _ in range(3))), TypeError),
        ("flash_attention seq 40 blocks 128/16", lambda: flash_attention(
            *(z(1, 40, 2, 16) for _ in range(3)), block_q=128, block_k=16), ValueError),
        ("flash_attention seq 100 blocks 64/48", lambda: flash_attention(
            *(z(1, 100, 2, 16, dtype=torch.int8) for _ in range(3)), block_q=64, block_k=48),
         ValueError),
    ]
    reset_counts()
    rows = []
    for name, call, exc in cases:
        try:
            call()
        except exc as e:
            rows.append({"case": name, "raised": type(e).__name__, "message": str(e)})
        else:
            raise AssertionError(f"{name}: ran where it should raise")
    if any(read_counts().values()):
        raise AssertionError(f"a refused call launched a kernel: {read_counts()}")

    def off(t, elements):
        """A contiguous copy of ``t`` starting ``elements`` past an aligned
        allocation."""
        view = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")[elements:]
        return view[:t.numel()].view(t.shape).copy_(t)

    q, k, v = attention_inputs(2, 2, 300, 64, torch.bfloat16, seed=50)
    q, k, v = off(q, 1), off(k, 1), off(v, 1)
    positions = torch.tensor([40, 299], dtype=torch.int32, device="cuda")
    fq, fk, fv = (off(t, 1) for t in flash_inputs((1, 100, 2, 16), torch.float32, seed=51))
    checks = (
        ("decode_attention bf16 views 2 bytes off", da.LAUNCHES,
         lambda: da.decode_attention(q, k, v, positions),
         lambda: da.decode_attention_reference(q, k, v, positions),
         TOLERANCE["decode_attention"]["bfloat16"], (q, k, v)),
        ("flash_attention fp32 views 4 bytes off", FLASH_LAUNCHES,
         lambda: flash_attention(fq, fk, fv), lambda: flash_attention_reference(fq, fk, fv),
         TOLERANCE["flash_attention"]["float32"], (fq, fk, fv)),
    )
    for name, counter, kernel, plain, tol, views in checks:
        if not all(t.data_ptr() % 16 for t in views):
            raise AssertionError(f"{name}: the views are aligned")
        before = counter.count
        out = kernel()
        err = (out.float() - plain().float()).abs().max().item()
        row = {"case": name, "max_abs_err": err, "tol": tol,
               "launches": counter.count - before}
        rows.append(row)
        if not err < tol or row["launches"] != 1:
            raise AssertionError(f"{name} disagrees with its plain version: {row}")
    return rows


def quantize_library(x, scale, q):
    """``torch.quantize_per_tensor(x, scale, 0, torch.qint8)`` against the
    kernel's output ``q``: the count of int8 values that differ, and up to 8
    (kernel, library, x / scale) triples where they do. Its range is
    [-128, 127] where the kernel clips to +-127, and it may round x / scale
    where the kernel rounds x * f32(1 / scale)."""
    lib = torch.quantize_per_tensor(x, scale, 0, torch.qint8).int_repr()
    differ = (lib != q).nonzero().flatten()
    where = [(int(q.flatten()[i]), int(lib.flatten()[i]), x.flatten()[i].item() / scale)
             for i in differ[:8].tolist()]
    return int(differ.numel()), where


def time_quantize(n, iters):
    """Both kernels and their plain versions on n fp32 elements, beside the
    bytes bound. The yardstick for dequantize is ``q * scale``; for quantize
    ``torch.quantize_per_tensor(x, scale, 0, torch.qint8)``, whose int8
    values are counted against the kernel's on the timed input and, at n =
    8192, on the int8 wire path's own input: its time is ``library_ms``
    only where both give 0 mismatches. Each kernel and library call also
    has its device time (profiler) and, at n = 8192, its host time per
    call (enqueue, no sync). Beside dequantize at 16 Mi: the card's write
    ceiling, ``out.fill_(1.0)`` on as many fp32 elements (never called by
    the port)."""
    x = quantize_inputs(n, torch.float32, 0.03, seed=5)
    scale = x.abs().max().item() / 127
    q = qz.quantize_int8(x, scale)
    q_err = (q.int() - qz.quantize_int8_reference(x, scale).int()).abs().max().item()
    d_err = (qz.dequantize_int8(q, scale)
             - qz.dequantize_int8_reference(q, scale)).abs().max().item()
    if q_err or d_err:
        raise AssertionError(f"int8 kernels disagree at n = {n}: {q_err}, {d_err}")
    bound_ms = (4 * n + n) / PEAK_BYTES_PER_S * 1e3  # fp32 in/out, int8 out/in
    mismatches, where = quantize_library(x, scale, q)
    library = {"library_mismatches": mismatches, "library_mismatch_at": where}
    if n == 8192:
        wire = torch.from_numpy(np.random.default_rng(11).standard_normal((1, n)).astype(
            np.float32)).to("cuda")
        wire_scale = wire.abs().max().item() / 127
        library["library_mismatches_wire"], library["library_mismatch_at_wire"] = (
            quantize_library(wire, wire_scale, qz.quantize_int8(wire, wire_scale)))
    library["library_candidate_ms"] = cuda_ms(
        lambda: torch.quantize_per_tensor(x, scale, 0, torch.qint8), iters)
    exact = mismatches == 0 and library.get("library_mismatches_wire", 0) == 0
    calls = {  # kernel, its name in the profiler, plain version, library call, error
        "quantize": (lambda: qz.quantize_int8(x, scale), "::quantize_kernel",
                     lambda: qz.quantize_int8_reference(x, scale),
                     lambda: torch.quantize_per_tensor(x, scale, 0, torch.qint8), q_err),
        "dequantize": (lambda: qz.dequantize_int8(q, scale), "::dequantize_kernel",
                       lambda: qz.dequantize_int8_reference(q, scale), lambda: q * scale,
                       d_err),
    }
    row = {"n": n, "bytes_fp32": 4 * n, "scale": scale}
    for name, (kernel, kernel_name, plain, lib, err) in calls.items():
        row[name] = {
            "ms": cuda_ms(kernel, iters),
            "device_ms": device_ms_per_launch(kernel, kernel_name, 20),
            "plain_ms": cuda_ms(plain, iters),
            "library_device_ms": device_ms_per_call(lib, "", 20),
            "bound_ms": bound_ms, "max_abs_err": err}
        device_share(row[name])
        if n == 8192:
            row[name]["host_us"] = host_us(kernel)
            row[name]["library_host_us"] = host_us(lib)
    row["quantize"].update(library, library_ms=library["library_candidate_ms"] if exact else None)
    row["dequantize"]["library_ms"] = cuda_ms(lambda: q * scale, iters)
    if n >= 16 * MIB:
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        row["dequantize"]["write_ceiling"] = {
            "call": "out.fill_(1.0), fp32", "n": n,
            "ms": cuda_ms(lambda: out.fill_(1.0), iters),
            "device_ms": device_ms_per_call(lambda: out.fill_(1.0), "", 20),
            "bound_ms": 4 * n / PEAK_BYTES_PER_S * 1e3}
        device_share(row["dequantize"]["write_ceiling"])
    return row


def time_dequantize_to(n, out_dtype, iters):
    """dequantize_int8 to a 2-byte type at n elements: kernel, plain
    version and ``torch.mul(q, scale, out=o)`` with a bf16 or fp16 ``o``
    (one call: it multiplies in float32 and rounds to o's type, whose bits
    are counted against the kernel's, not assumed), per call and on the
    device (profiler), beside the bytes bound (n int8 in, 2n bytes out)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randint(-128, 128, (n,), generator=gen, device="cuda", dtype=torch.int8)
    scale = 0.37
    out = qz.dequantize_int8(q, scale, out_dtype)
    if bit_mismatches(out, qz.dequantize_int8_reference(q, scale, out_dtype)):
        raise AssertionError(f"dequantize_int8 to {out_dtype} disagrees at n = {n}")
    lib_out = torch.empty(n, dtype=out_dtype, device="cuda")

    def kernel():
        return qz.dequantize_int8(q, scale, out_dtype)

    def library():
        return torch.mul(q, scale, out=lib_out)

    library()
    mismatches = bit_mismatches(lib_out, out)
    candidate = cuda_ms(library, iters)
    row = {
        "n": n, "out": str(out_dtype).replace("torch.", ""), "max_abs_err": 0.0,
        "ms": cuda_ms(kernel, iters),
        "device_ms": device_ms_per_launch(kernel, "::dequantize_kernel", 20),
        "plain_ms": cuda_ms(lambda: qz.dequantize_int8_reference(q, scale, out_dtype), iters),
        "bound_ms": 3 * n / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_mismatches": mismatches, "library_candidate_ms": candidate,
        "library_device_ms": device_ms_per_call(library, "", 20),
        "library_ms": candidate if mismatches == 0 else None,
    }
    device_share(row)
    return row


INCEPTION = (2.0 / 255.0, -1.0)
NORMALIZE_IN = {"float32": torch.float32, "uint8": torch.uint8, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32}
# the input dtypes the four elementwise kernels took last: every other dtype
# of ops.PLAIN_DTYPES
NEW_ELEMENT_IN = {"bool": torch.bool, "int8": torch.int8, "int16": torch.int16}
# every input dtype of the four elementwise kernels
ELEMENT_IN = {**NORMALIZE_IN, **NEW_ELEMENT_IN}


def image_input(shape, dtype, seed):
    """Seeded pixel values 0..255 (uniform reals, truncated for uint8); for
    bool, int8 and int16 their whole range."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype in NEW_ELEMENT_IN.values():
        return integer_input(shape, dtype, gen)
    x = torch.rand(shape, generator=gen, device="cuda") * 255
    return x.to(torch.uint8) if dtype == torch.uint8 else x.to(dtype)


def integer_input(shape, dtype, gen, spread=None):
    """Seeded values of an integer or bool dtype: its whole range (0 and 1
    for bool), or -spread..spread."""
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen, device="cuda").bool()
    info = torch.iinfo(dtype)
    low, high = (info.min, info.max) if spread is None else (max(info.min, -spread), spread)
    return torch.randint(low, high + 1, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(dtype)


def bit_mismatches(a, b) -> int:
    """Elements whose bits differ (same dtype and shape)."""
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return int((a.view(ints) != b.view(ints)).sum().item())


def check_normalize():
    """normalize_image element-exact against its plain version: fp32, uint8,
    bf16, fp16, int32, bool, int8 and int16 in x fp32, bf16 and fp16 out,
    INCEPTION and NONE
    scaling, at the image_client's (224, 224, 3), a ragged (7, 13, 3), 64
    MiB of fp32 and an input one element off 16-byte alignment (the
    kernel's scalar path), and int32 spread past 2**24 (where its fp32 cast
    rounds); then, for every path (the widening uint8 -> fp32 / bf16 / fp16
    and bf16 -> fp32 among them), at lengths one below and one above a
    whole vector (the word a thread takes at a time) and a whole step of the
    largest grid (a word for every thread), where the word loop, its
    grid-stride step and the scalar tail meet."""
    rows = []
    for in_name, in_dtype in ELEMENT_IN.items():
        for shape in ((224, 224, 3), (7, 13, 3), (16 * MIB,), "unaligned"):
            base = image_input((4099,) if shape == "unaligned" else shape, in_dtype,
                               seed=len(rows))
            x = base[1:] if shape == "unaligned" else base
            for out_name in FLOATS:
                for mode, (scale, shift) in (("INCEPTION", INCEPTION), ("NONE", (1.0, 0.0))):
                    rows.append(normalize_case(x, shape, in_name, out_name, mode, scale,
                                               shift))
    gen = torch.Generator(device="cuda").manual_seed(24)
    wide = torch.randint(-2 ** 31, 2 ** 31 - 1, (8195,), generator=gen, device="cuda",
                         dtype=torch.int32)
    for out_name in FLOATS:
        rows.append(normalize_case(wide, (8195,), "int32 past 2**24", out_name, "odd", 0.37,
                                   0.5))
    plan = nz.normalize_plan
    for in_name, in_dtype in ELEMENT_IN.items():
        for out_name, out_dtype in FLOATS.items():
            vector = plan(1, in_dtype, out_dtype, True).elements
            step = vector * nz.THREADS * plan(1 << 40, in_dtype, out_dtype, True, sms()).blocks
            for n in (vector - 1, vector + 1, step - 1, step + 1):
                x = image_input((n,), in_dtype, seed=n)
                rows.append(normalize_case(x, (n,), in_name, out_name, "INCEPTION",
                                           *INCEPTION))
    return rows


def normalize_case(x, shape, in_name, out_name, mode, scale, shift):
    """One normalize_image call against its plain version; raises unless
    every element's bits agree."""
    out_dtype = FLOATS[out_name]
    out = ops.normalize_image(x, scale, shift, out_dtype)
    ref = nz.normalize_image_reference(x, scale, shift, out_dtype)
    torch.cuda.synchronize()
    row = {"shape": shape if isinstance(shape, str) else list(shape), "in": in_name,
           "out": out_name, "mode": mode, "mismatches": bit_mismatches(out, ref)}
    if row["mismatches"] or out.dtype != out_dtype or out.shape != x.shape:
        raise AssertionError(f"normalize_image disagrees with its plain version: {row}")
    return row


def time_normalize(shape, in_dtype, iters):
    """Kernel and plain version (INCEPTION, fp32 out) beside the bytes bound.
    The yardstick ``torch.add(shift, x, alpha=scale)`` computes x * scale +
    shift in one call (the 0-dim fp32 ``shift`` makes a uint8 ``x`` give
    float32 too); whether it gives the kernel's single rounding is counted,
    not assumed. Kernel and yardstick each have their device time
    (profiler) and, below 1 Mi elements, their host time per call (enqueue,
    no sync)."""
    x = image_input(shape, in_dtype, seed=3)
    scale, shift = INCEPTION
    out = ops.normalize_image(x, scale, shift, torch.float32)
    err = bit_mismatches(out, nz.normalize_image_reference(x, scale, shift, torch.float32))
    if err:
        raise AssertionError(f"normalize_image {shape} {in_dtype}: {err} mismatches")
    n = x.numel()
    shift_t = torch.tensor(shift, device="cuda")

    def kernel():
        return ops.normalize_image(x, scale, shift, torch.float32)

    def library():
        return torch.add(shift_t, x, alpha=scale)

    row = {
        "shape": list(shape), "in": str(in_dtype).replace("torch.", ""), "out": "float32",
        "max_abs_err": 0.0,
        "ms": cuda_ms(kernel, iters),
        "device_ms": device_ms_per_launch(kernel, "normalize_kernel", 20),
        "plain_ms": cuda_ms(lambda: nz.normalize_image_reference(x, scale, shift,
                                                                 torch.float32), iters),
        "bound_ms": n * (x.element_size() + 4) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }
    device_share(row)
    lib = library()
    if lib.dtype != torch.float32:
        raise AssertionError(f"torch.add(shift, x, alpha=scale) gave {lib.dtype} for {in_dtype}")
    row["library_mismatches"] = bit_mismatches(lib, out)
    row["library_candidate_ms"] = cuda_ms(library, iters)
    row["library_device_ms"] = device_ms_per_call(library, "", 20)
    if row["library_mismatches"] == 0:
        row["library_ms"] = row["library_candidate_ms"]
    if n < MIB:
        row["host_us"] = host_us(kernel)
        row["library_host_us"] = host_us(library)
    return row


def check_softmax():
    """softmax_probabilities against its plain version within rtol 1e-5
    (atol 1e-30): the served (1, 1000), a batch (8, 1000), tests/
    test_utils.py's (3, 50) x 30, 1-D (1000,), bf16 (8, 1000), a long row
    (4, 5000), a bytes-sized (16384, 1000), fp16 (8, 1000); then every
    width in SOFTMAX_COLS at 1, 8 and 16384 rows in fp32, bf16 and fp16
    (every variant of softmax_plan and every warps and vectors count it
    picks, which must all occur), and a row 4 bytes off 16-byte
    alignment. Special rows (all -inf,
    a -inf prefix, a NaN, a +inf) in each variant must give what the plain
    version gives (NaN where it does)."""
    from client_tpu_torch.ops.softmax import softmax_plan

    rows = []
    cases = [((1, 1000), "float32", 1.0), ((8, 1000), "float32", 1.0),
             ((3, 50), "float32", 30.0), ((1000,), "float32", 1.0),
             ((8, 1000), "bfloat16", 1.0), ((4, 5000), "float32", 1.0),
             ((16384, 1000), "float32", 1.0), ((8, 1000), "float16", 1.0)]
    cases += [((r, c), name, 4.0) for name in FLOATS for r in (1, 8, 16384)
              for c in SOFTMAX_COLS]
    # integer and bool logits (values -20..20, 0..20 for uint8, 0 and 1 for
    # bool; the whole range at (8, 1000)): every width at 1 and 8 rows, and
    # (16384, 1000)
    integers = [name for name, dtype in ELEMENT_IN.items() if not dtype.is_floating_point]
    cases += [((r, c), name, 20) for name in integers for r in (1, 8) for c in SOFTMAX_COLS]
    cases += [((16384, 1000), name, 20) for name in integers]
    cases += [((8, 1000), name, None) for name in integers]
    cases.append(("unaligned", "float32", 4.0))
    seen = set()
    for i, (shape, name, stretch) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(i)
        if shape == "unaligned":
            x = (torch.randn(8 * 1000 + 1, generator=gen, device="cuda") * stretch)[1:]
            x = x.view(8, 1000)
        elif name in FLOATS:
            x = (torch.randn(shape, generator=gen, device="cuda") * stretch).to(FLOATS[name])
        else:
            x = integer_input(shape, ELEMENT_IN[name], gen, stretch)
        cols = x.shape[-1]
        plan = softmax_plan(x.numel() // cols, cols, x.dtype, x.data_ptr() % 16 == 0, sms())
        seen.update({("variant", plan.variant), ("warps", plan.warps),
                     (f"vectors {name}", plan.vectors if plan.variant == "registers" else 0)})
        rows.append(softmax_case(x, shape, name, stretch, plan))
    want = ({("variant", v) for v in ("registers", "two_pass", "scalar")}
            | {("warps", w) for w in (1, 2, 4, 8)}
            | {("vectors float32", v) for v in (1, 2, 4, 8)}
            | {(f"vectors {name}", v) for name in ("bfloat16", "float16") for v in (1, 2, 4)}
            | {(f"vectors {name}", v) for name in ("uint8", "int8", "bool") for v in (1, 2)}
            | {("vectors int16", v) for v in (1, 2, 4)}
            | {("vectors int32", v) for v in (1, 2, 4, 8)})
    if want - seen:
        raise AssertionError(f"softmax checks never ran {sorted(want - seen)}")
    inf, nan = float("inf"), float("nan")
    for cols in (8, SOFTMAX_COLS[-1], SOFTMAX_COLS[-3]):  # registers, two_pass, scalar
        x = torch.randn((5, cols), generator=torch.Generator().manual_seed(cols))
        x[0] = -inf
        x[1, : cols // 2 + 1] = -inf
        x[2, cols // 3] = nan
        x[3, cols - 1] = inf
        x = x.to("cuda")
        plan = softmax_plan(5, cols, x.dtype, True, sms())
        out = ops.softmax_probabilities(x)
        ref = sm.softmax_probabilities_reference(x)
        tol = TOLERANCE["softmax_probabilities"]
        if not torch.allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"], equal_nan=True):
            raise AssertionError(f"softmax_probabilities of special rows ({plan}) differs: "
                                 f"{out[:, :4]} vs {ref[:, :4]}")
        rows.append({"shape": [5, cols], "dtype": "float32", "scale": 1.0,
                     "case": "special rows: -inf, a -inf prefix, NaN, +inf",
                     "variant": plan.variant, "warps": plan.warps, "vectors": plan.vectors,
                     "nan_rows": int(out.isnan().all(-1).sum().item())})
    return rows


# softmax widths that reach every variant: whole rows in registers up to
# REGISTER_COLS (8192; one warp or several, 1-8 vectors a thread), scalar
# where a row is not a whole number of 16-byte vectors (1, 3, 2049, 8193;
# in bf16 also 8196), two passes one bf16 vector past the register width
SOFTMAX_COLS = (1, 3, 8, 1000, 1024, 2048, 2049, 4096, 5000, 8192, 8193, 8196, 8200)


def softmax_case(x, shape, name, stretch, plan):
    """One softmax_probabilities call against its plain version; raises
    unless every probability is within rtol 1e-5 (atol 1e-30)."""
    tol = TOLERANCE["softmax_probabilities"]
    out = ops.softmax_probabilities(x)
    ref = sm.softmax_probabilities_reference(x)
    torch.cuda.synchronize()
    rel = ((out - ref).abs() / ref.abs().clamp_min(tol["atol"])).max().item()
    row = {"shape": shape if isinstance(shape, str) else list(shape), "dtype": name,
           "scale": stretch, "variant": plan.variant, "warps": plan.warps,
           "vectors": plan.vectors, "max_rel_err": rel,
           "max_abs_err": (out - ref).abs().max().item(), "rtol": tol["rtol"]}
    if (out.dtype != torch.float32 or out.shape != x.shape
            or not torch.allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"])):
        raise AssertionError(f"softmax_probabilities disagrees with its plain version: {row}")
    return row


def time_softmax(shape, iters):
    """Kernel, plain version and ``torch.softmax(x, -1, dtype=float32)``
    beside the bytes bound (each logit read once, each probability written
    once, fp32): per call (CUDA events), on the device (profiler) and, at
    one row, on the host per call (enqueue, no sync)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(shape, generator=gen, device="cuda") * 4
    out = ops.softmax_probabilities(x)
    ref = sm.softmax_probabilities_reference(x)
    tol = TOLERANCE["softmax_probabilities"]
    if not torch.allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"]):
        raise AssertionError(f"softmax_probabilities {shape} disagrees with its plain version")

    def kernel():
        return ops.softmax_probabilities(x)

    def library():
        return torch.softmax(x, -1, dtype=torch.float32)

    row = {
        "shape": list(shape), "dtype": "float32",
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": cuda_ms(kernel, iters),
        "device_ms": device_ms_per_launch(kernel, "softmax_", 20),
        "plain_ms": cuda_ms(lambda: sm.softmax_probabilities_reference(x), iters),
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": device_ms_per_call(library, "", 20),
        "bound_ms": 8 * x.numel() / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    device_share(row)
    if shape[0] == 1:
        row["host_us"] = host_us(kernel)
        row["library_host_us"] = host_us(library)
    return row


def profiled_kernels(fn, kernel_name, runs):
    """The kernels whose names hold ``kernel_name`` in a torch.profiler
    trace of ``runs`` calls of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return [k for k in device_kernels(prof) if kernel_name in k["name"]]


def device_ms_per_call(fn, kernel_name, runs):
    """Device time per call of ``fn`` in the kernels named ``kernel_name``
    (every phase a call launches), over the calls the trace holds: the most
    launches of any one such kernel (a call launches each at most once;
    the profiler has dropped the first of 5 calls' kernels); None if the
    trace has none."""
    hits = profiled_kernels(fn, kernel_name, runs)
    return sum(k["total_ms"] for k in hits) / max(k["count"] for k in hits) if hits else None


def device_ms_per_launch(fn, kernel_name, runs):
    """Device time alone per launch of the kernel named ``kernel_name``
    over ``runs`` calls of ``fn`` (the CUDA event time of back-to-back
    wrapper calls includes the host's launch cost, which dominates at small
    sizes); None if the trace has none."""
    hits = profiled_kernels(fn, kernel_name, runs)
    launches = sum(k["count"] for k in hits)
    return sum(k["total_ms"] for k in hits) / launches if launches else None


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------


def p50_ms(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def drive_identity(client, nbytes: int, iters: int, mod=httpclient):
    """identity_fp32 over the wire, system shm and colocated cuda shm, through
    ``client`` of the client module ``mod`` (HTTP or GRPC)."""
    n = nbytes // 4
    shape = [1, n]
    x = torch.arange(n, dtype=torch.float32, device="cuda").reshape(shape) * 0.5
    x_host = x.cpu().numpy()
    row = {"bytes": nbytes}

    def wire():
        inp = mod.InferInput("INPUT0", shape, "FP32").set_data_from_numpy(x_host)
        return client.infer("identity_fp32", [inp]).as_numpy("OUTPUT0")

    if not np.array_equal(wire(), x_host):
        raise AssertionError("identity_fp32 over the wire changed the tensor")
    row["wire_p50_ms"] = p50_ms(wire, iters)

    tag = os.urandom(4).hex()
    sys_in = shm.create_shared_memory_region(f"sin{tag}", f"/sin{tag}", nbytes)
    sys_out = shm.create_shared_memory_region(f"sout{tag}", f"/sout{tag}", nbytes)
    try:
        client.register_system_shared_memory(f"sin{tag}", f"/sin{tag}", nbytes)
        client.register_system_shared_memory(f"sout{tag}", f"/sout{tag}", nbytes)

        def system():
            shm.set_shared_memory_region(sys_in, [x_host])
            inp = mod.InferInput("INPUT0", shape, "FP32").set_shared_memory(f"sin{tag}", nbytes)
            out = mod.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(f"sout{tag}", nbytes)
            client.infer("identity_fp32", [inp], outputs=[out])
            return shm.get_contents_as_numpy(sys_out, "FP32", shape)

        if not np.array_equal(system(), x_host):
            raise AssertionError("identity_fp32 over system shm changed the tensor")
        row["system_shm_p50_ms"] = p50_ms(system, iters)
    finally:
        client.unregister_system_shared_memory()
        shm.destroy_shared_memory_region(sys_in)
        shm.destroy_shared_memory_region(sys_out)

    cu_in = cudashm.create_shared_memory_region(f"cin{tag}", nbytes, colocated=True)
    cu_out = cudashm.create_shared_memory_region(f"cout{tag}", nbytes, colocated=True)
    try:
        client.register_cuda_shared_memory(f"cin{tag}", cudashm.get_raw_handle(cu_in), 0, nbytes)
        client.register_cuda_shared_memory(f"cout{tag}", cudashm.get_raw_handle(cu_out), 0, nbytes)

        def cuda():
            cudashm.set_shared_memory_region_from_torch(cu_in, x)
            inp = mod.InferInput("INPUT0", shape, "FP32").set_shared_memory(f"cin{tag}", nbytes)
            out = mod.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(f"cout{tag}", nbytes)
            client.infer("identity_fp32", [inp], outputs=[out])
            return cudashm.get_contents_as_torch(cu_out, "FP32", shape)

        y = cuda()
        # the model got the client's CUDA tensor itself and handed it back
        if not (y.is_cuda and y.data_ptr() == x.data_ptr() and torch.equal(y, x)):
            raise AssertionError("cuda shm did not hand the CUDA tensor through")
        row["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
        # colocated regions never mirror to the host: both windows stay zero
        for region in (cu_in, cu_out):
            if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(cu_in)
        cudashm.destroy_shared_memory_region(cu_out)
    return row


def drive_long_context(client, cpu_model, seqs, iters):
    """long_context_encoder over the wire and colocated cuda shm at each
    sequence length, every output against the CPU run of the port with the
    same weights (flash_attention's fp32 tolerance). Returns the rows and
    the number of requests made."""
    dim = cpu_model.encoder.dim
    tol = TOLERANCE["flash_attention"]["float32"]
    tag = os.urandom(4).hex()
    rows, requests = [], 0
    for seq in seqs:
        gen = torch.Generator(device="cuda").manual_seed(seq)
        x = torch.randn((seq, dim), generator=gen, device="cuda")
        x_host = x.cpu().numpy()
        want = cpu_model.execute({"sequence": x_host}, {})["encoded"].numpy()
        nbytes = seq * dim * 4
        row = {"seq": seq, "dim": dim, "heads": cpu_model.encoder.heads}

        def check(got, plane):
            ok = (got.shape == want.shape and np.isfinite(got).all()
                  and np.allclose(got, want, atol=tol, rtol=tol))
            row[f"{plane}_max_abs_diff_vs_cpu"] = float(np.abs(got - want).max())
            if not ok:
                raise AssertionError(f"long_context_encoder over {plane} differs from the "
                                     f"CPU run: {row}")

        def wire():
            inp = httpclient.InferInput("sequence", [seq, dim], "FP32").set_data_from_numpy(x_host)
            return client.infer("long_context_encoder", [inp]).as_numpy("encoded")

        check(wire(), "wire")
        row["wire_p50_ms"] = p50_ms(wire, iters)
        requests += 1 + iters

        names = (f"lcin{tag}{seq}", f"lcout{tag}{seq}")
        cu_in, cu_out = (cudashm.create_shared_memory_region(n, nbytes, colocated=True)
                         for n in names)
        try:
            for name, region in zip(names, (cu_in, cu_out)):
                client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0,
                                                   nbytes)

            def cuda():
                cudashm.set_shared_memory_region_from_torch(cu_in, x)
                inp = httpclient.InferInput("sequence", [seq, dim], "FP32").set_shared_memory(
                    names[0], nbytes)
                out = httpclient.InferRequestedOutput("encoded")
                out.set_shared_memory(names[1], nbytes)
                client.infer("long_context_encoder", [inp], outputs=[out])
                y = cudashm.get_contents_as_torch(cu_out, "FP32", [seq, dim])
                torch.cuda.synchronize()  # the output is ready to use
                return y

            y = cuda()
            if not y.is_cuda:
                raise AssertionError("long_context_encoder's cuda shm output left the card")
            check(y.cpu().numpy(), "cuda_shm")
            row["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
            requests += 1 + iters
            for region in (cu_in, cu_out):
                if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                    raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
        finally:
            client.unregister_cuda_shared_memory()
            cudashm.destroy_shared_memory_region(cu_in)
            cudashm.destroy_shared_memory_region(cu_out)
        rows.append(row)
    return rows, requests


def drive_int8(client, rounds):
    """examples/quantized_wire_client.py with the port: quantize on the
    card, INT8 over the wire through identity_int8, dequantize on the card;
    the error must be within half a step. Returns the row and the number of
    round trips made."""
    x_host = np.random.default_rng(11).standard_normal((1, 8192)).astype(np.float32)
    scale = float(np.abs(x_host).max() / 127.0)
    x = torch.from_numpy(x_host).to("cuda")

    def round_trip():
        q = qz.quantize_int8(x, scale)
        inp = httpclient.InferInput("INPUT0", list(q.shape), "INT8")
        inp.set_data_from_numpy(q.cpu().numpy())
        q_back = client.infer("identity_int8", [inp]).as_numpy("OUTPUT0")
        restored = qz.dequantize_int8(numpy_to_tensor(q_back, "cuda"), scale)
        torch.cuda.synchronize()
        return q, q_back, restored

    q, q_back, restored = round_trip()
    err = (restored - x).abs().max().item()
    row = {"shape": list(x.shape), "scale": scale, "max_abs_err": err, "bound": scale / 2,
           "wire_bytes": int(q.numel()), "fp32_bytes": int(x.numel() * 4)}
    if (q_back.dtype != np.int8 or not np.array_equal(q_back, q.cpu().numpy())
            or not err <= scale / 2 + 1e-6):
        raise AssertionError(f"int8 wire path failed: {row}")
    row["p50_ms"] = p50_ms(round_trip, rounds)
    return row, rounds + 1


VISION_CLASSES, VISION_WIDTH = 1000, 96


def top_entries(result, name):
    """The classification extension's "value:index:label" entries."""
    return [e.decode().split(":") for e in result.as_numpy(name).reshape(-1)]


def serve_vision(iters):
    """The vision path on the card: ``build_image_ensemble`` at width 96 /
    1000 classes (weights from seed 0) behind the port's HTTP server, driven
    by the port's client, against a CPU run of the port with the same
    weights. Each flow runs with every launch count set to 0 just before it
    and read just after:

    - image_client: the noise image to the card, ``ops.normalize_image``
      (INCEPTION), CHW, ``densenet_onnx`` (a) over the wire and (b) through
      colocated cuda shm for data_0 and fc6_1, then
      ``ops.softmax_probabilities`` on the logits in the output region;
    - ensemble_image: (300, 400, 3) UINT8 noise over the wire.
    """
    models = build_image_ensemble(VISION_CLASSES, VISION_WIDTH, device="cuda")
    densenet = models[1]
    cpu_densenet = DenseNetModel(VISION_CLASSES, VISION_WIDTH, seed=0, device="cpu")
    server = HttpInferenceServer(ServerCore(models)).start()
    client = httpclient.InferenceServerClient(server.url, network_timeout=600.0)
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    raw = np.random.default_rng(0).integers(0, 256, (300, 400, 3)).astype(np.uint8)
    scale, shift = INCEPTION
    in_bytes, out_bytes = 3 * 224 * 224 * 4, VISION_CLASSES * 4
    calls = {"image_client": 0, "ensemble": 0, "softmax": 0}
    result = {"classes": VISION_CLASSES, "width": VISION_WIDTH,
              "flops_per_image": flops_per_image(VISION_CLASSES, VISION_WIDTH, (2, 2, 2))}

    def data_0():
        """image_client's preprocess on the card: HWC -> INCEPTION -> CHW."""
        calls["image_client"] += 1
        x = torch.from_numpy(img).to("cuda")
        return ops.normalize_image(x, scale, shift, torch.float32).permute(2, 0, 1).contiguous()

    def wire(class_count=0):
        inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32").set_data_from_numpy(data_0())
        out = httpclient.InferRequestedOutput("fc6_1", class_count=class_count)
        return client.infer("densenet_onnx", [inp], outputs=[out])

    def ensemble(class_count=0):
        calls["ensemble"] += 1
        inp = httpclient.InferInput("IMAGE", list(raw.shape), "UINT8").set_data_from_numpy(raw)
        out = httpclient.InferRequestedOutput("CLASSIFICATION", class_count=class_count)
        return client.infer("ensemble_image", [inp], outputs=[out])

    # the CPU reference: the same seed-0 weights, the plain normalize
    want = cpu_densenet.execute({"data_0": nz.normalize_image_reference(
        torch.from_numpy(img), scale, shift, torch.float32).permute(2, 0, 1).contiguous()},
        {})["fc6_1"].numpy().reshape(-1)
    stage0 =ImagePreprocessModel(device="cpu").execute({"raw_image": raw}, {})["preprocessed"]
    want_ens = cpu_densenet.execute({"data_0": stage0}, {})["fc6_1"].numpy().reshape(-1)
    # the gRPC phase holds its image_client flow against the same CPU run
    result["cpu_logits"] = want.tolist()

    def check(logits, reference, what):
        diff = float(np.abs(logits - reference).max())
        result[f"{what}_max_abs_logit_diff_vs_cpu"] = diff
        if (logits.shape != reference.shape or not np.isfinite(logits).all() or diff > 5e-2
                or logits.argmax() != reference.argmax()):
            raise AssertionError(f"{what}: logits differ from the CPU run by {diff} (top-1 "
                                 f"{logits.argmax()} vs {reference.argmax()})")

    def check_top(entries, reference, what):
        result[f"{what}_top3"] = entries
        if (len(entries) != 3 or int(entries[0][1]) != int(reference.argmax())
                or entries[0][2] != f"class_{entries[0][1]}"):
            raise AssertionError(f"{what}: top-3 {entries}, CPU top-1 {reference.argmax()}")

    tag = os.urandom(4).hex()
    names = (f"dnin{tag}", f"dnout{tag}")
    cu_in = cudashm.create_shared_memory_region(names[0], in_bytes, colocated=True)
    cu_out = cudashm.create_shared_memory_region(names[1], out_bytes, colocated=True)
    try:
        client.register_cuda_shared_memory(names[0], cudashm.get_raw_handle(cu_in), 0, in_bytes)
        client.register_cuda_shared_memory(names[1], cudashm.get_raw_handle(cu_out), 0,
                                           out_bytes)

        def cuda():
            cudashm.set_shared_memory_region_from_torch(cu_in, data_0())
            inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
                names[0], in_bytes)
            out = httpclient.InferRequestedOutput("fc6_1")
            out.set_shared_memory(names[1], out_bytes)
            client.infer("densenet_onnx", [inp], outputs=[out])
            logits = cudashm.get_contents_as_torch(cu_out, "FP32", [VISION_CLASSES, 1, 1])
            calls["softmax"] += 1
            probs = ops.softmax_probabilities(logits.reshape(1, VISION_CLASSES))
            torch.cuda.synchronize()  # the probabilities are ready to use
            return logits, probs

        # one request of each flow first (cuDNN and library set-up, the kernel
        # libraries loaded), outside the counts
        wire(), cuda(), ensemble()
        reset_counts()
        calls.update(image_client=0, softmax=0)
        check(wire().as_numpy("fc6_1").reshape(-1), want, "wire")
        check_top(top_entries(wire(3), "fc6_1"), want, "wire")
        result["wire_p50_ms"] = p50_ms(wire, iters)
        logits, probs = cuda()
        if not (logits.is_cuda and probs.is_cuda):
            raise AssertionError("densenet_onnx's cuda shm output or its softmax left the card")
        check(logits.reshape(-1).cpu().numpy(), want, "cuda_shm")
        total = probs.sum().item()
        result["probabilities_sum"] = total
        result["probabilities_top1"] = int(probs.argmax().item())
        if abs(total - 1.0) > 1e-5 or result["probabilities_top1"] != int(want.argmax()):
            raise AssertionError(f"softmax of the served logits: sum {total}, top-1 "
                                 f"{result['probabilities_top1']}")
        result["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
        for region in (cu_in, cu_out):
            if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
        image_client_counts = read_counts()
        image_client_calls = dict(calls)

        reset_counts()
        calls.update(ensemble=0)
        check(ensemble().as_numpy("CLASSIFICATION").reshape(-1), want_ens, "ensemble")
        check_top(top_entries(ensemble(3), "CLASSIFICATION"), want_ens, "ensemble")
        result["ensemble_p50_ms"] = p50_ms(ensemble, iters)
        ensemble_counts = read_counts()
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(cu_in)
        cudashm.destroy_shared_memory_region(cu_out)
        client.close()
        server.stop()

    expected = {
        "image_client": (image_client_counts, {
            "normalize_image": image_client_calls["image_client"],
            "softmax_probabilities": image_client_calls["softmax"]}),
        "ensemble_image": (ensemble_counts, {"normalize_image": calls["ensemble"]}),
    }
    for path, (counts, wanted) in expected.items():
        if counts != {name: wanted.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the {path} path: {counts}, expected {wanted}")
    result["launch_counts"] = {path: counts for path, (counts, _) in expected.items()}
    result["requests"] = {"image_client": image_client_calls["image_client"],
                          "ensemble_image": calls["ensemble"],
                          "softmax_calls": image_client_calls["softmax"]}
    result["profile"] = profile_densenet(densenet, 5)
    launches = {
        "normalize_image": (image_client_counts["normalize_image"]
                            + ensemble_counts["normalize_image"]),
        "softmax_probabilities": image_client_counts["softmax_probabilities"],
    }
    return result, launches


def drive_decoder(run, prompt, steps):
    """decoder_lm: the prompt as the sequence start, then ``steps`` greedy
    continuations; ``run(tokens, start, end)`` -> (logits, next_token)."""
    logits, tok = run(prompt, True, False)
    tokens, all_logits = [tok], [logits]
    for i in range(steps):
        logits, tok = run([tok], False, i == steps - 1)
        tokens.append(tok)
        all_logits.append(logits)
    return tokens, np.concatenate(all_logits)


# decoder_lm_batched over HTTP: one sequence a client and thread, prompts of
# lengths 1-8 drawn from seed 7, then BATCH_STEPS greedy continuations each
BATCH_SEQS = 8
BATCH_STEPS = 8
# the decode_attention row at the batched step's shape (B = slots): mixed
# positions with 0, 127 (a full cache, which the step clips to MAX_LEN - 1)
# and an idle slot (never started: pos 0, its output unused)
BATCHED_SHAPE = (8, 4, 128, 32)
BATCHED_POS = [0, 127, 5, 64, 31, 100, 77, 0]
# prefill rows and the disagg prompt
PREFILL_ROWS = 4
PREFILL_LEN = 6


def batch_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, size=n).tolist() for n in range(1, BATCH_SEQS + 1)]


def gate_first_window(model, size):
    """Hold the batched model's worker before its first window until
    ``size`` requests are queued, so that window holds them all; later
    windows coalesce on their own. Set before the model's first request
    (the worker starts with it); past 60 s the worker goes on and the
    width check fails instead."""
    real = model._collect

    def gated():
        deadline = time.monotonic() + 60
        while model._queue.qsize() < size and time.monotonic() < deadline:
            time.sleep(0.0005)
        model._collect = real
        return real()

    model._collect = gated


def drive_batched(url, prompts, steps):
    """Each prompt's sequence through decoder_lm_batched on a thread and
    client of its own, started together: (tokens, logits) per sequence."""
    results, errors = {}, []
    barrier = threading.Barrier(len(prompts))

    def run(i, prompt):
        client = httpclient.InferenceServerClient(url, network_timeout=600.0)
        try:
            def served(tokens, start, end):
                inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
                inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
                r = client.infer("decoder_lm_batched", [inp], sequence_id=300 + i,
                                 sequence_start=start, sequence_end=end)
                return r.as_numpy("LOGITS"), int(r.as_numpy("NEXT_TOKEN")[0, 0])

            barrier.wait(60)
            results[i] = drive_decoder(served, prompt, steps)
        except Exception as e:  # raised below, after every thread ended
            errors.append((i, repr(e)))
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"decoder_lm_batched sequences failed: {errors}")
    return [results[i] for i in range(len(prompts))]


def in_process(model, seq_id):
    """``run(tokens, start, end)`` for drive_decoder, through ``model.execute``."""
    def run(tokens, start, end):
        out = model.execute({"TOKENS": np.array([tokens], dtype=np.int32)},
                            {"sequence_id": seq_id, "sequence_start": start, "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])
    return run


def top2_margins(logits):
    top = np.sort(logits, axis=-1)
    return (top[:, -1] - top[:, -2]).tolist()


def full_slot_ride_along(batched, decoder):
    """In process on the card: a sequence fills its cache to MAX_LEN and
    stays live (no sequence_end) while another decodes beside it at
    pos == MAX_LEN: no error, the other's tokens as decoder_lm's, the full
    slot's cache untouched; the full sequence's next token is refused with
    max_len and frees its slot."""
    full = np.random.default_rng(11).integers(0, 256, size=decoder.MAX_LEN).tolist()
    in_process(batched, 900)(full, True, False)
    slot = batched._slot_of[900]
    if int(batched._pos[slot]) != decoder.MAX_LEN:
        raise AssertionError(f"the full sequence sits at {batched._pos[slot]}, not MAX_LEN")
    before = [kv[:, slot].clone() for kv in batched._caches]
    tokens, logits = drive_decoder(in_process(batched, 901), [5, 6, 7], 6)
    ref_tokens, ref_logits = drive_decoder(in_process(decoder, 902), [5, 6, 7], 6)
    untouched = all(torch.equal(kv[:, slot], old) for kv, old in zip(batched._caches, before))
    try:
        in_process(batched, 900)([1], False, False)
        refused = None
    except ValueError as e:
        refused = str(e)
    row = {"tokens": tokens, "decoder_lm_tokens": ref_tokens,
           "max_abs_logit_diff": float(np.abs(logits - ref_logits).max()),
           "cache_untouched": untouched, "overflow_error": refused,
           "live_after": batched.live_sequences()}
    if (tokens != ref_tokens or not untouched or refused is None or "max_len" not in refused
            or row["live_after"] != 0):
        raise AssertionError(f"the full-slot ride-along failed: {row}; decoder_lm top-2 "
                             f"margins {top2_margins(ref_logits)}")
    return row


def prompt_kv(decoder, prompt):
    """The decoder's cache after ``prompt`` as the disagg KV, [L*2, H, M, Dh] fp32."""
    caches = decoder.fresh_cache()
    decoder.prefill(caches, np.array(prompt), 0)
    return torch.stack([c[half] for c in caches for half in ("k", "v")]).float()


def disagg_handoff(client, core, decoder, prompt, max_tokens, kv_ref):
    """decoder_lm_disagg_prefill writes its KV into a colocated cuda shm
    output region over HTTP; decoder_lm_kv_decode streams from that region
    through ServerCore.infer_stream in process. ``kv_ref``: the KV the
    prompt must give (``prompt_kv``)."""
    shape = [decoder.LAYERS * 2, decoder.HEADS, decoder.MAX_LEN,
             decoder.D_MODEL // decoder.HEADS]
    nbytes = int(np.prod(shape)) * 4
    name = f"kv{os.urandom(4).hex()}"
    region = cudashm.create_shared_memory_region(name, nbytes, colocated=True)
    try:
        client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)
        inp = httpclient.InferInput("TOKENS", [1, len(prompt)], "INT32")
        inp.set_data_from_numpy(np.array([prompt], dtype=np.int32))
        kv_out = httpclient.InferRequestedOutput("KV")
        kv_out.set_shared_memory(name, nbytes)
        r = client.infer("decoder_lm_disagg_prefill", [inp], outputs=[
            kv_out, httpclient.InferRequestedOutput("NEXT_TOKEN"),
            httpclient.InferRequestedOutput("POS")])
        first, pos = int(r.as_numpy("NEXT_TOKEN")[0, 0]), int(r.as_numpy("POS")[0, 0])
        kv = cudashm.get_contents_as_torch(region, "FP32", shape)
        on_device = kv.is_cuda
        request = {"inputs": [
            {"name": "KV", "datatype": "FP32", "shape": shape, "shm": (name, nbytes, 0)},
            {"name": "POS", "datatype": "INT32", "shape": [1],
             "array": np.array([pos], np.int32)},
            {"name": "FIRST_TOKEN", "datatype": "INT32", "shape": [1],
             "array": np.array([first], np.int32)},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "array": np.array([max_tokens], np.int32)},
        ]}
        stream = [int(resp["outputs"][0]["array"][0, 0])
                  for resp in core.infer_stream("decoder_lm_kv_decode", "", request)]
        kv_exact = torch.equal(kv, kv_ref)
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(region)
    return {"prompt": prompt, "stream": stream, "pos": pos, "kv_on_device": on_device,
            "kv_equals_the_cache": kv_exact, "kv_bytes": nbytes}


def time_batched_rounds(batched, widths, windows):
    """In process on the card, through the model's own window runner: for
    each width S, S sequences started with one token, then ``windows``
    windows of one token each (one round, its logits read back in one copy):
    wall per round, tokens per second, and at the widest, the device time
    per round and decode_attention launches per round (profiler)."""
    rows = []
    for width in widths:
        seqs = [950 + i for i in range(width)]

        def window(start, end):
            reqs = [_SeqRequest(s, [(s * 31 + 7) % 256], start, end) for s in seqs]
            batched._run_window(reqs)
            for req in reqs:
                req.future.result(timeout=60)

        window(True, False)
        window(False, False)  # warm
        t0 = time.perf_counter()
        for _ in range(windows):
            window(False, False)
        wall_ms = (time.perf_counter() - t0) * 1e3 / windows
        row = {"width": width, "windows": windows, "wall_ms_per_round": wall_ms,
               "tokens_per_s": width * 1e3 / wall_ms}
        if width == max(widths):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(windows):
                    window(False, False)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            device_ms = sum(k["total_ms"] for k in kernels) / windows
            attention = [k for k in kernels if "decode_attention" in k["name"]]
            row.update({
                "device_ms_per_round": device_ms if kernels else None,
                "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
                "decode_attention_launches_per_round": (
                    sum(k["count"] for k in attention) / windows if kernels else None),
                "decode_attention_ms_per_round": (
                    sum(k["total_ms"] for k in attention) / windows if kernels else None),
                "kernel_launches_per_round": (sum(k["count"] for k in kernels) / windows
                                              if kernels else None),
                "top_kernels": kernels[:8],
            })
        window(False, True)
        rows.append(row)
    if batched.live_sequences():
        raise AssertionError("the timed sequences did not end")
    return rows


def serve_and_check():
    prompt, steps, max_tokens = [1, 2, 3, 4], 8, 8
    result = {}
    encoder = LongContextEncoderModel(device="cuda")
    server = HttpInferenceServer(ServerCore(default_model_zoo("cuda") + [encoder])).start()
    client = httpclient.InferenceServerClient(server.url, network_timeout=600.0)
    try:
        decoder = server.core.model("decoder_lm")
        layers = decoder.LAYERS
        # one request first, so library set-up (cuBLAS) is not in the timings
        warm = httpclient.InferInput("TOKENS", [1, 1], "INT32")
        warm.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        client.infer("decoder_lm", [warm], sequence_id=16, sequence_start=True,
                     sequence_end=True)
        reset_counts()

        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        inputs = [httpclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                  for n in ("INPUT0", "INPUT1")]
        res = client.infer("simple", inputs)
        if not (np.array_equal(res.as_numpy("OUTPUT0"), 2 * a)
                and not res.as_numpy("OUTPUT1").any()):
            raise AssertionError("simple returned wrong sums")

        result["identity"] = [
            drive_identity(client, 4 * MIB, 20),
            drive_identity(client, 64 * MIB, 5),
        ]

        def served(tokens, start, end):
            inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
            r = client.infer("decoder_lm", [inp], sequence_id=17,
                             sequence_start=start, sequence_end=end)
            return r.as_numpy("LOGITS"), int(r.as_numpy("NEXT_TOKEN")[0, 0])

        before = client.client_infer_stat()
        t0 = time.perf_counter()
        gpu_tokens, gpu_logits = drive_decoder(served, prompt, steps)
        decoder_s = time.perf_counter() - t0
        after = client.client_infer_stat()
        t0 = time.perf_counter()
        events = list(client.generate_stream(
            "tiny_lm_generate", {"TOKENS": prompt, "MAX_TOKENS": max_tokens}))
        generate_s = time.perf_counter() - t0
        decoder_counts = read_counts()
        launches = decoder_counts["decode_attention"]

        # long_context_encoder: one request first (cuBLAS set-up, the kernel
        # library loaded) outside the counts; the CPU run gets the same weights
        warm = httpclient.InferInput("sequence", [8, encoder.encoder.dim], "FP32")
        warm.set_data_from_numpy(np.zeros((8, encoder.encoder.dim), np.float32))
        client.infer("long_context_encoder", [warm])
        cpu_encoder = LongContextEncoderModel(device="cpu")
        load_jax_params(cpu_encoder, {name: getattr(encoder.encoder, name).cpu().numpy()
                                      for name in WEIGHTS})
        reset_counts()
        result["long_context"], lc_requests = drive_long_context(
            client, cpu_encoder, (100, 4096, 8192), 10)
        lc_counts = read_counts()

        reset_counts()
        result["int8"], round_trips = drive_int8(client, 20)
        int8_counts = read_counts()

        # decoder_lm_batched: 8 sequences over HTTP, the first window holding
        # all 8 starts
        batched = server.core.model("decoder_lm_batched")
        gate_first_window(batched, BATCH_SEQS)
        prompts = batch_prompts()
        reset_counts()
        t0 = time.perf_counter()
        batched_runs = drive_batched(server.url, prompts, BATCH_STEPS)
        batched_s = time.perf_counter() - t0
        batched_counts = read_counts()
        batched_rounds = sum(batched.batch_histogram.values())
        histogram = dict(sorted(batched.batch_histogram.items()))

        reset_counts()
        result["full_slot"] = full_slot_ride_along(batched, decoder)
        full_slot_counts = read_counts()
        full_slot_rounds = sum(batched.batch_histogram.values()) - batched_rounds
        # (the ride-along's decoder_lm reference steps count too)
        full_slot_stepped = 3 + 6

        rows = np.random.default_rng(12).integers(
            0, decoder.VOCAB, size=(PREFILL_ROWS, PREFILL_LEN)).astype(np.int32)
        reset_counts()
        inp = httpclient.InferInput("TOKENS", list(rows.shape), "INT32").set_data_from_numpy(rows)
        prefill = client.infer("decoder_lm_prefill", [inp])
        prefill_counts = read_counts()
        prefill_logits = prefill.as_numpy("LOGITS")

        kv_ref = prompt_kv(decoder, prompt)
        reset_counts()
        result["disagg"] = disagg_handoff(client, server.core, decoder, prompt, max_tokens,
                                          kv_ref)
        disagg_counts = read_counts()

        # references, after the counts were read: decoder_lm on the card for
        # each prefill row and each batched sequence, and the disagg stream's
        # tiny_lm_generate
        prefill_rows = []
        for b, row in enumerate(rows.tolist()):
            inp = httpclient.InferInput("TOKENS", [1, PREFILL_LEN], "INT32")
            inp.set_data_from_numpy(np.array([row], dtype=np.int32))
            r = client.infer("decoder_lm", [inp], sequence_id=400 + b, sequence_start=True,
                             sequence_end=True)
            prefill_rows.append(r.as_numpy("LOGITS")[0])
        card_runs = [drive_decoder(in_process(decoder, 500 + i), p, BATCH_STEPS)
                     for i, p in enumerate(prompts)]
        disagg_want = [e["NEXT_TOKEN"] for e in client.generate_stream(
            "tiny_lm_generate", {"TOKENS": prompt, "MAX_TOKENS": max_tokens})]
        result["batched_timing"] = time_batched_rounds(batched, (1, 2, 4, 8), 50)
    finally:
        client.close()
        server.stop()

    gen_tokens = [e["NEXT_TOKEN"] for e in events]
    if [e["INDEX"] for e in events] != list(range(max_tokens)):
        raise AssertionError(f"generate_stream indices out of order: {events}")
    # tokens through the decode step: prompt + continuations, and for the
    # stream the prompt + every emitted token but the last
    stepped = (len(prompt) + steps) + (len(prompt) + max_tokens - 1)
    # each path launched its own kernels, once per token x layer, request or
    # round trip, and no other kernel
    # the disagg path: the prompt, then one step per streamed token but the last
    disagg_stepped = len(prompt) + len(result["disagg"]["stream"]) - 1
    expected = {
        "decoder": (decoder_counts, {"decode_attention": stepped * layers}),
        "long_context_encoder": (lc_counts, {"flash_attention": lc_requests}),
        "int8 wire": (int8_counts, {"quantize_int8": round_trips, "dequantize_int8": round_trips}),
        # one launch a layer a round, at B = slots
        "decoder_lm_batched": (batched_counts, {"decode_attention": batched_rounds * layers}),
        "full slot ride-along": (full_slot_counts, {"decode_attention": (
            full_slot_rounds + full_slot_stepped) * layers}),
        "decoder_lm_prefill": (prefill_counts, {"decode_attention": rows.size * layers}),
        "disagg": (disagg_counts, {"decode_attention": disagg_stepped * layers}),
    }
    for path, (counts, want) in expected.items():
        if counts != {name: want.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the {path} path: {counts}, expected {want}")
    result["launch_counts"] = {path: counts for path, (counts, _) in expected.items()}

    # the same weights on the CPU, through the plain attention version
    cpu = TinyDecoderModel(device="cpu")

    def on_cpu(tokens, start, end):
        out = cpu.execute({"TOKENS": np.array([tokens], dtype=np.int32)},
                          {"sequence_id": 17, "sequence_start": start, "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    cpu_tokens, cpu_logits = drive_decoder(on_cpu, prompt, steps)
    cpu_gen = [int(r["NEXT_TOKEN"][0, 0]) for r in TinyGenerateModel(decoder=cpu).execute_decoupled(
        {"TOKENS": np.array([prompt], dtype=np.int32),
         "MAX_TOKENS": np.array([max_tokens], dtype=np.int32)}, {})]
    logit_err = float(np.abs(gpu_logits - cpu_logits).max())
    result["decoder"] = {
        "prompt": prompt, "gpu_tokens": gpu_tokens, "cpu_tokens": cpu_tokens,
        "max_abs_logit_diff": logit_err, "seconds": decoder_s,
        "generate_tokens": gen_tokens, "cpu_generate_tokens": cpu_gen,
        "generate_seconds": generate_s, "launches": launches,
        # client timers over the decoder_lm requests: send = request out to
        # response headers (server time included), receive = body read
        "client_request_ms": {
            kind: (after[f"cumulative_{kind}_time_ns"] - before[f"cumulative_{kind}_time_ns"])
            / 1e6 / (steps + 1)
            for kind in ("total_request", "send", "receive")},
        "tokens_stepped": stepped, "layers": layers,
    }
    if gpu_tokens != cpu_tokens or gen_tokens != cpu_gen:
        sorted_logits = np.sort(cpu_logits, axis=-1)
        raise AssertionError(
            f"greedy tokens differ from the CPU run: {result['decoder']}; CPU top-2 "
            f"margins {(sorted_logits[:, -1] - sorted_logits[:, -2]).tolist()}")
    if not np.isfinite(gpu_logits).all() or logit_err > 5e-2:
        raise AssertionError(f"logits differ from the CPU run by {logit_err}")

    # decoder_lm_batched: every sequence's tokens as decoder_lm's on the card
    # and as the CPU run's, logits within 5e-2 of the CPU run
    cpu_runs = [drive_decoder(in_process(cpu, 600 + i), p, BATCH_STEPS)
                for i, p in enumerate(prompts)]
    batched_err = max(float(np.abs(got[1] - ref[1]).max())
                      for got, ref in zip(batched_runs, cpu_runs))
    result["batched"] = {
        "prompts": prompts, "steps": BATCH_STEPS, "seconds": batched_s,
        "tokens": [run[0] for run in batched_runs],
        "card_decoder_lm_tokens": [run[0] for run in card_runs],
        "cpu_tokens": [run[0] for run in cpu_runs],
        "max_abs_logit_diff_vs_cpu": batched_err,
        "max_abs_logit_diff_vs_card_decoder_lm": max(
            float(np.abs(got[1] - ref[1]).max()) for got, ref in zip(batched_runs, card_runs)),
        "histogram": histogram, "rounds": batched_rounds,
        "launches": batched_counts["decode_attention"], "layers": layers,
    }
    for i, (got, card, ref) in enumerate(zip(batched_runs, card_runs, cpu_runs)):
        if got[0] != card[0] or got[0] != ref[0]:
            raise AssertionError(
                f"decoder_lm_batched sequence {i} tokens {got[0]}, decoder_lm on the card "
                f"{card[0]}, CPU {ref[0]}; top-2 margins batched {top2_margins(got[1])}, "
                f"card {top2_margins(card[1])}, CPU {top2_margins(ref[1])}")
    if not np.isfinite(np.concatenate([run[1] for run in batched_runs])).all() \
            or batched_err > 5e-2:
        raise AssertionError(f"decoder_lm_batched logits differ from the CPU run by {batched_err}")
    if max(histogram) < 4:
        raise AssertionError(f"no batched round of width >= 4: {histogram}")
    prefill_exact = all(prefill_logits[b].tobytes() == prefill_rows[b].tobytes()
                        for b in range(PREFILL_ROWS))
    result["prefill"] = {"rows": rows.tolist(), "bit_equal_to_decoder_lm": prefill_exact,
                         "next_tokens": prefill.as_numpy("NEXT_TOKEN")[:, 0].tolist()}
    if not prefill_exact:
        raise AssertionError("decoder_lm_prefill rows differ from decoder_lm on the card")
    disagg = result["disagg"]
    disagg["tiny_lm_generate"] = disagg_want
    if not (disagg["stream"] == disagg_want and disagg["kv_on_device"]
            and disagg["kv_equals_the_cache"]):
        raise AssertionError(f"the disagg handoff differs from tiny_lm_generate: {disagg}")

    # after the launch counts were read: where a served request's time goes
    result["profile"] = profile_decode(decoder, prompt, steps)
    result["long_context_profile"] = profile_long_context(encoder, 8192, 5)
    result["launches_by_path"] = {
        "decoder": launches, "decoder_lm_batched": batched_counts["decode_attention"],
        "full slot ride-along": full_slot_counts["decode_attention"],
        "decoder_lm_prefill": prefill_counts["decode_attention"],
        "disagg": disagg_counts["decode_attention"]}
    return result, {"decode_attention": launches, "flash_attention": lc_counts["flash_attention"],
                    "quantize_int8": int8_counts["quantize_int8"],
                    "dequantize_int8": int8_counts["dequantize_int8"]}


# ---------------------------------------------------------------------------
# phase 5: the served path over GRPC
# ---------------------------------------------------------------------------


def stream_decode(client, model, seq_id, prompt, steps):
    """decoder_lm-style greedy decode over the client's bidi stream, the way
    examples/grpc_decoder_stream_client.py drives it: (tokens, logits)."""
    responses = queue.Queue()
    client.start_stream(lambda r, e: responses.put((r, e)))
    try:
        def run(tokens, start, end):
            inp = grpcclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
            client.async_stream_infer(model, [inp], sequence_id=seq_id,
                                      sequence_start=start, sequence_end=end)
            result, error = responses.get(timeout=600)
            if error is not None:
                raise error
            return result.as_numpy("LOGITS"), int(result.as_numpy("NEXT_TOKEN")[0, 0])

        return drive_decoder(run, prompt, steps)
    finally:
        client.stop_stream()


def stream_batched(url, prompts, steps):
    """Each prompt's sequence through decoder_lm_batched on a GRPC stream,
    client and thread of its own, started together: (tokens, logits) each."""
    results, errors = {}, []
    barrier = threading.Barrier(len(prompts))

    def run(i, prompt):
        try:
            with grpcclient.InferenceServerClient(url) as client:
                barrier.wait(60)
                results[i] = stream_decode(client, "decoder_lm_batched", 300 + i, prompt, steps)
        except Exception as e:  # raised below, after every thread ended
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"decoder_lm_batched GRPC streams failed: {errors}")
    return [results[i] for i in range(len(prompts))]


def aio_identity(cuda_regions, mod, infer, x, shape, nbytes, n):
    """``n`` identity_fp32 requests through colocated cuda shm regions sent
    at once with asyncio.gather; the tensors the model handed back."""
    async def one(i):
        cin, cout, names = cuda_regions[i]
        cudashm.set_shared_memory_region_from_torch(cin, x * (i + 1))
        inp = mod.InferInput("INPUT0", shape, "FP32").set_shared_memory(names[0], nbytes)
        out = mod.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(names[1], nbytes)
        await infer("identity_fp32", [inp], outputs=[out])
        return cudashm.get_contents_as_torch(cout, "FP32", shape)

    async def run():
        return await asyncio.gather(*[one(i) for i in range(n)])
    return run()


def drive_aio(http_url, grpc_url, requests):
    """The aio clients: grpc.aio and http.aio each send ``requests`` simple
    and identity_fp32 (colocated cuda shm) requests through asyncio.gather;
    every output as expected and the two clients' outputs equal."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    n = 1 << 20
    shape, nbytes = [1, n], 4 * n
    x = torch.arange(n, dtype=torch.float32, device="cuda").reshape(shape) * 0.25
    tag = os.urandom(4).hex()
    regions = []
    for i in range(requests):
        names = (f"acin{i}{tag}", f"acout{i}{tag}")
        regions.append((cudashm.create_shared_memory_region(names[0], nbytes, colocated=True),
                        cudashm.create_shared_memory_region(names[1], nbytes, colocated=True),
                        names))

    async def session(mod, url):
        async with mod.InferenceServerClient(url) as client:
            for cin, cout, names in regions:
                for region, name in ((cin, names[0]), (cout, names[1])):
                    await client.register_cuda_shared_memory(
                        name, cudashm.get_raw_handle(region), 0, nbytes)
            simple = [mod.InferInput(name, [1, 16], "INT32").set_data_from_numpy(a)
                      for name in ("INPUT0", "INPUT1")]
            sums = await asyncio.gather(*[client.infer("simple", simple)
                                          for _ in range(requests)])
            ys = await aio_identity(regions, mod, client.infer, x, shape, nbytes, requests)
            await client.unregister_cuda_shared_memory()
            return [r.as_numpy("OUTPUT0") for r in sums], ys

    out = {}
    try:
        for name, mod, url in (("grpc_aio", grpc_aio, grpc_url), ("http_aio", http_aio, http_url)):
            t0 = time.perf_counter()
            sums, ys = asyncio.run(session(mod, url))
            seconds = time.perf_counter() - t0
            if not all(np.array_equal(s, 2 * a) for s in sums):
                raise AssertionError(f"{name}: simple returned wrong sums")
            for i, y in enumerate(ys):
                if not (y.is_cuda and torch.equal(y, x * (i + 1))):
                    raise AssertionError(f"{name}: identity_fp32 over cuda shm changed "
                                         f"request {i}'s tensor")
            out[name] = {"requests": 2 * requests, "seconds": seconds,
                         "sums": [s.tolist() for s in sums],
                         "identity_sums": [float(y.sum().item()) for y in ys]}
        if (out["grpc_aio"]["sums"] != out["http_aio"]["sums"]
                or out["grpc_aio"]["identity_sums"] != out["http_aio"]["identity_sums"]):
            raise AssertionError(f"the aio clients' outputs differ: {out}")
        for cin, cout, _ in regions:
            for region in (cin, cout):
                if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                    raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
    finally:
        for cin, cout, _ in regions:
            cudashm.destroy_shared_memory_region(cin)
            cudashm.destroy_shared_memory_region(cout)
    return out


def grpc_image_client(url, want, iters):
    """The image_client flow over GRPC: the noise image to the card,
    ``ops.normalize_image`` (INCEPTION), CHW into a colocated cuda shm
    region, ``densenet_onnx`` with its logits in another, then
    ``ops.softmax_probabilities`` on them. Checked against the CPU run's
    logits (top-1 equal, within 5e-2). Returns (row, requests, softmax
    calls)."""
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    scale, shift = INCEPTION
    in_bytes, out_bytes = 3 * 224 * 224 * 4, VISION_CLASSES * 4
    tag = os.urandom(4).hex()
    names = (f"gdnin{tag}", f"gdnout{tag}")
    cu_in = cudashm.create_shared_memory_region(names[0], in_bytes, colocated=True)
    cu_out = cudashm.create_shared_memory_region(names[1], out_bytes, colocated=True)
    calls = {"requests": 0, "softmax": 0}
    client = grpcclient.InferenceServerClient(url)
    row = {}
    try:
        client.register_cuda_shared_memory(names[0], cudashm.get_raw_handle(cu_in), 0, in_bytes)
        client.register_cuda_shared_memory(names[1], cudashm.get_raw_handle(cu_out), 0,
                                           out_bytes)

        def run():
            calls["requests"] += 1
            x = torch.from_numpy(img).to("cuda")
            data_0 = ops.normalize_image(x, scale, shift, torch.float32).permute(2, 0, 1)
            cudashm.set_shared_memory_region_from_torch(cu_in, data_0.contiguous())
            inp = grpcclient.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
                names[0], in_bytes)
            out = grpcclient.InferRequestedOutput("fc6_1")
            out.set_shared_memory(names[1], out_bytes)
            client.infer("densenet_onnx", [inp], outputs=[out])
            logits = cudashm.get_contents_as_torch(cu_out, "FP32", [VISION_CLASSES, 1, 1])
            calls["softmax"] += 1
            probs = ops.softmax_probabilities(logits.reshape(1, VISION_CLASSES))
            torch.cuda.synchronize()  # the probabilities are ready to use
            return logits, probs

        logits, probs = run()
        if not (logits.is_cuda and probs.is_cuda):
            raise AssertionError("densenet_onnx's GRPC cuda shm output or its softmax left "
                                 "the card")
        got = logits.reshape(-1).cpu().numpy()
        diff = float(np.abs(got - want).max())
        row["max_abs_logit_diff_vs_cpu"] = diff
        row["top1"], row["cpu_top1"] = int(got.argmax()), int(want.argmax())
        row["probabilities_sum"] = probs.sum().item()
        row["probabilities_top1"] = int(probs.argmax().item())
        if (not np.isfinite(got).all() or diff > 5e-2 or row["top1"] != row["cpu_top1"]
                or row["probabilities_top1"] != row["cpu_top1"]
                or abs(row["probabilities_sum"] - 1.0) > 1e-5):
            raise AssertionError(f"image_client over GRPC differs from the CPU run: {row}")
        row["cuda_shm_p50_ms"] = p50_ms(run, iters)
        for region in (cu_in, cu_out):
            if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
    finally:
        client.unregister_cuda_shared_memory()
        client.close()
        cudashm.destroy_shared_memory_region(cu_in)
        cudashm.destroy_shared_memory_region(cu_out)
    return row, calls["requests"], calls["softmax"]


def serve_grpc(served, vision):
    """The port's GRPC server over ``ServerCore(default_model_zoo("cuda"))``
    plus the vision models, driven by the port's GRPC clients (and http.aio
    through an HTTP frontend on the same core), each path with every launch
    count set to 0 just before it and read just after. ``served`` and
    ``vision`` are the HTTP phases' results, which the GRPC paths must
    reproduce."""
    prompt, steps = served["decoder"]["prompt"], 8
    core = ServerCore(default_model_zoo("cuda")
                      + build_image_ensemble(VISION_CLASSES, VISION_WIDTH, device="cuda"))
    server = GrpcInferenceServer(core, max_workers=2 * BATCH_SEQS).start()
    http_server = HttpInferenceServer(core).start()
    client = grpcclient.InferenceServerClient(server.url)
    result, counts, expected = {}, {}, {}
    try:
        # warm-up outside the counts: cuBLAS and cuDNN set-up, kernels loaded
        warm = grpcclient.InferInput("TOKENS", [1, 1], "INT32")
        warm.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        client.infer("decoder_lm", [warm], sequence_id=16, sequence_start=True,
                     sequence_end=True)
        grpc_image_client(server.url, np.asarray(vision["cpu_logits"], np.float32), 1)

        # 1. simple and the admin surface
        reset_counts()
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        inputs = [grpcclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                  for n in ("INPUT0", "INPUT1")]
        sent = 5
        for _ in range(sent):
            res = client.infer("simple", inputs)
            if not (np.array_equal(res.as_numpy("OUTPUT0"), 2 * a)
                    and not res.as_numpy("OUTPUT1").any()):
                raise AssertionError("simple over GRPC returned wrong sums")
        meta = client.get_model_metadata("simple")
        config = client.get_model_config("decoder_lm")["config"]
        index = client.get_model_repository_index()
        client.unload_model("simple_string")
        unloaded = client.is_model_ready("simple_string")
        client.load_model("simple_string")
        stats = client.get_inference_statistics("simple")["model_stats"][0]
        admin = {
            "live": client.is_server_live(), "ready": client.is_server_ready(),
            "simple_ready": client.is_model_ready("simple"),
            "extensions": client.get_server_metadata()["extensions"],
            "simple_inputs": [i["name"] for i in meta["inputs"]],
            "decoder_lm_config_inputs": [i["name"] for i in config["input"]],
            "repository_models": len(index),
            "unloaded_then_ready": (unloaded, client.is_model_ready("simple_string")),
            "simple_success_count": stats["inference_stats"]["success"]["count"],
            "simple_sent": sent,
        }
        result["admin"] = admin
        if not (admin["live"] and admin["ready"] and admin["simple_ready"]
                and admin["unloaded_then_ready"] == (False, True)
                and admin["simple_success_count"] == sent
                and admin["repository_models"] == len(core.repository_index())):
            raise AssertionError(f"the GRPC admin surface: {admin}")
        counts["simple and admin"], expected["simple and admin"] = read_counts(), {}

        # 2. identity_fp32 by data plane
        reset_counts()
        result["identity"] = [drive_identity(client, 4 * MIB, 20, grpcclient),
                              drive_identity(client, 64 * MIB, 5, grpcclient)]
        counts["identity"], expected["identity"] = read_counts(), {}

        # 3. decoder_lm over one bidi stream
        decoder = core.model("decoder_lm")
        layers = decoder.LAYERS
        reset_counts()
        t0 = time.perf_counter()
        tokens, logits = stream_decode(client, "decoder_lm", 17, prompt, steps)
        seconds = time.perf_counter() - t0
        counts["decoder"] = read_counts()
        expected["decoder"] = {"decode_attention": (len(prompt) + steps) * layers}
        http_dec = served["decoder"]
        result["decoder"] = {"tokens": tokens, "http_tokens": http_dec["gpu_tokens"],
                             "cpu_tokens": http_dec["cpu_tokens"], "seconds": seconds,
                             "ms_per_token": seconds * 1e3 / (steps + 1),
                             "launches": counts["decoder"]["decode_attention"],
                             "tokens_stepped": len(prompt) + steps, "layers": layers}
        if tokens != http_dec["gpu_tokens"] or tokens != http_dec["cpu_tokens"]:
            raise AssertionError(f"decoder_lm over GRPC: {result['decoder']}")
        if not np.isfinite(logits).all():
            raise AssertionError("decoder_lm over GRPC gave non-finite logits")

        # 4. decoder_lm_batched over 8 concurrent streams
        batched = core.model("decoder_lm_batched")
        gate_first_window(batched, BATCH_SEQS)
        prompts = batch_prompts()
        reset_counts()
        t0 = time.perf_counter()
        runs = stream_batched(server.url, prompts, BATCH_STEPS)
        seconds = time.perf_counter() - t0
        counts["decoder_lm_batched"] = read_counts()
        rounds = sum(batched.batch_histogram.values())
        histogram = dict(sorted(batched.batch_histogram.items()))
        expected["decoder_lm_batched"] = {"decode_attention": rounds * layers}
        card = served["batched"]["card_decoder_lm_tokens"]
        result["batched"] = {"tokens": [r[0] for r in runs], "card_decoder_lm_tokens": card,
                             "seconds": seconds, "histogram": histogram, "rounds": rounds,
                             "launches": counts["decoder_lm_batched"]["decode_attention"],
                             "layers": layers}
        if [r[0] for r in runs] != card:
            raise AssertionError(f"decoder_lm_batched over GRPC: {result['batched']}")
        if max(histogram) < 4:
            raise AssertionError(f"no batched GRPC round of width >= 4: {histogram}")

        # 5. the image_client flow over GRPC, input and logits in cuda shm
        reset_counts()
        result["image_client"], requests, softmax_calls = grpc_image_client(
            server.url, np.asarray(vision["cpu_logits"], np.float32), 20)
        counts["image_client"] = read_counts()
        expected["image_client"] = {"normalize_image": requests,
                                    "softmax_probabilities": softmax_calls}
        result["image_client"].update(requests=requests, softmax_calls=softmax_calls)

        # 6. the aio clients
        reset_counts()
        result["aio"] = drive_aio(http_server.url, server.url, 4)
        counts["aio"], expected["aio"] = read_counts(), {}
    finally:
        client.close()
        server.stop()
        http_server.stop()
        core.model("decoder_lm_batched").unload()
    for path, want in expected.items():
        if counts[path] != {name: want.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the GRPC {path} path: {counts[path]}, "
                                 f"expected {want}")
    result["launch_counts"] = counts
    return result


# phase 6: resilience, telemetry, integrity and flight on the served paths.
# Seeded backoff; a GRPC channel that redials faster than the backoff (with a
# subchannel pool of its own, so one client's dead connection is not shared)
RESILIENCE_SEED = 0xC11E
FAST_REDIAL = [
    ("grpc.use_local_subchannel_pool", 1),
    ("grpc.initial_reconnect_backoff_ms", 50),
    ("grpc.min_reconnect_backoff_ms", 50),
    ("grpc.max_reconnect_backoff_ms", 100),
    ("grpc.max_send_message_length", 2**31 - 1),
    ("grpc.max_receive_message_length", 2**31 - 1),
]
# image_client requests per fault, the decoder step at which the fault
# lands, bytes into a connection before a reset (mid-body of the 588 KiB
# image request; past a decoder request, inside its ~1.5 KiB response)
FAULT_REQUESTS = 6
FAULT_STEP = 3
IMAGE_RESET_BYTES = 300_000
DECODER_RESET_BYTES = 1_200
# telemetry paths and the hooks' host cost: requests per path, interleaved
# rounds (bare, hooked, hooked, bare per round)
SPLIT_REQUESTS = 10
HOOK_ROUNDS = 3
HOOK_REQUESTS = 20


def resilience_policy(breaker=None):
    return ResiliencePolicy(retry=RetryPolicy(
        max_attempts=6, initial_backoff_s=0.05, max_backoff_s=0.4,
        rng=random.Random(RESILIENCE_SEED)), breaker=breaker)


def median(values):
    return statistics.median(values) if values else None


def split_of(tel, core):
    """Each traced request's client phases beside the server's queue and
    compute time, joined by trace id: p50s in ms."""
    traces = tel.recent_traces()
    access = {r["trace_id"]: r for r in core.access_records(1024)}
    phases, server = {}, {"queue": [], "compute": [], "total": []}
    for trace in traces:
        for ph in trace["phases"]:
            phases.setdefault(ph["name"], []).append(ph["duration_ms"])
        record = access.get(trace["trace_id"])
        if record is None or record["client_span_id"] != trace["span_id"]:
            raise AssertionError(f"span {trace['trace_id']} has no server access record")
        for key in server:
            server[key].append(record[f"{key}_ns"] / 1e6)
    return {"requests": len(traces),
            "client_ms_p50": {name: median(v) for name, v in phases.items()},
            "client_total_ms_p50": median([t["duration_ms"] for t in traces]),
            "server_queue_ms_p50": median(server["queue"]),
            "server_compute_ms_p50": median(server["compute"]),
            "server_total_ms_p50": median(server["total"])}


def serve_resilience(served, vision, device="cuda"):
    """Phase 6: the port's HTTP and GRPC servers over the default zoo and
    the vision models on ``device``, the port's ``ChaosProxy`` in front of
    each, every client with contract validation on, and a process-wide
    data-plane recorder. Each path runs with every launch count set to 0
    just before it and read just after; decode_attention launches are held
    to what the server ran (its execution count, each request's tokens,
    times the layers), as a retried request that reached the server runs
    the model again. ``served`` and ``vision`` are the HTTP phases' results
    (the decoder's prompt, CPU tokens and CPU logits).

    On a CPU ``device`` the wrappers run their plain versions and launch
    nothing; the script itself runs this phase only on the card."""
    on_card = torch.device(device).type == "cuda"
    prompt, steps = served["decoder"]["prompt"], 8
    cpu_tokens = served["decoder"]["cpu_tokens"]
    want = np.asarray(vision["cpu_logits"], np.float32)
    core = ServerCore(default_model_zoo(device)
                      + build_image_ensemble(VISION_CLASSES, VISION_WIDTH, device=device),
                      device=device)
    layers = core.model("decoder_lm").LAYERS
    http_server = HttpInferenceServer(core).start()
    # a bidi stream holds a handler thread for its life, and a reconnect
    # opens another before the dead one's handler notices
    grpc_server = GrpcInferenceServer(core, max_workers=2 * BATCH_SEQS + 8).start()
    http_proxy = ChaosProxy("127.0.0.1", http_server.port).start()
    grpc_proxy = ChaosProxy("127.0.0.1", grpc_server.port).start()
    previous_recorder = dataplane()
    recorder = enable_dataplane()
    integrity = IntegrityPolicy(stats=IntegrityStats())
    flight = FlightRecorder(baseline_ratio=0.0, rng=random.Random(RESILIENCE_SEED))
    fault_tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(1),
                          flight=flight)
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    scale, shift = INCEPTION
    in_bytes, out_bytes = 3 * 224 * 224 * 4, VISION_CLASSES * 4
    result, counts, expected = {}, {}, {}
    seen_failures = []
    dp = {"created": 0, "destroyed": 0, "registered": 0, "resident": 0, "peak": 0,
          "requests": 0}
    clients = []

    def client(url, tel=None, policy=None, checked=True):
        c = httpclient.InferenceServerClient(url, network_timeout=600.0)
        clients.append(c)
        c.configure_integrity(integrity if checked else False)
        if tel is not None:
            c.configure_telemetry(tel)
        if policy is not None:
            c.configure_resilience(policy)
        return c

    def executions(model):
        return core.statistics(model)["model_stats"][0]["execution_count"]

    def decoder_gate(path, before, extra_tokens):
        """decode_attention launches = layers x the tokens the server ran:
        one a request, plus each executed start's prompt beyond one."""
        ran = executions("decoder_lm") - before
        expected[path] = {"decode_attention": layers * (ran + extra_tokens) if on_card else 0}
        return ran

    def regions(c, tag, sizes):
        """Colocated cuda regions, registered on ``c``, accounted for the
        data-plane check."""
        made = []
        for i, nbytes in enumerate(sizes):
            name = f"{tag}{i}{os.urandom(3).hex()}"
            region = cudashm.create_shared_memory_region(name, nbytes, colocated=True,
                                                         device=device)
            c.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)
            made.append((name, region))
            dp["created"] += 1
            dp["registered"] += 1
            dp["resident"] += nbytes
            dp["peak"] = max(dp["peak"], dp["resident"])
        return made

    def release(c, made):
        for name, region in made:
            c.unregister_cuda_shared_memory(name)
            cudashm.destroy_shared_memory_region(region)
            dp["destroyed"] += 1
            dp["resident"] -= region.byte_size

    calls = {"normalize": 0, "softmax": 0}

    def data_0():
        calls["normalize"] += 1
        x = torch.from_numpy(img).to(device)
        return ops.normalize_image(x, scale, shift, torch.float32).permute(2, 0, 1).contiguous()

    def softmax(logits):
        calls["softmax"] += 1
        probs = ops.softmax_probabilities(logits.reshape(1, VISION_CLASSES))
        if on_card:
            torch.cuda.synchronize()  # the probabilities are ready to use
        return probs

    def image_wire(c):
        inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32")
        inp.set_data_from_numpy(data_0().cpu().numpy())
        res = c.infer("densenet_onnx", [inp], outputs=[httpclient.InferRequestedOutput("fc6_1")])
        logits = res.as_torch("fc6_1", device=device)
        return logits, softmax(logits)

    def image_cuda(c, made):
        (in_name, cu_in), (out_name, cu_out) = made
        cudashm.set_shared_memory_region_from_torch(cu_in, data_0())
        inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
            in_name, in_bytes)
        out = httpclient.InferRequestedOutput("fc6_1").set_shared_memory(out_name, out_bytes)
        c.infer("densenet_onnx", [inp], outputs=[out])
        dp["requests"] += 1
        logits = cudashm.get_contents_as_torch(cu_out, "FP32", [VISION_CLASSES, 1, 1])
        return logits, softmax(logits)

    def check_image(logits, probs, what):
        got = logits.reshape(-1).cpu().numpy()
        diff = float(np.abs(got - want).max())
        top1, ptop1 = int(got.argmax()), int(probs.argmax().item())
        if (not np.isfinite(got).all() or diff > 5e-2 or top1 != int(want.argmax())
                or ptop1 != top1 or abs(probs.sum().item() - 1.0) > 1e-5):
            raise AssertionError(f"{what}: top-1 {top1} (CPU {int(want.argmax())}), max "
                                 f"logit diff {diff}")
        return top1, diff

    x_id = torch.arange(MIB, dtype=torch.float32, device=device).reshape(1, MIB) * 0.5

    def identity_cuda(c, made):
        (in_name, cu_in), (out_name, cu_out) = made
        cudashm.set_shared_memory_region_from_torch(cu_in, x_id)
        inp = httpclient.InferInput("INPUT0", [1, MIB], "FP32").set_shared_memory(
            in_name, 4 * MIB)
        out = httpclient.InferRequestedOutput("OUTPUT0").set_shared_memory(out_name, 4 * MIB)
        c.infer("identity_fp32", [inp], outputs=[out])
        dp["requests"] += 1
        y = cudashm.get_contents_as_torch(cu_out, "FP32", [1, MIB])
        if not torch.equal(y, x_id):
            raise AssertionError("identity_fp32 over cuda shm changed the tensor")

    def decoder_step(c, seq, tokens, start, end=False):
        inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
        inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
        res = c.infer("decoder_lm", [inp], sequence_id=seq, sequence_start=start,
                      sequence_end=end)
        return int(res.as_numpy("NEXT_TOKEN")[0, 0])

    def decode_sequence(c, seq):
        """prompt, then ``steps`` greedy continuations: (tokens, seconds)."""
        t0 = time.perf_counter()
        tokens = [decoder_step(c, seq, prompt, True)]
        for i in range(steps):
            tokens.append(decoder_step(c, seq, [tokens[-1]], False, i == steps - 1))
        return tokens, time.perf_counter() - t0

    try:
        direct = client(http_server.url)
        for model in ("simple", "identity_fp32", "decoder_lm", "densenet_onnx"):
            direct.get_model_metadata(model)  # primes the contract cache
        # warm-up outside the counts: cuBLAS and cuDNN set-up, kernels loaded
        check_image(*image_wire(direct), "warm-up")
        decode_sequence(direct, 50)

        # 1. the image_client flow (idempotent) under flap and reset@N, a
        #    connection a request so the faults land
        for name, fault in (("flap", Fault("flap", every=2)),
                            ("reset@N", Fault("reset", after_bytes=IMAGE_RESET_BYTES,
                                              every=2))):
            reset_counts()
            calls.update(normalize=0, softmax=0)
            before = executions("densenet_onnx")
            policy = fault_tel.attach(resilience_policy())
            faulted_before = http_proxy.stats["faulted"]
            http_proxy.fault = fault
            top1s, diffs = [], []
            for _ in range(FAULT_REQUESTS):
                top1, diff = check_image(*image_wire(client(http_proxy.url, fault_tel, policy)),
                                         f"image_client under {name}")
                top1s.append(top1)
                diffs.append(diff)
            http_proxy.heal()
            path = f"image_client under {name}"
            counts[path] = read_counts()
            expected[path] = {"normalize_image": calls["normalize"] if on_card else 0,
                              "softmax_probabilities": calls["softmax"] if on_card else 0}
            stats = policy.stats.as_dict()
            result[path] = {"requests": FAULT_REQUESTS, "errors": 0, "top1": top1s,
                            "cpu_top1": int(want.argmax()),
                            "max_abs_logit_diff_vs_cpu": max(diffs), "policy": stats,
                            "server_executions": executions("densenet_onnx") - before,
                            "faulted_connections": http_proxy.stats["faulted"] - faulted_before}
            if stats["retries"] < 1 or stats["calls"] != FAULT_REQUESTS:
                raise AssertionError(f"{path}: no retry under the fault: {stats}")

        # 2. a decoder_lm sequence under reset@N: its faulted request is not
        #    re-sent; the tokens before it are the CPU run's
        reset_counts()
        before = executions("decoder_lm")
        policy = fault_tel.attach(resilience_policy())
        c = client(http_proxy.url, fault_tel, policy)
        tokens = [decoder_step(c, 41, prompt, True)]
        for _ in range(FAULT_STEP - 1):
            tokens.append(decoder_step(c, 41, [tokens[-1]], False))
        sequence_stats = policy.stats.as_dict()
        http_proxy.fault = Fault("reset", after_bytes=DECODER_RESET_BYTES, limit=1)
        faulted = client(http_proxy.url, fault_tel, policy)  # a new connection: faulted
        try:
            decoder_step(faulted, 41, [tokens[-1]], False)
            raise AssertionError("the faulted decoder_lm request did not fail")
        except InferenceServerException as e:
            domain = classify_fault(e)
            seen_failures.append(("decoder_lm", domain))
        http_proxy.heal()
        after = policy.stats.as_dict()
        ran = decoder_gate("decoder_lm under reset@N", before, len(prompt) - 1)
        counts["decoder_lm under reset@N"] = read_counts()
        result["decoder_lm under reset@N"] = {
            "tokens_before_fault": tokens, "cpu_tokens": cpu_tokens[:FAULT_STEP],
            "fault_domain": domain, "requests_sent": FAULT_STEP + 1, "server_executions": ran,
            "faulted_call_attempts": after["attempts"] - sequence_stats["attempts"]}
        if (tokens != cpu_tokens[:FAULT_STEP] or after["calls"] - sequence_stats["calls"] != 1
                or after["attempts"] - sequence_stats["attempts"] != 1
                or ran > FAULT_STEP + 1 or ran < FAULT_STEP):
            raise AssertionError(f"decoder_lm under reset@N: {result['decoder_lm under reset@N']}")
        decoder_step(direct, 41, prompt, True, True)  # ends the broken sequence

        # 3. a GRPC bidi stream with auto_reconnect under a reset: one
        #    StreamReconnected naming the in-flight sequence request; the
        #    application re-drives the sequence from the tokens it has
        reset_counts()
        before = executions("decoder_lm")
        events = queue.Queue()
        gc = grpcclient.InferenceServerClient(grpc_proxy.url, channel_args=FAST_REDIAL)
        gc.configure_integrity(integrity)
        gc.configure_telemetry(fault_tel)
        gc.configure_resilience(fault_tel.attach(resilience_policy()))
        gc.start_stream(lambda r, e: events.put((r, e)), auto_reconnect=True)
        checkers = [StreamChecker(grpc_proxy.url, integrity)]
        reconnects = []
        starts = []

        def stream_step(seq, tokens, start, rid):
            inp = grpcclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
            gc.async_stream_infer("decoder_lm", [inp], sequence_id=seq, sequence_start=start,
                                  request_id=rid)
            if start:
                starts.append(len(tokens))

        def stream_result(reconnect=False):
            """The next token, or (``reconnect``) the next StreamReconnected;
            each wire stream's responses pass a StreamChecker of their own
            (request ids count up from 0 on each)."""
            while True:
                res, err = events.get(timeout=60)
                if err is not None:
                    raise err
                if isinstance(res, StreamReconnected):
                    reconnects.append(res)
                    checkers.append(StreamChecker(grpc_proxy.url, integrity))
                    if reconnect:
                        return res
                    continue
                if reconnect:
                    raise AssertionError(f"a response where the reconnect was due: "
                                         f"{res.get_response()}")
                rid = res.get_response()["id"]
                checkers[-1].observe({"index": int(rid[1:])})
                return int(res.as_numpy("NEXT_TOKEN")[0, 0])

        try:
            stream_step(42, prompt, True, "t0")
            tokens = [stream_result()]
            for i in range(1, FAULT_STEP):
                stream_step(42, [tokens[-1]], False, f"t{i}")
                tokens.append(stream_result())
            grpc_proxy.pause_forwarding = True
            stream_step(42, [tokens[-1]], False, f"t{FAULT_STEP}")  # in flight
            time.sleep(0.2)
            grpc_proxy.reset_active()
            grpc_proxy.pause_forwarding = False
            # the reconnect first: a request enqueued while the dead stream
            # still looks alive would be abandoned with the in-flight one
            stream_result(reconnect=True)
            # re-driven: a new sequence over the prompt and the tokens so far
            stream_step(43, prompt + tokens, True, "r0")
            tokens.append(stream_result())
            for i in range(1, steps + 1 - FAULT_STEP):
                stream_step(43, [tokens[-1]], False, f"r{i}")
                tokens.append(stream_result())
        finally:
            gc.stop_stream()
            gc.close()
        ran = decoder_gate("grpc stream auto_reconnect", before,
                           sum(n - 1 for n in starts))
        counts["grpc stream auto_reconnect"] = read_counts()
        event = reconnects[0] if reconnects else None
        result["grpc stream auto_reconnect"] = {
            "tokens": tokens, "cpu_tokens": cpu_tokens, "reconnects": len(reconnects),
            "abandoned_request_ids": event.abandoned_request_ids if event else None,
            "resent_request_ids": event.resent_request_ids if event else None,
            "server_executions": ran, "stream_checker_events": [k.events for k in checkers]}
        if (len(reconnects) != 1 or event.abandoned_request_ids != [f"t{FAULT_STEP}"]
                or event.resent_request_ids or tokens != cpu_tokens
                or ran != FAULT_STEP + 1 + steps - FAULT_STEP):
            raise AssertionError(f"grpc stream auto_reconnect: "
                                 f"{result['grpc stream auto_reconnect']}")
        direct_grpc = grpcclient.InferenceServerClient(grpc_server.url)
        inp = grpcclient.InferInput("TOKENS", [1, 1], "INT32")
        inp.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        for seq in (42, 43):  # end both sequences
            direct_grpc.infer("decoder_lm", [inp], sequence_id=seq, sequence_start=True,
                              sequence_end=True)
        direct_grpc.close()

        # 4. a circuit breaker under blackhole: opens, fast-fails without a
        #    connection, and after the recovery window probes once
        reset_counts()
        transitions = []
        breaker = CircuitBreaker(failure_threshold=0.5, window=4, min_calls=4,
                                 recovery_time_s=0.5)
        policy = fault_tel.attach(ResiliencePolicy(retry=None, breaker=breaker))
        breaker.on_transition = lambda state: (transitions.append(state),
                                               fault_tel.on_breaker_transition(state))
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        simple_in = [httpclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                     for n in ("INPUT0", "INPUT1")]
        http_proxy.fault = Fault("blackhole")
        c = client(http_proxy.url, fault_tel, policy)
        for _ in range(4):
            try:
                c.infer("simple", simple_in, client_timeout=0.25)
                raise AssertionError("simple answered through a blackhole")
            except InferenceServerException as e:
                seen_failures.append(("simple", classify_fault(e)))
        state_after_faults = breaker.state
        connections = http_proxy.stats["connections"]
        try:
            c.infer("simple", simple_in, client_timeout=0.25)
            raise AssertionError("an open breaker let a request through")
        except CircuitOpenError:
            seen_failures.append(("simple", "fast_fail"))
        fast_fail_connections = http_proxy.stats["connections"] - connections
        http_proxy.heal()
        http_proxy.reset_active()
        time.sleep(0.55)
        probe = c.infer("simple", simple_in, client_timeout=30.0)
        counts["breaker"], expected["breaker"] = read_counts(), {}
        result["breaker"] = {"state_after_faults": state_after_faults,
                             "transitions": transitions, "policy": policy.stats.as_dict(),
                             "fast_fail_connections": fast_fail_connections,
                             "probe_ok": bool(np.array_equal(probe.as_numpy("OUTPUT0"), 2 * a))}
        if (state_after_faults != "open" or transitions != ["open", "half_open", "closed"]
                or fast_fail_connections != 0 or not result["breaker"]["probe_ok"]
                or policy.stats.as_dict()["fast_fails"] != 1):
            raise AssertionError(f"breaker under blackhole: {result['breaker']}")

        # the flight recorder kept each failure the caller saw, once
        flight_stats = flight.stats()
        retained = flight_stats["retained"]
        result["flight"] = {"failures_seen": len(seen_failures), "seen": seen_failures,
                            "retained": retained, "requests": flight_stats["requests"]}
        if retained["error"] + retained["shed"] != len(seen_failures):
            raise AssertionError(f"flight recorder: {result['flight']}")

        # 5. the round-trip split: client phases beside the server's queue and
        #    compute time, joined by trace id (telemetry at ratio 1.0)
        split = {}
        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(2))
        c = client(http_server.url, tel)
        x_host = x_id.cpu().numpy()
        reset_counts()
        for _ in range(SPLIT_REQUESTS):
            inp = httpclient.InferInput("INPUT0", [1, MIB], "FP32").set_data_from_numpy(x_host)
            if not np.array_equal(c.infer("identity_fp32", [inp]).as_numpy("OUTPUT0"),
                                  x_host):
                raise AssertionError("identity_fp32 over the wire changed the tensor")
        split["identity_fp32 4 MiB wire"] = split_of(tel, core)
        counts["split identity"], expected["split identity"] = read_counts(), {}

        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(3))
        c = client(http_server.url, tel)
        made = regions(c, "spid", (4 * MIB, 4 * MIB))
        for _ in range(SPLIT_REQUESTS):
            identity_cuda(c, made)
        release(c, made)
        split["identity_fp32 4 MiB cuda shm"] = split_of(tel, core)

        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(4))
        c = client(http_server.url, tel)
        reset_counts()
        before = executions("decoder_lm")
        tokens, _ = decode_sequence(c, 44)
        decoder_gate("split decoder_lm", before, len(prompt) - 1)
        counts["split decoder_lm"] = read_counts()
        if tokens != cpu_tokens:
            raise AssertionError(f"decoder_lm with telemetry: {tokens} vs CPU {cpu_tokens}")
        split["decoder_lm per token"] = split_of(tel, core)

        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(5))
        c = client(http_server.url, tel)
        made = regions(c, "spim", (in_bytes, out_bytes))
        reset_counts()
        calls.update(normalize=0, softmax=0)
        for _ in range(SPLIT_REQUESTS):
            check_image(*image_cuda(c, made), "image_client with telemetry")
        counts["split image_client"] = read_counts()
        expected["split image_client"] = {
            "normalize_image": calls["normalize"] if on_card else 0,
            "softmax_probabilities": calls["softmax"] if on_card else 0}
        split["image_client cuda shm"] = split_of(tel, core)
        # compute_ns is the host time of model.execute; the same request's
        # device time from the profiler beside it
        device_ms = None
        if on_card:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                image_cuda(c, made)
                torch.cuda.synchronize()
            kernels_ms = sum(k["total_ms"] for k in device_kernels(prof))
            device_ms = kernels_ms if kernels_ms > 0 else None
        last = tel.recent_traces()[-1]
        record = next(r for r in core.access_records(1024)
                      if r["trace_id"] == last["trace_id"])
        split["image_client cuda shm"]["profiled_request"] = {
            "server_compute_ms": record["compute_ns"] / 1e6,
            "server_total_ms": record["total_ns"] / 1e6,
            "device_ms": device_ms, "client_total_ms": last["duration_ms"]}
        release(c, made)
        result["split"] = split

        # 6. the hooks' host cost: the same paths with no hooks (no
        #    telemetry, resilience or integrity) and with all three, in
        #    interleaved rounds
        bare = client(http_server.url, checked=False)
        hooked = client(http_server.url, Telemetry(sample="ratio", sample_ratio=1.0,
                                                   rng=random.Random(6)),
                        resilience_policy())
        bare_regions = regions(bare, "hkb", (4 * MIB, 4 * MIB))
        hooked_regions = regions(hooked, "hkh", (4 * MIB, 4 * MIB))
        cost = {"bare": {"identity_p50_ms": [], "decoder_ms_per_token": []},
                "hooked": {"identity_p50_ms": [], "decoder_ms_per_token": []}}
        reset_counts()
        before = executions("decoder_lm")
        seq = 60
        for _ in range(HOOK_ROUNDS):
            for side in ("bare", "hooked", "hooked", "bare"):
                c, made = (bare, bare_regions) if side == "bare" else (hooked, hooked_regions)
                cost[side]["identity_p50_ms"].append(
                    p50_ms(lambda: identity_cuda(c, made), HOOK_REQUESTS))
                seq += 1
                tokens, seconds = decode_sequence(c, seq)
                if tokens != cpu_tokens:
                    raise AssertionError(f"decoder_lm ({side}): {tokens} vs CPU {cpu_tokens}")
                cost[side]["decoder_ms_per_token"].append(seconds * 1e3 / (steps + 1))
        decoder_gate("hooks", before, (len(prompt) - 1) * 4 * HOOK_ROUNDS)
        counts["hooks"] = read_counts()
        release(bare, bare_regions)
        release(hooked, hooked_regions)
        summary = {side: {k: median(v) for k, v in rows.items()} for side, rows in cost.items()}
        result["hooks"] = {"rounds": cost, "median": summary, "difference": {
            k: summary["hooked"][k] - summary["bare"][k] for k in summary["bare"]}}

        # integrity: every served output of the phase passed its contract
        overhead = integrity.stats.overhead_ns()
        result["integrity"] = {"violations": integrity.stats.violations,
                               "results": integrity.stats.results,
                               "checks": integrity.stats.checks,
                               "overhead_ns": overhead}
        if integrity.stats.violations or not integrity.stats.results:
            raise AssertionError(f"integrity: {result['integrity']}")

        # /metrics: the server's counts are the executions the phase caused
        with urllib.request.urlopen(f"http://{http_server.url}/metrics", timeout=60) as resp:
            text = resp.read().decode()
        metrics = {}
        for model in ("simple", "identity_fp32", "decoder_lm", "densenet_onnx"):
            stats = core.statistics(model)["model_stats"][0]
            row = {}
            for metric, want_value in (
                    ("inference_count", stats["inference_count"]),
                    ("execution_count", stats["execution_count"]),
                    ("request_success_count", stats["inference_stats"]["success"]["count"])):
                match = re.search(rf'^client_tpu_server_{metric}{{model="{model}"}} (\S+)$',
                                  text, re.M)
                got = float(match.group(1)) if match else None
                row[metric] = got
                if got != want_value:
                    raise AssertionError(f"/metrics {metric} of {model}: {got}, the "
                                         f"statistics say {want_value}")
            metrics[model] = row
        identity_sent = SPLIT_REQUESTS * 2 + 4 * HOOK_ROUNDS * HOOK_REQUESTS
        if metrics["identity_fp32"]["request_success_count"] != identity_sent:
            raise AssertionError(f"/metrics identity_fp32 successes "
                                 f"{metrics['identity_fp32']} != {identity_sent} sent")
        result["metrics"] = {"models": metrics, "identity_sent": identity_sent,
                             "lines": len(text.splitlines())}

        # the data-plane counters: the creates, registers and destroys made
        snap = recorder.snapshot()
        fam = snap["families"]["cuda"]
        registers = snap["rpcs"].get("cuda.register.ok", 0)
        unregisters = snap["rpcs"].get("cuda.unregister.ok", 0)
        result["dataplane"] = {"cuda": fam, "registers": registers,
                               "unregisters": unregisters, "made": dict(dp)}
        if (fam["created"] != dp["created"] or fam["destroyed"] != dp["destroyed"]
                or registers != dp["registered"] or unregisters != dp["registered"]
                or fam["regions"] != 0 or fam["bytes_resident"] != 0
                or fam["bytes_peak"] != dp["peak"]
                or fam["map_writes"] != 2 * dp["requests"]
                or fam["map_reads"] != 2 * dp["requests"]):
            raise AssertionError(f"the cuda data-plane counters: {result['dataplane']}")
    finally:
        install_dataplane(previous_recorder)
        for c in clients:
            c.close()
        http_proxy.stop()
        grpc_proxy.stop()
        http_server.stop()
        grpc_server.stop()
        core.model("decoder_lm_batched").unload()
    for path, wanted in expected.items():
        if counts[path] != {name: wanted.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the resilience phase's {path} path: "
                                 f"{counts[path]}, expected {wanted}")
    result["launch_counts"] = counts
    return result


# ---------------------------------------------------------------------------
# phase 7: the measurement harness (perf, genai_perf, trace) on the served
# paths, over the shm arena's cuda family
# ---------------------------------------------------------------------------

# the sizes phase 7 runs at; the CPU rehearsal in the tests passes smaller ones
HarnessSize = collections.namedtuple("HarnessSize", [
    "identity_bytes", "image", "vision_classes", "vision_width", "seq", "requests",
    "concurrency", "prompt", "output", "sessions", "replay"])
HARNESS = HarnessSize(
    identity_bytes=4 * MIB, image=(224, 224, 3), vision_classes=VISION_CLASSES,
    vision_width=VISION_WIDTH, seq=8192, requests=100, concurrency=(1, 2, 4), prompt=8,
    output=16, sessions=8,
    replay="mixed:duration_s=3,rate=30,stream_fraction=0.2,seq_fraction=0.15,"
           "output_mean=4,max_output=6")


def arena_regions_expected(arena, nbytes, workers):
    """The regions an arena carves for ``workers`` workers that each hold
    one lease of every size in ``nbytes`` at once: a size class carves
    ``region_target_bytes // class`` slabs a region (one above the
    target, at most ``max_slabs_per_region``), whatever the requests."""
    classes = collections.Counter(arena._class_for(n) for n in nbytes)
    total = 0
    for size, leases in classes.items():
        slabs = 1
        if size <= arena.region_target_bytes:
            slabs = max(1, min(arena.max_slabs_per_region, arena.region_target_bytes // size))
        total += -(-workers * leases // slabs)
    return total


class CountingGenAiRunner(GenAiPerfRunner):
    """``GenAiPerfRunner`` that also counts the tokens its clients received
    (the rows report rates, not counts)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tokens = 0
        self._tokens_lock = threading.Lock()

    def _count(self, sess):
        with self._tokens_lock:
            self.tokens += sess.tokens

    def _run_decoupled_session(self, client, infer_input, sess, responses, rng):
        super()._run_decoupled_session(client, infer_input, sess, responses, rng)
        self._count(sess)

    def _run_sequence_session(self, client, infer_input, sess, responses, sequence_id, rng):
        try:
            super()._run_sequence_session(client, infer_input, sess, responses, sequence_id, rng)
        finally:
            self._count(sess)

    def _run_generate_session(self, client, sess, rng):
        super()._run_generate_session(client, sess, rng)
        self._count(sess)


def serve_harness(device="cuda", size=HARNESS):
    """Phase 7: the port's measurement harness against its own servers on
    ``device`` (the default zoo, the image ensemble and the long-context
    encoder in one ``ServerCore``, served over HTTP and GRPC in this
    process). ``PerfRunner`` closed loops at ``size.concurrency`` on
    identity_fp32 (none, system and cuda shm), ensemble_image and
    long_context_encoder (cuda shm), one open-loop poisson rate on
    identity_fp32 over cuda shm at half the closed loop's rate at
    concurrency 1, the replay of a seeded mixed trace over HTTP, and
    ``GenAiPerfRunner`` in its three modes. Each path runs with every launch
    count set to 0 just before it and read just after, and is held to what
    the server ran (its statistics' executions, the batched model's
    rounds). Every row has 0 errors and the completed counts of the
    requests sent; the cuda rows' regions are the arena's size classes,
    not the requests, and none stays resident after the arenas close.

    On a CPU ``device`` the wrappers run their plain versions and launch
    nothing, so the launch gate expects zeros there; ``expected_launches``
    in the result says what the card would launch. The script runs this
    phase only on the card."""
    on_card = torch.device(device).type == "cuda"
    encoder = LongContextEncoderModel(device=device)
    core = ServerCore(default_model_zoo(device)
                      + build_image_ensemble(size.vision_classes, size.vision_width,
                                             device=device)
                      + [encoder], device=device)
    layers = core.model("decoder_lm").LAYERS
    batched = core.model("decoder_lm_batched")
    http_server = HttpInferenceServer(core).start()
    grpc_server = GrpcInferenceServer(core, max_workers=2 * BATCH_SEQS + 8).start()
    previous_recorder = dataplane()
    recorder = enable_dataplane()
    result = {"size": size._asdict(), "perf": {}, "genai": {}}
    counts = {}
    expected = {}
    runners = []

    def stat(model, key="execution_count"):
        stats = core.statistics(model)["model_stats"][0]
        return (stats["inference_stats"]["success"]["count"] if key == "success"
                else stats[key])

    def closed_loop(name, url, protocol, model, mode, shapes, kernel, per_request):
        """A sweep at ``size.concurrency``; ``kernel`` launches ``per_request``
        times an execution of ``model``."""
        runner = PerfRunner(url, protocol, model, mode, shapes, device=device)
        runners.append(runner)
        executed, succeeded = stat(model), stat(model, "success")
        reset_counts()
        rows = [runner.run(c, size.requests) for c in size.concurrency]
        counts[name] = read_counts()
        executions = stat(model) - executed
        successes = stat(model, "success") - succeeded
        sent = sum(row["requests"] + row["errors"] + row["shed"] for row in rows)
        for row in rows:
            if row["errors"] or row["shed"]:
                raise AssertionError(f"perf {name} c={row['concurrency']}: {row['errors']} "
                                     f"errors, {row['shed']} shed ({row['error_sample']})")
        if successes != sent or sum(row["requests"] for row in rows) != sent:
            raise AssertionError(f"perf {name}: the server counted {successes} successes "
                                 f"of {sent} requests sent")
        expected[name] = {kernel: per_request * executions} if kernel else {}
        if mode != "none":
            arena = runner._arena
            made = sum(row["client_shm"]["regions_created"] for row in rows)
            want = arena_regions_expected(
                arena, [data.nbytes for _, _, _, data in runner._tensors]
                + list(runner._output_sizes.values()), max(size.concurrency))
            if made != want or arena.stats()["regions_created"] != want or made >= sent:
                raise AssertionError(f"perf {name}: {made} regions created (the arena "
                                     f"{arena.stats()['regions_created']}) for {sent} "
                                     f"requests, its size classes need {want}")
            if any(row["client_shm"]["arena"]["leased_bytes"] for row in rows):
                raise AssertionError(f"perf {name}: leases held after a run: {rows}")
        result["perf"][name] = {"rows": rows, "executions": executions, "sent": sent}
        return runner, rows

    try:
        identity_shape = {"INPUT0": [1, size.identity_bytes // 4]}
        for mode in ("none", "system", "cuda"):
            runner, rows = closed_loop(f"identity_fp32 {mode}", http_server.url, "http",
                                       "identity_fp32", mode, identity_shape, None, 0)
            if mode == "cuda":
                identity_runner, identity_c1 = runner, rows[0]
        closed_loop("identity_fp32 cuda grpc", grpc_server.url, "grpc", "identity_fp32",
                    "cuda", identity_shape, None, 0)
        closed_loop("ensemble_image cuda", http_server.url, "http", "ensemble_image", "cuda",
                    {"IMAGE": list(size.image)}, "normalize_image", 1)
        closed_loop(f"long_context_encoder S={size.seq} cuda", http_server.url, "http",
                    "long_context_encoder", "cuda", {"sequence": [size.seq, encoder.encoder.dim]},
                    "flash_attention", 1)

        # the open loop at half the closed loop's rate at concurrency 1
        rate = identity_c1["infer_per_sec"] / 2
        succeeded = stat("identity_fp32", "success")
        reset_counts()
        row = identity_runner.run_rate(rate, size.requests, "poisson", pool_size=4)
        counts["identity_fp32 cuda poisson"] = read_counts()
        expected["identity_fp32 cuda poisson"] = {}
        if (row["errors"] or row["requests"] != size.requests or row["issued"] != size.requests
                or stat("identity_fp32", "success") - succeeded != size.requests):
            raise AssertionError(f"perf identity_fp32 poisson at {rate}/s: {row}")
        result["perf"]["identity_fp32 cuda poisson"] = {"rows": [row], "rate": rate}

        # every arena closed: no region of the phase stays resident
        for runner in runners:
            if runner._arena is not None:
                runner._arena.close()
        snap = recorder.snapshot()["families"]
        result["dataplane"] = {fam: snap[fam] for fam in ("system", "cuda")}
        for fam in ("system", "cuda"):
            if snap[fam]["regions"] or snap[fam]["bytes_resident"]:
                raise AssertionError(f"{fam} regions resident after the arenas closed: "
                                     f"{snap[fam]}")

        # the replay of a seeded trace over HTTP
        trace = trace_mod.generate(size.replay, seed=0)
        streams = [r for r in trace.records if r.kind == "generate_stream"]
        # warmup sends the first record of each kind once more
        stepped = sum(r.prompt_tokens + r.output_tokens - 1 for r in streams[:1] + streams)
        replayer = PerfRunner(http_server.url, "http", "simple", device=device)
        reset_counts()
        row = replayer.run_trace(trace, replay_workers=16, slos=["error_rate<0.1%"])
        counts["trace replay"] = read_counts()
        expected["trace replay"] = {"decode_attention": stepped * layers}
        if row["errors"] or row["requests"] != len(trace.records) or not row["slo_ok"]:
            raise AssertionError(f"trace replay: {row['errors']} errors, {row['requests']} of "
                                 f"{len(trace.records)} records ({row['error_sample']})")
        result["perf"]["trace replay"] = {"rows": [row], "stream_tokens_stepped": stepped}

        # genai_perf: decoupled and sequence over GRPC, generate over HTTP
        for name, url, mode, model, levels in (
                ("decoupled tiny_lm_generate", grpc_server.url, "decoupled",
                 "tiny_lm_generate", (1,)),
                ("sequence decoder_lm_batched", grpc_server.url, "sequence",
                 "decoder_lm_batched", (1, BATCH_SEQS)),
                ("generate tiny_lm_generate", http_server.url, "generate",
                 "tiny_lm_generate", (1,))):
            for concurrency in levels:
                sessions = max(size.sessions, concurrency)
                path = f"{name} c={concurrency}"
                genai = CountingGenAiRunner(url, model, mode, size.prompt, size.output)
                executed = stat(model)
                rounds = sum(batched.batch_histogram.values())
                reset_counts()
                row = genai.run(concurrency, sessions)
                counts[path] = read_counts()
                executions = stat(model) - executed
                if mode == "sequence":
                    # a launch a layer a round, at B = slots
                    launched = sum(batched.batch_histogram.values()) - rounds
                    want_executions = sessions * size.output
                else:
                    launched = executions * (size.prompt + size.output - 1)
                    want_executions = sessions
                expected[path] = {"decode_attention": launched * layers}
                if (row["errors"] or row["incomplete"] or row["sessions"] != sessions
                        or genai.tokens != sessions * size.output
                        or executions != want_executions):
                    raise AssertionError(f"genai {path}: {row['sessions']} of {sessions} "
                                         f"sessions, {row['errors']} errors, {genai.tokens} "
                                         f"tokens, {executions} executions "
                                         f"({row['error_sample']})")
                result["genai"][path] = {"row": row, "tokens": genai.tokens,
                                         "executions": executions,
                                         "rounds": launched if mode == "sequence" else None}
    finally:
        install_dataplane(previous_recorder)
        for runner in runners:
            runner.close()
            if runner._arena is not None and not runner._arena._closed:
                runner._arena.close(force=True)
        http_server.stop()
        grpc_server.stop()
        batched.unload()
    for path, wanted in expected.items():
        want = {name: wanted.get(name, 0) if on_card else 0
                for name in COUNTERS}
        if counts[path] != want:
            raise AssertionError(f"launches on the harness phase's {path} path: "
                                 f"{counts[path]}, expected {want}")
    result["launch_counts"] = counts
    result["expected_launches"] = expected
    return result


# ---------------------------------------------------------------------------
# phase 8: the standalone server (client_tpu_torch.serve) in a process of its
# own, driven from this process as the client
# ---------------------------------------------------------------------------

# the served set of every child: the default zoo plus identity_fp32, the
# image ensemble (1000 classes, width 32, weights from seed 0) and
# long_context_encoder (flash)
SERVE_ARGS = ["--http-port", "0", "--grpc-port", "0", "--identity-fp32", "--vision",
              "--long-context", "--attention", "flash"]
# the child: ``serve.main`` as ``python -m client_tpu_torch.serve`` runs it,
# its core kept so that, once main returns (after the SIGTERM drain), one
# line reports the kernels it launched, the statistics, the decoder steps
# (single-sequence steps of every decoder-family model) and the device
SERVE_CHILD = r"""
import json, sys, threading
sys.path.insert(0, sys.argv[1])
import torch
from client_tpu_torch import serve
from client_tpu_torch.models.decoder import TinyDecoderModel
from client_tpu_torch.ops import decode_attention, normalize, softmax, quantize
from client_tpu_torch.ops.flash_attention import LAUNCHES as flash
steps, steps_lock, plain_step = [0], threading.Lock(), TinyDecoderModel.step
def counted_step(self, *args, **kwargs):
    with steps_lock:
        steps[0] += 1
    return plain_step(self, *args, **kwargs)
TinyDecoderModel.step = counted_step
cores = []
class Core(serve.SignalDrainedCore):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cores.append(self)
serve.SignalDrainedCore = Core
rc = serve.main(sys.argv[2:])
core = cores[0]
counters = {"decode_attention": decode_attention.LAUNCHES, "flash_attention": flash,
            "quantize_int8": quantize.QUANTIZE_LAUNCHES,
            "dequantize_int8": quantize.DEQUANTIZE_LAUNCHES,
            "normalize_image": normalize.LAUNCHES, "softmax_probabilities": softmax.LAUNCHES}
stats = core.statistics()["model_stats"]
print("SERVE_REPORT " + json.dumps({
    "rc": rc, "launches": {k: c.count for k, c in counters.items()},
    "executions": {r["name"]: r["execution_count"] for r in stats},
    "successes": {r["name"]: r["inference_stats"]["success"]["count"] for r in stats},
    "failures": {r["name"]: r["inference_stats"]["fail"]["count"] for r in stats},
    "rounds": sum(core.model("decoder_lm_batched").batch_histogram.values()),
    "decoder_steps": steps[0],
    "layers": core.model("decoder_lm").LAYERS,
    "device": (torch.cuda.get_device_name(core.device) if core.device.type == "cuda"
               else str(core.device))}), flush=True)
sys.exit(rc)
"""

ProcessSize = collections.namedtuple("ProcessSize", [
    "identity_bytes", "load_bytes", "seq", "image", "requests", "concurrency", "prompt",
    "steps", "sessions", "output", "int8_rounds", "cli_requests"])
PROCESS = ProcessSize(
    identity_bytes=(4 * MIB, 64 * MIB), load_bytes=4 * MIB, seq=8192, image=(224, 224, 3),
    requests=40, concurrency=(1, 2, 4, 8), prompt=[1, 2, 3, 4], steps=8, sessions=8,
    output=16, int8_rounds=4, cli_requests=40)
PROCESS_WARMUP = 4  # requests a load row sends before it is measured
DRAIN_THREADS = 4
DRAIN_GRACE_S = 1.0  # serve's own wait between ready -> 0 and the closes


class ServeChild:
    """``client_tpu_torch.serve`` in a child process on ``device``: its output
    read line by line, its URLs from the lines it prints."""

    def __init__(self, device, frontend, args=SERVE_ARGS):
        self.frontend = frontend
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SERVE_CHILD, REPO, *args, "--device", device,
             "--http-frontend", frontend],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        self.lines = []
        self._eof = False
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    def line(self, prefix, timeout):
        """The first line the child printed that starts with ``prefix``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if line.startswith(prefix):
                        return line
                left = deadline - time.monotonic()
                if self._eof or left <= 0:
                    raise AssertionError(
                        f"serve ({self.frontend}) printed no '{prefix}' line (exit "
                        f"{self.proc.poll()}):\n" + "\n".join(self.lines[-40:]))
                self._cond.wait(left)

    def wait_ready(self, timeout=300):
        """The printed URLs, then ``is_server_ready`` over both protocols."""
        t0 = time.perf_counter()
        self.http_url = self.line(f"HTTP  server ({self.frontend}) listening on ",
                                  timeout).rsplit(" ", 1)[1]
        self.grpc_url = self.line("GRPC  server listening on ", timeout).rsplit(" ", 1)[1]
        self.models = self.line("models: ", timeout)[len("models: "):].split(", ")
        deadline = time.monotonic() + 30
        with httpclient.InferenceServerClient(self.http_url) as h, \
                grpcclient.InferenceServerClient(self.grpc_url) as g:
            while not (h.is_server_ready() and g.is_server_ready()):
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve ({self.frontend}) never became ready")
                time.sleep(0.05)
        self.ready_s = time.perf_counter() - t0
        return self

    def terminate(self, timeout=15.0):
        """SIGTERM, then the exit (within ``timeout``) and the final report."""
        t0 = time.perf_counter()
        self.sigterm()
        return self.finish(t0, timeout)

    def sigterm(self):
        self.proc.send_signal(signal.SIGTERM)

    def finish(self, t0, timeout):
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"serve ({self.frontend}) did not exit within {timeout} s "
                                 "of SIGTERM:\n" + "\n".join(self.lines[-40:]))
        exit_s = time.perf_counter() - t0
        self._reader.join(10)
        report = json.loads(self.line("SERVE_REPORT ", 0)[len("SERVE_REPORT "):])
        if rc != 0 or report["rc"] != 0:
            raise AssertionError(f"serve ({self.frontend}) exited {rc}:\n"
                                 + "\n".join(self.lines[-40:]))
        report["exit_s"] = exit_s
        report["drain_line"] = any(line.startswith("SIGTERM: draining") for line in self.lines)
        return report

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)


class CrossRegions:
    """An input and an output cuda shm region made in this process with
    ``colocated=False`` (the host window carries the bytes to a server in
    another process, and the output back), registered on ``client``."""

    def __init__(self, client, mod, in_bytes, out_bytes, device):
        tag = os.urandom(4).hex()
        self.client, self.mod = client, mod
        self.names = (f"xin{tag}", f"xout{tag}")
        self.sizes = (in_bytes, out_bytes)
        self.regions = [cudashm.create_shared_memory_region(n, b, device=device, colocated=False)
                        for n, b in zip(self.names, self.sizes)]
        for name, region, nbytes in zip(self.names, self.regions, self.sizes):
            client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)

    def infer(self, model, in_name, x, out_name, out_shape, **kwargs):
        """One request on ``x`` (a tensor), the output read back as a tensor;
        the input window must hold ``x`` (mirrored for the server)."""
        mod = self.mod
        cudashm.set_shared_memory_region_from_torch(self.regions[0], x)
        inp = mod.InferInput(in_name, list(x.shape), torch_to_triton_dtype(x.dtype))
        inp.set_shared_memory(self.names[0], self.sizes[0])
        out = mod.InferRequestedOutput(out_name)
        out.set_shared_memory(self.names[1], self.sizes[1])
        self.client.infer(model, [inp], outputs=[out], **kwargs)
        window = np.frombuffer(self.regions[0].host_buffer(), dtype=np.uint8)[:x.numel()
                                                                             * x.element_size()]
        if not np.array_equal(window, x.cpu().contiguous().view(torch.uint8).numpy().reshape(-1)):
            raise AssertionError(f"{model}: the input window does not hold the input")
        return cudashm.get_contents_as_torch(self.regions[1], "FP32", out_shape)

    def close(self):
        for name in self.names:
            self.client.unregister_cuda_shared_memory(name)
        for region in self.regions:
            cudashm.destroy_shared_memory_region(region)


def process_references(size):
    """The CPU run of the port with the same seed-0 weights as the child's:
    decoder_lm's greedy tokens and logits, long_context_encoder's output at
    ``size.seq`` and ensemble_image's logits on a seeded image."""
    decoder = TinyDecoderModel(device="cpu")

    def run(tokens, start, end):
        out = decoder.execute({"TOKENS": np.array([tokens], np.int32)},
                              {"sequence_id": 900, "sequence_start": start,
                               "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    tokens, logits = drive_decoder(run, size.prompt, size.steps)
    encoder = LongContextEncoderModel(device="cpu")
    seq = np.random.default_rng(8).standard_normal(
        (size.seq, encoder.encoder.dim)).astype(np.float32)
    encoded = encoder.execute({"sequence": seq}, {})["encoded"].numpy()
    image = np.random.default_rng(0).integers(0, 256, size.image, dtype=np.uint8)
    vision = ServerCore(build_image_ensemble(device="cpu"), device="cpu")
    logits_img = vision.infer("ensemble_image", "", {"inputs": [{
        "name": "IMAGE", "datatype": "UINT8", "shape": list(image.shape),
        "array": image}]})["outputs"][0]["array"]
    logits_img = np.asarray(logits_img.cpu() if isinstance(logits_img, torch.Tensor)
                            else logits_img).reshape(-1)
    return {"decoder_tokens": tokens, "decoder_logits": logits, "seq": seq,
            "encoded": encoded, "image": image, "image_logits": logits_img}


def check_encoded(got, refs, where):
    tol = TOLERANCE["flash_attention"]["float32"]
    want = refs["encoded"]
    if got.shape != want.shape:
        raise AssertionError(f"long_context_encoder {where}: shape {got.shape}")
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and np.allclose(got, want, atol=tol, rtol=tol)):
        raise AssertionError(f"long_context_encoder {where} differs from the CPU run by {err}")
    return err


def check_image(got, refs, where):
    want = refs["image_logits"]
    got = got.reshape(-1)
    if not (got.shape == want.shape and np.isfinite(got).all()
            and int(got.argmax()) == int(want.argmax())
            and float(np.abs(got - want).max()) <= 5e-2):
        raise AssertionError(f"ensemble_image {where}: top-1 {int(got.argmax())} (CPU "
                             f"{int(want.argmax())}), max logit diff "
                             f"{float(np.abs(got - want).max())}")
    return float(np.abs(got - want).max())


def process_identity(client, mod, nbytes, device):
    """identity_fp32 at ``nbytes`` over the wire, system shm and cross-process
    cuda shm, each output equal to the input."""
    n = nbytes // 4
    x = torch.arange(n, dtype=torch.float32, device=device).reshape(1, n) * 0.25
    x_host = x.cpu().numpy()
    inp = mod.InferInput("INPUT0", [1, n], "FP32").set_data_from_numpy(x_host)
    if not np.array_equal(client.infer("identity_fp32", [inp]).as_numpy("OUTPUT0"), x_host):
        raise AssertionError(f"identity_fp32 {nbytes} B over the wire changed the tensor")
    tag = os.urandom(4).hex()
    names = (f"psin{tag}", f"psout{tag}")
    regions = [shm.create_shared_memory_region(name, "/" + name, nbytes) for name in names]
    try:
        for name in names:
            client.register_system_shared_memory(name, "/" + name, nbytes)
        shm.set_shared_memory_region(regions[0], [x_host])
        inp = mod.InferInput("INPUT0", [1, n], "FP32").set_shared_memory(names[0], nbytes)
        out = mod.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(names[1], nbytes)
        client.infer("identity_fp32", [inp], outputs=[out])
        if not np.array_equal(shm.get_contents_as_numpy(regions[1], "FP32", [1, n]), x_host):
            raise AssertionError(f"identity_fp32 {nbytes} B over system shm changed the tensor")
    finally:
        client.unregister_system_shared_memory()
        for region in regions:
            shm.destroy_shared_memory_region(region)
    cross = CrossRegions(client, mod, nbytes, nbytes, device)
    try:
        y = cross.infer("identity_fp32", "INPUT0", x, "OUTPUT0", [1, n])
        if y.device.type != torch.device(device).type or not torch.equal(y, x):
            raise AssertionError(f"identity_fp32 {nbytes} B over cuda shm (host window) "
                                 "changed the tensor")
    finally:
        cross.close()
    return 3


def process_decoder_http(client, prompt, steps, seq_id):
    """decoder_lm over the HTTP generate route: the sequence's parameters in
    the payload, one response per request."""
    def run(tokens, start, end):
        event = client.generate("decoder_lm", {"TOKENS": tokens}, parameters={
            "sequence_id": seq_id, "sequence_start": start, "sequence_end": end})
        return (np.asarray(event["LOGITS"], np.float32).reshape(1, -1),
                int(event["NEXT_TOKEN"]))

    return drive_decoder(run, prompt, steps)


def process_correctness(child, refs, size, device, full=True):
    """Every case against the CPU run: simple, identity_fp32 by plane and
    protocol, decoder_lm over the generate route and a GRPC stream,
    long_context_encoder and ensemble_image over cross-process cuda shm,
    and the int8 wire path (quantize and dequantize in this process)."""
    row = {"requests": collections.Counter()}
    h = httpclient.InferenceServerClient(child.http_url, network_timeout=600.0)
    g = grpcclient.InferenceServerClient(child.grpc_url)
    try:
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        b = np.full((1, 16), 3, dtype=np.int32)
        for client, mod in ((h, httpclient), (g, grpcclient)):
            inputs = [mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a),
                      mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)]
            res = client.infer("simple", inputs)
            if not (np.array_equal(res.as_numpy("OUTPUT0"), a + b)
                    and np.array_equal(res.as_numpy("OUTPUT1"), a - b)):
                raise AssertionError("simple returned wrong sums")
            row["requests"]["simple"] += 1
        for nbytes in size.identity_bytes if full else size.identity_bytes[:1]:
            for client, mod in ((h, httpclient), (g, grpcclient)) if full else ((h, httpclient),):
                row["requests"]["identity_fp32"] += process_identity(client, mod, nbytes, device)
        if not full:
            return row

        http_tokens, http_logits = process_decoder_http(h, size.prompt, size.steps, 901)
        grpc_tokens, grpc_logits = stream_decode(g, "decoder_lm", 902, size.prompt, size.steps)
        row["requests"]["decoder_lm"] += 2 * (size.steps + 1)
        row["tokens_stepped"] = 2 * (len(size.prompt) + size.steps)
        want = refs["decoder_logits"].reshape(-1)
        errs = [float(np.abs(lg.reshape(-1) - want).max()) if lg.size == want.size
                else float("inf") for lg in (http_logits, grpc_logits)]
        row["decoder"] = {"http_tokens": http_tokens, "grpc_tokens": grpc_tokens,
                          "cpu_tokens": refs["decoder_tokens"], "max_abs_logit_diff": max(errs)}
        if http_tokens != refs["decoder_tokens"] or grpc_tokens != refs["decoder_tokens"] \
                or not max(errs) <= 5e-2:
            raise AssertionError(f"decoder_lm across processes: {row['decoder']}")

        seq = torch.from_numpy(refs["seq"]).to(device)
        cross = CrossRegions(h, httpclient, seq.numel() * 4, seq.numel() * 4, device)
        try:
            y = cross.infer("long_context_encoder", "sequence", seq, "encoded", list(seq.shape))
            row["encoder_max_abs_diff_vs_cpu"] = check_encoded(y.cpu().numpy(), refs,
                                                               "over cuda shm")
        finally:
            cross.close()
        row["requests"]["long_context_encoder"] += 1

        image = torch.from_numpy(refs["image"]).to(device)
        n_classes = refs["image_logits"].size
        for client, mod in ((h, httpclient), (g, grpcclient)):
            cross = CrossRegions(client, mod, image.numel(), n_classes * 4, device)
            try:
                y = cross.infer("ensemble_image", "IMAGE", image, "CLASSIFICATION",
                                [n_classes, 1, 1])
                row[f"ensemble_max_abs_logit_diff_vs_cpu_{mod.__name__.split('.')[-1]}"] = \
                    check_image(y.cpu().numpy(), refs, "over cuda shm")
            finally:
                cross.close()
            row["requests"]["ensemble_image"] += 1
        row["top1"] = int(refs["image_logits"].argmax())

        if torch.device(device).type == "cuda":
            row["int8"], trips = drive_int8(h, size.int8_rounds)
            row["int8_round_trips"] = trips
            row["requests"]["identity_int8"] += trips
    finally:
        h.close()
        g.close()
    return row


def process_load(child, size, device, extra=()):
    """``PerfRunner`` closed loops (``colocated=False``) at
    ``size.concurrency`` against the child's HTTP frontend: identity_fp32 over
    cuda shm and the wire, ensemble_image and long_context_encoder over
    cuda shm. Every row has 0 errors and the child's success count of the
    requests sent."""
    rows = {}
    shapes = {"identity_fp32": {"INPUT0": [1, size.load_bytes // 4]},
              "ensemble_image": {"IMAGE": list(size.image)},
              "long_context_encoder": {"sequence": [size.seq, 64]}}
    cases = [("identity_fp32", "cuda"), ("identity_fp32", "none"),
             ("ensemble_image", "cuda"), ("long_context_encoder", "cuda")] + list(extra)
    stats = httpclient.InferenceServerClient(child.http_url)
    try:
        for model, mode in cases:
            runner = PerfRunner(child.http_url, "http", model, mode, shapes[model],
                                device=device, colocated=False)
            try:
                # a fresh child's first requests of a model pay its lazy
                # set-up: warm it first; the statistics are read after the
                # runner's set-up probe and the warmup
                runner.run(1, PROCESS_WARMUP)
                before = stats.get_inference_statistics(model)["model_stats"][0]
                levels = [runner.run(c, size.requests) for c in size.concurrency]
            finally:
                runner.close()
                if runner._arena is not None:
                    runner._arena.close(force=True)
            after = stats.get_inference_statistics(model)["model_stats"][0]
            sent = sum(r["requests"] + r["errors"] + r["shed"] for r in levels)
            ok = (after["inference_stats"]["success"]["count"]
                  - before["inference_stats"]["success"]["count"])
            if any(r["errors"] or r["shed"] for r in levels) or ok != sent:
                raise AssertionError(f"serve {child.frontend} {model} {mode}: {ok} successes "
                                     f"of {sent} sent; rows {levels}")
            rows[f"{model} {mode}"] = {
                "rows": [{k: r[k] for k in ("concurrency", "requests", "errors",
                                            "infer_per_sec", "latency_ms")} for r in levels],
                "sent": sent, "executions": after["execution_count"] - before["execution_count"]}
    finally:
        stats.close()
    return rows


def process_perf_cli(child, size, device):
    """``python -m client_tpu_torch.perf`` as a third process against the
    child: identity_fp32 over cuda shm at concurrency 1 and 2."""
    args = [sys.executable, "-m", "client_tpu_torch.perf", "-m", "identity_fp32", "-u",
            child.http_url, "--shape", f"INPUT0:1,{size.load_bytes // 4}",
            "--shared-memory", "cuda", "--device", device, "--concurrency-range", "1:2",
            "--measurement-requests", str(size.cli_requests), "--warmup-requests", "2",
            "-f", "json"]
    with httpclient.InferenceServerClient(child.http_url) as stats:
        before = stats.get_inference_statistics("identity_fp32")["model_stats"][0]
        t0 = time.perf_counter()
        proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        after = stats.get_inference_statistics("identity_fp32")["model_stats"][0]
    if proc.returncode != 0:
        raise AssertionError(f"perf CLI exited {proc.returncode}: {proc.stderr[-4000:]}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    # the runner's set-up probe, the 2 warmup requests and the measured ones
    sent = 1 + 2 + sum(r["requests"] + r["errors"] for r in rows)
    ok = (after["inference_stats"]["success"]["count"]
          - before["inference_stats"]["success"]["count"])
    if any(r["errors"] for r in rows) or ok != sent:
        raise AssertionError(f"perf CLI: {ok} successes of {sent} sent; rows {rows}")
    return {"rows": [{k: r[k] for k in ("concurrency", "requests", "errors", "infer_per_sec",
                                        "latency_ms")} for r in rows],
            "sent": sent, "seconds": seconds}


def process_drain(child, refs, device):
    """SIGTERM under load: ``DRAIN_THREADS`` clients send long_context_encoder
    and ensemble_image requests (HTTP and GRPC, cuda shm and the wire);
    inside serve's grace window HTTP ready reads 503, live 200, ``/metrics``
    ``client_tpu_server_ready 0`` and GRPC ``ServerReady`` false; every
    request sent completes with a correct output, and the child exits 0."""
    stop = threading.Event()
    errors, done = [], collections.Counter()
    started = threading.Barrier(DRAIN_THREADS + 1)
    seq = torch.from_numpy(refs["seq"]).to(device)
    image = torch.from_numpy(refs["image"]).to(device)
    n_classes = refs["image_logits"].size

    def worker(i):
        mod = httpclient if i < DRAIN_THREADS // 2 else grpcclient
        encoder = i % 2 == 0
        client = (mod.InferenceServerClient(child.http_url, network_timeout=600.0)
                  if mod is httpclient else mod.InferenceServerClient(child.grpc_url))
        cross = None
        try:
            if encoder:
                cross = CrossRegions(client, mod, seq.numel() * 4, seq.numel() * 4, device)
            first = True
            while first or not stop.is_set():
                if encoder:
                    y = cross.infer("long_context_encoder", "sequence", seq, "encoded",
                                    list(seq.shape))
                    check_encoded(y.cpu().numpy(), refs, "under the drain")
                else:
                    inp = mod.InferInput("IMAGE", list(refs["image"].shape), "UINT8")
                    inp.set_data_from_numpy(refs["image"])
                    check_image(client.infer("ensemble_image", [inp]).as_numpy(
                        "CLASSIFICATION"), refs, "under the drain")
                done["long_context_encoder" if encoder else "ensemble_image"] += 1
                if first:
                    first = False
                    started.wait(120)
        except Exception as e:  # raised below, after every thread ended
            errors.append((i, repr(e)))
            started.abort()
        finally:
            try:
                if cross is not None:
                    cross.close()
            except Exception as e:
                errors.append((i, f"close: {e!r}"))
            client.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(DRAIN_THREADS)]
    for t in threads:
        t.start()
    row = {}
    try:
        started.wait(120)  # every client has had one answer: the load is on
        h = httpclient.InferenceServerClient(child.http_url)
        g = grpcclient.InferenceServerClient(child.grpc_url)
        base = f"http://{child.http_url}"
        t0 = time.perf_counter()
        child.proc.send_signal(signal.SIGTERM)
        try:
            while h.is_server_ready():
                if time.perf_counter() - t0 > DRAIN_GRACE_S:
                    raise AssertionError("HTTP ready still 200 a grace window after SIGTERM")
                time.sleep(0.005)
            row["ready_503_ms"] = (time.perf_counter() - t0) * 1e3
            with urllib.request.urlopen(base + "/v2/health/live", timeout=5) as r:
                row["live_status"] = r.status
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                text = r.read().decode()
            row["metrics_ready_0"] = "\nclient_tpu_server_ready 0\n" in "\n" + text
            row["metrics_live_1"] = "\nclient_tpu_server_live 1\n" in "\n" + text
            row["grpc_ready"] = g.is_server_ready()
            row["grpc_live"] = g.is_server_live()
            row["checks_done_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            stop.set()
            h.close()
            g.close()
    finally:
        stop.set()
        for t in threads:
            t.join(120)
    row["requests"] = dict(done)
    row["errors"] = errors
    if (errors or any(t.is_alive() for t in threads) or row["live_status"] != 200
            or not row["metrics_ready_0"] or not row["metrics_live_1"] or row["grpc_ready"]
            or not row["grpc_live"] or row["checks_done_ms"] > DRAIN_GRACE_S * 1e3):
        raise AssertionError(f"drain under load: {row}")
    report = child.finish(t0, 15.0)
    row["exit_s"] = report["exit_s"]
    return row, report


def serve_process(device="cuda", size=PROCESS):
    """Phase 8: ``client_tpu_torch.serve`` in processes of its own on
    ``device`` (``SERVE_ARGS``), driven from this one. The threaded child:
    every correctness case against a CPU run of the port on the same seed-0
    weights, then ``PerfRunner`` closed loops at ``size.concurrency``
    (``process_load``), then a SIGTERM drain with no load. The aio child
    (``--http-frontend aio``): simple and identity_fp32, the same loops,
    ``GenAiPerfRunner`` on decoder_lm_batched at ``size.sessions`` sessions
    over GRPC, the perf CLI as a third process, then SIGTERM under load
    (``process_drain``). Each child's final report holds its kernel
    launches to its executions: decode_attention = layers x the tokens
    stepped (decoder_lm) and the batched rounds, flash_attention = the
    encoder's executions, normalize_image = the ensemble's. In this
    process, quantize_int8 and dequantize_int8 launch once per int8 round
    trip. On a CPU ``device`` nothing launches: the gates expect zeros,
    and ``expected_launches`` says what the card would launch."""
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    children = {frontend: ServeChild(device, frontend) for frontend in ("threaded", "aio")}
    result = {"size": size._asdict(), "serve_args": SERVE_ARGS, "load": {}, "steps_s": {}}
    steps, terminated = result["steps_s"], {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        return time.perf_counter()

    def terminate(child):
        try:
            terminated[child.frontend] = child.terminate()
        except Exception as e:  # raised below
            terminated[child.frontend] = e

    try:
        t = time.perf_counter()
        refs = process_references(size)
        t = step("cpu references", t)
        a = children["threaded"].wait_ready()
        t = step("threaded child ready", t)
        result["startup_s"] = {"threaded": a.ready_s}
        result["models"] = a.models
        reset_counts()
        correct = process_correctness(a, refs, size, device)
        client_counts = read_counts()
        t = step("correctness", t)
        result["load"]["threaded"] = process_load(a, size, device)
        t = step("load threaded", t)
        # the threaded child drains (no load) while the aio child is driven
        stopper = threading.Thread(target=terminate, args=(a,))
        stopper.start()

        b = children["aio"].wait_ready()
        result["startup_s"]["aio"] = b.ready_s
        aio_correct = process_correctness(b, refs, size, device, full=False)
        result["load"]["aio"] = process_load(b, size, device)
        t = step("load aio", t)
        # one warm session first: the child's first batched rounds pay its
        # lazy set-up
        GenAiPerfRunner(b.grpc_url, "decoder_lm_batched", "sequence", len(size.prompt),
                        size.output).run(1, 1)
        genai = CountingGenAiRunner(b.grpc_url, "decoder_lm_batched", "sequence",
                                    len(size.prompt), size.output)
        row = genai.run(size.sessions, size.sessions)
        if (row["errors"] or row["incomplete"] or row["sessions"] != size.sessions
                or genai.tokens != size.sessions * size.output):
            raise AssertionError(f"genai decoder_lm_batched over GRPC: {row}")
        result["genai"] = {"row": row, "tokens": genai.tokens}
        t = step("genai", t)
        result["perf_cli"] = process_perf_cli(b, size, device)
        t = step("perf CLI", t)
        result["drain"], report_b = process_drain(b, refs, device)
        t = step("drain", t)
        stopper.join(30)
        report_a = terminated.get("threaded")
        if not isinstance(report_a, dict):
            raise AssertionError(f"serve (threaded) did not drain: {report_a!r}")
    finally:
        for child in children.values():
            child.kill()
    result["correctness"] = {"threaded": correct, "aio": aio_correct}
    result["reports"] = {"threaded": report_a, "aio": report_b}

    # the children's launches against their executions
    expected = {}
    for name, report in result["reports"].items():
        ex = report["executions"]
        stepped = correct["tokens_stepped"] if name == "threaded" else 0
        expected[name] = {
            "decode_attention": report["layers"] * (stepped + report["rounds"]),
            "flash_attention": ex["long_context_encoder"],
            "normalize_image": ex["ensemble_image"],
        }
        if name == "threaded" and ex["decoder_lm"] != correct["requests"]["decoder_lm"]:
            raise AssertionError(f"decoder_lm executions {ex['decoder_lm']} of "
                                 f"{correct['requests']['decoder_lm']} requests sent")
        if any(report["failures"].values()):
            raise AssertionError(f"serve ({name}) counted failures: {report['failures']}")
        if not report["drain_line"]:
            raise AssertionError(f"serve ({name}) printed no drain line")
        want = {k: expected[name].get(k, 0) if on_card else 0 for k in COUNTERS}
        if report["launches"] != want:
            raise AssertionError(f"serve ({name}) launches {report['launches']}, "
                                 f"expected {want}")
        card = torch.cuda.get_device_name(0) if on_card else str(torch.device(device))
        if report["device"] != card:
            raise AssertionError(f"serve ({name}) ran on {report['device']}, not {card}")
    trips = correct.get("int8_round_trips", 0)
    expected["client"] = {"quantize_int8": trips, "dequantize_int8": trips}
    want = {k: expected["client"].get(k, 0) if on_card else 0 for k in COUNTERS}
    if client_counts != want:
        raise AssertionError(f"launches in this process on the int8 path {client_counts}, "
                             f"expected {want}")
    batched = report_b["executions"]["decoder_lm_batched"]
    if batched != (1 + size.sessions) * size.output or not report_b["rounds"]:
        raise AssertionError(f"decoder_lm_batched: {batched} executions for 1 + "
                             f"{size.sessions} sessions x {size.output} tokens, "
                             f"{report_b['rounds']} rounds")
    for name in ("threaded", "aio"):
        if not all(expected[name].values()):
            raise AssertionError(f"serve ({name}): a kernel's path did not run: "
                                 f"{expected[name]}")
    result["launch_counts"] = {"threaded": report_a["launches"], "aio": report_b["launches"],
                               "client": client_counts}
    result["expected_launches"] = expected
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 9: the routing and serving layers (pool, batch, cache, tenancy) over
# a fleet of two ``serve`` processes, this process the client
# ---------------------------------------------------------------------------

PoolSize = collections.namedtuple("PoolSize", [
    "image", "rr_requests", "prompt", "steps", "seq", "affinity_keys", "affinity_requests",
    "hedge_requests", "threads", "coalesce_rows", "window_us", "offered", "offered_s",
    "steady", "aio_requests", "concurrency", "perf_requests", "failover_workers",
    "failover_after"])
POOL = PoolSize(
    image=(224, 224, 3), rr_requests=40, prompt=[1, 2, 3, 4], steps=8, seq=8192,
    affinity_keys=3, affinity_requests=6, hedge_requests=4, threads=16, coalesce_rows=8,
    window_us=20000, offered=40, offered_s=1.0, steady=10, aio_requests=16,
    concurrency=(1, 2, 4, 8), perf_requests=40, failover_workers=4, failover_after=8)
# the metered tenant: 5 requests a second, a burst of 5; the other unmetered
# with weight 3
POOL_TENANCY = "steady,weight=3;burst,rate=5,burst=5"


def fleet_executions(children, model):
    """Each child's execution count of ``model`` (its statistics)."""
    out = []
    for child in children:
        with httpclient.InferenceServerClient(child.http_url) as c:
            out.append(c.get_inference_statistics(model)["model_stats"][0]["execution_count"])
    return out


def settled_executions(children, model, at_least, timeout=30.0):
    """The children's executions of ``model`` once their sum reaches
    ``at_least`` and holds still for three reads (a hedge's loser finishes
    on its replica after the winner answered)."""
    deadline = time.monotonic() + timeout
    last, still = None, 0
    while True:
        now = fleet_executions(children, model)
        still = still + 1 if now == last else 0
        if sum(now) >= at_least and still >= 2:
            return now
        if time.monotonic() > deadline:
            raise AssertionError(f"{model}: executions {now} never settled at >= {at_least}")
        last = now
        time.sleep(0.05)


def pool_encoder_input(mod, refs):
    return [mod.InferInput("sequence", list(refs["seq"].shape), "FP32").set_data_from_numpy(
        refs["seq"])]


def pool_image_input(mod, refs):
    return [mod.InferInput("IMAGE", list(refs["image"].shape), "UINT8").set_data_from_numpy(
        refs["image"])]


def pool_round_robin(children, refs, size):
    """Row 1: round robin over HTTP, ensemble_image on each child in turn."""
    urls = [c.http_url for c in children]
    before = fleet_executions(children, "ensemble_image")
    outputs = []
    with PoolClient(urls, protocol="http", health_interval_s=0.5) as pool:
        pool.wait_healthy()
        for _ in range(size.rr_requests):
            got = pool.infer("ensemble_image", pool_image_input(httpclient, refs)).as_numpy(
                "CLASSIFICATION")
            check_image(got, refs, "round robin over the pool")
            outputs.append(got.reshape(-1).copy())
    split = [a - b for a, b in zip(fleet_executions(children, "ensemble_image"), before)]
    if split != [size.rr_requests // 2] * 2:
        raise AssertionError(f"round robin: ensemble executions {split} of {size.rr_requests}")
    return {"requests": size.rr_requests, "executions": split}, outputs


def pool_sequence(children, refs, size):
    """Row 2: a decoder_lm sequence through ``PoolClient.infer`` pins to one
    child; tokens equal the CPU run's, logits within 5e-2."""
    urls = [c.http_url for c in children]
    before = fleet_executions(children, "decoder_lm")
    with PoolClient(urls, protocol="http", health_interval_s=0.5) as pool:
        def run(tokens, start, end):
            inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], np.int32))
            res = pool.infer("decoder_lm", [inp], sequence_id=977, sequence_start=start,
                             sequence_end=end)
            return res.as_numpy("LOGITS"), int(res.as_numpy("NEXT_TOKEN")[0, 0])

        tokens, logits = drive_decoder(run, size.prompt, size.steps)
    split = [a - b for a, b in zip(fleet_executions(children, "decoder_lm"), before)]
    err = float(np.abs(logits.reshape(-1) - refs["decoder_logits"].reshape(-1)).max())
    if tokens != refs["decoder_tokens"] or not err <= 5e-2:
        raise AssertionError(f"decoder_lm over the pool: tokens {tokens}, CPU "
                             f"{refs['decoder_tokens']}, max logit diff {err}")
    if sorted(split) != [0, size.steps + 1]:
        raise AssertionError(f"sequence pinning: decoder_lm executions {split}")
    stepped = [(len(size.prompt) + size.steps) if n else 0 for n in split]
    return {"executions": split, "tokens": tokens, "max_abs_logit_diff": err,
            "tokens_stepped": stepped}


def pool_affinity(children, refs, size):
    """Row 3: ``routing="affinity"``: each key's encoder requests on one child."""
    urls = [c.http_url for c in children]
    keys = {}
    with PoolClient(urls, protocol="http", routing="affinity", health_interval_s=0.5) as pool:
        pool.wait_healthy()
        for k in range(size.affinity_keys):
            before = fleet_executions(children, "long_context_encoder")
            for _ in range(size.affinity_requests):
                got = pool.infer("long_context_encoder", pool_encoder_input(httpclient, refs),
                                 affinity_key=f"session{k}").as_numpy("encoded")
                check_encoded(got, refs, "by affinity over the pool")
            split = [a - b for a, b in zip(fleet_executions(children, "long_context_encoder"),
                                           before)]
            if sorted(split) != [0, size.affinity_requests]:
                raise AssertionError(f"affinity key session{k}: executions {split}")
            keys[f"session{k}"] = split
        stats = pool.endpoint_stats()
    # every pick landed on its key's home: routed, never rehomed or spilled
    view = {url: stats[url]["affinity"] for url in urls}
    if (sum(v["routed"] for v in view.values()) != size.affinity_keys * size.affinity_requests
            or sum(v["keys"] for v in view.values()) != size.affinity_keys):
        raise AssertionError(f"affinity: endpoint_stats {view}")
    return {"keys": keys, "endpoint_stats": view,
            "executions": [sum(v[i] for v in keys.values()) for i in range(2)]}


def pool_hedge(children, refs, size):
    """Row 4: a ``HedgePolicy`` of fixed delay 0 over the wire: both children
    execute, and the executions (not the requests) are what launches."""
    urls = [c.http_url for c in children]
    before = fleet_executions(children, "long_context_encoder")
    with PoolClient(urls, protocol="http", health_interval_s=0.5,
                    hedge=HedgePolicy(delay_s=0.0, jitter_frac=0.0)) as pool:
        pool.wait_healthy()
        for _ in range(size.hedge_requests):
            got = pool.infer("long_context_encoder", pool_encoder_input(httpclient, refs)).as_numpy(
                "encoded")
            check_encoded(got, refs, "hedged over the pool")
        # a loser runs on in the background after its winner answered, and
        # closing the pool cuts it: a replica's first (cold) encoder
        # execution can outlast every winner, so let each attempt end first
        with pool._executor_lock:
            executor = pool._executor
        ended = threading.Thread(target=executor.shutdown, kwargs={"wait": True}, daemon=True)
        ended.start()
        ended.join(60)
        if ended.is_alive():
            raise AssertionError("hedging: attempts still in flight after 60 s: "
                                 f"{[ep.outstanding for ep in pool.pool.endpoints]}")
        after = settled_executions(children, "long_context_encoder",
                                   sum(before) + size.hedge_requests)
    split = [a - b for a, b in zip(after, before)]
    if not all(split) or sum(split) < size.hedge_requests:
        raise AssertionError(f"hedging: executions {split} for {size.hedge_requests} requests")
    return {"requests": size.hedge_requests, "executions": split}


class _UntilCollapsed:
    """The pool under the caching layer, its leader's call held until the
    other callers have joined the flight (so the collapse does not depend
    on how fast the threads arrive)."""

    def __init__(self, pool, followers):
        self.pool, self.followers, self.wrapper = pool, followers, None

    def infer(self, *args, **kwargs):
        deadline = time.monotonic() + 60
        while True:
            with self.wrapper._flights_lock:
                joined = max((f.followers for f in self.wrapper._flights.values()), default=0)
            if joined >= self.followers:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"singleflight: {joined} followers joined")
            time.sleep(0.001)
        return self.pool.infer(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.pool, name)


def pool_singleflight(children, refs, size, device):
    """Row 5: ``PoolClient(...).caching()``: identical concurrent encoder
    requests collapse onto one wire request; repeats are hits, bit-equal
    to the miss, and a hit's ``as_torch`` equals it on ``device``."""
    urls = [c.http_url for c in children]
    before = fleet_executions(children, "long_context_encoder")
    pool = PoolClient(urls, protocol="http", health_interval_s=0.5)
    client = pool.caching()
    gate = _UntilCollapsed(pool, size.threads - 1)
    gate.wrapper, client._inner = client, gate
    results, errors = [None] * size.threads, []
    start = threading.Barrier(size.threads)

    def caller(i):
        try:
            start.wait(60)
            results[i] = client.infer("long_context_encoder", pool_encoder_input(httpclient, refs))
        except Exception as e:  # raised below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in range(size.threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if errors:
            raise AssertionError(f"singleflight: {errors[:3]}")
        stats = client.cache_stats()
        miss = results[0].as_numpy("encoded").copy()
        check_encoded(miss, refs, "through singleflight")
        if (stats["wire_requests"], stats["singleflight_collapsed"]) != (1, size.threads - 1) \
                or not all(np.array_equal(r.as_numpy("encoded"), miss) for r in results):
            raise AssertionError(f"singleflight: {stats}")
        mid = fleet_executions(children, "long_context_encoder")
        hits = [client.infer("long_context_encoder", pool_encoder_input(httpclient, refs))
                for _ in range(size.threads)]
        stats = client.cache_stats()
        after = fleet_executions(children, "long_context_encoder")
        if stats["hit"] != size.threads or after != mid or not all(
                h.as_numpy("encoded").tobytes() == miss.tobytes() for h in hits):
            raise AssertionError(f"cache hits: {stats}, executions {mid} -> {after}")
        on_device = hits[0].as_torch("encoded", device)
        if on_device.device.type != torch.device(device).type or not torch.equal(
                on_device.cpu(), torch.from_numpy(miss)):
            raise AssertionError("a hit's as_torch differs from the miss")
    finally:
        client.close()
    split = [a - b for a, b in zip(after, before)]
    return {"threads": size.threads, "wire_requests": stats["wire_requests"],
            "singleflight_collapsed": stats["singleflight_collapsed"], "hits": stats["hit"],
            "executions": split}


def pool_coalescing(children, size):
    """Row 6: ``.coalescing(window_us=..., batch_max_rows=8)`` on
    batched_matmul: one row a thread, fewer executions than rows, each row
    within 1e-5 of a solo call (cuBLAS may pick another algorithm at M = 8)."""
    urls = [c.http_url for c in children]
    rows = np.random.default_rng(6).standard_normal((size.coalesce_rows, 64)).astype(np.float32)
    got, errors = [None] * size.coalesce_rows, []
    pool = PoolClient(urls, protocol="http", health_interval_s=0.5)
    client = pool.coalescing(window_us=size.window_us, batch_max_rows=size.coalesce_rows)
    start = threading.Barrier(size.coalesce_rows)

    def x(i):
        return [httpclient.InferInput("X", [1, 64], "FP32").set_data_from_numpy(rows[i:i + 1])]

    def caller(i):
        try:
            start.wait(60)
            got[i] = client.infer("batched_matmul", x(i)).as_numpy("Y")
        except Exception as e:  # raised below
            errors.append(repr(e))

    try:
        pool.wait_healthy()
        before = fleet_executions(children, "batched_matmul")
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(size.coalesce_rows)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        split = [a - b for a, b in zip(fleet_executions(children, "batched_matmul"), before)]
        batch = client.stats()
        solo = [pool.infer("batched_matmul", x(i)).as_numpy("Y") for i in range(size.coalesce_rows)]
    finally:
        client.close()
    err = max(float(np.abs(g - s_).max()) for g, s_ in zip(got, solo)) if not errors else None
    if errors or sum(split) >= size.coalesce_rows or not err <= 1e-5:
        raise AssertionError(f"coalescing: errors {errors[:3]}, executions {split}, "
                             f"max diff {err}")
    return {"rows": size.coalesce_rows, "executions": split, "dispatches": batch["dispatches"],
            "max_abs_diff_vs_solo": err}


def pool_tenancy(children, refs, size):
    """Row 7: an ``AdmissionController`` on the pool from ``POOL_TENANCY``:
    the metered tenant offers ``size.offered`` encoder requests in
    ``size.offered_s`` and sheds its excess as typed ``over_quota`` with a
    positive ``retry_after_s``; the unmetered tenant sheds nothing."""
    urls = [c.http_url for c in children]
    controller = AdmissionController(tenancy=POOL_TENANCY)
    verdicts = collections.Counter()
    retry = []
    before = fleet_executions(children, "long_context_encoder")
    with PoolClient(urls, protocol="http", health_interval_s=0.5,
                    admission=controller) as pool:
        pool.wait_healthy()
        steady_every = max(1, size.offered // size.steady)
        t0 = time.monotonic()
        for i in range(size.offered):
            delay = t0 + i * size.offered_s / size.offered - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            for tenant in ("burst",) + (("steady",) if i % steady_every == 0 else ()):
                try:
                    got = pool.infer("long_context_encoder", pool_encoder_input(httpclient, refs),
                                     tenant=tenant).as_numpy("encoded")
                    check_encoded(got, refs, f"admitted for {tenant}")
                    verdicts[(tenant, "ok")] += 1
                except AdmissionRejected as e:
                    verdicts[(tenant, e.reason)] += 1
                    retry.append(e.retry_after_s)
    split = [a - b for a, b in zip(fleet_executions(children, "long_context_encoder"), before)]
    admitted = verdicts[("burst", "ok")] + verdicts[("steady", "ok")]
    shed = sum(n for (t, v), n in verdicts.items() if t == "burst" and v != "ok")
    if (shed < size.offered - 10 or verdicts[("burst", "over_quota")] != shed
            or not all(r is not None and r > 0 for r in retry)
            or any(v != "ok" for (t, v) in verdicts if t == "steady")
            or sum(split) != admitted):
        raise AssertionError(f"tenancy: verdicts {dict(verdicts)}, executions {split}")
    return {"verdicts": {f"{t} {v}": n for (t, v), n in sorted(verdicts.items())},
            "retry_after_s_min": min(retry), "executions": split,
            "snapshot": controller.tenancy.snapshot()["tenants"]}


def pool_aio_grpc(children, refs, size, row1_outputs):
    """Row 8: ``AioPoolClient`` over both children's GRPC ports, the
    ensemble requests gathered at once; outputs equal row 1's."""
    urls = [c.grpc_url for c in children]
    before = fleet_executions(children, "ensemble_image")

    async def run():
        pool = AioPoolClient(urls, protocol="grpc", health_interval_s=0.5)
        try:
            results = await asyncio.gather(*[
                pool.infer("ensemble_image", pool_image_input(grpcclient, refs))
                for _ in range(size.aio_requests)])
        finally:
            await pool.close()
        return [r.as_numpy("CLASSIFICATION").reshape(-1) for r in results]

    outputs = asyncio.run(run())
    split = [a - b for a, b in zip(fleet_executions(children, "ensemble_image"), before)]
    if sum(split) != size.aio_requests or not all(
            any(np.array_equal(o, r) for r in row1_outputs) for o in outputs):
        raise AssertionError(f"aio GRPC pool: executions {split}, outputs differ from row 1's")
    return {"requests": size.aio_requests, "executions": split}


def pool_perf(children, size):
    """Row 9 (readings, not gates): ``PerfRunner`` on the encoder over the
    wire at ``size.concurrency``, one child alone and the pool of both."""
    shape = {"sequence": [size.seq, 64]}
    rows = {}
    for name, endpoints in (("one child", None),
                            ("pool of two", [c.http_url for c in children])):
        runner = PerfRunner(children[0].http_url, "http", "long_context_encoder", "none", shape,
                            endpoints=endpoints, device="cpu")
        try:
            runner.run(1, PROCESS_WARMUP)
            levels = [runner.run(c, size.perf_requests) for c in size.concurrency]
        finally:
            runner.close()
        if any(r["errors"] or r["shed"] for r in levels):
            raise AssertionError(f"pool perf {name}: {levels}")
        rows[name] = [{k: r[k] for k in ("concurrency", "requests", "errors", "infer_per_sec",
                                         "latency_ms")} for r in levels]
    return rows


def pool_failover(children, refs, size):
    """Row 10 (last): SIGTERM to the second child while
    ``size.failover_workers`` pool workers drive ensemble_image: no error,
    one ``EndpointHealthChanged(healthy=False)`` for its URL, and once it
    has exited every request on the survivor."""
    a, b = children
    events = []
    errors, done = [], collections.Counter()
    stop = threading.Event()
    started = threading.Barrier(size.failover_workers + 1)
    pool = PoolClient([a.http_url, b.http_url], protocol="http", health_interval_s=0.05,
                      probe_timeout_s=0.5, on_event=events.append)

    def worker(i):
        first = True
        try:
            while first or not stop.is_set():
                got = pool.infer("ensemble_image", pool_image_input(httpclient, refs)).as_numpy(
                    "CLASSIFICATION")
                check_image(got, refs, "under failover")
                done["after" if stop.is_set() else "during"] += 1
                if first:
                    first = False
                    started.wait(120)
        except Exception as e:  # raised below
            errors.append((i, repr(e)))
            started.abort()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(size.failover_workers)]
    report = None
    try:
        pool.wait_healthy()
        for t in threads:
            t.start()
        started.wait(120)
        t0 = time.perf_counter()
        b.sigterm()
        deadline = time.monotonic() + 10
        while not any(isinstance(e, EndpointHealthChanged) and e.url == b.http_url
                      and not e.healthy for e in events):
            if time.monotonic() > deadline or errors:
                raise AssertionError(f"failover: no health change for {b.http_url}: "
                                     f"{events}, errors {errors}")
            time.sleep(0.01)
        unhealthy_ms = (time.perf_counter() - t0) * 1e3
        report = b.finish(t0, 15.0)
        calls_b = pool.endpoint_stats()[b.http_url]["resilience"]["calls"]
        survivor_before = fleet_executions([a], "ensemble_image")[0]
        count_before = done["during"]
        while done["during"] < count_before + size.failover_after and not errors:
            time.sleep(0.01)
        stats = pool.endpoint_stats()
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        pool.close()
    survivor = fleet_executions([a], "ensemble_image")[0] - survivor_before
    changes = [e for e in events if isinstance(e, EndpointHealthChanged)
               and e.url == b.http_url and not e.healthy]
    row = {"unhealthy_ms": unhealthy_ms, "requests": dict(done), "errors": errors,
           "health_changes": len(changes), "exit_s": report["exit_s"],
           "calls_on_drained_after_exit": stats[b.http_url]["resilience"]["calls"] - calls_b,
           "survivor_executions_after_exit": survivor}
    if (errors or len(changes) != 1 or row["calls_on_drained_after_exit"]
            or survivor < size.failover_after):
        raise AssertionError(f"failover under drain: {row}")
    return row, report


def serve_pool(device="cuda", size=POOL, start_children=None):
    """Phase 9: ``client_tpu_torch.pool``, ``batch``, ``cache`` and
    ``tenancy`` over two ``serve`` children on ``device`` (``SERVE_ARGS``,
    threaded HTTP frontends), started at once; this process the client.
    ``start_children`` (tests) returns the two children instead. Rows 1-10
    (see the module docstring), each output against the CPU run of the port
    with the same seed-0 weights. This process launches nothing: its
    counts are reset before each row and read after it. Each child's final
    report holds its launches to its executions: decode_attention = layers
    x the tokens it stepped, flash_attention = the encoder's,
    normalize_image = the ensemble's."""
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    if start_children is None:
        children = [ServeChild(device, "threaded"), ServeChild(device, "threaded")]
    else:
        children = start_children()
    result = {"size": size._asdict(), "rows": {}, "client_counts": {}, "steps_s": {}}
    rows = result["rows"]
    try:
        t = time.perf_counter()
        refs = process_references(size)
        result["steps_s"]["cpu references"] = time.perf_counter() - t
        t = time.perf_counter()
        for child in children:
            child.wait_ready()
        result["steps_s"]["children ready"] = time.perf_counter() - t
        result["urls"] = [[c.http_url, c.grpc_url] for c in children]

        def row(name, fn, *args):
            reset_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            result["steps_s"][name] = time.perf_counter() - t0
            counts = read_counts()
            if any(counts.values()):
                raise AssertionError(f"pool row {name}: this process launched {counts}")
            result["client_counts"][name] = counts
            return out

        rows["round robin"], row1 = row("round robin", pool_round_robin, children, refs, size)
        rows["sequence"] = row("sequence", pool_sequence, children, refs, size)
        rows["affinity"] = row("affinity", pool_affinity, children, refs, size)
        rows["hedge"] = row("hedge", pool_hedge, children, refs, size)
        rows["singleflight"] = row("singleflight", pool_singleflight, children, refs, size,
                                   device)
        rows["coalescing"] = row("coalescing", pool_coalescing, children, size)
        rows["tenancy"] = row("tenancy", pool_tenancy, children, refs, size)
        rows["aio grpc"] = row("aio grpc", pool_aio_grpc, children, refs, size, row1)
        rows["perf"] = row("perf", pool_perf, children, size)
        rows["failover"], report_b = row("failover", pool_failover, children, refs, size)
        report_a = children[0].terminate()
    finally:
        for child in children:
            child.kill()
    result["reports"] = [report_a, report_b]

    expected = []
    for i, report in enumerate(result["reports"]):
        ex = report["executions"]
        stepped = rows["sequence"]["tokens_stepped"][i]
        want = {"decode_attention": report["layers"] * stepped,
                "flash_attention": ex["long_context_encoder"],
                "normalize_image": ex["ensemble_image"]}
        expected.append(want)
        if ex["decoder_lm"] != rows["sequence"]["executions"][i] or report["rounds"]:
            raise AssertionError(f"serve child {i}: decoder executions {ex['decoder_lm']}, "
                                 f"batched rounds {report['rounds']}")
        if any(report["failures"].values()):
            raise AssertionError(f"serve child {i} counted failures: {report['failures']}")
        if report.get("launches") is not None:
            got = {k: want.get(k, 0) if on_card else 0 for k in COUNTERS}
            if report["launches"] != got:
                raise AssertionError(f"serve child {i} launches {report['launches']}, "
                                     f"expected {got}")
            card = torch.cuda.get_device_name(0) if on_card else str(torch.device(device))
            if report["device"] != card:
                raise AssertionError(f"serve child {i} ran on {report['device']}, not {card}")
    total = {k: sum(e[k] for e in expected) for k in expected[0]}
    if not all(total.values()):
        raise AssertionError(f"pool phase: a kernel's path did not run: {total}")
    if not report_b["drain_line"]:
        raise AssertionError("the drained child printed no drain line")
    result["launch_counts"] = [r.get("launches") for r in result["reports"]]
    result["expected_launches"] = expected
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 10: the orchestration layers (shard, disagg, pipeline) over ``serve``
# children, this process the client
# ---------------------------------------------------------------------------

OrchSize = collections.namedtuple("OrchSize", [
    "prompts", "prompt_len", "max_tokens", "kill_after", "abandon_after", "shard_rows",
    "shard_len", "matmul_rows", "chain_runs", "image", "concurrency", "perf_requests",
    "records", "mixed"])
ORCH = OrchSize(
    prompts=3, prompt_len=16, max_tokens=16, kill_after=4, abandon_after=3, shard_rows=8,
    shard_len=16, matmul_rows=8, chain_runs=4, image=(224, 224, 3), concurrency=(1, 2),
    perf_requests=20, records=20,
    mixed=("mixed:duration_s=2,rate=20,stream_fraction=0.1,seq_fraction=0.1,"
           "shard_fraction=0.2,shard_model=decoder_lm_prefill,disagg_fraction=0.2,"
           "pipeline_fraction=0.2,max_prompt=24,max_output=8"))
# the decoder's logit bound against the CPU run; a greedy token may differ
# from the CPU run's where the CPU's top two logits are closer than twice it
DECODER_LOGIT_TOL = 5e-2
NEAR_TIE = 2 * DECODER_LOGIT_TOL
SHARD_SPEC = "TOKENS=0->LOGITS=0,NEXT_TOKEN=0"
# the wire requests one record of each kind makes: a sharded record one a
# shard, a prefill/decode session its prefill infer and its decode stream, a
# pipeline run one a stage
RECORD_REQUESTS = {"unary": 1, "sequence": 1, "generate_stream": 1, "sharded": 2,
                   "prefill_decode": 2, "pipeline": 3}


def orchestration_references(size):
    """The CPU run of the port with the same seeded weights as the children:
    ``size.prompts`` seeded prompts' greedy streams (tiny_lm_generate's path,
    with each step's top-two margin), decoder_lm_prefill on the shard row's
    seeded tokens, a seeded image's ensemble_image logits, and the chain's
    fused scores on seeded RAW."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, TinyDecoderModel.VOCAB, size.prompt_len).tolist()
               for _ in range(size.prompts)]
    decoder = TinyDecoderModel(device="cpu")
    streams, margins = [], []
    with torch.no_grad():
        for prompt in prompts:
            caches = decoder.fresh_cache()
            logits = decoder.prefill(caches, np.array(prompt), 0)
            tokens, gaps = [], []
            for i in range(size.max_tokens):
                top2 = torch.topk(logits.float(), 2).values
                gaps.append(float(top2[0] - top2[1]))
                tokens.append(int(logits.argmax()))
                if i + 1 < size.max_tokens:
                    logits = decoder.prefill(caches, np.array(tokens[-1:]), len(prompt) + i)
            streams.append(tokens)
            margins.append(gaps)
        shard_tokens = np.random.default_rng(19).integers(
            0, TinyDecoderModel.VOCAB, (size.shard_rows, size.shard_len), dtype=np.int32)
        prefill = PrefillDecoderModel(decoder=decoder).execute({"TOKENS": shard_tokens}, {})
    image = np.random.default_rng(0).integers(0, 256, size.image, dtype=np.uint8)
    vision = ServerCore(build_image_ensemble(device="cpu"), device="cpu")
    logits = vision.infer("ensemble_image", "", {"inputs": [{
        "name": "IMAGE", "datatype": "UINT8", "shape": list(image.shape),
        "array": image}]})["outputs"][0]["array"]
    raw = np.random.default_rng(17).integers(-10**6, 10**6, (1, 16)).astype(np.int32)
    scores = ChainFusedModel(chain_core("cpu")).execute({"RAW": raw}, {})["SCORES"]
    return {"prompts": prompts, "streams": streams, "margins": margins, "image": image,
            "image_logits": np.asarray(logits.cpu() if isinstance(logits, torch.Tensor)
                                       else logits).reshape(-1),
            "shard_tokens": shard_tokens, "shard_logits": prefill["LOGITS"],
            "raw": raw, "chain_scores": scores.numpy()}


def near_tie_check(got, want, margins, where):
    """``got`` equal to the CPU stream ``want``, or equal up to a first
    difference where the CPU's top-two margin is a near tie; returns that
    index (None when equal)."""
    if got == want:
        return None
    first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    if len(got) != len(want) or margins[first] >= NEAR_TIE:
        raise AssertionError(f"{where}: tokens {got} differ from the CPU run's {want} at "
                             f"{first} (top-two margin {margins[first]:.4g})")
    return first


def drain_disagg(stream, on_token=None):
    tokens, indices = [], []
    for event in stream:
        tokens.append(int(event["NEXT_TOKEN"]))
        indices.append(int(event["INDEX"]))
        if on_token is not None:
            on_token(len(tokens))
    return tokens, indices


def monolithic_stream(url, prompt, max_tokens):
    with httpclient.InferenceServerClient(url) as c:
        return [int(e["NEXT_TOKEN"]) for e in c.generate_stream(
            "tiny_lm_generate", {"TOKENS": [prompt], "MAX_TOKENS": max_tokens})]


def orch_disagg(children, refs, size):
    """Row 1: ``DisaggClient`` with the prefill role on the first child and
    the decode role on the second, over an arena pool; then the same
    prompts through ``AioDisaggClient``; then a tampered slab."""
    a, b = children[:2]
    specs = [EndpointSpec(a.http_url, role="prefill"), EndpointSpec(b.http_url, role="decode")]
    row = {"sessions": [], "near_ties": []}
    pool = PoolClient(specs, protocol="http", shm_arena=True, health_interval_s=None)
    client = DisaggClient(pool)
    try:
        first = None
        for i, prompt in enumerate(refs["prompts"]):
            t0 = time.perf_counter()
            tokens, indices = drain_disagg(client.generate_stream(prompt,
                                                                  max_tokens=size.max_tokens))
            wall_ms = (time.perf_counter() - t0) * 1e3
            mono = monolithic_stream(a.http_url, prompt, size.max_tokens)
            if tokens != mono or indices != list(range(size.max_tokens)):
                raise AssertionError(f"disagg prompt {i}: {tokens} (indices {indices}) != "
                                     f"tiny_lm_generate {mono}")
            row["near_ties"].append(near_tie_check(tokens, refs["streams"][i],
                                                   refs["margins"][i], f"disagg prompt {i}"))
            row["sessions"].append({"tokens": tokens, "ms": wall_ms})
            if first is None:
                first = client.arena().stats()
        last = client.arena().stats()
        row["arena"] = {k: last[k] for k in ("regions_created", "registrations_issued",
                                             "leased_bytes")}
        row["steady_region_creates"] = last["regions_created"] - first["regions_created"]
        row["steady_registrations"] = (last["registrations_issued"]
                                       - first["registrations_issued"])
        row["family"] = client.arena().default_family
        if (row["steady_region_creates"] or row["steady_registrations"]
                or last["leased_bytes"] or row["family"] != "system"):
            raise AssertionError(f"disagg steady state: {row}")
        # a tampered slab: the digest refuses it before any token
        budget = AttemptBudget(client.inner._budget_policy, None)
        handoff = client._prefill_leg(refs["prompts"][0], budget, 0, "")
        try:
            handoff.verify(b.http_url)
            view = handoff.lease.memoryview()
            view[7] = (view[7] + 1) % 256
            try:
                handoff.verify(b.http_url)
            except HandoffCorrupt as e:
                row["tampered"] = {"field": e.field, "url": e.url}
            else:
                raise AssertionError("a tampered handoff verified")
        finally:
            handoff.release()
        real_leg = client._prefill_leg

        def tampering_leg(*args):
            h = real_leg(*args)
            v = h.lease.memoryview()
            v[0] = (v[0] + 1) % 256
            return h

        client._prefill_leg = tampering_leg
        emitted = []
        try:
            for event in client.generate_stream(refs["prompts"][0], max_tokens=4):
                emitted.append(event)
        except HandoffCorrupt as e:
            row["tampered_session"] = {"field": e.field, "tokens_before": len(emitted)}
        else:
            raise AssertionError("a tampered session streamed to its end")
        if emitted or client.arena().stats()["leased_bytes"]:
            raise AssertionError(f"tampered session: {len(emitted)} tokens before the refusal")
    finally:
        pool.close()

    async def aio_sessions():
        apool = AioPoolClient(specs, protocol="http", shm_arena=True, health_interval_s=None)
        aclient = AioDisaggClient(apool)
        try:
            out = []
            for prompt in refs["prompts"]:
                tokens = []
                async for event in aclient.generate_stream(prompt, max_tokens=size.max_tokens):
                    tokens.append(int(event["NEXT_TOKEN"]))
                out.append(tokens)
            return out
        finally:
            await apool.close()

    aio = asyncio.run(aio_sessions())
    if aio != [s["tokens"] for s in row["sessions"]]:
        raise AssertionError(f"AioDisaggClient {aio} != DisaggClient")
    row["aio_equal"] = True
    return row


def orch_recovery(children, refs, size):
    """Row 2: re-prefill recovery. The prefill role on the first child, the
    decode role on a victim child and on the second child: the victim is
    SIGKILLed after ``size.kill_after`` tokens of a session it serves, and
    the session ends on the second child, every index once, the tokens the
    monolithic ones. Then the prefill child with a second victim as the only
    decode replica, killed mid-stream: ``DecodeAbandoned`` names it."""
    a, b, victim, lone = children
    mono = monolithic_stream(a.http_url, refs["prompts"][0], size.max_tokens)
    tel = Telemetry(flight=FlightRecorder(baseline_ratio=1.0))
    pool = PoolClient([EndpointSpec(a.http_url, role="prefill"),
                       EndpointSpec(victim.http_url, role="decode"),
                       EndpointSpec(b.http_url, role="decode")],
                      protocol="http", shm_arena=True, health_interval_s=None,
                      routing="round_robin", telemetry=tel)
    legs = []
    pinned = pool.pinned_generate_stream

    def recording(url, *args, **kwargs):
        legs.append(url)
        return pinned(url, *args, **kwargs)

    pool.pinned_generate_stream = recording
    client = DisaggClient(pool)
    row = {"sessions": 0}
    try:
        for _ in range(3):
            legs.clear()
            killed = []

            def maybe_kill(n):
                if not killed and n == size.kill_after and legs[-1] == victim.http_url:
                    victim.kill()
                    killed.append(n)

            tokens, indices = drain_disagg(
                client.generate_stream(refs["prompts"][0], max_tokens=size.max_tokens),
                maybe_kill)
            row["sessions"] += 1
            if tokens != mono or indices != list(range(size.max_tokens)):
                raise AssertionError(f"recovery: {tokens} (indices {indices}) != {mono}")
            if killed:
                row["decode_legs"] = list(legs)
                break
        else:
            raise AssertionError("recovery: no session ran on the victim's decode replica")
        names = [e[2] for t in tel.flight.retained() for e in t.events if e[1] == "disagg"]
        for event in ("decode_died", "reprefill", "handoff", "verify"):
            if event not in names:
                raise AssertionError(f"recovery: no disagg.{event} in the flight recorder")
        row["resumed_on"] = legs[-1]
        if legs[-1] != b.http_url or client.arena().stats()["leased_bytes"]:
            raise AssertionError(f"recovery: resumed on {legs[-1]}, legs {legs}")
    finally:
        pool.close()

    client = DisaggClient([EndpointSpec(a.http_url, role="prefill"),
                           EndpointSpec(lone.http_url, role="decode")],
                          protocol="http", health_interval_s=None)
    got = []
    try:
        for event in client.generate_stream(refs["prompts"][1], max_tokens=size.max_tokens):
            got.append(int(event["NEXT_TOKEN"]))
            if len(got) == size.abandon_after:
                lone.kill()
    except DecodeAbandoned as e:
        row["abandoned"] = {"url": e.url, "emitted": e.emitted, "cause": type(e.cause).__name__}
        if e.url != lone.http_url or e.emitted != len(got) or len(got) < size.abandon_after:
            raise AssertionError(f"DecodeAbandoned: {row['abandoned']}, {len(got)} received")
    else:
        raise AssertionError("the lone decode replica's death was not DecodeAbandoned")
    finally:
        client.close()
    return row


def orch_shard(children, refs, size, dead):
    """Row 3: ``ShardedClient`` over the two children, ``decoder_lm_prefill``
    rows and ``batched_matmul``: the gather bit-equal to the per-shard
    direct calls, NEXT_TOKEN equal to one unsharded call, the logits within
    5e-2 of it; then a layout whose second shard is a SIGKILLed child."""
    a, b = children[:2]
    urls = [a.http_url, b.http_url]
    cases = {"decoder_lm_prefill": ("TOKENS", refs["shard_tokens"],
                                    {"LOGITS": 0, "NEXT_TOKEN": 0}),
             "batched_matmul": ("X", np.random.default_rng(19).standard_normal(
                 (size.matmul_rows, 64)).astype(np.float32), {"Y": 0})}
    row = {}

    def wire(name, x):
        return httpclient.InferInput(name, list(x.shape), "INT32" if x.dtype == np.int32
                                     else "FP32").set_data_from_numpy(x)

    def direct(url, model, name, x):
        with httpclient.InferenceServerClient(url) as c:
            res = c.infer(model, [wire(name, x)])
            return {out: res.as_numpy(out) for out in cases[model][2]}

    for model, (name, x, outputs) in cases.items():
        layout = ShardLayout(urls, inputs={name: 0}, outputs=outputs)
        bounds = layout.inputs[name].resolve(name, x.shape[0], 2)
        with ShardedClient(urls, layout, health_interval_s=None) as client:
            res = client.infer(model, [wire(name, x)])
            got = {out: res.as_numpy(out).copy() for out in outputs}
            res.release()
        parts = [direct(u, model, name, x[lo:hi]) for u, (lo, hi) in zip(urls, bounds)]
        whole = direct(a.http_url, model, name, x)
        diffs = {}
        for out in outputs:
            cat = np.concatenate([p[out] for p in parts])
            if not np.array_equal(got[out], cat):
                raise AssertionError(f"shard {model} {out}: the gather differs from the "
                                     "per-shard calls")
            diffs[out] = float(np.abs(got[out].astype(np.float64)
                                      - whole[out].astype(np.float64)).max())
        if model == "decoder_lm_prefill" and (
                not np.array_equal(got["NEXT_TOKEN"], whole["NEXT_TOKEN"])
                or not diffs["LOGITS"] <= DECODER_LOGIT_TOL):
            raise AssertionError(f"shard decoder_lm_prefill vs one call: {diffs}")
        if model == "batched_matmul" and diffs["Y"] > 1e-5:
            raise AssertionError(f"shard batched_matmul vs one call: {diffs}")
        row[model] = {"rows": int(x.shape[0]), "bounds": bounds,
                      "max_abs_diff_vs_one_call": diffs}
        if model == "decoder_lm_prefill":
            # against the CPU run: logits within the bound, each row's next
            # token the CPU's but where the CPU's top two are a near tie
            want = refs["shard_logits"]
            err = float(np.abs(got["LOGITS"] - want).max())
            top2 = np.sort(want, axis=1)[:, -2:]
            ties = [i for i, (t, w) in enumerate(zip(got["NEXT_TOKEN"].reshape(-1),
                                                      want.argmax(axis=1)))
                    if t != w]
            if not err <= DECODER_LOGIT_TOL or any(top2[i, 1] - top2[i, 0] >= NEAR_TIE
                                                   for i in ties):
                raise AssertionError(f"shard decoder_lm_prefill vs the CPU run: {err}, "
                                     f"next tokens differ at rows {ties}")
            row[model].update(max_abs_logit_diff_vs_cpu=err, near_tie_rows=ties)

    name, x, outputs = cases["decoder_lm_prefill"]
    layout = ShardLayout([a.http_url, dead.http_url], inputs={name: 0}, outputs=outputs)
    client = ShardedClient(PoolClient(layout.endpoints, protocol="http",
                                      health_interval_s=None), layout)
    try:
        client.infer("decoder_lm_prefill", [wire(name, x)], client_timeout=10.0)
    except ShardFailed as e:
        row["killed_shard"] = {"shard": e.shard, "url": e.url,
                               "cause": type(e.cause).__name__}
        if (e.shard, e.url) != (1, dead.http_url):
            raise AssertionError(f"ShardFailed named {row['killed_shard']}")
    else:
        raise AssertionError("a layout with a killed shard gathered")
    finally:
        client.close()
    return row


def vision_pipeline(size):
    """``preprocess(raw_image) -> densenet_onnx(data_0)`` declared as a
    pipeline over the children's vision models."""
    return Pipeline(
        name="vision",
        stages=[Stage("preprocess", "preprocess", inputs={"raw_image": "$.IMAGE"},
                      outputs={"preprocessed": ("FP32", [3, 224, 224])}),
                Stage("classify", "densenet_onnx",
                      inputs={"data_0": "preprocess.preprocessed"},
                      outputs={"fc6_1": ("FP32", [1000, 1, 1])})],
        inputs={"IMAGE": ("UINT8", list(size.image))},
        outputs={"LOGITS": "classify.fc6_1"})


def orch_pipeline(children, refs, size):
    """Row 4: ``chain_pipeline()`` over the pool of the two children, bit-equal
    to ``chain_fused`` on one child, no region created and no registration
    issued after the first run, each run's peak arena residency the plan's
    high water; then the vision pipeline on the first child against the CPU
    run and against ensemble_image there."""
    a, b = children[:2]
    raw = refs["raw"]
    with httpclient.InferenceServerClient(a.http_url) as c:
        fused = c.infer("chain_fused", [httpclient.InferInput("RAW", list(raw.shape), "INT32")
                                        .set_data_from_numpy(raw)]).as_numpy("SCORES")
        ensemble = c.infer("ensemble_image", [httpclient.InferInput(
            "IMAGE", list(refs["image"].shape), "UINT8").set_data_from_numpy(refs["image"])]
        ).as_numpy("CLASSIFICATION").reshape(-1)
    row = {"chain_max_abs_diff_vs_cpu": float(np.abs(fused - refs["chain_scores"]).max())}
    if not np.allclose(fused, refs["chain_scores"], atol=1e-5, rtol=1e-5):
        raise AssertionError(f"chain_fused vs the CPU run: {row}")
    row["runs"] = []
    client = PipelineClient([a.http_url, b.http_url], chain_pipeline(), protocol="http",
                            health_interval_s=None)
    try:
        first = None
        for i in range(size.chain_runs):
            res = client.run({"RAW": raw})
            if not np.array_equal(res.as_numpy("SCORES"), fused):
                raise AssertionError(f"chain run {i}: SCORES differ from chain_fused")
            if res.arena_high_water_bytes != res.plan_high_water_bytes:
                raise AssertionError(f"chain run {i}: peak residency "
                                     f"{res.arena_high_water_bytes} != plan "
                                     f"{res.plan_high_water_bytes}")
            row["runs"].append({"ms": res.duration_s * 1e3,
                                "stage_ms": {k: v * 1e3 for k, v in res.stage_latency_s.items()}})
            if first is None:
                first = client.arena().stats()
        last = client.arena().stats()
        row["high_water_bytes"] = client.plan().high_water_bytes
        row["steady_region_creates"] = last["regions_created"] - first["regions_created"]
        row["steady_registrations"] = (last["registrations_issued"]
                                       - first["registrations_issued"])
        if row["steady_region_creates"] or row["steady_registrations"]:
            raise AssertionError(f"chain steady state: {row}")
    finally:
        client.close()
    client = PipelineClient([a.http_url], vision_pipeline(size), protocol="http",
                            health_interval_s=None)
    try:
        res = client.run({"IMAGE": refs["image"]})
        logits = res.as_numpy("LOGITS").reshape(-1)
    finally:
        client.close()
    want = refs["image_logits"]
    err = float(np.abs(logits - want).max())
    row["vision"] = {"top1": int(logits.argmax()), "cpu_top1": int(want.argmax()),
                     "max_abs_logit_diff_vs_cpu": err,
                     "max_abs_diff_vs_ensemble_image": float(np.abs(logits - ensemble).max()),
                     "high_water_bytes": res.plan_high_water_bytes}
    if row["vision"]["top1"] != row["vision"]["cpu_top1"] or not err <= DECODER_LOGIT_TOL:
        raise AssertionError(f"vision pipeline vs the CPU run: {row['vision']}")
    return row


def fleet_successes(children):
    """Each child's success count summed over its models."""
    out = []
    for child in children:
        with httpclient.InferenceServerClient(child.http_url) as c:
            out.append(sum(r["inference_stats"]["success"]["count"]
                           for r in c.get_inference_statistics()["model_stats"]))
    return out


def orch_records(kind, size):
    if kind == "prefill_decode":
        return [trace_mod.TraceRecord(at_s=i * 0.005, kind=kind, model="decoder_lm_kv_decode",
                                      prompt_tokens=16, output_tokens=8,
                                      prefill_role="prefill", decode_role="decode")
                for i in range(size.records)]
    return [trace_mod.TraceRecord(at_s=i * 0.005, kind=kind, model="chain",
                                  shapes={"RAW": [1, 16]}, dtypes={"RAW": "INT32"})
            for i in range(size.records)]


def orch_harness(children, size):
    """Row 5: ``PerfRunner`` with ``shard_layout`` (closed loop on
    decoder_lm_prefill), ``roles`` and ``pipeline="chain"`` (replays of their
    record kind), each at ``size.concurrency``, then the replay of a mixed
    trace with every orchestration kind. 0 errors, and the children's
    success counts equal to the wire requests sent (per child where the
    routing is fixed: shard i and the role endpoints)."""
    a, b = children[:2]
    urls = [a.http_url, b.http_url]
    rows = {}

    def counted(name, fn, expect):
        """``fn``'s row; ``expect(row)`` gives the wire requests it sent in
        all and, where the routing is fixed, to each child."""
        before = fleet_successes(children[:2])
        out = fn()
        got = [x - y for x, y in zip(fleet_successes(children[:2]), before)]
        total, per_child = expect(out)
        if sum(got) != total or (per_child is not None and got != per_child):
            raise AssertionError(f"harness {name}: children succeeded {got}, sent {total} "
                                 f"({per_child})")
        rows[name] = {"rows": out, "children_successes": got}

    def shard_loop():
        runner = PerfRunner(a.http_url, "http", "decoder_lm_prefill", "none",
                            {"TOKENS": [size.shard_rows, size.shard_len]}, endpoints=urls,
                            shard_layout=SHARD_SPEC, device="cpu")
        try:
            levels = [runner.run(c, size.perf_requests) for c in size.concurrency]
        finally:
            runner.close()
            if runner._arena is not None:
                runner._arena.close(force=True)
        return [{k: r[k] for k in ("concurrency", "requests", "errors", "shed",
                                   "infer_per_sec", "latency_ms")} for r in levels]

    def shard_sent(levels):
        n = sum(r["requests"] + r["errors"] + r["shed"] for r in levels)
        return 2 * n, [n, n]  # one request a shard

    counted("shard_layout", shard_loop, shard_sent)

    def replay(kind, **kwargs):
        def go():
            runner = PerfRunner(a.http_url, "http", "simple", device="cpu", **kwargs)
            try:
                out = []
                for workers in size.concurrency:
                    res = runner.run_trace(trace_mod.Trace(header={}, records=orch_records(
                        kind, size)), replay_workers=workers, warmup=False)
                    out.append({k: res[k] for k in ("issued", "errors", "shed", "latency_ms",
                                                    "achieved_rps")
                                if k in res} | {"workers": workers,
                                                "ok": res["kinds"][kind]["ok"],
                                                "stages": res.get("pipeline_stages")})
            finally:
                runner.close()
            if any(r["errors"] or r["shed"] or r["ok"] != size.records for r in out):
                raise AssertionError(f"harness {kind}: {out}")
            return out
        return go

    n = size.records * len(size.concurrency)
    counted("roles", replay("prefill_decode", roles=f"prefill={a.http_url};decode={b.http_url}"),
            lambda out: (2 * n, [n, n]))
    counted("pipeline", replay("pipeline", endpoints=urls, pipeline="chain"),
            lambda out: (3 * n, None))

    trace = trace_mod.generate(size.mixed, seed=0)
    counts = trace.kind_counts()
    for kind in ("sharded", "prefill_decode", "pipeline"):
        if not counts.get(kind):
            raise AssertionError(f"mixed trace: no {kind} records ({counts})")

    def mixed():
        runner = PerfRunner(a.http_url, "http", "simple", endpoints=urls,
                            shard_layout=SHARD_SPEC, pipeline="chain",
                            roles=f"prefill={a.http_url};decode={b.http_url}", device="cpu")
        try:
            res = runner.run_trace(trace, speed=4.0, replay_workers=8, warmup=False)
        finally:
            runner.close()
            if runner._arena is not None:
                runner._arena.close(force=True)
        if res["errors"] or res["shed"] or any(
                row["ok"] != counts[kind] for kind, row in res["kinds"].items()):
            raise AssertionError(f"mixed replay: {res['kinds']} of {counts}; "
                                 f"{res.get('error_sample')}")
        return {"kinds": {k: {"ok": r["ok"], "latency_ms": r["latency_ms"]}
                          for k, r in res["kinds"].items()},
                "pipeline_stages": res.get("pipeline_stages")}

    counted("mixed replay", mixed,
            lambda out: (sum(RECORD_REQUESTS[k] * n for k, n in counts.items()), None))
    rows["mixed replay"]["records"] = counts
    return rows


def serve_orchestration(device="cuda", size=ORCH, start_children=None):
    """Phase 10: ``client_tpu_torch.disagg``, ``shard`` and ``pipeline`` over
    four ``serve`` children on ``device`` (``SERVE_ARGS``, threaded HTTP),
    started at once; this process the client. The first two serve every
    row and drain at the end; the other two are the victims SIGKILLed in
    rows 2 and 3. ``start_children`` (tests) returns the four instead. Each
    output is held against the CPU run of the port with the same seeded
    weights. This process launches nothing. Each drained child's report
    holds its launches to its executions: decode_attention = layers x its
    decoder steps, normalize_image = its preprocess and ensemble_image
    executions, flash_attention = its encoder's."""
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    if start_children is None:
        children = [ServeChild(device, "threaded") for _ in range(4)]
    else:
        children = start_children()
    result = {"size": size._asdict(), "rows": {}, "client_counts": {}, "steps_s": {}}
    rows = result["rows"]
    reports = []
    try:
        t = time.perf_counter()
        refs = orchestration_references(size)
        result["steps_s"]["cpu references"] = time.perf_counter() - t
        t = time.perf_counter()
        for child in children:
            child.wait_ready()
        result["steps_s"]["children ready"] = time.perf_counter() - t
        result["urls"] = [c.http_url for c in children]

        def row(name, fn, *args):
            reset_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            result["steps_s"][name] = time.perf_counter() - t0
            counts = read_counts()
            if any(counts.values()):
                raise AssertionError(f"orchestration row {name}: this process launched "
                                     f"{counts}")
            result["client_counts"][name] = counts
            return out

        rows["disagg"] = row("disagg", orch_disagg, children, refs, size)
        rows["pipeline"] = row("pipeline", orch_pipeline, children, refs, size)
        rows["harness"] = row("harness", orch_harness, children, size)
        rows["recovery"] = row("recovery", orch_recovery, children, refs, size)
        rows["shard"] = row("shard", orch_shard, children, refs, size, children[2])
        t = time.perf_counter()
        for child in children[:2]:
            child.sigterm()
        reports = [child.finish(t, 15.0) for child in children[:2]]
    finally:
        for child in children:
            child.kill()
    result["reports"] = reports

    expected = []
    for i, report in enumerate(reports):
        ex = report["executions"]
        want = {"decode_attention": report["layers"] * report["decoder_steps"],
                "flash_attention": ex["long_context_encoder"],
                "normalize_image": ex["preprocess"] + ex["ensemble_image"]}
        expected.append(want)
        if report["rounds"] or any(report["failures"].values()):
            raise AssertionError(f"orchestration child {i}: batched rounds {report['rounds']}, "
                                 f"failures {report['failures']}")
        if report.get("launches") is not None:
            got = {k: want.get(k, 0) if on_card else 0 for k in COUNTERS}
            if report["launches"] != got:
                raise AssertionError(f"orchestration child {i} launches {report['launches']}, "
                                     f"expected {got}")
            card = torch.cuda.get_device_name(0) if on_card else str(torch.device(device))
            if report["device"] != card:
                raise AssertionError(f"orchestration child {i} ran on {report['device']}, "
                                     f"not {card}")
    if not all(e["decode_attention"] for e in expected) or not expected[0]["normalize_image"]:
        raise AssertionError(f"orchestration phase: a kernel's path did not run: {expected}")
    result["launch_counts"] = [r.get("launches") for r in reports]
    result["expected_launches"] = expected
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 11: federation, watch, doctor and the byzantine server over cells of
# ``serve`` children, this process the client
# ---------------------------------------------------------------------------

FedSize = collections.namedtuple("FedSize", [
    "seq", "home_requests", "spill_requests", "blackhole_after", "heal_after",
    "return_max", "prompt", "seq_tokens", "shadow_requests", "canary_healthy", "canary_max",
    "canary_after", "canary_slo_ms", "canary_latency_s", "byz_requests", "watch_warm",
    "watch_batch", "watch_batches", "watch_latency_s", "watch_slo_ms", "watch_fast_s",
    "watch_window_s", "perf_requests", "concurrency"])
FED = FedSize(
    seq=8192, home_requests=20, spill_requests=40, blackhole_after=10, heal_after=25,
    return_max=200, prompt=[1, 2, 3, 4], seq_tokens=4, shadow_requests=10, canary_healthy=10,
    canary_max=40, canary_after=10, canary_slo_ms=250.0, canary_latency_s=0.02,
    byz_requests=12, watch_warm=96, watch_batch=32, watch_batches=16,
    watch_latency_s=0.001, watch_slo_ms=50.0, watch_fast_s=4.0, watch_window_s=12.0,
    perf_requests=20, concurrency=(1, 2))
# the three cells of the four children, each replica behind its own proxy
FED_CELLS = {"home": (0, 1), "away": (2,), "canary": (3,)}
BYZ_KINDS = ("shape_lie", "truncate")


def federation_references(size):
    """The CPU run of the port with the children's seeded weights: the
    encoder at ``size.seq`` on a seeded sequence, and decoder_lm's greedy
    stream on ``size.prompt`` with each step's logits and top-two margin."""
    encoder = LongContextEncoderModel(device="cpu")
    seq = np.random.default_rng(8).standard_normal(
        (size.seq, encoder.encoder.dim)).astype(np.float32)
    encoded = encoder.execute({"sequence": seq}, {})["encoded"].numpy()
    decoder = TinyDecoderModel(device="cpu")
    margins = []

    def run(tokens, start, end):
        out = decoder.execute({"TOKENS": np.array([tokens], np.int32)},
                              {"sequence_id": 901, "sequence_start": start,
                               "sequence_end": end})
        top2 = torch.topk(torch.as_tensor(out["LOGITS"]).float().reshape(-1), 2).values
        margins.append(float(top2[0] - top2[1]))
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    tokens, logits = drive_decoder(run, size.prompt, size.seq_tokens - 1)
    return {"seq": seq, "encoded": encoded, "decoder_tokens": tokens,
            "decoder_logits": logits, "decoder_margins": margins}


def fed_encode(client, refs, where):
    """One encoder request through ``client``; the output checked against
    the CPU run. Returns the output's max abs difference."""
    got = client.infer("long_context_encoder", pool_encoder_input(httpclient, refs),
                       client_timeout=30.0).as_numpy("encoded")
    return check_encoded(got, refs, where)


def fed_cells(proxies, names=("home", "away", "canary")):
    return {name: [proxies[i].url for i in FED_CELLS[name]] for name in names}


def fed_client(cells, **kwargs):
    kwargs.setdefault("pool_kwargs", {"health_interval_s": 0.1, "probe_timeout_s": 0.3})
    return FederatedClient(cells, home="home", protocol="http", **kwargs)


def fed_split(children, model, before):
    return [a - b for a, b in zip(fleet_executions(children, model), before)]


def fed_warm(children, proxies, refs, size):
    """Row 0: one encoder request and a one-token decoder_lm sequence
    straight to each child, all at once, so that no row (the canary's
    latency SLO above all, and the sequence row's 2 s attempts, whose first
    one on a cold child outran them once) reads a child's first execution.
    Every later gate counts executions within its own row."""
    def warm(i, child):
        with httpclient.InferenceServerClient(child.http_url) as client:
            err = fed_encode(client, refs, "federation warm-up")
            inp = httpclient.InferInput("TOKENS", [1, 1], "INT32")
            inp.set_data_from_numpy(np.array([size.prompt[:1]], np.int32))
            client.infer("decoder_lm", [inp], sequence_id=9000 + i, sequence_start=True,
                         sequence_end=True)
            return err

    with ThreadPoolExecutor(len(children)) as pool:
        errs = list(pool.map(warm, range(len(children)), children))
    return {"max_abs_err": max(errs)}


def fed_home(children, proxies, refs, size):
    """Row 1: every request of a healthy fleet served by the home cell."""
    before = fleet_executions(children, "long_context_encoder")
    errs = []
    with fed_client(fed_cells(proxies)) as fed:
        for _ in range(size.home_requests):
            errs.append(fed_encode(fed, refs, "federation home"))
        spills, order = fed.spill_total(), fed.serve_order()
    split = fed_split(children, "long_context_encoder", before)
    if spills or split[2:] != [0, 0] or sum(split[:2]) != size.home_requests:
        raise AssertionError(f"federation home: executions {split}, spills {spills}")
    return {"executions": split, "spills": spills, "order": order,
            "max_abs_err": max(errs)}


def fed_spill(children, proxies, refs, size):
    """Row 2: the home cell blackholed after ``blackhole_after`` requests and
    healed after ``heal_after``: 0 errors, each spilled request on child 3
    with a typed ``CellSpill``, the spill counter in the registry, and the
    requests it took after the heal until home served again."""
    home = ChaosCell([proxies[i] for i in FED_CELLS["home"]])
    events = []
    tel = Telemetry(sample="off")
    before = fleet_executions(children, "long_context_encoder")
    errors, timeline = [], []
    fed = fed_client(fed_cells(proxies), telemetry=tel, on_event=events.append,
                     cell_breaker_factory=lambda: CircuitBreaker(min_calls=2,
                                                                recovery_time_s=0.5),
                     default_deadline_s=30.0, per_attempt_timeout_s=0.5)
    try:
        t_heal = None

        def send(i):
            try:
                fed_encode(fed, refs, f"federation spill request {i}")
            except Exception as e:
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            # home's served count and the seconds since the heal, a request
            timeline.append((fed.federation_stats()["cells"]["home"]["served"],
                             None if t_heal is None else time.perf_counter() - t_heal))
            time.sleep(0.02)

        for i in range(size.spill_requests):
            if i == size.blackhole_after:
                home.blackhole()
            if i == size.heal_after:
                home.heal(reset_active=True)
                t_heal = time.perf_counter()
            send(i)
        at_heal = timeline[size.heal_after - 1][0]
        while timeline[-1][0] == at_heal:  # home not back yet: keep sending
            if len(timeline) >= size.heal_after + size.return_max:
                raise AssertionError("federation spill: traffic never returned home")
            send(len(timeline))
        if errors:
            raise AssertionError(f"federation spill: errors reached the caller: {errors}")
        back = next(i for i in range(size.heal_after, len(timeline))
                    if timeline[i][0] > at_heal)
        after_heal, return_s = back - size.heal_after + 1, timeline[back][1]
        stats = fed.federation_stats()
        text = tel.registry.prometheus_text()
    finally:
        fed.close()
        home.heal(reset_active=True)
    spills = [e for e in events if isinstance(e, CellSpill)]
    split = fed_split(children, "long_context_encoder", before)
    reasons = collections.Counter(e.reason for e in spills)
    if not spills or split[2] != len(spills) or split[3] != 0 or any(
            e.cell != "home" or e.target != "away" for e in spills):
        raise AssertionError(f"federation spill: {len(spills)} CellSpill events, executions "
                             f"{split}")
    if "client_tpu_federation_spill_total" not in text:
        raise AssertionError("federation spill: no client_tpu_federation_spill_total series")
    return {"requests": size.spill_requests, "spills": len(spills), "reasons": dict(reasons),
            "executions": split, "requests_to_return_home": after_heal,
            "return_home_s": return_s, "spill_out": stats["cells"]["home"]["spill_out"]}


def fed_sequence(children, proxies, refs, size):
    """Row 3: a decoder_lm sequence pinned to home takes ``seq_tokens``
    tokens, then the home cell resets: a typed ``CellSequenceAbandoned``
    names the sequence, and child 3 never steps it."""
    home = ChaosCell([proxies[i] for i in FED_CELLS["home"]])
    events = []
    seq_id = 4242
    before = fleet_executions(children, "decoder_lm")
    fed = fed_client(fed_cells(proxies), on_event=events.append, default_deadline_s=10.0,
                     per_attempt_timeout_s=2.0)
    tokens, logits = [], []
    try:
        def run(tok, start, end):
            inp = httpclient.InferInput("TOKENS", [1, len(tok)], "INT32")
            inp.set_data_from_numpy(np.array([tok], np.int32))
            res = fed.infer("decoder_lm", [inp], sequence_id=seq_id, sequence_start=start,
                            sequence_end=end, client_timeout=10.0)
            return res.as_numpy("LOGITS"), int(res.as_numpy("NEXT_TOKEN")[0, 0])

        got, got_logits = drive_decoder(run, size.prompt, size.seq_tokens - 1)
        tokens, logits = got, got_logits
        home.kill()
        abandoned_error = None
        try:
            run([tokens[-1]], False, False)
        except Exception as e:
            abandoned_error = f"{type(e).__name__}: {e}"
    finally:
        fed.close()
        home.heal(reset_active=True)
    split = fed_split(children, "decoder_lm", before)
    abandoned = [e for e in events if isinstance(e, CellSequenceAbandoned)]
    near = near_tie_check(tokens, refs["decoder_tokens"], refs["decoder_margins"],
                          "federation sequence")
    err = float(np.abs(logits.reshape(-1) - refs["decoder_logits"].reshape(-1)).max())
    if abandoned_error is None or len(abandoned) != 1 or abandoned[0].sequence_id != seq_id \
            or abandoned[0].cell != "home":
        raise AssertionError(f"federation sequence: error {abandoned_error}, events "
                             f"{abandoned}")
    if split[2:] != [0, 0] or sorted(split[:2]) != [0, size.seq_tokens] or not (
            err <= DECODER_LOGIT_TOL or near is not None):
        raise AssertionError(f"federation sequence: decoder_lm executions {split}, max logit "
                             f"diff {err}")
    return {"tokens": tokens, "cpu_tokens": refs["decoder_tokens"], "near_tie": near,
            "max_abs_logit_diff": err, "executions": split,
            "abandoned": {"cell": abandoned[0].cell, "sequence_id": abandoned[0].sequence_id,
                          "cause": type(abandoned[0].cause).__name__},
            "error": abandoned_error}


def fed_shadow(children, proxies, refs, size):
    """Row 4: every request mirrored to the away cell: each mirror matches the
    served response bit for bit, none diverges or fails."""
    before = fleet_executions(children, "long_context_encoder")
    errs = []
    with fed_client(fed_cells(proxies, ("home", "away")),
                    shadow=ShadowPolicy("away", ratio=1.0)) as fed:
        for _ in range(size.shadow_requests):
            errs.append(fed_encode(fed, refs, "federation shadow"))
        drained = fed.shadow_drain(30.0)
        status = fed.shadow_status()
    split = fed_split(children, "long_context_encoder", before)
    if not drained or status["sent"] != size.shadow_requests or status["matched"] != \
            size.shadow_requests or status["diverged"] or status["errors"]:
        raise AssertionError(f"federation shadow: {status}")
    if split[2] != size.shadow_requests or sum(split[:2]) != size.shadow_requests:
        raise AssertionError(f"federation shadow: executions {split}")
    return {"status": status, "executions": split, "max_abs_err": max(errs)}


def fed_canary(children, proxies, refs, size):
    """Row 5: a canary at weight 0.5 under a latency SLO the healthy cells
    meet; a latency fault on child 4's proxy breaks it: one typed
    ``CanaryRolledBack``, weight 0, 0 caller errors, and child 4 executes
    nothing after the rollback."""
    events = []
    canary = CanaryPolicy("canary", weight=0.5, slo=f"p95<{size.canary_slo_ms:g}ms",
                          min_events=4)
    errors = []
    fed = fed_client(fed_cells(proxies, ("home", "canary")), canary=canary,
                     on_event=events.append, default_deadline_s=60.0)
    proxy = proxies[FED_CELLS["canary"][0]]
    try:
        for i in range(size.canary_healthy):
            try:
                fed_encode(fed, refs, "federation canary (healthy)")
            except Exception as e:
                errors.append(f"healthy {i}: {e}")
        healthy = fed.canary_status()
        if healthy["rolled_back"]:
            raise AssertionError(f"federation canary: rolled back on healthy cells: {healthy}")
        proxy.fault = Fault("latency", latency_s=size.canary_latency_s)
        proxy.reset_active()
        t_fault = time.perf_counter()
        sent = 0
        while not fed.canary_status()["rolled_back"]:
            if sent >= size.canary_max:
                raise AssertionError(f"federation canary: no rollback after {sent} requests: "
                                     f"{fed.canary_status()}")
            try:
                fed_encode(fed, refs, "federation canary (faulted)")
            except Exception as e:
                errors.append(f"faulted {sent}: {e}")
            sent += 1
        rollback_s = time.perf_counter() - t_fault
        at_rollback = fleet_executions(children, "long_context_encoder")
        for i in range(size.canary_after):
            try:
                fed_encode(fed, refs, "federation canary (rolled back)")
            except Exception as e:
                errors.append(f"after {i}: {e}")
        status = fed.canary_status()
    finally:
        fed.close()
        proxy.heal()
        proxy.reset_active()
    after = fed_split(children, "long_context_encoder", at_rollback)
    rollbacks = [e for e in events if isinstance(e, CanaryRolledBack)]
    if errors or len(rollbacks) != 1 or status["weight"] != 0.0 or after[3] != 0:
        raise AssertionError(f"federation canary: errors {errors}, rollbacks {rollbacks}, "
                             f"status {status}, executions after the rollback {after}")
    return {"healthy_routed": healthy["routed"], "faulted_requests": sent,
            "rollback_s": rollback_s, "burn_rate": rollbacks[0].burn_rate,
            "events": rollbacks[0].events, "status": status, "executions_after": after}


def fed_byzantine(children, proxies, refs, size, device):
    """Row 6: the port's ``ByzantineHttpServer`` in this process (the encoder
    on ``device``, faults ``BYZ_KINDS``, seed 7) is the lone replica of the
    home cell ``liar``, with ``away`` behind it: the typed
    ``IntegrityError``s quarantine it, the cell is quarantine-dominated,
    traffic spills to away, and no corrupt output is returned. This
    process's flash launches equal the byzantine core's executions."""
    core = ServerCore([LongContextEncoderModel(attention="flash", device=device)],
                      device=device)
    liar = ByzantineHttpServer(core, kinds=BYZ_KINDS, seed=7).start()
    events = []
    outputs, errors = [], []
    before = fleet_executions(children, "long_context_encoder")
    fed = FederatedClient({"liar": [liar.url], "away": [proxies[FED_CELLS["away"][0]].url]},
                          home="liar", protocol="http", on_event=events.append,
                          default_deadline_s=30.0,
                          pool_kwargs={"health_interval_s": 0.1, "probe_timeout_s": 0.3})
    try:
        for i in range(size.byz_requests):
            try:
                outputs.append(fed_encode(fed, refs, f"byzantine request {i}"))
            except AssertionError:
                raise  # a returned output that is not the CPU run's: a corrupt one
            except Exception as e:
                errors.append(f"request {i}: {type(e).__name__}: {e}")
        cells = fed.federation_stats()["cells"]
    finally:
        fed.close()
        liar.stop()
    executions = core.statistics()["model_stats"][0]["execution_count"]
    split = fed_split(children, "long_context_encoder", before)
    spills = [e for e in events if isinstance(e, CellSpill)]
    pool = cells["liar"]["pool"]
    if not (pool["quarantined"] and pool["quarantine_dominated"]) or not spills or \
            split[2] != len(outputs) - cells["liar"]["served"]:
        raise AssertionError(f"byzantine: liar cell {cells['liar']}, spills {len(spills)}, "
                             f"executions {split}, errors {errors}")
    return {"returned": len(outputs), "errors": errors, "corrupt_returned": 0,
            "max_abs_err": max(outputs) if outputs else None, "liar": cells["liar"],
            "spill_reasons": dict(collections.Counter(e.reason for e in spills)),
            "plan": liar.plan.stats(), "faults": [k for _, k in liar.plan.log],
            "byzantine_executions": executions, "away_executions": split[2]}


def fed_watch(children, proxies, refs, size, out_dir):
    """Row 7: a ``Watchtower`` with a black box under ``build/`` over the
    telemetry of a pool of the home cell's two children; a latency fault
    on child 2's proxy alone: the watchdog trips naming that proxy's URL
    (not ``fleet_shift``) within ``watch_batches`` batches, or, while the
    ``slo_burn`` alert fires, within as many again (the row waits for the
    flight divergence behind the burn), the edges
    land in the ring, ``read_blackbox`` gives back timelines, the last
    metric snapshot and the alerts, and ``python -m
    client_tpu_torch.doctor --blackbox`` renders them."""
    ring = os.path.join(out_dir, "fed_watch.bbx")
    if os.path.exists(ring):
        os.remove(ring)
    # no baseline samples: a handful of them, drawn before the fault, would
    # hold the faulted replica's baseline share to chance (the divergence
    # test compares the tail against them); the slow tail alone names it.
    # The slow tail is the top 5%: host noise on the healthy replica
    # retains few timelines beside the faulted one's
    rec = FlightRecorder(rng=random.Random(0xB1AB0), capacity=48, slow_quantile=0.95,
                         threshold_window=96, threshold_min_samples=48, baseline_ratio=0.0)
    tel = Telemetry(sample="always", flight=rec)
    # a burn alert stays active while the tail accumulates, and its evidence
    # (the flight divergence) is refreshed each tick
    tel.track_slo("req_p95", "request_ms", size.watch_slo_ms, objective=0.95,
                  window_s=size.watch_window_s)
    tower = Watchtower(tel, interval_s=0.2, blackbox=ring, fast_window_s=size.watch_fast_s,
                       cusum_warmup=6, min_stream_count=4, metrics_every_ticks=1)
    urls = [proxies[i].url for i in FED_CELLS["home"]]
    faulted = proxies[1]
    pool = PoolClient(urls, protocol="http", telemetry=tel, routing="round_robin",
                      health_interval_s=None)
    named, sent = None, 0

    def traffic(n):
        nonlocal sent
        for i in range(n):
            fed_encode(pool, refs, "watch loop")
            sent += 1
            if i % 8 == 7:
                tower.tick()

    try:
        traffic(size.watch_warm)
        # a trip on healthy traffic (host noise) is kept as a reading; one
        # that names a replica before any fault would be a misattribution
        before_fault = tower.history()
        if any(faulted.url in str(a.get("evidence")) for a in before_fault):
            raise AssertionError(f"watch: a replica named before the fault: {before_fault}")
        faulted.fault = Fault("latency", latency_s=size.watch_latency_s)
        faulted.reset_active()
        t_fault, sent_at_fault = time.perf_counter(), sent
        # past watch_batches the row goes on only while the slo_burn alert
        # fires: the burn is the fault seen, and its evidence names the
        # moved replica once the flight recorder's slow tail holds enough
        # of the faulted replica's timelines (a tail still shared with
        # healthy host noise gives no divergence yet); at most as many
        # batches again
        batches = burn_wait = 0
        while batches < 2 * size.watch_batches:
            burning = any(a.kind == "slo_burn" and a.state == "firing"
                          for a in tower.active_alerts())
            if batches >= size.watch_batches and not burning:
                break
            burn_wait += batches >= size.watch_batches
            batches += 1
            traffic(size.watch_batch)
            for alert in [a.as_dict() for a in tower.active_alerts()] + list(tower.history()):
                ev = alert.get("evidence") or {}
                moved = ev.get("moved") or (ev.get("divergence") or {}).get("dominant") or ""
                if alert["state"] == "firing" and faulted.url in str(moved):
                    named = alert
                    break
            if named:
                break
        detect_s = time.perf_counter() - t_fault
        detect_requests = sent - sent_at_fault
        faulted.heal()
        faulted.reset_active()
        if named is None:
            raise AssertionError(f"watch: no alert named {faulted.url}: {tower.history()}")
        deadline = time.monotonic() + 20.0
        while tower.active_alerts() and time.monotonic() < deadline:
            traffic(16)
            time.sleep(0.2)
        active = [a.as_dict() for a in tower.active_alerts()]
        stats = tower.stats()
    finally:
        pool.close()
        tower.stop()
        faulted.heal()
    report = read_blackbox(ring)
    alerts = [r.data for r in report.records if r.kind == "alert"]
    kinds = collections.Counter(r.kind for r in report.records)
    doc = blackbox_report(ring)
    if active or not any(a["state"] == "firing" for a in alerts) or not any(
            a["state"] == "resolved" for a in alerts):
        raise AssertionError(f"watch: active {active}, ring alerts {alerts}")
    if not (doc["ok"] and doc["timelines_recovered"] and doc["metrics"] is not None
            and doc["last_alert"] is not None):
        raise AssertionError(f"watch: black box {kinds}: {doc.get('note')}")
    # the doctor reads the ring while the next rows run (fed_blackbox_doctor)
    doctor = (subprocess.Popen([sys.executable, "-m", "client_tpu_torch.doctor", "--blackbox",
                                ring], cwd=REPO, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True), time.perf_counter())
    return {"named": named, "faulted_url": faulted.url, "detect_s": detect_s,
            "alerts_before_fault": len([a for a in before_fault if a["state"] == "firing"]),
            "detect_requests": detect_requests, "requests": sent, "ring_records": dict(kinds),
            "batches": batches, "burn_wait_batches": burn_wait,
            "ring_alerts": len(alerts), "timelines_recovered": doc["timelines_recovered"],
            "stats": {k: stats[k] for k in ("ticks", "alerts_fired", "alerts_resolved",
                                            "changepoint_trips")},
            "doctor_process": doctor}


def fed_blackbox_doctor(doctor):
    """Row 7's last gate: ``python -m client_tpu_torch.doctor --blackbox``
    over the watch row's ring exits 0 and renders the reconstruction."""
    proc, t0 = doctor
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0 or "blackbox reconstruction" not in out:
        raise AssertionError(f"watch: doctor --blackbox exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-2000:]}")
    return {"doctor_blackbox_s": time.perf_counter() - t0}


def fed_doctor_run(args, out_dir):
    out = os.path.join(out_dir, "doctor_fed.json")
    if os.path.exists(out):
        os.remove(out)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "client_tpu_torch.doctor", *args, "--json",
                           out], cwd=REPO, capture_output=True, text=True, timeout=180)
    seconds = time.perf_counter() - t
    snap = json.load(open(out)) if os.path.exists(out) else None
    return proc, snap, seconds


def fed_doctor(children, proxies, refs, size, out_dir):
    """Row 8: ``python -m client_tpu_torch.doctor`` over the four children
    with ``--cells`` exits 0 and lists the three cells; after child 4 is
    SIGKILLed, ``--fail-on-anomaly`` exits non-zero with ``cell_down``
    naming canary."""
    cells = fed_cells(proxies)
    spec = ";".join(f"{name}={'+'.join(urls)}" for name, urls in cells.items())
    args = [p.url for p in proxies] + ["--cells", spec, "--model", "long_context_encoder",
                                       "--requests", "2", "--timeout", "2"]
    proc, snap, healthy_s = fed_doctor_run(args, out_dir)
    listed = sorted(snap["cells"][0]["cells"]) if snap and snap.get("cells") else None
    if proc.returncode != 0 or listed != sorted(cells):
        raise AssertionError(f"doctor: exit {proc.returncode}, cells {listed}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")
    victim = FED_CELLS["canary"][0]
    children[victim].kill()
    # the killed child's listener is gone; its proxy resets what it had
    proxies[victim].fault = Fault("reset", after_bytes=0)
    proxies[victim].reset_active()
    proc2, snap2, down_s = fed_doctor_run(args + ["--fail-on-anomaly"], out_dir)
    down = [f for f in (snap2 or {}).get("anomalies", []) if f["flag"] == "cell_down"]
    if proc2.returncode == 0 or [f["url"] for f in down] != ["canary"]:
        raise AssertionError(f"doctor after SIGKILL: exit {proc2.returncode}, cell_down "
                             f"{down}:\n{proc2.stdout[-3000:]}")
    return {"cells": listed, "healthy_exit": proc.returncode, "healthy_s": healthy_s,
            "healthy_anomalies": [f["flag"] for f in snap["anomalies"]],
            "killed_exit": proc2.returncode, "killed_s": down_s,
            "killed_anomalies": sorted({f["flag"] for f in snap2["anomalies"]})}


def fed_harness(children, proxies, refs, size):
    """Row 9: ``PerfRunner`` on the encoder with ``cells``, ``home_cell``,
    ``shadow_cell``, ``canary_cell`` and ``watch=True`` at
    ``size.concurrency``: 0 errors, ``client_federation`` and
    ``client_watch`` blocks, and the children's successes equal to the wire
    requests sent (each request once, each mirror once)."""
    cells = {"home": [proxies[0].url, proxies[1].url], "shadow": [proxies[2].url],
             "canary": [proxies[3].url]}
    before = fleet_successes(children)
    runner = PerfRunner(children[0].http_url, "http", "long_context_encoder", "none",
                        {"sequence": [size.seq, 64]}, cells=cells, home_cell="home",
                        shadow_cell="shadow", shadow_ratio=1.0, canary_cell="canary",
                        canary_weight=0.1, canary_slo=f"p95<{size.canary_slo_ms:g}ms",
                        watch=True, device="cpu")
    try:
        levels = [runner.run(c, size.perf_requests) for c in size.concurrency]
    finally:
        runner.close()
    sent = sum(r["requests"] + r["errors"] + r["shed"] for r in levels)
    mirrors = sum(r["client_federation"]["shadow"]["sent"] for r in levels)
    got = [a - b for a, b in zip(fleet_successes(children), before)]
    if any(r["errors"] or r["shed"] for r in levels) or any(
            "client_federation" not in r or "client_watch" not in r for r in levels):
        raise AssertionError(f"federation harness: {levels}")
    if sum(got) != sent + mirrors:
        raise AssertionError(f"federation harness: children succeeded {got}, sent {sent} and "
                             f"{mirrors} mirrors")
    keep = ("concurrency", "requests", "errors", "shed", "infer_per_sec", "latency_ms")
    return {"rows": [{k: r[k] for k in keep} | {
        "spills": r["client_federation"]["spills"],
        "shadow": {k: r["client_federation"]["shadow"][k]
                   for k in ("sent", "matched", "diverged", "errors")},
        "canary_routed": r["client_federation"]["canary"]["routed"],
        "watch_ticks": r["client_watch"]["ticks"],
        "alerts_fired": r["client_watch"]["alerts_fired"]} for r in levels],
        "children_successes": got, "mirrors": mirrors}


def serve_federation(device="cuda", size=FED, start_children=None, out_dir=None):
    """Phase 11: ``client_tpu_torch.federation``, ``watch``, ``doctor`` and the
    byzantine server over four ``serve`` children on ``device`` (``SERVE_ARGS``,
    threaded HTTP) started at once, each behind a ``ChaosProxy`` of this
    process: the cells home (children 1 and 2, a ``ChaosCell``), away
    (child 3) and canary (child 4). ``start_children`` (tests) returns the
    four instead. The black box and the doctor's JSON go to ``out_dir``
    (default ``build/``). Every output is held against the CPU run of the port with
    the same seeded weights. Only the byzantine row launches in this process
    (its core's encoder). Children 1-3 drain at the end; child 4 is
    SIGKILLed in the doctor row. Each drained child's report holds its
    launches to its executions: decode_attention = layers x its decoder
    steps, flash_attention = its encoder's executions."""
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    out_dir = out_dir or os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    if start_children is None:
        children = [ServeChild(device, "threaded") for _ in range(4)]
    else:
        children = start_children()
    result = {"size": size._asdict(), "rows": {}, "client_counts": {}, "steps_s": {}}
    rows = result["rows"]
    reports, proxies = [], []
    try:
        t = time.perf_counter()
        refs = federation_references(size)
        result["steps_s"]["cpu references"] = time.perf_counter() - t
        t = time.perf_counter()
        for child in children:
            child.wait_ready()
        result["steps_s"]["children ready"] = time.perf_counter() - t
        for child in children:
            host, port = child.http_url.rsplit(":", 1)
            proxies.append(ChaosProxy(host, int(port)).start())
        result["urls"] = [c.http_url for c in children]
        result["proxies"] = [p.url for p in proxies]

        def row(name, fn, *args, launches=None):
            reset_counts()
            t0 = time.perf_counter()
            out = fn(children, proxies, refs, size, *args)
            result["steps_s"][name] = time.perf_counter() - t0
            counts = read_counts()
            want = {k: 0 for k in counts}
            if launches is not None:
                want.update(launches(out))
            if counts != want:
                raise AssertionError(f"federation row {name}: this process launched {counts}, "
                                     f"expected {want}")
            result["client_counts"][name] = counts
            return out

        rows["warm"] = row("warm", fed_warm)
        rows["home"] = row("home", fed_home)
        rows["spill"] = row("spill", fed_spill)
        rows["sequence"] = row("sequence", fed_sequence)
        rows["shadow"] = row("shadow", fed_shadow)
        rows["canary"] = row("canary", fed_canary)
        rows["byzantine"] = row(
            "byzantine", fed_byzantine, device,
            launches=lambda out: {"flash_attention": out["byzantine_executions"]
                                  if on_card else 0})
        rows["watch"] = row("watch", fed_watch, out_dir)
        rows["harness"] = row("harness", fed_harness)
        rows["doctor"] = row("doctor", fed_doctor, out_dir)
        rows["watch"].update(fed_blackbox_doctor(rows["watch"].pop("doctor_process")))
        t = time.perf_counter()
        for child in children[:3]:
            child.sigterm()
        reports = [child.finish(t, 15.0) for child in children[:3]]
    finally:
        pending = (rows.get("watch") or {}).get("doctor_process")
        if pending is not None and pending[0].poll() is None:
            pending[0].kill()
        for proxy in proxies:
            proxy.stop()
        for child in children:
            child.kill()
    result["reports"] = reports

    expected = []
    for i, report in enumerate(reports):
        ex = report["executions"]
        want = {"decode_attention": report["layers"] * report["decoder_steps"],
                "flash_attention": ex["long_context_encoder"]}
        expected.append(want)
        if any(report["failures"].values()):
            raise AssertionError(f"federation child {i}: failures {report['failures']}")
        if report.get("launches") is not None:
            got = {k: want.get(k, 0) if on_card else 0 for k in COUNTERS}
            if report["launches"] != got:
                raise AssertionError(f"federation child {i} launches {report['launches']}, "
                                     f"expected {got}")
            card = torch.cuda.get_device_name(0) if on_card else str(torch.device(device))
            if report["device"] != card:
                raise AssertionError(f"federation child {i} ran on {report['device']}, "
                                     f"not {card}")
    if not sum(e["decode_attention"] for e in expected) or \
            not sum(e["flash_attention"] for e in expected):
        raise AssertionError(f"federation phase: an attention kernel's path did not run: "
                             f"{expected}")
    result["launch_counts"] = [r.get("launches") for r in reports]
    result["expected_launches"] = expected
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 12: the mesh models in this process
# ---------------------------------------------------------------------------

MeshSize = collections.namedtuple("MeshSize", [
    "shards", "prompts", "prompt_len", "steps", "concurrent", "prefill_rows", "prefill_len",
    "seq", "cpu_seq", "causal", "encoder_requests", "moe_tokens", "pipe", "vision",
    "vision_requests"])
MESH = MeshSize(
    shards=(1, 2, 4), prompts=3, prompt_len=6, steps=5, concurrent=4, prefill_rows=8,
    prefill_len=16, seq=8192, cpu_seq=256, causal=(1, 1024, 4, 16), encoder_requests=10,
    moe_tokens=1024, pipe=(4, 4, 64, 256), vision=(1000, 96), vision_requests=10)
MESH_MODES = ("ring", "ulysses", "auto")
# the serve child of phase 12: every mesh flag at once, over the local devices
MESH_SERVE_ARGS = ["--http-port", "0", "--grpc-port", "0", "--long-context", "--attention",
                   "ring", "--moe", "--tensor-parallel", "2", "--vision"]


def shared_mesh(device, n, axis="model"):
    """A ("data", "model") mesh of ``n`` shards along ``axis`` that all live
    on ``device`` (one card serves the whole mesh)."""
    return Mesh([[device]] * n if axis == "data" else [[device] * n], ("data", "model"))


def mesh_prompts(size):
    rng = np.random.default_rng(12)
    return [rng.integers(0, TinyDecoderModel.VOCAB, size.prompt_len).tolist()
            for _ in range(size.prompts)]


def decoder_stream(model, prompt, steps, seq_id):
    """(tokens, logits [steps + 1, V], top-two margins) of one sequence."""
    margins = []

    def run(tokens, start, end):
        out = model.execute({"TOKENS": np.array([tokens], np.int32)},
                            {"sequence_id": seq_id, "sequence_start": start,
                             "sequence_end": end})
        logits = np.asarray(out["LOGITS"], np.float32).reshape(-1)
        top2 = np.sort(logits)[-2:]
        margins.append(float(top2[1] - top2[0]))
        return logits[None], int(out["NEXT_TOKEN"][0, 0])

    tokens, logits = drive_decoder(run, prompt, steps)
    return tokens, logits, margins


def mesh_decoder(device, size, layers):
    """Row 1: decoder_lm_tp over meshes of ``size.shards`` shards of one
    device, against decoder_lm on that device (same weights) and its CPU run."""
    prompts = mesh_prompts(size)
    decoder = TinyDecoderModel(device=device)
    cpu = TinyDecoderModel(device="cpu")
    tokens_a_prompt = size.prompt_len + size.steps
    row = {"prompts": prompts, "steps": size.steps, "by_shards": {}}
    refs = []
    decoder_stream(decoder, prompts[0], size.steps, 1199)  # warm: the timing starts hot
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        refs.append(decoder_stream(decoder, prompt, size.steps, 1200 + i))
    row["decoder_lm_ms_per_token"] = ((time.perf_counter() - t0) * 1e3
                                      / (tokens_a_prompt * len(prompts)))
    cpu_refs = [decoder_stream(cpu, p, size.steps, 1300 + i) for i, p in enumerate(prompts)]
    row["cpu_near_ties"] = [near_tie_check(r[0], c[0], c[2], f"decoder_lm prompt {i}")
                            for i, (r, c) in enumerate(zip(refs, cpu_refs))]
    for n in size.shards:
        model = TPDecoderModel(mesh=shared_mesh(device, n), params=decoder.params())
        decoder_stream(model, prompts[0], size.steps, 1399)  # warm, as decoder_lm
        reset_counts()
        t0 = time.perf_counter()
        got = [decoder_stream(model, p, size.steps, 1400 + i) for i, p in enumerate(prompts)]
        wall = time.perf_counter() - t0
        counts = read_counts()
        ties = []
        for i, ((toks, _, _), cpu_ref) in enumerate(zip(got, cpu_refs)):
            ties.append(near_tie_check(toks, cpu_ref[0], cpu_ref[2],
                                       f"decoder_lm_tp x{n} vs CPU prompt {i}"))
        # 4 sequences at once on the tp model, each as alone
        reset_counts()
        with ThreadPoolExecutor(size.concurrent) as pool:
            futures = [pool.submit(decoder_stream, model, prompts[i % len(prompts)],
                                   size.steps, 1500 + i) for i in range(size.concurrent)]
            concurrent = [f.result() for f in futures]
        concurrent_counts = read_counts()
        # same device, same weights: the tokens and logits of every sequence,
        # alone or concurrent, are decoder_lm's bit for bit
        pairs = got + concurrent
        wants = refs + [refs[i % len(refs)] for i in range(size.concurrent)]
        diffs = [float(np.abs(g[1] - w[1]).max()) if g[1].shape == w[1].shape else float("inf")
                 for g, w in zip(pairs, wants)]
        entry = {"tokens": [g[0] for g in got], "near_ties_vs_cpu": ties,
                 "max_abs_logit_diff_vs_decoder_lm": max(diffs),
                 "logits_bit_equal": max(diffs) == 0.0,
                 "ms_per_token": wall * 1e3 / (tokens_a_prompt * len(prompts)),
                 "launches": counts, "concurrent_launches": concurrent_counts,
                 "concurrent_equal": [c[0] == w[0] for c, w in
                                      zip(concurrent, wants[len(refs):])]}
        if max(diffs) != 0.0 or any(g[0] != w[0] for g, w in zip(pairs, wants)):
            raise AssertionError(f"decoder_lm_tp x{n}: not bit-equal to decoder_lm on "
                                 f"{device} (largest logit difference {max(diffs)}, "
                                 f"sequential tokens {entry['tokens']}, concurrent equal "
                                 f"{entry['concurrent_equal']})")
        for where, c, seqs in (("sequential", counts, len(prompts)),
                               ("concurrent", concurrent_counts, size.concurrent)):
            expect = tokens_a_prompt * seqs * layers * n if device.type == "cuda" else 0
            if c["decode_attention"] != expect or sum(c.values()) != expect:
                raise AssertionError(f"decoder_lm_tp x{n} {where}: launches {c}, expected "
                                     f"decode_attention {expect}")
        row["by_shards"][n] = entry
    row["decoder_lm_tokens"] = [r[0] for r in refs]
    row["cpu_tokens"] = [c[0] for c in cpu_refs]
    return row


def mesh_prefill(device, size, layers):
    """Row 2: the zoo's decoder_lm_tp_prefill over HTTP (its degree from the
    local devices) and a 4-shard one in process, each against the zoo's
    decoder_lm_prefill on the same rows."""
    tokens = np.random.default_rng(13).integers(
        0, TinyDecoderModel.VOCAB, (size.prefill_rows, size.prefill_len)).astype(np.int32)
    core = ServerCore(default_model_zoo(device), device=device)
    zoo_tp = core.model("decoder_lm_tp_prefill")
    row = {"zoo_tp_degree": zoo_tp.tp_degree}
    with HttpInferenceServer(core) as server, \
            httpclient.InferenceServerClient(server.url) as client:
        def infer(name):
            inp = httpclient.InferInput("TOKENS", list(tokens.shape), "INT32")
            res = client.infer(name, [inp.set_data_from_numpy(tokens)])
            return {k: res.as_numpy(k) for k in ("LOGITS", "NEXT_TOKEN")}

        want = infer("decoder_lm_prefill")
        reset_counts()
        got = infer("decoder_lm_tp_prefill")
        counts = read_counts()
    in_process = PrefillDecoderModel(tp=True, mesh=shared_mesh(device, 4))
    reset_counts()
    four = in_process.execute({"TOKENS": tokens}, {})
    four_counts = read_counts()
    cells = size.prefill_rows * size.prefill_len * layers
    for where, out, c, n in (("served", got, counts, zoo_tp.tp_degree),
                             ("4 shards", four, four_counts, 4)):
        diff = float(np.abs(out["LOGITS"] - want["LOGITS"]).max())
        row[where] = {"max_abs_logit_diff": diff, "bit_equal": diff == 0.0,
                      "next_token_equal": bool(np.array_equal(out["NEXT_TOKEN"],
                                                              want["NEXT_TOKEN"])),
                      "launches": c}
        if diff != 0.0 or not row[where]["next_token_equal"]:
            raise AssertionError(f"decoder_lm_tp_prefill {where}: not bit-equal to "
                                 f"decoder_lm_prefill (logits {diff} apart, NEXT_TOKEN equal "
                                 f"{row[where]['next_token_equal']})")
        expect = cells * n if device.type == "cuda" else 0
        if c["decode_attention"] != expect or sum(c.values()) != expect:
            raise AssertionError(f"decoder_lm_tp_prefill {where}: launches {c}, expected "
                                 f"decode_attention {expect}")
    return row


def served_p50(model, x, iters):
    """p50 ms of ``iters`` HTTP requests to ``model`` alone in a server."""
    name = model.name
    spec = model.inputs()[0]
    with HttpInferenceServer(ServerCore([model], device=model._device)) as server, \
            httpclient.InferenceServerClient(server.url) as client:
        inp = httpclient.InferInput(spec.name, list(x.shape), "FP32").set_data_from_numpy(x)
        out_name = model.outputs()[0].name
        got = client.infer(name, [inp]).as_numpy(out_name)  # warm
        return p50_ms(lambda: client.infer(name, [inp]), iters), got


def mesh_encoder(device, size):
    """Row 3: long_context_encoder in each mesh mode over 4 shards of one
    device at ``size.seq``, against flash on the device; at ``size.cpu_seq``
    against the CPU run in the same mode; causal ring and Ulysses against
    full_attention; the served p50 of each mode beside flash."""
    on_card = device.type == "cuda"
    tol = TOLERANCE["flash_attention"]["float32"]
    rng = np.random.default_rng(14)
    x = rng.standard_normal((size.seq, 64)).astype(np.float32)
    small = rng.standard_normal((size.cpu_seq, 64)).astype(np.float32)
    flash = LongContextEncoderModel(device=device)
    reset_counts()
    want = flash.execute({"sequence": x}, {})["encoded"].cpu().numpy()
    flash_counts = read_counts()
    row = {"seq": size.seq, "modes": {}}
    row["flash_p50_ms"], _ = served_p50(flash, x, size.encoder_requests)
    n = 4
    for mode in MESH_MODES:
        model = LongContextEncoderModel(attention=mode, mesh=shared_mesh(device, n, "data"))
        cpu = LongContextEncoderModel(attention=mode, device="cpu", n_devices=n)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        reset_counts()
        got = model.execute({"sequence": x}, {})["encoded"].cpu().numpy()
        counts = read_counts()
        peak = (torch.cuda.max_memory_allocated() - base) if on_card else None
        err = float(np.abs(got - want).max())
        small_got = model.execute({"sequence": small}, {})["encoded"].cpu().numpy()
        small_want = cpu.execute({"sequence": small}, {})["encoded"].numpy()
        small_err = float(np.abs(small_got - small_want).max())
        if not (np.allclose(got, want, atol=tol, rtol=tol)
                and np.allclose(small_got, small_want, atol=tol, rtol=tol)):
            raise AssertionError(f"long_context_encoder {mode}: {err} from flash, {small_err} "
                                 "from the CPU run")
        if any(counts.values()):
            raise AssertionError(f"long_context_encoder {mode} launched {counts}")
        p50, served = served_p50(model, x, size.encoder_requests)
        if not np.array_equal(served, got):
            raise AssertionError(f"long_context_encoder {mode}: served output differs")
        ran = mode if mode != "auto" else parallel_ulysses.auto_mode((1, size.seq, 4, 16), n)
        heads, sq = 4, size.seq
        row["modes"][mode] = {
            "runs": ran, "max_abs_err_vs_flash": err, "max_abs_err_vs_cpu": small_err,
            "served_p50_ms": p50, "peak_bytes": peak,
            "reckoned_bytes": (2 * (heads // n) * sq * sq * 4 if ran == "ulysses"
                               else heads * (sq // n) ** 2 * 4)}
    if flash_counts["flash_attention"] != (1 if on_card else 0):
        raise AssertionError(f"long_context_encoder flash launched {flash_counts}")
    # causal, against the dense reference on the device
    qkv = [torch.from_numpy(rng.standard_normal(size.causal).astype(np.float32)).to(device)
           for _ in range(3)]
    dense = parallel_ring.full_attention(*qkv, causal=True)
    mesh = shared_mesh(device, n, "data")
    for name, fn in (("ring", parallel_ring.ring_attention),
                     ("ulysses", parallel_ulysses.ulysses_attention)):
        out = fn(*qkv, mesh, axis="data", causal=True).full()
        err = float((out - dense).abs().max())
        if not torch.allclose(out, dense, atol=tol, rtol=tol):
            raise AssertionError(f"causal {name} attention: {err} from full_attention")
        row[f"causal_{name}_max_abs_err"] = err
    return row


def mesh_moe(device, size):
    """Row 4: moe_ffn over 4 shards of one device (8 experts) over HTTP at
    ``size.moe_tokens``, against the dense reference; in process at half the
    busiest (shard, expert) load, each kept row the dense row and each
    dropped row 0; an indivisible request a 400."""
    tol = TOLERANCE["flash_attention"]["float32"]
    n = 4
    model = MoEFFNModel(mesh=shared_mesh(device, n))
    x = np.random.default_rng(15).standard_normal((size.moe_tokens, 32)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    w1, w2 = model.w1.full(), model.w2.full()
    dense = parallel_moe.dense_moe_reference(xt, model.gate_w, w1, w2).cpu().numpy()
    with HttpInferenceServer(ServerCore([model], device=device)) as server, \
            httpclient.InferenceServerClient(server.url) as client:
        inp = httpclient.InferInput("tokens", list(x.shape), "FP32").set_data_from_numpy(x)
        got = client.infer("moe_ffn", [inp]).as_numpy("routed")
        p50 = p50_ms(lambda: client.infer("moe_ffn", [inp]), size.encoder_requests)
        bad = httpclient.InferInput("tokens", [size.moe_tokens - 1, 32], "FP32")
        try:
            client.infer("moe_ffn", [bad.set_data_from_numpy(x[:-1])])
        except InferenceServerException as e:
            refused = e.status()
        else:
            raise AssertionError("moe_ffn answered an indivisible token count")
    err = float(np.abs(got - dense).max())
    if refused != "400" or not np.allclose(got, dense, atol=tol, rtol=tol):
        raise AssertionError(f"moe_ffn: {err} from the dense reference, {refused} for "
                             f"{size.moe_tokens - 1} tokens")
    expert = (xt @ model.gate_w).argmax(-1).reshape(n, -1)
    peak_load = max(int((expert[i] == e).sum()) for i in range(n)
                    for e in range(model.n_experts))
    cap = max(peak_load // 2, 1)
    half = parallel_moe.moe_ffn(xt, model.gate_w, model.w1, model.w2, model.mesh,
                                capacity=cap).full().cpu().numpy()
    kept = np.isclose(half, dense, atol=tol, rtol=tol).all(-1)
    dropped = (half == 0).all(-1)
    if not (kept | dropped).all() or not dropped.any() or not kept.any():
        raise AssertionError(f"moe_ffn at capacity {cap}: {int(kept.sum())} kept, "
                             f"{int(dropped.sum())} dropped of {len(half)}")
    return {"tokens": size.moe_tokens, "experts": model.n_experts, "max_abs_err": err,
            "served_p50_ms": p50, "refused_status": refused, "half_capacity": cap,
            "peak_load": peak_load, "kept": int(kept.sum()), "dropped": int(dropped.sum())}


def mesh_pipeline(device, size):
    """Row 5: pipeline_forward over 4 stages of one device, 4 microbatches,
    against sequential_mlp (1e-5)."""
    stages, micro, batch, dim = size.pipe
    w, b = parallel_pipeline.mlp_stage_params(0, stages, dim)
    w, b = w.to(device), b.to(device)
    x = torch.from_numpy(np.random.default_rng(16).standard_normal((batch, dim))
                         .astype(np.float32)).to(device)
    want = parallel_pipeline.sequential_mlp(w, b, x)
    got = parallel_pipeline.pipeline_forward(
        w, b, x, shared_mesh(device, stages), n_microbatches=micro)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"pipeline_forward: {err} from sequential_mlp")
    return {"stages": stages, "microbatches": micro, "shape": [batch, dim], "max_abs_err": err}


def mesh_vision(device, size):
    """Row 6: densenet_onnx at tensor_parallel=2 over 2 shards of one device
    against tp = 1 (seed 0): top-1 equal, logits within 2e-2; p50 of each."""
    classes, width = size.vision
    single = DenseNetModel(classes, width, seed=0, device=device)
    tp = DenseNetModel(classes, width, seed=0, tensor_parallel=2,
                       mesh=shared_mesh(device, 2))
    image = torch.from_numpy(np.random.default_rng(17).standard_normal((3, 224, 224))
                             .astype(np.float32)).to(device)

    def run(model):
        return model.execute({"data_0": image}, {})["fc6_1"].reshape(-1).cpu().numpy()

    want, got = run(single), run(tp)
    err = float(np.abs(got - want).max())
    if got.argmax() != want.argmax() or err > 2e-2:
        raise AssertionError(f"densenet_onnx tp=2: top-1 {got.argmax()} vs {want.argmax()}, "
                             f"logits {err} apart")
    return {"classes": classes, "width": width, "tp": tp.tp_degree, "max_abs_logit_diff": err,
            "top1": int(got.argmax()), "p50_ms": p50_ms(lambda: run(tp), size.vision_requests),
            "tp1_p50_ms": p50_ms(lambda: run(single), size.vision_requests)}


def mesh_child(child, device, size):
    """Row 7: the serve child with every mesh flag answers the encoder,
    moe_ffn and densenet_onnx as the same models here, with the degrees the
    local devices give, then drains."""
    tol = TOLERANCE["flash_attention"]["float32"]
    n = len(parallel.local_devices(device))
    child.wait_ready()
    degrees = child.line("mesh degrees: ", 30)[len("mesh degrees: "):]
    want_degrees = {"decoder_lm_tp_prefill": f"model={max(d for d in (1, 2, 4) if d <= n)}",
                    "densenet_onnx": f"data=1 model={min(2, n)}",
                    "long_context_encoder": f"data={n} model=1",
                    "moe_ffn": f"data=1 model={n}"}
    for name, text in want_degrees.items():
        if f"{name} {text}" not in degrees:
            raise AssertionError(f"serve printed mesh degrees {degrees!r}, not {name} {text}")
    rng = np.random.default_rng(18)
    seq = rng.standard_normal((64 * n, 64)).astype(np.float32)
    tokens = rng.standard_normal((8 * n, 32)).astype(np.float32)
    image = rng.standard_normal((3, 224, 224)).astype(np.float32)
    local = {
        "long_context_encoder": LongContextEncoderModel(attention="ring", device=device),
        "moe_ffn": MoEFFNModel(device=device),
        "densenet_onnx": DenseNetModel(device=device)}
    row = {"degrees": degrees}
    with httpclient.InferenceServerClient(child.http_url) as client:
        for name, inp_name, out_name, x, bound in (
                ("long_context_encoder", "sequence", "encoded", seq, tol),
                ("moe_ffn", "tokens", "routed", tokens, tol),
                ("densenet_onnx", "data_0", "fc6_1", image, 2e-2)):
            inp = httpclient.InferInput(inp_name, list(x.shape), "FP32").set_data_from_numpy(x)
            got = client.infer(name, [inp]).as_numpy(out_name)
            want = local[name].execute({inp_name: x}, {})[out_name].cpu().numpy()
            err = float(np.abs(got - want).max())
            if not np.allclose(got, want, atol=bound, rtol=bound if bound < 1e-2 else 0):
                raise AssertionError(f"serve child {name}: {err} from this process's model")
            row[name] = err
    report = child.terminate()
    if report["failures"] and any(report["failures"].values()):
        raise AssertionError(f"serve child failures {report['failures']}")
    if report.get("launches") and any(report["launches"].values()):
        raise AssertionError(f"serve child launched {report['launches']} (no kernel path)")
    row.update(exit_s=report["exit_s"], drained=report["drain_line"], device=report["device"])
    return row


def log_mesh(mesh, card):
    """Phase 12's lines, each with the card's name and power limit."""
    ms = mesh["rows"]
    log(f"mesh phase: {mesh['seconds']:.1f} s; rows "
        + ", ".join(f"{k} {v:.2f} s" for k, v in mesh["steps_s"].items())
        + f"; every shard on one card ({mesh['shared_device']}); {card}")
    dt = ms["decoder_lm_tp"]
    for n, entry in dt["by_shards"].items():
        log(f"mesh decoder_lm_tp x{n} shards: {entry['ms_per_token']:.3f} ms a token "
            f"(decoder_lm {dt['decoder_lm_ms_per_token']:.3f}); max logit diff vs decoder_lm "
            f"{entry['max_abs_logit_diff_vs_decoder_lm']:.4g} (bit-equal: "
            f"{entry['logits_bit_equal']}); near ties vs the CPU run {entry['near_ties_vs_cpu']}; "
            f"decode_attention "
            f"{entry['launches']['decode_attention']} launches sequential, "
            f"{entry['concurrent_launches']['decode_attention']} in the 4-way run; {card}")
    pf = ms["decoder_lm_tp_prefill"]
    log(f"mesh decoder_lm_tp_prefill (zoo tp {pf['zoo_tp_degree']}) over HTTP: "
        + json.dumps(pf["served"]) + "; 4 shards in process: " + json.dumps(pf["4 shards"]))
    enc = ms["long_context_encoder"]
    log(f"mesh long_context_encoder S={enc['seq']}: flash served p50 "
        f"{enc['flash_p50_ms']:.3f} ms; " + "; ".join(
            f"{mode} (runs {r['runs']}) p50 {r['served_p50_ms']:.3f} ms, err vs flash "
            f"{r['max_abs_err_vs_flash']:.3g}, vs CPU {r['max_abs_err_vs_cpu']:.3g}, peak "
            f"{r['peak_bytes']} bytes (reckoned {r['reckoned_bytes']})"
            for mode, r in enc["modes"].items())
        + f"; causal ring {enc['causal_ring_max_abs_err']:.3g}, causal ulysses "
        f"{enc['causal_ulysses_max_abs_err']:.3g}; {card}")
    log("mesh moe_ffn: " + json.dumps(ms["moe_ffn"]) + f"; pipeline: "
        + json.dumps(ms["pipeline"]) + f"; {card}")
    log("mesh densenet_onnx tp=2: " + json.dumps(ms["densenet_onnx"]) + f"; {card}")
    log("mesh serve child: " + json.dumps(ms["serve_child"]))


def serve_mesh(device="cuda", size=MESH, start_child=None):
    """Phase 12: the mesh models (``client_tpu_torch.parallel``) in this
    process on ``device``, each mesh's shards sharing the one device (so no
    time here is a collective's cost), and a ``serve`` child with every mesh
    flag (``start_child`` returns it instead, for tests). Each row runs
    with the launch counts set to 0 just before it and read just after."""
    device = torch.device(device)
    t_phase = time.perf_counter()
    child = (ServeChild(str(device), "threaded", MESH_SERVE_ARGS) if start_child is None
             else start_child())
    shared = str(shared_mesh(device, 1).devices.flat[0])
    if device.type == "cuda":
        shared += f" ({torch.cuda.get_device_name(device)})"
    result = {"size": size._asdict(), "rows": {}, "steps_s": {}, "shared_device": shared,
              "note": "every mesh's shards share one device: no time here is a collective's"}
    log(f"mesh: every shard of phase 12 shares {shared}; its times are the shards' compute "
        "run one after another, no collective's cost")
    layers = TinyDecoderModel.LAYERS
    rows = result["rows"]
    try:
        for name, fn, args in (("decoder_lm_tp", mesh_decoder, (layers,)),
                               ("decoder_lm_tp_prefill", mesh_prefill, (layers,)),
                               ("long_context_encoder", mesh_encoder, ()),
                               ("moe_ffn", mesh_moe, ()),
                               ("pipeline", mesh_pipeline, ()),
                               ("densenet_onnx", mesh_vision, ())):
            t0 = time.perf_counter()
            rows[name] = fn(device, size, *args)
            result["steps_s"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows["serve_child"] = mesh_child(child, device, size)
        result["steps_s"]["serve_child"] = time.perf_counter() - t0
    finally:
        child.kill()
    result["launches"] = {n: r["launches"]["decode_attention"]
                          for n, r in rows["decoder_lm_tp"]["by_shards"].items()}
    result["seconds"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# phase 13: the training step, the dry run, multihost and entry()
# ---------------------------------------------------------------------------

TrainSize = collections.namedtuple("TrainSize", [
    "dryrun_devices", "classes", "width", "image", "batch", "cpu_batch", "steps", "lr",
    "entry_iters"])
# the served densenet's full width (phase 4's classifier), global batch 16
TRAIN = TrainSize(dryrun_devices=8, classes=1000, width=96, image=224, batch=16, cpu_batch=2,
                  steps=5, lr=1e-3, entry_iters=10)
# one leaf's update against another run's, per leaf: the cosine of the two
# update vectors and the largest difference as a fraction of the reference
# update's largest element. dp 2 x tp 4 against one shard on one device
# changes only the order of bf16 sums (each half batch, each channel block
# alone); the card against the CPU changes the bf16 convolutions' rounding
# (cuDNN against oneDNN), as the port against JAX on the CPU does
# (tests/test_torch_train_step.py: cosine >= 0.98, <= 27% there)
TRAIN_TOLERANCE = {"layouts": {"cosine": 0.99, "fraction": 0.1, "loss": 1e-3},
                   "cpu": {"cosine": 0.95, "fraction": 0.35, "loss": 2e-2}}
# entry() on the card against its CPU run, the same weights (the vision bound)
ENTRY_TOLERANCE = 5e-2
MULTIHOST_WAIT_S = 180


def train_inputs(size, device, batch):
    rng = np.random.default_rng(13)
    images = rng.standard_normal((size.batch, size.image, size.image, 3)).astype(np.float32)
    labels = rng.integers(0, size.classes, size.batch)
    return (torch.from_numpy(images[:batch]).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(labels[:batch]).to(device))


def leaf_values(params):
    """{path: fp32 numpy} of a parameter tree (Sharded leaves whole)."""
    out = {}

    def visit(tree, prefix):
        if isinstance(tree, dict):
            for key, value in tree.items():
                visit(value, f"{prefix}/{key}")
            return
        whole = tree.full("cpu") if isinstance(tree, parallel.Sharded) else tree
        # a copy: a CPU leaf's numpy view would follow the in-place update
        out[prefix] = np.array(whole.detach().float().cpu().numpy())

    visit(params, "")
    return out


def compare_updates(got, want, tol, where):
    """Each leaf's update in ``got`` against ``want`` (``{path: array}``):
    the worst cosine and fraction; raises past ``tol``."""
    worst = {"min_cosine": 1.0, "max_fraction": 0.0, "leaves": len(want)}
    for name, ref in want.items():
        new = got[name]
        if not ref.any() or not new.any():
            raise AssertionError(f"{where}: leaf {name} was not updated")
        cosine = float((ref * new).sum() / np.sqrt((ref ** 2).sum() * (new ** 2).sum()))
        fraction = float(np.abs(new - ref).max() / np.abs(ref).max())
        worst["min_cosine"] = min(worst["min_cosine"], cosine)
        worst["max_fraction"] = max(worst["max_fraction"], fraction)
        if cosine < tol["cosine"] or fraction > tol["fraction"]:
            raise AssertionError(f"{where}: leaf {name} update cosine {cosine:.4f}, "
                                 f"{fraction:.3f} of its largest apart (tol {tol})")
    return worst


def train_layout(size, mesh, device, batch, timed=True):
    """One step from the seed-0 weights over ``mesh``: its loss and each
    leaf's update; then ``size.steps`` timed steps, the peak memory and one
    profiled step's device time."""
    module = FunctionalDenseNet(size.classes, size.width)
    images, labels = train_inputs(size, device, batch)
    init = params_to_torch(draw_params(size.classes, size.width, seed=0), device)
    before = leaf_values(init)
    params = parallel.shard_params(init, mesh)
    step = parallel.sharded_train_step(module.apply,
                                       functools.partial(torch.optim.SGD, lr=size.lr), mesh)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params, opt, loss = step(params, None, images, labels)
    sync()
    row = {"shape": dict(mesh.shape), "batch": batch, "loss": float(loss)}
    updates = {k: v - before[k] for k, v in leaf_values(params).items()}
    if not np.isfinite(row["loss"]):
        raise AssertionError(f"train step over {dict(mesh.shape)}: loss {row['loss']}")
    if not timed:
        return row, updates
    times = []
    for _ in range(size.steps):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, images, labels)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    row.update(ms_per_step=statistics.median(times), step_ms=times,
               last_loss=float(loss),
               peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(params, opt, images, labels)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels)
    row.update(profiled_wall_ms=wall_ms, device_ms=device_ms if kernels else None,
               device_idle_share=1 - device_ms / wall_ms if kernels else None,
               kernel_launches=sum(k["count"] for k in kernels) if kernels else None,
               top_kernels=kernels[:6])
    return row, updates


def training_step_rows(device, size):
    """The full-width step at dp 2 x tp 4 and at one shard (every shard on
    ``device``), each timed; the mesh's updates against the one shard's,
    and the one-shard step at ``size.cpu_batch`` against the CPU's."""
    mesh = dryrun.dryrun_mesh(size.dryrun_devices, device)
    one = Mesh([[device]], ("data", "model"))
    rows = {}
    rows["dp2_tp4"], mesh_updates = train_layout(size, mesh, device, size.batch)
    rows["one_shard"], one_updates = train_layout(size, one, device, size.batch)
    tol = TRAIN_TOLERANCE["layouts"]
    loss_diff = abs(rows["dp2_tp4"]["loss"] - rows["one_shard"]["loss"])
    if loss_diff > tol["loss"] * abs(rows["one_shard"]["loss"]):
        raise AssertionError(f"train step dp2 x tp4 loss {rows['dp2_tp4']['loss']} vs one "
                             f"shard {rows['one_shard']['loss']}")
    rows["dp2_tp4_vs_one_shard"] = dict(
        compare_updates(mesh_updates, one_updates, tol, "dp2 x tp4 vs one shard"),
        loss_diff=loss_diff, tolerance=tol)
    small, small_updates = train_layout(size, one, device, size.cpu_batch, timed=False)
    cpu, cpu_updates = train_layout(size, Mesh([["cpu"]], ("data", "model")), "cpu",
                                    size.cpu_batch, timed=False)
    tol = TRAIN_TOLERANCE["cpu"]
    loss_diff = abs(small["loss"] - cpu["loss"])
    if loss_diff > tol["loss"]:
        raise AssertionError(f"train step at batch {size.cpu_batch}: loss {small['loss']} "
                             f"on {device} vs {cpu['loss']} on the CPU")
    rows["vs_cpu"] = dict(compare_updates(small_updates, cpu_updates, tol,
                                          f"batch {size.cpu_batch} {device} vs cpu"),
                          batch=size.cpu_batch, loss=small["loss"], cpu_loss=cpu["loss"],
                          loss_diff=loss_diff, tolerance=tol)
    return rows


def training_dryrun(device, size):
    """``dryrun.dryrun_multichip`` over (dp 2 x tp 4) with every shard on
    ``device``: its summary, and decode_attention launches = fed tokens x
    layers x shards for the served decode (plus fed tokens x layers for
    its single-device reference), no other kernel launched."""
    reset_counts()
    t0 = time.perf_counter()
    result = dryrun.dryrun_multichip(size.dryrun_devices, device=device)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    per_layer = result["fed_tokens"] * result["layers"]
    expected = {"served": per_layer * result["mesh"]["model"], "reference": per_layer}
    row = {"result": result, "seconds": seconds, "launches": counts,
           "expected_launches": expected}
    if torch.device(device).type == "cuda":
        want = {name: 0 for name in COUNTERS}
        want["decode_attention"] = sum(expected.values())
        if result["decode_attention_launches"] != expected or counts != want:
            raise AssertionError(f"dry run launches {result['decode_attention_launches']} "
                                 f"(counts {counts}), expected {expected}")
    return row


def training_multihost(device):
    """``python -m client_tpu_torch.parallel.multihost_check`` in a child
    through the CLIENT_TPU_* variables at world size 1: NCCL on the card
    (gloo with four positions on the CPU); its data-parallel step against
    the full-batch numpy step here."""
    kind = torch.device(device).type
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, CLIENT_TPU_COORDINATOR=multihost.free_address(),
                   CLIENT_TPU_NPROCS="1", CLIENT_TPU_PROC_ID="0")
        cmd = [sys.executable, "-m", "client_tpu_torch.parallel.multihost_check", "--device",
               kind, "--out", out] + (["--local-devices", "4"] if kind == "cpu" else [])
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=MULTIHOST_WAIT_S)
        seconds = time.perf_counter() - t0
        backend = "nccl" if kind == "cuda" else "gloo"
        if done.returncode != 0 or f"WORKER_OK 0 world=1 backend={backend}" not in done.stdout:
            raise AssertionError(f"multihost child exit {done.returncode}:\n"
                                 f"{(done.stdout + done.stderr)[-3000:]}")
        got = dict(np.load(os.path.join(out, "rank0.npz")))
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((16, 4)).astype(np.float32)
    full = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    targets = rng.standard_normal((8, 4)).astype(np.float32)
    want = w0 - 0.1 * 2.0 * full.T @ (full @ w0 - targets) / (8 * 4)
    rel = float(np.abs(got["dp_step"] - want).max() / np.abs(want).max())
    np.testing.assert_allclose(got["dp_step"], want, rtol=2e-4)
    line = next(x for x in done.stdout.splitlines() if x.startswith("WORKER_OK"))
    return {"backend": backend, "line": line, "seconds": seconds,
            "dp_step_max_rel_err": rel, "psum": got["psum"].tolist(),
            "train_loss": float(got["train_loss"])}


def training_entry(device, size):
    """``dryrun.entry()`` on ``device``: the example batch's logits, and a
    random batch's within ENTRY_TOLERANCE of the CPU run's (the same seed-0
    weights); the forward timed."""
    fn, (params, images) = dryrun.entry(device)
    cpu_fn, (cpu_params, _) = dryrun.entry("cpu")
    batch = torch.from_numpy(np.random.default_rng(14).standard_normal(
        tuple(images.shape)).astype(np.float32))
    with torch.no_grad():
        zeros = fn(params, images)
        got = fn(params, batch.to(device)).cpu().numpy()
        want = cpu_fn(cpu_params, batch).numpy()
        on_card = torch.device(device).type == "cuda"

        def forward():
            fn(params, images)
            if on_card:
                torch.cuda.synchronize()

        ms = p50_ms(forward, size.entry_iters)
    err = float(np.abs(got - want).max())
    if zeros.shape != (4, 1000) or not torch.isfinite(zeros).all() or err > ENTRY_TOLERANCE:
        raise AssertionError(f"entry(): logits {tuple(zeros.shape)}, {err} from the CPU run")
    return {"shape": list(zeros.shape), "max_abs_err_vs_cpu": err, "p50_ms": ms,
            "tolerance": ENTRY_TOLERANCE}


def serve_training(device="cuda", size=TRAIN):
    """Phase 13: the dry run (``client_tpu_torch.dryrun``), the sharded
    training step at the served densenet's width, the multihost child and
    ``entry()``, on ``device``. Each row with the launch counts set to 0
    just before it and read just after."""
    t_phase = time.perf_counter()
    result = {"size": size._asdict(), "rows": {}, "steps_s": {}, "launch_counts": {}}
    for name, fn in (("dryrun", training_dryrun),
                     ("train_step", training_step_rows),
                     ("multihost", lambda device, size: training_multihost(device)),
                     ("entry", training_entry)):
        reset_counts()
        t0 = time.perf_counter()
        result["rows"][name] = fn(device, size)
        result["steps_s"][name] = time.perf_counter() - t0
        result["launch_counts"][name] = read_counts()
    result["seconds"] = time.perf_counter() - t_phase
    return result


def log_training(training, card):
    """Phase 13's lines, each with the card's name and power limit."""
    rows = training["rows"]
    log(f"training phase: {training['seconds']:.1f} s; rows "
        + ", ".join(f"{k} {v:.2f} s" for k, v in training["steps_s"].items()) + f"; {card}")
    dr = rows["dryrun"]
    log(f"training dry run ({dr['seconds']:.2f} s): loss {dr['result']['loss']:.4f}, tokens "
        f"{dr['result']['tokens']}; decode_attention launches "
        f"{dr['result']['decode_attention_launches']} = expected {dr['expected_launches']} "
        f"(fed tokens x layers x shards, and its reference); {card}")
    ts = rows["train_step"]
    for name in ("dp2_tp4", "one_shard"):
        r = ts[name]
        idle = ("not measured" if r["device_idle_share"] is None
                else f"{r['device_idle_share']:.1%} idle, {r['device_ms']:.3f} ms on the device")
        peak = "not measured" if r["peak_bytes"] is None else f"{r['peak_bytes']} bytes"
        kernels = ("not measured" if r["kernel_launches"] is None
                   else f"{r['kernel_launches']} kernels")
        log(f"training step {name} {r['shape']} batch {r['batch']}: {r['ms_per_step']:.3f} ms "
            f"a step (median of {len(r['step_ms'])}); loss {r['loss']:.6f} -> "
            f"{r['last_loss']:.6f}; peak {peak}; profiled step {r['profiled_wall_ms']:.3f} ms "
            f"({idle}, {kernels}); {card}")
    log("training dp2 x tp4 vs one shard: " + json.dumps(ts["dp2_tp4_vs_one_shard"])
        + "; vs the CPU: " + json.dumps(ts["vs_cpu"]))
    log("training multihost: " + json.dumps(rows["multihost"]))
    log("training entry(): " + json.dumps(rows["entry"]) + f"; {card}")


# ---------------------------------------------------------------------------
# phase 14: the native clients and the embedded server
# ---------------------------------------------------------------------------

# the sizes phase 14 runs at; the CPU rehearsal in the tests passes smaller ones
NativeSize = collections.namedtuple("NativeSize", [
    "identity_bytes", "iters", "seq", "vision_classes", "vision_width", "prompt", "steps",
    "perf_requests", "concurrency"])
NATIVE = NativeSize(identity_bytes=4 * MIB, iters=20, seq=8192, vision_classes=VISION_CLASSES,
                    vision_width=VISION_WIDTH, prompt=[1, 2, 3, 4], steps=8, perf_requests=50,
                    concurrency=(1, 2, 4))
# the embedded server's models, and how long the C host may take
EMBED_MODELS = ["simple", "decoder_lm"]
EMBED_HOST_WAIT_S = 300


def decoder_request(tokens, start, end):
    """A decoder_lm request of sequence 1 in the v2 two-part body, the bytes
    ``csrc/embed_host.c`` sends: (body, header length)."""
    header = ('{"parameters":{"sequence_id":1,"sequence_start":%s,"sequence_end":%s},'
              '"inputs":[{"name":"TOKENS","datatype":"INT32","shape":[1,%d],'
              '"parameters":{"binary_data_size":%d}}],'
              '"outputs":[{"name":"LOGITS","parameters":{"binary_data":true}},'
              '{"name":"NEXT_TOKEN","parameters":{"binary_data":true}}]}'
              % (str(bool(start)).lower(), str(bool(end)).lower(), len(tokens),
                 4 * len(tokens))).encode()
    return header + np.asarray(tokens, np.int32).tobytes(), len(header)


def response_tensors(body, header_length):
    """{name: raw bytes} of a two-part response's binary outputs."""
    header = json.loads(body[:header_length])
    out, at = {}, header_length
    for entry in header["outputs"]:
        size = entry["parameters"]["binary_data_size"]
        out[entry["name"]] = body[at:at + size]
        at += size
    return out


class EmbeddedServer:
    """The embed library (``native_build.build_embed``) dlopened in this
    process: the C API of ``native/include/client_tpu/server_embed.h`` as a
    C host calls it, through ctypes. The library takes the interpreter's
    lock on each call (it finds this interpreter running)."""

    def __init__(self, path, repo=REPO):
        lib = ctypes.CDLL(path)
        err = ctypes.POINTER(ctypes.c_void_p)
        lib.ctpu_embed_init.argtypes = [ctypes.c_char_p, err]
        lib.ctpu_embed_server_create.argtypes = [ctypes.c_char_p, err]
        lib.ctpu_embed_server_create.restype = ctypes.c_int64
        lib.ctpu_embed_infer.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int64), err]
        lib.ctpu_embed_statistics.argtypes = [ctypes.c_int64, ctypes.c_char_p, err, err]
        lib.ctpu_embed_server_destroy.argtypes = [ctypes.c_int64, err]
        lib.ctpu_embed_free.argtypes = [ctypes.c_void_p]
        self.lib = lib
        self._call(lib.ctpu_embed_init, repo.encode())

    def _take(self, ptr) -> bytes:
        """The bytes of a C string the library returned, then freed."""
        try:
            return ctypes.string_at(ptr.value) if ptr.value else b""
        finally:
            self.lib.ctpu_embed_free(ptr)

    def _call(self, fn, *args, ok=lambda rc: rc == 0):
        """``fn(*args, &error)``; raises with the library's message unless
        ``ok(rc)``."""
        error = ctypes.c_void_p()
        rc = fn(*args, ctypes.byref(error))
        if not ok(rc):
            raise RuntimeError(f"{fn.__name__}: {self._take(error).decode()}")
        return rc

    def create(self, options) -> int:
        """A server handle (> 0) of ``options`` (``embed.create``'s JSON)."""
        return self._call(self.lib.ctpu_embed_server_create, json.dumps(options).encode(),
                          ok=lambda rc: rc > 0)

    def infer(self, handle, model, body, header_length):
        """(response body, its header length) of one request."""
        response, size, hlen = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_int64()
        self._call(self.lib.ctpu_embed_infer, handle, model.encode(), b"", body, len(body),
                   header_length, ctypes.byref(response), ctypes.byref(size), ctypes.byref(hlen))
        try:
            return ctypes.string_at(response.value, size.value), hlen.value
        finally:
            self.lib.ctpu_embed_free(response)

    def statistics(self, handle, model=""):
        out = ctypes.c_void_p()
        self._call(self.lib.ctpu_embed_statistics, handle, model.encode(), ctypes.byref(out))
        return json.loads(self._take(out))

    def destroy(self, handle):
        self._call(self.lib.ctpu_embed_server_destroy, handle)


def success_counts(stats):
    """{model: successful requests} of a statistics document."""
    return {m["name"]: m["inference_stats"]["success"]["count"] for m in stats["model_stats"]}


def embed_in_process(path, device, size):
    """(b): the embed library in this process, a server of ``EMBED_MODELS``
    on ``device``: ``simple`` once, one warm decoder_lm token, then the
    decoder_lm sequence (the prompt and ``size.steps`` greedy steps), with
    the launch counts set to 0 just before it and read just after; then the
    same sequence through
    ``decoder_lm`` in this process. Tokens and logits bit-equal, the
    statistics counting the requests."""
    server = EmbeddedServer(path)
    t0 = time.perf_counter()
    handle = server.create({"models": EMBED_MODELS, "device": device})
    create_s = time.perf_counter() - t0
    try:
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        header = json.dumps({
            "inputs": [{"name": n, "datatype": "INT32", "shape": [1, 16],
                        "parameters": {"binary_data_size": 64}} for n in ("INPUT0", "INPUT1")],
            "outputs": [{"name": n, "parameters": {"binary_data": True}}
                        for n in ("OUTPUT0", "OUTPUT1")]}).encode()
        out = response_tensors(*server.infer(handle, "simple", header + a.tobytes() * 2,
                                             len(header)))
        if np.frombuffer(out["OUTPUT0"], np.int32).tolist() != (2 * a).reshape(-1).tolist():
            raise AssertionError("simple in the embedded server returned wrong sums")

        def run(tokens, start, end):
            got = response_tensors(*server.infer(handle, "decoder_lm",
                                                 *decoder_request(tokens, start, end)))
            return (np.frombuffer(got["LOGITS"], np.float32).reshape(1, -1),
                    int(np.frombuffer(got["NEXT_TOKEN"], np.int32)[0]))

        # one token first, outside the counts and the time: the model's
        # weights drawn onto the device, the libraries' set-up
        server.infer(handle, "decoder_lm", *decoder_request([1], True, True))
        reset_counts()
        t0 = time.perf_counter()
        tokens, logits = drive_decoder(run, size.prompt, size.steps)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        stats = success_counts(server.statistics(handle))
    finally:
        server.destroy(handle)
    decoder = TinyDecoderModel(device=device)
    want_tokens, want_logits = drive_decoder(in_process(decoder, 99), size.prompt, size.steps)
    stepped = len(size.prompt) + size.steps
    row = {"tokens": tokens, "in_process_tokens": want_tokens,
           "logits_bit_equal": bool(np.array_equal(logits.view(np.uint32),
                                                   want_logits.view(np.uint32))),
           "statistics_success": stats, "launches": counts, "create_s": create_s,
           "seconds": seconds, "ms_per_token": seconds * 1e3 / (size.steps + 1),
           "tokens_stepped": stepped, "layers": decoder.LAYERS,
           "logits": logits}
    if tokens != want_tokens or not row["logits_bit_equal"]:
        raise AssertionError(f"embedded decoder_lm: tokens {tokens}, in process {want_tokens}, "
                             f"logits bit-equal {row['logits_bit_equal']}")
    if stats != {"simple": 1, "decoder_lm": size.steps + 2}:
        raise AssertionError(f"embedded statistics count {stats}, sent simple 1 and "
                             f"decoder_lm {size.steps + 2} (the warm token included)")
    return row


def embed_host_child(path, device, size):
    """(c): ``csrc/embed_host.c`` as a child process hosting the same server
    on ``device``; started here, read by :func:`embed_host_result`."""
    cmd = [path, REPO, json.dumps({"models": EMBED_MODELS, "device": device}),
           str(size.steps), *map(str, size.prompt)]
    return subprocess.Popen(cmd, cwd=REPO, env=native_build.host_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), time.perf_counter()


def embed_host_result(child, embedded):
    """The C host's exit, its tokens and LOGITS bytes against (b)'s."""
    proc, t0 = child
    try:
        out, err = proc.communicate(timeout=EMBED_HOST_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    steps = [line.split() for line in out.splitlines() if line.startswith("step ")]
    tokens = [int(s[3]) for s in steps]
    logits = np.stack([np.frombuffer(bytes.fromhex(s[5]), np.float32) for s in steps]) \
        if steps else np.zeros((0,), np.float32)
    stats_line = next((x for x in out.splitlines() if x.startswith("statistics ")), None)
    row = {"exit": proc.returncode, "seconds": seconds, "tokens": tokens,
           "logits_bit_equal": bool(logits.shape == embedded["logits"].shape and np.array_equal(
               logits.view(np.uint32), embedded["logits"].view(np.uint32))),
           "statistics_success": (success_counts(json.loads(stats_line.split(" ", 1)[1]))
                                  if stats_line else None),
           "decode_ms": next((float(x.split()[1]) for x in out.splitlines()
                              if x.startswith("decode_ms ")), None)}
    if (proc.returncode != 0 or "PASS embed_host" not in out or tokens != embedded["tokens"]
            or not row["logits_bit_equal"]):
        raise AssertionError(f"embed_host exit {proc.returncode}, tokens {tokens} (in process "
                             f"{embedded['tokens']}), logits bit-equal "
                             f"{row['logits_bit_equal']}:\n{out[-2000:]}\n{err[-3000:]}")
    return row


def native_identity(client, nbytes, iters, tag):
    """identity_fp32 through a native client over the wire and over two
    ``NativeCudaShmRegion`` host windows (the server reads the input window
    onto its device and writes the output window)."""
    n = nbytes // 4
    x = (np.arange(n, dtype=np.float32) * 0.5).reshape(1, n)
    row = {"bytes": nbytes}

    def wire():
        return client.infer("identity_fp32", [("INPUT0", x)])["OUTPUT0"]

    if not np.array_equal(wire(), x):
        raise AssertionError("identity_fp32 over a native client's wire changed the tensor")
    row["wire_p50_ms"] = p50_ms(wire, iters)
    names = (f"nin{tag}", f"nout{tag}")
    regions = [native.NativeCudaShmRegion(name, nbytes) for name in names]
    try:
        for name, region in zip(names, regions):
            client.register_cuda_shared_memory(name, region.raw_handle(), 0, nbytes)

        def cuda():
            regions[0].write(x)
            client.infer("identity_fp32", [("INPUT0", ("shm", names[0], nbytes, 0, "FP32",
                                                       [1, n]))],
                         outputs=[("OUTPUT0", ("shm", names[1], nbytes, 0))])
            return regions[1].read(np.float32, [1, n])

        if not np.array_equal(cuda(), x):
            raise AssertionError("identity_fp32 over a native cuda shm region changed the tensor")
        row["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
        row["requests"] = 2 * (iters + 1)
    finally:
        client.unregister_shared_memory("cuda", "")
        for region in regions:
            region.destroy()
    return row


def native_long_context(client, encoder, cpu_encoder, seq, iters, tag):
    """long_context_encoder at ``seq`` over native cuda shm regions, against
    the CPU run of the port with the same weights (flash_attention's fp32
    tolerance)."""
    dim = cpu_encoder.encoder.dim
    tol = TOLERANCE["flash_attention"]["float32"]
    x = np.random.default_rng(seq).standard_normal((seq, dim)).astype(np.float32)
    want = cpu_encoder.execute({"sequence": x}, {})["encoded"].numpy()
    nbytes = x.nbytes
    names = (f"nlcin{tag}", f"nlcout{tag}")
    regions = [native.NativeCudaShmRegion(name, nbytes) for name in names]
    try:
        for name, region in zip(names, regions):
            client.register_cuda_shared_memory(name, region.raw_handle(), 0, nbytes)

        def cuda():
            regions[0].write(x)
            client.infer("long_context_encoder",
                         [("sequence", ("shm", names[0], nbytes, 0, "FP32", [seq, dim]))],
                         outputs=[("encoded", ("shm", names[1], nbytes, 0))])
            return regions[1].read(np.float32, [seq, dim])

        got = cuda()
        diff = float(np.abs(got - want).max())
        if not (np.isfinite(got).all() and np.allclose(got, want, atol=tol, rtol=tol)):
            raise AssertionError(f"long_context_encoder over native cuda shm: {diff} from the "
                                 "CPU run")
        p50 = p50_ms(cuda, iters)
    finally:
        client.unregister_shared_memory("cuda", "")
        for region in regions:
            region.destroy()
    return {"seq": seq, "dim": dim, "max_abs_diff_vs_cpu": diff, "tol": tol,
            "cuda_shm_p50_ms": p50, "requests": iters + 1}


def native_stream_decode(client, prompt, steps):
    """decoder_lm greedy over the native gRPC client's bidi stream:
    (tokens, logits)."""
    responses = queue.Queue()
    client.start_stream(lambda outputs, error: responses.put((outputs, error)))
    try:
        def run(tokens, start, end):
            client.stream_infer("decoder_lm", [("TOKENS", np.array([tokens], np.int32))],
                                sequence=(23, start, end))
            outputs, error = responses.get(timeout=600)
            if error is not None:
                raise AssertionError(f"decoder_lm over the native stream: {error}")
            return outputs["LOGITS"], int(outputs["NEXT_TOKEN"][0, 0])

        return drive_decoder(run, prompt, steps)
    finally:
        client.stop_stream()


def native_clients_rows(device, size, reference_tokens):
    """(d): the native HTTP and gRPC clients against the port's HTTP and
    gRPC servers over one core on ``device`` (the default zoo, the image
    ensemble and the encoder), each row with the launch counts set to 0
    just before it and read just after, and held to the core's executions."""
    encoder = LongContextEncoderModel(device=device)
    cpu_encoder = LongContextEncoderModel(device="cpu")
    load_jax_params(cpu_encoder, {name: getattr(encoder.encoder, name).cpu().numpy()
                                  for name in WEIGHTS})
    core = ServerCore(default_model_zoo(device)
                      + build_image_ensemble(size.vision_classes, size.vision_width,
                                             device=device)
                      + [encoder], device=device)
    layers = core.model("decoder_lm").LAYERS
    http_server = HttpInferenceServer(core).start()
    grpc_server = GrpcInferenceServer(core, max_workers=2 * max(size.concurrency) + 4).start()
    clients = {"http": native.NativeClient(http_server.url),
               "grpc": native.NativeGrpcClient(grpc_server.url)}
    rows, counts, expected = {}, {}, {}
    tag = os.urandom(4).hex()

    def executions(model):
        return core.statistics(model)["model_stats"][0]["execution_count"]

    def successes(model):
        return core.statistics(model)["model_stats"][0]["inference_stats"]["success"]["count"]

    raw = np.random.default_rng(0).integers(0, 256, (300, 400, 3)).astype(np.uint8)
    cpu_densenet = DenseNetModel(size.vision_classes, size.vision_width, seed=0, device="cpu")
    stage0 = ImagePreprocessModel(device="cpu").execute({"raw_image": raw}, {})["preprocessed"]
    cpu_top1 = int(cpu_densenet.execute({"data_0": stage0}, {})["fc6_1"].numpy().argmax())
    try:
        # one request of each model first (library set-up), outside the counts
        for client in clients.values():
            client.infer("ensemble_image", [("IMAGE", raw)], outputs=["CLASSIFICATION"])
            client.infer("long_context_encoder",
                         [("sequence", np.zeros((8, encoder.encoder.dim), np.float32))])

        for name, client in clients.items():
            path = f"identity_fp32 {name}"
            reset_counts()
            rows[path] = native_identity(client, size.identity_bytes, size.iters, tag + name)
            counts[path], expected[path] = read_counts(), {}

            path = f"long_context_encoder {name}"
            before = executions("long_context_encoder")
            reset_counts()
            rows[path] = native_long_context(client, encoder, cpu_encoder, size.seq, size.iters,
                                             tag + name)
            counts[path] = read_counts()
            expected[path] = {"flash_attention": executions("long_context_encoder") - before}

            path = f"ensemble_image {name}"
            before = executions("ensemble_image")
            reset_counts()
            t0 = time.perf_counter()
            top1 = []
            for _ in range(size.iters):
                out = client.infer("ensemble_image", [("IMAGE", raw)],
                                   outputs=["CLASSIFICATION"])["CLASSIFICATION"]
                top1.append(int(out.reshape(-1).argmax()))
            seconds = time.perf_counter() - t0
            counts[path] = read_counts()
            expected[path] = {"normalize_image": executions("ensemble_image") - before}
            rows[path] = {"top1": sorted(set(top1)), "cpu_top1": cpu_top1,
                          "requests": size.iters, "ms_per_request": seconds * 1e3 / size.iters}
            if set(top1) != {cpu_top1}:
                raise AssertionError(f"ensemble_image over the native {name} client: top-1 "
                                     f"{sorted(set(top1))}, the CPU run {cpu_top1}")

        path = "decoder_lm native grpc stream"
        reset_counts()
        t0 = time.perf_counter()
        tokens, logits = native_stream_decode(clients["grpc"], size.prompt, size.steps)
        seconds = time.perf_counter() - t0
        counts[path] = read_counts()
        stepped = len(size.prompt) + size.steps
        expected[path] = {"decode_attention": stepped * layers}
        rows[path] = {"tokens": tokens, "reference_tokens": reference_tokens,
                      "ms_per_token": seconds * 1e3 / (size.steps + 1),
                      "tokens_stepped": stepped, "layers": layers}
        if tokens != reference_tokens or not np.isfinite(logits).all():
            raise AssertionError(f"decoder_lm over the native gRPC stream: tokens {tokens}, "
                                 f"expected {reference_tokens}")

        path = "perf native-grpc cuda"
        runner = PerfRunner(grpc_server.url, "native-grpc", "identity_fp32", "cuda",
                            {"INPUT0": [1, size.identity_bytes // 4]}, device=device)
        try:
            succeeded = successes("identity_fp32")
            reset_counts()
            perf_rows = [runner.run(c, size.perf_requests) for c in size.concurrency]
            counts[path], expected[path] = read_counts(), {}
            sent = sum(row["requests"] + row["errors"] + row["shed"] for row in perf_rows)
            got = successes("identity_fp32") - succeeded
        finally:
            runner.close()
        rows[path] = {"rows": perf_rows, "sent": sent, "server_successes": got}
        if any(row["errors"] or row["shed"] for row in perf_rows) or got != sent:
            raise AssertionError(f"perf -i native-grpc --shared-memory cuda: "
                                 f"{[(r['errors'], r['error_sample']) for r in perf_rows]} "
                                 f"errors, the server counted {got} successes of {sent} sent")
    finally:
        for client in clients.values():
            client.close()
        grpc_server.stop()
        http_server.stop()
    return rows, counts, expected


def serve_native(served=None, grpc_served=None, device="cuda", size=NATIVE):
    """Phase 14: ``native_build`` (a), the embed library in this process
    (b), the C host in a child (c), and the native clients against the
    port's servers (d), on ``device``. ``served`` and ``grpc_served`` are
    phases 4 and 5's results: the native stream's tokens must be phase 5's
    (else those of decoder_lm in this process), and the identity rows'
    p50s stand beside theirs. Where ``native_build.probe`` finds no curl
    or zlib header, (d) is not run and the result names what is missing;
    any other failure fails the phase."""
    t_phase = time.perf_counter()
    found = native_build.probe()
    result = {"probe": found, "builds": {}, "missing_for_clients": native_build.missing(
        "http", found)}
    compiles = ThreadPoolExecutor(1)
    try:
        # the client library builds while (b) and (c) run
        clients_build = (None if result["missing_for_clients"]
                         else compiles.submit(native_build.build_http))
        for name in ("embed", "embed_host"):
            result["builds"][name] = native_build.build_all([name])[name]
        child = embed_host_child(result["builds"]["embed_host"]["path"], device, size)
        try:
            result["embedded"] = embed_in_process(result["builds"]["embed"]["path"], device,
                                                  size)
        except BaseException:
            child[0].kill()
            child[0].wait()
            raise
        result["embed_host"] = embed_host_result(child, result["embedded"])
        if clients_build is not None:
            result["builds"]["http"] = clients_build.result()
    finally:
        compiles.shutdown(wait=True)
    embedded = result["embedded"]
    result["expected_launches"] = {"embedded": {
        "decode_attention": embedded["tokens_stepped"] * embedded["layers"]}}
    result["launch_counts"] = {"embedded": embedded["launches"]}
    if clients_build is not None:
        reference = (grpc_served["decoder"]["tokens"] if grpc_served is not None
                     else embedded["in_process_tokens"])
        rows, counts, expected = native_clients_rows(device, size, reference)
        result["clients"] = rows
        result["launch_counts"].update(counts)
        result["expected_launches"].update(expected)
    if served is not None and grpc_served is not None:
        result["python_identity_p50_ms"] = {
            "http": {k: served["identity"][0][k] for k in ("wire_p50_ms", "cuda_shm_p50_ms")},
            "grpc": {k: grpc_served["identity"][0][k] for k in ("wire_p50_ms", "cuda_shm_p50_ms")}}
    if torch.device(device).type == "cuda":
        for path, counts in result["launch_counts"].items():
            want = {name: result["expected_launches"][path].get(name, 0) for name in COUNTERS}
            if counts != want:
                raise AssertionError(f"phase 14 launches on {path}: {counts}, expected {want}")
    embedded["logits"] = embedded["logits"].tolist()
    result["seconds"] = time.perf_counter() - t_phase
    return result


def log_native(result, card):
    """Phase 14's lines, each with the card's name and power limit."""
    log(f"native phase: {result['seconds']:.1f} s; {card}")
    log("native probe: " + json.dumps(result["probe"]))
    for name, build in result["builds"].items():
        log(f"native build {name}: {'built' if build['built'] else 'present'} in "
            f"{build['seconds']:.2f} s: {build['path']}")
        for cmd in build["commands"]:
            log(f"  {' '.join(cmd)}")
    if result["missing_for_clients"]:
        log("native clients not built on this machine: missing "
            + ", ".join(result["missing_for_clients"]))
    em, host = result["embedded"], result["embed_host"]
    log(f"embedded server in process: tokens {em['tokens']} = decoder_lm in process "
        f"(logits bit-equal {em['logits_bit_equal']}); {em['ms_per_token']:.3f} ms a token; "
        f"statistics {em['statistics_success']}; launches {em['launches']}; {card}")
    log(f"embed_host child: exit {host['exit']} in {host['seconds']:.2f} s, tokens "
        f"{host['tokens']}, logits bit-equal to the in-process run {host['logits_bit_equal']}, "
        f"decode {host['decode_ms']} ms; {card}")
    for path, row in result.get("clients", {}).items():
        shown = {k: v for k, v in row.items() if k != "rows"}
        if "rows" in row:
            shown["rows"] = [{k: r[k] for k in ("concurrency", "requests", "errors",
                                                "infer_per_sec", "latency_ms")
                              if k in r} for r in row["rows"]]
        log(f"native {path}: " + json.dumps(shown) + f"; launches "
            f"{result['launch_counts'][path]} = expected {result['expected_launches'][path]}; "
            f"{card}")
    if "python_identity_p50_ms" in result:
        log("python clients' identity_fp32 p50 (phases 4 and 5): "
            + json.dumps(result["python_identity_p50_ms"]) + f"; {card}")


# ---------------------------------------------------------------------------
# phase 15: long_context_encoder at the published widths whose head dims
# (96 and 256) the flash kernel took last
# ---------------------------------------------------------------------------

WideSize = collections.namedtuple("WideSize", ["widths", "wire_seq", "requests",
                                               "child_profiled"])
# (name, dim, heads, S over cuda shm): Phi-3-mini
# (microsoft/Phi-3-mini-4k-instruct: hidden_size 3072, num_attention_heads
# 32, head dim 96) and Gemma-2B (google/gemma-2b: hidden_size 2048,
# num_attention_heads 8, head_dim 256), the encoder being one attention
# layer, so neither width nor depth is cut; then a width the JAX
# constructor takes whose head dim (512) is past 256, the wide flash
# kernels' (no published model in the records has one), at S = 1024. The
# published widths have one request profiled in a process of their own.
WIDE = WideSize(widths=(("phi3_mini", 3072, 32, 8192), ("gemma_2b", 2048, 8, 8192),
                        ("head_dim_512", 2048, 4, 1024)),
                wire_seq=1024, requests=10, child_profiled=("phi3_mini", "gemma_2b"))


def encoder_plain(model, x):
    """The encoder with the flash kernel's plain version in its place: the
    model's own projections (``torch.matmul``) around
    ``flash_attention_reference`` (dense fp32) on x's device."""
    enc = model.encoder
    seq, head_dim = x.shape[0], enc.dim // enc.heads
    q, k, v = ((x @ w).reshape(1, seq, enc.heads, head_dim) for w in (enc.wq, enc.wk, enc.wv))
    return flash_attention_reference(q, k, v).reshape(seq, enc.dim) @ enc.wo


def wide_bounds(seq, dim, heads):
    """The least time of one request's device work over the fp32 peak (the
    matmuls use no TF32), reckoned as the kernel table does: the
    attention's 4*H*S^2*D flops and the four projections' 8*S*dim^2 flops;
    where the flash kernel runs 3xTF32 (head dims 33-256), its bound at the
    TF32 peak beside (``flash_bound``)."""
    attention = 4 * heads * seq * seq * (dim // heads)
    projections = 8 * seq * dim * dim
    tf32 = ({"attention_3xtf32_bound_ms": 3 * attention / PEAK_TF32_FLOPS * 1e3}
            if runs_3xtf32(dim // heads, "float32") else {})
    return {"attention_gflop": attention / 1e9,
            "attention_bound_ms": attention / PEAK_FLOPS["float32"] * 1e3, **tf32,
            "projections_gflop": projections / 1e9,
            "projections_bound_ms": projections / PEAK_FLOPS["float32"] * 1e3}


def wide_check(got, want, row, where):
    """Every element within the flash kernel's fp32 tolerance (2e-5, the
    tier-1 bound of the port's plain version against JAX's model at these
    widths): both sides are fp32 with fp32 sums, and differ in their order."""
    tol = TOLERANCE["flash_attention"]["float32"]
    got, want = got.float().cpu(), want.float().cpu()
    row[f"{where}_max_abs_err"] = (got - want).abs().max().item()
    if not (got.shape == want.shape and torch.isfinite(got).all()
            and torch.allclose(got, want, atol=tol, rtol=tol)):
        raise AssertionError(f"long_context_encoder {where}: {row}")


@contextmanager
def wide_cuda_request(client, x, device):
    """A function that sends x to long_context_encoder over colocated cuda
    shm (cuda regions on the CPU in a CPU run) and returns the output, the
    regions registered for the block's life."""
    seq, dim = x.shape
    nbytes = seq * dim * 4
    tag = os.urandom(4).hex()
    names = (f"wdin{tag}", f"wdout{tag}")
    regions = [cudashm.create_shared_memory_region(n, nbytes, colocated=True,
                                                   device="cuda" if device == "cuda" else "cpu")
               for n in names]
    try:
        for name, region in zip(names, regions):
            client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)

        def request():
            cudashm.set_shared_memory_region_from_torch(regions[0], x)
            inp = httpclient.InferInput("sequence", [seq, dim], "FP32").set_shared_memory(
                names[0], nbytes)
            out = httpclient.InferRequestedOutput("encoded")
            out.set_shared_memory(names[1], nbytes)
            client.infer("long_context_encoder", [inp], outputs=[out])
            y = cudashm.get_contents_as_torch(regions[1], "FP32", [seq, dim])
            if device == "cuda":
                torch.cuda.synchronize()  # the output is ready to use
            return y

        yield request
    finally:
        client.unregister_cuda_shared_memory()
        for region in regions:
            cudashm.destroy_shared_memory_region(region)


def profiled_request(request):
    """One call of ``request`` under torch.profiler (CPU and CUDA activity):
    wall, device time, the device idle share and flash_attention's device
    time (None where the trace holds no kernel)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels)
    return {"wall_ms": wall_ms, "device_ms": device_ms if kernels else None,
            "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
            "flash_attention_ms": (sum(k["total_ms"] for k in kernels
                                       if "flash_attention" in k["name"])
                                   if kernels else None),
            "top_kernels": kernels[:4]}


def wide_cuda_row(client, model, x, size, device, row):
    """x (S rows) over colocated cuda shm: the output against the plain
    version on the same device with the same weights, the p50 of
    ``size.requests`` requests, and on the card one request profiled.
    Returns the requests made."""
    with wide_cuda_request(client, x, device) as request:
        got = request()
        wide_check(got, encoder_plain(model, x), row, "cuda_shm_vs_plain")
        row["cuda_shm_p50_ms"] = p50_ms(request, size.requests)
        if device == "cuda":
            row["profile"] = profiled_request(request)
    return 1 + size.requests + (1 if device == "cuda" else 0)


# one request of the wide encoder profiled in a process of its own: in the
# script's process the profiler has recorded no kernel of phase 15 (an
# open question); argv: repo, dim, heads, seq, device
WIDE_PROFILE_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
dim, heads, seq = (int(a) for a in sys.argv[2:5])
print("WIDE_PROFILE " + json.dumps(chip_smoke.wide_request_profile(dim, heads, seq, sys.argv[5])),
      flush=True)
"""


def wide_request_profile(dim, heads, seq, device="cuda"):
    """In ``WIDE_PROFILE_CHILD``'s process: the encoder at (dim, heads)
    behind ``ServerCore`` and the HTTP server, two requests of S = seq over
    colocated cuda shm, then one profiled (``profiled_request``; on the CPU
    its trace holds no device kernel)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LongContextEncoderModel(dim=dim, heads=heads, seed=0, attention="flash",
                                    device=device)
    with HttpInferenceServer(ServerCore([model], device=device)) as server, \
            httpclient.InferenceServerClient(server.url, network_timeout=600.0) as client:
        client.configure_integrity(IntegrityPolicy())
        gen = torch.Generator(device=device).manual_seed(dim)
        x = torch.randn((seq, dim), generator=gen, device=device)
        with wide_cuda_request(client, x, device) as request:
            for _ in range(2):
                request()
            return profiled_request(request)


def wide_profile_in_child(dim, heads, seq, device="cuda"):
    """``wide_request_profile`` in a process of its own; its result."""
    proc = subprocess.run([sys.executable, "-c", WIDE_PROFILE_CHILD, REPO, str(dim), str(heads),
                           str(seq), device], capture_output=True, text=True, timeout=300)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("WIDE_PROFILE ")), None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"wide profile child exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(line[len("WIDE_PROFILE "):])


def serve_wide_encoder(device="cuda", size=WIDE):
    """Phase 15: long_context_encoder (flash) through ``ServerCore`` and the
    port's HTTP server in this process at each width of ``size.widths``
    (seed-0 weights): the width's S over colocated cuda shm held against
    the plain version on the same device, and S = ``size.wire_seq`` over
    the wire held against a CPU run of the port; flash_attention launches
    equal the server's executions in each row (0 on the CPU, where the
    wrapper runs its plain version), and the statistics count the
    requests."""
    on_card = device == "cuda"
    rows = []
    t_phase = time.perf_counter()
    for name, dim, heads, seq in size.widths:
        t_row = time.perf_counter()
        row = {"width": name, "dim": dim, "heads": heads, "head_dim": dim // heads,
               "seq": seq, "wire_seq": size.wire_seq, "p50_requests": size.requests,
               **wide_bounds(seq, dim, heads)}
        model = LongContextEncoderModel(dim=dim, heads=heads, seed=0, attention="flash",
                                        device=device)
        core = ServerCore([model], device=device)

        def executions():
            stats = core.statistics()["model_stats"][0]
            return stats["execution_count"], stats["inference_stats"]["success"]["count"]

        with HttpInferenceServer(core) as server, httpclient.InferenceServerClient(
                server.url, network_timeout=600.0) as client:
            # an integrity policy of its own: the contract cache is keyed by
            # model name, and the process default's holds the dim-64 encoder
            client.configure_integrity(IntegrityPolicy())
            gen = torch.Generator(device=device).manual_seed(dim)
            x = torch.randn((seq, dim), generator=gen, device=device)
            before = executions()
            reset_counts()
            sent = wide_cuda_row(client, model, x, size, device, row)
            counts = read_counts()
            after = executions()
            row["cuda_shm"] = {"requests": sent, "executions": after[0] - before[0],
                               "successes": after[1] - before[1], "launches": counts}
            if on_card and name in size.child_profiled:
                row["child_profile"] = wide_profile_in_child(dim, heads, seq)
            small = x[:size.wire_seq].contiguous()
            cpu = LongContextEncoderModel(dim=dim, heads=heads, seed=0, attention="flash",
                                          device="cpu")
            want = cpu.execute({"sequence": small.cpu().numpy()}, {})["encoded"]
            before = executions()
            reset_counts()
            inp = httpclient.InferInput("sequence", list(small.shape), "FP32")
            inp.set_data_from_numpy(small.cpu().numpy())
            t0 = time.perf_counter()
            got = client.infer("long_context_encoder", [inp]).as_numpy("encoded")
            row["wire_ms"] = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            after = executions()
            row["wire"] = {"requests": 1, "executions": after[0] - before[0],
                           "successes": after[1] - before[1], "launches": counts}
            wide_check(torch.from_numpy(got.copy()), want, row, "wire_vs_cpu")
        if on_card:
            # the flash kernel alone at the row's attention shape, per call
            # (CUDA events), outside the counted paths
            fq, fk, fv = flash_inputs((1, seq, heads, dim // heads), torch.float32, seed=dim)
            row["flash_ms"] = cuda_ms(lambda: flash_attention(fq, fk, fv), 3 if seq > 2048 else 10)
            del fq, fk, fv
        for plane in ("cuda_shm", "wire"):
            r = row[plane]
            flash = r["launches"]["flash_attention"]
            others = {k: v for k, v in r["launches"].items() if k != "flash_attention" and v}
            if (r["executions"] != r["requests"] or r["successes"] != r["requests"] or others
                    or flash != (r["executions"] if on_card else 0)):
                raise AssertionError(f"long_context_encoder {name} {plane}: launches and "
                                     f"statistics {r}")
        row["seconds"] = time.perf_counter() - t_row
        rows.append(row)
        del model, core
        if on_card:
            torch.cuda.empty_cache()
    return {"rows": rows, "seconds": time.perf_counter() - t_phase}


def log_wide(result, card):
    """Phase 15's lines, each with the card's name and power limit."""
    log(f"wide encoder phase: {result['seconds']:.1f} s; {card}")
    for row in result["rows"]:
        prof = row.get("profile") or {}
        device = ("not measured" if prof.get("device_ms") is None else
                  f"{prof['device_ms']:.3f} ms on the device (idle "
                  f"{prof['device_idle_share']:.1%}), flash_attention "
                  f"{prof['flash_attention_ms']:.3f} ms")
        child = row.get("child_profile")
        if child is not None:
            device += (f"; one request profiled in a process of its own {child['wall_ms']:.3f} ms "
                       "wall, " + ("the profiler recorded no device time"
                                   if child["device_ms"] is None
                                   else f"{child['device_ms']:.3f} ms on the device (idle "
                                   f"{child['device_idle_share']:.1%}), flash_attention "
                                   f"{child['flash_attention_ms']:.3f} ms"))
        log(f"long_context_encoder {row['width']} (dim {row['dim']}, heads {row['heads']}, "
            f"head dim {row['head_dim']}; {row['seconds']:.1f} s) S={row['seq']} cuda shm p50 "
            f"{row['cuda_shm_p50_ms']:.3f} ms over {row['p50_requests']} requests; one profiled "
            f"request {prof.get('wall_ms', float('nan')):.3f} ms wall, {device}; bounds: "
            f"attention {row['attention_gflop']:.1f} GFLOP -> {row['attention_bound_ms']:.2f} ms, "
            f"projections {row['projections_gflop']:.1f} GFLOP -> "
            f"{row['projections_bound_ms']:.2f} ms (fp32 peak)"
            + ("" if "attention_3xtf32_bound_ms" not in row else
               f", attention in 3xTF32 at the TF32 peak {row['attention_3xtf32_bound_ms']:.2f} ms")
            + "; max |err| vs the plain version "
            f"on the same device {row['cuda_shm_vs_plain_max_abs_err']:.3g}"
            + ("" if row.get("flash_ms") is None else
               f"; flash_attention alone at (1, {row['seq']}, {row['heads']}, "
               f"{row['head_dim']}) {row['flash_ms']:.4f} ms a call")
            + f"; {card}")
        log(f"long_context_encoder {row['width']} S={row['wire_seq']} over the wire "
            f"{row['wire_ms']:.3f} ms; max |err| vs the CPU run "
            f"{row['wire_vs_cpu_max_abs_err']:.3g}; flash_attention launches "
            f"{row['cuda_shm']['launches']['flash_attention']} = "
            f"{row['cuda_shm']['executions']} executions (cuda shm), "
            f"{row['wire']['launches']['flash_attention']} = {row['wire']['executions']} "
            f"(wire); statistics successes {row['cuda_shm']['successes']} + "
            f"{row['wire']['successes']} = requests sent; {card}")


def device_kernels(prof):
    """Device time by kernel in a torch.profiler trace, largest first."""
    kernels = []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", 0)
        if device_us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": event.key[:80], "count": event.count,
                            "total_ms": device_us / 1e3})
    kernels.sort(key=lambda k: -k["total_ms"])
    return kernels


def profile_long_context(model, seq, runs):
    """Device kernel time against wall time for ``runs`` long_context_encoder
    executes at ``seq`` on a device input, in process (no HTTP)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((seq, model.encoder.dim), generator=gen, device="cuda")

    def run():
        for _ in range(runs):
            model.execute({"sequence": x}, {})
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels) / runs
    flash_ms = sum(k["total_ms"] for k in kernels if "flash_attention" in k["name"]) / runs
    return {
        "seq": seq, "runs": runs, "wall_ms": wall_ms,
        "device_ms": device_ms if kernels else None,
        "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
        "flash_attention_ms": flash_ms if kernels else None,
        "top_kernels": kernels[:6],
    }


def profile_densenet(model, runs):
    """Device kernel time against wall time for ``runs`` densenet_onnx
    executes on a device image, in process (no HTTP)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((3, 224, 224), generator=gen, device="cuda")

    def run():
        for _ in range(runs):
            model.execute({"data_0": x}, {})
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels) / runs
    return {
        "runs": runs, "wall_ms": wall_ms,
        "device_ms": device_ms if kernels else None,
        "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
        "kernel_launches_per_request": (sum(k["count"] for k in kernels) / runs
                                        if kernels else None),
        "top_kernels": kernels[:8],
    }


def profile_decode(decoder, prompt, steps):
    """Device kernel time against wall time for the decoder_lm request loop,
    run in process (no HTTP), from a torch.profiler trace."""
    def direct(tokens, start, end):
        out = decoder.execute({"TOKENS": np.array([tokens], dtype=np.int32)},
                              {"sequence_id": 29, "sequence_start": start, "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    drive_decoder(direct, prompt, steps)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_decoder(direct, prompt, steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive_decoder(direct, prompt, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tokens = len(prompt) + steps
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels)
    attention = [k for k in kernels if "decode_attention" in k["name"]]
    attention_ms = sum(k["total_ms"] for k in attention)
    attention_launches = sum(k["count"] for k in attention)
    return {
        "tokens": tokens,
        "wall_ms_per_token": plain_wall_ms / tokens,
        "profiled_wall_ms_per_token": wall_ms / tokens,
        "device_ms_per_token": device_ms / tokens if kernels else None,
        # kernel time is the same with the profiler on; its host cost is not
        "device_idle_share": 1 - device_ms / plain_wall_ms if kernels else None,
        "decode_attention_ms_per_token": attention_ms / tokens if kernels else None,
        "decode_attention_ms_per_launch": (attention_ms / attention_launches
                                           if attention_launches else None),
        "top_kernels": kernels[:8],
    }


def small_kernel_times():
    """The four small kernels timed at the served and the large shapes
    (per call, on the device, plain, library, bound, and at the served
    shapes the host time per call), and the host time per call of the two
    attention wrappers at their served shapes; each row logged. Only the
    public wrappers and plain versions are called, so the same function
    times an earlier tree of the port (``--kernel-times``)."""
    quant_timed = [time_quantize(8192, 200), time_quantize(16 * MIB, 20)]
    dequant_bf16 = time_dequantize_to(16 * MIB, torch.bfloat16, 20)
    library = ("none" if dequant_bf16["library_ms"] is None
               else f"{dequant_bf16['library_ms']:.4f} ms")
    log(f"time dequantize_int8 n={dequant_bf16['n']} bf16 out: kernel {dequant_bf16['ms']:.4f} "
        f"ms ({ms_text(dequant_bf16['device_ms'])} on the device), plain "
        f"{dequant_bf16['plain_ms']:.4f} ms, library {library} (torch.mul(q, scale, out=o) "
        f"{dequant_bf16['library_candidate_ms']:.4f} ms, {dequant_bf16['library_mismatches']} "
        f"bit mismatches; {ms_text(dequant_bf16['library_device_ms'])} on the device), "
        f"{bound_text(dequant_bf16)}")
    for row in quant_timed:
        for name in ("quantize", "dequantize"):
            t = row[name]
            library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            extra = ""
            if "library_candidate_ms" in t:
                extra = (f" (torch.quantize_per_tensor {t['library_candidate_ms']:.4f} ms, "
                         f"{t['library_mismatches']} int8 mismatches"
                         + (f", {t['library_mismatches_wire']} on the wire input"
                            if "library_mismatches_wire" in t else "")
                         + f"; at {t['library_mismatch_at'][:3]})")
            log(f"time {name}_int8 n={row['n']} fp32: kernel {t['ms']:.4f} ms "
                f"({ms_text(t['device_ms'])} on the device{host_text(t, 'host_us')}), plain "
                f"{t['plain_ms']:.4f} ms, library {library}{extra} "
                f"({ms_text(t['library_device_ms'])} on the device"
                f"{host_text(t, 'library_host_us')}), {bound_text(t)}")
        ceiling = row["dequantize"].get("write_ceiling")
        if ceiling:
            log(f"time write ceiling {ceiling['call']} n={ceiling['n']}: {ceiling['ms']:.4f} "
                f"ms ({ms_text(ceiling['device_ms'])} on the device), "
                f"{bound_text(ceiling)}")
    # the image_client's input first: the row of the kernels line
    norm_timed = [time_normalize((224, 224, 3), torch.float32, 200),
                  time_normalize((224, 224, 3), torch.uint8, 200),
                  time_normalize((16 * MIB,), torch.float32, 20),
                  time_normalize((16 * MIB,), torch.uint8, 20)]
    softmax_timed = [time_softmax((1, VISION_CLASSES), 200),
                     time_softmax((16384, VISION_CLASSES), 20)]
    for name, timed_rows in (("normalize_image", norm_timed),
                             ("softmax_probabilities", softmax_timed)):
        for row in timed_rows:
            library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
            extra = ""
            if "library_mismatches" in row:
                extra = (f" (torch.add(shift, x, alpha=scale) {row['library_candidate_ms']:.4f} "
                         f"ms, {row['library_mismatches']} bit mismatches)")
            log(f"time {name} {row['shape']} {row.get('in', row.get('dtype'))}: kernel "
                f"{row['ms']:.4f} ms ({ms_text(row['device_ms'])} on the device"
                f"{host_text(row, 'host_us')}), plain {row['plain_ms']:.4f} ms, "
                f"library {library}{extra} ({ms_text(row['library_device_ms'])} on the device"
                f"{host_text(row, 'library_host_us')}), {bound_text(row)}")
    attention = attention_host_us()
    for name, us in attention.items():
        log(f"host {name} at its served shape: {us:.3f} us per call")
    return {"quantize": quant_timed, "dequantize_bf16": dequant_bf16, "normalize": norm_timed,
            "softmax": softmax_timed, "attention_host_us": attention}


def log_attention_times(decode_rows, flash_rows):
    """One line per timed decode_attention and flash_attention row."""
    for row in decode_rows:
        device = ("not measured" if row["device_ms"] is None
                  else f"{row['device_ms']:.4f} ms")
        pos = row["pos"] if len(set(row["pos"])) > 1 else row["pos"][0]
        log(f"time decode_attention {row['shape']} pos {pos} {row['dtype']} splits "
            f"{row['splits']}: kernel {row['ms']:.4f} ms per call ({device} on the "
            f"device), plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_ms'] / row['ms']:.1%} of bound)")
    for row in flash_rows:
        fma = ("" if "fma_bound_ms" not in row else
               f"; the fp32 FMA bound {row['fma_bound_ms']:.5f} ms")
        log(f"time flash_attention {row['shape']} {row['dtype']} causal={row['causal']}: "
            f"kernel {row['ms']:.4f} ms ({ms_text(row.get('device_ms'))} on the device), "
            f"plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}, {row['bound_basis']}; "
            f"{row['bound_ms'] / row['ms']:.1%} of bound{fma})")


def attention_kernel_times():
    """decode_attention and flash_attention at the head dims and dtypes
    the port served before every head dim up to 256 ran (the decoders' step,
    full caches, the encoder's shapes, chip_bench's and the fp32 P-tile
    kernel's), each row logged. Only the public wrappers are called, so
    ``--kernel-times`` in an earlier tree times that tree's kernels."""
    decode = [time_decode_attention((1, 4, 128, 32), [11], 200)]
    for shape, iters, name in (((8, 8, 2048, 128), 50, "bfloat16"),
                               ((8, 8, 8192, 128), 20, "bfloat16"),
                               ((16, 8, 4096, 128), 20, "bfloat16"),
                               ((8, 8, 8192, 128), 20, "float32"),
                               ((8, 8, 8192, 64), 20, "bfloat16")):
        decode.append(time_decode_attention(shape, [shape[2] - 1] * shape[0], iters, name))
    flash = [time_flash_attention((1, s, 4, 16), "float32", False, iters)
             for s, iters in ((8192, 20), (4096, 50), (100, 200))]
    flash += [time_flash_attention((4, 2048, 8, 128), "bfloat16", causal, 10)
              for causal in (False, True)]
    flash += [time_flash_attention((1, 4096, 8, d), "float32", False, 10) for d in (64, 128)]
    # the wide encoder's shapes (phase 15) in fp32: the 3xTF32 kernel's
    # served rows
    flash += [time_flash_attention((1, 8192, h, d), "float32", False, 3)
              for h, d in ((32, 96), (8, 256))]
    log_attention_times(decode, flash)
    return {"decode": decode, "flash": flash}


def time_new_element_dtypes(iters: int = 20):
    """The input dtypes the four elementwise kernels took last, each kernel
    at 16 Mi elements (softmax at (16384, 1000)): kernel and plain version
    per call (CUDA events) beside the bytes bound, each input read once and
    each output written once. Only these rows call the new dtypes, so
    ``--kernel-times`` (an earlier tree's wrappers) never reaches them."""
    n, rows = 16 * MIB, []
    integers = {name: dtype for name, dtype in ELEMENT_IN.items()
                if not dtype.is_floating_point}
    plans = [("normalize_image", name, (n,), lambda x: ops.normalize_image(
        x, *INCEPTION, torch.float32), lambda x: nz.normalize_image_reference(
        x, *INCEPTION, torch.float32), 4) for name in NEW_ELEMENT_IN]
    plans += [("softmax_probabilities", name, (16384, VISION_CLASSES), ops.softmax_probabilities,
               sm.softmax_probabilities_reference, 4) for name in integers]
    plans += [("quantize_int8", name, (n,), lambda x: qz.quantize_int8(x, 2.0),
               lambda x: qz.quantize_int8_reference(x, 2.0), 1) for name in integers]
    plans += [("dequantize_int8", name, (n,), lambda x: qz.dequantize_int8(x, 0.37),
               lambda x: qz.dequantize_int8_reference(x, 0.37), 4)
              for name in ELEMENT_IN if name != "int8"]
    for kernel, name, shape, call, plain, out_size in plans:
        x = image_input(shape, ELEMENT_IN[name], seed=len(rows))
        out, ref = call(x), plain(x)
        if kernel == "softmax_probabilities":
            ok = torch.allclose(out, ref, rtol=TOLERANCE[kernel]["rtol"],
                                atol=TOLERANCE[kernel]["atol"])
        else:
            ok = torch.equal(out, ref)
        if not ok:
            raise AssertionError(f"{kernel} {name} in disagrees with its plain version")
        numel = x.numel()
        rows.append({"kernel": kernel, "in": name, "shape": list(shape),
                     "ms": cuda_ms(lambda: call(x), iters),
                     "plain_ms": cuda_ms(lambda: plain(x), iters),
                     "bound_ms": numel * (x.element_size() + out_size) / PEAK_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"})
    return rows


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_text(row, key) -> str:
    return f", {row[key]:.2f} us on the host" if key in row else ""


def device_share(row) -> None:
    """Store in ``row`` the share of its bound that its device time
    reaches (None where the profiler gave no device time)."""
    row["device_share_of_bound"] = (None if row.get("device_ms") is None
                                    else row["bound_ms"] / row["device_ms"])


def bound_text(row) -> str:
    """The bound and the shares of it that the per-call and the device
    times reach."""
    share = row.get("device_share_of_bound")
    device = "" if share is None else f", {share:.1%} on the device"
    return (f"bound {row['bound_ms']:.5f} ms (bytes; {row['bound_ms'] / row['ms']:.1%} of "
            f"bound per call{device})")


def attention_host_us():
    """Host time per call (enqueue, no sync) of the decode and flash
    wrappers at their served shapes: the decoder's step (1, 4, 128, 32) bf16
    at pos 11 and the encoder's (1, 100, 4, 16) fp32."""
    q, k, v = attention_inputs(1, 4, 128, 32, torch.bfloat16, seed=7)
    pos = torch.tensor([11], dtype=torch.int32, device="cuda")
    fq, fk, fv = flash_inputs((1, 100, 4, 16), torch.float32, seed=99)
    return {"decode_attention": host_us(lambda: da.decode_attention(q, k, v, pos)),
            "flash_attention": host_us(lambda: flash_attention(fq, fk, fv))}


def host_breakdown(calls: int = 10000):
    """Host time of each piece of one normalize_image call at the
    image_client's (224, 224, 3) uint8 -> fp32, median over ``calls`` calls
    each: the pieces of the launch path the five wrappers had before they
    shared ``_kernels.launch`` ("before", rebuilt here call for call) and
    those of the shared path ("after"), then the whole wrapper."""
    x = image_input((224, 224, 3), torch.uint8, seed=3)
    scale, shift = INCEPTION
    out = ops.normalize_image(x, scale, shift, torch.float32)
    dev = x.device
    index = x.get_device()
    n = x.numel()
    fn = _kernels.function("normalize_image", "normalize_image_launch", nz._ARGTYPES)
    blocks = nz.normalize_plan(n, x.dtype, torch.float32, True, sms()).blocks
    counter = type(nz.LAUNCHES)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    in_codes, out_codes = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}, {
        torch.float32: 0, torch.bfloat16: 1}

    def before_device_check():
        with (nullcontext() if dev.index is None or dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            pass

    pieces = [
        ("before", "checks (dtype, out dtype, contiguity, x.device.type)",
         lambda: (x.dtype not in in_codes, torch.float32 not in out_codes,
                  x.is_contiguous(), x.device.type)),
        ("before", "torch.empty(x.shape, dtype, device=x.device)",
         lambda: torch.empty(x.shape, dtype=torch.float32, device=x.device)),
        ("before", "_kernels.function lookup",
         lambda: _kernels.function("normalize_image", "normalize_image_launch",
                                   nz._ARGTYPES)),
        ("before", "device check: x.device, current_device, nullcontext",
         before_device_check),
        ("before", "scale and shift rounded by np.float32",
         lambda: (float(np.float32(scale)), float(np.float32(shift)))),
        ("before", "torch.cuda.current_stream(x.device).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        ("both", "ctypes call (launches the kernel)",
         lambda: fn(x.data_ptr(), out.data_ptr(), n, _kernels.ELEMENT_CODES[torch.uint8], 0,
                    scale, shift, blocks, stream)),
        ("both", "launch counter (a lock)", counter.add),
        ("after", "checks (dict.get x2, contiguity, is_cuda)",
         lambda: (in_codes.get(x.dtype), out_codes.get(torch.float32), x.is_contiguous(),
                  x.is_cuda)),
        ("after", "torch.empty_like(x, dtype)", lambda: torch.empty_like(x, dtype=torch.float32)),
        ("after", "x.get_device()", x.get_device),
        ("after", "normalize_plan + sm_count",
         lambda: nz.normalize_plan(n, x.dtype, torch.float32, True, _kernels.sm_count(index))),
        ("after", "raw stream: torch._C._cuda_getCurrentRawStream(index)",
         lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("after", "device check: index == current_device()",
         lambda: index == torch.cuda.current_device()),
        ("after", "the whole wrapper (ops.normalize_image)",
         lambda: ops.normalize_image(x, scale, shift, torch.float32)),
    ]
    return [{"side": side, "piece": piece, "calls": calls, "us": host_us(call, calls)}
            for side, piece, call in pieces]


def main(argv) -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = device_line()
    log(f"device: {smi}")

    seconds, ptxas = build_kernels(check_spills=argv != ["--kernel-times"])
    log(f"build: {seconds:.2f} s")
    for line in ptxas:
        log(f"  ptxas: {line}")
    if argv == ["--kernel-times"]:
        # the small kernels' timings alone, for the tree this file sits in
        # (copied into another tree of the port, it times that one)
        small = small_kernel_times()
        small["attention"] = attention_kernel_times()
        # the cases the attention kernels took last, where this tree's
        # wrappers take them (an earlier tree's refuse them)
        if hasattr(sys.modules["client_tpu_torch.ops.flash_attention"], "check_blocks"):
            small["attention"]["new"] = time_new_attention()
            log_new_attention([], [], small["attention"]["new"])
        log(smi)
        log(json.dumps({"kernel_times": small, "device": kind}))
        return 0
    if argv:
        log(f"chip_smoke: unknown arguments {argv} (none, or --kernel-times)")
        return 2
    smem = _kernels.function("flash_attention", "flash_attention_smem_bytes",
                             (ctypes.c_int, ctypes.c_int))
    log("  flash_attention dynamic shared memory per block (bytes, by padded head dim): "
        + ", ".join(f"{name} D<={dim} {smem(code, dim)}"
                    for name, code in (("bf16/fp16", 1), ("fp32", 0))
                    for dim in (16, 32, 64, 96, 128, 256, 512, 2048))
        + " (D > 256: the wide kernels, a cluster of blocks a query tile, a slab of at most 128"
        " columns a block; past 1024 a second Q buffer, and fp32 at 64 query rows, not 80)")

    rows, worst = check_decode_attention()
    for row in rows:
        split = (f" splits {row['splits']}; vs the split plain version "
                 f"{row['max_abs_err_vs_split_plain']:.3g}" if "splits" in row else "")
        log(f"kernel decode_attention {row['case']} {row['shape']} pos {row['pos']} "
            f"{row['dtype']}: max_abs_err {row['max_abs_err']:.3g} (tol {row['tol']}{split})")
    # the decoder's shape mid-run (the kernels line's row) and at a full cache
    timed = [time_decode_attention((1, 4, 128, 32), pos, 200) for pos in ([11], [127])]
    for shape, iters in (((8, 8, 2048, 128), 50), ((8, 8, 8192, 128), 20),
                         ((16, 8, 4096, 128), 20)):
        timed.append(time_decode_attention(shape, [shape[2] - 1] * shape[0], iters))
    # the dtype and head dims the kernel took last: fp16 at the full cache,
    # Phi-3-mini's head dim 96 (32 heads) and Gemma-2B's 256 (8 heads)
    for shape, name in (((8, 8, 8192, 128), "float16"), ((8, 32, 4096, 96), "bfloat16"),
                        ((8, 8, 4096, 256), "bfloat16"), ((8, 8, 4096, 256), "float32")):
        timed.append(time_decode_attention(shape, [shape[2] - 1] * shape[0], 20, name))
    batched_timed = time_decode_attention(BATCHED_SHAPE, BATCHED_POS, 200)
    log_attention_times(timed + [batched_timed], [])

    flash_rows = check_flash_attention()
    for row in flash_rows:
        log(f"kernel flash_attention {row['case']} {row['shape']} {row['dtype']} "
            f"causal={row['causal']} blocks {row['blocks']}: max_abs_err "
            f"{row['max_abs_err']:.3g} (atol {row['tol'][0]:.3g}, rtol {row['tol'][1]:.3g})"
            + ("" if row["dtype"] not in TILED_TOLERANCE else
               f"; vs the tiled plain version {row['max_abs_err_vs_tiled_plain']:.3g} (atol "
               f"{TILED_TOLERANCE[row['dtype']]['atol']:g}, rtol "
               f"{TILED_TOLERANCE[row['dtype']]['rtol']:g})")
            + ("" if "max_abs_err_vs_3xtf32" not in row else
               f"; vs the 3xTF32 emulation {row['max_abs_err_vs_3xtf32']:.3g} (atol = rtol "
               f"{TF32_EMULATION_TOLERANCE:g})"))
    # the served shape at its largest length first: the row of the kernels line
    flash_timed = [time_flash_attention((1, s, 4, 16), "float32", False, iters)
                   for s, iters in ((8192, 20), (4096, 50), (100, 200))]
    flash_timed += [time_flash_attention((4, 2048, 8, 128), name, causal, 10)
                    for name in ("bfloat16", "float16") for causal in (False, True)]
    # the head dims the kernel took last: the wide encoder's shapes (phase 15)
    # in fp32, and the same heads at S = 4096 on the tensor cores
    flash_timed += [time_flash_attention((1, 8192, h, d), "float32", False, 3)
                    for h, d in ((32, 96), (8, 256))]
    # and the 3xTF32 kernel's two other widths at S = 4096 (padded widths 128
    # and 64)
    flash_timed += [time_flash_attention((1, 4096, 8, d), "float32", False, 10)
                    for d in (128, 64)]
    flash_timed += [time_flash_attention((1, 4096, h, d), name, False, 10)
                    for h, d in ((32, 96), (8, 256)) for name in ("bfloat16", "float16")]
    log_attention_times([], flash_timed)
    # the dtypes and head dims the attention kernels took last
    integer_rows = check_integer_attention()
    wide_rows = check_wide_attention()
    new_attention_timed = time_new_attention()
    log_new_attention(integer_rows, wide_rows, new_attention_timed)

    quant_rows = check_quantize()
    log(f"kernel quantize_int8 / dequantize_int8: element exact in all {len(quant_rows)} "
        "cases (quantize fp32, bf16 and fp16 in at n = 8192, 8195, 16 Mi and unaligned, "
        "half-steps and clipping, and uint8, int32, bool, int8 and int16 in over their whole "
        "range at scale 2 and max/127; dequantize to fp32, bf16 and fp16 over every int8 "
        "value, at n = 8192, 8195, one below and one above a whole word and a whole grid "
        "step, 16 Mi, input unaligned, and from every other input dtype around its own word "
        "and grid step)")
    norm_rows = check_normalize()
    log(f"kernel normalize_image: element exact in all {len(norm_rows)} cases (fp32, uint8, "
        "bf16, fp16, int32, bool, int8 and int16 in; fp32, bf16 and fp16 out; INCEPTION and "
        "NONE; (224,224,3), (7,13,3), 16 Mi, unaligned, int32 past 2**24; every path one "
        "below and one above a whole vector and a whole grid step)")
    softmax_rows = check_softmax()
    for row in softmax_rows:
        if "max_rel_err" in row:
            log(f"kernel softmax_probabilities {row['shape']} {row['dtype']} "
                f"x{row['scale']} ({row['variant']}, {row['warps']} warps, {row['vectors']} "
                f"vectors): max_rel_err {row['max_rel_err']:.3g} (rtol {row['rtol']})")
        else:
            log(f"kernel softmax_probabilities {row['shape']} {row['case']} "
                f"({row['variant']}): as the plain version, {row['nan_rows']} NaN rows")
    tie_rows = check_ties()
    for row in tie_rows:
        log(f"ties {row['rows']} {row['shape']} k={row['k']}: card as the CPU (indices, "
            f"values and the extension's strings); torch.topk on the card ranks "
            f"{row['torch_topk_rows_in_another_order']} rows in another order")
    topk_timed = time_classification()
    for row in topk_timed:
        log(f"time classification {row['shape']} k={row['k']}: " + "; ".join(
            f"{name} {t['ms']:.4f} ms (quartiles {t['ms_quartiles'][0]:.4f}-"
            f"{t['ms_quartiles'][1]:.4f}; {ms_text(t['device_ms'])} on the device)"
            for name, t in row.items()
            if name in ("sort", "torch_topk", "sort_to_host", "topk_to_host")))
    fallback_rows = check_no_fallback()
    for row in fallback_rows:
        if "raised" in row:
            log(f"no fallback: {row['case']} raised {row['raised']}")
        else:
            log(f"unaligned views: {row['case']}: max_abs_err {row['max_abs_err']:.3g} (tol "
                f"{row['tol']}), {row['launches']} launch")
    small = small_kernel_times()
    quant_timed, norm_timed, softmax_timed = (small["quantize"], small["normalize"],
                                              small["softmax"])
    new_dtype_timed = time_new_element_dtypes()
    for row in new_dtype_timed:
        log(f"time {row['kernel']} {row['shape']} {row['in']} in: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_ms'] / row['ms']:.1%} of bound)")
    breakdown = host_breakdown()
    for piece in breakdown:
        log(f"host normalize_image (224,224,3) uint8: {piece['side']} {piece['piece']}: "
            f"{piece['us']:.3f} us per call (median of {piece['calls']})")

    served, launches = serve_and_check()
    vision, vision_launches = serve_vision(20)
    launches.update(vision_launches)
    grpc_served = serve_grpc(served, vision)
    t_phase = time.perf_counter()
    resilience = serve_resilience(served, vision)
    resilience["seconds"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    harness = serve_harness()
    harness["seconds"] = time.perf_counter() - t_phase
    process = serve_process()
    pool = serve_pool()
    orchestration = serve_orchestration()
    federation = serve_federation()
    mesh = serve_mesh()
    training = serve_training()
    native_result = serve_native(served, grpc_served)
    wide = serve_wide_encoder()
    for row in served["identity"]:
        log(f"identity_fp32 {row['bytes'] // MIB} MiB p50: wire {row['wire_p50_ms']:.3f} ms, "
            f"system shm {row['system_shm_p50_ms']:.3f} ms, "
            f"cuda shm {row['cuda_shm_p50_ms']:.3f} ms")
    prof = served["profile"]
    if prof["device_ms_per_token"] is None:
        log("profile: the profiler recorded no device time (not measured)")
    else:
        log(f"profile decoder_lm in process: {prof['wall_ms_per_token']:.3f} ms/token wall, "
            f"{prof['device_ms_per_token']:.4f} ms/token on the device "
            f"(idle {prof['device_idle_share']:.1%}), decode_attention "
            f"{prof['decode_attention_ms_per_token']:.4f} ms/token; top kernels "
            + ", ".join(f"{k['name'][:40]} {k['total_ms']:.3f} ms/{k['count']}"
                        for k in prof["top_kernels"][:4]))
    dec = served["decoder"]
    req = dec["client_request_ms"]
    log(f"decoder_lm over HTTP per request: {req['total_request']:.3f} ms total, "
        f"{req['send']:.3f} ms send to response headers, {req['receive']:.3f} ms body read")
    log(f"decoder_lm tokens {dec['gpu_tokens']} (cpu {dec['cpu_tokens']}), max logit diff "
        f"{dec['max_abs_logit_diff']:.4g}; tiny_lm_generate {dec['generate_tokens']}; "
        f"decode_attention launches {launches['decode_attention']} = "
        f"{dec['tokens_stepped']} tokens x {dec['layers']} layers")
    bat = served["batched"]
    log(f"decoder_lm_batched over HTTP: {BATCH_SEQS} sequences (prompts of 1-{BATCH_SEQS} "
        f"tokens, {bat['steps']} continuations each) in {bat['seconds']:.3f} s; rounds by "
        f"width {bat['histogram']}; decode_attention launches {bat['launches']} = "
        f"{bat['rounds']} rounds x {bat['layers']} layers; tokens as decoder_lm on the card "
        f"and as the CPU run; max logit diff vs CPU {bat['max_abs_logit_diff_vs_cpu']:.4g}, vs "
        f"decoder_lm on the card {bat['max_abs_logit_diff_vs_card_decoder_lm']:.4g}")
    fs = served["full_slot"]
    log(f"decoder_lm_batched full slot: a sequence at pos == MAX_LEN rode along while "
        f"another decoded {fs['tokens']} (decoder_lm {fs['decoder_lm_tokens']}, max logit diff "
        f"{fs['max_abs_logit_diff']:.4g}); its cache untouched; its next token refused "
        f"({fs['overflow_error']})")
    log(f"decoder_lm_prefill {PREFILL_ROWS}x{PREFILL_LEN}: rows bit-equal to decoder_lm on "
        f"the card; next tokens {served['prefill']['next_tokens']}")
    dg = served["disagg"]
    log(f"disagg: KV ({dg['kv_bytes']} B) in a colocated cuda shm region, on the device and "
        f"equal to the prompt's cache; kv_decode stream {dg['stream']} = tiny_lm_generate")
    log("launches by path: " + json.dumps(served["launches_by_path"]))
    for row in served["batched_timing"]:
        extra = ""
        if "device_ms_per_round" in row:
            extra = ("; profiler: not measured" if row["device_ms_per_round"] is None else
                     f"; {row['device_ms_per_round']:.4f} ms per round on the device (idle "
                     f"{row['device_idle_share']:.1%}), "
                     f"{row['decode_attention_launches_per_round']:g} decode_attention "
                     f"launches ({row['decode_attention_ms_per_round']:.4f} ms) and "
                     f"{row['kernel_launches_per_round']:g} kernels per round")
        log(f"time decoder_lm_batched in process, {row['width']} active: "
            f"{row['wall_ms_per_round']:.4f} ms per round, {row['tokens_per_s']:.1f} tokens/s"
            + extra)
    for row in served["long_context"]:
        log(f"long_context_encoder S={row['seq']} p50: wire {row['wire_p50_ms']:.3f} ms, "
            f"cuda shm {row['cuda_shm_p50_ms']:.3f} ms; max diff vs CPU run "
            f"{row['wire_max_abs_diff_vs_cpu']:.3g} (wire), "
            f"{row['cuda_shm_max_abs_diff_vs_cpu']:.3g} (cuda shm)")
    log(f"long_context_encoder flash_attention launches {launches['flash_attention']} = "
        "requests")
    lc_prof = served["long_context_profile"]
    if lc_prof["device_ms"] is None:
        log("profile long_context_encoder: the profiler recorded no device time (not measured)")
    else:
        log(f"profile long_context_encoder S={lc_prof['seq']} in process: "
            f"{lc_prof['wall_ms']:.3f} ms wall, {lc_prof['device_ms']:.3f} ms on the device "
            f"(idle {lc_prof['device_idle_share']:.1%}), flash_attention "
            f"{lc_prof['flash_attention_ms']:.3f} ms; top kernels "
            + ", ".join(f"{k['name'][:40]} {k['total_ms']:.3f} ms/{k['count']}"
                        for k in lc_prof["top_kernels"][:4]))
    int8 = served["int8"]
    log(f"int8 wire path {int8['shape']}: {int8['wire_bytes']} B on the wire vs "
        f"{int8['fp32_bytes']} B fp32, max error {int8['max_abs_err']:.6f} <= half step "
        f"{int8['bound']:.6f}, round trip p50 {int8['p50_ms']:.3f} ms; launches quantize "
        f"{launches['quantize_int8']}, dequantize {launches['dequantize_int8']} = round trips")
    req = vision["requests"]
    log(f"densenet_onnx width {VISION_WIDTH} / {VISION_CLASSES} classes "
        f"({vision['flops_per_image'] / 1e9:.3f} GFLOP per image) p50: wire "
        f"{vision['wire_p50_ms']:.3f} ms, cuda shm {vision['cuda_shm_p50_ms']:.3f} ms; "
        f"ensemble_image p50 {vision['ensemble_p50_ms']:.3f} ms; max logit diff vs CPU run "
        f"{vision['wire_max_abs_logit_diff_vs_cpu']:.4g} (wire), "
        f"{vision['cuda_shm_max_abs_logit_diff_vs_cpu']:.4g} (cuda shm), "
        f"{vision['ensemble_max_abs_logit_diff_vs_cpu']:.4g} (ensemble); top-3 "
        f"{vision['wire_top3']} (image_client), {vision['ensemble_top3']} (ensemble); "
        f"probabilities sum {vision['probabilities_sum']:.7f}")
    log(f"vision launches: normalize_image {launches['normalize_image']} = "
        f"{req['image_client']} image_client + {req['ensemble_image']} ensemble requests; "
        f"softmax_probabilities {launches['softmax_probabilities']} = {req['softmax_calls']} "
        "calls")
    dn_prof = vision["profile"]
    if dn_prof["device_ms"] is None:
        log("profile densenet_onnx: the profiler recorded no device time (not measured)")
    else:
        log(f"profile densenet_onnx in process: {dn_prof['wall_ms']:.3f} ms wall, "
            f"{dn_prof['device_ms']:.3f} ms on the device (idle "
            f"{dn_prof['device_idle_share']:.1%}), {dn_prof['kernel_launches_per_request']:.0f} "
            "kernels per request; top kernels "
            + ", ".join(f"{k['name'][:40]} {k['total_ms']:.3f} ms/{k['count']}"
                        for k in dn_prof["top_kernels"][:4]))

    # the GRPC phase, beside the HTTP phase's numbers on the same card
    card = smi.strip()
    for grpc_row, http_row in zip(grpc_served["identity"], served["identity"]):
        log(f"grpc identity_fp32 {grpc_row['bytes'] // MIB} MiB p50 (HTTP beside it): wire "
            f"{grpc_row['wire_p50_ms']:.3f} ms ({http_row['wire_p50_ms']:.3f}), system shm "
            f"{grpc_row['system_shm_p50_ms']:.3f} ms ({http_row['system_shm_p50_ms']:.3f}), "
            f"cuda shm {grpc_row['cuda_shm_p50_ms']:.3f} ms "
            f"({http_row['cuda_shm_p50_ms']:.3f}); {card}")
    adm = grpc_served["admin"]
    log(f"grpc admin: live, ready, metadata, config, {adm['repository_models']} models in the "
        f"repository index, unload/load {adm['unloaded_then_ready']}, statistics success "
        f"count {adm['simple_success_count']} = {adm['simple_sent']} simple requests sent")
    gdec = grpc_served["decoder"]
    log(f"grpc decoder_lm over one bidi stream: tokens {gdec['tokens']} = HTTP and CPU; "
        f"{gdec['ms_per_token']:.3f} ms per token (HTTP "
        f"{served['decoder']['client_request_ms']['total_request']:.3f} ms per request); "
        f"decode_attention launches {gdec['launches']} = {gdec['tokens_stepped']} tokens x "
        f"{gdec['layers']} layers; {card}")
    gbat = grpc_served["batched"]
    log(f"grpc decoder_lm_batched over {BATCH_SEQS} concurrent streams in "
        f"{gbat['seconds']:.3f} s (HTTP {served['batched']['seconds']:.3f} s); rounds by width "
        f"{gbat['histogram']}; decode_attention launches {gbat['launches']} = "
        f"{gbat['rounds']} rounds x {gbat['layers']} layers; tokens as decoder_lm on the "
        f"card; {card}")
    gimg = grpc_served["image_client"]
    log(f"grpc image_client (cuda shm in and out, normalize and softmax on the card) p50 "
        f"{gimg['cuda_shm_p50_ms']:.3f} ms (HTTP {vision['cuda_shm_p50_ms']:.3f}); top-1 "
        f"{gimg['top1']} = CPU {gimg['cpu_top1']}, max logit diff "
        f"{gimg['max_abs_logit_diff_vs_cpu']:.4g}; launches normalize_image "
        f"{grpc_served['launch_counts']['image_client']['normalize_image']} = "
        f"{gimg['requests']} requests, softmax_probabilities "
        f"{grpc_served['launch_counts']['image_client']['softmax_probabilities']} = "
        f"{gimg['softmax_calls']} calls; {card}")
    for name, row in grpc_served["aio"].items():
        log(f"{name}: {row['requests']} requests (simple, identity_fp32 over cuda shm) "
            f"through asyncio.gather in {row['seconds']:.3f} s; outputs as expected and "
            f"equal across the two aio clients; {card}")
    grpc_counts = grpc_served["launch_counts"]

    # the resilience phase, with the card's name and power limit on each line
    log(f"resilience phase: {resilience['seconds']:.1f} s")
    for name in ("image_client under flap", "image_client under reset@N"):
        row = resilience[name]
        log(f"resilience {name}: {row['requests']} requests, {row['errors']} errors, policy "
            f"{row['policy']}, {row['faulted_connections']} faulted connections, "
            f"{row['server_executions']} densenet_onnx executions; top-1 {row['top1'][0]} = "
            f"CPU {row['cpu_top1']}, max logit diff {row['max_abs_logit_diff_vs_cpu']:.4g}; "
            f"{card}")
    row = resilience["decoder_lm under reset@N"]
    log(f"resilience decoder_lm sequence under reset@N: tokens before the fault "
        f"{row['tokens_before_fault']} = CPU; the faulted request ({row['fault_domain']}) "
        f"made {row['faulted_call_attempts']} attempt (never re-sent); "
        f"{row['server_executions']} executions of {row['requests_sent']} requests sent")
    row = resilience["grpc stream auto_reconnect"]
    log(f"resilience grpc stream auto_reconnect: {row['reconnects']} StreamReconnected, "
        f"abandoned {row['abandoned_request_ids']}, re-sent {row['resent_request_ids']}; "
        f"re-driven tokens {row['tokens']} = CPU; {row['server_executions']} executions; "
        f"StreamChecker events per wire stream {row['stream_checker_events']}")
    row = resilience["breaker"]
    log(f"resilience breaker under blackhole: {row['state_after_faults']} after 4 "
        f"timeouts, transitions {row['transitions']}, fast-fail opened "
        f"{row['fast_fail_connections']} connections, policy {row['policy']}")
    row = resilience["flight"]
    log(f"flight recorder: retained {row['retained']} for {row['failures_seen']} failures "
        f"seen by the caller")
    for name, row in resilience["split"].items():
        phases = ", ".join(f"{k} {v:.3f}" for k, v in row["client_ms_p50"].items())
        log(f"round trip {name} ({row['requests']} requests, p50 ms): client {phases}, "
            f"total {row['client_total_ms_p50']:.3f}; server queue "
            f"{row['server_queue_ms_p50']:.3f}, compute {row['server_compute_ms_p50']:.3f}, "
            f"total {row['server_total_ms_p50']:.3f}; {card}")
    prof_row = resilience["split"]["image_client cuda shm"]["profiled_request"]
    log(f"one image_client request (cuda shm): server compute_ns "
        f"{prof_row['server_compute_ms']:.3f} ms (host time of model.execute), server total "
        f"{prof_row['server_total_ms']:.3f} ms, device time (profiler, all device activity) "
        f"{ms_text(prof_row['device_ms'])}, client {prof_row['client_total_ms']:.3f} ms; "
        f"{card}")
    hooks = resilience["hooks"]
    log(f"hooks' host cost ({HOOK_ROUNDS} interleaved rounds, medians): identity_fp32 4 MiB "
        f"cuda shm p50 {hooks['median']['bare']['identity_p50_ms']:.4f} ms bare, "
        f"{hooks['median']['hooked']['identity_p50_ms']:.4f} ms with telemetry, resilience "
        f"and integrity (+{hooks['difference']['identity_p50_ms']:.4f}); decoder_lm "
        f"{hooks['median']['bare']['decoder_ms_per_token']:.4f} ms per token bare, "
        f"{hooks['median']['hooked']['decoder_ms_per_token']:.4f} hooked "
        f"(+{hooks['difference']['decoder_ms_per_token']:.4f}); {card}")
    row = resilience["integrity"]
    log(f"integrity: {row['results']} results, {row['checks']} checks, {row['violations']} "
        f"violations; overhead p50 {row['overhead_ns']['p50']:.0f} ns, p99 "
        f"{row['overhead_ns']['p99']:.0f} ns per result; {card}")
    log("metrics: /metrics counts = the statistics: " + json.dumps(
        resilience["metrics"]["models"]))
    row = resilience["dataplane"]
    log(f"dataplane cuda: {row['cuda']} = {row['made']['created']} creates, "
        f"{row['made']['registered']} registers, {row['made']['destroyed']} destroys, peak "
        f"{row['made']['peak']} B, {row['made']['requests']} requests x 2 map writes and reads")
    log("resilience launches by path: " + json.dumps(resilience["launch_counts"]))
    res_counts = resilience["launch_counts"]

    def resilience_launches(kernel):
        return {path: row[kernel] for path, row in res_counts.items() if row[kernel]}

    # the harness phase: each row's rate and latency, with the card's name
    log(f"harness phase: {harness['seconds']:.1f} s")
    for name, entry in harness["perf"].items():
        for row in entry["rows"]:
            lm = row["latency_ms"]
            if "concurrency" in row:
                level, rate = f"concurrency {row['concurrency']}", row["infer_per_sec"]
            elif "request_rate" in row:
                level = f"{row['distribution']} rate {row['request_rate']:.1f}/s"
                rate = row["achieved_rate"]
            else:
                level = f"{row['trace']['records']} records {row['trace']['kinds']}"
                rate = row["achieved_rate"]
            shm = row.get("client_shm")
            extra = ("" if shm is None else
                     f"; {shm['regions_created']} regions created, arena hit rate "
                     f"{shm['arena']['hit_rate']}, {shm['arena']['registrations_issued']} "
                     "registrations issued")
            log(f"perf {name} {level}: {row['requests']} requests, {row['errors']} errors, "
                f"{rate} infer/s, p50 {lm['p50']} ms, p99 {lm['p99']} ms{extra}; {card}")
    for path, entry in harness["genai"].items():
        row = entry["row"]
        log(f"genai {path}: {row['sessions']} sessions, {entry['tokens']} tokens, "
            f"{row['errors']} errors; ttft p50 {row['ttft_ms']['p50']} ms p99 "
            f"{row['ttft_ms']['p99']} ms, inter-token p50 {row['inter_token_ms']['p50']} ms "
            f"p99 {row['inter_token_ms']['p99']} ms, {row['output_tokens_per_sec']} tokens/s; "
            f"{card}")
    log("harness dataplane after the arenas closed: " + json.dumps(harness["dataplane"]))
    log("harness launches by path: " + json.dumps(harness["launch_counts"]))
    harness_counts = harness["launch_counts"]

    def harness_launches(kernel):
        return {path: row[kernel] for path, row in harness_counts.items() if row[kernel]}

    # phase 8: the standalone server in processes of its own
    log(f"process phase: {process['seconds']:.1f} s (serve ready after "
        + ", ".join(f"{k} {v:.1f} s" for k, v in process["startup_s"].items())
        + f"); serve {' '.join(SERVE_ARGS)}")
    pc = process["correctness"]["threaded"]
    log(f"process correctness (threaded child, this process the client): simple, identity_fp32 "
        f"at {[n // MIB for n in PROCESS.identity_bytes]} MiB over the wire, system shm and cuda "
        f"shm (colocated=False) over HTTP and GRPC; decoder_lm tokens {pc['decoder']['http_tokens']} "
        f"(generate route) = {pc['decoder']['grpc_tokens']} (GRPC stream) = CPU, max logit diff "
        f"{pc['decoder']['max_abs_logit_diff']:.4g}; long_context_encoder S={PROCESS.seq} over "
        f"cuda shm max diff {pc['encoder_max_abs_diff_vs_cpu']:.3g}; ensemble_image top-1 "
        f"{pc['top1']} = CPU, max logit diff "
        f"{pc['ensemble_max_abs_logit_diff_vs_cpu_http']:.4g} (HTTP), "
        f"{pc['ensemble_max_abs_logit_diff_vs_cpu_grpc']:.4g} (GRPC); int8 round trips "
        f"{pc['int8_round_trips']} (max error {pc['int8']['max_abs_err']:.6f})")
    in_process = harness["perf"]
    for frontend, rows in process["load"].items():
        for name, entry in rows.items():
            beside = {"identity_fp32 cuda": "identity_fp32 cuda",
                      "identity_fp32 none": "identity_fp32 none",
                      "ensemble_image cuda": "ensemble_image cuda",
                      "long_context_encoder cuda": f"long_context_encoder S={HARNESS.seq} cuda"}
            phase7 = {r["concurrency"]: r for r in in_process[beside[name]]["rows"]}
            for row in entry["rows"]:
                lm = row["latency_ms"]
                near = phase7.get(row["concurrency"])
                extra = ("" if near is None else
                         f" (phase 7 in process: {near['infer_per_sec']} infer/s, p50 "
                         f"{near['latency_ms']['p50']} ms)")
                log(f"process perf {frontend} {name} concurrency {row['concurrency']}: "
                    f"{row['requests']} requests, {row['errors']} errors, {row['infer_per_sec']} "
                    f"infer/s, p50 {lm['p50']} ms, p99 {lm['p99']} ms{extra}; {card}")
    for row in process["perf_cli"]["rows"]:
        log(f"process perf CLI (third process) identity_fp32 cuda concurrency "
            f"{row['concurrency']}: {row['requests']} requests, {row['errors']} errors, "
            f"{row['infer_per_sec']} infer/s, p50 {row['latency_ms']['p50']} ms; {card}")
    row = process["genai"]["row"]
    log(f"process genai decoder_lm_batched over GRPC (aio child): {row['sessions']} sessions, "
        f"{process['genai']['tokens']} tokens, {row['errors']} errors, ttft p50 "
        f"{row['ttft_ms']['p50']} ms, inter-token p50 {row['inter_token_ms']['p50']} ms, "
        f"{row['output_tokens_per_sec']} tokens/s; {card}")
    dr = process["drain"]
    log(f"process drain under load (aio child, {DRAIN_THREADS} clients): ready 503 "
        f"{dr['ready_503_ms']:.1f} ms after SIGTERM, live {dr['live_status']}, /metrics ready 0 "
        f"{dr['metrics_ready_0']}, GRPC ServerReady {dr['grpc_ready']} (checks done "
        f"{dr['checks_done_ms']:.1f} ms); requests {dr['requests']}, 0 errors; exit 0 after "
        f"{dr['exit_s']:.2f} s")
    log("process launches: " + json.dumps(process["launch_counts"]) + " = expected "
        + json.dumps(process["expected_launches"]) + "; children on "
        + ", ".join(f"{k} {r['device']}" for k, r in process["reports"].items()))
    process_counts = process["launch_counts"]

    def process_launches(kernel):
        return {path: row[kernel] for path, row in process_counts.items() if row[kernel]}

    # phase 9: the routing and serving layers over two serve children
    log(f"pool phase: {pool['seconds']:.1f} s (children ready after "
        f"{pool['steps_s']['children ready']:.1f} s); rows "
        + ", ".join(f"{k} {v:.2f} s" for k, v in pool["steps_s"].items()))
    pr = pool["rows"]
    log(f"pool round robin (HTTP): {pr['round robin']['requests']} ensemble_image requests, "
        f"executions by child {pr['round robin']['executions']}, top-1 = CPU; "
        f"sequence: decoder_lm executions {pr['sequence']['executions']} (pinned), tokens "
        f"{pr['sequence']['tokens']} = CPU, max logit diff "
        f"{pr['sequence']['max_abs_logit_diff']:.4g}; affinity: "
        f"{json.dumps(pr['affinity']['keys'])}; hedge (delay 0): "
        f"{pr['hedge']['requests']} requests, executions {pr['hedge']['executions']}")
    sf, co, te = pr["singleflight"], pr["coalescing"], pr["tenancy"]
    log(f"pool caching: {sf['threads']} threads -> {sf['wire_requests']} wire request, "
        f"{sf['singleflight_collapsed']} collapsed, then {sf['hits']} hits, executions "
        f"{sf['executions']}; coalescing: {co['rows']} rows -> {co['dispatches']} dispatches, "
        f"executions {co['executions']}, max diff vs solo {co['max_abs_diff_vs_solo']:.3g}; "
        f"tenancy {POOL_TENANCY!r}: {json.dumps(te['verdicts'])}, min retry_after "
        f"{te['retry_after_s_min']:.3f} s, executions {te['executions']}; aio GRPC: "
        f"{pr['aio grpc']['requests']} requests, executions {pr['aio grpc']['executions']}")
    for name, levels in pr["perf"].items():
        for r in levels:
            lm = r["latency_ms"]
            log(f"pool perf long_context_encoder S={POOL.seq} wire {name} concurrency "
                f"{r['concurrency']}: {r['requests']} requests, {r['errors']} errors, "
                f"{r['infer_per_sec']} infer/s, p50 {lm['p50']} ms, p99 {lm['p99']} ms; {card}")
    fo = pr["failover"]
    log(f"pool failover under drain: {POOL.failover_workers} workers, unhealthy after "
        f"{fo['unhealthy_ms']:.1f} ms, requests {fo['requests']}, 0 errors, "
        f"{fo['health_changes']} health change, drained child exit 0 after "
        f"{fo['exit_s']:.2f} s, calls on it after its exit {fo['calls_on_drained_after_exit']}")
    log("pool launches by child: " + json.dumps(pool["launch_counts"]) + " = expected "
        + json.dumps(pool["expected_launches"]))

    def pool_launches(kernel):
        return [row[kernel] for row in pool["launch_counts"]]

    orch = orchestration["rows"]
    log(f"orchestration phase: {orchestration['seconds']:.1f} s (children ready after "
        f"{orchestration['steps_s']['children ready']:.1f} s); rows "
        + ", ".join(f"{k} {v:.2f} s" for k, v in orchestration["steps_s"].items()) + f"; {card}")
    dg = orch["disagg"]
    log(f"orchestration disagg (prefill child 1, decode child 2, V=256 D=128 H=4 L=2 "
        f"MAX_LEN=128): {len(dg['sessions'])} prompts of {ORCH.prompt_len} tokens x "
        f"{ORCH.max_tokens} tokens = tiny_lm_generate on child 1, near ties vs the CPU run "
        f"{dg['near_ties']}; session ms "
        + ", ".join(f"{s['ms']:.1f}" for s in dg["sessions"])
        + f"; steady state {dg['steady_region_creates']} region creates, "
        f"{dg['steady_registrations']} registrations (family {dg['family']}); aio equal; "
        f"tampered slab -> HandoffCorrupt({dg['tampered']['field']}), a tampered session "
        f"{dg['tampered_session']['tokens_before']} tokens before the refusal; {card}")
    rc = orch["recovery"]
    log(f"orchestration recovery: decode legs {rc['decode_legs']} (the victim SIGKILLed after "
        f"{ORCH.kill_after} tokens), resumed on {rc['resumed_on']}, every index once, tokens "
        f"= monolithic; lone decode replica killed -> DecodeAbandoned {rc['abandoned']}")
    sh = orch["shard"]
    log(f"orchestration shard: decoder_lm_prefill {sh['decoder_lm_prefill']['rows']} rows over "
        f"{sh['decoder_lm_prefill']['bounds']} bit-equal to the per-shard calls, vs one call "
        f"{sh['decoder_lm_prefill']['max_abs_diff_vs_one_call']}; batched_matmul "
        f"{sh['batched_matmul']['max_abs_diff_vs_one_call']}; a SIGKILLed shard -> "
        f"ShardFailed {sh['killed_shard']}")
    pl = orch["pipeline"]
    log(f"orchestration pipeline: chain over two children x {len(pl['runs'])} runs = "
        f"chain_fused, run ms " + ", ".join(f"{r['ms']:.2f}" for r in pl["runs"])
        + f", high water {pl['high_water_bytes']} B = peak residency, steady state "
        f"{pl['steady_region_creates']} creates / {pl['steady_registrations']} registrations; "
        f"vision pipeline top-1 {pl['vision']['top1']} = CPU {pl['vision']['cpu_top1']}, max "
        f"logit diff vs CPU {pl['vision']['max_abs_logit_diff_vs_cpu']:.4g}, vs ensemble_image "
        f"on the child {pl['vision']['max_abs_diff_vs_ensemble_image']:.4g}; {card}")
    for name, hrow in orch["harness"].items():
        log(f"orchestration harness {name}: children successes {hrow['children_successes']}; "
            + json.dumps(hrow["rows"]) + f"; {card}")
    log("orchestration launches by child: " + json.dumps(orchestration["launch_counts"])
        + " = expected " + json.dumps(orchestration["expected_launches"]))

    def orchestration_launches(kernel):
        return [row[kernel] for row in orchestration["launch_counts"]]

    fed = federation["rows"]
    log(f"federation phase: {federation['seconds']:.1f} s (children ready after "
        f"{federation['steps_s']['children ready']:.1f} s); rows "
        + ", ".join(f"{k} {v:.2f} s" for k, v in federation["steps_s"].items()) + f"; {card}")
    sp = fed["spill"]
    log(f"federation home: {fed['home']['executions']} encoder executions by child, "
        f"{fed['home']['spills']} spills; spill: {sp['spills']} of {sp['requests']} spilled "
        f"{sp['reasons']}, child 3 ran {sp['executions'][2]}, home again after "
        f"{sp['requests_to_return_home']} requests / {sp['return_home_s']:.3f} s of the heal; "
        f"{card}")
    sq = fed["sequence"]
    log(f"federation sequence: tokens {sq['tokens']} (CPU {sq['cpu_tokens']}, near tie "
        f"{sq['near_tie']}), abandoned {sq['abandoned']}, decoder_lm executions "
        f"{sq['executions']}")
    cn = fed["canary"]
    log(f"federation shadow: {fed['shadow']['status']}; canary: rolled back after "
        f"{cn['faulted_requests']} faulted requests / {cn['rollback_s']:.3f} s (burn "
        f"{cn['burn_rate']}), executions after {cn['executions_after']}; {card}")
    bz = fed["byzantine"]
    log(f"federation byzantine: {bz['returned']} returned (0 corrupt, max err "
        f"{bz['max_abs_err']}), faults {bz['faults']}, liar pool {bz['liar']['pool']}, "
        f"spills {bz['spill_reasons']}, byzantine core executions {bz['byzantine_executions']}")
    wt = fed["watch"]
    log(f"federation watch: {wt['named']['kind']} named {wt['faulted_url']} after "
        f"{wt['detect_requests']} requests / {wt['detect_s']:.3f} s ({wt['batches']} batches, "
        f"{wt['burn_wait_batches']} of them waiting on the burn alert's divergence), ring "
        f"{wt['ring_records']}, "
        f"doctor --blackbox {wt['doctor_blackbox_s']:.2f} s; {card}")
    dr = fed["doctor"]
    log(f"federation doctor: cells {dr['cells']} exit {dr['healthy_exit']} in "
        f"{dr['healthy_s']:.2f} s; after SIGKILL exit {dr['killed_exit']} in "
        f"{dr['killed_s']:.2f} s, anomalies {dr['killed_anomalies']}")
    log("federation harness: " + json.dumps(fed["harness"]["rows"]) + f"; {card}")
    log("federation launches by child: " + json.dumps(federation["launch_counts"])
        + " = expected " + json.dumps(federation["expected_launches"]))

    def federation_launches(kernel):
        return [row[kernel] for row in federation["launch_counts"]]

    log_mesh(mesh, card)
    log_training(training, card)
    log_native(native_result, card)
    log_wide(wide, card)

    def native_launches(kernel):
        """Phase 14's launches of ``kernel`` by path."""
        return {path: counts[kernel] for path, counts in native_result["launch_counts"].items()}

    main_row = timed[0]
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_attention.py:121",
        "launches": launches["decode_attention"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        # device time alone per launch on the served decode step (profiler);
        # "ms" above is a wrapper call back to back, host launch cost included
        "device_ms": served["profile"]["decode_attention_ms_per_launch"],
        "redesigned": REDESIGNED["decode_attention"],
        "host_us": small["attention_host_us"]["decode_attention"],
        "shape": main_row["shape"],
        "pos": main_row["pos"],
        "splits": main_row["splits"],
        "at_shapes": timed[1:],
        # launches is the decoder path's; every decoder-family path's here
        "launches_by_path": served["launches_by_path"],
        "grpc_launches_by_path": {
            "decoder": grpc_counts["decoder"]["decode_attention"],
            "decoder_lm_batched": grpc_counts["decoder_lm_batched"]["decode_attention"]},
        "resilience_launches_by_path": resilience_launches("decode_attention"),
        "harness_launches_by_path": harness_launches("decode_attention"),
        "process_launches": process_launches("decode_attention"),
        "pool_launches": pool_launches("decode_attention"),
        "orchestration_launches": orchestration_launches("decode_attention"),
        "federation_launches": federation_launches("decode_attention"),
        # decoder_lm_tp's sequential run by mesh size: tokens x layers x shards
        "mesh_launches": mesh["launches"],
        # the dry run of phase 13: its served tp decode and that decode's
        # single-device reference (fed tokens x layers x shards, and x 1)
        "training_launches": training["rows"]["dryrun"]["result"]["decode_attention_launches"],
        # phase 14: the embedded server's decode and the native gRPC stream's
        "native_launches": native_launches("decode_attention"),
        "batched_shape": batched_timed,
        # the cases the kernel took last: integer and bool caches (the
        # tiled kernel, element-exact but where l's order explains a
        # mismatch) and head dims past 256 (their times: new_attention_timed
        # in build/chip_smoke.json)
        "new_cases": new_cases("decode", integer_rows, wide_rows),
    }]
    flash_row = flash_timed[0]
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/flash_attention.cu",
        "replaces": "client_tpu/ops/flash_attention.py:142",
        "launches": launches["flash_attention"],
        "max_abs_err": flash_row["max_abs_err"],
        "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
        "redesigned": REDESIGNED["flash_attention"],
        "host_us": small["attention_host_us"]["flash_attention"],
        "harness_launches_by_path": harness_launches("flash_attention"),
        "process_launches": process_launches("flash_attention"),
        "pool_launches": pool_launches("flash_attention"),
        "orchestration_launches": orchestration_launches("flash_attention"),
        "federation_launches": federation_launches("flash_attention"),
        "native_launches": native_launches("flash_attention"),
        # phase 15: the encoder at Phi-3-mini's and Gemma-2B's widths
        "wide_launches": {row["width"]: {plane: row[plane]["launches"]["flash_attention"]
                                         for plane in ("cuda_shm", "wire")}
                          for row in wide["rows"]},
        "shape": flash_row["shape"],
        "dtype": flash_row["dtype"],
        "at_shapes": flash_timed[1:],
        # the fp32 kernel for head dims 33-256 (3xTF32 on the tensor cores):
        # its rows at the shapes phase 3 times it at, with the fp32 FMA bound
        # beside the 3xTF32 one, and its launches on phase 15's published
        # widths (head dims 96 and 256), both planes
        "tf32_kernel": {
            "redesigned": "3xTF32 on the tensor cores (mma.sync m16n8k8), K and V by cp.async",
            "launches": sum(row[plane]["launches"]["flash_attention"] for row in wide["rows"]
                            if row["width"] in ("phi3_mini", "gemma_2b")
                            for plane in ("cuda_shm", "wire")),
            "rows": [row for row in flash_timed
                     if runs_3xtf32(row["shape"][3], row["dtype"])],
        },
        "new_cases": new_cases("flash", integer_rows, wide_rows),
    })
    wire_row = quant_timed[0]
    for name, replaces, note in (
            ("quantize_int8", "client_tpu/ops/__init__.py:170",
             "library_ms is torch.quantize_per_tensor(x, scale, 0, torch.qint8) where its "
             "int_repr() gave the kernel's int8 values on the timed input and on the int8 "
             "wire path's input, else null with library_mismatches (and _wire) the count "
             "of values that differ and library_mismatch_at (kernel, library, x / scale) "
             "where"),
            ("dequantize_int8", "client_tpu/ops/__init__.py:183",
             "library_ms is q * scale (int8 times a Python float gives float32)")):
        t = wire_row[name.split("_")[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "client_tpu_torch/csrc/quantize_int8.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "library_note": note,
            **{key: t[key] for key in ("library_mismatches", "library_mismatches_wire",
                                       "library_mismatch_at", "library_candidate_ms",
                                       "library_device_ms", "host_us", "library_host_us")
               if key in t},
            # device time alone per launch (profiler); "ms" is a wrapper call
            # back to back, host launch cost included
            "device_ms": t["device_ms"],
            **({"redesigned": REDESIGNED[name]} if name in REDESIGNED else {}),
            "process_launches": process_launches(name),
            "pool_launches": pool_launches(name),
            "orchestration_launches": orchestration_launches(name),
            "federation_launches": federation_launches(name),
            "n": wire_row["n"],
            "at_shapes": [{"n": row["n"], **row[name.split("_")[0]]}
                          for row in quant_timed[1:]]
            + ([small["dequantize_bf16"]] if name == "dequantize_int8" else []),
        })
    for name, source, replaces, timed_rows, note in (
            ("normalize_image", "normalize_image.cu", "client_tpu/ops/__init__.py:44",
             norm_timed,
             "library_ms is torch.add(shift, x, alpha=scale) (a 0-dim fp32 shift; fp32 or "
             "uint8 x) where it gave the kernel's bits, else null with library_mismatches "
             "the count of elements whose bits differ"),
            ("softmax_probabilities", "softmax.cu", "client_tpu/ops/__init__.py:138",
             softmax_timed, "library_ms is torch.softmax(x, -1, dtype=torch.float32)")):
        row = timed_rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"client_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_note": note,
            **{key: row[key] for key in ("library_mismatches", "library_device_ms",
                                         "host_us", "library_host_us") if key in row},
            "device_ms": row["device_ms"],
            "redesigned": REDESIGNED[name],
            "grpc_launches": grpc_counts["image_client"][name],
            "resilience_launches_by_path": resilience_launches(name),
            "harness_launches_by_path": harness_launches(name),
            "process_launches": process_launches(name),
            "pool_launches": pool_launches(name),
            "orchestration_launches": orchestration_launches(name),
            "federation_launches": federation_launches(name),
            "native_launches": native_launches(name),
            "shape": row["shape"],
            "at_shapes": timed_rows[1:],
        })
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_seconds": seconds, "ptxas": ptxas,
                   "checks": rows, "worst_err": worst, "timed": timed,
                   "batched_timed": batched_timed,
                   "flash_checks": flash_rows, "flash_timed": flash_timed,
                   "integer_attention_checks": integer_rows,
                   "wide_attention_checks": wide_rows,
                   "new_attention_timed": new_attention_timed,
                   "quantize_checks": quant_rows, "quantize_timed": quant_timed,
                   "new_dtype_timed": new_dtype_timed,
                   "dequantize_bf16_timed": small["dequantize_bf16"],
                   "tie_checks": tie_rows, "classification_timed": topk_timed,
                   "no_fallback_checks": fallback_rows,
                   "normalize_checks": norm_rows, "normalize_timed": norm_timed,
                   "softmax_checks": softmax_rows, "softmax_timed": softmax_timed,
                   "attention_host_us": small["attention_host_us"],
                   "host_breakdown": breakdown,
                   "served": served, "vision": vision, "grpc": grpc_served,
                   "resilience": resilience, "harness": harness, "process": process,
                   "pool": pool, "orchestration": orchestration, "federation": federation,
                   "mesh": mesh, "training": training, "native": native_result,
                   "wide": wide,
                   "kernels": kernels}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
