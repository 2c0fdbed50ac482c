"""Perf harness: the framework's perf_analyzer equivalent.

The port of ``client_tpu.perf``: a load generator with perf_analyzer's core
controls — concurrency sweep, infer/sec, p50/p90/p99 latency, and a
``--shared-memory={none,system,cuda}`` data-plane switch (the JAX package's
``tpu`` mode is ``cuda`` here). Beside the closed loop it runs the open
loop at a fixed arrival rate (``--request-rate-range``, constant or
poisson) and the replay of a seeded workload trace (``--trace`` /
``--trace-gen``, ``client_tpu_torch.trace``) against one endpoint, with
``--generate-stream``, ``--observe``, ``--flight``, ``--validate``,
``--chaos`` and ``--retries``, and the routing and serving layers: a
replica pool over ``--endpoints`` (``--routing``, ``--hedge``,
``--affinity-key``, ``--endpoint-limits``, ``--admission`` with
``--tenancy``; ``client_tpu_torch.pool``), the coalescing dispatcher
(``--coalesce``, ``client_tpu_torch.batch``) and the hot-key layer
(``--cache``, ``--singleflight``, ``client_tpu_torch.cache``), and the
orchestration layers: sharded scatter-gather over the pool
(``--shard-layout``, ``client_tpu_torch.shard``), and the replay of
``prefill_decode`` records through a role-labeled ``DisaggClient``
(``--roles``, ``client_tpu_torch.disagg``) and of ``pipeline`` records
through a ``PipelineClient`` (``--pipeline``, ``client_tpu_torch.pipeline``).
The result rows carry the JAX package's keys.

Usage::

    python -m client_tpu_torch.perf -m simple -u 127.0.0.1:8000 -i http \\
        --concurrency-range 1:4 --shared-memory cuda --measurement-requests 200

Inputs are generated from the model's metadata (random data per datatype;
dynamic dims default to 1, override with ``--shape NAME:d1,d2``). The
cuda mode stages each input on ``--device`` (default ``cuda``) and leases
it into a cuda shm slab of the runner's arena (``client_tpu_torch.arena``).
A ``PerfRunner`` leases colocated slabs by default: a server in its process
receives the tensor itself and the host window is never written. The CLI's
server is another process, so the CLI leases slabs that mirror each input
into the host window, which that server reads (no CUDA IPC).

It also runs the federation over named cells (``--cells``,
``--home-cell``, ``--shadow-cell``, ``--canary-cell``;
``client_tpu_torch.federation``) and the continuous monitor
(``--watch``, ``client_tpu_torch.watch``). The native protocols drive
the C++ clients through ``client_tpu_torch.native`` (built from source at
first use): ``-i native`` (HTTP), ``-i native-grpc`` (one client a worker)
and ``-i native-grpc-async`` (one client, every worker's RPCs in flight
on its one connection); the first two take ``--shared-memory none|cuda``,
the async one ``none``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils import sorted_percentile as _percentile

PROTOCOLS = ("http", "grpc", "native", "native-grpc", "native-grpc-async")


def _random_tensor(datatype: str, shape: List[int], rng) -> np.ndarray:
    from .utils import triton_to_np_dtype

    if datatype == "BYTES":
        flat = int(np.prod(shape))
        return np.array(
            [str(rng.integers(0, 100)).encode() for _ in range(flat)], dtype=np.object_
        ).reshape(shape)
    np_dtype = np.dtype(triton_to_np_dtype(datatype))
    if np_dtype.kind in "iu":
        return rng.integers(0, 100, size=shape).astype(np_dtype)
    return rng.standard_normal(shape).astype(np_dtype)


def _latency_ms_row(lat_sorted: List[float]) -> Dict[str, float]:
    """The avg/p50/p90/p99 row every result dict carries, from an
    ALREADY-SORTED list of latencies in seconds."""
    n = len(lat_sorted)
    return {
        "avg": round(1000 * sum(lat_sorted) / n, 3) if n else 0.0,
        "p50": round(1000 * _percentile(lat_sorted, 0.50), 3),
        "p90": round(1000 * _percentile(lat_sorted, 0.90), 3),
        "p99": round(1000 * _percentile(lat_sorted, 0.99), 3),
    }


def _lag_ms_row(lag_sorted: List[float]) -> Dict[str, float]:
    """The schedule-slip row shared by the open-loop and trace-replay
    results, from an ALREADY-SORTED list of lags in seconds."""
    return {
        "p50": round(1000 * _percentile(lag_sorted, 0.50), 3),
        "p99": round(1000 * _percentile(lag_sorted, 0.99), 3),
        "max": round(1000 * lag_sorted[-1], 3) if lag_sorted else 0.0,
    }


def _parse_chaos_fault(spec: str):
    """``--chaos`` spec -> a testing.chaos.Fault (None = clean proxy)."""
    from .testing.chaos import Fault

    if spec in ("", "none"):
        return None
    kind, _, arg = spec.partition(":")
    if kind == "latency":
        return Fault("latency", latency_s=float(arg or 0.001))
    if kind == "reset":
        return Fault("reset", after_bytes=int(arg or 0))
    if kind == "stall":
        return Fault("stall", after_bytes=int(arg or 0))
    if kind == "flap":
        return Fault("flap", every=int(arg or 2))
    if kind == "blackhole":
        return Fault("blackhole")
    raise ValueError(
        f"unknown --chaos spec {spec!r} "
        "(none|latency:S|reset:N|stall:N|flap:K|blackhole)")


class PerfRunner:
    """Drives one (concurrency, shared-memory-mode) measurement."""

    def __init__(
        self,
        url: str,
        protocol: str = "http",
        model_name: str = "simple",
        shared_memory: str = "none",
        shape_overrides: Optional[Dict[str, List[int]]] = None,
        batch_size: int = 0,
        seed: int = 0,
        retries: int = 0,
        chaos: Optional[str] = None,
        endpoints: Optional[List[str]] = None,
        hedge: bool = False,
        hedge_delay_s: Optional[float] = None,
        observe: bool = False,
        observe_sample: str = "always",
        generate_stream: bool = False,
        stream_prompt_tokens: int = 32,
        stream_output_tokens: int = 16,
        coalesce: bool = False,
        batch_window_us: Optional[float] = None,
        batch_max: int = 32,
        routing: Optional[str] = None,
        admission: bool = False,
        admission_mode: str = "aimd",
        admission_target_ms: Optional[float] = None,
        admission_max_queue_wait_s: float = 0.05,
        tenancy: Optional[str] = None,
        endpoint_limits: bool = False,
        shard_layout=None,
        cache: bool = False,
        cache_ttl_s: float = 30.0,
        singleflight: bool = False,
        affinity_key: Optional[str] = None,
        flight: bool = False,
        cells: Optional[Dict[str, List[str]]] = None,
        home_cell: Optional[str] = None,
        shadow_cell: Optional[str] = None,
        shadow_ratio: float = 0.05,
        canary_cell: Optional[str] = None,
        canary_weight: float = 0.1,
        canary_slo: Optional[str] = None,
        canary_min_events: int = 20,
        cells_deadline_s: Optional[float] = 5.0,
        cells_attempt_timeout_s: Optional[float] = None,
        roles=None,
        pipeline=None,
        validate: bool = False,
        watch: bool = False,
        device="cuda",
        colocated: bool = True,
    ):
        """The JAX runner's signature, plus ``device`` (where the cuda mode
        stages its inputs: ``"cuda"``, a ``torch.device``, or ``"cpu"`` for
        CPU-only runs) and ``colocated``: the cuda mode's slabs skip the
        host window, so only a server in this process sees their bytes.
        Pass False for a server in another process, which reads the window
        (the CLI does).

        ``retries``: arm a resilience policy (RetryPolicy with
        ``retries``+1 attempts) on every measurement client — benchmarks
        the pay-for-what-you-use overhead of the policy path. ``chaos``:
        route measurement traffic through an in-process fault-injection
        proxy (``client_tpu_torch.testing.chaos``); spec is ``none`` (proxy
        only), ``latency:S``, ``reset:N``, ``stall:N``, ``flap:K`` or
        ``blackhole``. Control/probe traffic always goes direct.
        ``observe``: arm a fresh ``observe.Telemetry`` (sample=always) on
        every measurement run and append a client-phase p50/p99 breakdown
        (serialize/send/ttfb/recv/deserialize) to each result row.
        ``flight``: attach a flight recorder to every measurement run.
        ``validate``: append the run's contract-validation delta.
        ``endpoints``: N replica urls — measurement clients become
        health-aware ``PoolClient``s (``client_tpu_torch.pool``) over them;
        ``url`` stays the control-plane address. ``hedge`` arms hedged
        requests on the pool (``hedge_delay_s`` pins the hedge delay;
        default is the rolling p95). ``routing``, ``affinity_key``,
        ``endpoint_limits`` and ``admission`` (with ``tenancy``, a
        ``parse_tenancy_spec`` string) configure that pool.
        ``coalesce``: wrap every measurement client in the micro-batching
        dispatcher (``client_tpu_torch.batch.BatchingClient``) so
        concurrent workers share coalesced wire requests;
        ``batch_window_us`` pins the coalescing window (default:
        adaptive) and ``batch_max`` bounds the stacked batch dimension.
        Each result row then carries a ``client_batch`` block with
        achieved batch-size p50/p99. ``cache`` / ``singleflight`` wrap the
        client in the hot-key layer (``client_tpu_torch.cache``) and add
        a ``client_cache`` block.

        ``shard_layout``: a ``ShardLayout`` or its spec string
        (``"IN=0->OUT=0"``) over ``endpoints`` in order; measurement
        clients become ``ShardedClient``s over the pool
        (``client_tpu_torch.shard``). ``roles``: a ``{role: [urls]}`` dict
        or its spec string (``"prefill=u1+u2;decode=u3"``); trace replay
        drives ``prefill_decode`` records through a ``DisaggClient`` over
        them (``client_tpu_torch.disagg``). ``pipeline``: a ``Pipeline``
        or its spec (``"chain"`` or an inline graph); trace replay drives
        ``pipeline`` records through a ``PipelineClient``
        (``client_tpu_torch.pipeline``).

        ``cells``: a ``{cell: [urls]}`` dict or its spec string
        (``"a=u1+u2;b=u3"``); measurement clients become
        ``FederatedClient``s over the named cells, each its own
        ``PoolClient`` (``client_tpu_torch.federation``; ``home_cell``,
        ``shadow_cell`` and ``canary_cell`` arm locality, the shadow mirror
        and the canary), and each row gains a ``client_federation`` block.
        ``watch``: arm a ``Watchtower`` (``client_tpu_torch.watch``) on each
        run's telemetry and append a ``client_watch`` block.

        ``protocol`` ``native`` / ``native-grpc`` / ``native-grpc-async``
        drives the C++ clients (``client_tpu_torch.native``)."""
        if protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {protocol!r} (one of {', '.join(PROTOCOLS)})")
        if shared_memory not in ("none", "system", "cuda"):
            raise ValueError(
                f"unknown --shared-memory {shared_memory!r} (none|system|cuda)")
        self.url = url
        self._direct_url = url
        self.protocol = protocol
        self.model_name = model_name
        self.shared_memory = shared_memory
        self.shape_overrides = shape_overrides or {}
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.retries = max(0, retries)
        self.endpoints = list(endpoints) if endpoints else None
        self.hedge = hedge
        self.hedge_delay_s = hedge_delay_s
        self.observe = observe
        self.observe_sample = observe_sample
        # --flight: attach a flight recorder to every measurement run's
        # telemetry and append a client_flight row (events/request,
        # retained fraction, commit cost) to each result
        self.flight = flight
        self.generate_stream = generate_stream
        self.coalesce = coalesce
        self.batch_window_us = batch_window_us
        self.batch_max = batch_max
        self.routing = routing
        self.admission = admission
        self.admission_mode = admission_mode
        self.admission_target_ms = admission_target_ms
        self.admission_max_queue_wait_s = admission_max_queue_wait_s
        # multi-tenant QoS (client_tpu_torch.tenancy): a parse_tenancy_spec
        # string arming per-tenant weighted-fair queueing + quotas on the
        # pool's admission controller; trace replay threads each record's
        # ``tenant`` (format v4) through the client stack
        self.tenancy = tenancy
        self.endpoint_limits = endpoint_limits
        # hot-key serving layer (client_tpu_torch.cache): wrap measurement
        # clients in the singleflight/response-cache wrapper; replay
        # threads each record's content_key into per-key payloads so the
        # layer has real hot keys to collapse
        self.cache = cache
        self.cache_ttl_s = cache_ttl_s
        self.singleflight = singleflight
        self.affinity_key = affinity_key
        # multi-cell federation (client_tpu_torch.federation): measurement
        # clients become FederatedClients over named cells, each cell its
        # own PoolClient (routing/admission/endpoint-limit flags apply
        # PER CELL); shadow/canary arm the rollout primitives and every
        # result row gains a ``client_federation`` block
        if isinstance(cells, str):
            from .federation import parse_cells_spec

            cells = parse_cells_spec(cells)
        self.cells = cells
        self.home_cell = home_cell
        self.shadow_cell = shadow_cell
        self.shadow_ratio = shadow_ratio
        self.canary_cell = canary_cell
        self.canary_weight = canary_weight
        self.canary_slo = canary_slo
        self.canary_min_events = canary_min_events
        self.cells_deadline_s = cells_deadline_s
        self.cells_attempt_timeout_s = cells_attempt_timeout_s
        # disaggregated prefill/decode (client_tpu_torch.disagg): a
        # {role: [urls]} dict or its spec string
        # ("prefill=u1+u2;decode=u3") labeling replay endpoints with
        # serving roles; trace replay drives ``prefill_decode`` records
        # (format v5) through a DisaggClient over them
        if isinstance(roles, str):
            from .federation import parse_cells_spec

            roles = parse_cells_spec(roles)
        self.roles = roles
        # client-orchestrated model-DAG replay (client_tpu_torch.pipeline):
        # a Pipeline or its spec string ("chain" or an inline graph spec);
        # trace replay drives ``pipeline`` records (format v6) through a
        # PipelineClient over the replay endpoints
        if isinstance(pipeline, str):
            from .pipeline import resolve_pipeline

            pipeline = resolve_pipeline(pipeline)
        self.pipeline = pipeline
        self.validate = validate
        # --watch: arm a continuous Watchtower (client_tpu_torch.watch) on
        # each measurement run's telemetry and append a client_watch block
        # (alerts fired/resolved by kind, tick overhead, changepoint
        # trips) to every result row
        self.watch = watch
        self._watchtower = None
        self.seed = seed
        # sharded scatter-gather (client_tpu_torch.shard): a ShardLayout or
        # a spec string ("IN=0->OUT=0") resolved over --endpoints in order;
        # measurement clients become ShardedClients over the pool
        if isinstance(shard_layout, str):
            from .shard import ShardLayout

            if not endpoints:
                raise ValueError(
                    "--shard-layout requires --endpoints: each shard is "
                    "pinned to one replica url")
            shard_layout = ShardLayout.parse(shard_layout, list(endpoints))
        self.shard_layout = shard_layout
        self.device = torch.device(device)
        self.colocated = colocated
        # orca_weighted routing needs the frontends to OPT IN to the ORCA
        # response header; every Telemetry this runner builds carries it
        self._orca_format = "json" if routing == "orca_weighted" else None
        self._telemetry = None  # fresh per measurement run (see run())
        # one ShmArena per runner (created lazily on the first shm-mode
        # worker setup): slabs and cached registrations survive across
        # workers AND runs, so a sweep's steady state pays zero region
        # create/destroy and zero registration RPCs per request
        self._arena = None
        self._arena_lock = threading.Lock()
        self._arena_before = None
        self._proxy = None
        if generate_stream:
            # one streamed generation per "request": each worker iteration
            # drives a full SSE session; latency_ms becomes session e2e
            # and --observe adds the ttft/itl breakdown (client_stream_ms)
            if protocol != "http":
                raise ValueError(
                    "--generate-stream requires the http protocol (the "
                    "generate extension is an HTTP SSE surface)")
            if shared_memory != "none":
                raise ValueError(
                    "--generate-stream requires --shared-memory none")
            prompt_rng = np.random.default_rng(seed)
            self._stream_payload = {
                "TOKENS": prompt_rng.integers(
                    0, 256, size=(1, max(1, stream_prompt_tokens)),
                    dtype=np.int32).tolist(),
                "MAX_TOKENS": max(1, stream_output_tokens),
            }
        if protocol in ("native", "native-grpc") and shared_memory == "system":
            raise ValueError("native protocols support --shared-memory none|cuda")
        if protocol == "native-grpc-async" and shared_memory != "none":
            raise ValueError("native-grpc-async supports --shared-memory none")
        if self.retries and protocol.startswith("native"):
            raise ValueError(
                "--retries requires a python frontend (http|grpc): the native "
                "clients have no resilience hook")
        if self.observe and protocol.startswith("native"):
            raise ValueError(
                "--observe requires a python frontend (http|grpc): the "
                "native clients have no telemetry hook")
        if self.endpoints and protocol not in ("http", "grpc"):
            raise ValueError(
                "--endpoints requires a python frontend (http|grpc): the "
                "pool wraps the python clients")
        if self.endpoints and shared_memory != "none":
            raise ValueError(
                "--endpoints requires --shared-memory none: regions would "
                "register on one replica while infers route to all of them")
        if self.endpoints and chaos is not None:
            raise ValueError(
                "--chaos proxies a single url; with --endpoints, stand up "
                "one ChaosProxy per replica instead")
        if self.hedge and not self.endpoints:
            raise ValueError("--hedge requires --endpoints")
        if (routing or admission or endpoint_limits) and not (
                self.endpoints or cells):
            raise ValueError(
                "--routing/--admission/--endpoint-limits require "
                "--endpoints (pool-level policies) or --cells (applied "
                "to every cell's pool)")
        if self.shard_layout is not None:
            if not self.endpoints:
                raise ValueError(
                    "--shard-layout requires --endpoints: each shard is "
                    "pinned to one replica url")
            if self.hedge or self.coalesce:
                raise ValueError(
                    "--shard-layout rejects --hedge and --coalesce: "
                    "sharded requests never hedge (a hedge would race a "
                    "replica holding a different partition) and never "
                    "coalesce")
            if generate_stream:
                raise ValueError(
                    "--shard-layout applies to unary/sharded infers, not "
                    "--generate-stream")
        if self.coalesce:
            if protocol not in ("http", "grpc"):
                raise ValueError(
                    "--coalesce requires a python frontend (http|grpc): the "
                    "batching dispatcher wraps the python clients")
            if shared_memory != "none":
                raise ValueError(
                    "--coalesce requires --shared-memory none: shm-bound "
                    "tensors never coalesce")
            if generate_stream:
                raise ValueError(
                    "--coalesce applies to unary infers, not "
                    "--generate-stream")
        if self.cache or self.singleflight:
            if protocol not in ("http", "grpc"):
                raise ValueError(
                    "--cache/--singleflight require a python frontend "
                    "(http|grpc): the caching wrapper wraps the python "
                    "clients")
            if shared_memory != "none":
                raise ValueError(
                    "--cache/--singleflight require --shared-memory none: "
                    "shm-bound tensors never cache or collapse")
            if generate_stream:
                raise ValueError(
                    "--cache/--singleflight apply to unary infers, not "
                    "--generate-stream")
            if self.shard_layout is not None:
                raise ValueError(
                    "--cache/--singleflight reject --shard-layout: a "
                    "sharded logical request has per-replica partitions, "
                    "not one cacheable answer")
        if self.affinity_key is not None and self.routing != "affinity":
            raise ValueError(
                "--affinity-key requires --routing affinity (and "
                "--endpoints): the key only steers the affinity policy")
        if self.tenancy is not None and not self.admission:
            raise ValueError(
                "--tenancy requires --admission: tenant quotas and "
                "weighted-fair queueing live in the admission controller")
        if self.cells:
            if protocol not in ("http", "grpc"):
                raise ValueError(
                    "--cells requires a python frontend (http|grpc): the "
                    "federation wraps per-cell PoolClients")
            if self.endpoints:
                raise ValueError(
                    "--cells and --endpoints are mutually exclusive: each "
                    "cell already declares its own replica urls")
            if shared_memory != "none":
                raise ValueError(
                    "--cells requires --shared-memory none (same rule as "
                    "--endpoints)")
            if chaos is not None:
                raise ValueError(
                    "--chaos proxies a single url; with --cells, stand up "
                    "one ChaosProxy per replica and group them per cell "
                    "(testing.ChaosCell / tools/bench_federation.py)")
            if self.hedge or self.coalesce or self.cache or self.singleflight:
                raise ValueError(
                    "--cells rejects --hedge/--coalesce/--cache/"
                    "--singleflight: compose them per cell (each cell IS "
                    "a PoolClient) rather than across cells")
            if self.shard_layout is not None:
                raise ValueError(
                    "--cells rejects --shard-layout: a shard layout pins "
                    "replicas of ONE pool")
            for name in (self.home_cell, self.shadow_cell,
                         self.canary_cell):
                if name is not None and name not in self.cells:
                    raise ValueError(
                        f"cell {name!r} is not declared in --cells")
        elif (self.home_cell or self.shadow_cell or self.canary_cell):
            raise ValueError(
                "--home-cell/--shadow-cell/--canary-cell require --cells")
        if chaos is not None:
            from .testing.chaos import ChaosProxy

            fault = _parse_chaos_fault(chaos)  # validate BEFORE binding
            host, _, port = url.partition(":")
            self._proxy = ChaosProxy(host, int(port)).start()
            self._proxy.fault = fault
            self.url = self._proxy.url
        try:
            self._client_mod = self._import_client_mod()
            self._metadata = self._fetch_metadata()
            self._tensors = self._generate_tensors()
            # shm modes place outputs in regions too; probe once over the
            # wire to learn output byte sizes (perf_analyzer's
            # output-shared-memory sizing, derived instead of flag-supplied)
            self._output_sizes = (
                self._probe_output_sizes() if shared_memory != "none" else {})
        except Exception:
            self.close()  # don't leak the proxy listener on init failure
            raise

    def close(self) -> None:
        if self._proxy is not None:
            self._proxy.stop()
            self._proxy = None

    def _in_device_scope(self, worker):
        """``worker`` bound to the runner's card: in the cuda mode every
        worker thread stages CUDA tensors, and runs with that card current."""
        def run(*args):
            scope = (torch.cuda.device(self.device)
                     if self.shared_memory == "cuda" and self.device.type == "cuda"
                     else nullcontext())
            with scope:
                worker(*args)
        return run

    def _import_client_mod(self):
        if self.protocol in ("http", "native"):
            from . import http as mod
        else:  # grpc and native-grpc* share the grpc value model
            from . import grpc as mod
        return mod

    def _make_client(self, concurrency: int = 1):
        if self.protocol == "native":
            from .native import NativeClient

            return NativeClient(self.url)
        if self.protocol in ("native-grpc", "native-grpc-async"):
            from .native import NativeGrpcClient

            return NativeGrpcClient(self.url)
        if self.cells:
            return self._make_federated_client(concurrency)
        if self.endpoints:
            pool = self._make_pool_client(concurrency)
            if self.shard_layout is not None:
                from .shard import ShardedClient

                # one ShardedClient per measurement client: logical infers
                # scatter across the replica-pinned endpoints (the pool
                # carries the arena so shards stage zero-copy). Every
                # logical request holds n_shards fan-out threads, so the
                # executor must admit the full worker concurrency or the
                # harness would measure its own thread pool
                return ShardedClient(
                    pool, self.shard_layout,
                    executor_workers=max(
                        8, 2 * concurrency * self.shard_layout.n_shards))
            return self._wrap_caching(self._wrap_coalescing(pool))
        if self.protocol == "http":
            client = self._client_mod.InferenceServerClient(
                self.url, concurrency=concurrency)
        else:
            client = self._client_mod.InferenceServerClient(self.url)
        if self.retries:
            from .resilience import ResiliencePolicy, RetryPolicy

            client.configure_resilience(ResiliencePolicy(
                retry=RetryPolicy(max_attempts=self.retries + 1)))
        if self._telemetry is not None:
            client.configure_telemetry(self._telemetry)
        return self._wrap_caching(self._wrap_coalescing(client))

    def _wrap_caching(self, client):
        """Cache OUTSIDE batching: a hit skips the coalescing window
        entirely, a collapsed group's one miss may still ride a batch."""
        if not (self.cache or self.singleflight):
            return client
        from .cache import CachingClient

        return CachingClient(
            client,
            cache=self.cache,
            ttl_s=self.cache_ttl_s,
            singleflight=self.singleflight,
            telemetry=self._telemetry,
        )

    def _wrap_coalescing(self, client):
        """ALL measurement workers share one client, so wrapping it in the
        batching dispatcher coalesces across workers — the deployment
        shape the dispatcher exists for."""
        if not self.coalesce:
            return client
        from .batch import BatchingClient

        return BatchingClient(
            client,
            window_us=self.batch_window_us,
            batch_max_rows=self.batch_max,
            telemetry=self._telemetry,
        )

    def _shard_arena(self):
        """One NON-promoting arena per runner for the sharded arms: the
        scatter path leases fresh per-request slabs explicitly (safe), but
        transparent promotion of the replay's SHARED cached InferInputs
        would mutate one input's raw-data/shm-params state from many
        workers at once — unsharded replay records must stay plain
        binary."""
        with self._arena_lock:
            if self._arena is None:
                from .arena import ShmArena

                self._arena = ShmArena(promote_inputs=False,
                                       name_prefix="perf_shard")
            return self._arena

    def _make_federated_client(self, concurrency: int):
        """A FederatedClient over ``--cells``: per-cell PoolClients with
        the pool-level flags (routing/admission/endpoint limits/retries)
        applied to EVERY cell, plus the shadow/canary rollout policies
        when named."""
        from .federation import CanaryPolicy, FederatedClient, ShadowPolicy
        from .resilience import RetryPolicy

        factory = None
        if self.protocol == "http":
            mod = self._client_mod

            def factory(url):
                return mod.InferenceServerClient(url, concurrency=concurrency)

        pool_kwargs: Dict[str, Any] = {
            "client_factory": factory,
            "routing": self.routing or "round_robin",
            "health_interval_s": 0.5,
            "probe_timeout_s": 0.5,
            "endpoint_retry": (RetryPolicy(max_attempts=self.retries + 1)
                               if self.retries else None),
            # admission=True (or the kwargs-dict form, when tenancy is
            # armed) builds a FRESH controller inside each cell's pool —
            # one shared controller would meter the cells jointly and
            # hide exactly the per-cell saturation the federation
            # spills on
            "admission": (
                {"mode": self.admission_mode,
                 "target_ms": self.admission_target_ms,
                 "max_queue_wait_s": self.admission_max_queue_wait_s,
                 "tenancy": self.tenancy}
                if self.admission and self.tenancy is not None
                else True if self.admission else None),
            "endpoint_limits": True if self.endpoint_limits else None,
        }
        shadow = None
        if self.shadow_cell:
            shadow = ShadowPolicy(self.shadow_cell, ratio=self.shadow_ratio)
        canary = None
        if self.canary_cell:
            canary = CanaryPolicy(
                self.canary_cell, weight=self.canary_weight,
                slo=self.canary_slo or "p95<250ms",
                min_events=self.canary_min_events)
        return FederatedClient(
            self.cells,
            home=self.home_cell,
            protocol=self.protocol,
            telemetry=self._telemetry,
            shadow=shadow,
            canary=canary,
            default_deadline_s=self.cells_deadline_s,
            per_attempt_timeout_s=self.cells_attempt_timeout_s,
            pool_kwargs=pool_kwargs,
        )

    def _make_pool_client(self, concurrency: int):
        from .pool import HedgePolicy, PoolClient
        from .resilience import RetryPolicy

        factory = None
        if self.protocol == "http":
            mod = self._client_mod

            def factory(url):
                return mod.InferenceServerClient(url, concurrency=concurrency)

        hedge = None
        if self.hedge:
            hedge = HedgePolicy(delay_s=self.hedge_delay_s)
        endpoint_retry = (
            RetryPolicy(max_attempts=self.retries + 1) if self.retries else None)
        telemetry = self._telemetry
        if self.routing == "orca_weighted" and telemetry is None:
            # the pool can only route on loads somebody ingests: a quiet
            # (sample=off) telemetry carries the ORCA opt-in + gauges
            from .observe import Telemetry

            telemetry = Telemetry(sample="off", orca_format="json")
        admission = None
        if self.admission:
            from .admission import AdmissionController

            admission = AdmissionController(
                mode=self.admission_mode,
                target_ms=self.admission_target_ms,
                max_queue_wait_s=self.admission_max_queue_wait_s,
                tenancy=self.tenancy)
        return PoolClient(
            self.endpoints,
            protocol=self.protocol,
            # sharded scatter staging rides the arena fast path (cached
            # per-endpoint registrations; see client_tpu_torch.shard)
            shm_arena=self._shard_arena() if self.shard_layout is not None
            else None,
            client_factory=factory,
            routing=self.routing or "round_robin",
            health_interval_s=0.5,
            endpoint_retry=endpoint_retry,
            hedge=hedge,
            # primary + hedge both ride the executor: size it so the full
            # worker concurrency never queues behind hedge threads
            hedge_executor_workers=max(8, 2 * concurrency),
            telemetry=telemetry,
            admission=admission,
            endpoint_limits=True if self.endpoint_limits else None,
        )

    def _control_client(self):
        """(client, module) for metadata/probing: the protocol's own python
        client (a native protocol's: the python client of its transport).
        Always dials the server directly (never the chaos proxy)."""
        mod = self._client_mod
        return mod.InferenceServerClient(self._direct_url), mod

    def _fetch_metadata(self) -> Dict[str, Any]:
        client, _ = self._control_client()
        try:
            md = client.get_model_metadata(self.model_name)
        finally:
            client.close()
        return md

    def _resolve_shape(self, name: str, shape: List[int]) -> List[int]:
        if name in self.shape_overrides:
            return self.shape_overrides[name]
        resolved = [d if d != -1 else 1 for d in shape]
        if self.batch_size:
            resolved = [self.batch_size] + resolved
        return resolved

    def _generate_tensors(self) -> List[Tuple[str, str, List[int], np.ndarray]]:
        tensors = []
        for t in self._metadata["inputs"]:
            shape = self._resolve_shape(t["name"], list(t["shape"]))
            tensors.append(
                (t["name"], t["datatype"], shape, _random_tensor(t["datatype"], shape, self.rng))
            )
        return tensors

    def _probe_output_sizes(self) -> Dict[str, int]:
        from .utils import serialized_byte_size

        client, mod = self._control_client()
        try:
            inputs = []
            for name, datatype, shape, data in self._tensors:
                inp = mod.InferInput(name, shape, datatype)
                inp.set_data_from_numpy(data)
                inputs.append(inp)
            result = client.infer(self.model_name, inputs)
            sizes = {}
            for out in self._metadata["outputs"]:
                arr = result.as_numpy(out["name"])
                if arr is None:
                    continue
                nbytes = serialized_byte_size(arr) if arr.dtype == np.object_ else arr.nbytes
                sizes[out["name"]] = nbytes + nbytes // 4  # slack for growth
            return sizes
        finally:
            client.close()

    def _run_arena(self):
        """The runner's lazily-created ShmArena (uuid-keyed regions, so
        concurrent runs on one host can never collide on fixed names).
        Lock-guarded: every worker thread sets up concurrently and all of
        them must share ONE arena."""
        with self._arena_lock:
            if self._arena is None:
                from .arena import ShmArena

                family = "cuda" if self.shared_memory == "cuda" else "system"
                self._arena = ShmArena(
                    default_family=family, colocated=self.colocated,
                    device_id=self.device.index or 0,
                    device="cuda" if self.device.type == "cuda" else "cpu")
            return self._arena

    def _shm_worker_setup(self, client, worker_id):
        """ONE shared setup path for every shm mode (system / cuda, and the
        native protocols' cuda): leases input+output slabs from the runner's
        arena, writes each payload once, and lets the (cached) registration
        machinery issue the register RPC only on a region's first use per
        endpoint. A cuda input is staged on the runner's device and the copy
        waited for before timing starts. A native client takes its inputs
        and outputs as ``("shm", region, ...)`` tuples, its regions
        registered here. Returns (inputs, outputs_or_None, cleanup)."""
        from .utils import numpy_to_tensor, serialized_byte_size

        family = self.shared_memory
        native = self.protocol in ("native", "native-grpc")
        arena = self._run_arena()
        mod = self._client_mod
        leases = []

        def cleanup():
            for lease in leases:
                try:
                    lease.release()
                except Exception:
                    pass

        try:
            inputs = []
            for name, datatype, shape, data in self._tensors:
                nbytes = (serialized_byte_size(data)
                          if datatype == "BYTES" else data.nbytes)
                lease = arena.lease(nbytes, family=family)
                leases.append(lease)
                if family == "cuda" and datatype != "BYTES":
                    dev = numpy_to_tensor(data, self.device)
                    if dev.device.type == "cuda":
                        torch.cuda.current_stream(dev.device).synchronize()
                    lease.write_torch(dev)
                else:
                    lease.write_numpy(data)
                if native:
                    arena.ensure_registered(client, lease._region)
                    inputs.append((name, ("shm", lease.region_name, nbytes,
                                          lease.offset, datatype, shape)))
                else:
                    # bind_input attaches the lease, so infer() ensures the
                    # (cached) registration against the endpoint
                    inputs.append(lease.bind_input(
                        mod.InferInput(name, shape, datatype)))
            outputs = []
            for name, nbytes in self._output_sizes.items():
                lease = arena.lease(nbytes, family=family)
                leases.append(lease)
                if native:
                    arena.ensure_registered(client, lease._region)
                    outputs.append((name, ("shm", lease.region_name,
                                           lease.byte_size, lease.offset)))
                else:
                    outputs.append(lease.bind_output(
                        mod.InferRequestedOutput(name)))
        except Exception:
            cleanup()
            raise
        return inputs, outputs or None, cleanup

    # -- one worker --------------------------------------------------------
    def _worker_setup(self, client, worker_id):
        """Per-worker client/tensor/shm setup shared by the closed-loop
        (concurrency) and open-loop (request-rate) workers.

        Returns (client, inputs, outputs, shm_cleanup, own_client)."""
        if self.protocol.startswith("native"):
            own_client = None
            if self.protocol != "native-grpc-async":
                # one C++ client per worker: the native sync Infer serializes
                # on a per-client transport handle, so sharing one client
                # would measure lock contention instead of concurrency. The
                # async protocol shares ONE client: its worker keeps every
                # worker's RPCs in flight on one multiplexed h2 connection,
                # which is what that mode measures
                client = own_client = self._make_client()
            if self.shared_memory == "none":
                inputs = [(name, data) for name, _, _, data in self._tensors]
                return client, inputs, None, None, own_client
            try:
                return (client, *self._shm_worker_setup(client, worker_id), own_client)
            except Exception:
                # the caller never receives own_client on failure: close it
                # here or the native socket/handle leaks per failed worker
                own_client.close()
                raise
        if self.shared_memory in ("system", "cuda"):
            return (client, *self._shm_worker_setup(client, worker_id), None)
        inputs = []
        for name, datatype, shape, data in self._tensors:
            inp = self._client_mod.InferInput(name, shape, datatype)
            inp.set_data_from_numpy(data)
            inputs.append(inp)
        return client, inputs, None, None, None

    def _worker(self, client, barrier, stop, latencies, errors, sheds,
                counter, worker_id):
        from .admission import AdmissionRejected
        from .resilience import CircuitOpenError

        shm_ctx = None
        own_client = None
        setup_failed = False
        try:
            client, inputs, outputs, shm_ctx, own_client = self._worker_setup(
                client, worker_id)
        except Exception as e:
            errors.append(f"worker setup failed: {e}")
            setup_failed = True
        try:
            # the barrier must be reached even on setup failure, or run()
            # would wait forever for this worker
            barrier.wait(timeout=120)
            if setup_failed:
                stop.set()
                return
            lock, count, limit = counter
            # keyword only when armed: harness hooks that stub _infer_once
            # with the bare (client, inputs, outputs) signature keep working
            akw = ({"affinity_key": self._affinity_key_for(worker_id)}
                   if self.affinity_key is not None else {})
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    self._infer_once(client, inputs, outputs, **akw)
                    latencies.append(time.perf_counter() - t0)
                except (CircuitOpenError, AdmissionRejected) as e:
                    sheds.append(str(e))  # deliberate shedding, not error
                except Exception as e:  # measured as failure, loop continues
                    errors.append(str(e))
                with lock:
                    count[0] += 1
                    if count[0] >= limit:
                        stop.set()
        finally:
            if shm_ctx is not None:
                shm_ctx()
            if own_client is not None:
                own_client.close()

    def _rate_worker(self, client, barrier, stop, schedule, cursor, t0_box,
                     records, lags, issues, errors, sheds, worker_id):
        """Open-loop worker: claims the next arrival slot from the shared
        schedule, sleeps until its wall-clock time, then issues one sync
        infer. Lateness (actual start - scheduled start) is recorded per
        request — under saturation the pool can't keep up and the lag
        distribution, not just latency, shows it (perf_analyzer's delayed
        request semantics for --request-rate-range)."""
        from .admission import AdmissionRejected
        from .resilience import CircuitOpenError

        shm_ctx = None
        own_client = None
        setup_failed = False
        try:
            client, inputs, outputs, shm_ctx, own_client = self._worker_setup(
                client, worker_id)
        except Exception as e:
            errors.append(f"worker setup failed: {e}")
            setup_failed = True
        try:
            barrier.wait(timeout=120)
            if setup_failed:
                stop.set()
                return
            lock, idx = cursor
            akw = ({"affinity_key": self._affinity_key_for(worker_id)}
                   if self.affinity_key is not None else {})
            while not stop.is_set():
                with lock:
                    i = idx[0]
                    if i >= len(schedule):
                        return
                    idx[0] += 1
                target = t0_box[0] + schedule[i]
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                lag = max(0.0, time.perf_counter() - target)
                # lag is recorded for EVERY issued request — under overload
                # the failing requests are the latest-starting ones, and
                # excluding them would understate exactly the slip this
                # mode exists to measure
                lags.append(lag)
                # actual arrival offset: feeds the achieved-ARRIVAL rate, so
                # a saturated replay that silently under-offers (workers all
                # busy, schedule slipping) can't flatter the result
                issues.append(schedule[i] + lag)
                t1 = time.perf_counter()
                try:
                    self._infer_once(client, inputs, outputs, **akw)
                    records.append(time.perf_counter() - t1)
                except (CircuitOpenError, AdmissionRejected) as e:
                    sheds.append(str(e))  # deliberate shedding, not error
                except Exception as e:  # measured as failure, loop continues
                    errors.append(str(e))
        finally:
            if shm_ctx is not None:
                shm_ctx()
            if own_client is not None:
                own_client.close()

    def _affinity_key_for(self, worker_id) -> Optional[str]:
        """The closed/open-loop worker's session key: ``worker`` = one
        key per worker (a steady per-session stream, the KV-reuse shape);
        any other value is a shared literal key (the hot-key shape)."""
        if self.affinity_key is None:
            return None
        if self.affinity_key == "worker":
            return f"w{worker_id}"
        return self.affinity_key

    def _infer_once(self, client, inputs, outputs=None, affinity_key=None):
        kw = {"affinity_key": affinity_key} if affinity_key is not None else {}
        if self.generate_stream:
            # one "request" = one fully-drained SSE generation session
            for _event in client.generate_stream(
                    self.model_name, self._stream_payload, **kw):
                pass
            return
        if self.protocol == "native-grpc-async":
            done = threading.Event()
            box = {}

            def on_complete(result, error):
                box["error"] = error
                done.set()

            client.async_infer(self.model_name, inputs, on_complete)
            if not done.wait(timeout=120):
                raise RuntimeError("async infer did not complete in 120s")
            if box.get("error"):
                raise RuntimeError(box["error"])
            return
        client.infer(self.model_name, inputs, outputs=outputs, **kw)

    def _arm_telemetry(self, measurement_requests: int):
        """A fresh Telemetry per measurement run (sample=always, ring sized
        to hold every request) so each result row's phase breakdown covers
        exactly that run."""
        if not (self.observe or self.flight or self.watch):
            return
        from .observe import Telemetry

        self._telemetry = Telemetry(
            # --flight without --observe keeps span retention off: the
            # recorder's own tail ring is the retention mechanism
            sample=self.observe_sample if self.observe else "off",
            trace_capacity=max(measurement_requests, 1024),
            orca_format=self._orca_format,
            flight=self._make_flight())
        self._arm_watch()

    def _arm_watch(self):
        """A run-scoped Watchtower over the run's telemetry: background
        ticks during the measurement window, final synchronous tick and
        stats harvest in :meth:`_watch_result`."""
        if not self.watch or self._telemetry is None:
            return
        from .watch import Watchtower

        if self._watchtower is not None:
            self._watchtower.stop()
        self._watchtower = Watchtower(
            self._telemetry, interval_s=0.25).start()

    def _watch_result(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Append ``client_watch``: the run's continuous-monitoring
        verdicts (alerts fired/resolved by kind, the active set, tick
        overhead p50/p99, changepoint trips)."""
        tower, self._watchtower = self._watchtower, None
        if tower is None:
            return result
        tower.tick()  # short runs still get at least one full evaluation
        tower.stop()
        stats = tower.stats()
        result["client_watch"] = {
            "ticks": stats["ticks"],
            "tick_ns": stats.get("tick_ns"),
            "alerts_fired": stats["alerts_fired"],
            "alerts_resolved": stats["alerts_resolved"],
            "alerts_active": stats["alerts_active"],
            "changepoint_trips": stats["changepoint_trips"],
            "active": [a.as_dict() for a in tower.active_alerts()],
        }
        return result

    def _arm_dataplane(self):
        """Scoped shm accounting for shm-mode runs: reuse an already
        installed recorder, else install one for the run (the caller's
        try/finally uninstalls an owned one even when the run raises).
        Returns (recorder, before-snapshot, owned)."""
        if self.shared_memory not in ("system", "cuda"):
            return None, None, False
        from . import observe

        # arena hit-rate baseline for this run's client_shm row (the arena
        # itself is cumulative across a sweep's runs — that reuse IS the
        # point — so the row reports deltas)
        self._arena_before = (self._arena.stats()
                              if self._arena is not None else None)
        recorder = observe.dataplane()
        if recorder is not None:
            return recorder, recorder.snapshot(), False
        registry = (self._telemetry.registry
                    if self._telemetry is not None else None)
        recorder = observe.enable_dataplane(registry)
        return recorder, recorder.snapshot(), True

    def _shm_result(self, result: Dict[str, Any], recorder,
                    before) -> Dict[str, Any]:
        """Registration-churn counters for the run: regions created and
        register RPCs issued, bytes peak, and the arena's hit rate."""
        if recorder is None:
            return result
        after = recorder.snapshot()
        family = self.shared_memory
        before_fam = before["families"][family]
        after_fam = after["families"][family]

        def rpc_delta(op: str) -> int:
            key = f"{family}.{op}.ok"
            return int(after["rpcs"].get(key, 0) - before["rpcs"].get(key, 0))

        result["client_shm"] = {
            "family": family,
            "regions_created": int(
                after_fam["created"] - before_fam["created"]),
            "regions_destroyed": int(
                after_fam["destroyed"] - before_fam["destroyed"]),
            "regions_registered": rpc_delta("register"),
            "regions_unregistered": rpc_delta("unregister"),
            "map_writes": int(
                after_fam["map_writes"] - before_fam["map_writes"]),
            "map_reads": int(
                after_fam["map_reads"] - before_fam["map_reads"]),
            # the recorder's high-water mark is attributable to THIS run
            # only when the run raised it (always true for the run-scoped
            # recorder _arm_dataplane installs; a reused process-global
            # recorder may carry an earlier run's peak -> unknown/None)
            "bytes_peak": (int(after_fam["bytes_peak"])
                           if after_fam["bytes_peak"]
                           > before_fam["bytes_peak"] else None),
        }
        if self._arena is not None:
            astats = self._arena.stats()
            abefore = self._arena_before or {}

            def adelta(key: str) -> int:
                return int(astats[key] - abefore.get(key, 0))

            leases = adelta("leases")
            reg_issued = adelta("registrations_issued")
            reg_cached = adelta("registrations_cached")
            result["client_shm"]["arena"] = {
                "leases": leases,
                "hits": adelta("hits"),
                "misses": adelta("misses"),
                # a warm sweep's later runs should approach 1.0: slabs and
                # registrations outlive the run that created them
                "hit_rate": (round(adelta("hits") / leases, 4)
                             if leases else None),
                "registrations_issued": reg_issued,
                "registrations_cached": reg_cached,
                "registration_cache_hit_rate": (
                    round(reg_cached / (reg_cached + reg_issued), 4)
                    if (reg_cached + reg_issued) else None),
                "leased_bytes": astats["leased_bytes"],
                "regions": astats["regions"],
            }
        return result

    @staticmethod
    def _disarm_dataplane(owned: bool) -> None:
        if owned:
            from . import observe

            observe.install_dataplane(None)

    def _integrity_stats(self) -> Optional[Dict[str, Any]]:
        """Pre-run snapshot of the process-global integrity counters,
        when ``--validate`` armed the row. Contract validation itself is
        default-ON regardless — this flag only opts the RESULT ROW into
        carrying the delta, so A/B artifacts stay byte-stable when
        validation reporting is off."""
        if not self.validate:
            return None
        from . import integrity

        return integrity.global_stats().snapshot()

    def _integrity_result(self, result: Dict[str, Any],
                          before: Optional[Dict[str, Any]],
                          ) -> Dict[str, Any]:
        """Append ``client_integrity``: this run's delta of the global
        validation counters (results checked, per-check count,
        violations by kind) plus the overhead percentile window — the
        measured nanoseconds the contract walk cost per response."""
        if before is None:
            return result
        from . import integrity

        after = integrity.global_stats().snapshot()
        kinds = {
            k: after["violations_by_kind"].get(k, 0)
            - before["violations_by_kind"].get(k, 0)
            for k in after.get("violations_by_kind", {})
        }
        result["client_integrity"] = {
            "results": after["results"] - before["results"],
            "checks": after["checks"] - before["checks"],
            "violations": after["violations"] - before["violations"],
            "violations_by_kind": {k: v for k, v in kinds.items() if v},
            # the stats ring holds the most recent samples, which for a
            # just-finished run IS the run's window
            "overhead_ns": after.get("overhead_ns", {}),
        }
        return result

    @staticmethod
    def _admission_stats(client) -> Optional[Dict[str, Any]]:
        """The pool's admission-controller snapshot (limit, inflight,
        per-lane sheds), when one is armed — appended to result rows as
        ``client_admission`` so artifacts carry the shed story."""
        getter = getattr(client, "admission", None)
        if getter is None:
            return None
        try:
            ctrl = getter()
            return ctrl.snapshot() if ctrl is not None else None
        except Exception:
            return None

    @staticmethod
    def _admission_result(result: Dict[str, Any],
                          admission_stats: Optional[Dict[str, Any]],
                          ) -> Dict[str, Any]:
        if admission_stats is not None:
            result["client_admission"] = admission_stats
        return result

    def _cache_stats_row(self, client) -> Optional[Dict[str, Any]]:
        """The caching wrapper's snapshot, when armed — the per-arm
        hit/collapse story every harness row carries as ``client_cache``."""
        if not (self.cache or self.singleflight):
            return None
        getter = getattr(client, "cache_stats", None)
        if getter is None:
            return None
        try:
            return getter()
        except Exception:
            return None

    @staticmethod
    def _cache_result(result: Dict[str, Any],
                      cache_stats: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        if cache_stats is not None:
            result["client_cache"] = {
                "hit_rate": cache_stats["hit_rate"],
                "hits": cache_stats["hit"],
                "stale_hits": cache_stats["stale"],
                "misses": cache_stats["miss"],
                "bypass": cache_stats["bypass"],
                "singleflight_collapsed": cache_stats[
                    "singleflight_collapsed"],
                "collapse_ratio": cache_stats["collapse_ratio"],
                "wire_requests": cache_stats["wire_requests"],
                "logical_requests": cache_stats["logical_requests"],
                "bytes_resident": cache_stats["bytes_resident"],
                "entries": cache_stats["entries"],
            }
        return result

    @staticmethod
    def _batch_result(result: Dict[str, Any],
                      batch_stats: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """Achieved client-side batch sizes alongside the latency row."""
        if batch_stats is not None:
            result["client_batch"] = {
                "dispatches": batch_stats["dispatches"],
                "coalesced_calls": batch_stats["coalesced_calls"],
                "solo_calls": batch_stats["solo_calls"],
                "bypass_calls": batch_stats["bypass_calls"],
                "window_us": batch_stats["window_us"],
                "rows_p50": batch_stats["batch_rows"]["p50"],
                "rows_p99": batch_stats["batch_rows"]["p99"],
                "rows_mean": batch_stats["batch_rows"]["mean"],
            }
        return result

    def _layer_stats(self, client):
        """(batch, cache, admission, federation) snapshots of the
        measurement client, read before it closes."""
        return (client.stats() if self.coalesce else None,
                self._cache_stats_row(client), self._admission_stats(client),
                self._federation_stats(client))

    def _layer_result(self, result: Dict[str, Any], stats) -> Dict[str, Any]:
        batch_stats, cache_stats, admission_stats, fed_stats = stats
        return self._federation_result(self._cache_result(
            self._admission_result(
                self._batch_result(result, batch_stats), admission_stats),
            cache_stats), fed_stats)

    def _federation_stats(self, client) -> Optional[Dict[str, Any]]:
        """The federation snapshot (per-cell spill/serve counters plus
        the shadow/canary views) when ``--cells`` is armed — appended to
        result rows as ``client_federation`` so artifacts carry the
        spillover/rollout story."""
        if not self.cells:
            return None
        getter = getattr(client, "federation_stats", None)
        if getter is None:
            return None
        try:
            # let in-flight shadow mirrors settle so the row's counters
            # cover the run (bounded; mirrors are themselves bounded)
            drain = getattr(client, "shadow_drain", None)
            if drain is not None and self.shadow_cell:
                drain(timeout_s=5.0)
            return getter()
        except Exception:
            return None

    @staticmethod
    def _federation_result(result: Dict[str, Any],
                           fed_stats: Optional[Dict[str, Any]],
                           ) -> Dict[str, Any]:
        if fed_stats is not None:
            cells = fed_stats.get("cells", {})
            result["client_federation"] = {
                "home": fed_stats.get("home"),
                "order": fed_stats.get("order"),
                "spills": sum(
                    n for row in cells.values()
                    for n in (row.get("spill_out") or {}).values()),
                "cells": cells,
                "shadow": fed_stats.get("shadow"),
                "canary": fed_stats.get("canary"),
            }
        return result

    def _make_flight(self):
        """A fresh FlightRecorder per measurement run under ``--flight``
        (None otherwise), so each row's retention accounting covers
        exactly that run."""
        if not self.flight:
            return None
        from .flight import FlightRecorder

        return FlightRecorder()

    def _observe_result(self, result: Dict[str, Any]) -> Dict[str, Any]:
        if self._telemetry is not None:
            # --flight without --observe runs sample="off": the empty
            # trace ring yields empty breakdowns, skip the rows entirely
            if self.observe or self._telemetry.sample != "off":
                result["client_phase_ms"] = \
                    self._telemetry.phase_breakdown()
                stream = self._telemetry.stream_breakdown()
                if stream:
                    # streaming runs: ttft/itl/duration p50/p99 from the
                    # exact StreamSpan samples in the trace ring
                    result["client_stream_ms"] = stream
            recorder = getattr(self._telemetry, "flight", None)
            if recorder is not None:
                stats = recorder.stats()
                result["client_flight"] = {
                    "requests": stats["requests"],
                    "events_per_request": stats["events_per_request"],
                    "retained": stats["retained"],
                    "retained_total": stats["retained_total"],
                    "retained_fraction": stats["retained_fraction"],
                    "dropped": stats["dropped"],
                    "ring": stats["ring"],
                    "capacity": stats["capacity"],
                    "commit_retained_ns": stats.get("commit_retained_ns"),
                    "commit_dropped_ns": stats.get("commit_dropped_ns"),
                }
        return result

    # -- sweep -------------------------------------------------------------
    def run(self, concurrency: int, measurement_requests: int) -> Dict[str, Any]:
        self._arm_telemetry(measurement_requests)
        shm_rec, shm_before, shm_owned = self._arm_dataplane()
        try:
            return self._run_closed(
                concurrency, measurement_requests, shm_rec, shm_before)
        finally:
            # an owned recorder must not outlive the run, even on error
            self._disarm_dataplane(shm_owned)

    def _run_closed(self, concurrency: int, measurement_requests: int,
                    shm_rec, shm_before) -> Dict[str, Any]:
        integrity_before = self._integrity_stats()
        client = self._make_client(concurrency)
        if self.protocol == "native-grpc-async":
            # the shared instance must admit as many RPCs as we have
            # workers, or the measurement clamps at the default window
            client.set_async_concurrency(concurrency)
        latencies: List[float] = []
        errors: List[str] = []
        sheds: List[str] = []  # breaker fast-fails + admission rejections
        stop = threading.Event()
        barrier = threading.Barrier(concurrency + 1)
        counter = (threading.Lock(), [0], measurement_requests)
        workers = [
            threading.Thread(
                target=self._in_device_scope(self._worker),
                args=(client, barrier, stop, latencies, errors, sheds,
                      counter, i),
                daemon=True,
            )
            for i in range(concurrency)
        ]
        for w in workers:
            w.start()
        barrier.wait()
        t_start = time.perf_counter()
        for w in workers:
            w.join(timeout=600)
        elapsed = time.perf_counter() - t_start
        layer_stats = self._layer_stats(client)
        client.close()

        lat_sorted = sorted(latencies)
        n = len(lat_sorted)
        issued = n + len(errors) + len(sheds)
        return self._watch_result(self._integrity_result(self._shm_result(self._layer_result(
            self._observe_result({
            "model": self.model_name,
            "protocol": self.protocol,
            "shared_memory": self.shared_memory,
            "concurrency": concurrency,
            "requests": n,
            "errors": len(errors),
            "shed": len(sheds),
            # a breaker fast-fail / admission rejection is deliberate
            # load-shedding, not a server error: the two rates must never
            # share a bucket (that would make overload unreadable)
            "error_pct": round(100.0 * len(errors) / issued, 2)
            if issued else 0.0,
            "shed_pct": round(100.0 * len(sheds) / issued, 2)
            if issued else 0.0,
            "error_sample": errors[0] if errors else None,
            "shed_sample": sheds[0] if sheds else None,
            "duration_s": round(elapsed, 3),
            "infer_per_sec": round(n / elapsed, 1) if elapsed > 0 else 0.0,
            "latency_ms": _latency_ms_row(lat_sorted),
        }), layer_stats), shm_rec, shm_before), integrity_before))

    def run_rate(self, rate: float, measurement_requests: int,
                 distribution: str = "constant",
                 pool_size: int = 16) -> Dict[str, Any]:
        """Open-loop measurement at a fixed arrival rate (perf_analyzer's
        --request-rate-range). Arrivals follow the schedule regardless of
        completions, so queueing shows up as schedule lag + latency growth
        instead of the closed-loop's self-throttling."""
        if rate <= 0:
            raise ValueError("rate must be > 0")
        if measurement_requests < 1:
            raise ValueError("measurement_requests must be >= 1")
        if distribution == "constant":
            gaps = np.full(measurement_requests, 1.0 / rate)
        elif distribution == "poisson":
            gaps = self.rng.exponential(1.0 / rate, size=measurement_requests)
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        schedule = np.concatenate([[0.0], np.cumsum(gaps[:-1])]).tolist()

        self._arm_telemetry(measurement_requests)
        shm_rec, shm_before, shm_owned = self._arm_dataplane()
        try:
            return self._run_open(
                rate, distribution, pool_size, schedule, shm_rec, shm_before)
        finally:
            # an owned recorder must not outlive the run, even on error
            self._disarm_dataplane(shm_owned)

    def _run_open(self, rate: float, distribution: str, pool_size: int,
                  schedule: List[float], shm_rec,
                  shm_before) -> Dict[str, Any]:
        integrity_before = self._integrity_stats()
        client = self._make_client(pool_size)
        if self.protocol == "native-grpc-async":
            client.set_async_concurrency(pool_size)
        records: List[float] = []  # latency_s of successful requests
        lags: List[float] = []  # schedule lag of EVERY issued request
        issues: List[float] = []  # actual arrival offset of every request
        errors: List[str] = []
        sheds: List[str] = []  # breaker fast-fails + admission rejections
        stop = threading.Event()
        barrier = threading.Barrier(pool_size + 1)
        cursor = (threading.Lock(), [0])
        t0_box = [0.0]
        workers = [
            threading.Thread(
                target=self._in_device_scope(self._rate_worker),
                args=(client, barrier, stop, schedule, cursor, t0_box,
                      records, lags, issues, errors, sheds, i),
                daemon=True,
            )
            for i in range(pool_size)
        ]
        for w in workers:
            w.start()
        # t0 must be written BEFORE the barrier releases the workers — they
        # read it immediately to place the schedule on the wall clock
        t0_box[0] = time.perf_counter()
        barrier.wait()
        for w in workers:
            w.join(timeout=600)
        elapsed = time.perf_counter() - t0_box[0]
        layer_stats = self._layer_stats(client)
        client.close()

        lat_sorted = sorted(records)
        lag_sorted = sorted(lags)
        n = len(lat_sorted)
        issued = len(lag_sorted)
        # a request is "delayed" when the pool could not start it on time
        # (reference threshold: perf_analyzer flags schedule slip; 1 ms
        # separates scheduler jitter from genuine queueing)
        delayed = sum(1 for lag in lag_sorted if lag > 1e-3)
        # offered vs achieved ARRIVAL rate: the schedule asked for ``rate``
        # req/s; what the workers actually managed to issue is the honest
        # denominator for every capacity claim (a saturated pool that
        # silently under-offers would otherwise flatter its own number)
        arrival_window = max(issues) if issues else 0.0
        return self._watch_result(self._integrity_result(self._shm_result(self._layer_result(
            self._observe_result({
            "model": self.model_name,
            "protocol": self.protocol,
            "shared_memory": self.shared_memory,
            "request_rate": rate,
            "offered_rate": rate,
            "distribution": distribution,
            "pool_size": pool_size,
            "requests": n,
            "issued": issued,
            "errors": len(errors),
            "shed": len(sheds),
            # under saturation the split is the whole story: shed_pct is
            # honest load-shedding (breaker fast-fail / admission), while
            # error_pct is genuine failure — they never share a bucket
            "error_pct": round(100.0 * len(errors) / issued, 2)
            if issued else 0.0,
            "shed_pct": round(100.0 * len(sheds) / issued, 2)
            if issued else 0.0,
            "error_sample": errors[0] if errors else None,
            "shed_sample": sheds[0] if sheds else None,
            "duration_s": round(elapsed, 3),
            "achieved_rate": round(n / elapsed, 1) if elapsed > 0 else 0.0,
            "achieved_arrival_rate": round(issued / arrival_window, 1)
            if arrival_window > 0 else 0.0,
            "latency_ms": _latency_ms_row(lat_sorted),
            "schedule_lag_ms": _lag_ms_row(lag_sorted),
            "delayed_pct": round(100.0 * delayed / issued, 1) if issued else 0.0,
        }), layer_stats), shm_rec, shm_before), integrity_before))

    # -- trace replay --------------------------------------------------------
    _SEQ_GATE_TIMEOUT_S = 60.0

    def run_trace(self, trace, speed: float = 1.0, replay_workers: int = 32,
                  slos: Sequence[Any] = (), on_result=None,
                  warmup: bool = True) -> Dict[str, Any]:
        """Open-loop replay of a workload trace (``client_tpu_torch.trace``)
        against the configured endpoint: arrivals are scheduled at
        ``at_s / speed`` regardless of completions, and all three request
        kinds run concurrently — unary infers, ``generate_stream`` SSE
        sessions (TTFT/ITL via StreamSpan), and sequences whose steps are
        issued in order.

        ``slos``: declared objectives — ``observe.SLOSpec`` values or spec
        strings (``ttft_p95<200ms``, ``p99<50ms``, ``error_rate<0.1%``).
        Stream-metric SLOs are tracked by a fresh per-run
        ``observe.Telemetry`` (one StreamSpan per session; exact over the
        replay window); ``request_ms`` SLOs are fed one event per
        unary/sequence record from the replay's own outcome accounting;
        error-rate SLOs are evaluated from the shed/error fractions.
        The result row carries per-kind latency/TTFT/ITL percentiles,
        offered-vs-achieved rates, schedule slip, shed/error fractions
        and the per-SLO verdicts (``slo_ok`` = every objective attained).

        ``on_result(record, outcome)`` (optional) is called with each
        completed record and its result object / exception — test hooks
        only; keep it cheap, it runs on the replay workers.

        ``warmup`` (default True): before the schedule starts, one
        best-effort dispatch per distinct (kind, model) through a
        separate telemetry-free client, so the first measured record of
        each model never bills its first-call setup to an SLO.

        Tenant-attributed records (format v4) pass their tenant to the
        client stack and the row gains per-tenant ``tenants`` counts;
        with ``routing="affinity"`` keyed records route by their
        ``content_key``. ``sharded`` records scatter through the
        ``shard_layout``; ``prefill_decode`` records run as two-leg
        sessions through a ``DisaggClient`` over ``roles``; ``pipeline``
        records run as DAGs through a ``PipelineClient`` over the replay
        endpoints, and the row gains a ``pipeline_stages`` waterfall."""
        from .observe import SLO, SLOSpec, parse_slo_spec, Telemetry
        from .trace import Trace

        if speed <= 0:
            raise ValueError("speed must be > 0")
        if self.protocol not in ("http", "grpc"):
            raise ValueError(
                "trace replay requires a python frontend (http|grpc): the "
                "native clients take (name, array) pairs and have no "
                "sequence/telemetry surface")
        if self.shared_memory != "none":
            raise ValueError(
                "trace replay supports --shared-memory none only: replay "
                "payloads are synthesized per record, not staged in "
                "pre-registered regions")
        if isinstance(trace, Trace):
            header, records = trace.header, trace.records
        else:
            header, records = {}, list(trace)
        if not records:
            raise ValueError("empty trace")
        records = sorted(records, key=lambda r: r.at_s)
        if (any(r.kind == "generate_stream" for r in records)
                and self.protocol != "http"):
            raise ValueError(
                "trace contains generate_stream records: the generate "
                "extension is an HTTP SSE surface (use -i http)")
        if (any(r.kind == "sharded" for r in records)
                and self.shard_layout is None):
            raise ValueError(
                "trace contains sharded records: configure --shard-layout "
                "(with --endpoints) so the replayer can scatter them "
                "(client_tpu_torch.shard)")
        if any(r.kind == "prefill_decode" for r in records):
            if self.protocol != "http":
                raise ValueError(
                    "trace contains prefill_decode records: the decode "
                    "leg is an HTTP SSE surface (use -i http)")
            if not self.roles:
                raise ValueError(
                    "trace contains prefill_decode records: configure "
                    "--roles 'prefill=u1;decode=u2' so the replayer can "
                    "build a DisaggClient over role-labeled endpoints "
                    "(client_tpu_torch.disagg)")
        if (any(r.kind == "pipeline" for r in records)
                and self.pipeline is None):
            raise ValueError(
                "trace contains pipeline records: configure --pipeline "
                "('chain' or an inline graph spec) so the replayer can "
                "run them as client-orchestrated DAGs "
                "(client_tpu_torch.pipeline)")
        specs: List[SLOSpec] = [
            spec if isinstance(spec, SLOSpec) else parse_slo_spec(spec)
            for spec in slos]

        trace_duration = records[-1].at_s or (1.0 / speed)
        # a fresh Telemetry per replay, sample FORCED to "always": SLO
        # good/bad counters must cover exactly this run (observe.SLO.report's
        # bounded-window contract) — a ratio mode would silently drop
        # unsampled (including errored) requests from the verdict. The
        # window must outlive the replay so nothing ages out mid-run.
        window_s = max(300.0, 4.0 * trace_duration / speed)
        self._telemetry = Telemetry(
            sample="always",
            trace_capacity=len(records) + 64,
            stream_window_s=window_s,
            orca_format=self._orca_format,
            flight=self._make_flight())
        self._arm_watch()
        # request_ms SLOs are fed PER TRACE RECORD from the replay's own
        # outcome accounting, NOT from telemetry spans (a retried attempt
        # is a span of its own); stream-metric SLOs stay span-fed (one
        # StreamSpan per session by construction).
        request_slos: List[SLO] = []
        for spec in specs:
            if spec.kind != "latency":
                continue
            if spec.metric == "request_ms":
                request_slos.append(SLO(
                    spec.name, "request_ms", spec.threshold_ms,
                    spec.objective, window_s))
            else:
                self._telemetry.track_slo(
                    spec.name, spec.metric, spec.threshold_ms,
                    spec.objective, window_s=window_s)

        try:
            return self._run_trace_measured(
                header, records, speed, replay_workers, specs, on_result,
                warmup, trace_duration, request_slos)
        finally:
            if not self.observe:
                # the per-run Telemetry must not leak into later run()/
                # run_rate() calls on a runner that never asked for
                # telemetry — on ANY exit path, including errors
                self._telemetry = None

    def _run_trace_measured(self, header, records, speed, replay_workers,
                            specs, on_result, warmup, trace_duration,
                            request_slos) -> Dict[str, Any]:
        resources = _ReplayResources(self, records)
        if any(r.kind == "prefill_decode" for r in records):
            # one role-labeled DisaggClient for the whole replay
            # (telemetry-free: prefill_decode sessions feed request_ms
            # SLOs per record, like unaries, so warmup sessions land
            # nothing in the per-run Telemetry)
            resources.disagg = self._make_disagg_client()
        if any(r.kind == "pipeline" for r in records):
            # one PipelineClient (own pool, arena-backed) for the whole
            # replay; per-stage latencies land in the resources and
            # surface as the result row's ``pipeline_stages`` waterfall
            resources.pipeline = self._make_pipeline_client()
        try:
            return self._run_trace_workers(
                header, records, speed, replay_workers, specs, on_result,
                warmup, trace_duration, request_slos, resources)
        finally:
            if resources.disagg is not None:
                resources.disagg.close()
            if resources.pipeline is not None:
                resources.pipeline.close()

    def _run_trace_workers(self, header, records, speed, replay_workers,
                           specs, on_result, warmup, trace_duration,
                           request_slos, resources) -> Dict[str, Any]:
        if warmup:
            # warm through a SEPARATE telemetry-free client: server-side
            # model setup is what warmup exists for, and warmup traffic
            # must not land spans or SLO events in the per-run Telemetry
            # (the verdict population is exactly the trace)
            saved_telemetry = self._telemetry
            self._telemetry = None
            warm_client = self._make_client(4)
            try:
                warm_wait = getattr(warm_client, "wait_healthy", None)
                if warm_wait is not None:
                    warm_wait(timeout_s=10.0)
                self._replay_warmup(warm_client, records, resources)
            finally:
                warm_client.close()
                self._telemetry = saved_telemetry
            # warmup DAG runs must not land in the measured waterfall
            resources.pipeline_stage_s.clear()
        # capture AFTER warmup: warmup traffic is contract-checked too
        # and must not pollute the measured row's validation delta
        integrity_before = self._integrity_stats()
        client = self._make_client(replay_workers)
        try:
            # pools: let active probes mark replicas healthy BEFORE the
            # schedule starts, or the first arrivals measure probe warmup
            wait_healthy = getattr(client, "wait_healthy", None)
            if wait_healthy is not None:
                wait_healthy(timeout_s=10.0)
            if resources.disagg is not None:
                resources.disagg.wait_healthy(timeout_s=10.0)
            outcomes: List[Tuple[str, str, float, float, float,
                                 Optional[str], Optional[str],
                                 Optional[float]]] = []
            errors: List[str] = []
            stop = threading.Event()
            barrier = threading.Barrier(replay_workers + 1)
            cursor = (threading.Lock(), [0])
            t0_box = [0.0]
            workers = [
                threading.Thread(
                    target=self._replay_worker,
                    args=(client, barrier, stop, records, speed, cursor,
                          t0_box, resources, outcomes, errors, on_result),
                    daemon=True,
                )
                for _ in range(replay_workers)
            ]
            for w in workers:
                w.start()
            t0_box[0] = time.perf_counter()
            barrier.wait()
            # the join bound scales with the trace: a replay longer than a
            # fixed cap must not be silently truncated into a row that
            # reports partial counts as the verdict
            join_timeout = max(600.0, 2.0 * trace_duration / speed + 120.0)
            for w in workers:
                w.join(timeout=join_timeout)
            stop.set()
            elapsed = time.perf_counter() - t0_box[0]
            # snapshot BEFORE close(): a worker stuck past the join
            # timeout may still append when close() yanks its connection,
            # and aggregation must not iterate a list being mutated
            outcomes = list(outcomes)
            errors = list(errors)
            layer_stats = self._layer_stats(client)
        finally:
            client.close()
        return self._watch_result(self._integrity_result(self._layer_result(
            self._trace_result(
                header, records, speed, elapsed, outcomes, errors, specs,
                resources, request_slos), layer_stats), integrity_before))

    def _replay_warmup(self, client, records, resources) -> None:
        """One best-effort dispatch per distinct (kind, model) BEFORE the
        schedule starts: the first request of each model must not bill
        its first-call setup / connection setup to an SLO. Warmup
        sequences use a throwaway id (start+end in one step) so no group
        state is left behind; failures are ignored — a genuinely broken
        model will show up measured."""
        done = set()
        for rec in records:
            key = (rec.kind, rec.model)
            if key in done:
                continue
            done.add(key)
            try:
                if rec.kind == "sequence":
                    # same unwrap as _replay_dispatch: a ShardedClient
                    # types-rejects sequence kwargs, and a swallowed
                    # rejection here would silently skip the warmup
                    getattr(client, "inner", client).infer(
                        rec.model, resources.inputs_for(rec),
                        sequence_id=999979,
                        sequence_start=True, sequence_end=True)
                else:
                    self._replay_dispatch(client, rec, resources)
            except Exception:
                pass

    def _replay_worker(self, client, barrier, stop, records, speed, cursor,
                       t0_box, resources, outcomes, errors, on_result):
        from .admission import AdmissionRejected
        from .resilience import CircuitOpenError

        try:
            barrier.wait(timeout=120)
        except threading.BrokenBarrierError:
            return
        lock, idx = cursor
        while not stop.is_set():
            with lock:
                i = idx[0]
                if i >= len(records):
                    return
                idx[0] += 1
            rec = records[i]
            target = t0_box[0] + rec.at_s / speed
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            gate = (resources.seq_gates.get(rec.seq_group)
                    if rec.kind == "sequence" else None)
            ordered = True
            if gate is not None:
                with gate.cond:
                    ordered = gate.cond.wait_for(
                        lambda: gate.next >= rec.seq_index,
                        timeout=self._SEQ_GATE_TIMEOUT_S) and not gate.broken
            # lag includes sequence head-of-line blocking: the arrival was
            # scheduled at ``target`` whether or not its predecessor is done
            lag = max(0.0, time.perf_counter() - target)
            t1 = time.perf_counter()
            status = "ok"
            outcome: Any = None
            try:
                if not ordered:
                    raise RuntimeError(
                        f"sequence group {rec.seq_group} step "
                        f"{rec.seq_index}: predecessor failed or never "
                        f"completed (group abandoned)")
                outcome = self._replay_dispatch(client, rec, resources)
            except (CircuitOpenError, AdmissionRejected) as e:
                status = "shed"
                outcome = e
                errors.append(f"{rec.kind}: {e}")
            except Exception as e:  # measured as failure, replay continues
                # a sharded logical request wraps its per-shard failure in
                # ShardFailed; a breaker-open/admission cause underneath is
                # still a SHED, not an error — same classification contract
                # as the unsharded kinds
                cause = getattr(e, "cause", None)
                status = ("shed" if isinstance(
                    cause, (CircuitOpenError, AdmissionRejected))
                    else "error")
                outcome = e
                errors.append(f"{rec.kind}: {e}")
            finally:
                if gate is not None:
                    with gate.cond:
                        if status != "ok":
                            # ANY failed step (error, shed, or gate
                            # timeout) poisons the group: the server-side
                            # sequence state is now a lie, and sending
                            # later steps into it would either mis-count
                            # as independent errors or mis-accumulate and
                            # inflate the served numbers under exactly
                            # the chaos this harness measures
                            gate.broken = True
                        gate.next = max(gate.next, rec.seq_index + 1)
                        gate.cond.notify_all()
            # shed attribution rides the outcome tuple: the typed
            # rejection's reason and honest retry_after hint (possibly
            # wrapped in a sharded failure's ``cause``)
            shed_exc = (getattr(outcome, "cause", None) or outcome
                        if status == "shed" else None)
            outcomes.append(
                (rec.kind, status, time.perf_counter() - t1, lag,
                 rec.at_s / speed, getattr(rec, "tenant", None),
                 getattr(shed_exc, "reason", None),
                 getattr(shed_exc, "retry_after_s", None)))
            if on_result is not None:
                on_result(rec, outcome)

    def _replay_affinity_kw(self, rec) -> Dict[str, Any]:
        """The replay's session-key kwarg: with ``routing="affinity"``,
        every keyed record (format v3 ``content_key``) routes by its key —
        the trace-driven twin of ``--affinity-key``."""
        if (self.routing == "affinity"
                and getattr(rec, "content_key", None) is not None):
            return {"affinity_key": f"k{rec.content_key}"}
        return {}

    def _replay_tenant_kw(self, rec) -> Dict[str, Any]:
        """The replay's tenant kwarg: a tenant-attributed record (format
        v4) carries its tenant through the whole client stack — admission
        queues/quotas, cache partitions and batch compat keys all judge
        it as that tenant. Tenantless records pass no kwarg at all, so a
        mixed trace exercises both paths."""
        tenant = getattr(rec, "tenant", None)
        if tenant is not None:
            return {"tenant": tenant}
        return {}

    def _make_disagg_client(self):
        """The replay's disaggregated client: a DisaggClient over the
        ``--roles`` urls (role-labeled) plus any role-less ``--endpoints``
        (eligible only for the monolithic fallback path)."""
        from .disagg import DisaggClient
        from .pool import EndpointSpec

        role_by_url = {u: role for role, urls in self.roles.items()
                       for u in urls}
        urls = list(dict.fromkeys(
            [u for role_urls in self.roles.values() for u in role_urls]
            + (self.endpoints or [])))
        specs = [EndpointSpec(u, role=role_by_url.get(u)) for u in urls]
        return DisaggClient(specs, protocol=self.protocol)

    def _make_pipeline_client(self):
        """The replay's DAG executor: a PipelineClient over the replay
        endpoints (its own arena-backed pool, so intermediate handoffs
        ride cached shm registrations exactly like production runs)."""
        from .pipeline import PipelineClient

        urls = list(self.endpoints) if self.endpoints else [self.url]
        return PipelineClient(urls, self.pipeline,
                              protocol=self.protocol)

    def _replay_dispatch(self, client, rec, resources):
        if rec.kind == "sharded":
            # the measurement client IS the ShardedClient in shard mode
            return client.infer(
                rec.model, resources.inputs_for(rec),
                model_version=rec.version,
                **self._replay_tenant_kw(rec))
        if rec.kind == "prefill_decode":
            # the disagg session runs on its own role-labeled pool; the
            # measurement client plays no part in either leg
            tokens = resources.tokens_for(
                rec.prompt_tokens, getattr(rec, "content_key", None))
            return list(resources.disagg.generate_stream(
                tokens, max_tokens=int(rec.output_tokens)))
        if rec.kind == "pipeline":
            # the DAG runs on its own arena-backed pool; the measurement
            # client plays no part in the stage dispatches
            res = resources.pipeline.run(resources.feeds_for(rec))
            resources.record_pipeline(res)
            return res
        # non-sharded kinds bypass the scatter-gather wrapper (a sharded
        # client types-rejects streams and would scatter plain unaries)
        client = getattr(client, "inner", client)
        if rec.kind == "generate_stream":
            events = []
            for event in client.generate_stream(
                    rec.model, resources.stream_payload(rec),
                    model_version=rec.version,
                    **self._replay_affinity_kw(rec),
                    **self._replay_tenant_kw(rec)):
                events.append(event)
            return events
        inputs = resources.inputs_for(rec)
        if rec.kind == "sequence":
            return client.infer(
                rec.model, inputs,
                model_version=rec.version,
                sequence_id=rec.seq_group,
                sequence_start=rec.seq_index == 0,
                sequence_end=rec.seq_index == rec.seq_len - 1,
                **self._replay_tenant_kw(rec))
        return client.infer(rec.model, inputs, model_version=rec.version,
                            **self._replay_affinity_kw(rec),
                            **self._replay_tenant_kw(rec))

    @staticmethod
    def _kind_row(samples: Dict[Tuple[str, str], List[float]],
                  counts: Dict[Tuple[str, str], int],
                  kind: str) -> Dict[str, Any]:
        return {
            "requests": counts.get((kind, "ok"), 0)
            + counts.get((kind, "error"), 0) + counts.get((kind, "shed"), 0),
            "ok": counts.get((kind, "ok"), 0),
            "errors": counts.get((kind, "error"), 0),
            "shed": counts.get((kind, "shed"), 0),
            "latency_ms": _latency_ms_row(
                sorted(samples.get((kind, "ok"), []))),
        }

    def _trace_result(self, header, records, speed, elapsed, outcomes,
                      errors, specs, resources,
                      request_slos=()) -> Dict[str, Any]:
        kind_counts: Dict[str, int] = {}
        counts: Dict[Tuple[str, str], int] = {}
        samples: Dict[Tuple[str, str], List[float]] = {}
        lags: List[float] = []
        all_ok_lat: List[float] = []
        arrival_window = 0.0
        # per-tenant accounting (format v4 records): status counts, ok
        # latencies and shed-reason breakdown, keyed by tenant label
        tenant_rows: Dict[str, Dict[str, Any]] = {}
        retry_hints: List[float] = []
        for (kind, status, lat_s, lag_s, at_rel_s,
             tenant, shed_reason, retry_after_s) in outcomes:
            kind_counts[kind] = kind_counts.get(kind, 0) + 1
            counts[(kind, status)] = counts.get((kind, status), 0) + 1
            samples.setdefault((kind, status), []).append(lat_s)
            if status == "ok":
                all_ok_lat.append(lat_s)
            if retry_after_s is not None:
                retry_hints.append(float(retry_after_s))
            if tenant is not None:
                row = tenant_rows.setdefault(tenant, {
                    "issued": 0, "ok": 0, "errors": 0, "shed": 0,
                    "shed_by_reason": {}, "_lat": []})
                row["issued"] += 1
                if status == "ok":
                    row["ok"] += 1
                    row["_lat"].append(lat_s)
                elif status == "shed":
                    row["shed"] += 1
                    reason = shed_reason or "unknown"
                    row["shed_by_reason"][reason] = (
                        row["shed_by_reason"].get(reason, 0) + 1)
                else:
                    row["errors"] += 1
            lags.append(lag_s)
            # actual arrival offset (scheduled + slip): the window the
            # schedule was REALLY issued over, free of the service/drain
            # tail that stretches ``elapsed``
            arrival_window = max(arrival_window, at_rel_s + lag_s)
            # request_ms SLOs: exactly ONE event per unary/sequence record
            # (caller-visible latency; errored or shed = bad) — streams
            # report through their own ttft/itl/duration metrics
            if kind != "generate_stream":
                for slo in request_slos:
                    if status == "ok":
                        slo.observe(lat_s * 1e3)
                    else:
                        slo.observe_failure()
        issued = len(outcomes)
        ok = sum(n for (_, status), n in counts.items() if status == "ok")
        shed = sum(n for (_, status), n in counts.items() if status == "shed")
        errored = issued - ok - shed
        trace_duration = records[-1].at_s if records else 0.0
        if trace_duration <= 0.0:
            # an instantaneous burst (every at_s == 0): fall back to the
            # header's declared span so offered_rate isn't a 1e9 absurdity
            # that no delivery criterion could ever satisfy
            trace_duration = float(header.get("duration_s") or 0.0)
        offered_window = max(trace_duration / speed, 1e-3)
        if arrival_window <= 1e-6:
            # matching fallback on the achieved side: an instantaneous
            # burst issued with ~zero slip must not report an arrival
            # rate of 0 (or 1e9) and flunk the delivery criterion
            arrival_window = offered_window
        lag_sorted = sorted(lags)
        lat_sorted = sorted(all_ok_lat)
        delayed = sum(1 for lag in lag_sorted if lag > 1e-3)
        # stream sessions that failed BEFORE a StreamSpan existed would
        # otherwise vanish from the span-fed ttft/duration verdicts:
        # sample=always means one span per session that got as far as the
        # frontend, so any shortfall vs issued stream records is exactly
        # the spanless failures — count each one bad, same rule as every
        # other errored request
        stream_issued = kind_counts.get("generate_stream", 0)
        if stream_issued:
            self._telemetry._fold_stream_pending()
            spans_finished = sum(
                s.value
                for s in self._telemetry.streams_total._series.values())
            for _ in range(int(max(0, stream_issued - spans_finished))):
                for slo in self._telemetry.slos():
                    if slo.metric in ("ttft_ms", "stream_duration_ms"):
                        slo.observe_failure()
        # the SLO verdicts: stream objectives from the per-run Telemetry
        # (exact bounded-window good/bad counts), request_ms objectives
        # from the per-record feed above, error-rate objectives from the
        # replay's own accounting (shed counts against capacity: a shed
        # request was not served inside SLO)
        slo_rows = self._telemetry.slo_report()
        slo_rows.extend(slo.report() for slo in request_slos)
        bad_fraction = (errored + shed) / issued if issued else 0.0
        for spec in specs:
            if spec.kind != "error_rate":
                continue
            slo_rows.append({
                "slo": spec.name,
                "metric": "error_rate",
                "limit": spec.limit,
                "value": round(bad_fraction, 6),
                "attained": bad_fraction <= spec.limit + 1e-12,
            })
        result = {
            "mode": "trace_replay",
            "protocol": self.protocol,
            "speed": speed,
            "trace": {
                "records": len(records),
                "duration_s": round(trace_duration, 3),
                "kinds": kind_counts,
                "generator": header.get("generator"),
                "spec": header.get("spec"),
                "seed": header.get("seed"),
            },
            "requests": ok,
            "issued": issued,
            "errors": errored,
            "shed": shed,
            "error_rate": round(errored / issued, 6) if issued else 0.0,
            "shed_rate": round(shed / issued, 6) if issued else 0.0,
            "error_sample": errors[0] if errors else None,
            "duration_s": round(elapsed, 3),
            "offered_rate": round(len(records) / offered_window, 1),
            "achieved_rate": round(ok / elapsed, 1) if elapsed > 0 else 0.0,
            "achieved_arrival_rate": round(issued / arrival_window, 1)
            if arrival_window > 0 else 0.0,
            "latency_ms": _latency_ms_row(lat_sorted),
            "kinds": {
                kind: self._kind_row(samples, counts, kind)
                for kind in sorted(kind_counts)
            },
            "schedule_lag_ms": _lag_ms_row(lag_sorted),
            "delayed_pct": round(100.0 * delayed / issued, 1)
            if issued else 0.0,
            "sequence_groups": len(resources.seq_gates),
            "slo": slo_rows,
            "slo_ok": all(row["attained"] for row in slo_rows),
        }
        if resources.pipeline_stage_s:
            # only when the trace carried pipeline records: the per-stage
            # latency waterfall across every measured DAG run
            result["pipeline_stages"] = {
                stage: dict(count=len(vals),
                            **_latency_ms_row(sorted(vals)))
                for stage, vals in
                sorted(resources.pipeline_stage_s.items())
            }
        if tenant_rows:
            # only when the trace carried tenant-attributed records:
            # tenantless replays keep byte-identical result rows
            result["tenants"] = {
                t: {
                    "issued": row["issued"],
                    "ok": row["ok"],
                    "errors": row["errors"],
                    "shed": row["shed"],
                    "shed_by_reason": row["shed_by_reason"],
                    "latency_ms": _latency_ms_row(sorted(row["_lat"])),
                }
                for t, row in sorted(tenant_rows.items())
            }
        if retry_hints:
            # the honest backpressure story: every shed's retry_after_s
            # hint (bucket refill eta / limiter minRTT eta), as ms
            result["shed_retry_after_ms"] = _latency_ms_row(
                sorted(retry_hints))
        return self._observe_result(result)


class _SeqGate:
    """Per-sequence-group ordering: step *k+1* must not hit the wire until
    step *k* completed (the server-side accumulator is ordered state).
    ``broken`` poisons the group after a gate timeout: later steps error
    out instead of being sent into state that never saw the missing
    step."""

    __slots__ = ("cond", "next", "broken")

    def __init__(self):
        self.cond = threading.Condition()
        self.next = 0
        self.broken = False


class _ReplayResources:
    """Shared read-only payload caches for one replay run: one tensor set
    per distinct (model, layout, content key) and one token list per
    distinct (prompt length, content key), all deterministic — keyless
    records draw from the runner's single seeded Generator, keyed records
    (the hot-key workload, format v3) from a per-key generator seeded by
    (runner seed, key) so the SAME key always replays BYTE-IDENTICAL
    bytes, record order be damned."""

    def __init__(self, runner: "PerfRunner", records) -> None:
        self._mod = runner._client_mod
        self._rng = runner.rng
        self._seed = runner.seed
        self._inputs: Dict[Any, list] = {}
        self._tokens: Dict[Any, list] = {}
        self.seq_gates: Dict[int, _SeqGate] = {}
        # the replay's DisaggClient (set by the runner when the trace
        # carries prefill_decode records; closed by the runner)
        self.disagg = None
        # the replay's PipelineClient + per-stage latency accumulator
        # (set by the runner when the trace carries pipeline records)
        self.pipeline = None
        self.pipeline_stage_s: Dict[str, List[float]] = {}
        self._pipeline_lock = threading.Lock()
        self._feeds: Dict[Any, Dict[str, Any]] = {}
        for rec in records:
            if rec.kind == "pipeline":
                self.feeds_for(rec)
                continue
            if rec.kind == "sequence":
                self.seq_gates.setdefault(rec.seq_group, _SeqGate())
            elif rec.kind in ("generate_stream", "prefill_decode"):
                self.tokens_for(rec.prompt_tokens,
                                getattr(rec, "content_key", None))
            if rec.shapes is not None:
                self.inputs_for(rec)

    def _rng_for(self, content_key):
        if content_key is None:
            return self._rng
        from .trace import _key_rng

        return _key_rng(self._seed, content_key)

    def inputs_for(self, rec) -> list:
        content_key = getattr(rec, "content_key", None)
        key = (rec.model, content_key,
               tuple(sorted((name, rec.dtypes[name], tuple(shape))
                            for name, shape in rec.shapes.items())))
        inputs = self._inputs.get(key)
        if inputs is None:
            rng = self._rng_for(content_key)
            inputs = []
            for name in sorted(rec.shapes):
                datatype = rec.dtypes[name]
                shape = list(rec.shapes[name])
                inp = self._mod.InferInput(name, shape, datatype)
                inp.set_data_from_numpy(
                    _random_tensor(datatype, shape, rng))
                inputs.append(inp)
            self._inputs[key] = inputs
        return inputs

    def feeds_for(self, rec) -> Dict[str, Any]:
        """One deterministic ndarray feed dict per distinct pipeline
        record layout (PipelineClient.run() takes host arrays, not
        InferInputs — the client owns the wire staging)."""
        key = (rec.model,
               tuple(sorted((name, rec.dtypes[name], tuple(shape))
                            for name, shape in rec.shapes.items())))
        feeds = self._feeds.get(key)
        if feeds is None:
            feeds = {
                name: _random_tensor(rec.dtypes[name],
                                     list(rec.shapes[name]), self._rng)
                for name in sorted(rec.shapes)}
            self._feeds[key] = feeds
        return feeds

    def record_pipeline(self, result) -> None:
        with self._pipeline_lock:
            for stage, lat_s in result.stage_latency_s.items():
                self.pipeline_stage_s.setdefault(stage, []).append(lat_s)

    def tokens_for(self, prompt_tokens: int, content_key=None) -> list:
        key = (prompt_tokens, content_key)
        tokens = self._tokens.get(key)
        if tokens is None:
            tokens = self._rng_for(content_key).integers(
                0, 256, size=max(1, prompt_tokens), dtype=np.int32).tolist()
            self._tokens[key] = tokens
        return tokens

    def stream_payload(self, rec) -> Dict[str, Any]:
        return {"TOKENS": [self.tokens_for(
                    rec.prompt_tokens, getattr(rec, "content_key", None))],
                "MAX_TOKENS": int(rec.output_tokens)}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="client_tpu_torch.perf",
        description="KServe v2 load generator (perf_analyzer equivalent)")
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("-u", "--url", default="127.0.0.1:8000")
    parser.add_argument(
        "-i", "--protocol", choices=PROTOCOLS, default="http",
        help="native = the C++ client via its C API (HTTP transport); native-grpc / "
             "native-grpc-async its gRPC client, one a worker / one for all workers")
    parser.add_argument(
        "--shared-memory", choices=("none", "system", "cuda"), default="none")
    parser.add_argument(
        "--device", default="cuda",
        help="where --shared-memory cuda stages its inputs (cuda, cuda:N, cpu)")
    parser.add_argument(
        "--concurrency-range", default="1",
        help="start[:end[:step]] concurrency sweep (e.g. 1:8:2)",
    )
    parser.add_argument(
        "--request-rate-range", default=None,
        help="start[:end[:step]] open-loop arrival rate sweep in req/s "
             "(overrides --concurrency-range; perf_analyzer semantics)",
    )
    parser.add_argument(
        "--request-distribution", choices=("constant", "poisson"),
        default="constant",
        help="arrival process for --request-rate-range",
    )
    parser.add_argument(
        "--rate-pool-size", type=int, default=16,
        help="worker pool servicing the open-loop schedule",
    )
    parser.add_argument("--measurement-requests", type=int, default=200)
    parser.add_argument("-b", "--batch-size", type=int, default=0)
    parser.add_argument(
        "--shape", action="append", default=[],
        help="override an input shape: NAME:d1,d2,...",
    )
    parser.add_argument("-f", "--format", choices=("table", "json"), default="table")
    parser.add_argument("--warmup-requests", type=int, default=10)
    parser.add_argument(
        "--retries", type=int, default=0,
        help="arm a resilience RetryPolicy with N re-attempts on every "
             "measurement client (benchmarks the policy-path overhead)",
    )
    parser.add_argument(
        "--chaos", default=None,
        help="route measurement traffic through the in-process fault "
             "proxy: none|latency:S|reset:N|stall:N|flap:K|blackhole "
             "(none = clean proxy, for topology-identical baselines)",
    )
    parser.add_argument(
        "--endpoints", default=None,
        help="comma-separated replica urls: measurement clients become "
             "health-aware PoolClients over them (-u stays the "
             "control-plane address; see client_tpu_torch.pool)",
    )
    parser.add_argument(
        "--hedge", action="store_true",
        help="arm hedged requests on the pool (requires --endpoints)",
    )
    parser.add_argument(
        "--hedge-delay", type=float, default=None,
        help="hedge delay in seconds (default: rolling p95 of recent "
             "latencies)",
    )
    parser.add_argument(
        "--observe", action="store_true",
        help="enable client telemetry (observe.Telemetry, sample=always) "
             "during measurement and append a client-phase p50/p99 "
             "breakdown (serialize/ttfb/recv/deserialize) to each result; "
             "with --generate-stream, also a ttft/itl breakdown "
             "(client_stream_ms)",
    )
    parser.add_argument(
        "--flight", action="store_true",
        help="attach a flight recorder (client_tpu_torch.flight) to every "
             "measurement run and append a client_flight row "
             "(events/request, retained fraction by verdict, commit "
             "p50/p99 cost) to each result",
    )
    parser.add_argument(
        "--validate", action="store_true",
        help="append a client_integrity row to each result: this run's "
             "contract-validation delta (results checked, checks, "
             "violations by kind) plus the measured per-response "
             "validation overhead (ns p50/p99)",
    )
    parser.add_argument(
        "--generate-stream", action="store_true",
        help="measure streamed generations instead of unary infers: each "
             "request drives one generate-extension SSE session to "
             "exhaustion (http protocol only; latency_ms = session e2e)",
    )
    parser.add_argument(
        "--coalesce", action="store_true",
        help="wrap measurement clients in the micro-batching dispatcher "
             "(client_tpu_torch.batch): concurrent workers share coalesced "
             "wire requests; result rows gain achieved batch-size p50/p99",
    )
    parser.add_argument(
        "--batch-window-us", type=float, default=None,
        help="fixed coalescing window in microseconds (default: adaptive, "
             "tuned from the observed arrival rate)",
    )
    parser.add_argument(
        "--batch-max", type=int, default=32,
        help="row cap per coalesced request (size to the model's "
             "max_batch_size)",
    )
    parser.add_argument(
        "--routing", default=None,
        choices=("round_robin", "least_outstanding", "weighted",
                 "orca_weighted", "affinity"),
        help="pool routing policy (requires --endpoints); orca_weighted "
             "feeds smooth-WRR weights from the servers' ORCA "
             "endpoint-load-metrics reports, falling back to "
             "least_outstanding while loads are stale or absent; "
             "affinity rendezvous-hashes a session/prefix key "
             "(--affinity-key, or a trace record's content_key) onto a "
             "home replica with deterministic bounded-load fallback")
    parser.add_argument(
        "--cache", action="store_true",
        help="wrap measurement clients in the bounded response cache "
             "(client_tpu_torch.cache): repeated content keys are served "
             "client-side as zero-copy arena views; result rows gain "
             "client_cache (hit rate, collapse ratio, resident bytes)")
    parser.add_argument(
        "--cache-ttl", type=float, default=30.0,
        help="response-cache TTL in seconds (with --cache)")
    parser.add_argument(
        "--singleflight", action="store_true",
        help="collapse concurrent identical infers onto one wire request "
             "(client_tpu_torch.cache; combine with --cache for the full "
             "hot-key layer)")
    parser.add_argument(
        "--affinity-key", default=None,
        help="session key for --routing affinity on the closed/open-loop "
             "paths: 'worker' = one key per worker thread, anything else "
             "= one shared literal key; trace replay instead threads "
             "each record's content_key automatically")
    parser.add_argument(
        "--admission", action="store_true",
        help="arm the pool's adaptive admission controller "
             "(client_tpu_torch.admission): saturated/deadline-infeasible "
             "requests are shed with a typed AdmissionRejected, counted "
             "as shed (never error) in every result row")
    parser.add_argument(
        "--admission-mode", choices=("aimd", "gradient"), default="aimd")
    parser.add_argument(
        "--admission-target-ms", type=float, default=None,
        help="SLO latency target the limiter defends (default: a minRTT "
             "EWMA tolerance band)")
    parser.add_argument(
        "--tenancy", default=None,
        help="per-tenant QoS spec for the admission controller "
             "(client_tpu_torch.tenancy; requires --admission), e.g. "
             "'t0,rate=50,weight=2;adv0,rate=50': weighted-fair "
             "queueing + token-bucket quotas; over-quota requests shed "
             "typed over_quota with an honest retry_after. Trace replay "
             "threads each record's tenant (format v4) automatically")
    parser.add_argument(
        "--endpoint-limits", action="store_true",
        help="arm a per-endpoint adaptive concurrency limit (selection "
             "skips replicas at their limit; requires --endpoints)")
    parser.add_argument(
        "--stream-prompt-tokens", type=int, default=32,
        help="prompt length for --generate-stream sessions")
    parser.add_argument(
        "--stream-output-tokens", type=int, default=16,
        help="generated tokens per --generate-stream session")
    parser.add_argument(
        "--seed", type=int, default=0,
        help="seed for EVERY stochastic path: generated tensors, the "
             "open-loop poisson schedule, and --trace-gen traces all draw "
             "from one numpy Generator — same seed, same spec => same run")
    parser.add_argument(
        "--trace", default=None,
        help="replay a JSONL workload trace (client_tpu_torch.trace "
             "format): arrivals are scheduled open-loop at at_s/--speed; "
             "unary, generate_stream and sequence records run concurrently")
    parser.add_argument(
        "--trace-gen", default=None,
        help="generate-and-replay a trace from a spec, e.g. "
             "'mixed:duration_s=10,rate=50,stream_fraction=0.2,"
             "seq_fraction=0.1' (generators: poisson_burst, heavy_tail, "
             "mixed; seeded by --seed)")
    parser.add_argument(
        "--speed", type=float, default=1.0,
        help="trace replay speed multiplier (2.0 = twice the offered rate)")
    parser.add_argument(
        "--replay-workers", type=int, default=32,
        help="worker pool servicing the trace replay schedule")
    parser.add_argument(
        "--slo", action="append", default=[],
        help="declare an SLO for the replay verdict (repeatable): "
             "ttft_p95<200ms, p99<50ms, itl_p99<20ms, error_rate<0.1%%")
    parser.add_argument(
        "--shard-layout", default=None,
        help="scatter-gather every infer across --endpoints per this "
             "layout spec, e.g. 'TOKENS=0->LOGITS=0,NEXT_TOKEN=0' "
             "(tensor=axis pairs, 'r' = replicated, inputs->outputs; "
             "shard i pins to the i-th --endpoints url; rejects --hedge/"
             "--coalesce; also required to replay 'sharded' trace "
             "records — see client_tpu_torch.shard)")
    parser.add_argument(
        "--roles", default=None, metavar="SPEC",
        help="role-labeled endpoints for disaggregated prefill/decode "
             "replay: 'prefill=u1+u2;decode=u3' builds a DisaggClient "
             "over them so 'prefill_decode' trace records (format v5) "
             "replay as two-leg sessions (client_tpu_torch.disagg)")
    parser.add_argument(
        "--pipeline", default=None, metavar="SPEC",
        help="model-DAG spec for replaying 'pipeline' trace records "
             "(format v6) as client-orchestrated graphs with "
             "arena-resident intermediates: 'chain' (the zoo's "
             "tokenize->embed->rerank chain) or an inline graph spec "
             "(client_tpu_torch.pipeline); result rows gain per-stage "
             "latency columns under 'pipeline_stages'")
    parser.add_argument(
        "--cells", default=None, metavar="SPEC",
        help="multi-cell federation: 'a=u1+u2;b=u3' builds a "
             "FederatedClient over named cells, each its own PoolClient "
             "(routing/admission/endpoint-limit flags apply per cell); "
             "locality-first with transparent spillover "
             "(client_tpu_torch.federation); result rows gain "
             "client_federation")
    parser.add_argument(
        "--home-cell", default=None,
        help="the locality-preferred cell (default: first in --cells)")
    parser.add_argument(
        "--shadow-cell", default=None,
        help="mirror a sampled fraction of successful infers to this "
             "cell (responses compared+counted, never returned)")
    parser.add_argument(
        "--shadow-ratio", type=float, default=0.05,
        help="sampled mirror fraction for --shadow-cell")
    parser.add_argument(
        "--canary-cell", default=None,
        help="weighted canary split to this cell with SLO-burn "
             "auto-rollback")
    parser.add_argument(
        "--canary-weight", type=float, default=0.1,
        help="canary traffic weight in [0,1]")
    parser.add_argument(
        "--canary-slo", default=None,
        help="canary burn objective, e.g. 'p95<100ms' "
             "(default p95<250ms)")
    parser.add_argument(
        "--canary-min-events", type=int, default=20,
        help="canary outcomes required before a burn may roll back")
    parser.add_argument(
        "--watch", action="store_true",
        help="arm a continuous Watchtower (client_tpu_torch.watch: multi-"
             "window SLO burn, watermark gauges, changepoint detectors) "
             "on each measurement run and append a client_watch block "
             "(alerts fired/resolved by kind, tick overhead p50/p99, "
             "changepoint trips) to every result row — closed-loop, "
             "open-loop and trace replay alike")
    args = parser.parse_args(argv)

    if args.trace and args.trace_gen:
        parser.error("--trace and --trace-gen are mutually exclusive")

    parts = [int(x) for x in args.concurrency_range.split(":")]
    start = parts[0]
    end = parts[1] if len(parts) > 1 else start
    step = parts[2] if len(parts) > 2 else 1
    shape_overrides = {}
    for s in args.shape:
        name, _, dims = s.partition(":")
        shape_overrides[name] = [int(d) for d in dims.split(",")]

    runner = PerfRunner(
        args.url, args.protocol, args.model_name, args.shared_memory,
        shape_overrides, args.batch_size, seed=args.seed,
        retries=args.retries, chaos=args.chaos,
        endpoints=[u.strip() for u in args.endpoints.split(",") if u.strip()]
        if args.endpoints else None,
        hedge=args.hedge, hedge_delay_s=args.hedge_delay,
        observe=args.observe,
        generate_stream=args.generate_stream,
        stream_prompt_tokens=args.stream_prompt_tokens,
        stream_output_tokens=args.stream_output_tokens,
        coalesce=args.coalesce,
        batch_window_us=args.batch_window_us,
        batch_max=args.batch_max,
        routing=args.routing,
        admission=args.admission,
        admission_mode=args.admission_mode,
        admission_target_ms=args.admission_target_ms,
        tenancy=args.tenancy,
        endpoint_limits=args.endpoint_limits,
        shard_layout=args.shard_layout,
        cache=args.cache,
        cache_ttl_s=args.cache_ttl,
        singleflight=args.singleflight,
        affinity_key=args.affinity_key,
        flight=args.flight,
        cells=args.cells,
        home_cell=args.home_cell,
        shadow_cell=args.shadow_cell,
        shadow_ratio=args.shadow_ratio,
        canary_cell=args.canary_cell,
        canary_weight=args.canary_weight,
        canary_slo=args.canary_slo,
        canary_min_events=args.canary_min_events,
        roles=args.roles,
        pipeline=args.pipeline,
        validate=args.validate,
        watch=args.watch,
        device=args.device,
        colocated=False,  # the server is another process: it reads the host window
    )
    try:
        # trace mode does its own per-(kind, model) warmup inside
        # run_trace — a closed-loop warmup against --model-name here would
        # hit an unrelated model (or fail outright when the server only
        # serves the trace's models)
        if args.warmup_requests and not (args.trace or args.trace_gen):
            runner.run(1, args.warmup_requests)

        results = []
        if args.trace or args.trace_gen:
            from . import trace as trace_mod

            if args.trace:
                tr = trace_mod.load_trace(args.trace)
            else:
                tr = trace_mod.generate(args.trace_gen, seed=args.seed)
            results.append(runner.run_trace(
                tr, speed=args.speed, replay_workers=args.replay_workers,
                slos=args.slo))
        elif args.request_rate_range is not None:
            rparts = [float(x) for x in args.request_rate_range.split(":")]
            rstart = rparts[0]
            rend = rparts[1] if len(rparts) > 1 else rstart
            rstep = rparts[2] if len(rparts) > 2 else 1.0
            if rstep <= 0:
                # match the closed-loop path, where range() rejects step=0
                raise ValueError("--request-rate-range step must be > 0")
            rate = rstart
            while rate <= rend + 1e-9:
                results.append(runner.run_rate(
                    rate, args.measurement_requests,
                    distribution=args.request_distribution,
                    pool_size=args.rate_pool_size))
                rate += rstep
        else:
            for concurrency in range(start, end + 1, step):
                results.append(runner.run(concurrency, args.measurement_requests))
    finally:
        runner.close()

    if args.format == "json":
        print(json.dumps(results))
    elif args.trace or args.trace_gen:
        for r in results:
            t = r["trace"]
            print(
                f"trace replay: {t['records']} records over "
                f"{t['duration_s']}s at speed {r['speed']} "
                f"(kinds: {t['kinds']})")
            print(
                f"offered={r['offered_rate']}/s achieved="
                f"{r['achieved_rate']}/s errors={r['errors']} "
                f"shed={r['shed']} lag_p99="
                f"{r['schedule_lag_ms']['p99']}ms "
                f"lag_max={r['schedule_lag_ms']['max']}ms "
                f"late%={r['delayed_pct']}")
            print(f"{'kind':>16} {'req':>6} {'ok':>6} {'err':>5} "
                  f"{'shed':>5} {'p50 ms':>8} {'p99 ms':>8}")
            for kind, row in r["kinds"].items():
                lm = row["latency_ms"]
                print(f"{kind:>16} {row['requests']:>6} {row['ok']:>6} "
                      f"{row['errors']:>5} {row['shed']:>5} "
                      f"{lm['p50']:>8} {lm['p99']:>8}")
            stream = r.get("client_stream_ms")
            if stream:
                for metric, row in stream.items():
                    print(f"  {metric}: p50={row['p50']} p99={row['p99']}")
            for row in r["slo"]:
                verdict = "OK " if row["attained"] else "MISS"
                if row["metric"] == "error_rate":
                    print(f"  SLO {verdict} {row['slo']}: "
                          f"value={row['value']} limit={row['limit']}")
                else:
                    print(f"  SLO {verdict} {row['slo']}: good={row['good']} "
                          f"bad={row['bad']} burn={row['burn_rate']}")
            print(f"slo_ok={r['slo_ok']}")
    elif args.request_rate_range is not None:
        print(
            f"model={args.model_name} protocol={args.protocol} "
            f"shared_memory={args.shared_memory} "
            f"distribution={args.request_distribution}"
        )
        print(f"{'rate':>7} {'ach':>7} {'p50 ms':>8} {'p90 ms':>8} {'p99 ms':>8} "
              f"{'lag p99':>8} {'late%':>6} {'err':>4} {'shed':>5}")
        for r in results:
            lm = r["latency_ms"]
            print(
                f"{r['request_rate']:>7} {r['achieved_rate']:>7} {lm['p50']:>8} "
                f"{lm['p90']:>8} {lm['p99']:>8} "
                f"{r['schedule_lag_ms']['p99']:>8} {r['delayed_pct']:>6} "
                f"{r['errors']:>4} {r['shed']:>5}"
            )
    else:
        print(
            f"model={args.model_name} protocol={args.protocol} "
            f"shared_memory={args.shared_memory}"
        )
        print(f"{'conc':>5} {'infer/s':>9} {'avg ms':>8} {'p50 ms':>8} {'p90 ms':>8} "
              f"{'p99 ms':>8} {'err':>4} {'shed':>5}")
        for r in results:
            lm = r["latency_ms"]
            print(
                f"{r['concurrency']:>5} {r['infer_per_sec']:>9} {lm['avg']:>8} "
                f"{lm['p50']:>8} {lm['p90']:>8} {lm['p99']:>8} {r['errors']:>4} "
                f"{r.get('shed', 0):>5}"
            )
    return 1 if any(r["errors"] and not r["requests"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
