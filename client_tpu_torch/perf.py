"""Perf harness: the framework's perf_analyzer equivalent.

The port of ``client_tpu.perf``: a load generator with perf_analyzer's core
controls — concurrency sweep, infer/sec, p50/p90/p99 latency, and a
``--shared-memory={none,system,cuda}`` data-plane switch (the JAX package's
``tpu`` mode is ``cuda`` here). Beside the closed loop it runs the open
loop at a fixed arrival rate (``--request-rate-range``, constant or
poisson) and the replay of a seeded workload trace (``--trace`` /
``--trace-gen``, ``client_tpu_torch.trace``) against one endpoint, with
``--generate-stream``, ``--observe``, ``--flight``, ``--validate``,
``--chaos`` and ``--retries``. The result rows carry the JAX package's
keys.

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

Flags whose layers the port does not have yet raise ``NotImplementedError``
naming their ROADMAP item: the pool, routing, admission, hedging,
coalescing, caching and tenancy flags (A7); federation cells, shard
layouts, roles, pipelines and ``--watch`` (A8); the native protocols (A10).
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

# the protocols the JAX harness has; the native ones wait for ROADMAP A10
PROTOCOLS = ("http", "grpc", "native", "native-grpc", "native-grpc-async")
PYTHON_PROTOCOLS = ("http", "grpc")


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


def _not_ported(flag: str, layer: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs {layer}, which the port does not have yet "
        f"(ROADMAP {item})")


def _check_ported(protocol: str, flags: Dict[str, Any]) -> None:
    """Raise for the first requested flag whose layer is not ported."""
    layers = {
        "--endpoints": ("the replica pool (pool.PoolClient)", "A7"),
        "--hedge": ("the pool's hedging (pool.HedgePolicy)", "A7"),
        "--routing": ("the pool's routing policies", "A7"),
        "--admission": ("the pool's admission wiring (pool, admission)", "A7"),
        "--tenancy": ("tenancy.TenancyPolicy", "A7"),
        "--endpoint-limits": ("the pool's endpoint limits", "A7"),
        "--affinity-key": ("the pool's affinity routing", "A7"),
        "--coalesce": ("the coalescing dispatcher (batch.BatchingClient)", "A7"),
        "--cache": ("the response cache (cache.CachingClient)", "A7"),
        "--singleflight": ("singleflight (cache.CachingClient)", "A7"),
        "--cells": ("federation cells (federation.FederatedClient)", "A8"),
        "--home-cell": ("federation cells (federation.FederatedClient)", "A8"),
        "--shadow-cell": ("federation cells (federation.FederatedClient)", "A8"),
        "--canary-cell": ("federation cells (federation.FederatedClient)", "A8"),
        "--shard-layout": ("sharded scatter-gather (shard.ShardedClient)", "A8"),
        "--roles": ("disaggregated serving (disagg.DisaggClient)", "A8"),
        "--pipeline": ("model-DAG pipelines (pipeline.PipelineClient)", "A8"),
        "--watch": ("continuous monitoring (watch.Watchtower)", "A8"),
    }
    for flag, value in flags.items():
        if value:
            layer, item = layers[flag]
            raise _not_ported(flag, layer, item)
    if protocol not in PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r} (one of {', '.join(PROTOCOLS)})")
    if protocol not in PYTHON_PROTOCOLS:
        raise _not_ported(f"-i {protocol}", "the native clients (native.py)", "A10")


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

        The pool, routing, admission, hedging, coalescing, caching and
        tenancy arguments (ROADMAP A7), the federation, shard, roles,
        pipeline and watch arguments (A8) and the native protocols (A10)
        raise ``NotImplementedError``."""
        _check_ported(protocol, {
            "--endpoints": endpoints, "--hedge": hedge or hedge_delay_s is not None,
            "--routing": routing, "--admission": admission, "--tenancy": tenancy,
            "--endpoint-limits": endpoint_limits, "--affinity-key": affinity_key,
            "--coalesce": coalesce, "--cache": cache, "--singleflight": singleflight,
            "--cells": cells, "--home-cell": home_cell, "--shadow-cell": shadow_cell,
            "--canary-cell": canary_cell, "--shard-layout": shard_layout,
            "--roles": roles, "--pipeline": pipeline, "--watch": watch,
        })
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
        self.observe = observe
        self.observe_sample = observe_sample
        # --flight: attach a flight recorder to every measurement run's
        # telemetry and append a client_flight row (events/request,
        # retained fraction, commit cost) to each result
        self.flight = flight
        self.generate_stream = generate_stream
        self.validate = validate
        self.seed = seed
        self.device = torch.device(device)
        self.colocated = colocated
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
        if self.protocol == "http":
            from . import http as mod
        else:
            from . import grpc as mod
        return mod

    def _make_client(self, concurrency: int = 1):
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
        return client

    def _control_client(self):
        """(client, module) for metadata/probing: the protocol's own python
        client. Always dials the server directly (never the chaos proxy)."""
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
        """ONE shared setup path for every shm mode (system / cuda): leases
        input+output slabs from the runner's arena, writes each payload
        once, and lets the (cached) registration machinery issue the
        register RPC only on a region's first use per endpoint. A cuda
        input is staged on the runner's device and the copy waited for
        before timing starts. Returns (inputs, outputs_or_None, cleanup)."""
        from .utils import numpy_to_tensor, serialized_byte_size

        family = self.shared_memory
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
                # bind_input attaches the lease, so infer() ensures the
                # (cached) registration against the endpoint
                inputs.append(lease.bind_input(
                    mod.InferInput(name, shape, datatype)))
            outputs = []
            for name, nbytes in self._output_sizes.items():
                lease = arena.lease(nbytes, family=family)
                leases.append(lease)
                outputs.append(lease.bind_output(
                    mod.InferRequestedOutput(name)))
        except Exception:
            cleanup()
            raise
        return inputs, outputs or None, cleanup

    # -- one worker --------------------------------------------------------
    def _worker_setup(self, client, worker_id):
        """Per-worker tensor/shm setup shared by the closed-loop
        (concurrency) and open-loop (request-rate) workers.

        Returns (inputs, outputs, shm_cleanup)."""
        if self.shared_memory in ("system", "cuda"):
            return self._shm_worker_setup(client, worker_id)
        inputs = []
        for name, datatype, shape, data in self._tensors:
            inp = self._client_mod.InferInput(name, shape, datatype)
            inp.set_data_from_numpy(data)
            inputs.append(inp)
        return inputs, None, None

    def _worker(self, client, barrier, stop, latencies, errors, sheds,
                counter, worker_id):
        from .admission import AdmissionRejected
        from .resilience import CircuitOpenError

        shm_ctx = None
        setup_failed = False
        try:
            inputs, outputs, shm_ctx = self._worker_setup(client, worker_id)
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
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    self._infer_once(client, inputs, outputs)
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
        setup_failed = False
        try:
            inputs, outputs, shm_ctx = self._worker_setup(client, worker_id)
        except Exception as e:
            errors.append(f"worker setup failed: {e}")
            setup_failed = True
        try:
            barrier.wait(timeout=120)
            if setup_failed:
                stop.set()
                return
            lock, idx = cursor
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
                    self._infer_once(client, inputs, outputs)
                    records.append(time.perf_counter() - t1)
                except (CircuitOpenError, AdmissionRejected) as e:
                    sheds.append(str(e))  # deliberate shedding, not error
                except Exception as e:  # measured as failure, loop continues
                    errors.append(str(e))
        finally:
            if shm_ctx is not None:
                shm_ctx()

    def _infer_once(self, client, inputs, outputs=None):
        if self.generate_stream:
            # one "request" = one fully-drained SSE generation session
            for _event in client.generate_stream(
                    self.model_name, self._stream_payload):
                pass
            return
        client.infer(self.model_name, inputs, outputs=outputs)

    def _arm_telemetry(self, measurement_requests: int):
        """A fresh Telemetry per measurement run (sample=always, ring sized
        to hold every request) so each result row's phase breakdown covers
        exactly that run."""
        if not (self.observe or self.flight):
            return
        from .observe import Telemetry

        self._telemetry = Telemetry(
            # --flight without --observe keeps span retention off: the
            # recorder's own tail ring is the retention mechanism
            sample=self.observe_sample if self.observe else "off",
            trace_capacity=max(measurement_requests, 1024),
            flight=self._make_flight())

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
        client.close()

        lat_sorted = sorted(latencies)
        n = len(lat_sorted)
        issued = n + len(errors) + len(sheds)
        return self._integrity_result(self._shm_result(self._observe_result({
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
        }), shm_rec, shm_before), integrity_before)

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
        return self._integrity_result(self._shm_result(self._observe_result({
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
        }), shm_rec, shm_before), integrity_before)

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

        ``sharded``, ``prefill_decode`` and ``pipeline`` records (ROADMAP
        A8) and tenant-attributed records (the ``tenant=`` keyword of
        tenancy, A7) raise ``NotImplementedError``."""
        from .observe import SLO, SLOSpec, parse_slo_spec, Telemetry
        from .trace import Trace

        if speed <= 0:
            raise ValueError("speed must be > 0")
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
        for kind, layer in (("sharded", "sharded scatter-gather (shard.ShardedClient)"),
                            ("prefill_decode", "disaggregated serving (disagg.DisaggClient)"),
                            ("pipeline", "model-DAG pipelines (pipeline.PipelineClient)")):
            if any(r.kind == kind for r in records):
                raise _not_ported(f"replaying {kind} records", layer, "A8")
        if any(getattr(r, "tenant", None) is not None for r in records):
            raise _not_ported("replaying tenant-attributed records",
                              "the clients' tenant= keyword (tenancy)", "A7")
        if (any(r.kind == "generate_stream" for r in records)
                and self.protocol != "http"):
            raise ValueError(
                "trace contains generate_stream records: the generate "
                "extension is an HTTP SSE surface (use -i http)")
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
            flight=self._make_flight())
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
            return self._run_trace_workers(
                header, records, speed, replay_workers, specs, on_result,
                warmup, trace_duration, request_slos,
                _ReplayResources(self, records))
        finally:
            if not self.observe:
                # the per-run Telemetry must not leak into later run()/
                # run_rate() calls on a runner that never asked for
                # telemetry — on ANY exit path, including errors
                self._telemetry = None

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
                self._replay_warmup(warm_client, records, resources)
            finally:
                warm_client.close()
                self._telemetry = saved_telemetry
        # capture AFTER warmup: warmup traffic is contract-checked too
        # and must not pollute the measured row's validation delta
        integrity_before = self._integrity_stats()
        client = self._make_client(replay_workers)
        try:
            outcomes: List[Tuple[str, str, float, float, float]] = []
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
        finally:
            client.close()
        return self._integrity_result(self._trace_result(
            header, records, speed, elapsed, outcomes, errors, specs,
            resources, request_slos), integrity_before)

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
                    client.infer(
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
                status = "error"
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
            outcomes.append(
                (rec.kind, status, time.perf_counter() - t1, lag,
                 rec.at_s / speed))
            if on_result is not None:
                on_result(rec, outcome)

    def _replay_dispatch(self, client, rec, resources):
        if rec.kind == "generate_stream":
            events = []
            for event in client.generate_stream(
                    rec.model, resources.stream_payload(rec),
                    model_version=rec.version):
                events.append(event)
            return events
        inputs = resources.inputs_for(rec)
        if rec.kind == "sequence":
            return client.infer(
                rec.model, inputs,
                model_version=rec.version,
                sequence_id=rec.seq_group,
                sequence_start=rec.seq_index == 0,
                sequence_end=rec.seq_index == rec.seq_len - 1)
        return client.infer(rec.model, inputs, model_version=rec.version)

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
        for kind, status, lat_s, lag_s, at_rel_s in outcomes:
            kind_counts[kind] = kind_counts.get(kind, 0) + 1
            counts[(kind, status)] = counts.get((kind, status), 0) + 1
            samples.setdefault((kind, status), []).append(lat_s)
            if status == "ok":
                all_ok_lat.append(lat_s)
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
        for rec in records:
            if rec.kind == "sequence":
                self.seq_gates.setdefault(rec.seq_group, _SeqGate())
            elif rec.kind == "generate_stream":
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
        help="http or grpc (the native protocols wait for ROADMAP A10)")
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
    # the JAX harness's flags whose layers are not ported: accepted, and
    # PerfRunner raises NotImplementedError naming their ROADMAP item
    not_ported = parser.add_argument_group(
        "not ported yet", "raise NotImplementedError (ROADMAP A7 / A8)")
    for flag in ("--endpoints", "--routing", "--tenancy", "--affinity-key",
                 "--shard-layout", "--cells", "--home-cell", "--shadow-cell",
                 "--canary-cell", "--roles", "--pipeline"):
        not_ported.add_argument(flag, default=None)
    for flag in ("--hedge", "--admission", "--endpoint-limits", "--coalesce",
                 "--cache", "--singleflight", "--watch"):
        not_ported.add_argument(flag, action="store_true")
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
        hedge=args.hedge,
        observe=args.observe,
        generate_stream=args.generate_stream,
        stream_prompt_tokens=args.stream_prompt_tokens,
        stream_output_tokens=args.stream_output_tokens,
        coalesce=args.coalesce,
        routing=args.routing,
        admission=args.admission,
        tenancy=args.tenancy,
        endpoint_limits=args.endpoint_limits,
        shard_layout=args.shard_layout,
        cache=args.cache,
        singleflight=args.singleflight,
        affinity_key=args.affinity_key,
        flight=args.flight,
        cells=args.cells,
        home_cell=args.home_cell,
        shadow_cell=args.shadow_cell,
        canary_cell=args.canary_cell,
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
