"""Protocol-neutral server core: model registry, shm data plane, infer.

The counterpart of ``client_tpu.server.core``. The HTTP and GRPC frontends
marshal requests into the neutral dict shape consumed by
:meth:`ServerCore.infer`; the core resolves shared-memory placement, runs
the model (sequence parameters pass through to it; decoupled models stream),
applies the classification extension and keeps per-model statistics. Model
outputs may be torch tensors: they reach the wire as host bytes, or stay on
the device when the output lands in a cuda shared-memory region.

The admin surface is the JAX core's: the repository index, load (with a
config override) and unload, statistics, trace settings (with the trace
records they switch on) and log settings. So is its observability surface:
traceparent-joined access records, the ``metrics_registry`` the HTTP
frontend serves at ``/metrics``, and the per-response ORCA load report.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.base import Model
from ..ops import topk_classification
from ..utils import (
    deserialize_bf16_tensor,
    deserialize_bytes_tensor,
    np_to_triton_dtype,
    serialize_bf16_tensor,
    serialize_byte_tensor,
    tensor_to_numpy,
    torch_to_triton_dtype,
    triton_to_np_dtype,
)


class InferError(Exception):
    """Server-side inference failure with an HTTP-ish status code."""

    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status


def _to_host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return tensor_to_numpy(value)
    return np.asarray(value)


def _triton_dtype(value) -> Optional[str]:
    if isinstance(value, torch.Tensor):
        return torch_to_triton_dtype(value.dtype)
    return np_to_triton_dtype(value.dtype)


class _Region:
    """A registered system shared-memory region the server can read/write."""

    def __init__(self, name: str, family: str, key: str, offset: int,
                 byte_size: int, device_id: int = 0):
        self.name = name
        self.family = family
        self.key = key
        self.offset = offset
        self.byte_size = byte_size
        self.device_id = device_id
        self._shm = None

    def _buffer(self) -> memoryview:
        if self._shm is None:
            from ..utils.shared_memory import attach_shared_memory

            self._shm = attach_shared_memory(self.key)
        return self._shm.buf

    def check_range(self, nbytes: int, offset: int, op: str) -> int:
        if offset < 0 or nbytes < 0 or nbytes + offset > self.byte_size:
            raise InferError(
                f"shared-memory {op} of {nbytes}B at offset {offset} exceeds "
                f"region '{self.name}' ({self.byte_size}B)", 400,
            )
        return self.offset + offset

    def read(self, byte_size: int, offset: int) -> memoryview:
        base = self.check_range(byte_size, offset, "read")
        return self._buffer()[base : base + byte_size]

    def write(self, data: bytes, offset: int) -> None:
        base = self.check_range(len(data), offset, "write")
        self._buffer()[base : base + len(data)] = data

    def read_tensor(self, datatype: str, shape, byte_size: int, offset: int):
        """Materialize a tensor of ``datatype``/``shape`` from the region."""
        return _bytes_to_array(bytearray(self.read(byte_size, offset)), datatype, shape)

    def write_tensor(self, arr, datatype: str, offset: int, limit: int, name: str = "?") -> int:
        """Serialize ``arr`` into the region; returns bytes written."""
        payload = _array_to_bytes(_to_host(arr), datatype)
        if len(payload) > limit:
            raise InferError(
                f"output '{name}' ({len(payload)}B) exceeds shared-memory region "
                f"allotment of {limit}B", 400,
            )
        self.write(payload, offset)
        return len(payload)

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close()
            self._shm = None

    def status(self) -> Dict[str, Any]:
        if self.family == "system":
            return {
                "name": self.name,
                "key": self.key,
                "offset": self.offset,
                "byte_size": self.byte_size,
            }
        return {
            "name": self.name,
            "device_id": self.device_id,
            "byte_size": self.byte_size,
        }


class _CudaRegion(_Region):
    """A registered cuda_shared_memory region — the device-aware data plane.

    In-process registrations resolve to the client's own
    ``CudaSharedMemoryRegion`` object, so tensors bound with
    ``set_shared_memory_region_from_torch`` reach the model as those very
    tensors (zero copies) and torch outputs are pinned back into the region's
    device cache. A region registered from another process is read through
    its host window onto the server's device.
    """

    def __init__(self, name: str, raw_handle_b64: str, device_id: int,
                 byte_size: int, device):
        from ..utils.cuda_shared_memory import attach_from_raw_handle

        self._region = attach_from_raw_handle(raw_handle_b64, device=device.type)
        super().__init__(name, "cuda", self._region.shm_key, 0, byte_size, device_id)

    def read(self, byte_size: int, offset: int) -> memoryview:
        return self._region.read_host(byte_size, offset)

    def write(self, data: bytes, offset: int) -> None:
        self._region.write_host(data, offset)

    def read_tensor(self, datatype: str, shape, byte_size: int, offset: int):
        if datatype == "BYTES":
            return super().read_tensor(datatype, shape, byte_size, offset)
        from ..utils.cuda_shared_memory import get_contents_as_torch

        nbytes = int(np.prod(shape)) * np.dtype(triton_to_np_dtype(datatype)).itemsize
        if nbytes > byte_size:
            raise InferError(
                f"shm input needs {nbytes}B for shape {list(shape)} {datatype} but "
                f"only {byte_size}B were supplied", 400,
            )
        return get_contents_as_torch(self._region, datatype, shape, offset)

    def write_tensor(self, arr, datatype: str, offset: int, limit: int, name: str = "?") -> int:
        if datatype != "BYTES" and isinstance(arr, torch.Tensor):
            from ..utils.cuda_shared_memory import set_shared_memory_region_from_torch

            nbytes = arr.element_size() * arr.numel()
            if nbytes > limit:
                raise InferError(
                    f"output '{name}' ({nbytes}B) exceeds shared-memory region "
                    f"allotment of {limit}B", 400,
                )
            set_shared_memory_region_from_torch(self._region, arr, offset)
            return nbytes
        return super().write_tensor(arr, datatype, offset, limit, name)

    def close(self) -> None:
        self._region.detach()


class _ModelStats:
    """One model's inference statistics (the protocol's ModelStatistics)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inference_count = 0
        self.execution_count = 0
        self.last_inference = 0
        self.success = [0, 0]  # count, ns
        self.fail = [0, 0]
        # client cancel/disconnect mid-stream: neither a success nor a
        # model failure
        self.cancel = [0, 0]
        self.compute_infer = [0, 0]
        self.queue = [0, 0]
        self.batches: Dict[int, List[int]] = {}  # batch_size -> [count, ns]

    def record(self, ok: bool, total_ns: int, infer_ns: int, batch: int,
               executed: bool = True) -> None:
        """``executed=False`` for dynamically batched requests: the model
        execution is counted once by record_batch, not once per request
        (execution_count < inference_count under batching)."""
        with self.lock:
            if ok:
                self.inference_count += batch
                if executed:
                    self.execution_count += 1
                    self.compute_infer[0] += 1
                    self.compute_infer[1] += infer_ns
                self.last_inference = int(time.time() * 1000)
                self.success[0] += 1
                self.success[1] += total_ns
            else:
                self.fail[0] += 1
                self.fail[1] += total_ns

    def record_cancel(self, total_ns: int) -> None:
        with self.lock:
            self.cancel[0] += 1
            self.cancel[1] += total_ns
            self.last_inference = int(time.time() * 1000)

    def record_batch(self, batch_size: int, exec_ns: int, queue_ns: int,
                     n_requests: int) -> None:
        """One dynamic-batcher execution (InferBatchStatistics feed).

        ``queue`` counts per request (the average must be a request's wait,
        not the batch's summed waits)."""
        with self.lock:
            row = self.batches.setdefault(batch_size, [0, 0])
            row[0] += 1
            row[1] += exec_ns
            self.queue[0] += n_requests
            self.queue[1] += queue_ns
            self.execution_count += 1
            self.compute_infer[0] += 1
            self.compute_infer[1] += exec_ns

    def as_dict(self, name: str, version: str) -> Dict[str, Any]:
        with self.lock:
            return {
                "name": name,
                "version": version,
                "last_inference": self.last_inference,
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "inference_stats": {
                    "success": {"count": self.success[0], "ns": self.success[1]},
                    "fail": {"count": self.fail[0], "ns": self.fail[1]},
                    "cancel": {"count": self.cancel[0], "ns": self.cancel[1]},
                    "queue": {"count": self.queue[0], "ns": self.queue[1]},
                    "compute_input": {"count": 0, "ns": 0},
                    "compute_infer": {
                        "count": self.compute_infer[0],
                        "ns": self.compute_infer[1],
                    },
                    "compute_output": {"count": 0, "ns": 0},
                },
                "batch_stats": [
                    {
                        "batch_size": size,
                        "compute_infer": {"count": row[0], "ns": row[1]},
                    }
                    for size, row in sorted(self.batches.items())
                ],
            }


def handler_device(core: "ServerCore") -> torch.device:
    """The device a frontend's worker threads make current: the core's,
    with its index resolved here (a worker thread's own current device is
    0). A core left at "cuda" on a machine without one (its models on the
    CPU) has no device to bind."""
    device = core.device
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def bind_device(device: torch.device) -> None:
    """Worker-thread initializer: make ``device`` current, so kernels
    launched from the thread run on it."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)


class ServerCore:
    """Registry + data plane + execution, shared by the protocol frontends.

    ``device``: where tensors read from cross-process cuda shared-memory
    regions are placed (the models carry their own device)."""

    def __init__(self, models: Optional[List[Model]] = None,
                 name: str = "client_tpu_torch_server", device="cuda"):
        """``name``: the server metadata's name (JAX's keyword)."""
        self._name = name
        self._device = torch.device(device)
        self._lock = threading.Lock()
        self._models: Dict[str, Model] = {}
        self._stats: Dict[str, _ModelStats] = {}
        self._regions: Dict[str, _Region] = {}
        self._batchers: Dict[str, Any] = {}  # model name -> (max_batch, DynamicBatcher)
        self.batch_timeout_s = 60.0  # future wait for one batched request
        self.trace_settings: Dict[str, Any] = {
            "trace_level": ["OFF"],
            "trace_rate": "1000",
            "trace_count": "-1",
            "log_frequency": "0",
            "trace_file": "",
            "trace_mode": "triton",
        }
        self.log_settings: Dict[str, Any] = {
            "log_file": "",
            "log_info": True,
            "log_warning": True,
            "log_error": True,
            "log_verbose_level": 0,
            "log_format": "default",
        }
        self.live = True
        # ready is the drainable half of health: frontends flip it false on
        # drain/close so pool ready-probes route away while in-flight
        # requests still complete (live stays true until the process exits)
        self.ready = True
        # rolling per-request trace records, kept while trace_level includes
        # TIMESTAMPS or TENSORS (mirrored to trace_file when one is set)
        self._traces: List[Dict[str, Any]] = []
        self._trace_seq = 0
        self._trace_candidates = 0
        # W3C trace-context access records: every request that arrived with
        # a valid traceparent gets a server-side span joined on the same
        # trace id, so client phase timings and server queue/compute
        # timings line up (client_tpu_torch.observe)
        self._access: deque = deque(maxlen=1024)
        self._metrics_registry = None
        for m in models or []:
            self.add_model(m)

    @property
    def device(self) -> torch.device:
        """The device tensors from cross-process cuda regions land on."""
        return self._device

    # -- registry ----------------------------------------------------------
    def add_model(self, model: Model) -> None:
        with self._lock:
            self._models[model.name] = model
            self._stats.setdefault(model.name, _ModelStats())
        if hasattr(model, "bind"):  # ensembles resolve members at execute time
            model.bind(self.model)

    def model(self, name: str, version: str = "") -> Model:
        m = self._models.get(name)
        if m is None:
            raise InferError(f"Request for unknown model: '{name}' is not found", 400)
        if version and version not in m.versions:
            raise InferError(
                f"Request for unknown model: '{name}' version {version} is not found", 400
            )
        return m

    def model_ready(self, name: str, version: str = "") -> bool:
        try:
            return self.model(name, version).ready
        except InferError:
            return False

    def server_metadata(self) -> Dict[str, Any]:
        return {
            "name": self._name,
            "version": "2.x-client_tpu_torch",
            "extensions": [
                "classification",
                "sequence",
                "model_repository",
                "model_repository(unload_dependents)",
                "model_configuration",
                "system_shared_memory",
                "cuda_shared_memory",
                "binary_tensor_data",
                "parameters",
                "statistics",
                "trace",
                "logging",
            ],
        }

    # -- repository, statistics, trace ---------------------------------------
    def repository_index(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "name": m.name,
                    "version": m.versions[-1],
                    "state": "READY" if m.ready else "UNAVAILABLE",
                    "reason": "",
                }
                for m in self._models.values()
            ]

    def load_model(self, name: str, config: Optional[str] = None) -> None:
        """(Re)load ``name``; ``config`` is a JSON override merged over the
        model's config (a plain load reverts to the repository config)."""
        model = self.model(name)
        if config:
            try:
                override = json.loads(config)
            except Exception as e:
                raise InferError(f"invalid config override: {e}", 400)
            if not isinstance(override, dict):
                raise InferError("config override must be a JSON object", 400)
            if override.get("name", name) != name:
                raise InferError("config override cannot rename the model", 400)
        else:
            override = {}
        model.config_override = override
        model.load()

    def unload_model(self, name: str) -> None:
        self.model(name).unload()

    def statistics(self, name: str = "", version: str = "") -> Dict[str, Any]:
        with self._lock:
            names = [name] if name else list(self._models.keys())
        out = []
        for n in names:
            m = self.model(n)
            out.append(self._stats[n].as_dict(n, version or m.versions[-1]))
        return {"model_stats": out}

    def _trace_enabled(self) -> bool:
        """Honors trace_level plus the trace_rate (sample 1-in-N) and
        trace_count (stop after N, -1 = unlimited) settings."""
        level = self.trace_settings.get("trace_level", [])
        if "TIMESTAMPS" not in level and "TENSORS" not in level:
            return False
        with self._lock:
            try:
                rate = max(int(self.trace_settings.get("trace_rate", 1) or 1), 1)
                count = int(self.trace_settings.get("trace_count", -1))
            except (TypeError, ValueError):
                rate, count = 1, -1
            if count >= 0 and self._trace_seq >= count:
                return False
            self._trace_candidates += 1
            return (self._trace_candidates - 1) % rate == 0

    def _trace_request(self, model_name: str, request: Dict[str, Any],
                       t0: int, t_infer: int, infer_ns: int) -> None:
        if not self._trace_enabled():
            return
        with self._lock:
            self._trace_seq += 1
            record = {
                "id": self._trace_seq,
                "model_name": model_name,
                "request_id": request.get("id", ""),
                "timestamps": {
                    "request_start_ns": t0,
                    "compute_start_ns": t_infer,
                    "compute_end_ns": t_infer + infer_ns,
                    "request_end_ns": time.perf_counter_ns(),
                },
            }
            self._traces.append(record)
            if len(self._traces) > 1024:
                del self._traces[: len(self._traces) - 1024]
            trace_file = self.trace_settings.get("trace_file")
        if trace_file:
            try:
                with open(trace_file, "a") as f:
                    f.write(json.dumps(record) + "\n")
            except OSError:
                pass

    def recent_traces(self, count: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._traces[-count:])

    # -- observability (client_tpu_torch.observe counterpart) -----------------
    def _observe_access(self, request: Dict[str, Any], model_name: str,
                        t0: int, t_infer: int, infer_ns: int,
                        responses: int = 1,
                        first_response_ns: Optional[int] = None) -> None:
        """Record a server-side span for a request that carried a W3C
        ``traceparent`` (the frontends stash the header or metadata value
        under the reserved ``traceparent`` request key). ``client_span_id``
        is the parent id from the header — the client's request span — so
        one trace id joins client phases to the server's queue and compute
        times. Streamed (decoupled) requests also carry their response count
        and the server-side first-response latency.

        On the GPU, ``compute_ns`` is the host time of ``model.execute``
        (or of the decoupled generator's run). A model whose outputs are
        CUDA tensors may return once its kernels are enqueued: its device
        time then lands after ``compute_ns`` — in the response build, where
        a wire output's device-to-host copy waits for it — or, for an output
        left on the device in a colocated cuda region, in no server span at
        all. The path adds no synchronize to measure it."""
        traceparent = request.get("traceparent")
        if not traceparent:
            return
        from ..observe import make_span_id, parse_traceparent

        parsed = parse_traceparent(traceparent)
        if parsed is None:
            return
        trace_id, client_span_id, _sampled = parsed
        record = {
            "trace_id": trace_id,
            "client_span_id": client_span_id,
            "server_span_id": make_span_id(),
            "model_name": model_name,
            "request_id": request.get("id", ""),
            # recv -> compute start: input resolution and the batching queue
            "queue_ns": max(t_infer - t0, 0),
            "compute_ns": infer_ns,
            "total_ns": time.perf_counter_ns() - t0,
            "responses": responses,
            "wall_time_s": time.time(),
        }
        if first_response_ns is not None:
            record["first_response_ns"] = max(first_response_ns - t0, 0)
        with self._lock:
            self._access.append(record)

    def access_records(self, count: int = 100) -> List[Dict[str, Any]]:
        """The most recent traceparent-joined server spans (newest last)."""
        with self._lock:
            return list(self._access)[-count:]

    def metrics_registry(self):
        """The server's ``observe.MetricsRegistry`` (created on first use):
        live/ready gauges plus per-model request/latency series refreshed
        from the model statistics at scrape time. The HTTP frontend serves
        its Prometheus rendering at ``GET /metrics``. ``ready`` reads 0 once
        a frontend drains (``core.ready``), while ``live`` stays 1."""
        with self._lock:
            if self._metrics_registry is not None:
                return self._metrics_registry
        from ..observe import MetricsRegistry

        reg = MetricsRegistry()
        live = reg.gauge("client_tpu_server_live", "Server liveness (1 live)")
        ready = reg.gauge(
            "client_tpu_server_ready",
            "Server readiness (0 while draining; live stays 1)")
        gauges = {
            "inference_count": reg.gauge(
                "client_tpu_server_inference_count",
                "Inferences completed (batched requests each count)", ("model",)),
            "execution_count": reg.gauge(
                "client_tpu_server_execution_count",
                "Model executions (execution < inference under batching)", ("model",)),
            "success": reg.gauge(
                "client_tpu_server_request_success_count", "Successful requests",
                ("model",)),
            "fail": reg.gauge(
                "client_tpu_server_request_fail_count", "Failed requests", ("model",)),
            "cancel": reg.gauge(
                "client_tpu_server_request_cancel_count",
                "Client-cancelled/abandoned streaming requests", ("model",)),
            "queue_seconds": reg.gauge(
                "client_tpu_server_queue_seconds", "Cumulative batching-queue wait",
                ("model",)),
            "compute_seconds": reg.gauge(
                "client_tpu_server_compute_seconds", "Cumulative model compute time",
                ("model",)),
        }
        traced = reg.gauge(
            "client_tpu_server_traced_requests",
            "Traceparent-joined access records currently buffered")

        def collect():
            live.set(1.0 if self.live else 0.0)
            ready.set(1.0 if (self.live and self.ready) else 0.0)
            for row in self.statistics()["model_stats"]:
                model = row["name"]
                gauges["inference_count"].labels(model).set(row["inference_count"])
                gauges["execution_count"].labels(model).set(row["execution_count"])
                stats = row["inference_stats"]
                gauges["success"].labels(model).set(stats["success"]["count"])
                gauges["fail"].labels(model).set(stats["fail"]["count"])
                gauges["cancel"].labels(model).set(stats["cancel"]["count"])
                gauges["queue_seconds"].labels(model).set(stats["queue"]["ns"] / 1e9)
                gauges["compute_seconds"].labels(model).set(
                    stats["compute_infer"]["ns"] / 1e9)
            with self._lock:
                traced.set(len(self._access))

        reg.add_collector(collect)
        with self._lock:
            if self._metrics_registry is None:
                self._metrics_registry = reg
            return self._metrics_registry

    def orca_report(self, fmt: str, model_name: str = "") -> str:
        """Per-response load metrics in ORCA json or text form."""
        stats = self._stats.get(model_name)
        count = infer_ns = 0
        if stats is not None:
            with stats.lock:
                count = stats.inference_count
                infer_ns = stats.compute_infer[1] // max(stats.compute_infer[0], 1)
        metrics = {
            "inference_count": count,
            "avg_compute_infer_us": infer_ns // 1000,
            "active_models": len(self._models),
        }
        if fmt == "json":
            return json.dumps({"named_metrics": metrics}, separators=(",", ":"))
        return ", ".join(f"named_metrics.{k}={v}" for k, v in metrics.items())

    # -- shared memory -----------------------------------------------------
    def register_system_region(self, name: str, key: str, offset: int, byte_size: int) -> None:
        self._register(_Region(name, "system", key, offset, byte_size))

    def register_cuda_region(
        self, name: str, raw_handle_b64: str, device_id: int, byte_size: int
    ) -> None:
        """Register a cuda region from its serialized handle (the base64 JSON
        descriptor of ``utils.cuda_shared_memory.get_raw_handle``)."""
        try:
            region = _CudaRegion(name, raw_handle_b64, device_id, byte_size, self._device)
        except Exception as e:
            raise InferError(f"failed to attach cuda shared-memory region: {e}", 400)
        self._register(region)

    def _register(self, region: _Region) -> None:
        with self._lock:
            if region.name in self._regions:
                # Triton semantics: an active name must be unregistered first
                region.close()
                raise InferError(
                    f"shared memory region '{region.name}' already in manager", 400)
            self._regions[region.name] = region

    def unregister_region(self, name: str = "", family: Optional[str] = None) -> None:
        with self._lock:
            if name:
                r = self._regions.pop(name, None)
                if r is not None:
                    r.close()
            else:
                for key in list(self._regions):
                    if family is None or self._regions[key].family == family:
                        self._regions.pop(key).close()

    def region_status(self, family: str, name: str = "") -> List[Dict[str, Any]]:
        with self._lock:
            return [
                r.status()
                for r in self._regions.values()
                if r.family == family and (not name or r.name == name)
            ]

    def _region(self, name: str) -> _Region:
        with self._lock:
            r = self._regions.get(name)
        if r is None:
            raise InferError(f"Unable to find shared memory region: '{name}'", 400)
        return r

    # -- inference ---------------------------------------------------------
    def infer(self, model_name: str, model_version: str,
              request: Dict[str, Any], decoupled_ok: bool = False):
        """Execute one inference.

        ``request``: {"id", "parameters", "inputs": [...], "outputs": [...]}
        where each input dict has name/datatype/shape plus exactly one of
        "array" (host ndarray) or "shm" ((region, byte_size, offset)).

        Returns the response dict: {"model_name", "model_version", "id",
        "outputs": [{name, datatype, shape, "array"|"shm"}]}. A decoupled
        model raises unless ``decoupled_ok``; then its stream runs to the
        end and the list of its responses is returned, as JAX's does.
        """
        t0 = time.perf_counter_ns()
        model = self.model(model_name, model_version)
        if not model.ready:
            raise InferError(f"Request for unknown model: '{model_name}' is not ready", 400)
        if model.decoupled:
            if decoupled_ok:
                return list(self._decoupled_stream(model, model_version, request, t0))
            raise InferError(
                f"model '{model_name}' is a decoupled model: use streaming inference", 400)
        stats = self._stats[model.name]
        try:
            inputs = self._resolve_inputs(model, request)
            params = request.get("parameters", {})
            t_infer = time.perf_counter_ns()
            batched = self._batchable(model, request)
            if batched:
                try:
                    raw = self._batcher_for(model).submit(inputs, params).result(
                        timeout=self.batch_timeout_s)
                except FuturesTimeoutError:
                    raise InferError(
                        f"batched inference timed out after {self.batch_timeout_s:.0f}s "
                        "(the execution may still complete server-side; raise "
                        "core.batch_timeout_s for cold-compile workloads)", 504)
            else:
                raw = model.execute(inputs, params)
            infer_ns = time.perf_counter_ns() - t_infer
        except InferError:
            stats.record(False, time.perf_counter_ns() - t0, 0, 0)
            raise
        except Exception as e:
            stats.record(False, time.perf_counter_ns() - t0, 0, 0)
            raise InferError(f"inference failed: {e}", 400)
        response = self._build_response(model, model_version, request, raw)
        self._trace_request(model.name, request, t0, t_infer, infer_ns)
        self._observe_access(request, model.name, t0, t_infer, infer_ns)
        batch = 1
        if model.effective_max_batch_size():
            first = next(iter(raw.values()))
            batch = int(first.shape[0]) if first.ndim else 1
        stats.record(True, time.perf_counter_ns() - t0, infer_ns, batch,
                     executed=not batched)
        return response

    # -- dynamic batching ---------------------------------------------------
    def _batchable(self, model: Model, request: Dict[str, Any]) -> bool:
        """Coalescing is for stateless, non-decoupled models that declared
        batch capacity; sequence requests never merge, and requests bound to
        shared memory run alone (their tensors are the regions' own)."""
        return (
            model.effective_max_batch_size() > 1
            and not model.decoupled
            and not model.stateful
            and not request.get("parameters", {}).get("sequence_id")
            and not any("shm" in t for t in request.get("inputs", []))
            and not any("shm" in t for t in request.get("outputs") or [])
        )

    def _batcher_for(self, model: Model):
        from .batcher import DynamicBatcher

        max_batch = model.effective_max_batch_size()
        with self._lock:
            entry = self._batchers.get(model.name)
            if entry is not None and entry[0] == max_batch:
                return entry[1]
            stale = entry[1] if entry is not None else None
            batcher = DynamicBatcher(
                model.execute, max_batch, report=self._stats[model.name].record_batch)
            self._batchers[model.name] = (max_batch, batcher)
        if stale is not None:
            # max_batch_size changed through a config override: close OUTSIDE
            # the core lock, as close() joins the worker
            stale.close()
        return batcher

    def infer_stream(self, model_name: str, model_version: str, request: Dict[str, Any]):
        """Incremental inference: a generator yielding response dicts AS the
        model produces them (decoupled models stream each response before
        the next is computed; others yield their single infer() response)."""
        model = self.model(model_name, model_version)
        if not model.decoupled:
            yield self.infer(model_name, model_version, request)
            return
        if not model.ready:
            raise InferError(f"Request for unknown model: '{model_name}' is not ready", 400)
        yield from self._decoupled_stream(model, model_version, request,
                                          time.perf_counter_ns())

    def _decoupled_stream(self, model: Model, model_version: str,
                          request: Dict[str, Any], t0: int):
        """Drive ``execute_decoupled`` lazily, building and yielding each
        response as it is produced. Records the request's statistics once,
        whether it completes, fails mid-stream, or the consumer abandons the
        generator (a cancel)."""
        stats = self._stats[model.name]
        try:
            inputs = self._resolve_inputs(model, request)
        except InferError:
            stats.record(False, time.perf_counter_ns() - t0, 0, 0)
            raise
        except Exception as e:
            stats.record(False, time.perf_counter_ns() - t0, 0, 0)
            raise InferError(f"inference failed: {e}", 400)
        t_infer = time.perf_counter_ns()
        n_responses = 0
        t_first: Optional[int] = None
        try:
            for raw in model.execute_decoupled(inputs, request.get("parameters", {})):
                response = self._build_response(model, model_version, request, raw)
                if t_first is None:
                    t_first = time.perf_counter_ns()
                n_responses += 1
                yield response
        except GeneratorExit:
            # the consumer went away mid-stream (client cancel/disconnect)
            stats.record_cancel(time.perf_counter_ns() - t0)
            raise
        except InferError:
            stats.record(False, time.perf_counter_ns() - t0, 0, 0)
            raise
        except Exception as e:
            stats.record(False, time.perf_counter_ns() - t0, 0, 0)
            raise InferError(f"inference failed: {e}", 400)
        infer_ns = time.perf_counter_ns() - t_infer
        stats.record(True, time.perf_counter_ns() - t0, infer_ns, 1)
        self._trace_request(model.name, request, t0, t_infer, infer_ns)
        self._observe_access(request, model.name, t0, t_infer, infer_ns,
                             responses=n_responses, first_response_ns=t_first)

    def _resolve_inputs(self, model: Model, request: Dict[str, Any]) -> Dict[str, Any]:
        specs = {s.name: s for s in model.inputs()}
        out: Dict[str, Any] = {}
        for inp in request.get("inputs", []):
            name = inp["name"]
            spec = specs.get(name)
            if spec is None:
                raise InferError(
                    f"unexpected inference input '{name}' for model '{model.name}'", 400)
            datatype = inp.get("datatype", spec.datatype)
            if datatype != spec.datatype:
                raise InferError(
                    f"inference input '{name}' has datatype {datatype}; "
                    f"model expects {spec.datatype}", 400,
                )
            shape = inp.get("shape", [])
            if not spec.matches(shape):
                raise InferError(
                    f"unexpected shape {shape} for input '{name}' "
                    f"(model expects {spec.shape})", 400,
                )
            shm = inp.get("shm")
            if shm is not None:
                region_name, byte_size, offset = shm
                region = self._region(region_name)
                region.check_range(byte_size, offset, "read")
                out[name] = region.read_tensor(datatype, shape, byte_size, offset)
            else:
                arr = inp.get("array")
                if arr is None:
                    raise InferError(f"input '{name}' has no data", 400)
                out[name] = arr
        missing = {s for s in set(specs) - set(out) if not specs[s].optional}
        if missing:
            raise InferError(
                f"expected {len(specs)} inputs but got {len(out)} inputs for "
                f"model '{model.name}' (missing: {sorted(missing)})", 400,
            )
        return out

    def _build_response(self, model: Model, model_version: str,
                        request: Dict[str, Any], raw: Dict[str, Any]) -> Dict[str, Any]:
        requested = request.get("outputs")
        if requested:
            for r in requested:
                if r["name"] not in raw:
                    raise InferError(
                        f"unexpected inference output '{r['name']}' for model "
                        f"'{model.name}'", 400,
                    )
            out_specs = requested
        else:
            out_specs = [{"name": n} for n in raw.keys()]

        outputs = []
        for spec in out_specs:
            name = spec["name"]
            arr = raw[name]  # np.ndarray or torch tensor (stays on its device)
            class_count = spec.get("classification", 0)
            if class_count:
                arr = _classification(
                    arr, class_count, model.labels(),
                    batched=model.effective_max_batch_size() > 0,
                )
                datatype = "BYTES"
            else:
                datatype = _triton_dtype(arr)
            entry: Dict[str, Any] = {
                "name": name,
                "datatype": datatype,
                "shape": list(arr.shape),
            }
            shm = spec.get("shm")
            if shm is not None:
                region_name, byte_size, offset = shm
                written = self._region(region_name).write_tensor(
                    arr, datatype, offset, byte_size, name)
                entry["shm"] = (region_name, written, offset)
            else:
                entry["array"] = _to_host(arr)
            outputs.append(entry)
        resp: Dict[str, Any] = {
            "model_name": model.name,
            "model_version": model_version or model.versions[-1],
            "outputs": outputs,
        }
        if request.get("id"):
            resp["id"] = request["id"]
        return resp


def _bytes_to_array(buf, datatype: str, shape) -> np.ndarray:
    """Decode wire bytes; a ``bytearray`` gives a writable array (which torch
    then takes without a further copy)."""
    if datatype == "BYTES":
        return deserialize_bytes_tensor(buf).reshape(shape)
    if datatype == "BF16":
        return deserialize_bf16_tensor(buf).reshape(shape)
    return np.frombuffer(buf, dtype=triton_to_np_dtype(datatype)).reshape(shape)


def _array_to_bytes(arr: np.ndarray, datatype: str) -> bytes:
    if datatype == "BYTES":
        s = serialize_byte_tensor(arr)
        return s.item() if s.size else b""
    if datatype == "BF16":
        s = serialize_bf16_tensor(arr)
        return s.item() if s.size else b""
    return np.ascontiguousarray(arr).tobytes()


def _classification(arr, k: int, labels: Optional[List[str]], batched: bool = False) -> np.ndarray:
    """classification extension: top-k "value:index[:label]" strings.

    For batched models the first dim is the batch and each element's
    (flattened) remainder is its class vector; for non-batched models the
    whole (flattened) tensor is one class vector. A tensor output (the
    counterpart of the JAX server's device array) ranks on its device
    through ``ops.topk_classification``, ties lowest index first, and only
    the k winners cross to the host; a numpy output ranks through the JAX
    server's host argsort, ties highest index first (which may pick another
    set of classes where ties straddle k).
    """
    on_device = isinstance(arr, torch.Tensor)
    if not on_device:
        arr = np.asarray(arr)
    flat = arr.reshape(arr.shape[0], -1) if batched and arr.ndim >= 1 else arr.reshape(1, -1)
    k = min(k, flat.shape[-1])
    if on_device:
        values, indices = topk_classification(flat, k)
        values, indices = _to_host(values), _to_host(indices)
    else:
        indices = np.argsort(flat, axis=-1)[:, ::-1][:, :k]
        values = np.take_along_axis(flat, indices, axis=-1)
    rows = []
    for row_values, row_indices in zip(values, indices):
        entries = []
        for value, i in zip(row_values, row_indices):
            s = f"{value:f}:{i}"
            if labels and i < len(labels):
                s += f":{labels[i]}"
            entries.append(s.encode("utf-8"))
        rows.append(entries)
    out = np.array(rows, dtype=np.object_)
    if not batched:
        return out.reshape(-1)
    return out.reshape((arr.shape[0], k))
