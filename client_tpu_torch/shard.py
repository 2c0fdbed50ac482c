"""Sharded scatter-gather serving: one logical request across a replica mesh.

The port of ``client_tpu.shard``, over the port's pool, arena and
clients. The pool (client_tpu_torch.pool) treats replicas as
interchangeable clones; this module opens the scenario where they are
NOT — a model (or batch) too big for one worker, served by client-driven
tensor/batch parallelism across *processes*. A :class:`ShardLayout` is a ``PartitionSpec``-like declaration
mapping each input/output tensor axis to an ordered list of replica-pinned
endpoints; :class:`ShardedClient` / :class:`AioShardedClient` split one
logical ``infer()`` along those axes into per-shard KServe requests, fan
them out concurrently through the existing pool machinery (each shard
pinned to its endpoint via ``PoolClient.pinned_infer`` and staged zero-copy
through the shm arena's cached per-endpoint registrations), and gather the
shard responses into one logical result with exactness asserts::

    from client_tpu_torch.pool import PoolClient
    from client_tpu_torch.shard import ShardLayout, ShardedClient

    layout = ShardLayout(
        endpoints=["10.0.0.1:8000", "10.0.0.2:8000"],
        inputs={"TOKENS": 0},              # split rows across replicas
        outputs={"LOGITS": 0, "NEXT_TOKEN": 0},  # concat rows back
    )
    pool = PoolClient(layout.endpoints, protocol="http", shm_arena=True)
    client = ShardedClient(pool, layout)
    result = client.infer("decoder_lm_prefill", inputs)
    result.as_numpy("LOGITS")              # lease-pinned zero-copy view

Semantics:

- **Failure is first-class and whole-request.** A lost/errored shard fails
  the LOGICAL request with a typed :class:`ShardFailed` naming the shard
  index and pinned endpoint — never a silent partial retry on another
  replica (the other replicas hold the *other* shards, not spares) and
  never a partial gather. In-endpoint resilience (the pool's
  ``endpoint_retry`` / breaker) still composes per shard, and every shard
  draws its timeout from ONE shared
  :class:`~client_tpu_torch.resilience.AttemptBudget`.
- **Admission charges one token per logical request** (the pool's
  controller, when armed) — shards bypass the pool-level gate so a
  half-admitted scatter can never deadlock the controller against itself.
- **Hedging and coalescing are rejected, typed.** A hedged shard would
  race a replica that doesn't hold the shard's partition; a coalesced
  shard would stack rows across layouts. Both raise
  :class:`ShardConfigError` at construction.
- **Exactness asserts at gather.** Shard responses must agree on dtype and
  every non-sharded dimension; declared outputs must be present on every
  shard; replicated outputs must be bit-identical across shards (checked
  on read). Axis coverage is validated at scatter: explicit per-shard
  ranges must tile ``[0, L)`` with no gap and no overlap
  (:class:`ShardLayoutError`).
- **Observability**: the logical request is one span (frontend
  ``shard+<protocol>``) with ``shard_scatter`` / per-shard ``attempt`` /
  ``shard_gather`` phases — ``Telemetry.phase_breakdown()`` decomposes
  logical-request time into scatter, slowest-shard and gather legs — plus
  ``client_tpu_shard_*`` counters and the per-request shard-skew
  histogram.

This is Hermes-style pipelined inference for models that don't fit one
worker (arXiv:2409.04249) recast as a client-side protocol; the replay /
capacity methodology (arXiv:2210.04323) drives it via the ``sharded``
trace kind (client_tpu_torch.trace) and ``perf.py --shard-layout``.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import flight as _flight
from ._base import fold_infer_args
from .pool import _PoolClientBase, AioPoolClient, PoolClient
from .utils import InferenceServerException, triton_to_np_dtype

__all__ = [
    "AioShardedClient",
    "ShardAxis",
    "ShardConfigError",
    "ShardError",
    "ShardFailed",
    "ShardGatherError",
    "ShardLayout",
    "ShardLayoutError",
    "ShardedClient",
    "ShardedInferResult",
]

REPLICATED = None  # readable alias for "this tensor is not sharded"


class ShardError(InferenceServerException):
    """Base for every typed sharding error."""

    def __init__(self, msg: str, status: str = "SHARD"):
        super().__init__(msg, status=status)


class ShardLayoutError(ShardError):
    """The layout declaration (or the request's tensors against it) is
    invalid: unknown axis, uncovered axis span, overlapping ranges,
    endpoint/range count mismatch, undeclared tensor."""

    def __init__(self, msg: str):
        super().__init__(msg, status="SHARD_LAYOUT")


class ShardConfigError(ShardError):
    """Sharded serving was composed with something it rejects by design:
    hedging, the coalescing dispatcher, sequence requests, shm-bound
    caller tensors, or a non-pool substrate."""

    def __init__(self, msg: str):
        super().__init__(msg, status="SHARD_CONFIG")


class ShardGatherError(ShardError):
    """Shard responses disagree (dtype/shape/replicated-content mismatch,
    missing or undeclared outputs) — the gather refuses to fabricate a
    logical result from inconsistent pieces."""

    def __init__(self, msg: str):
        super().__init__(msg, status="SHARD_GATHER")


class ShardFailed(ShardError):
    """One shard's request failed, so the WHOLE logical request failed.

    ``shard`` is the shard index, ``url`` its pinned endpoint, ``cause``
    the underlying per-shard exception. The scatter-gather layer never
    retries a shard on a different replica (they hold different
    partitions) and never returns a partial gather."""

    def __init__(self, shard: int, url: str, cause: BaseException):
        super().__init__(
            f"shard {shard} (endpoint {url}) failed: "
            f"{type(cause).__name__}: {cause}",
            status="SHARD_FAILED")
        self.shard = shard
        self.url = url
        self.cause = cause


class ShardAxis:
    """One tensor's shard mapping: the axis to split, optionally with
    explicit per-shard ``ranges`` (``[(start, stop), ...]``, one per
    endpoint, in endpoint order). Without ranges the axis is split into
    contiguous near-equal blocks. Explicit ranges must tile the axis:
    start at 0, end at the axis length, and be contiguous — a gap is an
    uncovered-axis error, an overlap a double-covered one (both
    :class:`ShardLayoutError`, both checked per request against the real
    axis length)."""

    __slots__ = ("axis", "ranges")

    def __init__(self, axis: int,
                 ranges: Optional[Sequence[Tuple[int, int]]] = None):
        if not isinstance(axis, int) or axis < 0:
            raise ShardLayoutError(
                f"shard axis must be a non-negative int, got {axis!r}")
        self.axis = axis
        self.ranges = ([(int(a), int(b)) for a, b in ranges]
                       if ranges is not None else None)

    def __repr__(self) -> str:
        if self.ranges is None:
            return f"ShardAxis({self.axis})"
        return f"ShardAxis({self.axis}, ranges={self.ranges})"

    def resolve(self, name: str, length: int,
                n_shards: int) -> List[Tuple[int, int]]:
        """Per-shard ``(start, stop)`` blocks covering ``[0, length)``."""
        if self.ranges is not None:
            ranges = self.ranges
            if len(ranges) != n_shards:
                raise ShardLayoutError(
                    f"input {name!r}: {len(ranges)} explicit ranges for "
                    f"{n_shards} shard endpoints")
            cursor = 0
            for i, (start, stop) in enumerate(ranges):
                if stop <= start:
                    raise ShardLayoutError(
                        f"input {name!r} shard {i}: empty/negative range "
                        f"({start}, {stop})")
                if start < cursor:
                    raise ShardLayoutError(
                        f"input {name!r} shard {i}: range ({start}, {stop}) "
                        f"overlaps shard {i - 1} (covered through {cursor})")
                if start > cursor:
                    raise ShardLayoutError(
                        f"input {name!r} shard {i}: axis span "
                        f"[{cursor}, {start}) is uncovered")
                cursor = stop
            if cursor != length:
                raise ShardLayoutError(
                    f"input {name!r}: ranges cover [0, {cursor}) but the "
                    f"axis has length {length}")
            return list(ranges)
        if length < n_shards:
            raise ShardLayoutError(
                f"input {name!r}: axis {self.axis} has length {length} < "
                f"{n_shards} shards (every shard needs at least one slice)")
        base, extra = divmod(length, n_shards)
        ranges, cursor = [], 0
        for i in range(n_shards):
            size = base + (1 if i < extra else 0)
            ranges.append((cursor, cursor + size))
            cursor += size
        return ranges


AxisSpec = Union[int, None, ShardAxis]


def _as_axis(name: str, spec: AxisSpec) -> Optional[ShardAxis]:
    if spec is None:
        return None
    if isinstance(spec, ShardAxis):
        return spec
    if isinstance(spec, bool) or not isinstance(spec, int):
        raise ShardLayoutError(
            f"tensor {name!r}: axis must be an int, None (replicated) or "
            f"ShardAxis, got {spec!r}")
    return ShardAxis(spec)


class ShardLayout:
    """The PartitionSpec of a sharded deployment.

    ``endpoints``: ordered replica urls, one per shard (shard *i* is
    pinned to ``endpoints[i]`` forever — there is no failover target for
    a partition). ``inputs`` / ``outputs`` map tensor name -> axis
    (``int`` or :class:`ShardAxis`) or ``None`` for replicated tensors
    (inputs: same bytes to every shard; outputs: must come back
    bit-identical from every shard). ``check_replicated=False`` skips the
    replicated-output content comparison (metadata is still asserted)."""

    def __init__(self, endpoints: Sequence[str],
                 inputs: Dict[str, AxisSpec],
                 outputs: Dict[str, AxisSpec],
                 check_replicated: bool = True):
        self.endpoints = [str(u) for u in endpoints]
        if len(self.endpoints) < 1:
            raise ShardLayoutError("a shard layout needs >= 1 endpoint")
        if len(set(self.endpoints)) != len(self.endpoints):
            raise ShardLayoutError(
                "shard endpoints must be distinct: two shards pinned to "
                f"one replica is a partition error ({self.endpoints})")
        if not inputs:
            raise ShardLayoutError("a shard layout needs >= 1 input tensor")
        if not outputs:
            raise ShardLayoutError("a shard layout needs >= 1 output tensor")
        self.inputs: Dict[str, Optional[ShardAxis]] = {
            str(k): _as_axis(k, v) for k, v in inputs.items()}
        self.outputs: Dict[str, Optional[ShardAxis]] = {
            str(k): _as_axis(k, v) for k, v in outputs.items()}
        if all(v is None for v in self.inputs.values()):
            raise ShardLayoutError(
                "every input is replicated: nothing is sharded, use the "
                "pool directly")
        self.check_replicated = check_replicated

    @property
    def n_shards(self) -> int:
        return len(self.endpoints)

    # -- (de)serialization -------------------------------------------------
    @classmethod
    def parse(cls, spec: str, endpoints: Sequence[str],
              **kwargs) -> "ShardLayout":
        """Build a layout from a compact spec string (the CLI surface):
        ``"IN0=0,IN1=r->OUT0=0,OUT1=r"`` — tensor=axis pairs, ``r`` (or
        ``replicated``) for replicated tensors, inputs and outputs
        separated by ``->``."""
        ins, sep, outs = spec.partition("->")
        if not sep:
            raise ShardLayoutError(
                f"shard layout spec needs 'inputs->outputs', got {spec!r}")

        def side(text: str, label: str) -> Dict[str, AxisSpec]:
            mapping: Dict[str, AxisSpec] = {}
            for part in filter(None, (p.strip() for p in text.split(","))):
                name, eq, axis = part.partition("=")
                if not eq or not name.strip():
                    raise ShardLayoutError(
                        f"malformed {label} spec part {part!r} "
                        "(want NAME=axis or NAME=r)")
                axis = axis.strip().lower()
                if axis in ("r", "replicated", "none", "-"):
                    mapping[name.strip()] = None
                else:
                    try:
                        mapping[name.strip()] = int(axis)
                    except ValueError:
                        raise ShardLayoutError(
                            f"{label} {name.strip()!r}: axis {axis!r} is "
                            "not an int or 'r'") from None
            return mapping

        return cls(endpoints, side(ins, "input"), side(outs, "output"),
                   **kwargs)

    def describe(self) -> Dict[str, Any]:
        """JSON-ready topology (the doctor's ``shard`` section and the
        bench artifacts embed this)."""

        def one(spec: Optional[ShardAxis]) -> Any:
            if spec is None:
                return "replicated"
            if spec.ranges is None:
                return spec.axis
            return {"axis": spec.axis, "ranges": list(spec.ranges)}

        return {
            "shards": self.n_shards,
            "endpoints": list(self.endpoints),
            "inputs": {k: one(v) for k, v in self.inputs.items()},
            "outputs": {k: one(v) for k, v in self.outputs.items()},
        }


# -- gather-side logical result ----------------------------------------------
class ShardedInferResult:
    """One logical InferResult assembled from per-shard responses.

    ``as_numpy`` of a sharded output concatenates the shard views along
    the layout axis — into a fresh arena lease when the client has one,
    so repeated reads serve the SAME lease-pinned zero-copy view over the
    slab; replicated outputs return shard 0's (itself zero-copy when that
    response is arena/binary-backed) after a bit-equality check across
    shards. ``release()`` drops the gather leases and every shard
    result's arena leases."""

    def __init__(self, layout: ShardLayout, results: List[Any],
                 arena=None):
        self._layout = layout
        self._results = results
        self._arena = arena
        self._cache: Dict[str, np.ndarray] = {}
        self._gather_leases: List[Any] = []
        self._validate()

    # -- exactness asserts (metadata level, eager) -------------------------
    def _metas(self, name: str) -> List[Dict[str, Any]]:
        metas = []
        for i, res in enumerate(self._results):
            meta = res.get_output(name)
            if meta is None:
                raise ShardGatherError(
                    f"output {name!r} missing from shard {i} "
                    f"({self._layout.endpoints[i]})")
            metas.append(meta)
        return metas

    def _validate(self) -> None:
        declared = set(self._layout.outputs)
        returned = set()
        for res in self._results:  # EVERY shard: a lone misconfigured
            returned |= {o.get("name") for o in      # replica must not
                         res.get_response().get("outputs", [])}  # hide
        extra = returned - declared
        if extra:
            raise ShardGatherError(
                f"shard responses carry outputs the layout does not "
                f"declare: {sorted(extra)} (declare an axis or 'r' for "
                "each)")
        for name, spec in self._layout.outputs.items():
            metas = self._metas(name)
            dtypes = {m["datatype"] for m in metas}
            if len(dtypes) != 1:
                raise ShardGatherError(
                    f"output {name!r}: shards disagree on dtype "
                    f"({sorted(dtypes)})")
            shapes = [list(m["shape"]) for m in metas]
            ndims = {len(s) for s in shapes}
            if len(ndims) != 1:
                raise ShardGatherError(
                    f"output {name!r}: shards disagree on rank ({shapes})")
            ndim = ndims.pop()
            if spec is None:
                if any(s != shapes[0] for s in shapes):
                    raise ShardGatherError(
                        f"output {name!r} is replicated but shard shapes "
                        f"differ: {shapes}")
                continue
            if spec.axis >= ndim:
                raise ShardGatherError(
                    f"output {name!r}: gather axis {spec.axis} out of "
                    f"range for rank {ndim}")
            for i, s in enumerate(shapes):
                other = [d for j, d in enumerate(s) if j != spec.axis]
                ref = [d for j, d in enumerate(shapes[0])
                       if j != spec.axis]
                if other != ref:
                    raise ShardGatherError(
                        f"output {name!r}: shard {i} non-gather dims {s} "
                        f"disagree with shard 0 {shapes[0]}")

    # -- accessors ---------------------------------------------------------
    @property
    def shard_results(self) -> List[Any]:
        return list(self._results)

    def get_output(self, name: str) -> Optional[Dict[str, Any]]:
        spec = self._layout.outputs.get(name)
        if name not in self._layout.outputs:
            return None
        metas = self._metas(name)
        shape = list(metas[0]["shape"])
        if spec is not None:
            shape[spec.axis] = sum(m["shape"][spec.axis] for m in metas)
        return {"name": name, "datatype": metas[0]["datatype"],
                "shape": shape}

    def get_response(self) -> Dict[str, Any]:
        head = self._results[0].get_response()
        return {
            "model_name": head.get("model_name"),
            "model_version": head.get("model_version"),
            "shards": self._layout.n_shards,
            "outputs": [self.get_output(name)
                        for name in self._layout.outputs],
        }

    def _gather_dest(self, datatype: str, shape: List[int]):
        """A writable ndarray to concatenate into: a zero-copy view over a
        fresh arena lease when possible (pinned by the lease until
        :meth:`release`), else a plain allocation."""
        np_dtype = np.dtype(triton_to_np_dtype(datatype))
        if self._arena is None or np_dtype.itemsize == 0:
            return np.empty(shape, np_dtype)
        nbytes = max(1, int(np.prod(shape)) * np_dtype.itemsize)
        lease = self._arena.lease(nbytes)
        self._gather_leases.append(lease)
        return lease.as_numpy(np_dtype, shape)

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        if name in self._cache:
            return self._cache[name]
        spec = self._layout.outputs.get(name)
        if name not in self._layout.outputs:
            raise ShardGatherError(
                f"output {name!r} is not declared in the shard layout")
        arrays = [res.as_numpy(name) for res in self._results]
        if any(a is None for a in arrays):
            missing = [i for i, a in enumerate(arrays) if a is None]
            raise ShardGatherError(
                f"output {name!r}: shards {missing} returned no host "
                "data (non-arena shared-memory outputs cannot gather)")
        if spec is None:
            first = arrays[0]
            if self._layout.check_replicated:
                for i, arr in enumerate(arrays[1:], start=1):
                    if not np.array_equal(first, arr):
                        raise ShardGatherError(
                            f"replicated output {name!r}: shard {i} "
                            f"({self._layout.endpoints[i]}) disagrees "
                            "with shard 0 bit-for-bit")
            self._cache[name] = first
            return first
        shape = [int(d) for d in self.get_output(name)["shape"]]
        dtype = arrays[0].dtype
        if dtype == np.object_ or dtype.kind in ("S", "U"):
            out = np.concatenate(arrays, axis=spec.axis)
        else:
            datatype = self._metas(name)[0]["datatype"]
            if datatype == "BF16":
                out = np.concatenate(arrays, axis=spec.axis)
            else:
                dest = self._gather_dest(datatype, shape)
                np.concatenate(arrays, axis=spec.axis, out=dest)
                out = dest
        self._cache[name] = out
        return out

    def release(self) -> None:
        """Release the gather leases and every shard result's arena
        leases (views taken from :meth:`as_numpy` die with them)."""
        self._cache.clear()
        for lease in self._gather_leases:
            try:
                lease.release()
            except Exception:
                pass
        self._gather_leases = []
        for res in self._results:
            release = getattr(res, "release_arena", None)
            if release is not None:
                release()


# -- scatter-side helpers -----------------------------------------------------
def _input_array(inp) -> np.ndarray:
    """Recover the host array behind a staged InferInput (zero-copy for
    fixed-width dtypes: a frombuffer view over the already-serialized
    wire bytes)."""
    datatype = inp.datatype()
    if datatype == "BYTES":
        raise ShardConfigError(
            f"input {inp.name()!r}: BYTES tensors cannot be sharded "
            "(variable-width rows have no sliceable axis layout)")
    if inp._shared_memory_params() is not None:
        raise ShardConfigError(
            f"input {inp.name()!r} is bound to shared memory; the "
            "scatter layer owns staging — pass host-staged inputs "
            "(set_data_from_numpy)")
    raw = inp._get_binary_data()
    if raw is None:
        raise ShardConfigError(
            f"input {inp.name()!r} carries no binary payload; stage it "
            "with set_data_from_numpy(..., binary_data=True)")
    shape = list(inp.shape())
    if datatype == "BF16":
        from .utils import deserialize_bf16_tensor

        return deserialize_bf16_tensor(raw).reshape(shape)
    np_dtype = triton_to_np_dtype(datatype)
    return np.frombuffer(raw, dtype=np_dtype).reshape(shape)


def _release_quietly(lease) -> None:
    try:
        lease.release()
    except Exception:
        pass


class _ShardPlan:
    """One logical request's scatter: per-shard input lists plus the
    arena leases each shard must release once its wire request settled."""

    __slots__ = ("inputs", "leases")

    def __init__(self, n_shards: int):
        self.inputs: List[List[Any]] = [[] for _ in range(n_shards)]
        self.leases: List[List[Any]] = [[] for _ in range(n_shards)]


class _ShardedBase:
    """Scatter/gather logic shared by the sync and asyncio clients."""

    _AIO = False

    def __init__(self, client: _PoolClientBase, layout: ShardLayout):
        if not isinstance(client, _PoolClientBase):
            kind = type(client).__name__
            if "Batching" in kind:
                raise ShardConfigError(
                    "sharded requests cannot ride the coalescing "
                    "dispatcher: coalescing stacks rows across callers, "
                    "sharding partitions rows across replicas — wrap the "
                    "PoolClient itself")
            raise ShardConfigError(
                f"ShardedClient needs a PoolClient/AioPoolClient "
                f"substrate, got {kind}")
        if client._AIO != self._AIO:
            raise ShardConfigError(
                "sync ShardedClient needs a PoolClient and "
                "AioShardedClient an AioPoolClient (sync/aio mismatch)")
        if client._hedge is not None:
            raise ShardConfigError(
                "hedging is rejected for sharded serving: a hedge copy "
                "would race a replica that does not hold the shard's "
                "partition — build the pool without hedge=")
        pool_urls = {ep.url for ep in client.pool.endpoints}
        missing = [u for u in layout.endpoints if u not in pool_urls]
        if missing:
            raise ShardConfigError(
                f"shard layout pins endpoints the pool does not serve: "
                f"{missing}")
        self.inner = client
        self.layout = layout

    # -- composition rejections (typed) ------------------------------------
    def coalescing(self, **kwargs):
        raise ShardConfigError(
            "sharded requests cannot be coalesced: a batch window would "
            "stack rows across shard layouts")

    def generate_stream(self, *args, **kwargs):
        raise ShardConfigError(
            "generate_stream cannot be sharded: a decode stream's state "
            "lives on one replica (see ROADMAP item 4, disaggregated "
            "prefill/decode)")

    def start_stream(self, *args, **kwargs):
        raise ShardConfigError(
            "bidi streams cannot be sharded: stream state is "
            "replica-local")

    # -- delegation ---------------------------------------------------------
    @property
    def _FRONTEND(self) -> str:
        return "shard+" + self.inner._FRONTEND

    def telemetry(self):
        return self.inner.telemetry()

    def arena(self):
        return self.inner.arena()

    def admission(self):
        return self.inner.admission()

    def endpoint_stats(self):
        return self.inner.endpoint_stats()

    def describe(self) -> Dict[str, Any]:
        return self.layout.describe()

    def __getattr__(self, name: str):
        if name.startswith("_") or name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- scatter ------------------------------------------------------------
    def _check_kwargs(self, kwargs) -> None:
        if kwargs.get("sequence_id"):
            raise ShardConfigError(
                "sequence requests cannot be sharded: sequence state is "
                "replica-local and a scatter would split it")
        for out in kwargs.get("outputs") or ():
            if out._shared_memory_params() is not None:
                raise ShardConfigError(
                    f"requested output {out.name()!r} is bound to shared "
                    "memory; sharded gathers own output placement")

    def _scatter(self, inputs) -> _ShardPlan:
        """Slice every input per the layout and stage each slice — through
        the arena fast path when the pool carries one (one host->slab copy
        per shard, registrations cached per (endpoint, region)), else as
        plain binary payloads."""
        layout = self.layout
        n = layout.n_shards
        arena = self.inner.arena()
        plan = _ShardPlan(n)
        try:
            self._scatter_into(plan, inputs, arena)
        except BaseException:
            for leases in plan.leases:
                for lease in leases:
                    _release_quietly(lease)
            raise
        return plan

    def _scatter_into(self, plan: _ShardPlan, inputs, arena) -> None:
        layout = self.layout
        n = layout.n_shards
        names = set()
        for inp in inputs:
            name = inp.name()
            names.add(name)
            if name not in layout.inputs:
                raise ShardLayoutError(
                    f"request input {name!r} is not declared in the "
                    "shard layout")
            spec = layout.inputs[name]
            arr = _input_array(inp)
            cls = type(inp)
            if spec is None:
                # replicated: stage ONCE, every shard rides the same slab
                lease = None
                if arena is not None:
                    lease = arena.lease(max(1, arr.nbytes))
                    try:
                        lease.write_numpy(arr)
                    except BaseException:
                        _release_quietly(lease)
                        raise
                try:
                    for i in range(n):
                        shard_inp = cls(name, list(arr.shape),
                                        inp.datatype())
                        if lease is not None:
                            # one extra ref per shard, released by that
                            # shard's settle (or the scatter cleanup)
                            plan.leases[i].append(lease.retain())
                            lease.bind_input(shard_inp)
                        else:
                            shard_inp.set_data_from_numpy(arr)
                        plan.inputs[i].append(shard_inp)
                finally:
                    if lease is not None:
                        # the staging ref is ALWAYS dropped here — on a
                        # mid-loop failure the shard refs are released by
                        # _scatter's cleanup, and this ref must not leak
                        # the slab forever
                        _release_quietly(lease)
                continue
            if spec.axis >= arr.ndim:
                raise ShardLayoutError(
                    f"input {name!r}: shard axis {spec.axis} out of range "
                    f"for shape {list(arr.shape)}")
            ranges = spec.resolve(name, arr.shape[spec.axis], n)
            index: List[Any] = [slice(None)] * arr.ndim
            for i, (start, stop) in enumerate(ranges):
                index[spec.axis] = slice(start, stop)
                piece = arr[tuple(index)]
                shard_inp = cls(name, list(piece.shape), inp.datatype())
                if arena is not None and piece.dtype.kind not in ("O",):
                    lease = arena.lease(max(1, piece.nbytes))
                    try:
                        lease.write_numpy(piece)
                    except BaseException:
                        _release_quietly(lease)
                        raise
                    plan.leases[i].append(lease)
                    lease.bind_input(shard_inp)
                else:
                    shard_inp.set_data_from_numpy(
                        np.ascontiguousarray(piece))
                plan.inputs[i].append(shard_inp)
        undeclared = set(layout.inputs) - names
        if undeclared:
            raise ShardLayoutError(
                f"layout inputs missing from the request: "
                f"{sorted(undeclared)}")

    def _shard_kwargs(self, kwargs, shard: int,
                      remaining: Optional[float]) -> Dict[str, Any]:
        kw = dict(kwargs)
        if remaining is not None:
            kw["client_timeout"] = remaining
        request_id = kw.get("request_id")
        if request_id:
            kw["request_id"] = f"{request_id}.s{shard}"
        return kw

    def _gather(self, results: List[Any]) -> ShardedInferResult:
        return ShardedInferResult(self.layout, results,
                                  arena=self.inner.arena())

    # -- observability -------------------------------------------------------
    def _span_begin(self, model_name: str):
        tel = self.inner.telemetry()
        if tel is None:
            return None, None
        return tel, tel.begin(self._FRONTEND, model_name, op="shard_infer")

    def _note_done(self, tel, span, marks: List[Tuple[int, int]],
                   error: Optional[BaseException]) -> None:
        if tel is None:
            return
        # the per-shard "attempt" sub-spans are appended HERE, on the
        # caller's thread, from the workers' completion marks: a straggler
        # shard settling after a fail-fast ShardFailed must never mutate a
        # span that finish() already queued for folding (its late mark is
        # simply dropped)
        marks = list(marks)
        if span is not None:
            for start_ns, end_ns in marks:
                span.phase("attempt", start_ns, end_ns)
        skew_s = None
        if error is None and marks:
            skew_s = (max(e for _, e in marks)
                      - min(e for _, e in marks)) * 1e-9
        tel.on_shard_result(self._FRONTEND, skew_s)
        if isinstance(error, ShardFailed):
            tel.on_shard_failed(error.url)
        tel.finish(span, error)


class ShardedClient(_ShardedBase):
    """Synchronous scatter-gather client over a :class:`PoolClient`.

    Shard fan-out runs on an internal thread pool (sized to the layout);
    the first shard failure cancels not-yet-started siblings and raises
    :class:`ShardFailed` immediately — in-flight siblings settle in the
    background and their staging leases release when they do."""

    _AIO = False

    def __init__(self, client: Union[PoolClient, Sequence[str]],
                 layout: ShardLayout, protocol: str = "http",
                 executor_workers: Optional[int] = None,
                 **pool_kwargs):
        """``executor_workers``: the shard fan-out thread pool size. Every
        logical request holds ``n_shards`` threads for its round trip, so
        a client shared by C concurrent callers needs at least
        ``C * n_shards`` workers or the callers queue behind each other
        (default: ``max(8, 4 * n_shards)`` — size it up for harnesses)."""
        owns = False
        if not hasattr(client, "infer"):
            urls = list(client)
            pool_kwargs.setdefault("shm_arena", True)
            client = PoolClient(urls or layout.endpoints,
                                protocol=protocol, **pool_kwargs)
            owns = True
        elif pool_kwargs:
            raise ShardConfigError(
                "pool kwargs are only accepted when ShardedClient builds "
                "the pool itself (pass urls, not a client)")
        try:
            super().__init__(client, layout)
        except BaseException:
            if owns:
                client.close()
            raise
        self._owns = owns
        self._executor_workers = (
            executor_workers if executor_workers
            else max(8, 4 * layout.n_shards))
        self._executor_lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None

    def _get_executor(self) -> ThreadPoolExecutor:
        with self._executor_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._executor_workers,
                    thread_name_prefix="client_tpu_shard")
            return self._executor

    def close(self) -> None:
        with self._executor_lock:
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None
        self.inner.close()

    def __enter__(self) -> "ShardedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- inference -----------------------------------------------------------
    def infer(self, model_name: str, inputs, *args,
              **kwargs) -> ShardedInferResult:
        kwargs = fold_infer_args(args, kwargs)
        self._check_kwargs(kwargs)
        scratch = _flight.layer_begin(
            self.inner.telemetry(), "shard", model_name)
        if scratch is None:
            return self._infer_admitted(model_name, inputs, kwargs)
        try:
            result = self._infer_admitted(model_name, inputs, kwargs)
        except BaseException as e:
            _flight.layer_commit(self.inner.telemetry(), scratch, error=e)
            raise
        _flight.layer_commit(self.inner.telemetry(), scratch)
        return result

    def _infer_admitted(self, model_name: str, inputs,
                        kwargs) -> ShardedInferResult:
        """The admission-gated engine behind :meth:`infer` (split out so
        the flight-recorder wrapper above owns one scratch per LOGICAL
        sharded request)."""
        inner = self.inner
        ctrl = inner.admission()
        if ctrl is None:
            return self._infer_sharded(model_name, inputs, kwargs)
        # ONE admission token covers the whole logical scatter-gather run
        # (shards bypass the pool gate via pinned_infer)
        deadline = inner._admission_deadline(kwargs.get("client_timeout"))
        t0_ns = time.perf_counter_ns()
        token = ctrl.acquire(kwargs.get("priority") or 0, deadline)
        admission_phase = ((t0_ns, time.perf_counter_ns())
                           if token.waited_s else None)
        t0 = time.monotonic()
        try:
            result = self._infer_sharded(model_name, inputs, kwargs,
                                         admission_phase)
        except BaseException as e:
            inner._admission_settle(
                token, t0, getattr(e, "cause", None) or e)
            raise
        inner._admission_settle(token, t0, None)
        return result

    def _infer_sharded(self, model_name, inputs, kwargs,
                       admission_phase=None) -> ShardedInferResult:
        from .resilience import AttemptBudget

        inner = self.inner
        layout = self.layout
        tel, span = self._span_begin(model_name)
        if span is not None and admission_phase is not None:
            span.phase("admission_queue", *admission_phase)
        budget = AttemptBudget(inner._budget_policy,
                               kwargs.get("client_timeout"))
        marks: List[Tuple[int, int]] = []
        error: Optional[BaseException] = None
        try:
            scatter_t0 = time.perf_counter_ns()
            plan = self._scatter(inputs)
            try:
                remaining = budget.attempt_timeout_s()  # raises once spent
            except BaseException:
                for leases in plan.leases:
                    for lease in leases:
                        _release_quietly(lease)
                raise

            def run_shard(i: int):
                url = layout.endpoints[i]
                if tel is not None:
                    tel.on_shard_subrequest(url)
                t_start = time.perf_counter_ns()
                try:
                    res = inner.pinned_infer(
                        url, model_name, plan.inputs[i],
                        **self._shard_kwargs(kwargs, i, remaining))
                finally:
                    for lease in plan.leases[i]:
                        _release_quietly(lease)
                # the shard sub-span is recorded as a completion mark; the
                # caller folds marks into "attempt" phases in _note_done
                marks.append((t_start, time.perf_counter_ns()))
                return res

            executor = self._get_executor()
            futures: List[Any] = []
            _flight.note("shard", "fanout", shards=layout.n_shards)
            try:
                for i in range(layout.n_shards):
                    _flight.note("shard", "dispatch", shard=i,
                                 url=layout.endpoints[i])
                    futures.append(executor.submit(run_shard, i))
            except BaseException:
                # a shard that never dispatched still owns staged leases
                for j in range(len(futures), layout.n_shards):
                    for lease in plan.leases[j]:
                        _release_quietly(lease)
                raise
            if span is not None:
                span.phase("shard_scatter", scatter_t0,
                           time.perf_counter_ns())
            pending = set(futures)
            failed: Optional[Tuple[int, BaseException]] = None
            while pending and failed is None:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for f in done:
                    exc = f.exception()
                    if exc is not None:
                        i = futures.index(f)
                        if failed is None or i < failed[0]:
                            failed = (i, exc)
            if failed is not None:
                # fail fast and WHOLE: cancel what never started (their
                # staging leases release here), let in-flight siblings
                # settle in the background — their results are dropped,
                # never partially gathered
                for f in pending:
                    if f.cancel():
                        i = futures.index(f)
                        for lease in plan.leases[i]:
                            _release_quietly(lease)
                shard_i, cause = failed
                raise ShardFailed(shard_i, layout.endpoints[shard_i],
                                  cause)
            gather_t0 = time.perf_counter_ns()
            _flight.note("shard", "gather", shards=layout.n_shards)
            result = self._gather([f.result() for f in futures])
            if span is not None:
                span.phase("shard_gather", gather_t0,
                           time.perf_counter_ns())
            return result
        except BaseException as e:
            error = e
            raise
        finally:
            self._note_done(tel, span, marks, error)


class AioShardedClient(_ShardedBase):
    """Asyncio twin of :class:`ShardedClient` over an
    :class:`~client_tpu_torch.pool.AioPoolClient`: shard fan-out as tasks, so
    the first failure TRULY cancels the sibling shards mid-flight before
    raising :class:`ShardFailed`."""

    _AIO = True

    def __init__(self, client: Union[AioPoolClient, Sequence[str]],
                 layout: ShardLayout, protocol: str = "http",
                 **pool_kwargs):
        owns = False
        if not hasattr(client, "infer"):
            urls = list(client)
            pool_kwargs.setdefault("shm_arena", True)
            client = AioPoolClient(urls or layout.endpoints,
                                   protocol=protocol, **pool_kwargs)
            owns = True
        elif pool_kwargs:
            raise ShardConfigError(
                "pool kwargs are only accepted when AioShardedClient "
                "builds the pool itself (pass urls, not a client)")
        try:
            super().__init__(client, layout)
        except BaseException:
            if owns:
                # close() is a coroutine; schedule-or-drop is worse than
                # leaking here — abandon endpoints synchronously
                client._abandon(client.pool.endpoints)
            raise
        self._owns = owns

    async def close(self) -> None:
        await self.inner.close()

    async def __aenter__(self) -> "AioShardedClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- inference -----------------------------------------------------------
    async def infer(self, model_name: str, inputs, *args,
                    **kwargs) -> ShardedInferResult:
        kwargs = fold_infer_args(args, kwargs)
        self._check_kwargs(kwargs)
        scratch = _flight.layer_begin(
            self.inner.telemetry(), "shard", model_name)
        if scratch is None:
            return await self._infer_admitted(model_name, inputs, kwargs)
        try:
            result = await self._infer_admitted(model_name, inputs, kwargs)
        except BaseException as e:
            _flight.layer_commit(self.inner.telemetry(), scratch, error=e)
            raise
        _flight.layer_commit(self.inner.telemetry(), scratch)
        return result

    async def _infer_admitted(self, model_name: str, inputs,
                              kwargs) -> ShardedInferResult:
        """Async twin of the sync ``_infer_admitted`` split."""
        inner = self.inner
        ctrl = inner.admission()
        if ctrl is None:
            return await self._infer_sharded(model_name, inputs, kwargs)
        deadline = inner._admission_deadline(kwargs.get("client_timeout"))
        t0_ns = time.perf_counter_ns()
        token = await ctrl.acquire_async(
            kwargs.get("priority") or 0, deadline)
        admission_phase = ((t0_ns, time.perf_counter_ns())
                           if token.waited_s else None)
        t0 = time.monotonic()
        try:
            result = await self._infer_sharded(model_name, inputs, kwargs,
                                               admission_phase)
        except BaseException as e:
            inner._admission_settle(
                token, t0, getattr(e, "cause", None) or e)
            raise
        inner._admission_settle(token, t0, None)
        return result

    async def _infer_sharded(self, model_name, inputs, kwargs,
                             admission_phase=None) -> ShardedInferResult:
        from .resilience import AttemptBudget

        inner = self.inner
        layout = self.layout
        tel, span = self._span_begin(model_name)
        if span is not None and admission_phase is not None:
            span.phase("admission_queue", *admission_phase)
        budget = AttemptBudget(inner._budget_policy,
                               kwargs.get("client_timeout"))
        marks: List[Tuple[int, int]] = []
        error: Optional[BaseException] = None
        try:
            scatter_t0 = time.perf_counter_ns()
            plan = self._scatter(inputs)
            try:
                remaining = budget.attempt_timeout_s()
            except BaseException:
                for leases in plan.leases:
                    for lease in leases:
                        _release_quietly(lease)
                raise

            async def run_shard(i: int):
                url = layout.endpoints[i]
                if tel is not None:
                    tel.on_shard_subrequest(url)
                t_start = time.perf_counter_ns()
                try:
                    res = await inner.pinned_infer(
                        url, model_name, plan.inputs[i],
                        **self._shard_kwargs(kwargs, i, remaining))
                finally:
                    for lease in plan.leases[i]:
                        _release_quietly(lease)
                # completion mark only; _note_done folds these into
                # "attempt" phases on the caller's side (see sync twin)
                marks.append((t_start, time.perf_counter_ns()))
                return res

            _flight.note("shard", "fanout", shards=layout.n_shards)
            tasks = [asyncio.ensure_future(run_shard(i))
                     for i in range(layout.n_shards)]
            if span is not None:
                span.phase("shard_scatter", scatter_t0,
                           time.perf_counter_ns())
            try:
                await asyncio.wait(tasks,
                                   return_when=asyncio.FIRST_EXCEPTION)
                failed: Optional[Tuple[int, BaseException]] = None
                for i, t in enumerate(tasks):
                    if t.done() and not t.cancelled() \
                            and t.exception() is not None:
                        failed = (i, t.exception())
                        break
                if failed is not None:
                    # true cancellation: the sibling shards die mid-flight
                    for t in tasks:
                        t.cancel()
                    for t in tasks:
                        try:
                            await t
                        except BaseException:
                            pass
                    shard_i, cause = failed
                    raise ShardFailed(
                        shard_i, layout.endpoints[shard_i], cause)
            except asyncio.CancelledError:
                for t in tasks:
                    t.cancel()
                for t in tasks:
                    try:
                        await t
                    except BaseException:
                        pass
                raise
            gather_t0 = time.perf_counter_ns()
            _flight.note("shard", "gather", shards=layout.n_shards)
            result = self._gather([t.result() for t in tasks])
            if span is not None:
                span.phase("shard_gather", gather_t0,
                           time.perf_counter_ns())
            return result
        except BaseException as e:
            error = e
            raise
        finally:
            self._note_done(tel, span, marks, error)
