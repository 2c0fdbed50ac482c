"""Client-side model-DAG pipelines with arena-resident intermediates.

The port of ``client_tpu.pipeline``, over the port's pool, arena and
clients. Every other layer in this package serves ONE model per logical
request; real products run chains and ensembles (tokenize -> embed -> rerank,
N-model voting) that Triton solves server-side with its "ensemble"
scheduler. This module rebuilds that orchestration CLIENT-side — where
it can span replicas, roles and cells — as a declared :class:`Pipeline`
graph of :class:`Stage`\\ s executed by :class:`PipelineClient` /
:class:`AioPipelineClient` over any frontend or pool::

    from client_tpu_torch.pipeline import PipelineClient, chain_pipeline

    client = PipelineClient(["10.0.0.1:8000"], chain_pipeline())
    result = client.run({"RAW": raw})       # one DAG run
    result.as_numpy("SCORES")

Semantics:

- **Validation is construction-time and typed.** Cycles, missing
  producers, dtype/shape incompatibilities, unconsumed stage outputs and
  unconsumed pipeline inputs all raise :class:`PipelineConfigError`
  before anything is sent.
- **Intermediates never round-trip the host.** Each consumed stage
  output lands in a :class:`~client_tpu_torch.arena.ShmArena` lease bound to
  the request's ``InferRequestedOutput``; the consuming stage's
  ``InferInput`` references the SAME slab by shm handle. Region
  registrations ride the arena's per-``(endpoint, region)`` cache, so a
  steady-state run issues 0 region creates and 0 registration RPCs.
- **Slab residency is planned from tensor lifetimes.** ``Pipeline.plan``
  computes birth/death levels per intermediate from the DAG (the
  operator-lifetime shared-buffer planning of arXiv:2001.03288 applied
  across models); a tensor's lease is released the moment its last
  consumer settles, so a run's peak arena residency equals the plan's
  high-water mark.
- **One admission token, one attempt budget per logical run** (the
  shard.py contract): stages bypass the pool-level gate via
  ``routed_infer`` / ``pinned_infer`` and every stage dispatch draws its
  timeout from ONE shared :class:`~client_tpu_torch.resilience.AttemptBudget`.
- **Failure is whole-run and typed.** A failed stage cancels unstarted
  dependents and raises :class:`StageFailed` naming the stage — never a
  partial result; every staged lease is released, eagerly for cancelled
  stages and at settle for in-flight ones.
- **Observability**: one span per run (frontend ``pipeline+<inner>``)
  with per-stage ``stage:<name>`` phases, plus a ``pipeline`` flight
  layer (plan / stage_dispatch / handoff / stage_settle / release
  events) whose attribution keys are ``pipeline:<stage>`` — the flight
  recorder names the slow stage.
"""

from __future__ import annotations

import asyncio
import re
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from . import flight as _flight
from ._tensor import InferInput, InferRequestedOutput, _release_quietly
from .pool import AioPoolClient, PoolClient, _PoolClientBase
from .utils import InferenceServerException, triton_to_np_dtype

__all__ = [
    "AioPipelineClient",
    "Pipeline",
    "PipelineClient",
    "PipelineConfigError",
    "PipelineError",
    "PipelineResult",
    "SlabPlan",
    "Stage",
    "StageFailed",
    "chain_pipeline",
    "resolve_pipeline",
]

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")
PIPELINE_INPUT = "$"  # the reserved "producer" name for pipeline feeds


class PipelineError(InferenceServerException):
    """Base for every typed pipeline error."""

    def __init__(self, msg: str, status: str = "PIPELINE"):
        super().__init__(msg, status=status)


class PipelineConfigError(PipelineError):
    """The pipeline declaration (or its composition with a substrate) is
    invalid: duplicate/illegal names, unresolvable references, cycles,
    dtype/shape incompatibilities, unconsumed outputs, sync/aio
    mismatch, endpoints the pool does not serve."""

    def __init__(self, msg: str):
        super().__init__(msg, status="PIPELINE_CONFIG")


class StageFailed(PipelineError):
    """One stage of a pipeline run failed. The LOGICAL run fails whole:
    unstarted dependents are cancelled, staged leases released, and the
    original error is preserved as ``cause`` — never a partial result."""

    def __init__(self, stage: str, url: Optional[str],
                 cause: BaseException):
        where = f" (endpoint {url})" if url else ""
        super().__init__(
            f"pipeline stage {stage!r}{where} failed: "
            f"{type(cause).__name__}: {cause}",
            status="PIPELINE_STAGE")
        self.stage = stage
        self.url = url
        self.cause = cause


def _check_name(kind: str, name: Any) -> str:
    if not isinstance(name, str) or not name:
        raise PipelineConfigError(f"{kind} name must be a non-empty "
                                  f"string, got {name!r}")
    if "." in name or "$" in name or not _NAME_RE.match(
            name.replace(".", "_")):
        raise PipelineConfigError(
            f"{kind} name {name!r} is illegal ('.' and '$' are reserved "
            "for tensor references)")
    return name


def _check_spec(owner: str, tensor: str, spec: Any) -> Tuple[str, List[int]]:
    """Validate one ``(dtype, shape)`` tensor declaration."""
    try:
        dtype, shape = spec
    except (TypeError, ValueError):
        raise PipelineConfigError(
            f"{owner}: tensor {tensor!r} spec must be (dtype, shape), "
            f"got {spec!r}")
    if triton_to_np_dtype(dtype) is None:
        raise PipelineConfigError(
            f"{owner}: tensor {tensor!r} has unknown dtype {dtype!r}")
    try:
        dims = [int(d) for d in shape]
    except (TypeError, ValueError):
        raise PipelineConfigError(
            f"{owner}: tensor {tensor!r} shape {shape!r} is not a list "
            "of ints")
    if not dims or any(d == 0 or d < -1 for d in dims):
        raise PipelineConfigError(
            f"{owner}: tensor {tensor!r} shape {dims} must be non-empty "
            "with every dim > 0 (or -1 for dynamic)")
    return str(dtype), dims


def _parse_ref(owner: str, ref: Any) -> Tuple[str, str]:
    """``"$.NAME"`` -> ``("$", NAME)``; ``"stage.TENSOR"`` ->
    ``(stage, TENSOR)``."""
    if not isinstance(ref, str) or ref.count(".") != 1:
        raise PipelineConfigError(
            f"{owner}: reference {ref!r} must be '$.INPUT' or "
            "'stage.TENSOR'")
    producer, tensor = ref.split(".", 1)
    if not producer or not tensor:
        raise PipelineConfigError(f"{owner}: reference {ref!r} is empty "
                                  "on one side of the '.'")
    return producer, tensor


def _shapes_compatible(a: Sequence[int], b: Sequence[int]) -> bool:
    return len(a) == len(b) and all(
        x == -1 or y == -1 or x == y for x, y in zip(a, b))


class Stage:
    """One node of a :class:`Pipeline`: a model invocation whose inputs
    are wired by tensor name from pipeline feeds (``"$.NAME"``) or
    upstream stage outputs (``"stage.TENSOR"``).

    ``outputs`` declares this stage's produced tensors as
    ``{name: (dtype, shape)}`` — the declaration the slab plan sizes
    leases from (dynamic ``-1`` dims or BYTES fall back to host-staged
    handoff). ``input_specs`` optionally declares expected ``(dtype,
    shape)`` per local input name for construction-time compatibility
    checks against the wired producer. ``endpoint`` pins the stage to
    one replica (pool substrate only), ``affinity_key`` routes it under
    ``routing="affinity"``, ``priority``/``tenant`` feed the run-level
    admission defaults (ONE token per run)."""

    __slots__ = ("name", "model", "inputs", "outputs", "input_specs",
                 "model_version", "priority", "tenant", "affinity_key",
                 "endpoint", "_refs")

    def __init__(self, name: str, model: str,
                 inputs: Dict[str, str],
                 outputs: Dict[str, Tuple[str, Sequence[int]]],
                 input_specs: Optional[Dict[str, Tuple[str,
                                                       Sequence[int]]]] = None,
                 model_version: str = "",
                 priority: int = 0,
                 tenant: Optional[str] = None,
                 affinity_key: Optional[str] = None,
                 endpoint: Optional[str] = None):
        self.name = _check_name("stage", name)
        if not isinstance(model, str) or not model:
            raise PipelineConfigError(
                f"stage {name!r}: model must be a non-empty string")
        self.model = model
        if not isinstance(inputs, dict) or not inputs:
            raise PipelineConfigError(
                f"stage {name!r}: inputs must be a non-empty "
                "{local: reference} dict")
        if not isinstance(outputs, dict) or not outputs:
            raise PipelineConfigError(
                f"stage {name!r}: outputs must be a non-empty "
                "{tensor: (dtype, shape)} dict")
        self.inputs = dict(inputs)
        self._refs = {
            local: _parse_ref(f"stage {name!r} input {local!r}", ref)
            for local, ref in self.inputs.items()}
        self.outputs = {
            _check_name(f"stage {name!r} output", t):
                _check_spec(f"stage {name!r}", t, spec)
            for t, spec in outputs.items()}
        self.input_specs = {
            local: _check_spec(f"stage {name!r} input_specs", local, spec)
            for local, spec in (input_specs or {}).items()}
        unknown = set(self.input_specs) - set(self.inputs)
        if unknown:
            raise PipelineConfigError(
                f"stage {name!r}: input_specs for unwired inputs "
                f"{sorted(unknown)}")
        self.model_version = model_version
        self.priority = int(priority)
        self.tenant = tenant
        self.affinity_key = affinity_key
        self.endpoint = endpoint


class SlabPlan:
    """Lifetime-based arena residency plan for one pipeline.

    Each plannable intermediate (consumed downstream, static shape,
    non-BYTES) is assigned a ``[birth, death]`` level span — produced at
    its stage's topological level, dead after its last consumer's level
    — and ``high_water_bytes`` is the max over levels of the summed
    size-class bytes of tensors live at that level. Because the clients
    allocate a tensor's lease at producer dispatch and release it the
    moment its last consumer settles, a run's observed peak residency
    equals this high-water mark."""

    __slots__ = ("tensors", "level_bytes", "high_water_bytes",
                 "host_staged")

    def __init__(self, tensors: Dict[str, Dict[str, Any]],
                 level_bytes: List[int],
                 host_staged: Dict[str, str]):
        self.tensors = tensors
        self.level_bytes = level_bytes
        self.high_water_bytes = max(level_bytes) if level_bytes else 0
        self.host_staged = host_staged

    def describe(self) -> Dict[str, Any]:
        return {
            "high_water_bytes": self.high_water_bytes,
            "level_bytes": list(self.level_bytes),
            "tensors": {k: dict(v) for k, v in self.tensors.items()},
            "host_staged": dict(self.host_staged),
        }


class Pipeline:
    """A validated model DAG: named :class:`Stage`\\ s, declared pipeline
    ``inputs`` (``{name: (dtype, shape)}``) and exported ``outputs``
    (``{name: "stage.TENSOR"}``).

    Construction validates the whole graph — duplicate names, dangling
    references, cycles, dtype/shape incompatibilities (against declared
    ``input_specs``), unconsumed stage outputs, unconsumed pipeline
    inputs — raising :class:`PipelineConfigError` with the offending
    edge named."""

    def __init__(self, stages: Sequence[Stage],
                 inputs: Dict[str, Tuple[str, Sequence[int]]],
                 outputs: Dict[str, str],
                 name: str = "pipeline"):
        self.name = _check_name("pipeline", name)
        if not stages:
            raise PipelineConfigError("a pipeline needs at least one "
                                      "stage")
        self.stages: Dict[str, Stage] = {}
        for st in stages:
            if not isinstance(st, Stage):
                raise PipelineConfigError(
                    f"stages must be Stage instances, got "
                    f"{type(st).__name__}")
            if st.name in self.stages or st.name == PIPELINE_INPUT:
                raise PipelineConfigError(
                    f"duplicate stage name {st.name!r}")
            self.stages[st.name] = st
        if not isinstance(inputs, dict) or not inputs:
            raise PipelineConfigError(
                "pipeline inputs must be a non-empty "
                "{name: (dtype, shape)} dict")
        self.inputs = {
            _check_name("pipeline input", n):
                _check_spec("pipeline", n, spec)
            for n, spec in inputs.items()}
        if not isinstance(outputs, dict) or not outputs:
            raise PipelineConfigError(
                "pipeline outputs must be a non-empty {name: "
                "'stage.TENSOR'} dict")
        self._validate_wiring()
        self._toposort()
        self._validate_compat()
        self.exports: Dict[str, Tuple[str, str]] = {}
        for out_name, ref in outputs.items():
            _check_name("pipeline output", out_name)
            producer, tensor = _parse_ref(
                f"pipeline output {out_name!r}", ref)
            if producer == PIPELINE_INPUT:
                raise PipelineConfigError(
                    f"pipeline output {out_name!r} cannot re-export a "
                    f"pipeline input ({ref!r})")
            if producer not in self.stages:
                raise PipelineConfigError(
                    f"pipeline output {out_name!r} references unknown "
                    f"stage {producer!r}")
            if tensor not in self.stages[producer].outputs:
                raise PipelineConfigError(
                    f"pipeline output {out_name!r} references "
                    f"{producer}.{tensor} but stage {producer!r} does "
                    f"not declare output {tensor!r}")
            self.exports[out_name] = (producer, tensor)
        self._validate_coverage()

    # -- validation ---------------------------------------------------------
    def _validate_wiring(self) -> None:
        """Every reference resolves: consumers, tensor key maps."""
        self.consumers: Dict[str, List[str]] = {}
        self.stage_deps: Dict[str, Set[str]] = {}
        self.dependents: Dict[str, List[str]] = {s: [] for s in self.stages}
        self.stage_upstream: Dict[str, List[str]] = {}
        for sname, st in self.stages.items():
            deps: Set[str] = set()
            upstream: Set[str] = set()
            for local, (producer, tensor) in st._refs.items():
                where = f"stage {sname!r} input {local!r}"
                if producer == PIPELINE_INPUT:
                    if tensor not in self.inputs:
                        raise PipelineConfigError(
                            f"{where} references undeclared pipeline "
                            f"input {tensor!r}")
                    continue
                if producer == sname:
                    raise PipelineConfigError(
                        f"{where} references its own stage "
                        f"({producer}.{tensor}): a stage cannot consume "
                        "itself")
                if producer not in self.stages:
                    raise PipelineConfigError(
                        f"{where} references unknown stage "
                        f"{producer!r}")
                if tensor not in self.stages[producer].outputs:
                    raise PipelineConfigError(
                        f"{where} references {producer}.{tensor} but "
                        f"stage {producer!r} does not declare output "
                        f"{tensor!r}")
                key = f"{producer}.{tensor}"
                cons = self.consumers.setdefault(key, [])
                if sname not in cons:
                    cons.append(sname)
                deps.add(producer)
                upstream.add(key)
            self.stage_deps[sname] = deps
            self.stage_upstream[sname] = sorted(upstream)
        for sname, deps in self.stage_deps.items():
            for d in deps:
                self.dependents[d].append(sname)

    def _toposort(self) -> None:
        """Kahn's algorithm in declaration order; leftovers name the
        cycle. Levels are longest-path depths (the plan's time axis)."""
        left = {s: len(d) for s, d in self.stage_deps.items()}
        order: List[str] = []
        ready = [s for s in self.stages if left[s] == 0]
        self.level: Dict[str, int] = {s: 0 for s in ready}
        while ready:
            s = ready.pop(0)
            order.append(s)
            for d in self.dependents[s]:
                left[d] -= 1
                self.level[d] = max(self.level.get(d, 0),
                                    self.level[s] + 1)
                if left[d] == 0:
                    ready.append(d)
        if len(order) != len(self.stages):
            cyclic = sorted(s for s in self.stages if s not in order)
            raise PipelineConfigError(
                f"pipeline has a cycle through stages {cyclic}")
        self.order = order
        self.depth = 1 + max(self.level.values()) if self.level else 0

    def _validate_compat(self) -> None:
        """Declared ``input_specs`` vs the wired producer's declaration
        (dtype equality, shape rank + per-dim with -1 wildcards)."""
        for sname, st in self.stages.items():
            for local, (producer, tensor) in st._refs.items():
                spec = st.input_specs.get(local)
                if spec is None:
                    continue
                if producer == PIPELINE_INPUT:
                    src_dt, src_shape = self.inputs[tensor]
                    src = f"pipeline input {tensor!r}"
                else:
                    src_dt, src_shape = \
                        self.stages[producer].outputs[tensor]
                    src = f"{producer}.{tensor}"
                want_dt, want_shape = spec
                if src_dt != want_dt:
                    raise PipelineConfigError(
                        f"stage {sname!r} input {local!r} expects dtype "
                        f"{want_dt} but {src} produces {src_dt}")
                if not _shapes_compatible(src_shape, want_shape):
                    raise PipelineConfigError(
                        f"stage {sname!r} input {local!r} expects shape "
                        f"{want_shape} but {src} produces {src_shape}")

    def _validate_coverage(self) -> None:
        """No dead tensors: every stage output is consumed or exported,
        every pipeline input is consumed."""
        exported = {f"{s}.{t}" for s, t in self.exports.values()}
        dead = sorted(
            f"{sname}.{t}" for sname, st in self.stages.items()
            for t in st.outputs
            if f"{sname}.{t}" not in self.consumers
            and f"{sname}.{t}" not in exported)
        if dead:
            raise PipelineConfigError(
                f"unconsumed stage outputs {dead}: every declared output "
                "must be consumed downstream or exported as a pipeline "
                "output")
        consumed_feeds = {
            tensor for st in self.stages.values()
            for producer, tensor in st._refs.values()
            if producer == PIPELINE_INPUT}
        unused = sorted(set(self.inputs) - consumed_feeds)
        if unused:
            raise PipelineConfigError(
                f"unconsumed pipeline inputs {unused}: every declared "
                "input must be wired into at least one stage")

    # -- planning -----------------------------------------------------------
    def plan(self, class_for=None) -> SlabPlan:
        """Compute the lifetime-based slab plan. ``class_for`` maps a
        tensor's nbytes to its arena size class (pass the serving
        arena's ``_class_for`` so planned bytes equal leased bytes;
        default identity plans raw bytes)."""
        class_for = class_for or (lambda n: n)
        tensors: Dict[str, Dict[str, Any]] = {}
        host_staged: Dict[str, str] = {}
        n_levels = self.depth
        level_bytes = [0] * n_levels
        for sname, st in self.stages.items():
            for tname, (dtype, shape) in st.outputs.items():
                key = f"{sname}.{tname}"
                cons = self.consumers.get(key, [])
                if not cons:
                    host_staged[key] = "exported-only (plain wire)"
                    continue
                np_dt = triton_to_np_dtype(dtype)
                if dtype == "BYTES" or np_dt is None \
                        or np_dt == np.object_:
                    host_staged[key] = "BYTES dtype (host staged)"
                    continue
                if any(d < 0 for d in shape):
                    host_staged[key] = "dynamic shape (host staged)"
                    continue
                nbytes = int(np.prod(shape)) * np.dtype(np_dt).itemsize
                cls = int(class_for(max(1, nbytes)))
                birth = self.level[sname]
                death = max(self.level[c] for c in cons)
                tensors[key] = {
                    "nbytes": nbytes, "class_bytes": cls,
                    "birth": birth, "death": death,
                    "consumers": list(cons),
                }
                for lvl in range(birth, death + 1):
                    level_bytes[lvl] += cls
        return SlabPlan(tensors, level_bytes, host_staged)

    # -- introspection ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "order": list(self.order),
            "depth": self.depth,
            "stages": {
                s: {"model": st.model, "level": self.level[s],
                    "inputs": dict(st.inputs),
                    "outputs": {t: [dt, list(sh)]
                                for t, (dt, sh) in st.outputs.items()},
                    "endpoint": st.endpoint,
                    "affinity_key": st.affinity_key}
                for s, st in self.stages.items()},
            "inputs": {n: [dt, list(sh)]
                       for n, (dt, sh) in self.inputs.items()},
            "outputs": {n: f"{s}.{t}"
                        for n, (s, t) in self.exports.items()},
        }

    # -- parsing ------------------------------------------------------------
    _IN_RE = re.compile(r"^in\s+(\w+)\s*:\s*(\w+)\s*\[([0-9,\s\-]+)\]$")
    _OUT_RE = re.compile(r"^out\s+(\w+)\s*=\s*([\w$]+\.\w+)$")
    _STAGE_RE = re.compile(
        r"^(\w+)\s*=\s*([\w\-./]+?)(?:@([\w\-.]+))?\s*"
        r"\(([^)]*)\)\s*->\s*(.+)$")
    _ODECL_RE = re.compile(r"^(\w+)\s*:\s*(\w+)\s*\[([0-9,\s\-]+)\]$")

    @classmethod
    def parse(cls, spec: str, name: str = "pipeline") -> "Pipeline":
        """Parse a compact semicolon-separated pipeline spec::

            in RAW:INT32[1,16];
            tok=chain_tokenize(RAW=$.RAW)->TOKENS:INT32[1,16];
            emb=chain_embed(TOKENS=tok.TOKENS)->EMBED:FP32[1,16,32];
            out SCORES=emb.EMBED

        Segments: ``in NAME:DTYPE[dims]`` declares a pipeline input,
        ``stage=model[@version](LOCAL=ref,...)->OUT:DTYPE[dims]+...``
        declares a stage (multiple outputs joined with ``+``), and
        ``out NAME=stage.TENSOR`` exports a pipeline output."""
        inputs: Dict[str, Tuple[str, List[int]]] = {}
        outputs: Dict[str, str] = {}
        stages: List[Stage] = []
        for raw_seg in spec.split(";"):
            seg = raw_seg.strip()
            if not seg:
                continue
            m = cls._IN_RE.match(seg)
            if m:
                inputs[m.group(1)] = (
                    m.group(2),
                    [int(d) for d in m.group(3).split(",")])
                continue
            m = cls._OUT_RE.match(seg)
            if m:
                outputs[m.group(1)] = m.group(2)
                continue
            m = cls._STAGE_RE.match(seg)
            if m:
                sname, model, version, wires, odecls = m.groups()
                wiring: Dict[str, str] = {}
                for w in wires.split(","):
                    w = w.strip()
                    if not w:
                        continue
                    if "=" not in w:
                        raise PipelineConfigError(
                            f"pipeline spec: bad wire {w!r} in segment "
                            f"{seg!r} (want LOCAL=ref)")
                    local, ref = w.split("=", 1)
                    wiring[local.strip()] = ref.strip()
                outs: Dict[str, Tuple[str, List[int]]] = {}
                for od in odecls.split("+"):
                    om = cls._ODECL_RE.match(od.strip())
                    if not om:
                        raise PipelineConfigError(
                            f"pipeline spec: bad output declaration "
                            f"{od.strip()!r} (want NAME:DTYPE[dims])")
                    outs[om.group(1)] = (
                        om.group(2),
                        [int(d) for d in om.group(3).split(",")])
                stages.append(Stage(sname, model, wiring, outs,
                                    model_version=version or ""))
                continue
            raise PipelineConfigError(
                f"pipeline spec: cannot parse segment {seg!r}")
        return cls(stages, inputs, outputs, name=name)


EMBED_DIM = 32  # client_tpu_torch.models.chain.EMBED_DIM (tests hold them equal)


def chain_pipeline(batch: int = 1, length: int = 16) -> Pipeline:
    """The standard 3-stage chain over the ``models/`` zoo's chain
    fixtures (``chain_tokenize`` -> ``chain_embed`` -> ``chain_rerank``)
    — the graph whose runs are asserted bit-exact against the fused
    ``chain_fused`` single-model reference."""
    return Pipeline(
        name="chain",
        stages=[
            Stage("tokenize", "chain_tokenize",
                  inputs={"RAW": "$.RAW"},
                  outputs={"TOKENS": ("INT32", [batch, length])}),
            Stage("embed", "chain_embed",
                  inputs={"TOKENS": "tokenize.TOKENS"},
                  input_specs={"TOKENS": ("INT32", [batch, length])},
                  outputs={"EMBED": ("FP32",
                                     [batch, length, EMBED_DIM])}),
            Stage("rerank", "chain_rerank",
                  inputs={"EMBED": "embed.EMBED"},
                  input_specs={"EMBED": ("FP32",
                                         [batch, length, EMBED_DIM])},
                  outputs={"SCORES": ("FP32", [batch, length])}),
        ],
        inputs={"RAW": ("INT32", [batch, length])},
        outputs={"SCORES": "rerank.SCORES"},
    )


def resolve_pipeline(spec: Union[str, Pipeline]) -> Pipeline:
    """A CLI-friendly resolver: a :class:`Pipeline` passes through, the
    builtin name ``"chain"`` builds :func:`chain_pipeline`, anything
    with an ``=`` parses as a :meth:`Pipeline.parse` spec."""
    if isinstance(spec, Pipeline):
        return spec
    if spec == "chain":
        return chain_pipeline()
    if "=" in spec:
        return Pipeline.parse(spec)
    raise PipelineConfigError(
        f"unknown pipeline {spec!r}: pass 'chain' or an inline "
        "'in ...; stage=model(...)->...; out ...' spec")


class PipelineResult:
    """One completed DAG run: exported tensors (host arrays, safe after
    the run's leases are gone), per-stage wall latencies, and the run's
    observed-vs-planned arena residency."""

    __slots__ = ("outputs", "stage_latency_s", "duration_s",
                 "arena_high_water_bytes", "plan_high_water_bytes")

    def __init__(self, outputs: Dict[str, np.ndarray],
                 stage_latency_s: Dict[str, float], duration_s: float,
                 arena_high_water_bytes: int,
                 plan_high_water_bytes: int):
        self.outputs = outputs
        self.stage_latency_s = stage_latency_s
        self.duration_s = duration_s
        self.arena_high_water_bytes = arena_high_water_bytes
        self.plan_high_water_bytes = plan_high_water_bytes

    def as_numpy(self, name: str) -> np.ndarray:
        try:
            return self.outputs[name]
        except KeyError:
            raise PipelineError(
                f"unknown pipeline output {name!r} (have "
                f"{sorted(self.outputs)})")

    def describe(self) -> Dict[str, Any]:
        return {
            "outputs": {n: [str(a.dtype), list(a.shape)]
                        for n, a in self.outputs.items()},
            "stage_ms": {s: round(v * 1e3, 3)
                         for s, v in self.stage_latency_s.items()},
            "duration_ms": round(self.duration_s * 1e3, 3),
            "arena_high_water_bytes": self.arena_high_water_bytes,
            "plan_high_water_bytes": self.plan_high_water_bytes,
        }


class _TensorState:
    """One intermediate's run-time residency: the arena lease (or the
    host-staged value), the ACTUAL produced shape, and the set of
    consumer stages still outstanding — the lease is released the
    moment this set empties."""

    __slots__ = ("lease", "value", "dtype", "shape", "nbytes",
                 "class_bytes", "pending")

    def __init__(self, dtype: str, pending: Set[str], lease=None,
                 nbytes: int = 0, class_bytes: int = 0):
        self.lease = lease
        self.value: Optional[np.ndarray] = None
        self.dtype = dtype
        self.shape: Optional[List[int]] = None
        self.nbytes = nbytes
        self.class_bytes = class_bytes
        self.pending = pending


class _RunState:
    """Book-keeping for ONE logical run (tensors, settle/abandon sets,
    residency high-water). ``lock`` serializes the failure path's
    late-settle callbacks (worker threads) against the coordinator."""

    __slots__ = ("feeds", "tensors", "exports", "stage_lat", "settled",
                 "abandoned", "failed", "lock", "resident",
                 "high_water", "t0")

    def __init__(self, feeds: Dict[str, np.ndarray]):
        self.feeds = feeds
        self.tensors: Dict[str, _TensorState] = {}
        self.exports: Dict[str, np.ndarray] = {}
        self.stage_lat: Dict[str, float] = {}
        self.settled: Set[str] = set()
        self.abandoned: Set[str] = set()
        self.failed = False
        self.lock = threading.Lock()
        self.resident = 0
        self.high_water = 0
        self.t0 = time.monotonic()

    def lease_acquired(self, class_bytes: int) -> None:
        self.resident += class_bytes
        if self.resident > self.high_water:
            self.high_water = self.resident

    def lease_released(self, class_bytes: int) -> None:
        self.resident -= class_bytes


class _PipelineBase:
    """DAG-execution logic shared by the sync and asyncio clients."""

    _AIO = False

    def __init__(self, client: Any, pipeline: Pipeline,
                 arena: Any = None):
        if not isinstance(pipeline, Pipeline):
            raise PipelineConfigError(
                f"need a Pipeline, got {type(pipeline).__name__}")
        kind = type(client).__name__
        if "Batching" in kind:
            raise PipelineConfigError(
                "pipelines cannot ride the coalescing dispatcher: a "
                "batch window would stack stage requests across runs — "
                "wrap the PoolClient itself")
        if "Sharded" in kind:
            raise PipelineConfigError(
                "pipelines cannot wrap a ShardedClient: stage dispatch "
                "is whole-request — give the pipeline the pool and "
                "shard within a stage's own serving path instead")
        if not hasattr(client, "infer"):
            raise PipelineConfigError(
                f"pipeline substrate {kind} has no infer()")
        inner_aio = getattr(client, "_AIO", None)
        if inner_aio is None:
            inner_aio = asyncio.iscoroutinefunction(
                getattr(type(client), "infer", None))
        if bool(inner_aio) != self._AIO:
            raise PipelineConfigError(
                "sync PipelineClient needs a sync substrate and "
                "AioPipelineClient an asyncio one (sync/aio mismatch)")
        self.inner = client
        self.pipeline = pipeline
        self._pool = isinstance(client, _PoolClientBase)
        if self._pool:
            pool_urls = {ep.url for ep in client.pool.endpoints}
            bad = sorted(st.endpoint for st in pipeline.stages.values()
                         if st.endpoint and st.endpoint not in pool_urls)
            if bad:
                raise PipelineConfigError(
                    f"pipeline stages pin endpoints the pool does not "
                    f"serve: {bad}")
        else:
            pinned = sorted(
                st.name for st in pipeline.stages.values()
                if st.endpoint or st.affinity_key)
            if pinned:
                raise PipelineConfigError(
                    f"stages {pinned} declare endpoint/affinity routing "
                    "but the substrate is not a pool")
        if arena is True:
            from .arena import default_arena
            arena = default_arena()
        if arena is None:
            getter = getattr(client, "arena", None)
            arena = getter() if callable(getter) else None
        self._arena = arena
        class_for = (arena._class_for if arena is not None
                     else (lambda n: n))
        self._plan = pipeline.plan(class_for)
        # run-level admission defaults derived from the stage
        # declarations (explicit run kwargs win)
        self._default_priority = max(
            (st.priority for st in pipeline.stages.values()), default=0)
        self._default_tenant = next(
            (st.tenant for st in pipeline.stages.values()
             if st.tenant is not None), None)
        self._stats_lock = threading.Lock()
        self._runs = 0
        self._failures = 0
        self._observed_high_water = 0
        self._stage_ms: Dict[str, deque] = {
            s: deque(maxlen=256) for s in pipeline.order}

    # -- composition rejections (typed) ------------------------------------
    def coalescing(self, **kwargs):
        raise PipelineConfigError(
            "pipeline runs cannot be coalesced: a batch window would "
            "stack stage requests across DAG runs")

    def generate_stream(self, *args, **kwargs):
        raise PipelineConfigError(
            "generate_stream is not a pipeline stage: decode streams "
            "are sessions, not DAG nodes (see client_tpu_torch.disagg)")

    def start_stream(self, *args, **kwargs):
        raise PipelineConfigError(
            "bidi streams cannot host a pipeline: stage dispatch is "
            "per-request")

    # -- delegation ---------------------------------------------------------
    @property
    def _FRONTEND(self) -> str:
        return "pipeline+" + getattr(self.inner, "_FRONTEND", "client")

    def telemetry(self):
        getter = getattr(self.inner, "telemetry", None)
        return getter() if callable(getter) else None

    def arena(self):
        return self._arena

    def admission(self):
        getter = getattr(self.inner, "admission", None)
        return getter() if callable(getter) else None

    def endpoint_stats(self):
        return self.inner.endpoint_stats()

    def plan(self) -> SlabPlan:
        return self._plan

    def describe(self) -> Dict[str, Any]:
        d = self.pipeline.describe()
        d["plan"] = self._plan.describe()
        return d

    def __getattr__(self, name: str):
        if name.startswith("_") or name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            stages = {}
            for s, dq in self._stage_ms.items():
                if not dq:
                    stages[s] = {"count": 0}
                    continue
                vals = sorted(dq)
                n = len(vals)
                stages[s] = {
                    "count": n,
                    "avg_ms": round(sum(vals) / n, 3),
                    "p50_ms": round(vals[n // 2], 3),
                    "max_ms": round(vals[-1], 3),
                }
            return {
                "pipeline": self.pipeline.name,
                "runs": self._runs,
                "failures": self._failures,
                "plan_high_water_bytes": self._plan.high_water_bytes,
                "observed_high_water_bytes": self._observed_high_water,
                "stages": stages,
            }

    # -- request validation -------------------------------------------------
    def _check_kwargs(self, kwargs: Dict[str, Any]) -> None:
        if kwargs.get("sequence_id"):
            raise PipelineConfigError(
                "sequence requests cannot drive a pipeline run: "
                "sequence state is replica-local, stages are not")
        if "outputs" in kwargs:
            raise PipelineConfigError(
                "run() owns per-stage output placement; export tensors "
                "via the pipeline's outputs declaration instead of "
                "outputs=")

    def _check_feeds(self, feeds: Any) -> Dict[str, np.ndarray]:
        if not isinstance(feeds, dict):
            raise PipelineConfigError(
                f"run() feeds must be a {{name: ndarray}} dict, got "
                f"{type(feeds).__name__}")
        declared = self.pipeline.inputs
        missing = sorted(set(declared) - set(feeds))
        extra = sorted(set(feeds) - set(declared))
        if missing or extra:
            raise PipelineConfigError(
                f"feeds do not match declared pipeline inputs "
                f"(missing {missing}, unexpected {extra})")
        checked: Dict[str, np.ndarray] = {}
        for name, arr in feeds.items():
            dtype, shape = declared[name]
            arr = np.ascontiguousarray(arr)
            want = np.dtype(triton_to_np_dtype(dtype))
            if dtype != "BYTES" and arr.dtype != want:
                raise PipelineConfigError(
                    f"feed {name!r} dtype {arr.dtype} does not match "
                    f"declared {dtype} ({want})")
            if not _shapes_compatible(list(arr.shape), shape):
                raise PipelineConfigError(
                    f"feed {name!r} shape {list(arr.shape)} does not "
                    f"match declared {shape}")
            checked[name] = arr
        return checked

    # -- stage request assembly --------------------------------------------
    def _build_stage_request(self, run: _RunState, stage: Stage):
        """Assemble one stage's wire tensors on the coordinator: inputs
        reference upstream slabs by shm handle (the zero-copy handoff),
        consumed outputs land in fresh arena leases sized by the plan."""
        pl = self.pipeline
        inputs: List[InferInput] = []
        for local, (producer, tensor) in stage._refs.items():
            if producer == PIPELINE_INPUT:
                arr = run.feeds[tensor]
                inp = InferInput(local, list(arr.shape),
                                 pl.inputs[tensor][0])
                inp.set_data_from_numpy(arr)
            else:
                key = f"{producer}.{tensor}"
                ts = run.tensors[key]
                inp = InferInput(local, list(ts.shape), ts.dtype)
                if ts.lease is not None:
                    ts.lease.bind_input(inp)
                    _flight.note("pipeline", "handoff", url=stage.name,
                                 tensor=key, bytes=ts.nbytes)
                else:
                    inp.set_data_from_numpy(ts.value)
            inputs.append(inp)
        outputs: List[InferRequestedOutput] = []
        for tname in stage.outputs:
            key = f"{stage.name}.{tname}"
            spec = self._plan.tensors.get(key)
            out = InferRequestedOutput(tname)
            pending = set(pl.consumers.get(key, ()))
            dtype = stage.outputs[tname][0]
            if spec is not None and self._arena is not None:
                lease = self._arena.lease(spec["nbytes"])
                lease.bind_output(out)
                ts = _TensorState(dtype, pending, lease=lease,
                                  nbytes=spec["nbytes"],
                                  class_bytes=lease.byte_size)
                with run.lock:
                    run.tensors[key] = ts
                    run.lease_acquired(lease.byte_size)
            else:
                with run.lock:
                    run.tensors[key] = _TensorState(dtype, pending)
            outputs.append(out)
        return inputs, outputs

    def _stage_kwargs(self, kwargs: Dict[str, Any], stage: Stage,
                      remaining: Optional[float]) -> Dict[str, Any]:
        kw = dict(kwargs)
        kw.pop("priority", None)
        kw.pop("tenant", None)
        if remaining is not None:
            kw["client_timeout"] = remaining
        request_id = kw.get("request_id")
        if request_id:
            kw["request_id"] = f"{request_id}.{stage.name}"
        if stage.model_version:
            kw["model_version"] = stage.model_version
        return kw

    def _stage_url(self, stage: Stage) -> Optional[str]:
        if stage.endpoint:
            return stage.endpoint
        if self._pool:
            eps = self.inner.pool.endpoints
            if len(eps) == 1:
                return eps[0].url
        return None

    # -- settle / release ---------------------------------------------------
    def _settle_stage(self, run: _RunState, stage: Stage,
                      res: Any) -> None:
        """Extract the stage's outputs (exports copied out of leased
        slabs) and decrement upstream pending-consumer sets — releasing
        each upstream lease the moment this stage was its LAST consumer.

        Lease ownership is single-ref: the result's ``release_arena``
        and this run's ``_drop_tensor`` share the ONE reference created
        at dispatch, and only the run releases it (at last-consumer
        settle) — downstream ``bind_input`` handoffs read the live slab
        until then."""
        pl = self.pipeline
        exported = {(s, t): out_name
                    for out_name, (s, t) in pl.exports.items()}
        for tname, (_dt, declared_shape) in stage.outputs.items():
            key = f"{stage.name}.{tname}"
            ts = run.tensors[key]
            arr = res.as_numpy(tname)
            if arr is None:
                raise PipelineError(
                    f"stage {stage.name!r} response is missing "
                    f"declared output {tname!r}")
            if not _shapes_compatible(list(arr.shape),
                                      declared_shape):
                raise PipelineError(
                    f"stage {stage.name!r} output {tname!r} came "
                    f"back {list(arr.shape)}, declared "
                    f"{declared_shape}")
            ts.shape = list(arr.shape)
            if ts.lease is None:
                ts.value = arr
            out_name = exported.get((stage.name, tname))
            if out_name is not None:
                # leased views die with the slab: exports are copied
                # to host arrays the caller owns outright
                run.exports[out_name] = (
                    np.array(arr) if ts.lease is not None else arr)
        with run.lock:
            run.settled.add(stage.name)
            for key in pl.stage_upstream[stage.name]:
                ts = run.tensors.get(key)
                if ts is None:
                    continue
                ts.pending.discard(stage.name)
                if not ts.pending:
                    self._drop_tensor(run, key, ts)

    def _drop_tensor(self, run: _RunState, key: str,
                     ts: _TensorState) -> None:
        """Release one tensor's run-owned lease (caller holds
        ``run.lock``); idempotent."""
        if ts.lease is not None:
            _release_quietly(ts.lease)
            run.lease_released(ts.class_bytes)
            _flight.note("pipeline", "release", tensor=key,
                         bytes=ts.class_bytes)
            ts.lease = None
        ts.value = None

    def _stage_abandon(self, run: _RunState, sname: str) -> None:
        """Failure-path cleanup for one unsettled stage: drop its own
        dispatched output leases and its claims on upstream tensors
        (releasing any it was the last outstanding consumer of)."""
        pl = self.pipeline
        stage = pl.stages[sname]
        with run.lock:
            if sname in run.settled or sname in run.abandoned:
                return
            run.abandoned.add(sname)
            for tname in stage.outputs:
                key = f"{sname}.{tname}"
                ts = run.tensors.get(key)
                if ts is not None:
                    self._drop_tensor(run, key, ts)
            for key in pl.stage_upstream[sname]:
                ts = run.tensors.get(key)
                if ts is None:
                    continue
                ts.pending.discard(sname)
                if not ts.pending:
                    self._drop_tensor(run, key, ts)

    def _abandon_all_unsettled(self, run: _RunState) -> None:
        for sname in self.pipeline.order:
            self._stage_abandon(run, sname)

    def _finish_run(self, run: _RunState) -> PipelineResult:
        with run.lock:
            # defensive: coverage validation guarantees every leased
            # tensor has consumers, so nothing should be live here
            for key, ts in run.tensors.items():
                if ts.lease is not None:
                    self._drop_tensor(run, key, ts)
        return PipelineResult(
            outputs=run.exports,
            stage_latency_s=dict(run.stage_lat),
            duration_s=time.monotonic() - run.t0,
            arena_high_water_bytes=run.high_water,
            plan_high_water_bytes=self._plan.high_water_bytes)

    def _account_run(self, run: _RunState,
                     error: Optional[BaseException]) -> None:
        with self._stats_lock:
            self._runs += 1
            if error is not None:
                self._failures += 1
            if run.high_water > self._observed_high_water:
                self._observed_high_water = run.high_water
            for s, v in run.stage_lat.items():
                self._stage_ms[s].append(v * 1e3)

    # -- observability -------------------------------------------------------
    def _span_begin(self):
        tel = self.telemetry()
        if tel is None:
            return None, None
        return tel, tel.begin(self._FRONTEND, self.pipeline.name,
                              op="pipeline_run")

    def _note_done(self, tel, span,
                   marks: List[Tuple[str, int, int]],
                   error: Optional[BaseException]) -> None:
        if tel is None:
            return
        # per-stage sub-spans fold HERE on the caller's side, from the
        # workers' completion marks (the flight scratch is context-local
        # — worker-thread notes would be dropped)
        if span is not None:
            for sname, start_ns, end_ns in list(marks):
                span.phase(f"stage:{sname}", start_ns, end_ns)
        tel.finish(span, error)

    def _budget_policy(self):
        return getattr(self.inner, "_budget_policy", None)


class PipelineClient(_PipelineBase):
    """Synchronous DAG executor over a
    :class:`~client_tpu_torch.pool.PoolClient` (or any sync frontend).
    Independent stages fan out on an internal thread pool; the
    coordinator (the calling thread) owns every flight event, lease
    release and dependent dispatch, so a run's causal timeline and
    residency accounting are single-threaded truths."""

    _AIO = False

    def __init__(self, client: Union[Any, Sequence[str]],
                 pipeline: Pipeline, protocol: str = "http",
                 arena: Any = None,
                 executor_workers: Optional[int] = None,
                 **pool_kwargs):
        """``executor_workers``: stage fan-out thread pool size — a run
        holds up to ``width(DAG)`` workers for its round trip (default
        ``max(8, 2 * n_stages)``)."""
        owns = False
        if not hasattr(client, "infer") and not isinstance(client, str):
            try:
                urls = [str(u) for u in client]
            except TypeError:
                raise PipelineConfigError(
                    f"unusable pipeline substrate "
                    f"{type(client).__name__!r}: pass a client with "
                    "an infer() method, a url, or a sequence of urls"
                ) from None
            pool_kwargs.setdefault("shm_arena", True)
            client = PoolClient(urls, protocol=protocol, **pool_kwargs)
            owns = True
        elif pool_kwargs:
            raise PipelineConfigError(
                "pool kwargs are only accepted when PipelineClient "
                "builds the pool itself (pass urls, not a client)")
        try:
            super().__init__(client, pipeline, arena=arena)
        except BaseException:
            if owns:
                client.close()
            raise
        self._owns = owns
        self._executor_workers = (
            executor_workers if executor_workers
            else max(8, 2 * len(pipeline.stages)))
        self._executor_lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None

    def _get_executor(self) -> ThreadPoolExecutor:
        with self._executor_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._executor_workers,
                    thread_name_prefix="client_tpu_pipeline")
            return self._executor

    def close(self) -> None:
        with self._executor_lock:
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None
        if self._owns:
            self.inner.close()

    def __enter__(self) -> "PipelineClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- execution -----------------------------------------------------------
    def run(self, feeds: Dict[str, np.ndarray],
            **kwargs) -> PipelineResult:
        """Execute one DAG run over ``feeds`` (``{input: ndarray}``).
        Accepts the usual request kwargs (``client_timeout``,
        ``priority``, ``tenant``, ``request_id``, ``headers``);
        per-stage request ids are stamped ``<rid>.<stage>``."""
        kwargs = dict(kwargs)
        self._check_kwargs(kwargs)
        feeds = self._check_feeds(feeds)
        scratch = _flight.layer_begin(
            self.telemetry(), "pipeline", self.pipeline.name)
        if scratch is None:
            return self._run_admitted(feeds, kwargs)
        try:
            result = self._run_admitted(feeds, kwargs)
        except BaseException as e:
            _flight.layer_commit(self.telemetry(), scratch, error=e)
            raise
        _flight.layer_commit(self.telemetry(), scratch)
        return result

    def _run_admitted(self, feeds, kwargs) -> PipelineResult:
        """ONE admission token covers the whole DAG run (stages bypass
        the pool gate via routed_infer/pinned_infer) — the shard.py
        contract, so a half-admitted fan-out can never deadlock the
        controller against itself."""
        inner = self.inner
        ctrl = self.admission()
        if ctrl is None:
            return self._run_dag(feeds, kwargs)
        deadline = inner._admission_deadline(kwargs.get("client_timeout"))
        t0_ns = time.perf_counter_ns()
        token = ctrl.acquire(
            kwargs.get("priority") or self._default_priority, deadline,
            tenant=kwargs.get("tenant") or self._default_tenant)
        admission_phase = ((t0_ns, time.perf_counter_ns())
                           if token.waited_s else None)
        t0 = time.monotonic()
        try:
            result = self._run_dag(feeds, kwargs, admission_phase)
        except BaseException as e:
            inner._admission_settle(
                token, t0, getattr(e, "cause", None) or e)
            raise
        inner._admission_settle(token, t0, None)
        return result

    def _run_dag(self, feeds, kwargs,
                 admission_phase=None) -> PipelineResult:
        from .resilience import AttemptBudget

        pl = self.pipeline
        tel, span = self._span_begin()
        if span is not None and admission_phase is not None:
            span.phase("admission_queue", *admission_phase)
        budget = AttemptBudget(self._budget_policy(),
                               kwargs.get("client_timeout"))
        run = _RunState(feeds)
        marks: List[Tuple[str, int, int]] = []
        error: Optional[BaseException] = None
        try:
            _flight.note(
                "pipeline", "plan", stages=len(pl.order),
                tensors=len(self._plan.tensors),
                planned_bytes=self._plan.high_water_bytes)
            executor = self._get_executor()
            deps_left = {s: len(pl.stage_deps[s]) for s in pl.order}
            futures: Dict[Any, str] = {}
            failed: Optional[Tuple[str, BaseException]] = None

            def dispatch(sname: str) -> None:
                stage = pl.stages[sname]
                remaining = budget.attempt_timeout_s()  # shared budget
                inputs, outputs = self._build_stage_request(run, stage)
                _flight.note("pipeline", "stage_dispatch", url=sname,
                             model=stage.model)
                skw = self._stage_kwargs(kwargs, stage, remaining)
                fut = executor.submit(self._call_stage, stage, inputs,
                                      outputs, skw)
                futures[fut] = sname

            for sname in pl.order:
                if deps_left[sname]:
                    continue
                try:
                    dispatch(sname)
                except BaseException as e:
                    failed = (sname, e)
                    break
            while futures and failed is None:
                done, _ = wait(set(futures),
                               return_when=FIRST_COMPLETED)
                for f in done:
                    sname = futures.pop(f)
                    exc = f.exception()
                    if exc is not None:
                        self._stage_abandon(run, sname)
                        if failed is None:
                            failed = (sname, exc)
                        continue
                    res, t_start, t_end = f.result()
                    try:
                        self._settle_stage(run, pl.stages[sname], res)
                    except BaseException as e:
                        self._stage_abandon(run, sname)
                        if failed is None:
                            failed = (sname, e)
                        continue
                    marks.append((sname, t_start, t_end))
                    run.stage_lat[sname] = (t_end - t_start) * 1e-9
                    _flight.note(
                        "pipeline", "stage_settle", url=sname,
                        ms=round((t_end - t_start) * 1e-6, 3))
                    if failed is not None:
                        continue
                    for dep in pl.dependents[sname]:
                        deps_left[dep] -= 1
                        if deps_left[dep] == 0:
                            try:
                                dispatch(dep)
                            except BaseException as e:
                                failed = (dep, e)
                                break
            if failed is not None:
                self._fail_cleanup(run, futures)
                sname, cause = failed
                if isinstance(cause, StageFailed):
                    raise cause
                raise StageFailed(
                    sname, self._stage_url(pl.stages[sname]), cause)
            return self._finish_run(run)
        except BaseException as e:
            error = e
            raise
        finally:
            self._note_done(tel, span, marks, error)
            self._account_run(run, error)

    def _call_stage(self, stage: Stage, inputs, outputs, kw):
        """Worker-thread leg: ONE stage request through the substrate
        (its own routing/resilience decision). Returns completion marks
        for the coordinator to fold — flight/lease bookkeeping never
        happens here."""
        t_start = time.perf_counter_ns()
        res = self._dispatch_infer(stage, inputs, outputs, kw)
        return res, t_start, time.perf_counter_ns()

    def _dispatch_infer(self, stage: Stage, inputs, outputs, kw):
        inner = self.inner
        if self._pool:
            if stage.endpoint:
                return inner.pinned_infer(stage.endpoint, stage.model,
                                          inputs, outputs=outputs, **kw)
            if stage.affinity_key:
                kw = dict(kw, affinity_key=stage.affinity_key)
            return inner.routed_infer(stage.model, inputs,
                                      outputs=outputs, **kw)
        return inner.infer(stage.model, inputs, outputs=outputs, **kw)

    def _fail_cleanup(self, run: _RunState,
                      futures: Dict[Any, str]) -> None:
        """Fail fast and WHOLE: cancel what never started (their leases
        release here, on the coordinator), let in-flight stages settle
        in the background — a late-settle callback drops the result's
        adopted refs and the stage's staged leases, so a failed run
        leaks nothing."""
        with run.lock:
            run.failed = True
        for f, sname in list(futures.items()):
            if f.cancel():
                _flight.note("pipeline", "stage_cancelled", url=sname)
                self._stage_abandon(run, sname)
            else:
                f.add_done_callback(
                    lambda fut, s=sname: self._late_settle(run, s, fut))
        # stages still waiting on dependencies never dispatched: release
        # their upstream claims so settled producers' slabs free now
        self._abandon_all_unsettled_except(run, set(futures.values()))

    def _abandon_all_unsettled_except(self, run: _RunState,
                                      in_flight: Set[str]) -> None:
        for sname in self.pipeline.order:
            if sname in in_flight:
                continue
            self._stage_abandon(run, sname)

    def _late_settle(self, run: _RunState, sname: str, fut) -> None:
        # the stage's output leases live in run.tensors (single-ref
        # protocol) — abandoning releases them whether the straggler
        # succeeded or died
        self._stage_abandon(run, sname)


class AioPipelineClient(_PipelineBase):
    """Asyncio twin of :class:`PipelineClient` over an
    :class:`~client_tpu_torch.pool.AioPoolClient` (or any asyncio frontend):
    stage fan-out as tasks, so the first failure TRULY cancels sibling
    stages mid-flight before raising :class:`StageFailed`."""

    _AIO = True

    def __init__(self, client: Union[Any, Sequence[str]],
                 pipeline: Pipeline, protocol: str = "http",
                 arena: Any = None, **pool_kwargs):
        owns = False
        if not hasattr(client, "infer") and not isinstance(client, str):
            try:
                urls = [str(u) for u in client]
            except TypeError:
                raise PipelineConfigError(
                    f"unusable pipeline substrate "
                    f"{type(client).__name__!r}: pass a client with "
                    "an infer() method, a url, or a sequence of urls"
                ) from None
            pool_kwargs.setdefault("shm_arena", True)
            client = AioPoolClient(urls, protocol=protocol,
                                   **pool_kwargs)
            owns = True
        elif pool_kwargs:
            raise PipelineConfigError(
                "pool kwargs are only accepted when AioPipelineClient "
                "builds the pool itself (pass urls, not a client)")
        try:
            super().__init__(client, pipeline, arena=arena)
        except BaseException:
            if owns:
                # close() is a coroutine; abandon endpoints synchronously
                client._abandon(client.pool.endpoints)
            raise
        self._owns = owns

    async def close(self) -> None:
        if self._owns:
            await self.inner.close()

    async def __aenter__(self) -> "AioPipelineClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- execution -----------------------------------------------------------
    async def run(self, feeds: Dict[str, np.ndarray],
                  **kwargs) -> PipelineResult:
        kwargs = dict(kwargs)
        self._check_kwargs(kwargs)
        feeds = self._check_feeds(feeds)
        scratch = _flight.layer_begin(
            self.telemetry(), "pipeline", self.pipeline.name)
        if scratch is None:
            return await self._run_admitted(feeds, kwargs)
        try:
            result = await self._run_admitted(feeds, kwargs)
        except BaseException as e:
            _flight.layer_commit(self.telemetry(), scratch, error=e)
            raise
        _flight.layer_commit(self.telemetry(), scratch)
        return result

    async def _run_admitted(self, feeds, kwargs) -> PipelineResult:
        inner = self.inner
        ctrl = self.admission()
        if ctrl is None:
            return await self._run_dag(feeds, kwargs)
        deadline = inner._admission_deadline(kwargs.get("client_timeout"))
        t0_ns = time.perf_counter_ns()
        token = await ctrl.acquire_async(
            kwargs.get("priority") or self._default_priority, deadline,
            tenant=kwargs.get("tenant") or self._default_tenant)
        admission_phase = ((t0_ns, time.perf_counter_ns())
                           if token.waited_s else None)
        t0 = time.monotonic()
        try:
            result = await self._run_dag(feeds, kwargs, admission_phase)
        except BaseException as e:
            inner._admission_settle(
                token, t0, getattr(e, "cause", None) or e)
            raise
        inner._admission_settle(token, t0, None)
        return result

    async def _run_dag(self, feeds, kwargs,
                       admission_phase=None) -> PipelineResult:
        from .resilience import AttemptBudget

        pl = self.pipeline
        tel, span = self._span_begin()
        if span is not None and admission_phase is not None:
            span.phase("admission_queue", *admission_phase)
        budget = AttemptBudget(self._budget_policy(),
                               kwargs.get("client_timeout"))
        run = _RunState(feeds)
        marks: List[Tuple[str, int, int]] = []
        error: Optional[BaseException] = None
        try:
            _flight.note(
                "pipeline", "plan", stages=len(pl.order),
                tensors=len(self._plan.tensors),
                planned_bytes=self._plan.high_water_bytes)
            deps_left = {s: len(pl.stage_deps[s]) for s in pl.order}
            tasks: Dict[Any, str] = {}
            failed: Optional[Tuple[str, BaseException]] = None

            def dispatch(sname: str) -> None:
                stage = pl.stages[sname]
                remaining = budget.attempt_timeout_s()
                inputs, outputs = self._build_stage_request(run, stage)
                _flight.note("pipeline", "stage_dispatch", url=sname,
                             model=stage.model)
                skw = self._stage_kwargs(kwargs, stage, remaining)
                task = asyncio.ensure_future(
                    self._call_stage(stage, inputs, outputs, skw))
                tasks[task] = sname

            for sname in pl.order:
                if deps_left[sname]:
                    continue
                try:
                    dispatch(sname)
                except BaseException as e:
                    failed = (sname, e)
                    break
            try:
                while tasks and failed is None:
                    done, _ = await asyncio.wait(
                        set(tasks), return_when=asyncio.FIRST_COMPLETED)
                    for t in done:
                        sname = tasks.pop(t)
                        if t.cancelled():
                            self._stage_abandon(run, sname)
                            continue
                        exc = t.exception()
                        if exc is not None:
                            self._stage_abandon(run, sname)
                            if failed is None:
                                failed = (sname, exc)
                            continue
                        res, t_start, t_end = t.result()
                        try:
                            self._settle_stage(run, pl.stages[sname],
                                               res)
                        except BaseException as e:
                            self._stage_abandon(run, sname)
                            if failed is None:
                                failed = (sname, e)
                            continue
                        marks.append((sname, t_start, t_end))
                        run.stage_lat[sname] = (t_end - t_start) * 1e-9
                        _flight.note(
                            "pipeline", "stage_settle", url=sname,
                            ms=round((t_end - t_start) * 1e-6, 3))
                        if failed is not None:
                            continue
                        for dep in pl.dependents[sname]:
                            deps_left[dep] -= 1
                            if deps_left[dep] == 0:
                                try:
                                    dispatch(dep)
                                except BaseException as e:
                                    failed = (dep, e)
                                    break
                if failed is not None:
                    # true cancellation: sibling stages die mid-flight
                    await self._cancel_all(run, tasks)
                    self._abandon_all_unsettled(run)
                    sname, cause = failed
                    if isinstance(cause, StageFailed):
                        raise cause
                    raise StageFailed(
                        sname, self._stage_url(pl.stages[sname]), cause)
            except asyncio.CancelledError:
                await self._cancel_all(run, tasks)
                self._abandon_all_unsettled(run)
                raise
            return self._finish_run(run)
        except BaseException as e:
            error = e
            raise
        finally:
            self._note_done(tel, span, marks, error)
            self._account_run(run, error)

    async def _call_stage(self, stage: Stage, inputs, outputs, kw):
        t_start = time.perf_counter_ns()
        res = await self._dispatch_infer(stage, inputs, outputs, kw)
        return res, t_start, time.perf_counter_ns()

    async def _dispatch_infer(self, stage: Stage, inputs, outputs, kw):
        inner = self.inner
        if self._pool:
            if stage.endpoint:
                return await inner.pinned_infer(
                    stage.endpoint, stage.model, inputs,
                    outputs=outputs, **kw)
            if stage.affinity_key:
                kw = dict(kw, affinity_key=stage.affinity_key)
            return await inner.routed_infer(stage.model, inputs,
                                            outputs=outputs, **kw)
        return await inner.infer(stage.model, inputs, outputs=outputs,
                                 **kw)

    async def _cancel_all(self, run: _RunState,
                          tasks: Dict[Any, str]) -> None:
        for t, sname in list(tasks.items()):
            t.cancel()
        for t, sname in list(tasks.items()):
            try:
                await t
            except BaseException:
                pass
            self._stage_abandon(run, sname)
        tasks.clear()
